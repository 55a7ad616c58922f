"""The numbers that decide `correct`: the program's outputs of the timed
path against the plain reference of the configuration's architecture
(`archs/<architecture>.py`; PatchmatchNet's is `reference.py`) on the same
inputs.

Maps: for each depth map kept from the window, with the depth range R of
its request and the gap |depth - reference| / R at each pixel,
- `depth_off_tiles`: the share of `tile` x `tile` blocks whose median gap
  is above `tile_tolerance`. Rounding moves every pixel a little, and a
  payload precision below bf16 lifts the median of almost every block
  over the tolerance; bf16 also flips a few ambiguous patches to other
  depths, which a share of pixels would count and this leaves to the
  blocks they fill;
- `depth_off_share`: the share of pixels whose gap is above
  `depth_tolerance`;
- `depth_mean_gap`, `depth_median_gap`, `conf_mean_gap` (printed only).
A run's number is the largest over its maps.

Training, over the first three steps that set-up drives through the
window's own call (the reference takes the same rows, noise, weights and
learning rate):
- `loss_gap`: the largest |loss - reference| / |reference| of the steps;
- `grad_gap`: the first step's gradient, as Adam's first moment gives it
  (m / (1 - beta1) after one step), by the worst leaf: |norm - reference
  norm| over the larger of the reference leaf's norm and the median
  leaf's;
- `change_gap`: the parameters' change over the three steps, by the
  worst leaf, measured the same way. Leaves whose reference gradient is
  under a thousandth of the median leaf's are left out: Adam moves them by
  round-off alone (the bias of a layer under a softmax).
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

SMALL_GRADIENT = 1e-3  # of the median leaf's reference gradient norm


def map_numbers(depth: torch.Tensor, conf: torch.Tensor, ref_depth: torch.Tensor,
                ref_conf: torch.Tensor, depth_range: float, params: Dict[str, float]
                ) -> Dict[str, float]:
    """A map's numbers against the reference's; `params` (the cell's
    limits file) gives `depth_tolerance` for `depth_off_share` and `tile`,
    `tile_tolerance` for `depth_off_tiles`."""
    gap = (depth.double() - ref_depth.double()).abs() / depth_range
    out = {
        "depth_mean_gap": float(gap.mean()),
        "depth_median_gap": float(torch.quantile(gap.flatten()[::7].float(), 0.5)),
        "conf_mean_gap": float((conf.double() - ref_conf.double()).abs().mean()),
    }
    if "depth_tolerance" in params:
        out["depth_off_share"] = float((gap > params["depth_tolerance"]).double().mean())
    if "tile" in params:
        medians = tile_medians(gap, int(params["tile"]))
        out["depth_off_tiles"] = float((medians > params["tile_tolerance"]).double().mean())
    return out


def tile_medians(gap: torch.Tensor, tile: int) -> torch.Tensor:
    """The median of `gap` [..., H, W] in each whole tile x tile block."""
    h, w = gap.shape[-2] // tile * tile, gap.shape[-1] // tile * tile
    blocks = gap[..., :h, :w].reshape(-1, h // tile, tile, w // tile, tile)
    return blocks.permute(0, 1, 3, 2, 4).reshape(-1, tile * tile).float().median(dim=1).values


def _leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
               keys: Iterable[str]) -> Dict[str, float]:
    """|program norm - reference norm| over the larger of the reference
    leaf's norm and the median leaf's, for each leaf of `keys`."""
    keys = list(keys)
    norms = sorted(reference[k] for k in keys)
    median = norms[len(norms) // 2]
    return {k: abs(program[k] - reference[k]) / max(reference[k], median, 1e-30) for k in keys}


def train_numbers(program: Dict[str, object], reference: Dict[str, object]
                  ) -> Dict[str, float]:
    """program / reference: {"losses": [3 floats], "grad_norms": {flax key:
    norm}, "change_norms": {flax key: norm}}."""
    losses = list(zip(program["losses"], reference["losses"]))
    grads_r = reference["grad_norms"]
    grad = _leaf_gaps(program["grad_norms"], grads_r, grads_r)
    median = sorted(grads_r.values())[len(grads_r) // 2]
    moved = [k for k, g in grads_r.items() if g >= SMALL_GRADIENT * median]
    change = _leaf_gaps(program["change_norms"], reference["change_norms"], moved)
    mid = lambda d: sorted(d.values())[len(d) // 2]  # noqa: E731
    return {"loss_gap": max(abs(p - r) / abs(r) for p, r in losses),
            "grad_gap": max(grad.values()), "grad_median_gap": mid(grad),
            "change_gap": max(change.values()), "change_median_gap": mid(change)}


def worst_leaves(program: Dict[str, object], reference: Dict[str, object], count: int = 3):
    """The leaves of the largest gradient gaps, with both norms (a look at
    what sets `grad_gap`)."""
    grads_r = reference["grad_norms"]
    gaps = _leaf_gaps(program["grad_norms"], grads_r, grads_r)
    top = sorted(gaps, key=lambda k: -gaps[k])[:count]
    return [(k, gaps[k], program["grad_norms"][k], grads_r[k]) for k in top]
