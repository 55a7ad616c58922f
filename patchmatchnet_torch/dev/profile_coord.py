"""K7 and K6 on the card, at the shapes of the coordinate-input plane sweep
and of the main path, for timing one tree of the port against another.

    python -m patchmatchnet_torch.dev.profile_coord [--views 4,64]
        [--save-outputs FILE] [--compare-outputs FILE] [--out FILE]

Every input is made on the CPU from a seed, so two trees get the same
bits. Per case it prints the device time of the bf16 case (busy time per
call in a torch.profiler trace of 10 calls, `utils.trace.device_ms`) and,
against the outputs another tree saved (--compare-outputs), max |this -
that| of the bf16 and f32 cases:

- K7 (`coord_group_corr`) at the sweep's three stage shapes (1152x864 at
  1/8, 1/4 and 1/2: C 64/32/16, G 8/8/4, D 64/16/8), 4 launches a stage,
  on three layouts of the coordinates:
  - "jitter", as `chip_smoke.py` phase 3 makes them: the warp of i.i.d.
    depths into the rig's first source view plus N(0, 1.5^2) px; one
    launch, counted 4 times;
  - "far": the same with N(0, 40^2) px, so that many samples have corners
    off the image;
  - "sweep", as phase 6 makes them (`sweep_coords`): fronto-parallel
    planes uniform in inverse depth over the synthetic scene's range,
    warped into each of its 4 source views; all 4 launches.
- K6 (`warp_group_corr_views`) at the main path's shapes (stage 3 D32,
  stage 2 D16 twice, stage 1 D8) with 4 views, and at stage 2 with each
  other count in --views.

Then device ms per sweep for each K7 layout and per forward for K6 at 4
views. The last line is a JSON summary.

It uses only the port's public wrappers, so the same file also measures
an earlier tree of the port (copy it into that tree and run it there,
with --views 4 where that tree's K6 takes at most 50 views).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from patchmatchnet_torch import ops
from patchmatchnet_torch.data import BatchLoader, MVSDataset, make_synthetic_scene
from patchmatchnet_torch.ops.warp import warp_coords, warp_proj_coeffs
from patchmatchnet_torch.utils.trace import device_ms, fmt_ms

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
H, W, VIEWS = 864, 1152, 5
# (stage, C, G, scale, the sweep's D, [(K6's D, launches per forward)])
STAGES = ((3, 64, 8, 8, 64, ((32, 1),)), (2, 32, 8, 4, 16, ((16, 2),)),
          (1, 16, 4, 2, 8, ((8, 1),)))
JITTER_PX = {"jitter": 1.5, "far": 40.0}


def sweep_coords(intr, extr, depth_min, depth_max, stage: int, d: int, h: int, w: int):
    """The coordinate-input plane sweep at one stage: `d` fronto-parallel
    planes uniform in inverse depth over [depth_min, depth_max], far to
    near, on the stage's h x w grid (1 / 2**stage of the images), warped
    from view 0 into each other view. intr [N, 3, 3] and extr [N, 4, 4]
    are the cameras at the images' resolution. Returns (mats [N - 1, 12],
    depth [1, d, h, w], hyp [d], [(ix, iy) [1, d, h, w] per source view])."""
    k = intr.clone()
    k[:, :2] *= 0.5 ** stage
    proj = extr.clone()
    proj[:, :3, :4] = k @ extr[:, :3, :4]
    mats = warp_proj_coeffs(proj[1:], proj[:1])
    inv_min, inv_max = 1.0 / depth_min, 1.0 / depth_max
    steps = (torch.arange(d, device=intr.device) + 0.5) / d
    hyp = 1.0 / (inv_max + steps * (inv_min - inv_max))
    depth = hyp.reshape(1, d, 1, 1).expand(1, d, h, w).contiguous()
    coords = [warp_coords(mats[v:v + 1], depth, h, w) for v in range(mats.shape[0])]
    return mats, depth, hyp, coords


def rig_mats(h: int, w: int, scale: int, views: int) -> torch.Tensor:
    """[1, views, 12] warps of a stage's h x w reference into `views`
    source cameras at x baselines +-0.35, +-0.7, +-1.05, +-1.4 and, past
    the eighth, y baselines of 0.2 more per 8 views (the first 4 are
    `chip_smoke.py`'s rig)."""
    f = 1.1 * max(H, W) / scale
    k = torch.tensor([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])
    projs = []
    for v in range(-1, views):
        tx = 0.0 if v < 0 else 0.35 * ((v // 2) % 4 + 1) * (1 if v % 2 == 0 else -1)
        ty = 0.0 if v < 0 else 0.2 * (v // 8)
        p = torch.eye(4)
        p[:3, :4] = k @ torch.tensor([[1.0, 0, 0, tx], [0, 1, 0, ty], [0, 0, 1, 0]])
        projs.append(p)
    projs = torch.stack(projs)[None]
    return warp_proj_coeffs(projs[:, 1:], projs[:, :1]).contiguous()


def scene_cameras():
    """(intr [N, 3, 3], extr [N, 4, 4], depth_min, depth_max) of the first
    sample of the synthetic 1152x864 scene `chip_smoke.py` phase 6 sweeps."""
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="profile_coord_", dir=os.path.join(REPO, "build"))
    try:
        make_synthetic_scene(root, num_views=VIEWS, height=H, width=W, texture_scale=8.0)
        batch = next(iter(BatchLoader(MVSDataset(root, VIEWS - 1, ".png"), num_threads=1)))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    intr, extr, dmin, dmax = (torch.as_tensor(np.asarray(batch[k])).float()
                              for k in ("intrinsics", "extrinsics", "depth_min", "depth_max"))
    return intr[0], extr[0], dmin[0], dmax[0]


def k7_calls(srcs, coords, ref, groups):
    """fn() running K7 once per (source map, (ix, iy)) pair."""
    return lambda: [ops.coord_group_corr(s, x, y, ref, groups) for s, (x, y) in zip(srcs, coords)]


def k6_call(src, mats, depth, ref, vw, groups):
    return lambda: [ops.warp_group_corr_views(src, mats, depth, ref, vw, groups)]


def cases(device, views_list):
    """[(kernel, layout, label, calls per pass, {"bf16": fn, "f32": fn})]:
    fn() runs the case's launches once on inputs made on the CPU from a
    seed of its own (so a case's inputs do not depend on the cases run
    before it), and "calls per pass" is how often a sweep (K7) or a
    forward (K6 at 4 views) runs it."""
    intr, extr, dmin, dmax = scene_cameras()
    out = []
    for stage, c, g, scale, d, k6_depths in STAGES:
        gen = torch.Generator().manual_seed(stage)
        h, w = H // scale, W // scale
        maps = torch.randn((VIEWS, h, w, c), generator=gen)
        feats = {"bf16": maps.to(torch.bfloat16).to(device), "f32": maps.to(device)}
        label = f"stage{stage} C{c} G{g} D{d} {h}x{w}"
        # K7 on phase 3's layout: the rig's first source view, i.i.d. depths
        mat12 = rig_mats(h, w, scale, 1)[:, 0].contiguous()
        depth = 4.8 + 3.0 * torch.rand((1, d, h, w), generator=gen)
        depth[:, -1, :4] = -1.0  # behind the source camera
        ix, iy = warp_coords(mat12, depth, h, w)
        for layout, px in JITTER_PX.items():
            coords = [((ix + px * torch.randn(ix.shape, generator=gen)).to(device),
                       (iy + px * torch.randn(iy.shape, generator=gen)).to(device))]
            out.append(("K7", layout, label, 4,
                        {tag: k7_calls([f[1:2]], coords, f[:1], g) for tag, f in feats.items()}))
        # K7 on phase 6's layout: the plane sweep into each source view
        coords = [(x.to(device), y.to(device))
                  for x, y in sweep_coords(intr, extr, dmin, dmax, stage, d, h, w)[3]]
        out.append(("K7", "sweep", label, 1,
                    {tag: k7_calls([f[v:v + 1] for v in range(1, VIEWS)], coords, f[:1], g)
                     for tag, f in feats.items()}))
        # K6 at the main path's shapes (4 views), and at stage 2 with more
        for views in views_list:
            if views != VIEWS - 1 and stage != 2:
                continue
            gen = torch.Generator().manual_seed(1000 * stage + views)
            mats = rig_mats(h, w, scale, views).to(device)
            stack = torch.randn((1, views, h, w, c), generator=gen)
            vw = torch.rand((1, views, h, w), generator=gen).to(device)
            for kd, launches in k6_depths:
                depth = 4.8 + 3.0 * torch.rand((1, kd, h, w), generator=gen)
                depth[:, -1, :4] = -1.0
                depth = depth.to(device)
                fns = {tag: k6_call(stack.to(f.dtype).to(device), mats, depth, f[:1], vw, g)
                       for tag, f in feats.items()}
                out.append(("K6", f"V{views}", f"stage{stage} C{c} G{g} D{kd} {h}x{w}",
                            launches if views == VIEWS - 1 else 0, fns))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--views", default="4,64", help="K6 view counts (4 is the main path's)")
    parser.add_argument("--save-outputs", help="write every case's outputs here")
    parser.add_argument("--compare-outputs", help="hold every case's outputs against these")
    parser.add_argument("--out", help="write the JSON summary here too")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_coord needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    other = torch.load(args.compare_outputs) if args.compare_outputs else None
    saved, rows, per_pass = {}, [], {}
    for kid, layout, label, calls, fns in cases(device, [int(v) for v in args.views.split(",")]):
        row = {"kernel": kid, "layout": layout, "case": label, "calls_per_pass": calls}
        line = f"{kid} {layout} {label}:"
        for tag, fn in fns.items():
            outs = [o.cpu() for o in fn()]
            key = f"{kid} {layout} {label} {tag}"
            saved[key] = outs
            if other is not None:
                diff = (max((a - b).abs().max().item() for a, b in zip(outs, other[key]))
                        if key in other else None)
                row[f"max_abs_diff_vs_compared_{tag}"] = diff
                line += f" max |this - compared| {tag} {'missing' if diff is None else f'{diff:.3e}'};"
        ms = device_ms(fns["bf16"])
        row["device_ms"] = ms
        line += f" device {fmt_ms(ms)} bf16"
        if calls:
            line += f" (x{calls}/pass)"
            key = f"{kid} {layout}"
            total = per_pass.get(key, 0.0)
            per_pass[key] = None if ms is None or total is None else total + ms * calls
        print(line, flush=True)
        rows.append(row)
    print("device ms per pass (K7: per sweep of 12 launches; K6 V4: per forward of 4): "
          + ", ".join(f"{k} {fmt_ms(v)}" for k, v in per_pass.items()), flush=True)
    if args.save_outputs:
        torch.save(saved, args.save_outputs)
    result = {"card": smi, "cases": rows, "per_pass": per_pass}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
