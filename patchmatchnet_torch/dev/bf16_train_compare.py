"""Long-horizon f32-against-bf16 trainer comparison: the port of
`tools/dev/bf16_train_compare.py`.

    python -m patchmatchnet_torch.dev.bf16_train_compare [--steps 300 --height 512
        --width 640 --batch 2 --num-views 5 --log-every 10] [--device cuda|cpu]

Trains PatchmatchNet from scratch for `--steps` steps at the DTU training
geometry (640x512, N=5, B=2 by default; `--num-views` counts the source
views, as `MVSDataset` and the JAX tool count them, so a sample holds 1 + 5
views) on the textured synthetic plane scene of known depth
(`data.make_synthetic_scene`), once with the f32
trainer (`compute_dtype=None`, TF32 off in forward and backward) and once
with the bf16 trainer (bf16 payloads; f32 parameters, BatchNorm, loss and
optimizer), f32 first. Both start from the same default initialization
(drawn under `torch.manual_seed(0)`) and take the same batch and the same
stage-3 noise at every step (step i draws it from a `torch.Generator`
seeded `noise_seed + i`). It reports:

- the loss and the stage-0 depth error against the plane's GT at every
  step, on stderr every `--log-every` steps with the step's wall time (each
  step reads its loss and depth error to the host, so a wall is a
  synchronized step), and each run's seconds after its first step;
- on the card, the hand-kernel launches of each run per step, and of both
  runs as `kernel launches: {...}`;
- one JSON line on stdout with the JAX tool's keys: the final losses, the
  relative loss divergence |bf16 - f32| / f32 over the run (median, 95th
  percentile, the largest of the second half) and the final stage-0 depth
  errors, unrounded.

The JAX tool's `windowed_escapes` key is left out: it counts samples that
escape the TPU windowed sampler's source window, a TPU workaround the port
does not have (the port's kernels read every sample), so there is nothing
to count.

`--device cuda` (the default) raises without CUDA; `--device cpu` runs the
kernels' plain versions (small sizes only).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from patchmatchnet_torch.bench import resolve_device, seeded_model
from patchmatchnet_torch.data import PLANE_Z, MVSDataset, adjust_sample_dims, make_synthetic_scene
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.ops import cuda_build
from patchmatchnet_torch.train import batch_to_device, make_optimizer, train_step

LEARNING_RATE = 1e-3


def build_batch(height: int, width: int, batch: int, num_views: int) -> Dict[str, np.ndarray]:
    """The training batch: the first `batch` samples of a plane scene of
    max(num_views + 1, batch + num_views) views read with `num_views`
    sources, depth_gt PLANE_Z everywhere and a mask of ones (numpy, keyed as
    a loader batch)."""
    with tempfile.TemporaryDirectory(prefix="bf16_train_") as tmp:
        make_synthetic_scene(tmp, num_views=max(num_views + 1, batch + num_views),
                             height=height, width=width)
        ds = MVSDataset(tmp, num_views=num_views, image_extension=".png")
        samples = [adjust_sample_dims(ds[i]) for i in range(batch)]
    images = np.stack([s["images"] for s in samples])
    h, w = images.shape[2], images.shape[3]
    return {
        "images": images,
        "intrinsics": np.stack([s["intrinsics"] for s in samples]),
        "extrinsics": np.stack([s["extrinsics"] for s in samples]),
        "depth_min": np.asarray([s["depth_min"] for s in samples], np.float32),
        "depth_max": np.asarray([s["depth_max"] for s in samples], np.float32),
        "depth_gt": np.full((batch, h, w), PLANE_Z, np.float32),
        "mask": np.ones((batch, h, w), dtype=bool),
    }


def step_noise(batch: Dict[str, torch.Tensor], step: int, noise_seed: int = 1000) -> torch.Tensor:
    """Step `step`'s stage-3 noise [B, 48, H/8, W/8], uniform on [0, 1),
    from a generator on the batch's device seeded `noise_seed + step`."""
    images = batch["images"]
    b, _, h, w = images.shape[:4]
    gen = torch.Generator(device=images.device).manual_seed(noise_seed + step)
    return torch.rand(PatchmatchNet.noise_shape(b, h, w), generator=gen, device=images.device)


def _launch_diff(after: Dict[str, int], before: Dict[str, int], steps: int) -> Dict[str, float]:
    return {k: (n - before.get(k, 0)) / steps for k, n in sorted(after.items())
            if n != before.get(k, 0)}


def run(batch: Dict[str, np.ndarray], compute_dtype: Optional[torch.dtype], steps: int,
        log_every: int, *, device: str = "cuda",
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        noise_seed: int = 1000) -> Tuple[List[float], List[float]]:
    """Train a fresh model for `steps` steps on `batch` with Adam at 1e-3:
    the default initialization under `torch.manual_seed(0)`, or
    `state_dict` when given. Returns (losses, stage-0 depth errors), one
    host float per step."""
    dev = resolve_device(device)
    name = "f32" if compute_dtype is None else "bf16"
    if state_dict is None:
        model = seeded_model(compute_dtype)
    else:
        model = PatchmatchNet(compute_dtype=compute_dtype)
        model.load_state_dict(state_dict, strict=True)
    model = model.to(dev)
    optimizer = make_optimizer(model.parameters(), LEARNING_RATE)
    tensors = batch_to_device(batch, dev)
    losses: List[float] = []
    derr: List[float] = []
    walls: List[float] = []
    before = cuda_build.launch_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        start = time.perf_counter()
        metrics, _ = train_step(model, optimizer, tensors, LEARNING_RATE,
                                step_noise(tensors, i, noise_seed))
        losses.append(float(metrics["loss"]))  # waits for the step
        derr.append(float(metrics["depth-error-stage-0"]))
        walls.append(time.perf_counter() - start)
        if i == 0:
            t0 = time.perf_counter()  # the first step (cuDNN's choices) apart
        if i % log_every == 0 or i == steps - 1:
            print(f"[{name}] step {i:4d} loss {losses[-1]:.6e} depth-err {derr[-1]:.6e} "
                  f"wall {walls[-1] * 1e3:.1f} ms", file=sys.stderr, flush=True)
    dt = time.perf_counter() - t0
    later = walls[1:] or walls
    line = (f"[{name}] {steps} steps, {dt:.2f} s after the first step; step wall (synced) "
            f"median {statistics.median(later) * 1e3:.2f} ms, min {min(later) * 1e3:.2f}, "
            f"max {max(later) * 1e3:.2f}, first {walls[0] * 1e3:.1f} ms")
    if dev.type == "cuda":
        per_step = _launch_diff(cuda_build.launch_counts(), before, steps)
        line += f"; hand-kernel launches per step {per_step}"
    print(line, file=sys.stderr, flush=True)
    return losses, derr


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m patchmatchnet_torch.dev.bf16_train_compare")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--num-views", type=int, default=5)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu (plain versions)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    batch = build_batch(args.height, args.width, args.batch, args.num_views)
    f32_loss, f32_err = run(batch, None, args.steps, args.log_every, device=args.device)
    bf16_loss, bf16_err = run(batch, torch.bfloat16, args.steps, args.log_every,
                              device=args.device)
    if dev.type == "cuda":
        print(f"kernel launches: {cuda_build.launch_counts()}", file=sys.stderr, flush=True)
        print(f"card: {torch.cuda.get_device_name(dev)}", file=sys.stderr, flush=True)
    rel = np.abs(np.asarray(bf16_loss) - np.asarray(f32_loss)) / np.maximum(
        np.asarray(f32_loss), 1e-9)
    half = len(rel) // 2
    print(json.dumps({
        "steps": args.steps,
        "f32_final_loss": f32_loss[-1],
        "bf16_final_loss": bf16_loss[-1],
        "rel_loss_div_median": float(np.median(rel)),
        "rel_loss_div_p95": float(np.percentile(rel, 95)),
        "rel_loss_div_max_2nd_half": float(rel[half:].max()),
        "f32_final_depth_err": f32_err[-1],
        "bf16_final_depth_err": bf16_err[-1],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
