"""The estimator at the ETH3D and Tanks and Temples evaluation geometries:
the port of `tools/dev/bench_dataset_configs.py`.

    python -m patchmatchnet_torch.dev.bench_dataset_configs [--config eth3d|tanks|all]
        [--iters 4] [--device cuda|cpu]

The reference's evaluation presets (`scripts/eval.sh`): ETH3D with 7 views
at image_max_dim 2688, Tanks and Temples with 7 views at 2048. Each config
synthesizes `bench.build_inputs` scenes at those (mixed) image geometries
and runs the bf16 `DepthEstimator(model, device, bucket_multiple=64)` on
them, so portrait and landscape ETH3D views share the estimator and Tanks'
1056 rows pad to 1088. Per shape it reports:

- `ms_per_map_e2e`: the estimator's call (pad, copy to the device, forward,
  crop, resize back, copy to the host) over `iters` calls after a first;
- `first_call_s`: that first call (cuDNN plans its convolutions once per
  shape, the allocator grows);
- `ms_per_map_device` and `mpix_s_device`: the forward alone on inputs
  padded as the estimator pads them and staged on the device, `iters`
  calls enqueued with distinct noises from `default_rng(7)`, then one
  synchronize;

and per config the device they ran on, the `mpix_s_device` over its shapes
and `padded_shapes`, the distinct padded shapes the model ran. The JAX
tool's `escapes`, `escape_fallbacks` and `compiles` belong to its windowed
sampler and jit cache, which the port does not have.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from patchmatchnet_torch.bench import build_inputs, load_model, resolve_device, synchronize
from patchmatchnet_torch.infer import DepthEstimator
from patchmatchnet_torch.models import PatchmatchNet

# name: (num_views, [per-view (H, W) after max_dim scaling], bucket)
# ETH3D: 6048x4032 sensors -> 2688x1792 at max_dim 2688; some scans mix
# portrait and landscape. Tanks: 1920x1080 -> 2048 cap leaves 1920x1080
# (1920x1056 as the reference pipeline rounds to multiples of 8).
CONFIGS: Dict[str, Tuple[int, List[Tuple[int, int]], int]] = {
    "eth3d": (7, [(1792, 2688), (1792, 2688), (2688, 1792)], 64),
    "tanks": (7, [(1056, 1920), (1056, 1920), (1056, 1920)], 64),
}


def run_config(name: str, iters: int = 4, device: str = "cuda", bf16: bool = True,
               configs: Optional[Dict[str, Tuple[int, Sequence[Tuple[int, int]], int]]] = None
               ) -> dict:
    """Run config `name` of `configs` (CONFIGS by default) with the released
    weights in bf16 (f32 with `bf16=False`). Returns the report: "config",
    "num_views", "shapes", "per_shape" (one dict per shape), "mpix_s_device",
    "padded_shapes" and "maps", per shape the (depth, confidence) of the
    device timing's first call (noise 0 of `default_rng(7)`), cropped to the
    shape."""
    num_views, shapes, bucket = (configs or CONFIGS)[name]
    dev = resolve_device(device)
    est = DepthEstimator(load_model(bf16, dev), dev, bucket_multiple=bucket)

    results: dict = {"config": name, "device": str(dev), "num_views": num_views,
                     "shapes": list(shapes)}
    total_pix = 0.0
    total_time = 0.0
    per_shape, maps, padded = [], [], set()
    for h, w in shapes:
        images, intr, extr, dmin, dmax, _ = build_inputs(1, num_views, h, w)
        batch = {"images": images, "intrinsics": intr, "extrinsics": extr,
                 "depth_min": dmin, "depth_max": dmax}
        # end to end: the first call apart, then `iters` calls, each
        # returning host arrays
        t0 = time.perf_counter()
        est(batch, torch.Generator(device=dev).manual_seed(0))
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(iters):
            est(batch, torch.Generator(device=dev).manual_seed(i + 1))
        dt = (time.perf_counter() - t0) / iters

        # device side: inputs padded as the estimator pads them and staged
        # once, a distinct noise per call
        m = est.bucket_multiple or 8
        hb, wb = -(-h // m) * m, -(-w // m) * m
        padded.add((hb, wb))
        img_p = np.pad(images, ((0, 0), (0, 0), (0, hb - h), (0, wb - w), (0, 0)), mode="edge")
        args = [torch.from_numpy(a).to(dev) for a in (img_p, intr, extr, dmin, dmax)]
        noises = torch.from_numpy(np.random.default_rng(7).random(
            (iters, *PatchmatchNet.noise_shape(1, hb, wb)), np.float32)).to(dev)
        with torch.inference_mode():
            depth, confidence = est._forward(*args, noises[0])
            maps.append((depth[0, :h, :w].float().cpu().numpy(),
                         confidence[0, :h, :w].float().cpu().numpy()))
            synchronize(dev)
            t0 = time.perf_counter()
            outs = [est._forward(*args, noises[i]) for i in range(iters)]
            synchronize(dev)
            dt_dev = (time.perf_counter() - t0) / iters
        del outs, args, noises

        per_shape.append({"shape": (h, w), "ms_per_map_e2e": dt * 1e3,
                          "ms_per_map_device": dt_dev * 1e3,
                          "mpix_s_device": h * w / 1e6 / dt_dev,
                          "first_call_s": first_s})
        total_pix += h * w * iters
        total_time += dt_dev * iters
    results["per_shape"] = per_shape
    results["mpix_s_device"] = total_pix / 1e6 / total_time
    results["padded_shapes"] = sorted(padded)
    results["maps"] = maps
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m patchmatchnet_torch.dev.bench_dataset_configs")
    ap.add_argument("--config", default="all", choices=["eth3d", "tanks", "all"])
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu (plain versions)")
    args = ap.parse_args(argv)
    names = list(CONFIGS) if args.config == "all" else [args.config]
    for name in names:
        res = run_config(name, args.iters, args.device)
        for s in res["per_shape"]:
            print(f"{name} {s['shape'][0]}x{s['shape'][1]} N={res['num_views']} on "
                  f"{res['device']}: "
                  f"e2e {s['ms_per_map_e2e']:.1f} ms/map, device {s['ms_per_map_device']:.1f} "
                  f"ms/map ({s['mpix_s_device']:.2f} MPix/s), first call "
                  f"{s['first_call_s']:.2f} s", flush=True)
        print({k: v for k, v in res.items() if k != "maps"}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
