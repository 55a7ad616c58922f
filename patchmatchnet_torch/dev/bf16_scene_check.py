"""bf16 against f32 on a textured synthetic scene of known depth: the port
of `tools/dev/bf16_scene_check.py`.

    python -m patchmatchnet_torch.dev.bf16_scene_check [--height 288 --width 400
        --num-views 5] [--device cuda|cpu]

Writes the plane scene (`data.make_synthetic_scene`, PNG images) to a
temporary directory, reads its view 0 through `data.MVSDataset` with
`num_views` - 1 sources, and runs the released model in both precisions on
it with the stage-3 noise of `default_rng(0)`. Reports |depth - GT| (mean,
median, 99th percentile; interior mean and max, 16 px in) for each
precision and |bf16 - f32| (mean, median, 99th percentile, max), in depth
units. bf16 is fit for inference where its delta to f32 stays well below
the estimator's own GT error.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from patchmatchnet_torch.bench import forward, load_model, resolve_device
from patchmatchnet_torch.data import PLANE_Z, MVSDataset, make_synthetic_scene
from patchmatchnet_torch.models import PatchmatchNet


def run(height: int = 288, width: int = 400, num_views: int = 5, device: str = "cuda",
        scratch: Optional[str] = None) -> Dict[str, object]:
    """Run the check in a temporary directory under `scratch` (the system's
    by default). Returns {"device", "shape", "num_views", "gt", "f32" and
    "bf16": {"mean", "median", "p99", "interior_mean", "interior_max"} of
    |depth - GT|, "bf16_vs_f32": {"mean", "median", "p99", "max"}}."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="bf16_scene_", dir=scratch) as tmp:
        make_synthetic_scene(tmp, num_views=num_views, height=height, width=width)
        s = MVSDataset(tmp, num_views=num_views - 1, image_extension=".png")[0]
    inputs = [torch.from_numpy(np.asarray(a, np.float32)[None]).to(dev) for a in (
        s["images"], s["intrinsics"], s["extrinsics"], s["depth_min"], s["depth_max"])]
    h, w = s["images"].shape[1:3]
    noise = torch.from_numpy(np.random.default_rng(0).random(
        PatchmatchNet.noise_shape(1, h, w)).astype(np.float32)).to(dev)

    gt = float(PLANE_Z)
    report: Dict[str, object] = {"device": str(dev), "shape": (h, w), "num_views": num_views,
                                 "gt": gt}
    depths = {}
    for name in ("f32", "bf16"):
        depth, _, _ = forward(load_model(name == "bf16", dev), inputs, noise)
        d = depth[0].float().cpu().numpy()
        depths[name] = d
        err = np.abs(d - gt)
        interior = err[16:-16, 16:-16]
        report[name] = {"mean": float(err.mean()), "median": float(np.median(err)),
                        "p99": float(np.percentile(err, 99)),
                        "interior_mean": float(interior.mean()),
                        "interior_max": float(interior.max())}
        r = report[name]
        print(f"{name}: |depth-GT| mean {r['mean']:.4e} median {r['median']:.4e} "
              f"p99 {r['p99']:.4e}; interior mean {r['interior_mean']:.4e} "
              f"max {r['interior_max']:.4e}", flush=True)
    dd = np.abs(depths["bf16"] - depths["f32"])
    report["bf16_vs_f32"] = {"mean": float(dd.mean()), "median": float(np.median(dd)),
                             "p99": float(np.percentile(dd, 99)), "max": float(dd.max())}
    r = report["bf16_vs_f32"]
    print(f"bf16 vs f32: mean {r['mean']:.4e} median {r['median']:.4e} p99 {r['p99']:.4e} "
          f"max {r['max']:.4e} (depth units, Z={gt}; {w}x{h}, N={num_views}, on {dev})",
          flush=True)
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m patchmatchnet_torch.dev.bf16_scene_check")
    ap.add_argument("--height", type=int, default=288)
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--num-views", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu (plain versions)")
    args = ap.parse_args(argv)
    run(args.height, args.width, args.num_views, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
