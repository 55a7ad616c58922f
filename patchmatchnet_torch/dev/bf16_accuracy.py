"""bf16 payload accuracy against the f32 path and the captured torch
reference: the port of `tools/dev/bf16_accuracy.py`.

    python -m patchmatchnet_torch.dev.bf16_accuracy [--device cuda|cpu] [FIXTURE ...]

Runs golden fixtures (`tests/golden/<name>.npz`, default forward_96x128
and forward_80x104_n5) through the released model with f32 payloads and
with bf16 ones, on the fixture's inputs and noise, and reports relative to
the depth range, per stage and iteration: max and mean |depth - reference|
of each precision and of bf16 against f32; and for the confidence of each
precision against the reference: max, median and the share above 5e-3.
`run` returns those numbers as a dict and prints them.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from patchmatchnet_torch.bench import forward, load_model, resolve_device

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "golden")
FIXTURES = ("forward_96x128", "forward_80x104_n5")
# (stage, iteration) of the per-stage depths; stage 0 is the refined depth
STAGES = ((3, 0), (3, 1), (2, 0), (2, 1), (1, 0), (0, 0))
PRECISIONS = ("f32", "bf16")


def run(fixture: str, device: str = "cuda") -> Dict[str, object]:
    """The accuracy report of one fixture: {"fixture", "device",
    "depth_range", "stages": {"stage{s}.it{i}": {"{f32|bf16}_vs_torch_max",
    "..._mean", "bf16_vs_f32_max", "bf16_vs_f32_mean"}} (relative to the
    depth range), "depth": the same for the refined depth, "confidence":
    {"f32"|"bf16": {"max", "median", "share_above_5e-3"}}}."""
    dev = resolve_device(device)
    g = np.load(os.path.join(GOLDEN, f"{fixture}.npz"))
    drange = float(g["depth_max"] - g["depth_min"])
    inputs = [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (
        g["images"][None], g["intrinsics"][None], g["extrinsics"][None],
        [g["depth_min"]], [g["depth_max"]])]
    noise = torch.from_numpy(np.asarray(g["noise"], np.float32)).to(dev)
    outs = {}
    for name in PRECISIONS:
        depth, confidence, dp = forward(load_model(name == "bf16", dev), inputs, noise)
        outs[name] = (depth.float().cpu().numpy(), confidence.float().cpu().numpy(),
                      {s: [d.float().cpu().numpy() for d in v] for s, v in dp.items()})

    def rel(a, b):
        d = np.abs(a - b)
        return float(d.max() / drange), float(d.mean() / drange)

    report: Dict[str, object] = {"fixture": fixture, "device": str(dev), "depth_range": drange}
    stages = {}
    for stage, it in STAGES:
        ref = g[f"stage{stage}_iter{it}"]
        row = {}
        for name in PRECISIONS:
            row[f"{name}_vs_torch_max"], row[f"{name}_vs_torch_mean"] = rel(
                outs[name][2][stage][it], ref)
        row["bf16_vs_f32_max"], row["bf16_vs_f32_mean"] = rel(
            outs["bf16"][2][stage][it], outs["f32"][2][stage][it])
        stages[f"stage{stage}.it{it}"] = row
    report["stages"] = stages
    depth = {}
    for name in PRECISIONS:
        depth[f"{name}_vs_torch_max"], depth[f"{name}_vs_torch_mean"] = rel(
            outs[name][0], g["depth"])
    depth["bf16_vs_f32_max"], depth["bf16_vs_f32_mean"] = rel(outs["bf16"][0], outs["f32"][0])
    report["depth"] = depth
    confidence = {}
    for name in PRECISIONS:
        cd = np.abs(outs[name][1] - g["confidence"])
        confidence[name] = {"max": float(cd.max()), "median": float(np.median(cd)),
                            "share_above_5e-3": float((cd > 5e-3).mean())}
    report["confidence"] = confidence

    print(f"=== {fixture} on {dev} (depth range {drange:g}) ===", flush=True)
    for key, row in stages.items():
        for name in PRECISIONS:
            print(f"  {key} {name:4s} vs torch: max {row[f'{name}_vs_torch_max']:.2e} "
                  f"mean {row[f'{name}_vs_torch_mean']:.2e} (rel range)", flush=True)
        print(f"  {key} bf16 vs f32  : max {row['bf16_vs_f32_max']:.2e} "
              f"mean {row['bf16_vs_f32_mean']:.2e}", flush=True)
    for name in PRECISIONS:
        c = confidence[name]
        print(f"  confidence {name}: max {c['max']:.2e} median {c['median']:.2e} "
              f"frac>5e-3 {c['share_above_5e-3']:.2e}", flush=True)
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m patchmatchnet_torch.dev.bf16_accuracy")
    ap.add_argument("fixtures", nargs="*", default=list(FIXTURES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu (plain versions)")
    args = ap.parse_args(argv)
    for fixture in args.fixtures:
        run(fixture, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
