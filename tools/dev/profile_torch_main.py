#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on one GPU.

Run from the root of a checkout:

    python3 tools/dev/profile_torch_main.py [--dtypes bf16,f32] [--forwards 3]

For each compute dtype, with the released weights on a 1152x864, 5-view
synthetic scene (`patchmatchnet_torch.data.make_synthetic_scene`):

- request ms: `DepthEstimator` calls on a batch already in host memory
  (host clock, median of 10; includes the pageable image copy and the
  copy of the maps back);
- forward ms: the model alone on device-resident inputs, median of 10, by
  CUDA events and by the host clock around a synchronized call;
- H2D ms: the request's image copy alone (host clock, median of 10);
- one torch.profiler trace of `--forwards` back-to-back forwards: kernel
  launches per forward, device-busy ms per forward (the union of kernel,
  memcpy and memset intervals), the device idle share of the traced span
  (first to last device activity), device time per kernel kind (as
  `patchmatchnet_torch.utils.trace.kernel_kind` sorts them: element-wise,
  convolutions, hand kernels, ...), per hand kernel (K1-K7, by
  `patchmatchnet_torch.utils.trace.hand_kernel_id`) and per kernel name.

Then K2 (`eval_grid_score`) and K3 (`neighbor_group_corr`) alone at each
of the main path's stage shapes, on inputs made from a seed on the CPU:
device ms per call (bf16 cost and features) from a trace of 10 calls, and
the outputs in bf16 and f32, which `--save-outputs FILE` writes and
`--compare-outputs FILE` holds against the outputs another tree wrote (max
|this - that| per case). To compare two trees, run this script from each,
in turns, in one call.

Prints a summary; writes the per-kernel tables as JSON to
build/profile_torch_main.json (`--out`).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CKPT = os.path.join(REPO, "checkpoints", "params_000007.msgpack")
H, W, VIEWS = 864, 1152, 5
# the main path's K2 and K3 shapes: (stage, C, G, scale, K2's depths)
KERNEL_STAGES = ((3, 64, 8, 8, (64, 32)), (2, 32, 8, 4, (16,)), (1, 16, 4, 2, (8,)))


def cuda_ms(fn, reps=10):
    """Median device time of fn() by CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps=10):
    """Median host-clock time of a synchronized fn()."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def profile_dtype(name, state_dict, batch, device, forwards, out_dir):
    import torch

    from patchmatchnet_torch.infer import DepthEstimator
    from patchmatchnet_torch.models import PatchmatchNet
    from patchmatchnet_torch.ops import cuda_build
    from patchmatchnet_torch.utils.trace import (
        busy_union_us,
        hand_kernel_id,
        kernel_kind,
        trace_device_events,
    )

    dtype = {"bf16": torch.bfloat16, "f32": None}[name]
    model = PatchmatchNet(compute_dtype=dtype)
    model.load_state_dict(state_dict, strict=True)
    estimator = DepthEstimator(model, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    torch.cuda.reset_peak_memory_stats(device)
    for _ in range(2):  # warm-up: cuDNN algorithm selection, allocator growth
        estimator(batch, gen)
    request = []
    for _ in range(10):
        start = time.perf_counter()
        estimator(batch, gen)
        request.append((time.perf_counter() - start) * 1e3)

    inputs = [torch.as_tensor(batch[k]).to(device).float()
              for k in ("images", "intrinsics", "extrinsics", "depth_min", "depth_max")]
    noise = torch.rand(PatchmatchNet.noise_shape(1, H, W), generator=gen, device=device)

    def forward():
        with torch.inference_mode():
            model(*inputs, init_noise=noise)

    forward_events, forward_host = cuda_ms(forward), host_ms(forward)
    images = batch["images"]
    h2d = host_ms(lambda: torch.as_tensor(images).to(device))
    cuda_build.reset_launch_counts()
    forward()
    counters = cuda_build.launch_counts()

    events = trace_device_events(forward, forwards, os.path.join(out_dir, f"trace_{name}.json"))
    kernels = [e for e in events if e[0] == "kernel"]
    start = min(s for _, _, s, _ in events)
    end = max(s + d for _, _, s, d in events)
    busy = busy_union_us([(s, s + d) for _, _, s, d in events])
    by_name = defaultdict(lambda: [0, 0.0])
    by_kind = defaultdict(lambda: [0, 0.0])
    by_id = defaultdict(lambda: [0, 0.0])
    for _, kname, _, dur in kernels:
        tables = [(by_name, kname), (by_kind, kernel_kind(kname))]
        if hand_kernel_id(kname):
            tables.append((by_id, hand_kernel_id(kname)))
        for table, key in tables:
            table[key][0] += 1
            table[key][1] += dur
    table = sorted(({"kernel": k, "id": hand_kernel_id(k), "launches_per_forward": n / forwards,
                     "ms_per_forward": us / forwards / 1e3} for k, (n, us) in by_name.items()),
                   key=lambda r: -r["ms_per_forward"])
    return {
        "dtype": name,
        "request_ms": request,
        "request_ms_median": statistics.median(request),
        "forward_ms_cuda_events": forward_events,
        "forward_ms_host_clock": forward_host,
        "h2d_images_ms": h2d,
        "h2d_images_mib": images.nbytes / 2**20,
        "hand_kernel_launches_per_forward": counters,
        "traced_forwards": forwards,
        "kernel_launches_per_forward": len(kernels) / forwards,
        "device_busy_ms_per_forward": busy / forwards / 1e3,
        "traced_span_ms_per_forward": (end - start) / forwards / 1e3,
        "device_idle_share": 1.0 - busy / (end - start),
        "kinds": {k: {"launches_per_forward": n / forwards, "ms_per_forward": us / forwards / 1e3}
                  for k, (n, us) in by_kind.items()},
        "hand_kernels": {k: {"launches_per_forward": n / forwards,
                             "ms_per_forward": us / forwards / 1e3}
                         for k, (n, us) in sorted(by_id.items())},
        "kernels": table,
        "max_memory_allocated_mib": torch.cuda.max_memory_allocated(device) / 2**20,
    }


def kernel_cases(device, save_path, compare_path):
    """K2 and K3 alone at the main path's stage shapes on seeded inputs:
    device ms per call (bf16) and, against `compare_path`'s outputs, max
    |this - that| per case. Returns the JSON rows."""
    import torch

    from patchmatchnet_torch import ops
    from patchmatchnet_torch.models.patchmatch import (
        STAGE_CONFIG,
        build_offset_grid,
        evaluation_offsets,
    )
    from patchmatchnet_torch.utils.trace import device_ms

    gen = torch.Generator().manual_seed(0)

    def rand(*shape, normal=False):
        t = torch.randn(shape, generator=gen) if normal else torch.rand(shape, generator=gen)
        return t.to(device)

    outputs, rows = {}, []
    for stage, c, g, scale, depths in KERNEL_STAGES:
        h, w = H // scale, W // scale
        cfg = STAGE_CONFIG[stage]
        grid = build_offset_grid(rand(1, h, w, 18, normal=True) * 2.0,
                                 evaluation_offsets(cfg.propagation_range), h, w)
        fw = rand(1, 9, h, w) * 0.9 + 0.1
        feats = rand(1, h, w, c, normal=True)
        x_norm = {d: rand(1, h, w, d) for d in depths}
        cost = {d: rand(1, h, w, d, normal=True) for d in depths}
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            ref = feats.to(dtype)
            cases = [(f"K3 stage{stage} C{c} G{g} K9 {h}x{w} {tag}",
                      lambda ref=ref: ops.neighbor_group_corr(ref, grid, g))]
            for d in depths:
                cases.append((f"K2 stage{stage} D{d} {h}x{w} cost {tag}",
                              lambda d=d, dt=dtype: ops.eval_grid_score(
                                  x_norm[d], cost[d].to(dt), grid, fw, cfg.interval_scale)))
            for label, fn in cases:
                outputs[label] = fn().cpu()
                row = {"case": label, "device_ms": device_ms(fn) if tag == "bf16" else None}
                rows.append(row)
    if save_path:
        torch.save(outputs, save_path)
    if compare_path:
        other = torch.load(compare_path)
        for row in rows:
            row["max_abs_diff_vs_compared"] = (
                outputs[row["case"]] - other[row["case"]]).abs().max().item()
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtypes", default="bf16,f32")
    parser.add_argument("--forwards", type=int, default=3)
    parser.add_argument("--out", default=os.path.join(REPO, "build", "profile_torch_main.json"))
    parser.add_argument("--save-outputs", help="write the kernel cases' outputs here")
    parser.add_argument("--compare-outputs", help="hold the kernel cases' outputs against these")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", flush=True)
        return 1
    from patchmatchnet_torch.compat import read_flax_msgpack, state_dict_from_jax
    from patchmatchnet_torch.data import BatchLoader, MVSDataset, make_synthetic_scene
    from patchmatchnet_torch.utils.trace import fmt_ms

    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    state_dict = state_dict_from_jax(read_flax_msgpack(CKPT))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="profile_scene_", dir=os.path.join(REPO, "build"))
    try:
        make_synthetic_scene(scratch, num_views=VIEWS, height=H, width=W, texture_scale=8.0)
        batch = next(iter(BatchLoader(MVSDataset(scratch, VIEWS - 1, ".png"), num_threads=1)))
        results = [profile_dtype(name, state_dict, batch, device, args.forwards, scratch)
                   for name in args.dtypes.split(",")]
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    cases = kernel_cases(device, args.save_outputs, args.compare_outputs)
    with open(args.out, "w") as f:
        json.dump({"card": card, "results": results, "kernel_cases": cases}, f, indent=1)
    for r in results:
        print(f"{r['dtype']}: request median {r['request_ms_median']:.2f} ms ("
              + " ".join(f"{t:.2f}" for t in r["request_ms"]) + ")")
        print(f"  forward {r['forward_ms_cuda_events']:.2f} ms (CUDA events) "
              f"{r['forward_ms_host_clock']:.2f} ms (host clock); H2D images "
              f"{r['h2d_images_ms']:.2f} ms for {r['h2d_images_mib']:.1f} MiB; peak "
              f"{r['max_memory_allocated_mib']:.1f} MiB")
        print(f"  trace of {r['traced_forwards']} forwards: "
              f"{r['kernel_launches_per_forward']:.0f} kernel launches per forward, "
              f"device busy {r['device_busy_ms_per_forward']:.2f} ms of "
              f"{r['traced_span_ms_per_forward']:.2f} ms span per forward, idle share "
              f"{r['device_idle_share']:.3f}; hand kernels per forward "
              f"{r['hand_kernel_launches_per_forward']}")
        print("  device ms per forward by kind (launches): " + ", ".join(
            f"{k} {v['ms_per_forward']:.3f} ({v['launches_per_forward']:.0f})"
            for k, v in sorted(r["kinds"].items(), key=lambda kv: -kv[1]["ms_per_forward"])))
        print("  hand kernels per forward (launches): " + ", ".join(
            f"{k} {v['ms_per_forward']:.3f} ({v['launches_per_forward']:.0f})"
            for k, v in r["hand_kernels"].items()))
        for row in r["kernels"][:15]:
            print(f"    {row['ms_per_forward']:.3f} ms x{row['launches_per_forward']:.0f} "
                  f"{row['id'] or '-'} {row['kernel'][:110]}")
    for row in cases:
        line = f"  {row['case']}: device {fmt_ms(row['device_ms'])}"
        if "max_abs_diff_vs_compared" in row:
            line += f", max |this - compared| {row['max_abs_diff_vs_compared']:.3e}"
        print(line)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
