#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`patchmatchnet_torch`) on one GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases, each
reported on its own lines; any failure exits non-zero without the final
result line:

1. device: a CUDA device is required; prints `nvidia-smi` name/power limit.
2. build: compiles `patchmatchnet_torch/csrc/*.cu` with nvcc (sm_90a).
3. kernel parity: K1, K2, K3, K6 and K7 against their plain PyTorch
   versions on the card, at the main paths' stage shapes, with bf16 and
   f32 payloads; kernel and plain times (median of CUDA-event timings),
   each kernel's device time (busy time per call in a torch.profiler trace
   of 10 calls) and its bound (the larger of its bytes over the card's
   memory rate and its f32 operations over its f32 rate). Fails unless K6
   equals the per-view route it replaces (4 K1 launches and the weighted
   sum), also with 64 views at stage 2's shape, and K7 on the warp
   coordinates equals K1, both to the bit; K7 on those coordinates (the
   same tiled kernel reading the coordinates K1 computes) is timed beside
   K1. One line per kernel of the main path gives its device ms per stage
   shape and per forward. Phase 12's shapes are held to the same bounds and
   timed beside them, outside the kernels line: its non-default
   configuration's (K3 and K2 at Ke = 17 (stages 3 and 1), K1, K6 (also
   against the per-view route, to the bit) and K2 at D = 20 (stage 2) and
   D = 12 (stage 1)) and the DTU preset's (1600x1200, stage maps 150x200,
   300x400 and 600x800: K1 on each of 5 sources, K6 at V = 5, also against
   the per-view route to the bit, K3 and K2), with its hand-kernel device
   ms per forward.
4. f32 golden parity: the f32 model (kernels on, TF32 off) against the
   captured reference outputs in tests/golden/.
5. main path: a 1152x864, 5-view synthetic scene through MVSDataset ->
   bf16 DepthEstimator -> save_depth_maps; checks finite maps, the GT
   error and the per-request kernel launch counts (K1 4 / K6 4 / K2 5 /
   K3 3); reports ms per map, MPix/s and peak device memory.
6. coordinate-input path: a plane sweep through `coord_group_corr` (K7) on
   the scene's bf16 features at each stage's resolution, C and G (D 64, 16,
   8; 4 source views; `dev.profile_coord.sweep_coords`): K7 launches, K7
   equal to K1 on the same coordinates to the bit, the winner-take-all
   depth against the plane, and K7's device ms per stage and per sweep on
   the sweep's coordinates.
7. backward-kernel parity: K4 and K5 against their plain versions
   (autograd through the plain forwards) at the training stage shapes of
   640x512, B=2, bf16 and f32 payloads; errors relative to the largest
   gradient entry; kernel and plain backward times and the wrapper's
   device time per launch and per train step. K4 runs on i.i.d. depths and
   on the training path's layout (stratified bins at stage 3 D64, a
   perturbed plane elsewhere), each case with its scatter count
   (`k4_scatter_counts`): the 16-byte atomics into d_src beside the design
   before's, and the runs of consecutive samples in one cell. K5 at Ke = 17
   (stages 3 and 1) and K4 at D = 20 and 12 (stages 2 and 1), phase 12's
   non-default configuration, are held to the same bounds and timed; so
   are K4 (both depth layouts) and K5 at phase 12 (b)'s B = 8, with K1 and
   K3 forward at B = 8 held to phase 3's bounds; K4's device ms per train
   step at B = 8 with 1 + 5 views is printed.
8. f32 train-step parity: one f32 train step (kernels on, TF32 off) on a
   64x80, 3-view plane batch against the same step on the CPU (plain
   versions): loss and per-leaf gradient cosine, and the step's launches.
9. training path: bf16 at 640x512, N=5, B=2 on a 12-view synthetic plane
   scene with depth_gt, warm-started from params_000007: one warm-up step
   and 6 timed train steps (finite losses, launches per step K1 20 / K4 20
   / K3 3 / K5 3 / K2 0, ms per step, samples/s, peak memory; a
   torch.profiler trace of 2 more steps: launches, device-busy time and
   device time by kernel kind and by hand kernel id per step; K4's
   scatter count over the 20 K4 calls of one more step); a
   checkpoint after the last timed step, resumed into a fresh model and
   optimizer, reproduces the next step's loss to 1e-5; then
   `run_training` for one epoch (6 steps and validation) through the
   driver, with its launch counts.
10. gather microbenchmarks (D1-D5) on the card: every section of
   `patchmatchnet_torch.dev.bench_gather` at the JAX tool's shapes (the
   `xla` row gather at the three stage shapes, D1/D2, D3, D4 and D5); each
   section holds its kernel against the plain version and `torch.gather`
   in every element. One line per case with kernel, plain, `torch.gather`
   and bound ms (CUDA events around batches of calls), and the kernel's and
   `torch.gather`'s device time from a profiler trace; launches counted
   per section.
11. reconstruction path: an 11-view 1152x864 synthetic scan whose pair.txt
   gives each reference its 10 sources best first (as DTU's): the bf16
   DepthEstimator (1 + 4 views per map) writes COLMAP .bin depth and
   confidence maps through save_depth_maps (launches 4/4/5/3 per map), and
   filter_and_fuse (FusionConfig defaults) fuses them on the card into
   fused.ply, once to warm up and once timed; prints each view's mask
   shares, the point count, fusion ms per reference view split into reads,
   consistency, mask PNGs, backprojection and the PLY write, and peak
   memory. Fails unless the PLY has points whose median |z - plane| is
   within 5% of the plane depth, and, for two reference views, the card's
   per-pixel consistent-view counts and final mask differ from the CPU's at
   most at 0.1% of the pixels and the fused points of pixels in both final
   masks agree within 1e-4 relative.
12. CLI path: `python -m patchmatchnet_torch` in its own process, each run
   with its own timeout (CLI_TIMEOUT), printing the hand-kernel launches it
   made, which must be those of its forwards and steps:
   (a) `eval` with scripts/eval.sh's DTU flags (`--num_views 5
   --image_max_dim 1600 --geo_mask_thres 3 --photo_thres 0.8`, a scan
   list of one scan) on a 7-view 1600x1200 scan: every view's depth and
   confidence maps at 1600x1200, the median |depth - plane| on each view's
   final mask and the fused points' median |z - plane| within 5% of the
   plane, ms per map and per fused view; view 0's map against
   DepthEstimator in this process (same weights, inputs and noise; every
   kernel of the forward is deterministic, so it should be equal: bound
   median 0 and at most 0.1% of the pixels off by more than 1e-3 of the
   depth range, room for another cuDNN algorithm in another process),
   then warm in-process ms per map at the same preset;
   (b) `train` with scripts/train.sh's flags that apply (`--batch_size 8
   --epochs 1`, `--image_max_dim` 640) from the released weights on a
   24-view 640x512 scan: 3 steps at 1 + 5 views, ms per step, peak MiB,
   the checkpoint set and finite losses;
   (c) the non-default configuration (VARIANT_FLAGS: propagation 4/8/16,
   evaluation 17/9/17, iterations 2/1/2, samples 8/12/16) trained one
   epoch from scratch at 640x512, B = 2, then `eval --output_type depth`
   from the `module_000000.pt` it wrote at 1152x864, 1 + 4 views.

The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON summary.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "checkpoints", "params_000007.msgpack")
MAIN_H, MAIN_W, MAIN_VIEWS, REQUESTS = 864, 1152, 5, 5
# per-forward launches of each kernel on the bf16 main path: K1 on stage
# 3's first evaluation (one per source view), K6 on every later one
EXPECTED_PER_FORWARD = {"warp_group_corr": 4, "warp_group_corr_views": 4,
                        "eval_grid_score": 5, "neighbor_group_corr": 3}
# plane sweep of the coordinate-input path: stage -> hypotheses
SWEEP_DEPTHS = {3: 64, 2: 16, 1: 8}
# reconstruction path: an 11-view scan (each reference with 10 sources, as
# DTU's pair.txt), and the reference views whose fusion is held against the
# CPU's (the middle view and an end view)
RECON_VIEWS = 11
FUSION_CHECK_VIEWS = (5, 0)
# the command line (phase 12): scripts/eval.sh's DTU preset on a 7-view scan
# at DTU's test image size (each reference with 6 sources, 5 taken), and
# scripts/train.sh's batch on a 24-view 640x512 scan (3 steps of 8)
DTU_EVAL_FLAGS = ["--num_views", "5", "--image_max_dim", "1600", "--geo_mask_thres", "3",
                  "--photo_thres", "0.8"]
CLI_EVAL_SCAN, CLI_EVAL_VIEWS, CLI_EVAL_SOURCES, CLI_EVAL_H, CLI_EVAL_W = "scan1", 7, 5, 1200, 1600
# The preset keeps pixels of photometric confidence > 0.8, a stage-1 score
# peaked on few of its 8 close hypotheses, which takes texture of a few
# pixels' period, as DTU's surfaces have. The smooth texture of the other
# phases (scale 8) leaves the stage-1 score nearly flat (confidence 0.50-0.55:
# no pixel passes); scale 128 gives a period of ~4.6 px at 1600x1200.
CLI_EVAL_TEXTURE = 128.0
CLI_TRAIN_SCAN, CLI_TRAIN_VIEWS, CLI_TRAIN_BATCH = "scan2", 24, 8
CLI_TIMEOUT = 300  # seconds, each CLI process
# the source views' x baselines of the parity rig (the first is the reference)
RIG_BASELINES = (0.0, 0.35, -0.35, 0.7, -0.7)
# the rig of phase 12 (a)'s kernel shapes: 1 + 5 views
DTU_RIG_BASELINES = RIG_BASELINES + (1.05,)
# K6 beyond a block's chunk of views (csrc/group_corr.cu `kViewChunk`): views,
# at stage 2's shape
MANY_VIEWS = 64
# training geometry (the JAX trainer's DTU configuration)
TRAIN_H, TRAIN_W, TRAIN_VIEWS, TRAIN_BATCH, TRAIN_SCENE_VIEWS = 512, 640, 5, 2, 12
TIMED_STEPS = 6
# per-train-step launches at N=5 (K2 has no backward; the training tail is plain)
EXPECTED_PER_STEP = {"warp_group_corr": 20, "warp_group_corr_backward": 20,
                     "neighbor_group_corr": 3, "neighbor_group_corr_backward": 3,
                     "eval_grid_score": 0}
# The non-default configuration of phase 12 (c) and what it gives the
# kernels at each stage of the main path's shape: stage -> (Ke, D of its
# evaluations). D = 20 (12 + 8 propagated) and 12 (8 + 4) are new depths;
# K3 and K5 take Ke = 17 in two blocks of neighbours.
VARIANT_FLAGS = ["--propagate_neighbors", "4", "8", "16", "--evaluate_neighbors", "17", "9", "17",
                 "--patchmatch_iteration", "2", "1", "2", "--patchmatch_num_sample", "8", "12",
                 "16"]
VARIANT_STAGES = {3: (17, (64, 32)), 2: (9, (20,)), 1: (17, (12, 8))}
# the kernel cases held and timed outside the kernels line: phase 12's
# shapes that the main paths of phases 5 and 9 do not give
VARIANT = "variant configuration (phase 12 (c))"
DTU_PRESET = "DTU preset (phase 12 (a))"
CLI_BATCH = "B 8 (phase 12 (b))"
KERNEL_INFO = {
    "warp_group_corr": ("patchmatchnet_torch/csrc/group_corr.cu",
                        "patchmatchnet_tpu/ops/pallas/windowed_similarity.py:419"),
    "eval_grid_score": ("patchmatchnet_torch/csrc/eval_tail.cu",
                        "patchmatchnet_tpu/ops/pallas/eval_tail.py:112"),
    "neighbor_group_corr": ("patchmatchnet_torch/csrc/group_corr.cu",
                            "patchmatchnet_tpu/ops/pallas/similarity_kernel.py:88"),
    "warp_group_corr_backward": ("patchmatchnet_torch/csrc/group_corr_bwd.cu",
                                 "patchmatchnet_tpu/ops/pallas/windowed_similarity.py:743"),
    "neighbor_group_corr_backward": ("patchmatchnet_torch/csrc/group_corr_bwd.cu",
                                     "patchmatchnet_tpu/ops/pallas/similarity_kernel.py:187"),
    "warp_group_corr_views": ("patchmatchnet_torch/csrc/group_corr.cu",
                              "patchmatchnet_tpu/ops/pallas/windowed_similarity.py:942"),
    "coord_group_corr": ("patchmatchnet_torch/csrc/group_corr.cu",
                         "patchmatchnet_tpu/ops/pallas/windowed_similarity.py:375"),
}
# The gather microbenchmarks' kernels, one entry per TPU kernel of
# tools/dev/bench_gather.py: id -> (kernel, section of the port's tool,
# the pallas_call it replaces). D1 and D2 are one function on the card (the
# JAX D1 writes only the first block of each 8 of its grid step).
GATHER_KERNELS = {
    "D1": ("gather_lanes", "lane", "tools/dev/bench_gather.py:96"),
    "D2": ("gather_lanes", "lane", "tools/dev/bench_gather.py:112"),
    "D3": ("gather_lanes", "biglane", "tools/dev/bench_gather.py:145"),
    "D4": ("gather_sublanes", "sublane", "tools/dev/bench_gather.py:180"),
    "D5": ("gather_rows", "onehot", "tools/dev/bench_gather.py:219"),
}
GATHER_SOURCE = "patchmatchnet_torch/csrc/gather.cu"
# how the kernels line's ms, plain_ms, device_ms and library_ms were taken
KERNEL_TIMING = ("ms and plain_ms: median of 20 single calls between two CUDA events, host "
                 "work included; device_ms: device busy time per call in a profiler trace of "
                 "10 calls")
GATHER_TIMING = ("median of 20 CUDA-event samples of 10 calls in a row, per call; "
                 "device_ms and library_device_ms: device busy time per call in a "
                 "profiler trace of 10 calls")
INFERENCE_KERNELS = ("warp_group_corr", "eval_grid_score", "neighbor_group_corr",
                     "warp_group_corr_views", "coord_group_corr")
BACKWARD_KERNELS = ("warp_group_corr_backward", "neighbor_group_corr_backward")
# Kernel vs plain version: the same f32 math in another summation order.
# K1/K3/K6/K7: the plain version goes through F.grid_sample's normalized
# coordinates, which moves a sample by up to ~1 ulp of its pixel coordinate
# (6e-5 px at x ~ 500) against per-pixel feature jumps of O(1) in these
# random inputs. K2: that shift of the sampled x_norm (random per pixel, so
# also O(1) jumps) enters the sigmoid depth weight multiplied by
# 2 / interval, so its max bound scales with 1 / interval: 2e-5 / interval
# is 8e-4, 1.6e-3 and 4e-3 at stages 3, 2 and 1.


def parity_tol(name: str, interval: float):
    """(max abs, mean abs) bound of kernel vs plain version on O(1) outputs."""
    if name == "eval_grid_score":
        return 2e-5 / interval, 2e-5
    return 2e-3, 2e-5


# The card's peak rates for the bound of a kernel (NVIDIA H100 SXM data
# sheet): device memory 3.35 TB/s; f32 outside the tensor cores 67 TFLOP/s.
# Every hand kernel computes in f32 on the CUDA cores.
MEMORY_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def sample_ops(c: int) -> int:
    """f32 operations to reduce one sample of a C-channel map (K1, K3, K7):
    4 bilinear taps x C multiply-adds, C multiply-adds with the reference,
    and ~24 for the cell, the weights and the group scaling."""
    return 10 * c + 24


def kernel_work(name: str, args, out) -> tuple:
    """(bytes, operations) one call of kernel `name` must do on these
    inputs: each input read once and each output written once, and its
    f32 arithmetic (a multiply-add is 2 operations)."""
    if name == "warp_group_corr":  # src, mat12, depth, ref, g
        src, _, depth, _, _ = args
        return nbytes(*args[:4], out), depth.numel() * sample_ops(src.shape[-1])
    if name == "coord_group_corr":  # src, ix, iy, ref, g
        src, ix, _, _, _ = args
        return nbytes(*args[:4], out), ix.numel() * sample_ops(src.shape[-1])
    if name == "warp_group_corr_views":  # src [B,V,...], mats, depth, ref, vw, g
        src, _, depth, _, _, g = args
        per_view = sample_ops(src.shape[-1]) + 2 * g  # and the weighted sum
        return nbytes(*args[:5], out), depth.numel() * src.shape[1] * per_view
    if name == "neighbor_group_corr":  # ref, (gx, gy), g
        ref, (gx, gy), _ = args
        return nbytes(ref, gx, gy, out), gx.numel() * sample_ops(ref.shape[-1])
    if name == "eval_grid_score":  # x_norm, cost, (gx, gy), fw, interval
        x_norm, cost, (gx, gy), fw, _ = args
        # per (pixel, hypothesis, neighbour): 2 four-tap samples, the
        # sigmoid weight and the two sums, ~40 operations
        return nbytes(x_norm, cost, gx, gy, fw, out), x_norm.numel() * gx.shape[1] * 40
    if name == "warp_group_corr_backward":  # src, mat12, depth, ref, g, dout
        src, _, depth, _, _, dout = args
        return (nbytes(*args[:4], dout, *out),
                depth.numel() * (2 * sample_ops(src.shape[-1])))
    if name == "neighbor_group_corr_backward":  # ref, (gx, gy), g, dout
        ref, (gx, gy), _, dout = args
        return nbytes(ref, gx, gy, dout, *out), gx.numel() * (sample_ops(ref.shape[-1]) + 8)
    raise KeyError(name)


def bound(work_bytes: float, work_ops: float):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    by_bytes = work_bytes / MEMORY_BYTES_PER_S * 1e3
    by_ops = work_ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def new_summary(names):
    return {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0,
                   "bytes": 0, "ops": 0}
            for name in names}


def add_time(entry, name, args, out, launches, ms, plain_ms, dev_ms):
    """Add `launches` calls of `name` at these inputs to a summary entry
    (its device_ms becomes None once a device time is missing)."""
    work_bytes, work_ops = kernel_work(name, args, out)
    entry["ms"] += ms * launches
    entry["plain_ms"] += plain_ms * launches
    entry["device_ms"] = (None if dev_ms is None or entry["device_ms"] is None
                          else entry["device_ms"] + dev_ms * launches)
    entry["bytes"] += work_bytes * launches
    entry["ops"] += work_ops * launches


def hold(name: str, label: str, got, want, interval: float) -> float:
    """Print a kernel's error against its plain version and fail outside
    `parity_tol`; returns the max abs error."""
    err = (got - want).abs()
    max_abs, mean_abs = err.max().item(), err.mean().item()
    tol_max, tol_mean = parity_tol(name, interval)
    print(f"{name} {label}: max_abs {max_abs:.3e} mean_abs {mean_abs:.3e}", flush=True)
    if not (max_abs <= tol_max and mean_abs <= tol_mean):
        fail(f"{name} {label} exceeds max {tol_max} / mean {tol_mean}")
    return max_abs


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() over `reps` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rig_cameras(h: int, w: int, f: float, baselines=RIG_BASELINES[:2]):
    """Projections [1, len(baselines), 4, 4] of the rig at focal length `f`
    for an h x w image, one camera per x baseline."""
    import torch

    k = torch.tensor([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]])
    projs = []
    for tx in baselines:
        p = torch.eye(4)
        p[:3, :4] = k @ torch.tensor([[1.0, 0, 0, tx], [0, 1, 0, 0], [0, 0, 1, 0]])
        projs.append(p)
    return torch.stack(projs)[None]


def per_view_route(src, mats, depth, ref, view_weights, groups):
    """What K6 replaces, its reference on the card: K1 per source view, each
    volume times its weights, added to a zeroed sum in view order (as
    models/patchmatch.py `Evaluation` does where K6 cannot run)."""
    import torch

    from patchmatchnet_torch import ops

    b, _, h, w = view_weights.shape
    out = torch.zeros((b, groups, depth.shape[1], h, w), dtype=torch.float32,
                      device=src.device)
    for v in range(src.shape[1]):
        sim = ops.warp_group_corr(src[:, v], mats[:, v].contiguous(), depth, ref, groups)
        out = out + sim * view_weights[:, v, None, None]
    return out


def kernel_parity(device):
    """Phase 3: returns {kernel: {"max_abs_err", "ms", "plain_ms",
    "device_ms", "bytes", "ops"}} with times and work summed over the
    kernel's launches per pass of its path (bf16 payloads): a forward of the
    main path for K1, K2, K3 and K6, a plane sweep for K7. Fails unless K6
    equals the per-view route (also with MANY_VIEWS views at stage 2, and
    at V = 5 at the DTU preset's shapes) and K7 on the warp coordinates
    equals K1, to the bit, in bf16 and f32."""
    import torch

    from patchmatchnet_torch import ops
    from patchmatchnet_torch.dev.profile_coord import rig_mats
    from patchmatchnet_torch.models.patchmatch import (
        STAGE_CONFIG,
        build_offset_grid,
        evaluation_offsets,
    )
    from patchmatchnet_torch.ops.warp import warp_coords, warp_proj_coeffs
    from patchmatchnet_torch.utils.trace import device_ms, fmt_ms

    gen = torch.Generator(device=device).manual_seed(0)
    # (stage, C, G, scale, [(D, launches per forward of K1, of K2)],
    #  [(D, launches per forward of K6)])
    stages = [
        (3, 64, 8, 8, [(64, 4, 1), (32, 0, 1)], [(32, 1)]),
        (2, 32, 8, 4, [(16, 0, 2)], [(16, 2)]),
        (1, 16, 4, 2, [(8, 0, 1)], [(8, 1)]),
    ]
    summary = new_summary(INFERENCE_KERNELS)
    route = {"ms": 0.0, "max_abs_diff": 0.0}  # K6 against the per-view route
    k7_vs_k1 = [0.0]
    # K1 against K7 on K1's warp coordinates (one tiled kernel, the cell
    # warped or read), device ms per forward of the main path
    baseline = {"k1": 0.0, "k7": 0.0}
    # device ms per call of each timed (bf16) case: kernel -> [(label, ms, launches)]
    per_stage = {name: [] for name in INFERENCE_KERNELS}
    # cases outside the kernels line: set -> [(kernel, label, device ms, launches per forward)]
    extra_rows = {VARIANT: [], DTU_PRESET: []}
    variant_grids = {}  # stage -> (eval grid, feature weights) at the variant's Ke
    vgen = torch.Generator(device=device).manual_seed(10)  # leaves gen's draws as they were

    def record(name, label, args, got, want, launches, timed, fn, plain_fn, interval,
               extra=None):
        """Hold a kernel's output against its plain version; time the bf16
        cases of the main path (`launches` per pass) and of the sets of
        `extra_rows` (`extra`: printed, not summed into the pass)."""
        err = (got - want).abs()
        max_abs, mean_abs = err.max().item(), err.mean().item()
        tol_max, tol_mean = parity_tol(name, interval)
        ok = max_abs <= tol_max and mean_abs <= tol_mean
        line = f"{name} {label}: max_abs {max_abs:.3e} mean_abs {mean_abs:.3e}"
        s = summary[name]
        s["max_abs_err"] = max(s["max_abs_err"], max_abs)
        if timed and (launches or extra):
            ms, plain_ms, dev_ms = time_ms(fn), time_ms(plain_fn), device_ms(fn)
            if extra:
                extra_rows[extra].append((name, label.split(" (")[0], dev_ms, launches))
            else:
                add_time(s, name, args, got, launches, ms, plain_ms, dev_ms)
                per_stage[name].append((label.split(" (")[0], dev_ms, launches))
            work_ms, by = bound(*kernel_work(name, args, got))
            line += (f" | kernel {ms:.4f} ms device {fmt_ms(dev_ms)} plain {plain_ms:.4f} ms "
                     f"bound {work_ms:.4f} ms ({by})"
                     + (f" (x{launches}/pass)" if not extra else
                        f" ({extra}" + (f", x{launches}/forward)" if launches else ")")))
        print(line, flush=True)
        if not ok:
            fail(f"{name} {label} exceeds max {tol_max} / mean {tol_mean}")

    for stage, c, g, scale, k1_depths, k6_depths in stages:
        h, w = MAIN_H // scale, MAIN_W // scale
        cfg = STAGE_CONFIG[stage]
        projs = rig_cameras(h, w, 1.1 * max(MAIN_H, MAIN_W) / scale, RIG_BASELINES).to(device)
        mats = warp_proj_coeffs(projs[:, 1:], projs[:, :1]).contiguous()  # [1, 4, 12]
        mat12 = mats[:, 0].contiguous()
        offset = torch.randn((1, h, w, 18), generator=gen, device=device) * 2.0
        grid = build_offset_grid(offset, evaluation_offsets(cfg.propagation_range), h, w)
        feats = torch.randn((1, 1 + mats.shape[1], h, w, c), generator=gen, device=device)
        vw = torch.rand((1, mats.shape[1], h, w), generator=gen, device=device)
        fw = torch.rand((1, 9, h, w), generator=gen, device=device) * 0.9 + 0.1
        ke = VARIANT_STAGES[stage][0]
        voffset = torch.randn((1, h, w, 2 * ke), generator=vgen, device=device) * 2.0
        variant_grids[stage] = (
            build_offset_grid(voffset, evaluation_offsets(cfg.propagation_range, ke), h, w),
            torch.rand((1, ke, h, w), generator=vgen, device=device) * 0.9 + 0.1)
        for dtype in (torch.bfloat16, torch.float32):
            timed = dtype == torch.bfloat16
            tag = "bf16" if timed else "f32"
            ref, src = feats[:, 0].to(dtype), feats[:, 1].to(dtype)
            stack = feats[:, 1:].to(dtype).contiguous()
            for i, (d, launches, _) in enumerate(k1_depths):
                depth = 4.8 + 3.0 * torch.rand((1, d, h, w), generator=gen, device=device)
                depth[:, -1, :4] = -1.0  # behind the source camera: pz <= 1e-3
                args = (src, mat12, depth, ref, g)
                label = f"stage{stage} C{c} G{g} D{d} {h}x{w} {tag}"
                k1 = ops.warp_group_corr(*args)
                record("warp_group_corr", label, args, k1, ops.warp_group_corr_reference(*args),
                       launches, timed, lambda: ops.warp_group_corr(*args),
                       lambda: ops.warp_group_corr_reference(*args), cfg.interval_scale)
                # K7 on the warp coordinates is K1; on jittered coordinates
                # (off-image too) it is held against its plain version
                ix, iy = warp_coords(mat12, depth, h, w)
                same = (ops.coord_group_corr(src, ix, iy, ref, g) - k1).abs().max().item()
                k7_vs_k1[0] = max(k7_vs_k1[0], same)
                if timed:
                    k1_fn = lambda: ops.warp_group_corr(*args)  # noqa: E731
                    k7_fn = lambda: ops.coord_group_corr(src, ix, iy, ref, g)  # noqa: E731
                    k7_ms, k1_ms, k1_dev, k7_dev = (time_ms(k7_fn), time_ms(k1_fn),
                                                    device_ms(k1_fn), device_ms(k7_fn))
                    print(f"K1 against K7 (tiled, mode kCoords) on K1's warp coordinates "
                          f"{label}: K1 {k1_ms:.4f} ms "
                          f"device {fmt_ms(k1_dev)}, K7 {k7_ms:.4f} ms device {fmt_ms(k7_dev)} "
                          f"(x{launches}/forward)", flush=True)
                    for key, dev in (("k1", k1_dev), ("k7", k7_dev)):
                        if baseline[key] is not None:
                            baseline[key] = None if dev is None else baseline[key] + dev * launches
                jx = ix + 1.5 * torch.randn(ix.shape, generator=gen, device=device)
                jy = iy + 1.5 * torch.randn(iy.shape, generator=gen, device=device)
                args = (src, jx, jy, ref, g)
                record("coord_group_corr", f"{label} (K7 on the warp coordinates: max "
                       f"|K7 - K1| {same:.3e})", args, ops.coord_group_corr(*args),
                       ops.coord_group_corr_reference(*args), 4 if i == 0 else 0, timed,
                       lambda: ops.coord_group_corr(*args),
                       lambda: ops.coord_group_corr_reference(*args), cfg.interval_scale)
            for d, launches in k6_depths:
                depth = 4.8 + 3.0 * torch.rand((1, d, h, w), generator=gen, device=device)
                depth[:, -1, :4] = -1.0
                args = (stack, mats, depth, ref, vw, g)
                got = ops.warp_group_corr_views(*args)
                diff = (got - per_view_route(*args)).abs().max().item()
                route["max_abs_diff"] = max(route["max_abs_diff"], diff)
                label = f"stage{stage} C{c} G{g} D{d} V{mats.shape[1]} {h}x{w} {tag}"
                if timed:
                    route_ms = time_ms(lambda: per_view_route(*args))
                    route["ms"] += route_ms * launches
                    label += f" (per-view route {route_ms:.4f} ms, max |K6 - route| {diff:.3e})"
                else:
                    label += f" (max |K6 - per-view route| {diff:.3e})"
                record("warp_group_corr_views", label, args, got,
                       ops.warp_group_corr_views_reference(*args), launches, timed,
                       lambda: ops.warp_group_corr_views(*args),
                       lambda: ops.warp_group_corr_views_reference(*args), cfg.interval_scale)
            if stage == 2:  # K6 over more views than a block stages at once
                d = k6_depths[0][0]
                mats_many = rig_mats(h, w, scale, MANY_VIEWS).to(device)
                stack_many = torch.randn((1, MANY_VIEWS, h, w, c), generator=gen,
                                         device=device).to(dtype)
                vw_many = torch.rand((1, MANY_VIEWS, h, w), generator=gen, device=device)
                depth = 4.8 + 3.0 * torch.rand((1, d, h, w), generator=gen, device=device)
                depth[:, -1, :4] = -1.0
                args = (stack_many, mats_many, depth, ref, vw_many, g)
                got = ops.warp_group_corr_views(*args)
                diff = (got - per_view_route(*args)).abs().max().item()
                route["max_abs_diff"] = max(route["max_abs_diff"], diff)
                plain = (got - ops.warp_group_corr_views_reference(*args)).abs().max().item()
                dev = fmt_ms(device_ms(lambda: ops.warp_group_corr_views(*args))) if timed else "-"
                print(f"warp_group_corr_views stage{stage} C{c} G{g} D{d} V{MANY_VIEWS} {h}x{w} "
                      f"{tag}: max |K6 - per-view route| {diff:.3e}, max |K6 - plain| {plain:.3e} "
                      f"(not gated); device {dev}", flush=True)
                del stack_many, args, got
            args = (ref, grid, g)
            record("neighbor_group_corr", f"stage{stage} C{c} G{g} K9 {h}x{w} {tag}", args,
                   ops.neighbor_group_corr(*args), ops.neighbor_group_corr_reference(*args),
                   1, timed, lambda: ops.neighbor_group_corr(*args),
                   lambda: ops.neighbor_group_corr_reference(*args), cfg.interval_scale)
            for d, _, launches in k1_depths:
                x_norm = torch.rand((1, h, w, d), generator=gen, device=device)
                cost = (torch.randn((1, h, w, d), generator=gen, device=device)).to(dtype)
                args = (x_norm, cost, grid, fw, cfg.interval_scale)
                record("eval_grid_score", f"stage{stage} D{d} {h}x{w} cost {tag}", args,
                       ops.eval_grid_score(*args), ops.eval_grid_score_reference(*args),
                       launches, timed, lambda: ops.eval_grid_score(*args),
                       lambda: ops.eval_grid_score_reference(*args), cfg.interval_scale)
            # the variant configuration (phase 12 (c)) at this stage's shape:
            # K3 and K2 on its eval grid, K1 and K6 at its new depths
            ke, variant_depths = VARIANT_STAGES[stage]
            vgrid, vfw = variant_grids[stage]
            if ke != 9:
                args = (ref, vgrid, g)
                record("neighbor_group_corr", f"variant stage{stage} C{c} G{g} K{ke} {h}x{w} {tag}",
                       args, ops.neighbor_group_corr(*args),
                       ops.neighbor_group_corr_reference(*args), 0, timed,
                       lambda: ops.neighbor_group_corr(*args),
                       lambda: ops.neighbor_group_corr_reference(*args), cfg.interval_scale,
                       extra=VARIANT)
            for d in variant_depths:
                if all(d != k1_d for k1_d, _, _ in k1_depths):
                    depth = 4.8 + 3.0 * torch.rand((1, d, h, w), generator=vgen, device=device)
                    depth[:, -1, :4] = -1.0
                    args = (src, mat12, depth, ref, g)
                    record("warp_group_corr", f"variant stage{stage} C{c} G{g} D{d} {h}x{w} {tag}",
                           args, ops.warp_group_corr(*args),
                           ops.warp_group_corr_reference(*args), 0, timed,
                           lambda: ops.warp_group_corr(*args),
                           lambda: ops.warp_group_corr_reference(*args), cfg.interval_scale,
                           extra=VARIANT)
                    args = (stack, mats, depth, ref, vw, g)
                    got = ops.warp_group_corr_views(*args)
                    diff = (got - per_view_route(*args)).abs().max().item()
                    route["max_abs_diff"] = max(route["max_abs_diff"], diff)
                    record("warp_group_corr_views",
                           f"variant stage{stage} C{c} G{g} D{d} V{mats.shape[1]} {h}x{w} {tag} "
                           f"(max |K6 - per-view route| {diff:.3e})", args, got,
                           ops.warp_group_corr_views_reference(*args), 0, timed,
                           lambda: ops.warp_group_corr_views(*args),
                           lambda: ops.warp_group_corr_views_reference(*args),
                           cfg.interval_scale, extra=VARIANT)
                x_norm = torch.rand((1, h, w, d), generator=vgen, device=device)
                cost = (torch.randn((1, h, w, d), generator=vgen, device=device)).to(dtype)
                args = (x_norm, cost, vgrid, vfw, cfg.interval_scale)
                record("eval_grid_score", f"variant stage{stage} K{ke} D{d} {h}x{w} cost {tag}",
                       args, ops.eval_grid_score(*args), ops.eval_grid_score_reference(*args),
                       0, timed, lambda: ops.eval_grid_score(*args),
                       lambda: ops.eval_grid_score_reference(*args), cfg.interval_scale,
                       extra=VARIANT)
    # phase 12 (a)'s shapes: the DTU preset at 1600x1200 with 1 + 5 views
    # (stage maps 150x200, 300x400, 600x800; K1 on each of 5 sources, K6
    # at V = 5, also against the per-view route), bf16 timed and f32
    dgen = torch.Generator(device=device).manual_seed(12)
    for stage, c, g, scale, k1_depths, k6_depths in stages:
        h, w = CLI_EVAL_H // scale, CLI_EVAL_W // scale
        cfg = STAGE_CONFIG[stage]
        projs = rig_cameras(h, w, 1.1 * max(CLI_EVAL_H, CLI_EVAL_W) / scale,
                            DTU_RIG_BASELINES).to(device)
        mats = warp_proj_coeffs(projs[:, 1:], projs[:, :1]).contiguous()  # [1, 5, 12]
        views = mats.shape[1]
        offset = torch.randn((1, h, w, 18), generator=dgen, device=device) * 2.0
        grid = build_offset_grid(offset, evaluation_offsets(cfg.propagation_range), h, w)
        feats = torch.randn((1, 1 + views, h, w, c), generator=dgen, device=device)
        vw = torch.rand((1, views, h, w), generator=dgen, device=device)
        fw = torch.rand((1, 9, h, w), generator=dgen, device=device) * 0.9 + 0.1
        for dtype in (torch.bfloat16, torch.float32):
            timed = dtype == torch.bfloat16
            tag = "bf16" if timed else "f32"
            ref, stack = feats[:, 0].to(dtype), feats[:, 1:].to(dtype).contiguous()
            for d, launches, _ in k1_depths:
                if not launches:
                    continue
                depth = 4.8 + 3.0 * torch.rand((1, d, h, w), generator=dgen, device=device)
                depth[:, -1, :4] = -1.0
                for v in range(views):
                    args = (stack[:, v].contiguous(), mats[:, v].contiguous(), depth, ref, g)
                    record("warp_group_corr", f"stage{stage} C{c} G{g} D{d} {h}x{w} {tag} "
                           f"(source {v + 1} of {views})", args, ops.warp_group_corr(*args),
                           ops.warp_group_corr_reference(*args), views if v == 0 else 0,
                           timed and v == 0, lambda: ops.warp_group_corr(*args),
                           lambda: ops.warp_group_corr_reference(*args), cfg.interval_scale,
                           extra=DTU_PRESET)
            for d, launches in k6_depths:
                depth = 4.8 + 3.0 * torch.rand((1, d, h, w), generator=dgen, device=device)
                depth[:, -1, :4] = -1.0
                args = (stack, mats, depth, ref, vw, g)
                got = ops.warp_group_corr_views(*args)
                diff = (got - per_view_route(*args)).abs().max().item()
                route["max_abs_diff"] = max(route["max_abs_diff"], diff)
                record("warp_group_corr_views", f"stage{stage} C{c} G{g} D{d} V{views} {h}x{w} "
                       f"{tag} (max |K6 - per-view route| {diff:.3e})", args, got,
                       ops.warp_group_corr_views_reference(*args), launches, timed,
                       lambda: ops.warp_group_corr_views(*args),
                       lambda: ops.warp_group_corr_views_reference(*args), cfg.interval_scale,
                       extra=DTU_PRESET)
            args = (ref, grid, g)
            record("neighbor_group_corr", f"stage{stage} C{c} G{g} K9 {h}x{w} {tag}", args,
                   ops.neighbor_group_corr(*args), ops.neighbor_group_corr_reference(*args),
                   1, timed, lambda: ops.neighbor_group_corr(*args),
                   lambda: ops.neighbor_group_corr_reference(*args), cfg.interval_scale,
                   extra=DTU_PRESET)
            for d, _, launches in k1_depths:
                x_norm = torch.rand((1, h, w, d), generator=dgen, device=device)
                cost = (torch.randn((1, h, w, d), generator=dgen, device=device)).to(dtype)
                args = (x_norm, cost, grid, fw, cfg.interval_scale)
                record("eval_grid_score", f"stage{stage} D{d} {h}x{w} cost {tag}", args,
                       ops.eval_grid_score(*args), ops.eval_grid_score_reference(*args),
                       launches, timed, lambda: ops.eval_grid_score(*args),
                       lambda: ops.eval_grid_score_reference(*args), cfg.interval_scale,
                       extra=DTU_PRESET)
        del feats, stack, args, got
    k6 = summary["warp_group_corr_views"]
    print(f"K6 per forward: {k6['ms']:.4f} ms (device {fmt_ms(k6['device_ms'])}) against the "
          f"per-view route it replaces (16 K1 launches and the weighted sum) {route['ms']:.4f} "
          f"ms; max |K6 - per-view route| {route['max_abs_diff']:.3e} (bf16 and f32, 4, 5 and "
          f"{MANY_VIEWS} views); max |K7 - K1| on the warp coordinates {k7_vs_k1[0]:.3e}; K1 per "
          f"forward device {fmt_ms(baseline['k1'])}, K7 (tiled) on K1's coordinates "
          f"{fmt_ms(baseline['k7'])}", flush=True)
    for name in ("warp_group_corr", "warp_group_corr_views", "eval_grid_score",
                 "neighbor_group_corr"):
        print(f"{name} device ms per stage: " + "; ".join(
            f"{label} {fmt_ms(dev)} x{n}" for label, dev, n in per_stage[name])
            + f"; per forward {fmt_ms(summary[name]['device_ms'])}", flush=True)
    for extra, rows in extra_rows.items():
        per_forward = (None if any(dev is None for _, _, dev, _ in rows)
                       else sum(dev * n for _, _, dev, n in rows))
        print(f"{extra} device ms per call: " + "; ".join(
            f"{name} {label} {fmt_ms(dev)}" + (f" x{n}" if n else "")
            for name, label, dev, n in rows)
            + (f"; hand kernels per forward {fmt_ms(per_forward)}" if extra == DTU_PRESET
               else ""), flush=True)
    if route["max_abs_diff"] != 0.0:
        fail(f"K6 differs from the per-view route by {route['max_abs_diff']:.3e}")
    if k7_vs_k1[0] != 0.0:
        fail(f"K7 on the warp coordinates differs from K1 by {k7_vs_k1[0]:.3e}")
    return summary


GOLDEN_CASES = (("forward_96x128", 0.25), ("forward_288x400_n5_dtu", None))
# (stage, iteration) of the per-stage depths; stage 0 is the refined depth
STAGES = ((3, 0), (3, 1), (2, 0), (2, 1), (1, 0), (0, 0))


def golden_parity(device, model_f32):
    """Phase 4: the f32 model on the card against the captured goldens, at
    the bounds of tests/test_model_golden.py."""
    import numpy as np
    import torch

    for name, conf_max in GOLDEN_CASES:
        g = np.load(os.path.join(REPO, "tests", "golden", f"{name}.npz"))
        with torch.inference_mode():
            depth, conf, dp = model_f32(
                torch.from_numpy(g["images"])[None].to(device),
                torch.from_numpy(g["intrinsics"])[None].to(device),
                torch.from_numpy(g["extrinsics"])[None].to(device),
                torch.tensor([float(g["depth_min"])], device=device),
                torch.tensor([float(g["depth_max"])], device=device),
                init_noise=torch.from_numpy(g["noise"]).to(device),
            )
        rng = float(g["depth_max"] - g["depth_min"])
        for stage, it in STAGES:
            diff = np.abs(dp[stage][it].cpu().numpy() - g[f"stage{stage}_iter{it}"])
            print(f"{name} stage{stage} iter{it}: max/range {diff.max() / rng:.3e} "
                  f"mean/range {diff.mean() / rng:.3e}", flush=True)
            if diff.max() >= 2e-3 * rng or diff.mean() >= 2e-4 * rng:
                fail(f"{name} stage{stage} iter{it} exceeds 2e-3 max / 2e-4 mean of range")
        if np.abs(depth.cpu().numpy() - g["depth"]).max() > 2e-3 * rng:
            fail(f"{name} final depth exceeds 2e-3 of range")
        cdiff = np.abs(conf.cpu().numpy() - g["confidence"])
        print(f"{name} confidence: frac>5e-3 {(cdiff > 5e-3).mean():.3e} "
              f"median {np.median(cdiff):.3e} max {cdiff.max():.3e}", flush=True)
        if (cdiff > 5e-3).mean() >= 1e-3 or np.median(cdiff) >= 1e-4:
            fail(f"{name} confidence outside the golden bounds")
        if conf_max is not None and cdiff.max() >= conf_max:
            fail(f"{name} confidence max diff {cdiff.max():.3e} >= {conf_max}")


def main_path(device, state_dict, scene):
    """Phase 5: the scene through the bf16 DepthEstimator and
    save_depth_maps. Returns (the run's launch counts, estimator)."""
    import numpy as np
    import torch

    from patchmatchnet_torch.data import PLANE_Z, BatchLoader, MVSDataset, read_pfm
    from patchmatchnet_torch.infer import DepthEstimator, save_depth_maps
    from patchmatchnet_torch.models import PatchmatchNet
    from patchmatchnet_torch.ops import cuda_build

    model = PatchmatchNet(compute_dtype=torch.bfloat16)
    model.load_state_dict(state_dict, strict=True)
    estimator = DepthEstimator(model, device=device)

    class Timed:
        """Times each request to the estimator (it returns host arrays, so
        the device work is done when it returns)."""

        def __init__(self, inner):
            self.inner, self.device, self.ms = inner, inner.device, []

        def __call__(self, batch, generator):
            start = time.perf_counter()
            out = self.inner(batch, generator)
            self.ms.append((time.perf_counter() - start) * 1e3)
            return out

    dataset = MVSDataset(scene, num_views=MAIN_VIEWS - 1, image_extension=".png")
    if len(dataset) < REQUESTS:
        fail(f"scene has {len(dataset)} samples, need {REQUESTS}")
    loader = BatchLoader(dataset, batch_size=1)  # default prefetching loader
    # warm-up request: cuDNN algorithm selection, allocator growth
    warm = next(iter(BatchLoader(dataset, batch_size=1, num_threads=1)))
    estimator(warm, torch.Generator(device=device).manual_seed(123))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    timed = Timed(estimator)
    out_dir = tempfile.mkdtemp(prefix="out_", dir=scene)
    cuda_build.reset_launch_counts()
    written = save_depth_maps(timed, loader, out_dir, seed=0)
    counts = cuda_build.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    if written != REQUESTS:
        fail(f"wrote {written} depth maps, expected {REQUESTS}")
    errs = []
    for i in range(REQUESTS):
        depth = read_pfm(os.path.join(out_dir, "depth_est", f"{i:08d}.pfm"))[..., 0]
        if depth.shape != (MAIN_H, MAIN_W) or not np.isfinite(depth).all():
            fail(f"depth map {i}: shape {depth.shape}, finite {np.isfinite(depth).all()}")
        errs.append(float(np.median(np.abs(depth - PLANE_Z))))
    shutil.rmtree(out_dir, ignore_errors=True)

    ms = statistics.median(timed.ms)
    print(f"requests {REQUESTS}, ms per depth map: " + " ".join(f"{t:.2f}" for t in timed.ms),
          flush=True)
    print(f"median ms/map {ms:.2f}, {MAIN_W * MAIN_H / (ms * 1e3):.3f} MPix/s, "
          f"peak memory {peak / 2**20:.1f} MiB, median |depth - GT| per map "
          + " ".join(f"{e:.4f}" for e in errs) + f" (plane at {PLANE_Z})", flush=True)
    print(f"launch counts: {counts}", flush=True)
    for name, per in EXPECTED_PER_FORWARD.items():
        if counts.get(name, 0) != per * REQUESTS:
            fail(f"{name} launched {counts.get(name, 0)} times, expected {per} x {REQUESTS}")
    if set(counts) - set(EXPECTED_PER_FORWARD):
        fail(f"launches of kernels off this path: {counts}")
    if max(errs) > 0.05 * PLANE_Z:
        fail(f"median depth error {max(errs):.4f} above 5% of the plane depth")
    return counts, estimator


def coordinate_path(device, model, scene):
    """Phase 6: a plane sweep through `coord_group_corr` (K7) on the scene's
    first batch: the bf16 FeatureNet's features of each stage, the warp
    coordinates of SWEEP_DEPTHS[stage] hypotheses uniform in inverse depth
    over the scene's range, K7 per source view, and the winner-take-all
    depth of the view-summed correlation. Returns the K7 launch counts."""
    import numpy as np
    import torch

    from patchmatchnet_torch import ops
    from patchmatchnet_torch.data import PLANE_Z, BatchLoader, MVSDataset
    from patchmatchnet_torch.dev.profile_coord import sweep_coords
    from patchmatchnet_torch.models.patchmatch import STAGE_CONFIG
    from patchmatchnet_torch.ops import cuda_build
    from patchmatchnet_torch.utils.trace import device_ms, fmt_ms

    batch = next(iter(BatchLoader(MVSDataset(scene, MAIN_VIEWS - 1, ".png"), num_threads=1)))
    images, intr, extr, dmin, dmax = [
        torch.as_tensor(np.asarray(batch[k])).to(device).float()
        for k in ("images", "intrinsics", "extrinsics", "depth_min", "depth_max")]
    n = images.shape[1]
    with torch.inference_mode():
        feats = model.feature(images[0].permute(0, 3, 1, 2))  # {stage: [N, C, h, w]}
    cases = []
    for stage, d in SWEEP_DEPTHS.items():
        f = feats[stage].permute(0, 2, 3, 1).contiguous()  # [N, h, w, C]
        h, w = f.shape[1:3]
        # mats [N - 1, 12], hyp [D] far to near
        mats, depth, hyp, coords = sweep_coords(intr[0], extr[0], dmin[0], dmax[0], stage, d,
                                                h, w)
        cases.append((stage, f, mats, depth, hyp, coords))

    cuda_build.reset_launch_counts()
    sims = [[ops.coord_group_corr(f[v + 1:v + 2], ix, iy, f[:1], STAGE_CONFIG[stage].groups)
             for v, (ix, iy) in enumerate(coords)]
            for stage, f, mats, depth, hyp, coords in cases]
    counts = cuda_build.launch_counts()

    for (stage, f, mats, depth, hyp, coords), per_view in zip(cases, sims):
        g = STAGE_CONFIG[stage].groups
        k1_diff = max((sim - ops.warp_group_corr(f[v + 1:v + 2], mats[v:v + 1].contiguous(),
                                                  depth, f[:1], g)).abs().max().item()
                      for v, sim in enumerate(per_view))
        volume = torch.stack(per_view).sum(0).sum(1)[0]  # [D, h, w]
        if not torch.isfinite(volume).all():
            fail(f"coordinate path stage {stage}: non-finite similarity")
        wta = hyp[volume.argmax(0)]
        err = (wta - PLANE_Z).abs().median().item()
        print(f"plane sweep stage{stage} C{f.shape[-1]} G{g} D{depth.shape[1]} "
              f"{f.shape[1]}x{f.shape[2]}, {n - 1} views: median |WTA depth - GT| {err:.4f} "
              f"(plane at {PLANE_Z}); max |K7 - K1| {k1_diff:.3e}", flush=True)
        if k1_diff != 0.0:
            fail(f"K7 on the warp coordinates differs from K1 at stage {stage}")
        if err > 0.05 * PLANE_Z:
            fail(f"plane sweep stage {stage}: median depth error above 5% of the plane")
    # K7's device ms on the sweep's own coordinates (fronto-parallel planes:
    # smooth, unlike phase 3's jittered ones), all source views per stage
    per_stage = [(stage, device_ms(lambda f=f, coords=coords, g=STAGE_CONFIG[stage].groups: [
        ops.coord_group_corr(f[v + 1:v + 2], ix, iy, f[:1], g)
        for v, (ix, iy) in enumerate(coords)])) for stage, f, _, _, _, coords in cases]
    sweep_ms = (None if any(ms is None for _, ms in per_stage)
                else sum(ms for _, ms in per_stage))
    print("coord_group_corr device ms on the sweep's coordinates, per stage (x"
          f"{n - 1} views): " + "; ".join(f"stage{stage} {fmt_ms(ms)}" for stage, ms in per_stage)
          + f"; per sweep {fmt_ms(sweep_ms)}", flush=True)
    want = len(SWEEP_DEPTHS) * (n - 1)
    print(f"coordinate path launch counts: {counts}", flush=True)
    if counts != {"coord_group_corr": want}:
        fail(f"coordinate path launched {counts}, expected coord_group_corr {want}")
    return counts


def backward_tol(dtype):
    """(max abs, mean abs) bound of backward kernel vs plain version,
    relative to the largest plain gradient entry. Both sum in f32 in another
    order (atomics on both sides for the source gradient, so neither is
    deterministic), and the plain warp reaches its coordinates through
    F.grid_sample's normalize/unnormalize, ~1 ulp away (as for K1); bf16
    results are then rounded to bf16, 2^-9 of an entry, and a different
    f32 sum can round to the neighbouring bf16 value."""
    return (2e-3, 2e-5) if dtype.itemsize == 4 else (8e-3, 5e-4)


def scatter_line(counts) -> str:
    """K4's scatter count (`k4_scatter_counts`) as printed."""
    atomics, before = counts["global_atomics"], counts["parent_atomics"]
    return (f"16-byte f32 atomics into d_src {atomics:,} (design before {before:,}, "
            f"x{before / max(atomics, 1):.1f}); {counts['samples']:,} samples with a valid "
            f"corner in {counts['merged_cells']:,} runs of one cell")


def backward_parity(device):
    """Phase 7: K4 and K5 vs autograd through their plain forwards at the
    640x512 B=2 training stage shapes. Returns {kernel: {"max_abs_err",
    "ms", "plain_ms", "bytes", "ops"}} with times summed over a train step's launches
    (bf16 payloads; K4 on the i.i.d. depths). The bounds are relative to the largest entry;
    max_abs_err is the absolute error. "ms" is the wrapper's time, as the
    train step calls it: zeroing the f32 source-gradient buffer, the launch,
    and its cast to the payload dtype. K4 then runs on the training path's
    layout of the depths at each stage shape (`dev.profile_backward`
    `path_depth`), held to the same bounds; its device ms per train step
    is printed beside the i.i.d. cases'."""
    import torch

    from patchmatchnet_torch import ops
    from patchmatchnet_torch.dev.profile_backward import path_depth
    from patchmatchnet_torch.models.patchmatch import (
        STAGE_CONFIG,
        build_offset_grid,
        evaluation_offsets,
    )
    from patchmatchnet_torch.ops.warp import warp_proj_coeffs
    from patchmatchnet_torch.ops.warp_similarity import k4_scatter_counts
    from patchmatchnet_torch.utils.trace import device_ms, fmt_ms

    gen = torch.Generator(device=device).manual_seed(1)
    path_gen = torch.Generator(device=device).manual_seed(2)  # leaves gen's draws as they were
    b = TRAIN_BATCH
    # (stage, C, G, scale, [(D, K4 launches per train step at N=5)])
    stages = [(3, 64, 8, 8, [(64, 4), (32, 4)]), (2, 32, 8, 4, [(16, 8)]),
              (1, 16, 4, 2, [(8, 4)])]
    summary = new_summary(BACKWARD_KERNELS)
    # K4 device ms per train step by layout, at B = 2 and at phase 12 (b)'s B = 8
    per_step = {"iid": 0.0, "path": 0.0, "B8 iid": 0.0, "B8 path": 0.0}
    variant_grids = {}  # stage -> eval grid at the variant configuration's Ke
    vgen = torch.Generator(device=device).manual_seed(11)  # leaves gen's draws as they were

    def check(name, label, got, want, dtype):
        tol_max, tol_mean = backward_tol(dtype)
        for g, w in zip(got, want):
            scale = w.float().abs().max().item()
            err = (g.float() - w.float()).abs()
            abs_max = err.max().item()
            rel_max, rel_mean = abs_max / scale, err.mean().item() / scale
            print(f"{name} {label}: max_abs {abs_max:.3e} max_abs/max {rel_max:.3e} "
                  f"mean_abs/max {rel_mean:.3e} (largest entry {scale:.3e})", flush=True)
            if rel_max > tol_max or rel_mean > tol_mean:
                fail(f"{name} {label} exceeds max {tol_max} / mean {tol_mean} of the largest entry")
            summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], abs_max)

    def timed(name, label, launches, args, kernel_fn, plain_fn, layout=None):
        """layout: None or "iid" (the kernels line's cases), "path" (K4 on
        the training path's depths), "variant" (phase 12 (c)'s shapes,
        printed only) or "B8", "B8 iid", "B8 path" (phase 12 (b)'s batch,
        printed only)."""
        out = kernel_fn()
        ms, plain_ms, dev_ms = time_ms(kernel_fn), time_ms(plain_fn), device_ms(kernel_fn)
        if layout in (None, "iid"):  # the kernels line keeps the i.i.d. cases
            add_time(summary[name], name, args, out, launches, ms, plain_ms, dev_ms)
        if layout in per_step and per_step[layout] is not None:
            per_step[layout] = None if dev_ms is None else per_step[layout] + dev_ms * launches
        work_ms, by = bound(*kernel_work(name, args, out))
        print(f"{name} {label}: wrapper {ms:.4f} ms device {fmt_ms(dev_ms)} plain "
              f"{plain_ms:.4f} ms bound {work_ms:.4f} ms ({by}) "
              + (f"({VARIANT})" if layout == "variant" else
                 f"({CLI_BATCH}, x{launches}/train step)" if (layout or "").startswith("B8") else
                 f"(x{launches}/train step)"), flush=True)

    for stage, c, g, scale, depths in stages:
        h, w = TRAIN_H // scale, TRAIN_W // scale
        cfg = STAGE_CONFIG[stage]
        f = 1.1 * max(TRAIN_H, TRAIN_W) / scale
        projs = rig_cameras(h, w, f).to(device)
        mat12 = warp_proj_coeffs(projs[:, 1], projs[:, 0]).expand(b, 12).contiguous()
        offset = torch.randn((b, h, w, 18), generator=gen, device=device) * 2.0
        grid = build_offset_grid(offset, evaluation_offsets(cfg.propagation_range), h, w)
        feats = torch.randn((2, b, h, w, c), generator=gen, device=device)
        ke = VARIANT_STAGES[stage][0]
        voffset = torch.randn((b, h, w, 2 * ke), generator=vgen, device=device) * 2.0
        variant_grids[stage] = build_offset_grid(
            voffset, evaluation_offsets(cfg.propagation_range, ke), h, w)
        for dtype in (torch.bfloat16, torch.float32):
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            ref, src = feats[0].to(dtype), feats[1].to(dtype)
            for d, launches in depths:
                depth = 4.8 + 3.0 * torch.rand((b, d, h, w), generator=gen, device=device)
                depth[:, -1, :4] = -1.0  # behind the source camera
                dout = torch.randn((b, g, d, h, w), generator=gen, device=device)
                for layout in ("iid", "path"):
                    if layout == "path":
                        depth = path_depth(stage, b, d, h, w, path_gen, device)
                    args = (src, mat12, depth, ref, g, dout)
                    label = f"stage{stage} C{c} G{g} D{d} B{b} {h}x{w} {tag} {layout}"
                    check("warp_group_corr_backward", label, ops.warp_group_corr_backward(*args),
                          ops.warp_group_corr_backward_reference(*args), dtype)
                    print(f"warp_group_corr_backward {label}: "
                          f"{scatter_line(k4_scatter_counts(*args))}", flush=True)
                    if dtype == torch.bfloat16:
                        s_ = src.detach().requires_grad_(True)
                        r_ = ref.detach().requires_grad_(True)
                        out = ops.warp_group_corr_reference(s_, mat12, depth, r_, g)
                        timed("warp_group_corr_backward", label, launches, args,
                              lambda: ops.warp_group_corr_backward(*args),
                              lambda: torch.autograd.grad(out, (s_, r_), dout, retain_graph=True),
                              layout)
            dout = torch.randn((b, g, 9, h, w), generator=gen, device=device)
            args = (ref, grid, g, dout)
            label = f"stage{stage} C{c} G{g} K9 B{b} {h}x{w} {tag}"
            check("neighbor_group_corr_backward", label, ops.neighbor_group_corr_backward(*args),
                  ops.neighbor_group_corr_backward_reference(*args), dtype)
            if dtype == torch.bfloat16:
                gx, gy = (t.detach().requires_grad_(True) for t in grid)
                out = ops.neighbor_group_corr_reference(ref, (gx, gy), g)
                timed("neighbor_group_corr_backward", label, 1, args,
                      lambda: ops.neighbor_group_corr_backward(*args),
                      lambda: torch.autograd.grad(out, (gx, gy), dout, retain_graph=True))
            # the variant configuration (phase 12 (c)) at this stage's training
            # shape: K5 on its Ke = 17 eval grid, K4 at its new depths
            ke, variant_depths = VARIANT_STAGES[stage]
            vgrid = variant_grids[stage]
            if ke != 9:
                dout = torch.randn((b, g, ke, h, w), generator=vgen, device=device)
                args = (ref, vgrid, g, dout)
                label = f"variant stage{stage} C{c} G{g} K{ke} B{b} {h}x{w} {tag}"
                check("neighbor_group_corr_backward", label,
                      ops.neighbor_group_corr_backward(*args),
                      ops.neighbor_group_corr_backward_reference(*args), dtype)
                if dtype == torch.bfloat16:
                    gx, gy = (t.detach().requires_grad_(True) for t in vgrid)
                    out = ops.neighbor_group_corr_reference(ref, (gx, gy), g)
                    timed("neighbor_group_corr_backward", label, 0, args,
                          lambda: ops.neighbor_group_corr_backward(*args),
                          lambda: torch.autograd.grad(out, (gx, gy), dout, retain_graph=True),
                          "variant")
            for d in variant_depths:
                if any(d == main_d for main_d, _ in depths):
                    continue
                depth = 4.8 + 3.0 * torch.rand((b, d, h, w), generator=vgen, device=device)
                depth[:, -1, :4] = -1.0
                dout = torch.randn((b, g, d, h, w), generator=vgen, device=device)
                args = (src, mat12, depth, ref, g, dout)
                label = f"variant stage{stage} C{c} G{g} D{d} B{b} {h}x{w} {tag}"
                check("warp_group_corr_backward", label, ops.warp_group_corr_backward(*args),
                      ops.warp_group_corr_backward_reference(*args), dtype)
                if dtype == torch.bfloat16:
                    s_ = src.detach().requires_grad_(True)
                    r_ = ref.detach().requires_grad_(True)
                    out = ops.warp_group_corr_reference(s_, mat12, depth, r_, g)
                    timed("warp_group_corr_backward", label, 0, args,
                          lambda: ops.warp_group_corr_backward(*args),
                          lambda: torch.autograd.grad(out, (s_, r_), dout, retain_graph=True),
                          "variant")
    # phase 12 (b)'s batch: K1, K3, K4 and K5 at B = 8 with 1 + 5 views (K1
    # and K4 5 launches per evaluation), bf16 timed and f32; printed only
    bgen = torch.Generator(device=device).manual_seed(13)
    b = CLI_TRAIN_BATCH
    stages = [(3, 64, 8, 8, [(64, 5), (32, 5)]), (2, 32, 8, 4, [(16, 10)]),
              (1, 16, 4, 2, [(8, 5)])]
    for stage, c, g, scale, depths in stages:
        h, w = TRAIN_H // scale, TRAIN_W // scale
        cfg = STAGE_CONFIG[stage]
        projs = rig_cameras(h, w, 1.1 * max(TRAIN_H, TRAIN_W) / scale).to(device)
        mat12 = warp_proj_coeffs(projs[:, 1], projs[:, 0]).expand(b, 12).contiguous()
        offset = torch.randn((b, h, w, 18), generator=bgen, device=device) * 2.0
        grid = build_offset_grid(offset, evaluation_offsets(cfg.propagation_range), h, w)
        feats = torch.randn((2, b, h, w, c), generator=bgen, device=device)
        for dtype in (torch.bfloat16, torch.float32):
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            ref, src = feats[0].to(dtype), feats[1].to(dtype)
            for d, launches in depths:
                for layout in ("iid", "path"):
                    if layout == "iid":
                        depth = 4.8 + 3.0 * torch.rand((b, d, h, w), generator=bgen, device=device)
                        depth[:, -1, :4] = -1.0
                    else:
                        depth = path_depth(stage, b, d, h, w, bgen, device)
                    label = f"stage{stage} C{c} G{g} D{d} B{b} {h}x{w} {tag} {layout}"
                    fwd = (src, mat12, depth, ref, g)
                    hold("warp_group_corr", label, ops.warp_group_corr(*fwd),
                         ops.warp_group_corr_reference(*fwd), cfg.interval_scale)
                    dout = torch.randn((b, g, d, h, w), generator=bgen, device=device)
                    args = fwd + (dout,)
                    check("warp_group_corr_backward", label, ops.warp_group_corr_backward(*args),
                          ops.warp_group_corr_backward_reference(*args), dtype)
                    if dtype == torch.bfloat16:
                        s_ = src.detach().requires_grad_(True)
                        r_ = ref.detach().requires_grad_(True)
                        out = ops.warp_group_corr_reference(s_, mat12, depth, r_, g)
                        timed("warp_group_corr_backward", label, launches, args,
                              lambda: ops.warp_group_corr_backward(*args),
                              lambda: torch.autograd.grad(out, (s_, r_), dout, retain_graph=True),
                              f"B8 {layout}")
                        del out
            label = f"stage{stage} C{c} G{g} K9 B{b} {h}x{w} {tag}"
            hold("neighbor_group_corr", label, ops.neighbor_group_corr(ref, grid, g),
                 ops.neighbor_group_corr_reference(ref, grid, g), cfg.interval_scale)
            dout = torch.randn((b, g, 9, h, w), generator=bgen, device=device)
            args = (ref, grid, g, dout)
            check("neighbor_group_corr_backward", label, ops.neighbor_group_corr_backward(*args),
                  ops.neighbor_group_corr_backward_reference(*args), dtype)
            if dtype == torch.bfloat16:
                gx, gy = (t.detach().requires_grad_(True) for t in grid)
                out = ops.neighbor_group_corr_reference(ref, (gx, gy), g)
                timed("neighbor_group_corr_backward", label, 1, args,
                      lambda: ops.neighbor_group_corr_backward(*args),
                      lambda: torch.autograd.grad(out, (gx, gy), dout, retain_graph=True), "B8")
                del out
        del feats, ref, src, args, dout
    print(f"warp_group_corr_backward device ms per train step: i.i.d. depths "
          f"{fmt_ms(per_step['iid'])}, the training path's layout {fmt_ms(per_step['path'])}; "
          f"at {CLI_BATCH} with 1 + 5 views: i.i.d. depths {fmt_ms(per_step['B8 iid'])}, the "
          f"training path's layout {fmt_ms(per_step['B8 path'])}", flush=True)
    return summary


def _cosine(a, b) -> float:
    a, b = a.double().ravel(), b.double().ravel()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def train_step_parity(device, state_dict):
    """Phase 8: one f32 train step on the card (kernels on, TF32 off) vs the
    same step on the CPU (plain versions), 64x80, N=3, B=2 plane batch."""
    import torch

    from patchmatchnet_torch.data import plane_batch
    from patchmatchnet_torch.models import PatchmatchNet
    from patchmatchnet_torch.ops import cuda_build
    from patchmatchnet_torch.train import batch_to_device, make_optimizer, train_step

    batch = plane_batch(2, 3, 64, 80)
    results = {}
    for dev in (torch.device("cpu"), device):
        model = PatchmatchNet().to(dev)
        model.load_state_dict(state_dict, strict=True)
        cuda_build.reset_launch_counts()
        metrics, _ = train_step(model, make_optimizer(model.parameters(), 0.0),
                                batch_to_device(batch, dev), 0.0,
                                torch.from_numpy(batch["noise"]).to(dev), with_grads=True)
        results[dev.type] = (float(metrics["loss"]),
                             {k: v.cpu() for k, v in metrics["grads"].items()},
                             cuda_build.launch_counts())
    (cpu_loss, cpu_grads, _), (gpu_loss, gpu_grads, counts) = results["cpu"], results["cuda"]
    rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    top = max(float(g.norm()) for g in cpu_grads.values())
    cos = {k: _cosine(cpu_grads[k], gpu_grads[k]) for k, g in cpu_grads.items()
           if float(g.norm()) >= 1e-3 * top}
    worst = min(cos, key=cos.get)
    print(f"f32 train step 64x80 N=3 B=2: loss card {gpu_loss:.7f} cpu {cpu_loss:.7f} "
          f"rel {rel:.3e}; {len(cos)} gradient leaves above 1e-3 of the largest norm, "
          f"min cosine {cos[worst]:.6f} ({worst}), median "
          f"{statistics.median(cos.values()):.6f}; launches {counts}", flush=True)
    if not (rel < 1e-4 and cos[worst] > 0.999):
        fail("f32 train step on the card disagrees with the CPU step "
             "(bounds: loss 1e-4 relative, cosine 0.999)")
    want = {"warp_group_corr": 10, "warp_group_corr_backward": 10, "neighbor_group_corr": 3,
            "neighbor_group_corr_backward": 3}
    if any(counts.get(k, 0) != v for k, v in want.items()) or counts.get("eval_grid_score"):
        fail(f"f32 train step launches {counts}, expected {want} and no eval_grid_score")


def trace_steps(step, steps: int, path: str) -> None:
    """Profile `steps` calls of step() and print launches, device-busy time,
    idle share of the traced span and device time by kernel kind, per call."""
    from patchmatchnet_torch.utils.trace import (
        busy_union_us,
        hand_kernel_id,
        kernel_kind,
        trace_device_events,
    )

    events = trace_device_events(step, steps, path)
    if not events:
        print("trace: no device events recorded", flush=True)
        return
    busy = busy_union_us((s, s + d) for _, _, s, d in events)
    span = max(s + d for _, _, s, d in events) - min(s for _, _, s, _ in events)
    kinds, hand = {}, {}
    launches = 0
    for cat, name, _, dur in events:
        if cat == "kernel":
            launches += 1
            for table, key in ((kinds, kernel_kind(name)), (hand, hand_kernel_id(name))):
                if key is not None:
                    k = table.setdefault(key, [0.0, 0])
                    k[0] += dur
                    k[1] += 1
    print(f"trace of {steps} steps: {launches / steps:.0f} kernel launches per step, device "
          f"busy {busy / steps / 1e3:.2f} ms of {span / steps / 1e3:.2f} ms traced span per step "
          f"(idle share {1 - busy / span:.3f}); device ms per step by kind: "
          + ", ".join(f"{name} {us / steps / 1e3:.2f} ({n / steps:.0f})"
                      for name, (us, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0])),
          flush=True)
    print("hand kernels per step (device ms, launches): "
          + ", ".join(f"{kid} {us / steps / 1e3:.4f} ({n / steps:.0f})"
                      for kid, (us, n) in sorted(hand.items())), flush=True)


def step_scatter(step) -> None:
    """Run step() once with K4's calls recorded and print K4's scatter count
    (`k4_scatter_counts`) summed over them."""
    from patchmatchnet_torch.dev.profile_backward import record_calls
    from patchmatchnet_torch.ops.warp_similarity import k4_scatter_counts

    calls = [args for kid, args in record_calls(step) if kid == "K4"]
    total = {}
    for args in calls:
        for key, v in k4_scatter_counts(*args).items():
            total[key] = total.get(key, 0) + v
    print(f"K4 scatter over one train step's {len(calls)} calls: {scatter_line(total)}",
          flush=True)
    if len(calls) != EXPECTED_PER_STEP["warp_group_corr_backward"]:
        fail(f"one train step made {len(calls)} K4 calls, expected "
             f"{EXPECTED_PER_STEP['warp_group_corr_backward']}")


def training_path(device, scratch):
    """Phase 9: the bf16 training path at 640x512, N=5, B=2. Returns the
    launch counts of the driver's run."""
    import torch

    from patchmatchnet_torch.config import Config
    from patchmatchnet_torch.data import BatchLoader, MVSDataset, make_synthetic_scene
    from patchmatchnet_torch.models import PatchmatchNet
    from patchmatchnet_torch.ops import cuda_build
    from patchmatchnet_torch.train import (
        batch_to_device,
        load_train_checkpoint,
        make_optimizer,
        run_training,
        save_train_checkpoint,
        train_step,
    )
    from patchmatchnet_torch.train.driver import load_model_weights, step_noise

    scene = os.path.join(scratch, "train_scene")
    make_synthetic_scene(scene, num_views=TRAIN_SCENE_VIEWS, height=TRAIN_H, width=TRAIN_W,
                         texture_scale=8.0)
    dataset = MVSDataset(scene, TRAIN_VIEWS - 1, ".png")
    loader = BatchLoader(dataset, TRAIN_BATCH, shuffle=True, drop_last=True, seed=1)
    batches = [batch_to_device(b, device) for b in loader]  # 6 batches of 2
    if len(batches) < TIMED_STEPS:
        fail(f"the scene gives {len(batches)} batches, need {TIMED_STEPS}")

    def fresh():
        model = PatchmatchNet(compute_dtype=torch.bfloat16).to(device)
        load_model_weights(model, CKPT)
        return model, make_optimizer(model.parameters(), 1e-3)

    model, opt = fresh()
    train_step(model, opt, batches[0], 1e-3, step_noise(batches[0], 1, 0))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    cuda_build.reset_launch_counts()
    ms, losses = [], []
    for i in range(1, TIMED_STEPS + 1):
        batch = batches[i % len(batches)]
        start = time.perf_counter()
        metrics, _ = train_step(model, opt, batch, 1e-3, step_noise(batch, 1, i))
        losses.append(float(metrics["loss"]))  # waits for the step
        ms.append((time.perf_counter() - start) * 1e3)
    counts = cuda_build.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    med = statistics.median(ms)
    print(f"timed steps {TIMED_STEPS}, ms per step: " + " ".join(f"{t:.2f}" for t in ms),
          flush=True)
    print(f"median ms/step {med:.2f}, {TRAIN_BATCH * 1e3 / med:.3f} samples/s, peak memory "
          f"{peak / 2**20:.1f} MiB, losses " + " ".join(f"{v:.5f}" for v in losses),
          flush=True)
    print(f"launch counts over {TIMED_STEPS} steps: {counts}", flush=True)
    trace_steps(lambda: train_step(model, opt, batches[1], 1e-3, step_noise(batches[1], 1, 1)),
                2, os.path.join(scratch, "train_trace.json"))
    step_scatter(lambda: train_step(model, opt, batches[2], 1e-3, step_noise(batches[2], 1, 2)))
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite training loss: {losses}")
    for name, per in EXPECTED_PER_STEP.items():
        if counts.get(name, 0) != per * TIMED_STEPS:
            fail(f"{name} launched {counts.get(name, 0)} times, expected {per} x {TIMED_STEPS}")

    # resume: the checkpoint after step k takes step k + 1 as the
    # uninterrupted run does: the same loss (the parameters), the same
    # update (the Adam moments and step count; the backward's atomics make
    # it equal only to rounding) and the same running statistics
    ckpt = os.path.join(scratch, "resume", "params_000000.ckpt.pt")
    k = TIMED_STEPS
    save_train_checkpoint(ckpt, model, opt, step=k + 1, epoch=0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    nxt = batches[(k + 1) % len(batches)]
    noise = step_noise(nxt, 1, k + 1)
    want = float(train_step(model, opt, nxt, 1e-3, noise)[0]["loss"])
    model2, opt2 = fresh()
    load_train_checkpoint(ckpt, model2, opt2)
    got = float(train_step(model2, opt2, nxt, 1e-3, noise)[0]["loss"])
    rel = abs(got - want) / abs(want)

    def norm(tensors):
        return math.sqrt(sum(float(t.double().square().sum()) for t in tensors))

    after = {n: p.detach() for n, p in model.named_parameters()}
    after2 = {n: p.detach() for n, p in model2.named_parameters()}
    update = norm(after[n] - before[n] for n in after)
    update_rel = norm(after2[n] - after[n] for n in after) / update
    buffers2 = dict(model2.named_buffers())
    stats_rel = norm(buffers2[n] - b for n, b in model.named_buffers()) / norm(
        b for _, b in model.named_buffers())
    print(f"resume: step {k + 1} loss {want:.7f}, from the checkpoint {got:.7f} "
          f"(rel {rel:.3e}); update |resumed - uninterrupted| / |update| {update_rel:.3e} "
          f"(|update| {update:.3e}); running statistics rel {stats_rel:.3e}", flush=True)
    if rel > 1e-5 or update_rel > 1e-2 or stats_rel > 1e-5:
        fail("the resumed step differs from the uninterrupted one (bounds: loss 1e-5, "
             "update 1e-2, running statistics 1e-5 relative)")
    del model, opt, model2, opt2, batches, before

    # the driver: one epoch of the same scene
    cfg = Config()
    cfg.data.input_folder = scene
    cfg.data.num_views = TRAIN_VIEWS - 1
    cfg.data.image_extension = ".png"
    cfg.data.batch_size = TRAIN_BATCH
    cfg.train.output_folder = os.path.join(scratch, "run")
    cfg.train.checkpoint_path = CKPT
    cfg.train.epochs = 1
    cfg.train.summary_freq = 1
    cuda_build.reset_launch_counts()
    history = run_training(cfg)
    counts = cuda_build.launch_counts()
    steps = len(history)
    val = len(dataset) // TRAIN_BATCH  # validation forwards (running statistics)
    print(f"run_training: {steps} steps, losses "
          + " ".join(f"{r['loss']:.5f}" for r in history) + ", ms per step "
          + " ".join(f"{r['step_ms']:.2f}" for r in history) + f"; launches {counts}", flush=True)
    want = {name: per * steps for name, per in EXPECTED_PER_STEP.items()}
    for name, per in EXPECTED_PER_FORWARD.items():
        want[name] = want.get(name, 0) + per * val
    if counts != {k: v for k, v in want.items() if v}:
        fail(f"run_training launched {counts}, expected {want}")
    if not all(math.isfinite(r["loss"]) for r in history):
        fail("run_training produced a non-finite loss")
    if not os.path.isfile(os.path.join(cfg.train.output_folder, "params_000000.ckpt.pt")):
        fail("run_training wrote no checkpoint")
    return counts


def gather_phase(device):
    """Phase 10: each section of the port's gather tool at the JAX tool's
    shapes (it raises if a kernel differs from its plain version or from
    `torch.gather` in one element). Returns the D1-D5 entries of the
    kernels line: per section the kernel's launches, and times and bytes
    summed over the section's cases (a gather does no arithmetic: bound by
    bytes)."""
    import torch

    from patchmatchnet_torch.dev import bench_gather
    from patchmatchnet_torch.ops import cuda_build
    from patchmatchnet_torch.utils.trace import fmt_ms

    def sum_or_none(values):
        values = list(values)
        return None if None in values else sum(values)

    results, launches = {}, {}
    for section, bench in bench_gather.SECTIONS.items():
        cuda_build.reset_launch_counts()
        try:
            cases = bench(device=device)
        except RuntimeError as e:
            fail(f"gather section {section}: {e}")
        launches[section] = cuda_build.launch_counts()
        torch.cuda.empty_cache()
        for c in cases:
            bound_ms, by = bound(c["bytes"], 0)
            print(f"{section} {c['case']}: kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms "
                  f"torch.gather {c['library_ms']:.4f} ms bound {bound_ms:.4f} ms ({by}, "
                  f"{c['bytes'] / 1e6:.1f} MB); device time kernel {fmt_ms(c['device_ms'])} "
                  f"torch.gather {fmt_ms(c['library_device_ms'])}; "
                  f"max_abs {c['max_abs_err']:.1e}", flush=True)
        results[section] = cases
    print(f"gather launches per section: {launches}", flush=True)
    entries = []
    for did, (kernel, section, replaces) in GATHER_KERNELS.items():
        cases = results[section]
        n = launches[section].get(kernel, 0)
        if n == 0 or set(launches[section]) != {kernel}:
            fail(f"gather section {section} launched {launches[section]}, expected {kernel}")
        bound_ms, bound_by = bound(sum(c["bytes"] for c in cases), 0)
        entries.append({
            "name": f"{kernel}_{did.lower()}", "route": "cuda", "source": GATHER_SOURCE,
            "replaces": replaces, "launches": n,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": sum(c["ms"] for c in cases), "plain_ms": sum(c["plain_ms"] for c in cases),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sum(c["library_ms"] for c in cases), "timing": GATHER_TIMING,
            "device_ms": sum_or_none(c["device_ms"] for c in cases),
            "library_device_ms": sum_or_none(c["library_device_ms"] for c in cases)})
    return entries


def reconstruction_path(device, state_dict, scene, smi):
    """Phase 11: an 11-view scan from images to a fused, coloured PLY. The
    bf16 DepthEstimator writes every view's depth and confidence maps as
    COLMAP .bin (1 + 4 views per map, as phase 5); `filter_and_fuse` fuses
    them on the card, each reference with 10 sources, twice (the first run
    warms up, the second is timed and checked). Then, for FUSION_CHECK_VIEWS,
    the consistency of the reference with its sources and the backprojected
    points on the card against the same on the CPU."""
    import numpy as np
    import torch
    from PIL import Image

    from patchmatchnet_torch.data import (
        PLANE_Z,
        BatchLoader,
        MVSDataset,
        make_synthetic_scene,
        read_cam_file,
        read_map,
        read_pair_file,
        read_ply,
    )
    from patchmatchnet_torch.geometry import backproject_to_world
    from patchmatchnet_torch.infer import DepthEstimator, FusionConfig, save_depth_maps
    from patchmatchnet_torch.infer.fusion import consistency_all_sources, filter_and_fuse
    from patchmatchnet_torch.models import PatchmatchNet
    from patchmatchnet_torch.ops import cuda_build

    make_synthetic_scene(scene, num_views=RECON_VIEWS, height=MAIN_H, width=MAIN_W,
                         texture_scale=8.0)
    best_first_pairs(scene)
    pairs = dict(read_pair_file(os.path.join(scene, "pair.txt")))

    model = PatchmatchNet(compute_dtype=torch.bfloat16)
    model.load_state_dict(state_dict, strict=True)
    estimator = DepthEstimator(model, device=device)
    dataset = MVSDataset(scene, num_views=MAIN_VIEWS - 1, image_extension=".png")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    start = time.perf_counter()
    cuda_build.reset_launch_counts()
    written = save_depth_maps(estimator, BatchLoader(dataset, batch_size=1), scene, seed=0,
                              file_format=".bin")
    counts = cuda_build.launch_counts()
    maps_s = time.perf_counter() - start
    maps_peak = torch.cuda.max_memory_allocated(device)
    del estimator, model
    torch.cuda.empty_cache()
    print(f"depth maps: {written} of {RECON_VIEWS} views as .bin in {maps_s:.2f} s, peak "
          f"memory {maps_peak / 2**20:.1f} MiB; launch counts: {counts}", flush=True)
    if written != RECON_VIEWS:
        fail(f"wrote {written} depth maps, expected {RECON_VIEWS}")
    if counts != {name: per * RECON_VIEWS for name, per in EXPECTED_PER_FORWARD.items()}:
        fail(f"depth maps launched {counts}, expected {EXPECTED_PER_FORWARD} x {RECON_VIEWS}")

    cfg = FusionConfig(file_format=".bin", image_extension=".png")
    runs = []
    for timed in (False, True):  # the second run overwrites the first's outputs
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
        timings = {}
        start = time.perf_counter()
        ply = filter_and_fuse(scene, scene, "", cfg, verbose=timed, device=device,
                              timings=timings)
        runs.append((ply, time.perf_counter() - start, timings,
                     torch.cuda.max_memory_allocated(device) - held))
    ply, total_s, timings, fusion_peak = runs[-1]
    per_view = {k: v * 1e3 / RECON_VIEWS for k, v in timings.items()}
    print(f"fusion on the card, {RECON_VIEWS} reference views x {len(pairs[0])} sources, "
          f"{MAIN_W}x{MAIN_H}: {total_s * 1e3 / RECON_VIEWS:.2f} ms per reference view "
          f"(warm-up run {runs[0][1] * 1e3 / RECON_VIEWS:.2f}); host ms per view: "
          + ", ".join(f"{k} {v:.2f}" for k, v in per_view.items())
          + f"; peak memory {fusion_peak / 2**20:.1f} MiB above what the process held "
          f"before (depth maps: peak {maps_peak / 2**20:.1f} MiB); card {smi}", flush=True)

    xyz, _ = read_ply(ply)
    if xyz.shape[0] == 0 or not np.isfinite(xyz).all():
        fail(f"fused.ply holds {xyz.shape[0]} points (finite {np.isfinite(xyz).all()})")
    z_err = float(np.median(np.abs(xyz[:, 2] - PLANE_Z)))
    print(f"fused points {xyz.shape[0]} ({xyz.shape[0] / (RECON_VIEWS * MAIN_H * MAIN_W):.4f} "
          f"of the pixels); median |z - plane| {z_err:.4f} (plane at {PLANE_Z})", flush=True)
    if z_err > 0.05 * PLANE_Z:
        fail(f"fused points: median |z - plane| {z_err:.4f} above 5% of the plane depth")

    # the card against the CPU on the same maps, for FUSION_CHECK_VIEWS
    finals = {v: np.asarray(Image.open(os.path.join(scene, "mask", f"{v:08d}_final.png"))) > 0
              for v in pairs}
    offsets = dict(zip(pairs, np.cumsum([0] + [f.sum() for f in finals.values()])))

    def load(v, folder):
        return torch.from_numpy(read_map(os.path.join(scene, folder, f"{v:08d}.bin"))[..., 0])

    for ref in FUSION_CHECK_VIEWS:
        cams = {v: [torch.from_numpy(a) for a in read_cam_file(
            os.path.join(scene, "cams", f"{v:08d}_cam.txt"))[:2]] for v in [ref] + pairs[ref]}
        photo = load(ref, "confidence") > cfg.photo_thres
        res = []
        for dev in (device, torch.device("cpu")):
            ref_depth = load(ref, "depth_est").to(dev)
            geo_sum, reproj_sum = consistency_all_sources(
                ref_depth, *cams[ref],
                torch.stack([load(s, "depth_est") for s in pairs[ref]]).to(dev),
                torch.stack([cams[s][0] for s in pairs[ref]]),
                torch.stack([cams[s][1] for s in pairs[ref]]),
                cfg.geo_pixel_thres, cfg.geo_depth_thres)
            final = (geo_sum >= cfg.geo_mask_thres) & photo.to(dev)
            world = backproject_to_world((reproj_sum + ref_depth) / (geo_sum + 1), *cams[ref])
            res.append((geo_sum.cpu().numpy(), final.cpu().numpy(), world.cpu().numpy()))
        (g_sum, g_final, _), (c_sum, c_final, c_world) = res
        sum_diff, final_diff = (g_sum != c_sum).mean(), (g_final != c_final).mean()
        both = g_final & c_final
        fused = xyz[offsets[ref]:offsets[ref] + g_final.sum()]
        rel = (np.linalg.norm(fused[both[g_final]] - c_world[both], axis=1)
               / np.linalg.norm(c_world[both], axis=1))
        print(f"ref view {ref}: card vs CPU geo_sum differs at {sum_diff:.2e} and the final "
              f"mask at {final_diff:.2e} of the pixels; fused points of {both.sum()} pixels in "
              f"both final masks, max relative difference {rel.max():.2e}", flush=True)
        if not np.array_equal(g_final, finals[ref]):
            fail(f"ref view {ref}: the card's final mask differs from its fusion run's")
        if sum_diff > 1e-3 or final_diff > 1e-3 or both.sum() == 0 or rel.max() > 1e-4:
            fail(f"ref view {ref}: card and CPU fusion disagree")


def run_cli(label: str, argv, timeout: int):
    """Run `python -m patchmatchnet_torch <argv>` from the checkout, killed
    at `timeout` s. Returns (stdout, the kernel launches it printed,
    seconds); fails on a non-zero exit or a timeout."""
    import ast

    start = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-m", "patchmatchnet_torch", *argv], cwd=REPO,
                              capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"CLI {label}: no result within {timeout} s")
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        print("\n".join((proc.stdout + proc.stderr).splitlines()[-30:]), flush=True)
        fail(f"CLI {label} exited with {proc.returncode}")
    counts = {}
    for line in proc.stdout.splitlines():
        if line.startswith("kernel launches: "):
            counts = ast.literal_eval(line[len("kernel launches: "):])
    print(f"CLI {label}: {seconds:.2f} s in all (process start, model, kernels' library load "
          f"included); kernel launches {counts}", flush=True)
    return proc.stdout, counts, seconds


def forward_launches(views: int, evaluations: int) -> dict:
    """Hand-kernel launches of one inference forward: K1 per source view on
    the first evaluation, K6 on every later one, K2 on every one, K3 once a
    stage."""
    return {"warp_group_corr": views, "warp_group_corr_views": evaluations - 1,
            "eval_grid_score": evaluations, "neighbor_group_corr": 3}


def step_launches(views: int, evaluations: int) -> dict:
    """Hand-kernel launches of one train step: K1 and K4 per source view on
    every evaluation, K3 and K5 once a stage (the training tail is plain)."""
    return {"warp_group_corr": views * evaluations,
            "warp_group_corr_backward": views * evaluations,
            "neighbor_group_corr": 3, "neighbor_group_corr_backward": 3}


def expect_launches(label: str, counts, parts) -> None:
    """Fail unless `counts` is the sum of (times, launches) parts."""
    want = {}
    for times, launches in parts:
        for name, n in launches.items():
            want[name] = want.get(name, 0) + times * n
    want = {k: v for k, v in want.items() if v}
    if counts != want:
        fail(f"CLI {label} launched {counts}, expected {want}")


def best_first_pairs(scene: str) -> None:
    """Rewrite a synthetic scene's pair.txt with each reference's sources
    best first (score 10 - |s - v|), as DTU's pair.txt lists them."""
    from patchmatchnet_torch.data import read_pair_file, save_pair_file

    path = os.path.join(scene, "pair.txt")
    save_pair_file(path, [(v, [(s, 10.0 - abs(s - v))
                               for s in sorted(srcs, key=lambda s: abs(s - v))])
                          for v, srcs in read_pair_file(path)])


def cli_path(device, scratch, smi) -> None:
    """Phase 12: the command line on the card, three runs of
    `python -m patchmatchnet_torch`, each its own process with its own
    timeout. (a) eval at scripts/eval.sh's DTU preset on a 7-view 1600x1200
    scan: every map, the fused cloud near the plane, and the CLI's map of
    view 0 against DepthEstimator in this process; (b) train with
    scripts/train.sh's flags that apply (B = 8, one epoch of 3 steps,
    640x512) from the released weights; (c) the variant configuration
    (VARIANT_FLAGS) trained one epoch from scratch at 640x512, B = 2, then
    evaluated from the module it wrote at 1152x864, 1 + 4 views."""
    import re

    import numpy as np
    import torch
    from PIL import Image

    from patchmatchnet_torch.config import Config
    from patchmatchnet_torch.data import (
        PLANE_Z,
        BatchLoader,
        MVSDataset,
        make_synthetic_scene,
        read_pfm,
        read_ply,
    )
    from patchmatchnet_torch.infer import DepthEstimator
    from patchmatchnet_torch.train.driver import build_model, load_any_checkpoint

    # (a) eval, DTU preset: 7 views of 1600x1200, 1 + 5 views per map
    root = os.path.join(scratch, "dtu")
    scan = os.path.join(root, CLI_EVAL_SCAN)
    make_synthetic_scene(scan, num_views=CLI_EVAL_VIEWS, height=CLI_EVAL_H, width=CLI_EVAL_W,
                         texture_scale=CLI_EVAL_TEXTURE)
    best_first_pairs(scan)
    scan_list = os.path.join(root, "test.txt")
    with open(scan_list, "w") as f:
        f.write(CLI_EVAL_SCAN + "\n")
    out = os.path.join(scratch, "dtu_out")
    stdout, counts, seconds = run_cli(
        "eval (DTU preset)", ["eval", "--input_folder", root, "--output_folder", out,
                              "--checkpoint_path", CKPT, "--scan_list", scan_list,
                              "--image_extension", ".png", *DTU_EVAL_FLAGS], CLI_TIMEOUT)
    maps = re.search(r"Wrote (\d+) depth/confidence map pairs in ([\d.]+) s \(([\d.]+) ms per "
                     r"map\); request ms: first ([\d.]+) \(set-up included\), then median ([\d.]+)",
                     stdout)
    fused = re.search(r"Fused (\S+) in ([\d.]+) s", stdout)
    if not maps or not fused or int(maps.group(1)) != CLI_EVAL_VIEWS:
        fail(f"CLI eval printed no map or fusion timing for {CLI_EVAL_VIEWS} views")
    expect_launches("eval (DTU preset)", counts,
                    [(CLI_EVAL_VIEWS, forward_launches(CLI_EVAL_SOURCES, 5))])
    errs = []
    for v in range(CLI_EVAL_VIEWS):
        depth = read_pfm(os.path.join(out, CLI_EVAL_SCAN, "depth_est", f"{v:08d}.pfm"))[..., 0]
        conf = read_pfm(os.path.join(out, CLI_EVAL_SCAN, "confidence", f"{v:08d}.pfm"))[..., 0]
        for name, m in (("depth", depth), ("confidence", conf)):
            if m.shape != (CLI_EVAL_H, CLI_EVAL_W) or not np.isfinite(m).all():
                fail(f"CLI eval view {v}: {name} map {m.shape}, finite {np.isfinite(m).all()}")
        final = np.asarray(Image.open(os.path.join(out, CLI_EVAL_SCAN, "mask",
                                                   f"{v:08d}_final.png"))) > 0
        errs.append((float(np.median(np.abs(depth[final] - PLANE_Z))) if final.any()
                     else float("nan"), float(final.mean())))
    xyz, _ = read_ply(fused.group(1))
    z_err = float(np.median(np.abs(xyz[:, 2] - PLANE_Z))) if xyz.shape[0] else float("inf")
    print(f"CLI eval {CLI_EVAL_W}x{CLI_EVAL_H}, {CLI_EVAL_VIEWS} views, 1 + {CLI_EVAL_SOURCES} "
          f"views per map: {float(maps.group(3)):.2f} ms per map ({maps.group(2)} s for "
          f"{maps.group(1)} maps; requests: the first {maps.group(4)} ms with its set-up, then "
          f"median {maps.group(5)} ms); fusion "
          f"{float(fused.group(2)) * 1e3 / CLI_EVAL_VIEWS:.2f} ms per fused view "
          f"({fused.group(2)} s); "
          f"{xyz.shape[0]} points, median |z - plane| {z_err:.4f}; median |depth - plane| on the "
          "final mask (mask share) per view: "
          + " ".join(f"{e:.4f} ({m:.2f})" for e, m in errs) + f"; card {smi}", flush=True)
    if not all(math.isfinite(e) and e <= 0.05 * PLANE_Z for e, _ in errs):
        fail("CLI eval: a view's median depth error on its final mask is above 5% of the plane")
    if xyz.shape[0] == 0 or z_err > 0.05 * PLANE_Z:
        fail(f"CLI eval: fused.ply has {xyz.shape[0]} points, median |z - plane| {z_err:.4f}")

    # view 0 through DepthEstimator in this process: the same weights,
    # inputs and noise (seed 0, the first draw)
    model = build_model(Config(), inference=True)
    model.load_state_dict(load_any_checkpoint(CKPT), strict=True)
    estimator = DepthEstimator(model, device=device)
    dataset = MVSDataset(root, CLI_EVAL_SOURCES, ".png", max_dim=CLI_EVAL_W, scan_list=scan_list)
    batch = next(iter(BatchLoader(dataset, 1, num_threads=1)))
    depth = estimator(batch, torch.Generator(device=device).manual_seed(0))[0][0]
    cli_depth = read_pfm(os.path.join(out, CLI_EVAL_SCAN, "depth_est", "00000000.pfm"))[..., 0]
    diff = np.abs(depth - cli_depth)
    off = float((diff > 1e-3 * (1.3 - 0.8) * PLANE_Z).mean())
    print(f"CLI view 0 against DepthEstimator in this process: max |diff| {diff.max():.3e}, "
          f"median {np.median(diff):.3e}, share of pixels off by more than 1e-3 of the depth "
          f"range {off:.2e}", flush=True)
    if np.median(diff) != 0.0 or off > 1e-3:
        fail("CLI view 0 differs from DepthEstimator (bounds: median 0, at most 0.1% of the "
             "pixels off by more than 1e-3 of the depth range)")
    # this process's steady state at the same preset, beside the CLI's
    ms = []
    for batch in BatchLoader(dataset, 1):
        torch.cuda.synchronize()
        start = time.perf_counter()
        estimator(batch, torch.Generator(device=device).manual_seed(0))
        ms.append((time.perf_counter() - start) * 1e3)
    print("DepthEstimator in this process, same preset, warm: ms per map "
          + " ".join(f"{t:.2f}" for t in ms) + f" (median {statistics.median(ms):.2f})",
          flush=True)
    del estimator, model
    torch.cuda.empty_cache()

    # (b) train, scripts/train.sh's flags that apply: B = 8, one epoch
    train_root = os.path.join(scratch, "train")
    make_synthetic_scene(os.path.join(train_root, CLI_TRAIN_SCAN), num_views=CLI_TRAIN_VIEWS,
                         height=TRAIN_H, width=TRAIN_W, texture_scale=8.0)
    best_first_pairs(os.path.join(train_root, CLI_TRAIN_SCAN))
    train_list = os.path.join(train_root, "train.txt")
    with open(train_list, "w") as f:
        f.write(CLI_TRAIN_SCAN + "\n")
    lists = ["--train_list", train_list, "--test_list", train_list]
    out = os.path.join(scratch, "train_out")
    _, counts, _ = run_cli("train (B 8)", [
        "train", "--input_folder", train_root, "--output_folder", out, *lists,
        "--image_extension", ".png", "--batch_size", str(CLI_TRAIN_BATCH), "--epochs", "1",
        "--checkpoint_path", CKPT, "--summary_freq", "1"], CLI_TIMEOUT)
    steps = CLI_TRAIN_VIEWS // CLI_TRAIN_BATCH
    records = read_training_run(out, steps)
    print(f"CLI train {TRAIN_W}x{TRAIN_H}, 1 + 5 views, B {CLI_TRAIN_BATCH}, {steps} steps: ms per "
          "step " + " ".join(f"{r['step_ms']:.2f}" for r in records) + ", losses "
          + " ".join(f"{r['loss']:.5f}" for r in records)
          + f", peak {records[-1].get('peak_mib', float('nan')):.1f} MiB; card {smi}", flush=True)
    expect_launches("train (B 8)", counts, [(steps, step_launches(5, 5)),
                                            (steps, forward_launches(5, 5))])

    # (c) the variant configuration: one epoch from scratch, B = 2, then
    # eval from the module it wrote at 1152x864, 1 + 4 views
    out = os.path.join(scratch, "variant_out")
    _, counts, _ = run_cli("train (variant)", [
        "train", "--input_folder", train_root, "--output_folder", out, *lists,
        "--image_extension", ".png", "--batch_size", "2", "--epochs", "1", "--summary_freq", "1",
        *VARIANT_FLAGS], CLI_TIMEOUT)
    steps = CLI_TRAIN_VIEWS // 2
    records = read_training_run(out, steps)
    expect_launches("train (variant)", counts, [(steps, step_launches(5, 5)),
                                                (steps, forward_launches(5, 5))])
    eval_root = os.path.join(scratch, "variant_scene")
    make_synthetic_scene(eval_root, num_views=MAIN_VIEWS, height=MAIN_H, width=MAIN_W,
                         texture_scale=8.0)
    eval_out = os.path.join(scratch, "variant_eval")
    stdout, counts, _ = run_cli("eval (variant)", [
        "eval", "--input_folder", eval_root, "--output_folder", eval_out, "--output_type", "depth",
        "--checkpoint_path", os.path.join(out, "module_000000.pt"), "--num_views",
        str(MAIN_VIEWS - 1), "--image_extension", ".png", *VARIANT_FLAGS], CLI_TIMEOUT)
    expect_launches("eval (variant)", counts,
                    [(MAIN_VIEWS, forward_launches(MAIN_VIEWS - 1, 5))])
    errs = []
    for v in range(MAIN_VIEWS):
        depth = read_pfm(os.path.join(eval_out, "depth_est", f"{v:08d}.pfm"))[..., 0]
        if depth.shape != (MAIN_H, MAIN_W) or not np.isfinite(depth).all():
            fail(f"CLI variant eval view {v}: depth map {depth.shape}, finite "
                 f"{np.isfinite(depth).all()}")
        errs.append(float(np.median(np.abs(depth - PLANE_Z))))
    maps = re.search(r"then median ([\d.]+)", stdout)
    print("CLI variant: train losses " + " ".join(f"{r['loss']:.5f}" for r in records)
          + f" ({steps} steps, one epoch from scratch), eval "
          f"{MAIN_W}x{MAIN_H} 1 + {MAIN_VIEWS - 1} views, requests after the first: median "
          f"{maps.group(1) if maps else '?'} ms per map; median |depth - plane| per map (not "
          "gated: one epoch of training) "
          + " ".join(f"{e:.4f}" for e in errs), flush=True)


def read_training_run(out: str, steps: int):
    """The train records of a CLI training run (metrics.jsonl), after
    checking its checkpoint set, a finite loss logged for each of its
    `steps` steps (run with --summary_freq 1) and a validation."""
    for name in ("params_000000.ckpt.pt", "module_000000.pt", "config.json", "metrics.jsonl"):
        if not os.path.isfile(os.path.join(out, name)):
            fail(f"CLI train wrote no {name}")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r["mode"] == "train"]
    if len(train) != steps or not all(math.isfinite(r["loss"]) for r in train):
        fail(f"CLI train logged {len(train)} steps, losses {[r['loss'] for r in train]}")
    if not any(r["mode"] == "full_test" for r in records):
        fail("CLI train logged no validation")
    return train


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "patchmatchnet_torch")):
        fail("run from a checkout of the repository (patchmatchnet_torch/ not found)")
    sys.path.insert(0, REPO)
    import torch

    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    phase("build")
    from patchmatchnet_torch.ops import cuda_build

    start = time.perf_counter()
    cuda_build.kernel_library()
    built = cuda_build.build_seconds()
    print(f"kernel library {cuda_build.library_path().relative_to(REPO)}: "
          f"{'built in %.1f s' % built if built is not None else 'reused'} "
          f"(load {time.perf_counter() - start:.1f} s)", flush=True)
    log = cuda_build.library_path().parent / "nvcc.log"
    if log.is_file():  # ptxas resource usage per kernel instantiation
        for line in log.read_text().splitlines():
            if any(k in line for k in ("Compiling entry function", "Used", "spill")):
                print("  " + line.split(":", 1)[-1].strip(), flush=True)

    phase("kernel parity (kernel vs plain version on the card)")
    summary = kernel_parity(device)

    phase("f32 golden parity (kernels on, TF32 off)")
    from patchmatchnet_torch.compat import read_flax_msgpack, state_dict_from_jax
    from patchmatchnet_torch.data import make_synthetic_scene
    from patchmatchnet_torch.models import PatchmatchNet

    state_dict = state_dict_from_jax(read_flax_msgpack(CKPT))
    model_f32 = PatchmatchNet().to(device).eval()
    model_f32.load_state_dict(state_dict, strict=True)
    golden_parity(device, model_f32)
    del model_f32

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    scene = tempfile.mkdtemp(prefix="smoke_scene_", dir=os.path.join(REPO, "build"))
    try:
        make_synthetic_scene(scene, num_views=MAIN_VIEWS, height=MAIN_H, width=MAIN_W,
                             texture_scale=8.0)
        phase(f"main path: bf16 DepthEstimator, {MAIN_W}x{MAIN_H}, {MAIN_VIEWS} views, "
              f"{REQUESTS} requests")
        counts, estimator = main_path(device, state_dict, scene)

        phase(f"coordinate-input path: plane sweep through coord_group_corr (K7) at "
              f"{MAIN_W}x{MAIN_H}, {MAIN_VIEWS} views")
        counts.update(coordinate_path(device, estimator.model, scene))
        del estimator
    finally:
        shutil.rmtree(scene, ignore_errors=True)

    phase("backward-kernel parity (K4/K5 vs plain versions on the card)")
    summary.update(backward_parity(device))

    phase("f32 train-step parity (card with kernels, TF32 off, vs CPU)")
    train_step_parity(device, state_dict)

    phase(f"training path: bf16, {TRAIN_W}x{TRAIN_H}, {TRAIN_VIEWS} views, "
          f"batch {TRAIN_BATCH}")
    scratch = tempfile.mkdtemp(prefix="smoke_train_", dir=os.path.join(REPO, "build"))
    try:
        train_counts = training_path(device, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    # launches: K1, K2, K3 and K6 from the main path's run (phase 5), K7
    # from the coordinate-input path's (phase 6), the backward kernels from
    # the training driver's run (phase 9), D1-D5 from the gather tool's
    # sections (phase 10)
    counts.update({name: train_counts.get(name, 0) for name in BACKWARD_KERNELS})

    phase("gather microbenchmarks (D1-D5) on the card")
    gather_entries = gather_phase(device)

    phase(f"reconstruction path: {RECON_VIEWS}-view scan at {MAIN_W}x{MAIN_H}, .bin depth "
          f"maps, filter_and_fuse on the card")
    scene = tempfile.mkdtemp(prefix="smoke_recon_", dir=os.path.join(REPO, "build"))
    try:
        reconstruction_path(device, state_dict, scene, smi)
    finally:
        shutil.rmtree(scene, ignore_errors=True)

    phase("CLI path: python -m patchmatchnet_torch eval (DTU preset, 1600x1200, 1 + 5 views), "
          "train (B 8), and train + eval of a non-default configuration")
    scratch = tempfile.mkdtemp(prefix="smoke_cli_", dir=os.path.join(REPO, "build"))
    try:
        cli_path(device, scratch, smi)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        s = summary[name]
        bound_ms, bound_by = bound(s["bytes"], s["ops"])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts.get(name, 0), "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "timing": KERNEL_TIMING,
            "device_ms": s["device_ms"]})
    kernels += gather_entries
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
