#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`patchmatchnet_torch`) on one GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases, each
reported on its own lines; any failure exits non-zero without the final
result line:

1. device: a CUDA device is required; prints `nvidia-smi` name/power limit.
2. build: compiles `patchmatchnet_torch/csrc/*.cu` with nvcc (sm_90a).
3. kernel parity: K1, K2 and K3 against their plain PyTorch versions on
   the card, at the main path's stage shapes, with bf16 and f32 payloads;
   kernel and plain times (median of CUDA-event timings).
4. f32 golden parity: the f32 model (kernels on, TF32 off) against the
   captured reference outputs in tests/golden/.
5. main path: a 1152x864, 5-view synthetic scene through MVSDataset ->
   bf16 DepthEstimator -> save_depth_maps; checks finite maps, the GT
   error and the per-request kernel launch counts; reports ms per map,
   MPix/s and peak device memory.

The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON summary.
"""

from __future__ import annotations

import json
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
# per-forward launches of each kernel on the bf16 main path
EXPECTED_PER_FORWARD = {"warp_group_corr": 20, "eval_grid_score": 5, "neighbor_group_corr": 3}
KERNEL_INFO = {
    "warp_group_corr": ("patchmatchnet_torch/csrc/group_corr.cu",
                        "patchmatchnet_tpu/ops/pallas/windowed_similarity.py:419"),
    "eval_grid_score": ("patchmatchnet_torch/csrc/eval_tail.cu",
                        "patchmatchnet_tpu/ops/pallas/eval_tail.py:112"),
    "neighbor_group_corr": ("patchmatchnet_torch/csrc/group_corr.cu",
                            "patchmatchnet_tpu/ops/pallas/similarity_kernel.py:88"),
}
# Kernel vs plain version: the same f32 math in another summation order.
# K1/K3: the plain version goes through F.grid_sample's normalized
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


def stage_cameras(h: int, w: int, scale: float):
    """Reference and source projections [1, 2, 4, 4] of the synthetic-scene
    rig (identity rotations, x baseline 0.35) at 1/scale of the main
    resolution."""
    import torch

    f = 1.1 * max(MAIN_H, MAIN_W) / scale
    k = torch.tensor([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]])
    projs = []
    for tx in (0.0, 0.35):
        p = torch.eye(4)
        p[:3, :4] = k @ torch.tensor([[1.0, 0, 0, tx], [0, 1, 0, 0], [0, 0, 1, 0]])
        projs.append(p)
    return torch.stack(projs)[None]


def kernel_parity(device):
    """Phase 3: returns {kernel: {"max_abs_err", "ms", "plain_ms"}} with times
    summed over the kernel's per-forward launches (bf16 payloads)."""
    import torch

    from patchmatchnet_torch import ops
    from patchmatchnet_torch.models.patchmatch import (
        STAGE_CONFIG,
        build_offset_grid,
        evaluation_offsets,
    )
    from patchmatchnet_torch.ops.warp import warp_proj_coeffs

    gen = torch.Generator(device=device).manual_seed(0)
    # (stage, C, G, [(D, launches per forward of K1)], K2 depth counts)
    stages = [
        (3, 64, 8, 8, [(64, 4), (32, 4)]),
        (2, 32, 8, 4, [(16, 8)]),
        (1, 16, 4, 2, [(8, 4)]),
    ]
    summary = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for name in KERNEL_INFO}

    def record(name, label, got, want, launches, fn, plain_fn, interval):
        err = (got - want).abs()
        max_abs, mean_abs = err.max().item(), err.mean().item()
        tol_max, tol_mean = parity_tol(name, interval)
        ok = max_abs <= tol_max and mean_abs <= tol_mean
        line = f"{name} {label}: max_abs {max_abs:.3e} mean_abs {mean_abs:.3e}"
        s = summary[name]
        s["max_abs_err"] = max(s["max_abs_err"], max_abs)
        if fn is not None:
            ms, plain_ms = time_ms(fn), time_ms(plain_fn)
            s["ms"] += ms * launches
            s["plain_ms"] += plain_ms * launches
            line += f" | kernel {ms:.4f} ms plain {plain_ms:.4f} ms (x{launches}/forward)"
        print(line, flush=True)
        if not ok:
            fail(f"{name} {label} exceeds max {tol_max} / mean {tol_mean}")

    for stage, c, g, scale, k1_depths in stages:
        h, w = MAIN_H // scale, MAIN_W // scale
        cfg = STAGE_CONFIG[stage]
        projs = stage_cameras(h, w, scale).to(device)
        mat12 = warp_proj_coeffs(projs[:, 1], projs[:, 0]).contiguous()
        offset = torch.randn((1, h, w, 18), generator=gen, device=device) * 2.0
        grid = build_offset_grid(offset, evaluation_offsets(cfg.propagation_range), h, w)
        feats = torch.randn((2, 1, h, w, c), generator=gen, device=device)
        fw = torch.rand((1, 9, h, w), generator=gen, device=device) * 0.9 + 0.1
        for dtype in (torch.bfloat16, torch.float32):
            timed = dtype == torch.bfloat16
            tag = "bf16" if timed else "f32"
            ref, src = feats[0].to(dtype), feats[1].to(dtype)
            for d, launches in k1_depths:
                depth = 4.8 + 3.0 * torch.rand((1, d, h, w), generator=gen, device=device)
                depth[:, -1, :4] = -1.0  # behind the source camera: pz <= 1e-3
                args = (src, mat12, depth, ref, g)
                record("warp_group_corr", f"stage{stage} C{c} G{g} D{d} {h}x{w} {tag}",
                       ops.warp_group_corr(*args), ops.warp_group_corr_reference(*args),
                       launches, (lambda: ops.warp_group_corr(*args)) if timed else None,
                       lambda: ops.warp_group_corr_reference(*args), cfg.interval_scale)
            args = (ref, grid, g)
            record("neighbor_group_corr", f"stage{stage} C{c} G{g} K9 {h}x{w} {tag}",
                   ops.neighbor_group_corr(*args), ops.neighbor_group_corr_reference(*args),
                   1, (lambda: ops.neighbor_group_corr(*args)) if timed else None,
                   lambda: ops.neighbor_group_corr_reference(*args), cfg.interval_scale)
            for d, launches in k1_depths:
                x_norm = torch.rand((1, h, w, d), generator=gen, device=device)
                cost = (torch.randn((1, h, w, d), generator=gen, device=device)).to(dtype)
                args = (x_norm, cost, grid, fw, cfg.interval_scale)
                record("eval_grid_score", f"stage{stage} D{d} {h}x{w} cost {tag}",
                       ops.eval_grid_score(*args), ops.eval_grid_score_reference(*args),
                       launches // 4, (lambda: ops.eval_grid_score(*args)) if timed else None,
                       lambda: ops.eval_grid_score_reference(*args), cfg.interval_scale)
    return summary


def golden_parity(device, model_f32):
    """Phase 4: the f32 model on the card against the captured goldens, at
    the bounds of tests/test_model_golden.py."""
    import numpy as np
    import torch

    for name, conf_max in (("forward_96x128", 0.25), ("forward_288x400_n5_dtu", None)):
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
        for stage, it in ((3, 0), (3, 1), (2, 0), (2, 1), (1, 0), (0, 0)):
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


def main_path(device, state_dict):
    """Phase 5: returns the launch counts of the timed requests."""
    import numpy as np
    import torch

    from patchmatchnet_torch.data import (
        PLANE_Z,
        BatchLoader,
        MVSDataset,
        make_synthetic_scene,
        read_pfm,
    )
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

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="smoke_scene_", dir=os.path.join(REPO, "build"))
    try:
        make_synthetic_scene(scratch, num_views=MAIN_VIEWS, height=MAIN_H, width=MAIN_W,
                             texture_scale=8.0)
        dataset = MVSDataset(scratch, num_views=MAIN_VIEWS - 1, image_extension=".png")
        if len(dataset) < REQUESTS:
            fail(f"scene has {len(dataset)} samples, need {REQUESTS}")
        loader = BatchLoader(dataset, batch_size=1)  # default prefetching loader
        # warm-up request: cuDNN algorithm selection, allocator growth
        warm = next(iter(BatchLoader(dataset, batch_size=1, num_threads=1)))
        estimator(warm, torch.Generator(device=device).manual_seed(123))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        timed = Timed(estimator)
        out_dir = os.path.join(scratch, "out")
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
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

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
    if max(errs) > 0.05 * PLANE_Z:
        fail(f"median depth error {max(errs):.4f} above 5% of the plane depth")
    return counts


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
    from patchmatchnet_torch.models import PatchmatchNet

    state_dict = state_dict_from_jax(read_flax_msgpack(CKPT))
    model_f32 = PatchmatchNet().to(device).eval()
    model_f32.load_state_dict(state_dict, strict=True)
    golden_parity(device, model_f32)
    del model_f32

    phase(f"main path: bf16 DepthEstimator, {MAIN_W}x{MAIN_H}, {MAIN_VIEWS} views, "
          f"{REQUESTS} requests")
    counts = main_path(device, state_dict)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": counts.get(name, 0), "max_abs_err": summary[name]["max_abs_err"],
         "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"]}
        for name, (src, replaces) in KERNEL_INFO.items()
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
