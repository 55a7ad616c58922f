"""Benchmark of the port: depth-map inference throughput (MPix/s per card).

    python -m patchmatchnet_torch.bench [--verbose] [--f32] [--train] [--device cuda|cpu]

The port's counterpart of the repository's root `bench.py`, with its flags,
defaults, inputs, timing and JSON record. It runs the released
PatchmatchNet (`checkpoints/params_000007.msgpack`, converted by
`compat.state_dict_from_jax`) at the DTU evaluation configuration (1152x864,
N=5 views: 1 reference + 4 sources, batch 1), bf16 payloads by default, on
inputs already on the device, and prints ONE JSON line:

    {"metric": "...", "value": N, "unit": "MPix/s", "vs_baseline": N, ...}

Baseline: the PatchmatchNet paper reports ~0.25 s per 1152x864 depth map
with its PyTorch implementation on an NVIDIA RTX 2080 / V100-class GPU
(~3.98 MPix/s), a published GPU figure; `vs_baseline` is the measured
throughput over it.

The forward metric is not `DepthEstimator` ms per map: its inputs are on
the card before the clock starts, the noise of every call is staged with
them, and the throughput enqueues `--iters` forwards before one
synchronize, so no host pre/post-processing or copy is timed.

Timing, as the root bench.py: one untimed first call (`compile` in the
`--verbose` output: cuDNN's plans and the first allocations; the nvcc
build of the kernels, `cuda_build.build_seconds()`, is reported apart);
`--warmup` calls; the latency, the median of `--iters` calls each followed
by a synchronize; the throughput, `--iters` calls enqueued then one
`torch.cuda.synchronize()`, its elapsed time held to at least half the
latency times `--iters`; MPix/s = H * W / 1e6 / (elapsed / (iters * batch)).
Every call gets its own noise, `default_rng(100 + s)` for call s.

Side metrics on the same line, each behind the `BENCH_DEADLINE_S` guard
(default 780 s since the process started; a section past it is recorded as
`*_skipped`) and each recording its exception as `*_error` (the first 200
characters) instead of failing the line:
- `tanks_1056x1920_n7_mpix_s`: the same forward at the Tanks and Temples
  evaluation geometry (1056x1920, N=7), 6 iterations after 1 warm-up;
- `train_samples_per_s` and `train_precision`: the train step at 640x512,
  N=5, B=2, 4 steps after 1 warm-up (`--train` prints the train line alone).

The train side is `train.loop.train_step` with `make_optimizer(params,
1e-3)` on a batch of `build_inputs` with depth_gt drawn as
`default_rng(0).random * 510 + 425` and a mask of ones; the bf16 mixed
precision trainer by default, f32 with `--train-f32`. Its weights are the
model's default initialization drawn under `torch.manual_seed(0)` inside
`torch.random.fork_rng` (the caller's generator is left as it was); each
step's noise comes from one `torch.Generator` seeded with 2 on the device. A
step ends when its loss is read as a host float.

Left out on purpose:
- `--no-derive-windows` and `--no-diagnostics`: they steer the JAX
  package's windowed sampler and its escape guard, which the port does not
  have (its warp kernel reads the source features directly, so no sample
  can leave a window);
- the train record's `vs_baseline` and the side key `train_vs_round1`:
  their denominator, 1.64 samples/s, is a figure of the JAX trainer on a
  TPU, not a baseline of this port;
- the JAX compile cache.

`--device` is `cuda` by default and raises when `torch.cuda.is_available()`
is false; `--device cpu` runs the kernels' plain versions (for the tests).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import sys
import time
import traceback
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from patchmatchnet_torch.compat import read_flax_msgpack, state_dict_from_jax
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.ops import cuda_build
from patchmatchnet_torch.train.loop import batch_to_device, make_optimizer, train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "checkpoints", "params_000007.msgpack")
# the paper's ~0.25 s per 1152x864 map on an RTX 2080 / V100-class GPU
BASELINE_MPIX_S = 1152 * 864 / 1e6 / 0.25  # ~3.98 MPix/s, a published GPU figure
TRAIN_LR = 1e-3

_PROCESS_START = time.monotonic()


def build_inputs(batch, num_views, height, width, seed=0):
    """(images [B, N, H, W, 3], intrinsics [B, N, 3, 3], extrinsics
    [B, N, 4, 4], depth_min [B], depth_max [B], noise [B, 48, H/8, W/8]) as
    numpy f32: random images, a rig rotated 0.06 rad and shifted 0.5 per
    view about its middle, depth 425-935. The root bench.py's inputs to
    the bit."""
    rng = np.random.default_rng(seed)
    images = rng.random((batch, num_views, height, width, 3)).astype(np.float32)
    f = 1.2 * max(height, width)
    k = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)
    intrinsics = np.broadcast_to(k, (batch, num_views, 3, 3)).copy()
    extrinsics = np.broadcast_to(
        np.eye(4, dtype=np.float32), (batch, num_views, 4, 4)
    ).copy()
    for v in range(num_views):
        angle = 0.06 * (v - (num_views - 1) / 2)
        c, s = np.cos(angle), np.sin(angle)
        extrinsics[:, v, :3, :3] = np.array(
            [[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32
        )
        extrinsics[:, v, 0, 3] = 0.5 * (v - (num_views - 1) / 2)
    depth_min = np.full(batch, 425.0, np.float32)
    depth_max = np.full(batch, 935.0, np.float32)
    noise = rng.random(PatchmatchNet.noise_shape(batch, height, width)).astype(np.float32)
    return images, intrinsics, extrinsics, depth_min, depth_max, noise


def call_noises(count: int, shape: Sequence[int]) -> np.ndarray:
    """The stacked noise of `count` timed or warm-up calls, [count, *shape]:
    call s draws `default_rng(100 + s)`, as the root bench.py."""
    return np.stack([np.random.default_rng(100 + s).random(tuple(shape), np.float32)
                     for s in range(count)])


def resolve_device(name: str) -> torch.device:
    """`name` as a torch device; raises for CUDA when there is none (no
    fallback to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: torch.cuda.is_available() is false; "
                           "pass --device cpu for the kernels' plain versions")
    return device


def load_model(bf16: bool, device: torch.device) -> PatchmatchNet:
    """The released model in inference mode on `device`, bf16 payloads or
    f32."""
    model = PatchmatchNet(compute_dtype=torch.bfloat16 if bf16 else None)
    model.load_state_dict(state_dict_from_jax(read_flax_msgpack(CHECKPOINT)), strict=True)
    return model.to(device).eval()


def forward(model: PatchmatchNet, inputs: Sequence[torch.Tensor], noise: torch.Tensor):
    """One inference forward on device tensors (images, intrinsics,
    extrinsics, depth_min, depth_max) with the stage-3 noise: the model's
    (depth, confidence, {stage: [depths]})."""
    with torch.inference_mode():
        return model(*inputs, init_noise=noise)


def synchronize(device: torch.device) -> None:
    """Wait for `device`'s queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def bench_forward(args, model: PatchmatchNet) -> float:
    """Timed forward at args' geometry on args.device; returns MPix/s."""
    device = resolve_device(args.device)
    arrays = build_inputs(args.batch, args.num_views, args.height, args.width)
    inputs = [torch.from_numpy(a).to(device) for a in arrays[:5]]
    noise0 = torch.from_numpy(arrays[5]).to(device)
    noises = torch.from_numpy(call_noises(args.warmup + args.iters,
                                          arrays[5].shape)).to(device)
    synchronize(device)

    t_compile = time.perf_counter()
    forward(model, inputs, noise0)
    synchronize(device)
    compile_s = time.perf_counter() - t_compile

    for i in range(args.warmup):
        forward(model, inputs, noises[i])
    synchronize(device)

    # latency: median of individually synchronized calls
    times = []
    for i in range(args.iters):
        start = time.perf_counter()
        forward(model, inputs, noises[args.warmup + i])
        synchronize(device)
        times.append(time.perf_counter() - start)
    latency = statistics.median(times)

    # throughput: every call enqueued, one synchronize; each call's depth
    # and confidence are kept, as the root bench.py keeps its outputs
    start = time.perf_counter()
    outs = [forward(model, inputs, noises[args.warmup + i])[:2] for i in range(args.iters)]
    synchronize(device)
    elapsed = time.perf_counter() - start
    del outs
    geometry = f"{args.width}x{args.height} N={args.num_views} B={args.batch}"
    if args.verbose:
        _log(f"{geometry}: single-call latency median {latency * 1e3:.1f} ms; pipelined "
             f"{elapsed / args.iters * 1e3:.1f} ms/map")
    # the root bench.py's guard against a pipelined time that is not real
    elapsed = max(elapsed, 0.5 * latency * args.iters)

    per_map = elapsed / (args.iters * args.batch)
    mpix_s = args.height * args.width / 1e6 / per_map
    if args.verbose:
        _log(f"compile {compile_s:.1f}s; {per_map * 1e3:.1f} ms per "
             f"{args.width}x{args.height} depth map")
    return mpix_s


def seeded_model(compute_dtype: Optional[torch.dtype]) -> PatchmatchNet:
    """A PatchmatchNet of the default initialization drawn under
    `torch.manual_seed(0)`, leaving the caller's generator as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return PatchmatchNet(compute_dtype=compute_dtype)


def train_batch(batch: int, num_views: int, height: int, width: int) -> Dict[str, np.ndarray]:
    """The train side's batch: `build_inputs`, depth_gt from
    `default_rng(0)` in 425-935 and a mask of ones."""
    rng = np.random.default_rng(0)
    images, intrinsics, extrinsics, depth_min, depth_max, _ = build_inputs(
        batch, num_views, height, width)
    return {
        "images": images,
        "intrinsics": intrinsics,
        "extrinsics": extrinsics,
        "depth_min": depth_min,
        "depth_max": depth_max,
        "depth_gt": (rng.random((batch, height, width)) * 510 + 425).astype(np.float32),
        "mask": np.ones((batch, height, width), dtype=bool),
    }


def bench_train(args, emit: bool = True) -> float:
    """Train-step throughput (samples/s) at args' geometry (the DTU
    training configuration 640x512, N=5, B=2 by default); with `emit`,
    prints the train record."""
    device = resolve_device(args.device)
    b, n, h, w = args.batch, args.num_views, args.height, args.width
    tensors = batch_to_device(train_batch(b, n, h, w), device)
    f32 = args.train_f32
    model = seeded_model(None if f32 else torch.bfloat16).to(device)
    optimizer = make_optimizer(model.parameters(), TRAIN_LR)
    generator = torch.Generator(device=device).manual_seed(2)

    def step() -> float:
        noise = torch.rand(PatchmatchNet.noise_shape(b, h, w), generator=generator, device=device)
        metrics, _ = train_step(model, optimizer, tensors, TRAIN_LR, noise)
        return float(metrics["loss"])

    t_compile = time.perf_counter()
    step()
    compile_s = time.perf_counter() - t_compile
    for _ in range(args.warmup):
        step()
    start = time.perf_counter()
    for _ in range(args.iters):
        step()
    elapsed = time.perf_counter() - start
    per_step = elapsed / args.iters
    samples_s = b / per_step
    if args.verbose:
        _log(f"compile {compile_s:.1f}s; {per_step * 1e3:.1f} ms/step at {w}x{h} N={n} B={b} "
             f"({'f32' if f32 else 'bf16'} trainer)")
    if emit:
        print(json.dumps({
            "metric": f"train-step throughput, DTU config {w}x{h} N={n} B={b}",
            "value": samples_s,
            "unit": "samples/s",
        }), flush=True)
    return samples_s


def emit_side_metrics(args, model: PatchmatchNet, record: Dict[str, object]) -> None:
    """The Tanks geometry and the train step as extra keys of `record`,
    each behind the deadline guard and recording its exception."""
    deadline = float(os.environ.get("BENCH_DEADLINE_S", "780"))

    def over_deadline() -> bool:
        return time.monotonic() - _PROCESS_START > deadline

    if not args.no_tanks_metric:
        if over_deadline():
            record["tanks_skipped"] = "deadline"
        else:
            gargs = copy.copy(args)
            gargs.height, gargs.width, gargs.num_views = 1056, 1920, 7
            gargs.iters, gargs.warmup = 6, 1
            try:
                record["tanks_1056x1920_n7_mpix_s"] = bench_forward(gargs, model)
            except Exception as exc:  # the primary metric still prints
                traceback.print_exc()
                record["tanks_error"] = str(exc)[:200]

    if not args.no_train_metric and over_deadline():
        record["train_skipped"] = (
            f"deadline: {time.monotonic() - _PROCESS_START:.0f}s elapsed > {deadline:.0f}s")
        args.no_train_metric = True
    if not args.no_train_metric:
        targs = copy.copy(args)
        targs.height, targs.width, targs.batch = 512, 640, 2
        targs.iters, targs.warmup = 4, 1
        try:
            record["train_samples_per_s"] = bench_train(targs, emit=False)
            record["train_precision"] = "f32" if targs.train_f32 else "bf16"
        except Exception as exc:  # the primary metric still prints
            traceback.print_exc()
            record["train_error"] = str(exc)[:200]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m patchmatchnet_torch.bench")
    parser.add_argument("--height", type=int, default=864)
    parser.add_argument("--width", type=int, default=1152)
    parser.add_argument("--num-views", type=int, default=5)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--train", action="store_true",
                        help="benchmark the training step (defaults switch to 640x512 B=2)")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--no-train-metric", action="store_true",
                        help="skip the train-step throughput side metric in the JSON line")
    parser.add_argument("--no-tanks-metric", action="store_true",
                        help="skip the second-geometry (Tanks 1056x1920 N=7) side metric")
    parser.add_argument("--train-f32", action="store_true",
                        help="benchmark the f32 trainer instead of the default bf16 "
                        "mixed-precision trainer")
    parser.add_argument("--bf16", action="store_true", default=True,
                        help="bfloat16 payloads with f32 weights and accumulation (default)")
    parser.add_argument("--f32", dest="bf16", action="store_false",
                        help="full-f32 path (TF32 off)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default; raises without CUDA) or cpu "
                        "(the kernels' plain versions)")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.verbose:
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
        _log(f"device: {device} ({name}); torch {torch.__version__}")
    if device.type == "cuda":
        cuda_build.kernel_library()
        if args.verbose:
            built = cuda_build.build_seconds()
            _log("kernel library: " + (f"built in {built:.1f}s" if built is not None
                                       else "reused"))

    if args.train:
        if args.height == 864 and args.width == 1152:
            args.height, args.width = 512, 640
        if args.batch == 1:
            args.batch = 2
        bench_train(args)
    else:
        model = load_model(args.bf16, device)
        mpix_s = bench_forward(args, model)
        record: Dict[str, object] = {
            "metric": f"depth-map inference throughput, DTU config "
            f"{args.width}x{args.height} N={args.num_views}",
            "value": mpix_s,
            "unit": "MPix/s",
            "vs_baseline": mpix_s / BASELINE_MPIX_S,
        }
        emit_side_metrics(args, model, record)
        print(json.dumps(record), flush=True)
    if args.verbose and device.type == "cuda":
        _log(f"kernel launches: {cuda_build.launch_counts()}")

if __name__ == "__main__":
    main()
