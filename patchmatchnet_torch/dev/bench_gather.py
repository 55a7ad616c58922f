"""Gather microbenchmarks on the card: the port of `tools/dev/bench_gather.py`.

    python -m patchmatchnet_torch.dev.bench_gather [xla|lane|biglane|sublane|onehot|all]

The JAX tool chose, for the TPU, between gathering through device memory,
inside a VMEM block and by a one-hot matrix product. Its sections, at its
shapes, measure on the card:

- xla: K1's tap pattern, a row gather from a table of 15552 / 62208 / 248832
  rows x 256 / 128 / 64 channels (the three stage shapes) at indices
  jittered by +-300 rows, f32 and bf16: `torch.gather` (the library call),
  with the hand kernel `gather_rows` and its plain version beside it.
- lane (D1, D2), biglane (D3), sublane (D4): `gather_lanes` or
  `gather_sublanes`, its plain version and `torch.gather`.
- onehot (D5): `gather_rows`, its plain version, `torch.gather` on the index
  expanded to C4, and the literal one-hot product through `torch.bmm` with
  TF32 off: the TPU's strategy timed on this card, a yardstick and not the
  port of D5.

Every case checks that the kernel equals its plain version and
`torch.gather` in every element (a gather is exact) before it prints a
time, and raises RuntimeError on a difference. A time is the median of
REPS samples, each the CUDA-event time of BATCH calls in a row over BATCH;
the calls take ROTATION distinct index arrays in turn, drawn from a seeded
generator on the device. The kernel, the plain version and `torch.gather`
are timed in turns (half their samples each way round), so that none
always runs first. On the card each case also prints the device time of
the three, from a torch.profiler trace of 10 calls
(`utils.trace.device_ms`): the time the device was busy, without the time
it waits for the host. On the CPU, where the tests run the sections at
small shapes, the wrappers run their plain versions and the host clock
times single calls. The JAX tool's scan timing, 10 ms dispatch floor and
scalar chain are not carried over: they served the TPU's remote dispatch.

Each `bench_*` function returns one dict per case: "case", "kernel", the
median "ms" of the kernel, "plain_ms", "library_ms" (`torch.gather`),
"bytes" (the table and the index read once, the output written once) and
"max_abs_err" (0); on the card also "device_ms", "plain_device_ms" and
"library_device_ms" (None where no trace held every event).
`torch.gather` takes the int32 index arrays as they are.
"""

from __future__ import annotations

import itertools
import statistics
import sys
import time

import torch

from patchmatchnet_torch.ops import (
    gather_lanes,
    gather_lanes_reference,
    gather_rows,
    gather_rows_reference,
    gather_sublanes,
    gather_sublanes_reference,
)
from patchmatchnet_torch.utils.trace import CALLS, device_ms, fmt_ms

ROTATION = 4  # distinct index arrays per case
REPS = 20  # timed samples of each implementation per case
SEED = 0  # of the tables and index arrays
BATCH = 10  # calls per sample on the card
WARMUP = 3
JITTER = 300  # rows: the xla section's index jitter
# (name, table rows, channels, points) of K1's three stage shapes
XLA_CASES = (
    ("stage3-ish", 144 * 108, 256, 96 * 15552),
    ("stage2-ish", 288 * 216, 128, 32 * 62208),
    ("stage1-ish", 576 * 432, 64, 8 * 248832),
)
ONEHOT_CASES = ((128, 256), (256, 256), (128, 128), (128, 64))  # (KW, C4)


def _torch_gather_lanes(win, idx):
    return torch.gather(win, 2, idx)


def _torch_gather_sublanes(win, idx):
    return torch.gather(win, 1, idx)


def _torch_gather_rows(win, idx):
    return torch.gather(win, 1, idx[..., None].expand(*idx.shape, win.shape[2]))


def _samples_ms(fn, args, device: torch.device, reps: int):
    """`reps` times of one call of fn(a) in ms, a taken from `args` in turn.
    On the card each is the CUDA-event time of BATCH calls in a row, over
    BATCH, so that the host's work for the next call overlaps the card's
    work on this one (one call between two events would also time the
    wrapper's host work while the card waits); on the CPU, the host clock
    of one call."""
    for i in range(WARMUP):
        fn(args[i % len(args)])
    times = []
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        stream.synchronize()
        for r in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for k in range(BATCH):
                fn(args[(r * BATCH + k) % len(args)])
            end.record(stream)
            end.synchronize()
            times.append(start.elapsed_time(end) / BATCH)
    else:
        for r in range(reps):
            t0 = time.perf_counter()
            fn(args[r % len(args)])
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def _time_in_turns(impls, device: torch.device):
    """{name: (fn, args)} -> {name: median ms}: REPS // 2 samples of each
    in the order a, b, c, then as many in the order c, b, a, so that none
    always runs first."""
    samples = {name: [] for name in impls}
    for name in list(impls) + list(impls)[::-1]:
        fn, args = impls[name]
        samples[name] += _samples_ms(fn, args, device, REPS // 2)
    return {name: statistics.median(times) for name, times in samples.items()}


def _device_ms(fn, args):
    """Device time of one call of fn(a) on the card, a taken from `args` in
    turn (`utils.trace.device_ms`)."""
    turn = itertools.cycle(args)
    return device_ms(lambda: fn(next(turn)))


def _header(title: str, device: torch.device) -> None:
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (plain versions, host clock)")
    print(f"== {title} on {where}", flush=True)


def _line(impl: str, ms: float, count: int, unit: str, out_bytes: int, note: str = "") -> None:
    print(f"  {impl:<13} {ms:9.4f} ms = {ms * 1e6 / count:.4f} ns/{unit}, "
          f"{out_bytes / ms / 1e6:.0f} GB/s out{note}", flush=True)


def _run_case(label, kernel_name, kernel, plain, library, win, idxs, device, unit):
    """Check the kernel against its plain version and `torch.gather` on the
    first index array, then time the three, print a line each and, on the
    card, a line of their device times."""
    got = kernel(win, idxs[0])
    want = plain(win, idxs[0])
    for name, other in (("plain version", want), ("torch.gather", library(win, idxs[0]))):
        if other.shape != got.shape or other.dtype != got.dtype:
            raise RuntimeError(f"{label}: {kernel_name} gives {got.dtype} {tuple(got.shape)}, "
                               f"its {name} {other.dtype} {tuple(other.shape)}")
        if not torch.equal(got, other):
            bad = int((got != other).sum())
            raise RuntimeError(f"{label}: {kernel_name} differs from its {name} in {bad} of "
                               f"{got.numel()} elements")
    max_abs_err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    work_bytes = sum(t.numel() * t.element_size() for t in (win, idxs[0], got))
    count = idxs[0].numel()  # indices, points or gathered elements
    out_bytes = got.numel() * got.element_size()
    del got, want
    impls = {"kernel": (lambda i: kernel(win, i), idxs),
             "plain": (lambda i: plain(win, i), idxs),
             "library": (lambda i: library(win, i), idxs)}
    times = _time_in_turns(impls, device)
    print(f"  {label}", flush=True)
    _line(kernel_name, times["kernel"], count, unit, out_bytes)
    _line("plain", times["plain"], count, unit, out_bytes)
    _line("torch.gather", times["library"], count, unit, out_bytes)
    result = {"case": label, "kernel": kernel_name, "ms": times["kernel"],
              "plain_ms": times["plain"], "library_ms": times["library"],
              "bytes": work_bytes, "max_abs_err": max_abs_err}
    if device.type == "cuda":
        dev = {name: _device_ms(fn, args) for name, (fn, args) in impls.items()}
        print(f"  device time (profiler trace of {CALLS} calls): {kernel_name} "
              f"{fmt_ms(dev['kernel'])}, plain {fmt_ms(dev['plain'])}, "
              f"torch.gather {fmt_ms(dev['library'])}", flush=True)
        result.update(device_ms=dev["kernel"], plain_device_ms=dev["plain"],
                      library_device_ms=dev["library"])
    return result


def bench_xla_gather(device="cuda", cases=XLA_CASES):
    """The JAX tool's `xla` section: K1's tap pattern at the stage shapes,
    `torch.gather` and `gather_rows`, f32 and bf16 payloads."""
    device = torch.device(device)
    _header("xla: row gather at K1's tap pattern (indices jittered by +-300 rows)", device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    results = []
    for name, hw, c4, npts in cases:
        base = torch.arange(npts, device=device) % hw
        idxs = [(base + torch.randint(-JITTER, JITTER, (npts,), generator=gen, device=device))
                .clamp_(0, hw - 1).to(torch.int32)[None] for _ in range(ROTATION)]
        for dtype in (torch.float32, torch.bfloat16):
            table = torch.rand((1, hw, c4), generator=gen, device=device).to(dtype)
            label = (f"{name} {str(dtype).split('.')[-1]}: {npts / 1e6:.1f}M idx, "
                     f"payload {c4}el, table {hw} rows")
            results.append(_run_case(label, "gather_rows", gather_rows, gather_rows_reference,
                                     _torch_gather_rows, table, idxs, device, "idx"))
    return results


def _block_gather(title, kernel_name, kernel, plain, library, shape, index_size, device):
    device = torch.device(device)
    _header(title, device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    win = torch.rand(shape, generator=gen, device=device)
    idxs = [torch.randint(0, index_size, shape, generator=gen, device=device, dtype=torch.int32)
            for _ in range(ROTATION)]
    n = win.numel()
    label = f"{list(shape)} f32: {n / 1e6:.1f}M gathered elements"
    return [_run_case(label, kernel_name, kernel, plain, library, win, idxs, device, "el")]


def bench_lane_gather(device="cuda", n=8192, c=32, l=128):
    """D1 and D2: take_along_axis along the lanes of [C, L] blocks. The JAX
    D1 (8 blocks per grid step) writes only the first block of each 8 and
    D2 (1 block) all of them; both were meant to compute the full gather,
    which is what `gather_lanes` computes, so on the card they are one case."""
    return _block_gather(f"lane (D1, D2): take_along_axis along lanes of [{c},{l}] blocks",
                         "gather_lanes", gather_lanes, gather_lanes_reference,
                         _torch_gather_lanes, (n, c, l), l, device)


def bench_big_lane_gather(device="cuda", n=2048, c=256, l=128):
    """D3: take_along_axis along the lanes of [256, 128] blocks."""
    return _block_gather(f"biglane (D3): take_along_axis along lanes of [{c},{l}] blocks",
                         "gather_lanes", gather_lanes, gather_lanes_reference,
                         _torch_gather_lanes, (n, c, l), l, device)


def bench_sublane_gather(device="cuda", n=8192, s=8, l=128):
    """D4: take_along_axis along axis 0 (sublanes) of [8, 128] blocks."""
    return _block_gather(f"sublane (D4): take_along_axis along axis 0 of [{s},{l}] blocks",
                         "gather_sublanes", gather_sublanes, gather_sublanes_reference,
                         _torch_gather_sublanes, (n, s, l), s, device)


def bench_onehot_gather(device="cuda", cases=ONEHOT_CASES, n=512, p=1024):
    """D5: the row gather out[n,p,:] = win[n, idx[n,p], :] that the TPU
    computes as a one-hot [P, KW] x [KW, C4] product; `gather_rows` beside
    that product through `torch.bmm` (f32, TF32 off) on precomputed one-hot
    matrices."""
    device = torch.device(device)
    _header("onehot (D5): row gather out[n,p,:] = win[n, idx[n,p], :], "
            f"{n} blocks of {p} points", device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    results = []
    for kw, c4 in cases:
        win = torch.rand((n, kw, c4), generator=gen, device=device)
        idxs = [torch.randint(0, kw, (n, p), generator=gen, device=device, dtype=torch.int32)
                for _ in range(ROTATION)]
        label = f"K={kw} C4={c4}: {n * p / 1e6:.2f}M pts"
        result = _run_case(label, "gather_rows", gather_rows, gather_rows_reference,
                           _torch_gather_rows, win, idxs, device, "pt")
        onehots = [(torch.arange(kw, device=device) == i[..., None]).float() for i in idxs]
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            diff = float((torch.bmm(onehots[0], win) - gather_rows_reference(win, idxs[0]))
                         .abs().max())
            bmm_ms = statistics.median(
                _samples_ms(lambda oh: torch.bmm(oh, win), onehots, device, REPS))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        del onehots
        _line("one-hot bmm", bmm_ms, n * p, "pt", n * p * c4 * 4,
              f", {n * p * kw * c4 * 2 / bmm_ms / 1e9:.1f} TFLOP/s (max |bmm - gather| {diff:.1e})")
        result["bmm_ms"] = bmm_ms
        results.append(result)
    return results


SECTIONS = {
    "xla": bench_xla_gather,
    "lane": bench_lane_gather,
    "biglane": bench_big_lane_gather,
    "sublane": bench_sublane_gather,
    "onehot": bench_onehot_gather,
}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    which = args[0] if args else "all"
    if len(args) > 1 or (which != "all" and which not in SECTIONS):
        print(f"usage: python -m patchmatchnet_torch.dev.bench_gather "
              f"[{'|'.join(SECTIONS)}|all]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench_gather: needs a CUDA device", file=sys.stderr)
        return 1
    for name, bench in SECTIONS.items():
        if which in ("all", name):
            bench()
    return 0


if __name__ == "__main__":
    sys.exit(main())
