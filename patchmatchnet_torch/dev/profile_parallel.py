"""Data parallel on the card(s): parity with one rank, throughput and the
collectives' cost.

    python -m patchmatchnet_torch.dev.profile_parallel [--ranks 1,2,4] [--share]
        [--steps N] [--out FILE]

For each rank count R (at most the cards present: R NCCL ranks on cuda:0
.. R-1; with --share, R gloo ranks sharing cuda:0), from the released
weights:

- train: the trainer's geometry (640x512, 1 + 4 views) on textured planes
  (`train_batch`: every second row's mask cut to its left half), 2 rows
  per rank, device-resident (no loading). An f32 step against the 1-rank
  step of the same global batch and noise in this process (loss, the whole
  gradient and the worst leaf cosine, running statistics), then bf16: a
  warm-up step, N timed steps (ms per step per rank; samples/s over the
  slowest rank's median), with one rank the plain `train_step` of an
  unwrapped model interleaved step by step (the cost of DDP and sync-BN),
  launches per step per rank, one traced step's all-reduces (count and
  host ms) beside its BatchNorm calls, and a device trace of 2 steps
  (device busy ms and NCCL kernel ms per step).
- eval: the bf16 estimator at 1152x864, 1 + 4 views, global batch R, over
  R copies of a DTU-sized 49-view scan (`eval_scans`: 49 references per
  rank); a warm-up pass over one global batch, then a timed pass. Per
  rank: the pass's seconds (loading, PFM writes and waits included) and
  the sum of its requests' ms (host arrays out: the card's work and the
  host's per request); maps/s over the slowest rank both ways. The maps
  are held against one rank's (share of pixels off by more than 1e-3 of
  the depth range).
- the command line, for R >= 2 NCCL ranks: `eval --num_devices R --device
  cuda` over a scene of 4R views writes one rank's maps, and `train
  --num_devices R` one epoch of it (`cli_num_devices`, `check_cli_run`).

Every line carries the card's name and power limit; the last line is a JSON
summary. `chip_smoke.py` phase 14 drives the same rank functions on one
card (two gloo ranks sharing it, one NCCL rank).
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from patchmatchnet_torch.data import (
    PLANE_Z,
    BatchLoader,
    MVSDataset,
    make_synthetic_scene,
    plane_batch,
    read_pfm,
    save_pair_file,
)
from patchmatchnet_torch.infer import DepthEstimator, save_depth_maps
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.models.layers import BatchNorm
from patchmatchnet_torch.ops import cuda_build
from patchmatchnet_torch.parallel import launch, replicate, shard_batch
from patchmatchnet_torch.train import batch_to_device, make_optimizer, train_step
from patchmatchnet_torch.train.driver import load_any_checkpoint
from patchmatchnet_torch.utils.profiling import reset_spans, span_records, trace_spans
from patchmatchnet_torch.utils.trace import busy_union_us, trace_device_events

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CKPT = os.path.join(REPO, "checkpoints", "params_000007.msgpack")
TRAIN_H, TRAIN_W, VIEWS = 512, 640, 5
EVAL_H, EVAL_W = 864, 1152
DTU_SCAN_VIEWS = 49  # a DTU scan's views, each a reference
ROWS_PER_RANK = 2
# the synthetic scene's depth range is (0.8, 1.3) x the plane's depth
DEPTH_RANGE = (1.3 - 0.8) * PLANE_Z
CLI_TIMEOUT = 600  # seconds, each command line process
RANKS_TIMEOUT = 600  # seconds, each launch of ranks


def train_batch(rows: int):
    """A global training batch of `rows` textured planes at 640x512, 1 + 4
    views, every second row's mask cut to its left half (the ranks' mask
    counts differ)."""
    batch = plane_batch(rows, VIEWS, TRAIN_H, TRAIN_W)
    batch["mask"][1::2, :, :TRAIN_W // 2] = False
    return batch


def f32_step(model, net, tensors, noise, group=None):
    """One f32 step (lr 1e-3) of `net` (`model` or its replica): (loss,
    gradients, state dict after the step), on the host."""
    metrics, _ = train_step(net, make_optimizer(model.parameters(), 1e-3), tensors, 1e-3, noise,
                            with_grads=True, group=group)
    return (float(metrics["loss"]), {k: v.cpu() for k, v in metrics["grads"].items()},
            {k: v.detach().cpu() for k, v in model.state_dict().items()})


def plain_f32_step(rows: int, device: torch.device):
    """The 1-rank f32 step of `train_batch(rows)` on `device`."""
    batch = train_batch(rows)
    model = PatchmatchNet().to(device)
    model.load_state_dict(load_any_checkpoint(CKPT), strict=True)
    return f32_step(model, model, batch_to_device(batch, device),
                    torch.from_numpy(batch["noise"]).to(device))


def train_rank(group, rows: int, timed_steps: int) -> Dict:
    """One rank of a data-parallel run over `train_batch(rows)`: its f32
    step, then (with `timed_steps`) bf16 steps: a warm-up, `timed_steps`
    timed (ms, losses, launches; with one rank, each followed by a timed
    plain step of an unwrapped model), one traced for its all-reduces (host
    events of the backend, count and ms) beside the BatchNorm calls, and a
    device trace of 2 (busy and NCCL kernel ms per step)."""
    local = shard_batch(train_batch(rows), group)
    tensors = batch_to_device(local, group.device)
    noise = torch.from_numpy(local["noise"]).to(group.device)
    model = PatchmatchNet().to(group.device)
    model.load_state_dict(load_any_checkpoint(CKPT), strict=True)
    out = {"f32": f32_step(model, replicate(model, group), tensors, noise,
                           group.process_group)}
    if not timed_steps:
        return out
    model = PatchmatchNet(compute_dtype=torch.bfloat16).to(group.device)
    model.load_state_dict(load_any_checkpoint(CKPT), strict=True)
    optimizer = make_optimizer(model.parameters(), 1e-3)
    net = replicate(model, group)

    def step():
        metrics, _ = train_step(net, optimizer, tensors, 1e-3, noise, group=group.process_group)
        return float(metrics["loss"])  # waits for the step

    plain_step = None
    if group.world_size == 1:
        plain = PatchmatchNet(compute_dtype=torch.bfloat16).to(group.device)
        plain.load_state_dict(load_any_checkpoint(CKPT), strict=True)
        plain_optimizer = make_optimizer(plain.parameters(), 1e-3)

        def plain_step():
            metrics, _ = train_step(plain, plain_optimizer, tensors, 1e-3, noise)
            return float(metrics["loss"])

        plain_step()
    step()  # warm-up: cuDNN algorithm selection, allocator growth
    ms, plain_ms, losses, counts = [], [], [], collections.Counter()
    for _ in range(timed_steps):
        cuda_build.reset_launch_counts()
        start = time.perf_counter()
        losses.append(step())
        ms.append((time.perf_counter() - start) * 1e3)
        counts.update(cuda_build.launch_counts())
        if plain_step is not None:
            start = time.perf_counter()
            plain_step()
            plain_ms.append((time.perf_counter() - start) * 1e3)
    bn_calls = []
    hooks = [m.register_forward_hook(lambda *_: bn_calls.append(1))
             for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
    for hook in hooks:
        hook.remove()
    collectives = {e.key: (e.count, e.cpu_time_total / 1e3) for e in prof.key_averages()
                   if e.key.startswith(("gloo:", "nccl:"))}
    host_ops = {"synced": host_self_ms(prof)}
    if plain_step is not None:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            plain_step()
        host_ops["plain"] = host_self_ms(prof)
    with tempfile.TemporaryDirectory(prefix="profile_parallel_trace_") as folder:
        events = trace_device_events(step, 2, os.path.join(folder, f"rank{group.rank}.json"))
    device = {"busy_ms": busy_union_us((t, t + d) for _, _, t, d in events) / 2e3,
              "nccl_ms": sum(d for _, name, _, d in events if "nccl" in name.lower()) / 2e3,
              "events": len(events) / 2}
    out.update(ms=ms, plain_ms=plain_ms, losses=losses, counts=dict(counts),
               collectives=collectives, bn_calls=len(bn_calls), device=device, host_ops=host_ops)
    return out


def host_self_ms(prof) -> Dict[str, tuple]:
    """{op: (calls, host self ms)} of a CPU trace of one step."""
    return {e.key: (e.count, e.self_cpu_time_total / 1e3) for e in prof.key_averages()}


def host_excess(synced: Dict[str, tuple], plain: Dict[str, tuple], top: int = 12) -> str:
    """The host ops whose self time the synced step has most beyond the
    plain step's, and both steps' summed self time."""
    excess = sorted(synced, key=lambda k: plain.get(k, (0, 0.0))[1] - synced[k][1])[:top]
    return (f"host self ms in ops, synced {sum(v[1] for v in synced.values()):.2f} / plain "
            f"{sum(v[1] for v in plain.values()):.2f}; most beyond the plain step (calls, ms "
            "synced / plain): " + ", ".join(
                f"{k} {synced[k][0]} {synced[k][1]:.2f} / {plain.get(k, (0, 0.0))[0]} "
                f"{plain.get(k, (0, 0.0))[1]:.2f}" for k in excess))


def eval_scene(root: str, views: int) -> None:
    """A `views`-view synthetic scene at 1152x864 whose pair file gives each
    view its 4 nearest sources."""
    make_synthetic_scene(root, num_views=views, height=EVAL_H, width=EVAL_W, texture_scale=8.0)
    save_pair_file(os.path.join(root, "pair.txt"), [
        (v, [(s, 10.0 - abs(s - v)) for s in sorted(
            (s for s in range(views) if s != v), key=lambda s: (abs(s - v), s))[:VIEWS - 1]])
        for v in range(views)])


def eval_scans(root: str, scans: int) -> str:
    """`scans` copies (links) of one DTU-sized scan under `root` (made by
    the first call), and the path of their scan list."""
    if not os.path.isdir(os.path.join(root, "scan")):
        eval_scene(os.path.join(root, "scan"), DTU_SCAN_VIEWS)
    for i in range(scans):
        if not os.path.islink(os.path.join(root, f"scan{i}")):
            os.symlink("scan", os.path.join(root, f"scan{i}"))
    scan_list = os.path.join(root, f"scans{scans}.txt")
    with open(scan_list, "w") as f:
        f.write("".join(f"scan{i}\n" for i in range(scans)))
    return scan_list


def eval_rank(group, scene: str, out_root: str, batch_size: int, refs_list,
              warm_up: bool = False, scan_list: str = "") -> Dict:
    """One rank of data-parallel eval: the bf16 estimator over its rows of
    every global batch of `batch_size`, for each reference count of
    `refs_list` (with `warm_up`, a pass of one global batch before), over
    `scene` or the scans of `scan_list` under it: {refs: (maps written,
    host ms per request (its `pmn.request` spans), launches, seconds)}."""
    model = PatchmatchNet(compute_dtype=torch.bfloat16)
    model.load_state_dict(load_any_checkpoint(CKPT), strict=True)
    estimator = DepthEstimator(model, group.device)
    runs = {}
    for refs in ([batch_size] if warm_up else []) + list(refs_list):
        dataset = MVSDataset(scene, VIEWS - 1, ".png", scan_list=scan_list)
        dataset.metas = dataset.metas[:refs]
        loader = BatchLoader(dataset, batch_size, shard=(group.rank, group.world_size))
        cuda_build.reset_launch_counts()
        previous = trace_spans(True)
        reset_spans()
        start = time.perf_counter()
        try:
            n = save_depth_maps(estimator, loader, os.path.join(out_root, f"refs{refs}"),
                                seed=0)
        finally:
            trace_spans(previous)
        seconds = time.perf_counter() - start
        request_ms = [r.host_ms for r in span_records("pmn.request")]
        runs[refs] = (n, request_ms, cuda_build.launch_counts(), seconds)
    return runs


def one_rank_maps(scene: str, out: str, batch_size: int, refs: int, device,
                  scan_list: str = "") -> None:
    """The 1-rank bf16 maps of the first `refs` references at `batch_size`
    (of `scene` or the scans of `scan_list` under it), written under `out`."""
    model = PatchmatchNet(compute_dtype=torch.bfloat16)
    model.load_state_dict(load_any_checkpoint(CKPT), strict=True)
    dataset = MVSDataset(scene, VIEWS - 1, ".png", scan_list=scan_list)
    dataset.metas = dataset.metas[:refs]
    save_depth_maps(DepthEstimator(model, device), BatchLoader(dataset, batch_size), out, seed=0)


def read_maps(root: str, view: int):
    return tuple(read_pfm(os.path.join(root, folder, f"{view:08d}.pfm"))[..., 0]
                 for folder in ("depth_est", "confidence"))


def map_difference(got, want) -> Dict[str, float]:
    """Depth and confidence differences of two (depth, confidence) maps:
    max and median |diff|, and the shares of pixels off by more than 1e-3
    of the depth range (depth) or 5e-3 (confidence)."""
    ddiff, cdiff = np.abs(got[0] - want[0]), np.abs(got[1] - want[1])
    return {"depth_max": float(ddiff.max()), "depth_median": float(np.median(ddiff)),
            "depth_share": float((ddiff > 1e-3 * DEPTH_RANGE).mean()),
            "conf_max": float(cdiff.max()), "conf_median": float(np.median(cdiff)),
            "conf_share": float((cdiff > 5e-3).mean())}


def relative_errors(got, want):
    """(loss, ||g - g_want|| / ||g_want|| over the whole gradient, worst
    cosine over the leaves above 1e-3 of the largest norm, worst running
    statistic max |diff| / max |want|) of two `f32_step` results."""
    loss = abs(got[0] - want[0]) / abs(want[0])
    grads, wgrads = got[1], want[1]
    num = sum(float((grads[k] - w).double().square().sum()) for k, w in wgrads.items())
    den = sum(float(w.double().square().sum()) for w in wgrads.values())
    top = max(float(w.norm()) for w in wgrads.values())

    def cosine(a, b):
        a, b = a.double().ravel(), b.double().ravel()
        return float(a @ b / (a.norm() * b.norm() + 1e-30))

    cos = min(cosine(grads[k], w) for k, w in wgrads.items() if float(w.norm()) >= 1e-3 * top)
    stats = max(float((got[2][k] - w).abs().max() / w.abs().max().clamp(min=1e-12))
                for k, w in want[2].items() if k.endswith(("running_mean", "running_var")))
    return loss, (num / den) ** 0.5, cos, stats


def bit_equal(got, want) -> bool:
    return (got[0] == want[0] and all(torch.equal(got[1][k], w) for k, w in want[1].items())
            and all(torch.equal(got[2][k], w) for k, w in want[2].items()))


def cli_num_devices(scene: str, out_root: str, num_devices: int,
                    batch_size: int) -> Dict[str, tuple]:
    """`python -m patchmatchnet_torch train|eval --num_devices N --device
    cuda` over `scene`, both processes at once (eval writes depth maps;
    train one epoch from the released weights at 640 px, one row per rank
    per step, summary every step): {command: (stdout, stderr, exit code,
    output folder)}."""
    common = ["--input_folder", scene, "--num_views", str(VIEWS - 1), "--image_extension",
              ".png", "--batch_size", str(batch_size), "--num_devices", str(num_devices),
              "--device", "cuda"]
    argv = {
        "train": ["train", "--train_list", "none", "--test_list", "none", "--image_max_dim",
                  str(TRAIN_W), "--epochs", "1", "--summary_freq", "1", "--checkpoint_path",
                  CKPT],
        "eval": ["eval", "--checkpoint_path", CKPT, "--output_type", "depth"],
    }
    procs = {}
    for cmd, args in argv.items():
        out = os.path.join(out_root, f"cli_{cmd}")
        procs[cmd] = (subprocess.Popen(
            [sys.executable, "-m", "patchmatchnet_torch", *args, *common, "--output_folder", out],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out)
    results = {}
    try:
        for cmd, (proc, out) in procs.items():
            stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT)
            results[cmd] = (stdout, stderr, proc.returncode, out)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def check_cli_run(results: Dict[str, tuple], one_rank_root: str, views: int,
                  steps: int) -> Dict[str, float]:
    """Raise unless both runs of `cli_num_devices` exited 0, train wrote its
    checkpoint set and a finite loss for each of its `steps` steps, and
    eval's maps of views 0..views-1 are within 0.1% of the pixels of
    `one_rank_root`'s. Returns the worst map difference."""
    for cmd, (stdout, stderr, rc, _) in results.items():
        if rc != 0:
            tail = "\n".join((stdout + stderr).splitlines()[-30:])
            raise RuntimeError(f"CLI {cmd} exited with {rc}:\n{tail}")
    out = results["train"][3]
    for name in ("params_000000.ckpt.pt", "module_000000.pt", "config.json", "metrics.jsonl"):
        if not os.path.isfile(os.path.join(out, name)):
            raise RuntimeError(f"CLI train wrote no {name}")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        losses = [r["loss"] for r in map(json.loads, f) if r["mode"] == "train"]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"CLI train logged the losses {losses}")
    worst = {}
    for view in range(views):
        diff = map_difference(read_maps(results["eval"][3], view),
                              read_maps(one_rank_root, view))
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in diff.items()}
    if worst["depth_share"] > 1e-3 or worst["conf_share"] > 1e-3:
        raise RuntimeError(f"CLI eval's maps differ from one rank's: {worst}")
    return worst


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", default="1,2,4",
                        help="rank counts, comma separated (each at most the cards present, "
                        "unless --share)")
    parser.add_argument("--share", action="store_true",
                        help="gloo ranks sharing cuda:0 in place of NCCL ranks on one card each")
    parser.add_argument("--steps", type=int, default=20, help="timed bf16 train steps")
    parser.add_argument("--out", default="", help="also write the JSON summary here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_parallel needs CUDA")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    cards = torch.cuda.device_count()
    print(f"cards: {cards} x {smi[0]}; torch {torch.__version__}", flush=True)
    ranks = [int(r) for r in args.ranks.split(",")]
    if not args.share and max(ranks) > cards:
        raise SystemExit(f"--ranks {args.ranks} needs {max(ranks)} cards; {cards} present")
    device = torch.device("cuda", 0)
    summary = {"card": smi[0], "cards": cards, "share": args.share, "runs": []}
    failures: List[str] = []
    scratch = tempfile.mkdtemp(prefix="profile_parallel_", dir=os.path.join(REPO, "build"))
    try:
        scene = os.path.join(scratch, "scene")  # the command line's
        scene_views = 4 * max(ranks)
        eval_scene(scene, scene_views)
        scans_root = os.path.join(scratch, "scans")
        for r in ranks:
            devices = [device] * r if args.share else [torch.device("cuda", i) for i in range(r)]
            backend = "gloo" if args.share else "nccl"
            label = f"{r} {backend} rank(s) on {', '.join(sorted({str(d) for d in devices}))}"
            rows = ROWS_PER_RANK * r
            want = plain_f32_step(rows, device)
            torch.cuda.empty_cache()
            start = time.perf_counter()
            results = [x.value for x in launch(train_rank, r, (rows, args.steps), devices=devices,
                                               backend=backend, timeout=RANKS_TIMEOUT)]
            launch_s = time.perf_counter() - start
            errors = relative_errors(results[0]["f32"], want)
            same_state = all(torch.equal(results[0]["f32"][2][k], x["f32"][2][k])
                             for x in results[1:] for k in results[0]["f32"][2])
            medians = [statistics.median(x["ms"]) for x in results]
            n_ar, ar_ms = max((v for k, v in results[0]["collectives"].items()
                               if k.endswith("all_reduce")), default=(0, 0.0))
            plain = (f"; plain steps interleaved (unwrapped model, no group) median "
                     f"{statistics.median(results[0]['plain_ms']):.2f} ms, "
                     + " ".join(f"{t:.2f}" for t in results[0]["plain_ms"]) + "; "
                     + host_excess(results[0]["host_ops"]["synced"],
                                   results[0]["host_ops"]["plain"])
                     if results[0]["plain_ms"] else "")
            print(f"train, {label}, global B {rows} ({smi[0]}): f32 vs 1 rank: loss rel "
                  f"{errors[0]:.3e}, gradient rel {errors[1]:.3e}, min cosine {errors[2]:.6f}, "
                  f"statistics rel {errors[3]:.3e}, bit-equal {bit_equal(results[0]['f32'], want)}"
                  f", ranks' state equal {same_state}; bf16, {args.steps} timed steps after a "
                  "warm-up, median ms per step per rank "
                  + " ".join(f"{m:.2f}" for m in medians) + "; ms per step per rank "
                  + "; ".join(" ".join(f"{t:.2f}" for t in x["ms"]) for x in results)
                  + f"{plain}; {rows * 1e3 / max(medians):.3f} samples/s; launches per step "
                  f"{ {k: v / args.steps for k, v in results[0]['counts'].items()} }; traced "
                  f"step: {n_ar} all-reduces, {ar_ms:.2f} host ms, {results[0]['bn_calls']} "
                  "BatchNorm calls; device trace per step per rank (busy ms, NCCL kernel ms) "
                  + "; ".join(f"{x['device']['busy_ms']:.2f} {x['device']['nccl_ms']:.2f}"
                              for x in results)
                  + f"; launch {launch_s:.1f} s", flush=True)

            refs = DTU_SCAN_VIEWS * r
            scan_list = eval_scans(scans_root, r)
            one = os.path.join(scratch, f"one_{r}")
            one_rank_maps(scans_root, one, r, refs, device, scan_list)
            torch.cuda.empty_cache()
            out = os.path.join(scratch, f"ranks_{r}")
            evals = [x.value[refs] for x in launch(eval_rank, r, (scans_root, out, r, [refs], True,
                                                                  scan_list),
                                                   devices=devices, backend=backend,
                                                   timeout=RANKS_TIMEOUT)]
            worst = {}
            for scan in range(r):
                for view in range(DTU_SCAN_VIEWS):
                    diff = map_difference(
                        read_maps(os.path.join(out, f"refs{refs}", f"scan{scan}"), view),
                        read_maps(os.path.join(one, f"scan{scan}"), view))
                    worst = {k: max(v, worst.get(k, 0.0)) for k, v in diff.items()}
            seconds = max(x[3] for x in evals)
            request_s = max(sum(x[1]) / 1e3 for x in evals)
            print(f"eval, {label}, global B {r}, {refs} maps at {EVAL_W}x{EVAL_H}, "
                  f"{DTU_SCAN_VIEWS} per rank, after a warm-up batch ({smi[0]}): "
                  f"{refs / seconds:.3f} maps/s over the slowest rank's pass ({seconds:.3f} s, "
                  f"loading, writes and waits included); {refs / request_s:.3f} maps/s over "
                  f"the slowest rank's requests alone ({request_s:.3f} s); median ms per request "
                  "per rank " + " ".join(f"{statistics.median(x[1]):.2f}" for x in evals)
                  + f"; worst map difference vs 1 rank {worst}", flush=True)
            run = {"ranks": r, "backend": backend, "train_errors": errors,
                   "state_equal": same_state, "step_ms": [x["ms"] for x in results],
                   "plain_step_ms": results[0]["plain_ms"],
                   "samples_per_s": rows * 1e3 / max(medians), "all_reduces": n_ar,
                   "all_reduce_ms": ar_ms, "bn_calls": results[0]["bn_calls"],
                   "device": [x["device"] for x in results], "maps": refs,
                   "eval_s": seconds, "maps_per_s": refs / seconds, "request_s": request_s,
                   "maps_per_request_s": refs / request_s,
                   "request_ms": [x[1] for x in evals], "map_difference": worst}
            if r >= 2 and not args.share:
                one = os.path.join(scratch, f"cli_one_{r}")
                one_rank_maps(scene, one, r, 4 * r, device)
                results = cli_num_devices(scene, os.path.join(scratch, f"cli_{r}"), r, r)
                try:
                    cli = check_cli_run(results, one, 4 * r, scene_views // r)
                except RuntimeError as err:
                    failures.append(f"CLI --num_devices {r}: {err}")
                    print(f"FAILED: {failures[-1]}", flush=True)
                else:
                    print(f"CLI train and eval --num_devices {r} --device cuda ({smi[0]}): ran; "
                          f"worst map difference vs 1 rank {cli}", flush=True)
                    run["cli_map_difference"] = cli
            summary["runs"].append(run)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    summary["failures"] = failures
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
