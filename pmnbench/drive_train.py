"""The generator of "train" traffic: the program's `train_step`, back to
back, on one card or on `ranks` cards over NCCL.

Set-up makes the traffic's pool of global batches (`pool` batches of
`batch` x `ranks` samples) and each batch's stage-3 noise on the device
from the seed; every rank makes the same pool and takes its rows. It
builds the model from the configuration with the checkpoint's weights (the
program's `build_model` and loader), on `ranks` > 1 as a
`parallel.mesh.replicate` replica (DDP and sync-BN) in ranks started by
`parallel.mesh.launch`, each with one intra-op thread, and Adam
(`make_optimizer`). It then drives three steps through the window's own
call on the pool's first three batches: they warm every shape, and they
are the steps the reference follows (the losses, the first gradient as
Adam's first moment holds it, and the parameters after the third step).
Two more steps, each ending in a synchronize, time a step, and the window
takes as many steps as fill `--seconds` at that time (the same count on
every rank), from a barrier and a synchronize to a synchronize and a
barrier. Nothing is read back inside the window.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from pmnbench import check, devtrace, scenes
from pmnbench.harness import Window, now, program_model, reference_model
from pmnbench.roofline.count import cell_bound

CHECK_STEPS = 3
TIMING_STEPS = 2
BETA1 = 0.9  # Adam's, as the program's `make_optimizer` sets it
BATCH_KEYS = ("images", "intrinsics", "extrinsics", "depth_min", "depth_max", "depth_gt",
              "mask")


def make_batches(traffic: Dict[str, Any], seed: int, dev: torch.device, rank: int = 0,
                 world: int = 1, rows: Optional[slice] = None
                 ) -> Tuple[List[Dict[str, torch.Tensor]], List[torch.Tensor]]:
    """The pool's batches and noises: rank `rank`'s rows of each global
    batch of `batch` x `world` samples, or the rows `rows` (all: the
    global batch)."""
    b, h, w = traffic["batch"], traffic["height"], traffic["width"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool = scenes.make_scenes(gen, traffic["pool"] * b * world, traffic)
    rows = rows if rows is not None else slice(rank * b, (rank + 1) * b)
    batches, noises = [], []
    for j in range(traffic["pool"]):
        glob = slice(j * b * world, (j + 1) * b * world)
        batches.append({k: pool[k][glob][rows].contiguous() for k in BATCH_KEYS})
        noise = torch.rand((b * world, 48, h // 8, w // 8), generator=gen, device=dev)
        noises.append(noise[rows].contiguous())
    return batches, noises


def checked_steps(step, optimizer, model) -> Dict[str, Any]:
    """Run the first CHECK_STEPS steps (`step()`); return what the reference
    is compared on: each step's loss, each parameter's first gradient as
    Adam's first moment holds it after one step (m / (1 - beta1)), and the
    norm of each parameter's change over the steps."""
    params = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    losses = []
    grad_norms: Dict[str, float] = {}
    for i in range(CHECK_STEPS):
        losses.append(step()["loss"])
        if i == 0:
            grad_norms = {k: float(optimizer.state[p]["exp_avg"].norm() / (1 - BETA1))
                          for k, p in params.items()}
    change_norms = {k: float((p.detach() - before[k]).norm()) for k, p in params.items()}
    return {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
            "change_norms": change_norms}


def rank_main(group, cell_data: Dict[str, Any], seed: int, seconds: float, traced: bool,
              t0_wall: float, device: Optional[str] = None) -> Dict[str, Any]:
    """One rank's run (all of it, with `group` None, on one card)."""
    import torch.distributed as dist
    from patchmatchnet_torch.parallel import replicate
    from patchmatchnet_torch.train.loop import make_optimizer, train_step

    traffic, config = cell_data["traffic"], cell_data["config"]
    if group is None:
        dev, rank, world, pg = torch.device(device), 0, 1, None
    else:
        torch.set_num_threads(1)
        dev, rank, world, pg = group.device, group.rank, group.world_size, group.process_group
    cuda = dev.type == "cuda"

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(dev)
        if pg is not None:
            dist.barrier(group=pg)
            if cuda:
                torch.cuda.synchronize(dev)

    batches, noises = make_batches(traffic, seed, dev, rank, world)
    model = program_model(config, inference=False).to(dev)
    plain = model
    if group is not None:
        model = replicate(model, group)
    lr = float(config["learning_rate"])
    optimizer = make_optimizer(model.parameters(), lr)
    step_index = [0]

    def step() -> Dict[str, torch.Tensor]:
        j = step_index[0] % traffic["pool"]
        step_index[0] += 1
        metrics, _ = train_step(model, optimizer, batches[j], lr, noises[j], group=pg)
        return metrics

    readings = checked_steps(step, optimizer, plain)
    sync()
    t = now()
    for _ in range(TIMING_STEPS):
        step()
    sync()
    per_step = (now() - t) / TIMING_STEPS
    count = torch.tensor([max(3, math.ceil(seconds / per_step))], device=dev)
    if pg is not None:
        dist.all_reduce(count, op=dist.ReduceOp.MAX, group=pg)
    count = int(count.item())

    setup_s = time.time() - t0_wall
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    sync()
    start = now()
    for _ in range(count):
        step()
    sync()
    window_s = now() - start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = devtrace.traced(step, traffic["trace_steps"], sync) if traced else None
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    return {"setup_s": setup_s, "window_s": window_s, "count": count, "peak": peak,
            "trace": summary, "device_name": name, **readings}


def calibration_rank(group, cell_data: Dict[str, Any], seeds: List[int], fault: str = "",
                     device: Optional[str] = None) -> List[Dict[str, Any]]:
    """`checked_steps`' readings of a fresh program for each seed (for
    `calibrate.py`), optionally with a fault planted: "half" (each step
    trains on half of each rank's rows) or "alone" (no exchange between
    the ranks: neither DDP nor sync-BN)."""
    from patchmatchnet_torch.parallel import replicate
    from patchmatchnet_torch.train.loop import make_optimizer, train_step

    traffic, config = cell_data["traffic"], cell_data["config"]
    if group is None:
        dev, rank, world, pg = torch.device(device), 0, 1, None
    else:
        torch.set_num_threads(1)
        dev, rank, world, pg = group.device, group.rank, group.world_size, group.process_group
    lr = float(config["learning_rate"])
    out = []
    for seed in seeds:
        batches, noises = make_batches(traffic, seed, dev, rank, world)
        if fault == "half":
            keep = traffic["batch"] // 2
            batches = [{k: v[:keep] for k, v in b.items()} for b in batches]
            noises = [n[:keep] for n in noises]
        model = program_model(config, inference=False).to(dev)
        plain = model
        if group is not None and fault != "alone":
            model = replicate(model, group)
        optimizer = make_optimizer(model.parameters(), lr)
        it = iter(range(CHECK_STEPS))

        def step():
            j = next(it)
            return train_step(model, optimizer, batches[j], lr, noises[j], group=pg)[0]

        out.append(checked_steps(step, optimizer, plain))
    return out


def run(window: Window, args, t0: float, device: str) -> None:
    from patchmatchnet_torch.parallel import launch

    cell = window.cell
    traffic, config = cell.traffic, cell.config
    ranks = int(traffic["ranks"])
    dev = torch.device(device if ranks == 1 or device != "cuda" else "cuda:0")
    cuda = dev.type == "cuda"
    cell_data = {"traffic": traffic, "config": config}
    t0_wall = time.time() - (now() - t0)
    if ranks == 1:
        results = [rank_main(None, cell_data, args.seed, args.seconds, bool(args.trace),
                             t0_wall, device)]
    else:
        out = launch(rank_main, ranks, (cell_data, args.seed, args.seconds, bool(args.trace),
                                        t0_wall),
                     device_type="cuda" if cuda else "cpu")
        results = [r.value for r in out]
    first = results[0]
    window.device_name = first["device_name"]
    window.ranks = ranks
    window.setup_s = max(r["setup_s"] for r in results)
    window.window_s = first["window_s"]
    window.count = first["count"]
    window.samples = first["count"] * traffic["batch"] * ranks
    window.peak_bytes = max(r["peak"] for r in results)
    window.bound = cell_bound(config, traffic)
    if args.trace:
        window.trace = devtrace.merge_ranks([r["trace"] for r in results])
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    judge_steps(window, first, args.seed, dev)


def judge_steps(window: Window, program: Dict[str, Any], seed: int, dev: torch.device) -> None:
    """Follow the first three steps with the reference on the global
    batches and compare."""
    from pmnbench import reference

    cell = window.cell
    traffic, config, limits = cell.traffic, cell.config, cell.limits
    batches, noises = make_batches(traffic, seed, dev, world=int(traffic["ranks"]),
                                   rows=slice(None))
    ref = reference_model(config, "f32", dev)
    out = reference.train_steps(ref, batches[:CHECK_STEPS], noises[:CHECK_STEPS],
                                float(config["learning_rate"]))
    mine = {"losses": program["losses"],
            "grad_norms": {k: program["grad_norms"][check.flax_to_program(k)]
                           for k in out["grads"]},
            "change_norms": {k: program["change_norms"][check.flax_to_program(k)]
                             for k in out["grads"]}}
    theirs = {"losses": out["losses"],
              "grad_norms": {k: float(g.norm()) for k, g in out["grads"].items()},
              "change_norms": {k: float((ref.params[k] - out["params0"][k]).norm())
                               for k in out["grads"]}}
    numbers = check.train_numbers(mine, theirs)
    print("steps: " + ", ".join(f"{k} {v!r}" for k, v in numbers.items()), file=sys.stderr)
    window.checked = 1
    window.wrong = int(any(numbers[n] > limit for n, limit in limits["numbers"].items()))
    window.checks = [(n, numbers[n], float(limit)) for n, limit in limits["numbers"].items()]
