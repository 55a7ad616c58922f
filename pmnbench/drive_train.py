"""The generator of "train" traffic: the architecture's train step
(PatchmatchNet's: the program's `train_step`), back to back, on one card
or on `ranks` cards over NCCL.

Set-up makes the traffic's pool of global batches (`pool` batches of
`batch` x `ranks` samples) and what the program draws at random for each
(PatchmatchNet's stage-3 noise) on the device from the seed; every rank
makes the same pool and takes its rows. It builds the model from the
configuration with its weights (`archs/<architecture>.py`), on `ranks` > 1
as a `parallel.mesh.replicate` replica (DDP and sync-BN) in ranks started
by `parallel.mesh.launch`, each with one intra-op thread, and the
architecture's optimizer. It then drives three steps through the window's
own call on the pool's first three batches: they warm every shape, and
they are the steps the reference follows (the losses, the first gradient as
Adam's first moment holds it, and the parameters after the third step).
Two more steps, each ending in a synchronize, time a step, and the window
takes as many steps as fill `--seconds` at that time (the same count on
every rank), from a barrier and a synchronize to a synchronize and a
barrier. Nothing is read back inside the window.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from pmnbench import check, devtrace, scenes
from pmnbench.harness import Window, architecture, now, peak_gib

CHECK_STEPS = 3
TIMING_STEPS = 2
BETA1 = 0.9  # Adam's, as the program's `make_optimizer` sets it
BATCH_KEYS = ("images", "intrinsics", "extrinsics", "depth_min", "depth_max", "depth_gt",
              "mask")


def make_batches(arch, traffic: Dict[str, Any], seed: int, dev: torch.device, rank: int = 0,
                 world: int = 1, rows: Optional[slice] = None
                 ) -> Tuple[List[Dict[str, torch.Tensor]], List[Optional[torch.Tensor]]]:
    """The pool's batches and the architecture's extra inputs of each
    (None where it draws nothing): rank `rank`'s rows of each global batch
    of `batch` x `world` samples, or the rows `rows` (all: the global
    batch)."""
    b, h, w = traffic["batch"], traffic["height"], traffic["width"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool = scenes.make_scenes(gen, traffic["pool"] * b * world, traffic)
    rows = rows if rows is not None else slice(rank * b, (rank + 1) * b)
    batches, extras = [], []
    for j in range(traffic["pool"]):
        glob = slice(j * b * world, (j + 1) * b * world)
        batches.append({k: pool[k][glob][rows].contiguous() for k in BATCH_KEYS})
        extra = arch.extra_inputs(gen, b * world, h, w, dev)
        extras.append(None if extra is None else extra[rows].contiguous())
    return batches, extras


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

    traffic, config = cell_data["traffic"], cell_data["config"]
    arch = architecture(config)
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

    batches, extras = make_batches(arch, traffic, seed, dev, rank, world)
    model = arch.program_model(config, False, seed).to(dev)
    plain = model
    if group is not None:
        model = replicate(model, group)
    lr = float(config["learning_rate"])
    optimizer = arch.make_optimizer(model.parameters(), lr)
    step_index = [0]

    def step() -> Dict[str, torch.Tensor]:
        j = step_index[0] % traffic["pool"]
        step_index[0] += 1
        return arch.train_step(model, optimizer, batches[j], lr, extras[j], pg)

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

    traffic, config = cell_data["traffic"], cell_data["config"]
    arch = architecture(config)
    if group is None:
        dev, rank, world, pg = torch.device(device), 0, 1, None
    else:
        torch.set_num_threads(1)
        dev, rank, world, pg = group.device, group.rank, group.world_size, group.process_group
    lr = float(config["learning_rate"])
    out = []
    for seed in seeds:
        batches, extras = make_batches(arch, traffic, seed, dev, rank, world)
        if fault == "half":
            keep = traffic["batch"] // 2
            batches = [{k: v[:keep] for k, v in b.items()} for b in batches]
            extras = [None if e is None else e[:keep] for e in extras]
        model = arch.program_model(config, False, seed).to(dev)
        plain = model
        if group is not None and fault != "alone":
            model = replicate(model, group)
        optimizer = arch.make_optimizer(model.parameters(), lr)
        it = iter(range(CHECK_STEPS))

        def step():
            j = next(it)
            return arch.train_step(model, optimizer, batches[j], lr, extras[j], pg)

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
    window.bound = cell.arch.bound(config, traffic)
    if args.trace:
        window.trace = devtrace.merge_ranks([r["trace"] for r in results])
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    judge_steps(window, first, args.seed, dev)


def keyed(arch, program: Dict[str, Any], keys) -> Dict[str, Any]:
    """The program's readings (`checked_steps`) under the reference's
    parameter names `keys`."""
    return {"losses": program["losses"],
            "grad_norms": {k: program["grad_norms"][arch.program_key(k)] for k in keys},
            "change_norms": {k: program["change_norms"][arch.program_key(k)] for k in keys}}


def judge_steps(window: Window, program: Dict[str, Any], seed: int, dev: torch.device) -> None:
    """Follow the first three steps with the reference on the global
    batches and compare."""
    cell = window.cell
    traffic, config, limits, arch = cell.traffic, cell.config, cell.limits, cell.arch
    batches, extras = make_batches(arch, traffic, seed, dev, world=int(traffic["ranks"]),
                                   rows=slice(None))
    ref = arch.reference_model(config, "f32", dev, seed)
    theirs = arch.reference_train_steps(ref, batches[:CHECK_STEPS], extras[:CHECK_STEPS],
                                        float(config["learning_rate"]))
    numbers = check.train_numbers(keyed(arch, program, theirs["grad_norms"]), theirs)
    print("steps: " + ", ".join(f"{k} {v!r}" for k, v in numbers.items()), file=sys.stderr)
    window.checked = 1
    window.wrong = int(any(numbers[n] > limit for n, limit in limits["numbers"].items()))
    window.checks = [(n, numbers[n], float(limit)) for n, limit in limits["numbers"].items()]


def calibrate(cell, args, dev) -> None:
    """`calibrate.py`'s readings of a train cell: for each seed, the
    program's first steps (`calibration_rank`) against the f32 reference's;
    on the first `--control-seeds` seeds also the control (the reference in
    fp8), the witness (in bf16), and the program with half of each rank's
    rows left out and, on several ranks, with no exchange between them."""
    traffic, config, arch = cell.traffic, cell.config, cell.arch
    lr = float(config["learning_rate"])
    ranks = int(traffic["ranks"])
    seeds = [args.first_seed + 7919 * s for s in range(args.seeds)]
    control_seeds = seeds[:args.control_seeds]
    cell_data = {"traffic": traffic, "config": config}

    def program(seed_list, fault=""):
        if ranks == 1:
            return calibration_rank(None, cell_data, seed_list, fault, str(dev))
        from patchmatchnet_torch.parallel import launch

        return launch(calibration_rank, ranks, (cell_data, seed_list, fault),
                      device_type=dev.type)[0].value

    readings = {"program": program(seeds), "half_batch": program(control_seeds, "half")}
    if ranks > 1:
        readings["no_exchange"] = program(control_seeds, "alone")

    def reference_side(batches, extras, precision, seed):
        ref = arch.reference_model(config, precision, dev, seed)
        return arch.reference_train_steps(ref, batches[:CHECK_STEPS], extras[:CHECK_STEPS], lr)

    for i, seed in enumerate(seeds):
        batches, extras = make_batches(arch, traffic, seed, dev, world=ranks, rows=slice(None))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        start = time.perf_counter()
        theirs = reference_side(batches, extras, "f32", seed)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        keys = list(theirs["grad_norms"])
        line = {"seed": seed, "ref_s": time.perf_counter() - start,
                "ref_peak_gib": peak_gib(dev), "ref_losses": theirs["losses"]}
        mine = keyed(arch, readings["program"][i], keys)
        line["program"] = check.train_numbers(mine, theirs)
        line["program_worst"] = check.worst_leaves(mine, theirs)
        if i < len(control_seeds):
            control = reference_side(batches, extras, "fp8", seed)
            line["control"] = check.train_numbers(control, theirs)
            witness = reference_side(batches, extras, "bf16", seed)
            line["witness_bf16"] = check.train_numbers(witness, theirs)
            line["witness_worst"] = check.worst_leaves(witness, theirs)
            for fault in ("half_batch", "no_exchange"):
                if fault in readings:
                    line[fault] = check.train_numbers(keyed(arch, readings[fault][i], keys),
                                                      theirs)
        print(json.dumps(line), flush=True)
