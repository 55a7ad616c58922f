"""Rank groups, the rank launcher and the sharding policy of data parallelism
(reference: `patchmatchnet_tpu/parallel/mesh.py`).

The JAX package jits one program over a 1-D `data` mesh: every batch array
is split along its leading axis, parameters are replicated, and XLA inserts
the gradient and BatchNorm reductions. Here each mesh device is a process
(a rank) with its own device; `launch` starts them, `make_group` joins them
in a `torch.distributed` process group (NCCL on CUDA, gloo on the CPU),
`shard_batch` takes a rank's rows of a global batch as `NamedSharding(P("data"))`
splits it, and `replicate` makes the model one replica of a global-batch
step: `DistributedDataParallel` for the gradients, and the port's own
BatchNorm reduced over the group (sync-BN), since the JAX step normalizes
with the statistics of the global batch.
"""

from __future__ import annotations

import inspect
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.nn.parallel import DistributedDataParallel

from patchmatchnet_torch.models.layers import BatchNorm
from patchmatchnet_torch.ops import cuda_build

DeviceLike = Union[str, torch.device]


class Group(NamedTuple):
    """One rank's view of a data-parallel group (the counterpart of a mesh)."""

    rank: int
    world_size: int
    device: torch.device
    process_group: dist.ProcessGroup


class RankResult(NamedTuple):
    """What one rank of `launch` returned, and its hand-kernel launches."""

    value: Any
    launches: dict


def resolve_devices(num_devices: int, device_type: str = "cuda",
                    devices: Optional[Sequence[DeviceLike]] = None,
                    backend: Optional[str] = None) -> Tuple[List[torch.device], str]:
    """The devices of ranks 0..num_devices-1 and the backend, checked before
    any rank starts. Defaults: `cuda:0..N-1` with NCCL, or the CPU with gloo.
    An explicit `devices` list may repeat a card (ranks sharing it) only
    with gloo: NCCL refuses two ranks on one GPU. CUDA ranks need that many
    cards; there is no quiet fallback to fewer ranks or to the CPU."""
    if num_devices < 1:
        raise ValueError(f"num_devices must be at least 1, got {num_devices}")
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(num_devices)]
                   if device_type == "cuda" else [torch.device(device_type)] * num_devices)
    devices = [torch.device(d) for d in devices]
    if len(devices) != num_devices:
        raise ValueError(f"{len(devices)} devices given for {num_devices} ranks")
    kinds = {d.type for d in devices}
    if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
        raise ValueError(f"ranks need all-cuda or all-cpu devices, got {devices}")
    kind = kinds.pop()
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend not in ("nccl", "gloo") or (backend == "nccl" and kind != "cuda"):
        raise ValueError(f"backend {backend!r} does not run {kind} ranks")
    if kind == "cuda":
        devices = [torch.device("cuda", d.index or 0) for d in devices]
        if backend == "nccl" and len(set(devices)) < len(devices):
            raise ValueError(f"NCCL takes one rank per GPU, got {devices}; ranks that "
                             "share a card need backend='gloo'")
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        needed = max(d.index for d in devices) + 1
        if needed > cards:
            on = ", ".join(sorted({str(d) for d in devices}))
            raise RuntimeError(f"{num_devices} CUDA ranks on {on} need {needed} cards; "
                               f"torch.cuda.device_count() is {cards}")
    return devices, backend


def make_group(num_devices: int, device_type: str = "cuda",
               devices: Optional[Sequence[DeviceLike]] = None,
               backend: Optional[str] = None, *, rank: int, init_file: str) -> Group:
    """Join rank `rank` of `num_devices` to a process group (the counterpart
    of `make_mesh`). Rendezvous is the file `init_file`, which every rank
    names and which must not exist before the group forms (no TCP port, so
    concurrent groups cannot collide)."""
    devices, backend = resolve_devices(num_devices, device_type, devices, backend)
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=num_devices)
    return Group(rank, num_devices, device, dist.group.WORLD)


def _rank_main(rank: int, fn: Callable, args: tuple, devices: List[torch.device],
               backend: str, folder: str, threads: int) -> None:
    if devices[rank].type == "cpu":
        torch.set_num_threads(threads)
    try:
        group = make_group(len(devices), devices=devices, backend=backend, rank=rank,
                           init_file=os.path.join(folder, "store"))
        try:
            value = fn(group, *args)
        finally:
            dist.destroy_process_group()
        torch.save(RankResult(value, cuda_build.launch_counts())._asdict(),
                   os.path.join(folder, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(folder, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def launch(fn: Callable, num_devices: int, args: tuple = (), *, device_type: str = "cuda",
           devices: Optional[Sequence[DeviceLike]] = None, backend: Optional[str] = None,
           timeout: Optional[float] = None) -> List[RankResult]:
    """Run `fn(group, *args)` on ranks 0..num_devices-1, each a process
    started with the `spawn` method (`fn` and `args` are pickled: `fn` must
    be importable by name). Returns each rank's `RankResult`: `fn`'s value
    and the rank's `cuda_build.launch_counts()`.

    The devices are checked first (`resolve_devices`), and for CUDA ranks
    the kernel library is built here, once, before any rank starts. Raises
    when a rank fails (with its traceback) or when `timeout` seconds pass,
    and then stops every rank that is still running. CPU ranks take an
    equal share of this process's threads."""
    devices, backend = resolve_devices(num_devices, device_type, devices, backend)
    if devices[0].type == "cuda":
        cuda_build.kernel_library()
    threads = max(1, torch.get_num_threads() // num_devices)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="pmn_ranks_") as folder:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, fn, args, devices, backend, folder, threads))
                 for rank in range(num_devices)]
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    _raise_rank_failure(folder, procs)
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{num_devices} ranks of {fn.__name__} did not finish "
                                       f"within {timeout} s")
                procs[0].join(0.05)
            if any(p.exitcode != 0 for p in procs):
                _raise_rank_failure(folder, procs)
            return [RankResult(**torch.load(os.path.join(folder, f"rank{rank}.pt"),
                                            weights_only=False))
                    for rank in range(num_devices)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                if p.pid is not None:
                    p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()


def _raise_rank_failure(folder: str, procs) -> None:
    """Raise with every failed rank's traceback: the first rank to fail
    often takes its peers down, and which exit is seen first is chance."""
    time.sleep(1.0)  # the peers of a failed rank fail within a moment
    lines = []
    for rank, p in enumerate(procs):
        path = os.path.join(folder, f"rank{rank}.err")
        if os.path.isfile(path):
            with open(path) as f:
                lines.append(f"rank {rank} (exit code {p.exitcode}):\n{f.read()}")
        elif p.exitcode not in (None, 0):
            lines.append(f"rank {rank}: exit code {p.exitcode}")
    raise RuntimeError("data-parallel ranks failed:\n" + "\n".join(lines))


def rank_rows(rows: int, rank: int, world_size: int) -> slice:
    """Rank `rank`'s contiguous share of `rows` rows: ceil(rows / world_size)
    each, in rank order, so the last ranks may get fewer or none. When
    world_size divides rows, this is `NamedSharding(P("data"))`'s split."""
    per = -(-rows // world_size)
    return slice(min(rows, rank * per), min(rows, (rank + 1) * per))


def shard_batch(batch: dict, group: Group) -> dict:
    """The rank's rows of every value (array, tensor or list) of a global
    batch. Like the JAX `shard_batch`, the leading axis must split evenly."""
    out = {}
    for key, value in batch.items():
        n = len(value)
        if n % group.world_size != 0:
            raise ValueError(f"{key}: a global batch of {n} rows does not split over "
                             f"{group.world_size} ranks")
        out[key] = value[rank_rows(n, group.rank, group.world_size)]
    return out


def replicate(model: torch.nn.Module, group: Group) -> DistributedDataParallel:
    """`model` (on `group.device`) as one replica of a global-batch step:
    its BatchNorms synced over the group, wrapped in DistributedDataParallel,
    which broadcasts rank 0's parameters and buffers when it is built and
    averages the gradients. Buffers are not broadcast again at every
    forward: the synced statistics move the running ones identically on
    every rank."""
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.group = group.process_group
    device_ids = [group.device] if group.device.type == "cuda" else None
    # torch versions that have `forward_sync_buffers` deprecate
    # `broadcast_buffers`; both leave the sync when DDP is built
    params = inspect.signature(DistributedDataParallel.__init__).parameters
    no_forward_sync = ({"forward_sync_buffers": False} if "forward_sync_buffers" in params
                       else {"broadcast_buffers": False})
    return DistributedDataParallel(model, device_ids=device_ids,
                                   process_group=group.process_group, **no_forward_sync)

