"""Data parallelism over `torch.distributed` (reference:
`patchmatchnet_tpu/parallel/`): rank groups and their launcher, the batch
sharding, the replicated model with sync-BN, and a stand-in model for
tests."""

from patchmatchnet_torch.parallel.dryrun import DryRunModel
from patchmatchnet_torch.parallel.mesh import (
    Group,
    RankResult,
    launch,
    make_group,
    rank_rows,
    replicate,
    resolve_devices,
    shard_batch,
)

__all__ = [
    "DryRunModel",
    "Group",
    "RankResult",
    "launch",
    "make_group",
    "rank_rows",
    "replicate",
    "resolve_devices",
    "shard_batch",
]
