"""The hand kernels as PyTorch operators in the `pmn` namespace
(`torch.ops.pmn.*`): K1 `warp_group_corr`, K6 `warp_group_corr_views`, K2
`eval_grid_score` and K3 `neighbor_group_corr`.

Each operator dispatches on its tensors' device: the plain PyTorch version
for CPU tensors, the kernel launch (with its checks and launch count) for
CUDA tensors, and no other device. A fake implementation gives the output's
shape and dtype to tracing, so `torch.export` keeps each call as one node
of its graph. Registration happens at import and builds nothing: the kernel
library is built at the first CUDA call.

The operators are registered through `torch.library.define` / `impl`
rather than `torch.library.custom_op`, whose implementations are wrapped to
disable TorchDynamo, so that an operator's first call imports it (seconds
of a process's first request).
"""

from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "pmn"


def define_kernel_op(name: str, schema: str, plain: Callable, kernel: Callable,
                     fake: Callable) -> torch._ops.OpOverload:
    """Register `pmn::<name>(<schema>)` with `plain` as its CPU
    implementation, `kernel` as its CUDA one and `fake` for tracing; returns
    the operator (`torch.ops.pmn.<name>.default`)."""
    qualname = f"{NAMESPACE}::{name}"
    torch.library.define(qualname, schema)
    torch.library.impl(qualname, "cpu", plain)
    torch.library.impl(qualname, "cuda", kernel)
    torch.library.register_fake(qualname, fake)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
