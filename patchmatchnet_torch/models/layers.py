"""Layer primitives (NCHW) mirroring `patchmatchnet_tpu/models/layers.py`.

Module and parameter names follow the flax tree of the reference so that
`compat.weights.state_dict_from_jax` maps leaf paths to state-dict keys
one to one (e.g. ConvBnReLU holds `conv` and `bn`).

`dtype` is the compute dtype (None = f32, or torch.bfloat16): like flax's
`dtype`, each layer casts its input and its f32 weights to it and returns
that dtype. Weights stay stored in f32, so the folded BatchNorm constants
are computed in f32 before the cast, as in the reference. This is explicit
casting, not autocast, so the CPU tests run the bf16 path too.

The reference's per-position channel maps (1x1x1 Conv3d in the original
model, Dense in the JAX package) are 1x1 convolutions here, applied to
channel-first volumes [B, C, ...] by folding the trailing dims into 2-D.

Inference only: BatchNorm always uses its running statistics, folded to one
multiply-add (training with batch statistics belongs with the loss).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """`conv` applied in the compute dtype (input and weights cast to it)."""
    x = cast(x, dtype)
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(
        x, conv.weight.to(x.dtype), bias, conv.stride, conv.padding, conv.dilation
    )


def channel_map(conv: nn.Conv2d, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """1x1 `conv` over axis 1 of a channel-first tensor of any rank >= 3."""
    shape = x.shape
    x4 = x.reshape(shape[0], shape[1], -1, shape[-1])
    y = conv2d(conv, x4, dtype)
    return y.reshape(shape[0], y.shape[1], *shape[2:])


class BatchNorm(nn.Module):
    """Inference BatchNorm over axis 1, folded to x * scale + bias in the
    input dtype (reference: layers.py `folded_bn_apply`), eps = 1e-5."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        bias = self.bias - self.running_mean * scale
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * scale.to(x.dtype).view(shape) + bias.to(x.dtype).view(shape)


class Conv2d(nn.Module):
    """Conv2d with bias under a `conv2d` child (reference: layers.Conv2d),
    used for the learned-offset convs."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 pad: int = 1, dilation: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv2d = nn.Conv2d(in_channels, out_channels, kernel_size,
                                padding=pad, dilation=dilation, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(self.conv2d, x, self.dtype)


class ConvBnReLU(nn.Module):
    """Conv2d (no bias) + BatchNorm + ReLU (reference: layers.ConvBnReLU)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, pad: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=pad, bias=False)
        self.bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(conv2d(self.conv, x, self.dtype)))


class DenseBnReLU(nn.Module):
    """Per-position channel map + BatchNorm + ReLU over axis 1
    (reference: layers.DenseBnReLU)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(channel_map(self.conv, x, self.dtype)))


class Dense1(nn.Module):
    """Per-position channel map with bias over axis 1 (reference:
    layers.Dense1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.dense = nn.Conv2d(in_channels, out_channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return channel_map(self.dense, x, self.dtype)
