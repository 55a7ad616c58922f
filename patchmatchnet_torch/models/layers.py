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
CasMVSNet's cost regularization has real 3D layers: `Conv3dBnReLU` and
`Deconv3dBnReLU` (3x3x3, named as cascade-stereo's `Conv3d` and
`Deconv3d` modules), which keep a `torch.channels_last_3d` input in that
layout and take the decoder's skip into the block. In eval mode a block
is one call of `ops.conv3d_block` (K10 on the card, bf16 or f32 payloads:
the convolution, the folded BatchNorm, the ReLU and the skip in one pass;
its plain version on the CPU); train mode keeps the composition (the
convolution, then BatchNorm with batch statistics, ReLU and the add).

BatchNorm follows the module's mode: `model.eval()` folds the running
statistics to one multiply-add; `model.train()` normalizes with the batch
statistics and updates the running ones as flax `nn.BatchNorm(momentum=0.9,
epsilon=1e-5)` does (reference: `layers.apply_batch_norm`). With a process
group set (`parallel.replicate`), the batch is the global one over the
group's ranks, as under the JAX package's sharded jit (sync-BN).

Initialization is torch's default (kaiming_uniform(a=sqrt(5)) weights,
U(+-1/sqrt(fan_in)) biases), which the reference reproduces with
`torch_kernel_init` / `torch_bias_init`; BatchNorm starts at scale 1,
bias 0, mean 0, var 1.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
import torch.nn as nn
import torch.nn.functional as F

from patchmatchnet_torch.ops import conv3d_block as block_op


def cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """`conv` applied in the compute dtype (input and weights cast to it)."""
    x = cast(x, dtype)
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(
        x, conv.weight.to(x.dtype), bias, conv.stride, conv.padding, conv.dilation
    )


def conv3d(conv: nn.Module, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """`conv` (an `nn.Conv3d` or `nn.ConvTranspose3d`) applied in the compute
    dtype (input and weights cast to it)."""
    x = cast(x, dtype)
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    if isinstance(conv, nn.ConvTranspose3d):
        return F.conv_transpose3d(x, conv.weight.to(x.dtype), bias, conv.stride, conv.padding,
                                  conv.output_padding, conv.groups, conv.dilation)
    return F.conv3d(x, conv.weight.to(x.dtype), bias, conv.stride, conv.padding, conv.dilation)


def channel_map(conv: nn.Conv2d, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """1x1 `conv` over axis 1 of a channel-first tensor of any rank >= 3."""
    shape = x.shape
    x4 = x.reshape(shape[0], shape[1], -1, shape[-1])
    y = conv2d(conv, x4, dtype)
    return y.reshape(shape[0], y.shape[1], *shape[2:])


class BatchNorm(nn.Module):
    """BatchNorm over axis 1, eps = 1e-5.

    Eval mode: folded to x * scale + bias in the input dtype (reference:
    layers.py `folded_bn_apply`). Train mode (flax `nn.BatchNorm` with
    momentum 0.9): f32 batch mean and biased variance over every axis but
    1, computed as E[x^2] - E[x]^2 clipped at 0 like flax; output in the
    input dtype; the running statistics move to 0.9 * old + 0.1 * batch,
    once per call.

    `group` (None, or a process group that `parallel.replicate` sets) makes
    the train-mode batch the global one: each call all-reduces one packed
    f32 tensor (E[x] and E[x^2] per channel, element count) with a
    differentiable sum (`torch.distributed.nn.functional.all_reduce`, whose
    backward sums the ranks' gradients), so the mean, the variance, their
    gradients and the running statistics are those of the global batch on
    every rank."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.group: Optional[dist.ProcessGroup] = None
        self._checked_counts: set = set()  # element counts sync-BN has checked

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            xf = x.float()
            mean = xf.mean(dim=dims)
            mean_sq = (xf * xf).mean(dim=dims)
            if self.group is not None:
                mean, mean_sq = self._global_means(mean, mean_sq, xf.numel() // xf.shape[1])
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
            mul = torch.rsqrt(var + 1e-5) * self.weight
            y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
            return y.to(x.dtype)
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        bias = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype).view(shape) + bias.to(x.dtype).view(shape)

    def _global_means(self, mean: torch.Tensor, mean_sq: torch.Tensor, count: int):
        """The means over the group's ranks of the local E[x] and E[x^2]:
        the global batch's, since every rank holds as many elements (equal
        rows of one global batch). The packed count checks that, reading it
        on the host (a sync) only the first time this module sees `count`,
        so a training step's launches queue up unbroken after the first.
        One rank gets its own means back to the bit."""
        c = mean.numel()
        packed = torch.cat([mean, mean_sq, mean.new_full((1,), count)])
        packed = dist_nn.all_reduce(packed, group=self.group)
        world = dist.get_world_size(self.group)
        if count not in self._checked_counts:
            # f32 sums integers exactly only below 2**24: compare relatively
            total = float(packed[2 * c].detach())
            if abs(total - world * count) > 1e-4 * world * count:
                raise ValueError("sync-BN needs the same number of elements on every rank, got "
                                 f"{count} here and {total:.0f} over {world} ranks")
            self._checked_counts.add(count)
        return packed[:c] / world, packed[c:2 * c] / world


class Conv2d(nn.Module):
    """Conv2d with bias under a `conv2d` child (reference: layers.Conv2d),
    used for the learned-offset convs, which start at zero (`zero_init`,
    as in the reference)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 pad: int = 1, dilation: int = 1, dtype: Optional[torch.dtype] = None,
                 zero_init: bool = False):
        super().__init__()
        self.dtype = dtype
        self.conv2d = nn.Conv2d(in_channels, out_channels, kernel_size,
                                padding=pad, dilation=dilation, bias=True)
        if zero_init:
            nn.init.zeros_(self.conv2d.weight)
            nn.init.zeros_(self.conv2d.bias)

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


def _block3d(block: nn.Module, x: torch.Tensor, skip: Optional[torch.Tensor]) -> torch.Tensor:
    """`relu(bn(conv(x))) [+ skip]` of a 3D block: K10 (`ops.conv3d_block`)
    in eval mode; the composition in train mode."""
    if block.training:
        return block_op.conv3d_block_reference(x, block.conv, block.bn, block.dtype, skip)
    return block_op.conv3d_block(x, block.conv, block.bn, block.dtype, skip)


class Conv3dBnReLU(nn.Module):
    """3x3x3 Conv3d (no bias) + BatchNorm + ReLU over [B, C, D, H, W]
    (cascade-stereo: module.py `Conv3d`), and the skip added after the
    ReLU where one is given."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv3d(in_channels, out_channels, 3, stride=stride, padding=1, bias=False)
        self.bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _block3d(self, x, skip)


class Deconv3dBnReLU(nn.Module):
    """3x3x3 ConvTranspose3d of stride 2 (padding 1, output padding 1, no
    bias: each of D, H, W doubles) + BatchNorm + ReLU (cascade-stereo:
    module.py `Deconv3d`), and the U-Net's skip added after the ReLU (the
    published `conv4 + self.conv7(x)`)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.ConvTranspose3d(in_channels, out_channels, 3, stride=2, padding=1,
                                       output_padding=1, bias=False)
        self.bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _block3d(self, x, skip)
