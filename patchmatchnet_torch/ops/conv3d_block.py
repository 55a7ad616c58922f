"""K10: one block of CasMVSNet's 3D U-Nets, `relu(conv3x3x3(x) * scale +
shift) [+ skip]`, in one pass (eval mode, forward only).

Replaces no TPU kernel (the JAX package runs no cost-volume network). The
CUDA kernel is `csrc/conv3d_block.cu` (`pmn_conv3d_block`, device symbols
`pmn::conv3d_block_kernel` and `pmn::conv3d_block_f32_kernel`): the 3x3x3
convolution of stride 1 or 2, or the stride-2 transposed one, the eval
BatchNorm folded into its epilogue with the ReLU and the decoder's skip add.
bf16 payloads take the tensor cores with f32 sums and one rounding to bf16;
f32 payloads take the CUDA cores in f32 throughout. The plain version is the
composition the blocks ran before it (`models.layers.conv3d`, the eval
`BatchNorm`, ReLU, then the skip added after the ReLU, as cascade-stereo's
`conv4 + self.conv7(x)`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from patchmatchnet_torch.ops import cuda_build
from patchmatchnet_torch.ops.warp_similarity import _refuse_grad

# the device symbols, as traces name them: bf16 payloads, f32 payloads
KERNEL, KERNEL_F32 = "pmn::conv3d_block_kernel", "pmn::conv3d_block_f32_kernel"
STRIDE1, STRIDE2, TRANSPOSED = 0, 1, 2
_PAYLOAD_DTYPES = (torch.bfloat16, torch.float32)


def conv3d_block_reference(x: torch.Tensor, conv: nn.Module, bn: nn.Module,
                           dtype: Optional[torch.dtype], skip: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version: same arguments and result as `conv3d_block`."""
    from patchmatchnet_torch.models.layers import conv3d

    y = F.relu(bn(conv3d(conv, x, dtype)))
    return y if skip is None else y + skip


def conv3d_block_unrounded(x: torch.Tensor, conv: nn.Module, bn: nn.Module,
                     skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The bf16 kernel's arithmetic in f32 (TF32 off), without its one rounding:
    bf16-rounded weights, as the tensor cores take them, over `x` and
    `skip` widened to f32, the folded BatchNorm, ReLU and skip in f32. What
    the kernel is held to on the card (the plain version rounds to bf16
    after the convolution and after each of the BatchNorm's two passes)."""
    weight = conv.weight.detach().bfloat16().float()
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        if block_mode(conv) == TRANSPOSED:
            y = F.conv_transpose3d(x.float(), weight, None, 2, 1, 1)
        else:
            y = F.conv3d(x.float(), weight, None, conv.stride, 1)
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    scale = bn.weight * torch.rsqrt(bn.running_var + 1e-5)
    shift = bn.bias - bn.running_mean * scale
    y = torch.relu(y * scale.view(1, -1, 1, 1, 1) + shift.view(1, -1, 1, 1, 1))
    return y if skip is None else y + skip.float()


def uses_kernel(x: torch.Tensor) -> bool:
    """Whether `conv3d_block(x, ...)` launches the kernel (CUDA tensors) or
    runs the plain version (CPU tensors)."""
    return x.device.type == "cuda"


def block_mode(conv: nn.Module) -> int:
    """STRIDE1, STRIDE2 or TRANSPOSED for a 3x3x3 `nn.Conv3d` (padding 1,
    stride 1 or 2) or `nn.ConvTranspose3d` (stride 2, padding 1, output
    padding 1), without bias, groups or dilation; raises for any other."""
    transposed = isinstance(conv, nn.ConvTranspose3d)
    ok = (isinstance(conv, (nn.Conv3d, nn.ConvTranspose3d)) and conv.bias is None
          and conv.kernel_size == (3, 3, 3) and conv.padding == (1, 1, 1)
          and conv.dilation == (1, 1, 1) and conv.groups == 1)
    if ok and transposed and conv.stride == (2, 2, 2) and conv.output_padding == (1, 1, 1):
        return TRANSPOSED
    if ok and not transposed and conv.stride in ((1, 1, 1), (2, 2, 2)):
        return STRIDE1 if conv.stride == (1, 1, 1) else STRIDE2
    raise ValueError(f"conv3d_block takes a 3x3x3 Conv3d of stride 1 or 2 or a stride-2 "
                     f"ConvTranspose3d (padding 1, no bias), got {conv}")


def output_size(mode: int, size: int) -> int:
    """An output extent of the block along one axis of input extent `size`."""
    return size if mode == STRIDE1 else (size - 1) // 2 + 1 if mode == STRIDE2 else 2 * size


def conv3d_block(x: torch.Tensor, conv: nn.Module, bn: nn.Module,
                 dtype: Optional[torch.dtype], skip: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """One U-Net block in eval mode: `relu(bn(conv(x))) [+ skip]`.

    Args:
        x: [B, Cin, D, H, W]; cast to `dtype` (None: kept) as the block's
            layers cast it.
        conv: the block's `nn.Conv3d` or `nn.ConvTranspose3d` (`block_mode`),
            its f32 weight as stored.
        bn: the block's eval-mode `models.layers.BatchNorm` over Cout.
        skip: None, or [B, Cout, Do, Ho, Wo] added after the ReLU.
    Returns:
        [B, Cout, Do, Ho, Wo] in x's dtype; on the card channels_last_3d
        (in memory [B, Do, Ho, Wo, Cout]). No backward: raises when grad is
        enabled and an input requires it.

    CPU tensors run the plain version; CUDA tensors launch the kernel, which
    takes bf16 or f32 channels_last_3d payloads (skip in x's dtype) at the
    (mode, Cin, Cout) of CasMVSNet's CostRegNets (`csrc/conv3d_block.cu`
    refuses any other), and anything else raises.
    """
    tensors = [x, conv.weight, bn.weight, bn.bias] + ([] if skip is None else [skip])
    _refuse_grad("conv3d_block", *tensors)
    cuda_build.check_kernel_device("conv3d_block", x.device)
    if not uses_kernel(x):
        return conv3d_block_reference(x, conv, bn, dtype, skip)
    if bn.training:
        raise ValueError("conv3d_block folds the BatchNorm's running statistics: eval mode only")
    x = x if dtype is None else x.to(dtype)
    mode = block_mode(conv)
    if x.dim() != 5:
        raise ValueError(f"conv3d_block: x must be [B, C, D, H, W], got {tuple(x.shape)}")
    b, cin, d, h, w = x.shape
    cout = conv.out_channels
    if cin != conv.in_channels:
        raise ValueError(f"conv3d_block: x has {cin} channels, the convolution takes "
                         f"{conv.in_channels}")
    if not x.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError("conv3d_block: x must be in torch.channels_last_3d")
    do, ho, wo = (output_size(mode, n) for n in (d, h, w))
    dev = x.device
    check = cuda_build.check_cuda_tensor
    volume = x.permute(0, 2, 3, 4, 1)  # the same memory, [B, D, H, W, Cin] contiguous
    check("x", volume, dev, _PAYLOAD_DTYPES, (b, d, h, w, cin))
    check("weight", conv.weight, dev, (torch.float32,), tuple(conv.weight.shape))
    for name in ("weight", "bias", "running_mean", "running_var"):
        check(f"bn.{name}", getattr(bn, name), dev, (torch.float32,), (cout,))
    skip_ptr = None
    if skip is not None:
        if not skip.is_contiguous(memory_format=torch.channels_last_3d):
            raise ValueError("conv3d_block: skip must be in torch.channels_last_3d")
        check("skip", skip.permute(0, 2, 3, 4, 1), dev, (x.dtype,), (b, do, ho, wo, cout))
        skip_ptr = skip.data_ptr()
    out = torch.empty((b, do, ho, wo, cout), dtype=x.dtype, device=dev)
    lib = cuda_build.kernel_library()
    with torch.cuda.device(dev):
        rc = lib.pmn_conv3d_block(volume.data_ptr(), conv.weight.data_ptr(), bn.weight.data_ptr(),
                                  bn.bias.data_ptr(), bn.running_mean.data_ptr(),
                                  bn.running_var.data_ptr(), skip_ptr, out.data_ptr(), b, d, h,
                                  w, do, ho, wo, cin, cout, mode, int(x.dtype == torch.bfloat16),
                                  cuda_build.stream_handle(dev))
    cuda_build.check_launch("conv3d_block", rc)
    return out.permute(0, 4, 1, 2, 3)
