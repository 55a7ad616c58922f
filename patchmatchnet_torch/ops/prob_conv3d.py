"""K9: CasMVSNet's probability head, the 3x3x3 convolution from the last
U-Net block's 8 channels to one f32 logit a voxel (forward only).

Replaces no TPU kernel (the JAX package runs no cost-volume network). The
CUDA kernel is `csrc/prob_conv3d.cu` (`pmn_prob_conv3d`, device symbol
`pmn::prob_conv3d_kernel`); the plain version is the published head
(`cas_mvsnet.py` `CostRegNet.prob`): `F.conv3d` in the input's dtype, its
one channel taken and widened to f32. The kernel keeps the weights in f32
and accumulates in f32, where cuDNN in bf16 rounds the weights and the
logits to bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from patchmatchnet_torch.ops import cuda_build
from patchmatchnet_torch.ops.warp_similarity import _refuse_grad

CHANNELS = 8
KERNEL = "pmn::prob_conv3d_kernel"  # the device symbol, as traces name it
_PAYLOAD_DTYPES = (torch.float32, torch.bfloat16)


def prob_conv3d_reference(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: same arguments and result as `prob_conv3d`."""
    return F.conv3d(x, weight.to(x.dtype), None, 1, 1)[:, 0].float()


def uses_kernel(x: torch.Tensor) -> bool:
    """Whether `prob_conv3d(x, ...)` launches the kernel (CUDA tensors) or
    runs the plain version (CPU tensors)."""
    return x.device.type == "cuda"


def prob_conv3d(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The head's logits.

    Args:
        x: [B, 8, D, H, W] bf16 or f32 in `torch.channels_last_3d` (in
            memory [B, D, H, W, 8], as the U-Net's blocks leave it).
        weight: the head's [1, 8, 3, 3, 3] f32 weight (padding 1, no bias).
    Returns:
        [B, D, H, W] f32, contiguous. No backward: raises when grad is
        enabled and an input requires it.

    CPU tensors run the plain version; CUDA tensors launch the kernel, and
    anything the kernel does not take raises.
    """
    _refuse_grad("prob_conv3d", x, weight)
    cuda_build.check_kernel_device("prob_conv3d", x.device)
    if not uses_kernel(x):
        return prob_conv3d_reference(x, weight)
    if x.dim() != 5 or x.shape[1] != CHANNELS:
        raise ValueError(f"prob_conv3d: x must be [B, {CHANNELS}, D, H, W], got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError("prob_conv3d: x must be in torch.channels_last_3d")
    b, c, d, h, w = x.shape
    dev = x.device
    check = cuda_build.check_cuda_tensor
    volume = x.permute(0, 2, 3, 4, 1)  # the same memory, [B, D, H, W, 8] contiguous
    check("x", volume, dev, _PAYLOAD_DTYPES, (b, d, h, w, c))
    check("weight", weight, dev, (torch.float32,), (1, c, 3, 3, 3))
    out = torch.empty((b, d, h, w), dtype=torch.float32, device=dev)
    lib = cuda_build.kernel_library()
    with torch.cuda.device(dev):
        rc = lib.pmn_prob_conv3d(volume.data_ptr(), weight.data_ptr(), out.data_ptr(), b, d, h,
                                 w, int(x.dtype == torch.bfloat16),
                                 cuda_build.stream_handle(dev))
    cuda_build.check_launch("prob_conv3d", rc)
    return out
