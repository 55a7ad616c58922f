"""K8: CasMVSNet's variance cost volume, fused (forward only).

Replaces no TPU kernel (the JAX package runs no cost-volume network). The
CUDA kernel is `csrc/variance_volume.cu` (`pmn_variance_volume`); the plain
version is the published formulation (`cas_mvsnet.py` `DepthNet` with
`module.py` `homo_warping`): one `grid_sample` of each source view at every
plane, summed with its square over the views.

Both take the warp through `warp.warp_proj_coeffs` and share its departure
from the published code: a point at or behind the source camera (pz <=
1e-3) reads zero, where the published warp divides by pz whatever its sign.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from patchmatchnet_torch.ops import cuda_build
from patchmatchnet_torch.ops.warp import warp_coords
from patchmatchnet_torch.ops.warp_similarity import _refuse_grad

CHANNELS = (8, 16, 32, 64)
_PAYLOAD_DTYPES = (torch.float32, torch.bfloat16)


def variance_volume_reference(ref: torch.Tensor, src: torch.Tensor, mats: torch.Tensor,
                              depth: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: same arguments and result as `variance_volume`,
    each source view warped by `F.grid_sample` (bilinear, zeros padding,
    align_corners=True) and accumulated in f32."""
    b, h, w, c = ref.shape
    d = depth.shape[1]
    total = ref.float()[:, None].expand(b, d, h, w, c)
    squares = total * total
    for v in range(src.shape[1]):
        ix, iy = warp_coords(mats[:, v], depth, h, w)
        grid = torch.stack([ix / ((w - 1) / 2) - 1, iy / ((h - 1) / 2) - 1], dim=-1)
        warped = F.grid_sample(src[:, v].float().permute(0, 3, 1, 2),
                               grid.reshape(b, d * h, w, 2), mode="bilinear",
                               padding_mode="zeros", align_corners=True)
        warped = warped.reshape(b, c, d, h, w).permute(0, 2, 3, 4, 1)
        total = total + warped
        squares = squares + warped * warped
    n = src.shape[1] + 1
    mean = total / n
    return (squares / n - mean * mean).to(ref.dtype).contiguous()


def variance_volume(ref: torch.Tensor, src: torch.Tensor, mats: torch.Tensor,
                    depth: torch.Tensor) -> torch.Tensor:
    """The variance over the N = V + 1 views of each channel at each
    depth hypothesis.

    Args:
        ref: [B, H, W, C] reference features (bf16 or f32).
        src: [B, V, H, W, C] source features at the same level, same dtype.
        mats: [B, V, 12] f32 `warp_proj_coeffs(src_proj, ref_proj)` of each
            source view.
        depth: [B, D, H, W] f32 depth hypotheses.
    Returns:
        [B, D, H, W, C] in the features' dtype (channels last: permuted to
        [B, C, D, H, W] it is a `torch.channels_last_3d` tensor). No
        backward: raises when grad is enabled and an input requires it.

    CPU tensors run the plain version; CUDA tensors launch the kernel, and
    anything the kernel does not take raises.
    """
    _refuse_grad("variance_volume", ref, src, depth)
    cuda_build.check_kernel_device("variance_volume", ref.device)
    if ref.device.type == "cpu":
        return variance_volume_reference(ref, src, mats, depth)
    b, h, w, c = ref.shape
    v, d = src.shape[1], depth.shape[1]
    if c not in CHANNELS:
        raise ValueError(f"variance_volume: no kernel for C={c} (takes {CHANNELS})")
    dev = ref.device
    check = cuda_build.check_cuda_tensor
    check("ref", ref, dev, _PAYLOAD_DTYPES, (b, h, w, c))
    check("src", src, dev, (ref.dtype,), (b, v, h, w, c))
    check("mats", mats, dev, (torch.float32,), (b, v, 12))
    check("depth", depth, dev, (torch.float32,), (b, d, h, w))
    out = torch.empty((b, d, h, w, c), dtype=ref.dtype, device=dev)
    lib = cuda_build.kernel_library()
    with torch.cuda.device(dev):
        rc = lib.pmn_variance_volume(
            ref.data_ptr(), src.data_ptr(), mats.data_ptr(), depth.data_ptr(), out.data_ptr(),
            b, v, d, h, w, c, int(ref.dtype == torch.bfloat16), cuda_build.stream_handle(dev))
    cuda_build.check_launch("variance_volume", rc)
    return out
