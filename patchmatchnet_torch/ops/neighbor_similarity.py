"""K3: group correlation of the reference feature with itself sampled at the
learned eval-grid neighbours (the FeatureWeightNet input).

Replaces `patchmatchnet_tpu/ops/pallas/similarity_kernel.py` `_kernel` as
`models/patchmatch.py` `_feature_weight_corr` uses it: the Ke neighbours
sit in the depth slot, samples are align_corners=False with border
clamping. The CUDA kernel is `csrc/group_corr.cu`
(`pmn_neighbor_group_corr`), sharing K1's tap/correlate code with grid
coordinates; the [P, 4C] taps the TPU path gathers first never exist.
"""

from __future__ import annotations

from typing import Sequence

import torch

from patchmatchnet_torch.ops import cuda_build
from patchmatchnet_torch.ops.grid_sample import grid_sample_2d
from patchmatchnet_torch.ops.warp_similarity import (
    SUPPORTED_CHANNELS_GROUPS,
    group_mean_matrix,
)

_PAYLOAD_DTYPES = (torch.float32, torch.bfloat16)


def neighbor_group_corr_reference(
    ref: torch.Tensor, grid: Sequence[torch.Tensor], groups: int
) -> torch.Tensor:
    """Plain PyTorch version: `F.grid_sample` + einsum with the group-mean
    matrix. Same arguments and result as `neighbor_group_corr`."""
    c = ref.shape[-1]
    neighbors = grid_sample_2d(
        ref.float(), grid, align_corners=False, padding_mode="border"
    )  # [B, Ke, H, W, C]
    prod = neighbors * ref.float()[:, None]
    gm = group_mean_matrix(c, groups, ref.device)
    return torch.einsum("bkhwc,cg->bgkhw", prod, gm)


def neighbor_group_corr(
    ref: torch.Tensor, grid: Sequence[torch.Tensor], groups: int
) -> torch.Tensor:
    """Args:
        ref: [B, H, W, C] reference features (bf16 or f32).
        grid: (gx, gy), each [B, Ke, H, W] f32 normalized eval-grid
            coordinates (align_corners=False convention).
        groups: G, dividing C.
    Returns:
        [B, G, Ke, H, W] f32 correlation.

    CPU tensors run the plain version; CUDA tensors launch the kernel, and
    anything the kernel does not take raises.
    """
    if ref.device.type == "cpu":
        return neighbor_group_corr_reference(ref, grid, groups)
    gx, gy = grid
    b, h, w, c = ref.shape
    ke = gx.shape[1]
    if (c, groups) not in SUPPORTED_CHANNELS_GROUPS:
        raise ValueError(f"neighbor_group_corr: no kernel for C={c}, G={groups}")
    if h < 2 or w < 2:
        raise ValueError("neighbor_group_corr needs H, W >= 2")
    dev = ref.device
    check = cuda_build.check_cuda_tensor
    check("ref", ref, dev, _PAYLOAD_DTYPES, (b, h, w, c))
    check("gx", gx, dev, (torch.float32,), (b, ke, h, w))
    check("gy", gy, dev, (torch.float32,), (b, ke, h, w))
    out = torch.empty((b, groups, ke, h, w), dtype=torch.float32, device=dev)
    lib = cuda_build.kernel_library()
    with torch.cuda.device(dev):
        rc = lib.pmn_neighbor_group_corr(
            ref.data_ptr(), gx.data_ptr(), gy.data_ptr(), out.data_ptr(),
            b, ke, h, w, c, groups, int(ref.dtype == torch.bfloat16),
            cuda_build.stream_handle(dev),
        )
    cuda_build.check_launch("neighbor_group_corr", rc)
    return out
