"""K3: group correlation of the reference feature with itself sampled at the
learned eval-grid neighbours (the FeatureWeightNet input).

Replaces `patchmatchnet_tpu/ops/pallas/similarity_kernel.py` `_kernel` as
`models/patchmatch.py` `_feature_weight_corr` uses it: the Ke neighbours
sit in the depth slot, samples are align_corners=False with border
clamping. The CUDA kernel is `csrc/group_corr.cu`
(`pmn_neighbor_group_corr`): K1's tiled kernel, `group_corr_tile_kernel`,
with each sample's cell taken from the eval grid by `border_taps`; the
[P, 4C] taps the TPU path gathers first never exist.

Gradients flow to the grid only. The reference detaches the feature it
feeds here (`patchmatch.py` `ref_sg`), so the wrapper raises when `ref`
requires grad rather than drop that gradient. On CUDA the backward is K5
(`csrc/group_corr_bwd.cu`, `pmn_neighbor_group_corr_backward`), replacing
`similarity_kernel.py` `_bwd_kernel`; on the CPU it is autograd through the
plain version.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from patchmatchnet_torch.ops import cuda_build
from patchmatchnet_torch.ops.grid_sample import grid_sample_2d
from patchmatchnet_torch.ops.library import define_kernel_op
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


def _check_inputs(ref, gx, gy, groups):
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
    return b, ke, h, w, c


def _launch_forward(ref: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                    groups: int) -> torch.Tensor:
    b, ke, h, w, c = _check_inputs(ref, gx, gy, groups)
    dev = ref.device
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


def _corr_like(ref, gx, gy, groups):
    b, ke, h, w = gx.shape
    return gx.new_empty((b, groups, ke, h, w))


# K3 as the operator `pmn::neighbor_group_corr` (ops/library.py), with K5 (or
# the plain backward on the CPU) as its gradient
_neighbor_group_corr_op = define_kernel_op(
    "neighbor_group_corr", "(Tensor ref, Tensor gx, Tensor gy, int groups) -> Tensor",
    lambda ref, gx, gy, groups: neighbor_group_corr_reference(ref, (gx, gy), groups)
    .contiguous(), _launch_forward, _corr_like)


def _neighbor_group_corr_setup(ctx, inputs, output):
    ref, gx, gy, groups = inputs
    ctx.save_for_backward(ref, gx, gy)
    ctx.groups = groups


def _neighbor_group_corr_grad(ctx, dout):
    """K5 (or its plain version): gradients to the grid only."""
    ref, gx, gy = ctx.saved_tensors
    d_gx, d_gy = neighbor_group_corr_backward(ref, (gx, gy), ctx.groups, dout.contiguous())
    return None, d_gx, d_gy, None


torch.library.register_autograd(_neighbor_group_corr_op, _neighbor_group_corr_grad,
                                setup_context=_neighbor_group_corr_setup)


def neighbor_group_corr(
    ref: torch.Tensor, grid: Sequence[torch.Tensor], groups: int
) -> torch.Tensor:
    """Args:
        ref: [B, H, W, C] reference features (bf16 or f32), not requiring
            grad (raises otherwise).
        grid: (gx, gy), each [B, Ke, H, W] f32 normalized eval-grid
            coordinates (align_corners=False convention).
        groups: G, dividing C.
    Returns:
        [B, G, Ke, H, W] f32 correlation, differentiable with respect to the
        grid.

    It calls the operator `torch.ops.pmn.neighbor_group_corr`: CPU tensors
    run the plain version (and its autograd in backward); CUDA tensors
    launch the kernel (and K5 in backward), and anything the kernel does
    not take raises.
    """
    if ref.requires_grad and torch.is_grad_enabled():
        raise ValueError("neighbor_group_corr: ref must be detached (the gradient "
                         "flows to the grid only, as in the reference)")
    cuda_build.check_kernel_device("neighbor_group_corr", ref.device)
    gx, gy = grid
    return _neighbor_group_corr_op(ref, gx, gy, groups)


def neighbor_group_corr_backward_reference(
    ref: torch.Tensor, grid: Sequence[torch.Tensor], groups: int, dout: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5: autograd through
    `neighbor_group_corr_reference` with respect to the grid. Same
    arguments and result as `neighbor_group_corr_backward`."""
    with torch.enable_grad():
        gx, gy = (g.detach().requires_grad_(True) for g in grid)
        out = neighbor_group_corr_reference(ref.detach(), (gx, gy), groups)
        return torch.autograd.grad(out, (gx, gy), dout)


def neighbor_group_corr_backward(
    ref: torch.Tensor, grid: Sequence[torch.Tensor], groups: int, dout: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cotangents (d_gx, d_gy), each [B, Ke, H, W] f32, of
    `neighbor_group_corr` for the incoming `dout` [B, G, Ke, H, W] f32.

    CPU tensors run the plain version; CUDA tensors launch K5, and anything
    the kernel does not take raises.
    """
    if ref.device.type == "cpu":
        return neighbor_group_corr_backward_reference(ref, grid, groups, dout)
    gx, gy = grid
    b, ke, h, w, c = _check_inputs(ref, gx, gy, groups)
    dev = ref.device
    cuda_build.check_cuda_tensor("dout", dout, dev, (torch.float32,), (b, groups, ke, h, w))
    d_gx = torch.empty((b, ke, h, w), dtype=torch.float32, device=dev)
    d_gy = torch.empty_like(d_gx)
    lib = cuda_build.kernel_library()
    with torch.cuda.device(dev):
        rc = lib.pmn_neighbor_group_corr_backward(
            ref.data_ptr(), gx.data_ptr(), gy.data_ptr(), dout.data_ptr(),
            d_gx.data_ptr(), d_gy.data_ptr(), b, ke, h, w, c, groups,
            int(ref.dtype == torch.bfloat16), cuda_build.stream_handle(dev),
        )
    cuda_build.check_launch("neighbor_group_corr_backward", rc)
    return d_gx, d_gy
