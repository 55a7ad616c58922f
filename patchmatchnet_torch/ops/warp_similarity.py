"""K1: fused homography warp + bilinear sample + group correlation, and
its companions K6 (`warp_group_corr_views`, the view-weighted sum over all
source views) and K7 (`coord_group_corr`, K1 with given coordinates).

K1 replaces `patchmatchnet_tpu/ops/pallas/windowed_similarity.py` `_kernel_proj`
(API `windowed_group_similarity_proj`). The CUDA kernel is
`csrc/group_corr.cu` (`pmn_warp_group_corr`); its source note says what
bounds it on the card and how it is laid out.

    sim[b, g, d, y, x] = mean_{c in group g} ref[b, y, x, c] *
                         bilinear(src[b], warp(mat12[b], depth[b, d, y, x], x, y))[c]

with zeros padding, align_corners=True and the pz <= 1e-3 push. Payloads
(src, ref) may be bf16 or f32; every operation is f32.

Gradients flow to `src` and `ref` only: the warp coordinates carry none,
as the reference's warp grid is built under no_grad
(`windowed_similarity.py` `_wgsp_bwd`). On CUDA the backward is K4
(`csrc/group_corr_bwd.cu`, `pmn_warp_group_corr_backward`), replacing
`_kernel_proj_bwd`; on the CPU it is autograd through the plain version.
K4 merges the consecutive hypotheses of a pixel that sample one source
cell, so it reads that cell's taps and adds its terms to the source
gradient once; `k4_scatter_counts` counts the merged cells and the atomics.
K6 and K7 are forward only, as their TPU kernels are.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from patchmatchnet_torch.ops import cuda_build
from patchmatchnet_torch.ops.grid_sample import grid_sample_2d
from patchmatchnet_torch.ops.library import define_kernel_op
from patchmatchnet_torch.ops.warp import warp_coords

# (channels, groups) pairs the kernel is instantiated for: stages 1, 2, 3
SUPPORTED_CHANNELS_GROUPS = ((16, 4), (32, 8), (64, 8))
_PAYLOAD_DTYPES = (torch.float32, torch.bfloat16)


def group_mean_matrix(channels: int, groups: int, device=None) -> torch.Tensor:
    """[C, G] f32 block matrix: column g averages the channels of group g."""
    cg = channels // groups
    gm = torch.zeros(channels, groups, dtype=torch.float32, device=device)
    for g in range(groups):
        gm[g * cg : (g + 1) * cg, g] = 1.0 / cg
    return gm


def coord_group_corr_reference(
    src: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
    ref: torch.Tensor, groups: int,
) -> torch.Tensor:
    """Plain PyTorch version of K7: `F.grid_sample` + einsum with the
    group-mean matrix. Same arguments and result as `coord_group_corr`."""
    hs, ws, c = src.shape[1], src.shape[2], src.shape[3]
    gx = ix / ((ws - 1) / 2.0) - 1.0
    gy = iy / ((hs - 1) / 2.0) - 1.0
    warped = grid_sample_2d(
        src.float(), (gx, gy), align_corners=True, padding_mode="zeros"
    )  # [B, D, H, W, C]
    prod = warped * ref.float()[:, None]
    gm = group_mean_matrix(c, groups, src.device)
    return torch.einsum("bdhwc,cg->bgdhw", prod, gm)


def warp_group_corr_reference(
    src: torch.Tensor, mat12: torch.Tensor, depth: torch.Tensor,
    ref: torch.Tensor, groups: int,
) -> torch.Tensor:
    """Plain PyTorch version of K1: the warp coordinates, then K7's plain
    version. Same arguments and result as `warp_group_corr`."""
    ix, iy = warp_coords(mat12, depth, src.shape[1], src.shape[2])
    return coord_group_corr_reference(src, ix, iy, ref, groups)


def _check_inputs(src, mat12, depth, ref, groups):
    b, hs, ws, c = src.shape
    _, d, h, w = depth.shape
    if (c, groups) not in SUPPORTED_CHANNELS_GROUPS:
        raise ValueError(f"warp_group_corr: no kernel for C={c}, G={groups}")
    dev = src.device
    check = cuda_build.check_cuda_tensor
    check("src", src, dev, _PAYLOAD_DTYPES, (b, hs, ws, c))
    check("ref", ref, dev, (src.dtype,), (b, h, w, c))
    check("mat12", mat12, dev, (torch.float32,), (b, 12))
    check("depth", depth, dev, (torch.float32,), (b, d, h, w))
    return b, d, h, w, hs, ws, c


def _launch_forward(src, mat12, depth, ref, groups):
    b, d, h, w, hs, ws, c = _check_inputs(src, mat12, depth, ref, groups)
    dev = src.device
    out = torch.empty((b, groups, d, h, w), dtype=torch.float32, device=dev)
    lib = cuda_build.kernel_library()
    with torch.cuda.device(dev):
        rc = lib.pmn_warp_group_corr(
            src.data_ptr(), ref.data_ptr(), mat12.data_ptr(), depth.data_ptr(),
            out.data_ptr(), b, d, h, w, hs, ws, c, groups,
            int(src.dtype == torch.bfloat16), cuda_build.stream_handle(dev),
        )
    cuda_build.check_launch("warp_group_corr", rc)
    return out


def _similarity_like(src, mats, depth, ref, *rest):
    """The [B, G, D, H, W] f32 output of K1 and K6 (groups last)."""
    b, d, h, w = depth.shape
    return depth.new_empty((b, rest[-1], d, h, w))


# K1 as the operator `pmn::warp_group_corr` (ops/library.py), with K4 (or the
# plain backward on the CPU) as its gradient
_warp_group_corr_op = define_kernel_op(
    "warp_group_corr", "(Tensor src, Tensor mat12, Tensor depth, Tensor ref, int groups) -> Tensor",
    lambda *args: warp_group_corr_reference(*args).contiguous(), _launch_forward,
    _similarity_like)


def _warp_group_corr_setup(ctx, inputs, output):
    src, mat12, depth, ref, groups = inputs
    ctx.save_for_backward(src, mat12, depth, ref)
    ctx.groups = groups


def _warp_group_corr_grad(ctx, dout):
    """K4 (or its plain version): gradients to src and ref only."""
    src, mat12, depth, ref = ctx.saved_tensors
    d_src, d_ref = warp_group_corr_backward(src, mat12, depth, ref, ctx.groups,
                                            dout.contiguous())
    need = ctx.needs_input_grad
    return (d_src if need[0] else None, None, None, d_ref if need[3] else None, None)


torch.library.register_autograd(_warp_group_corr_op, _warp_group_corr_grad,
                                setup_context=_warp_group_corr_setup)


def warp_group_corr(
    src: torch.Tensor, mat12: torch.Tensor, depth: torch.Tensor,
    ref: torch.Tensor, groups: int,
) -> torch.Tensor:
    """Group-wise correlation of the reference feature with the source
    feature warped at every depth hypothesis.

    Args:
        src: [B, Hs, Ws, C] source-view features (bf16 or f32).
        mat12: [B, 12] f32 warp coefficients (`ops.warp.warp_proj_coeffs`).
        depth: [B, D, H, W] f32 depth hypotheses on the reference grid.
        ref: [B, H, W, C] reference features, same dtype as `src`.
        groups: G, dividing C.
    Returns:
        [B, G, D, H, W] f32 similarity volume, differentiable with respect
        to `src` and `ref` (never `mat12` or `depth`).

    It calls the operator `torch.ops.pmn.warp_group_corr`: CPU tensors
    run the plain version (and its autograd in backward); CUDA tensors
    launch the kernel (and K4 in backward), and anything the kernel does
    not take raises.
    """
    cuda_build.check_kernel_device("warp_group_corr", src.device)
    return _warp_group_corr_op(src, mat12.detach(), depth.detach(), ref, groups)


def warp_group_corr_backward_reference(
    src: torch.Tensor, mat12: torch.Tensor, depth: torch.Tensor,
    ref: torch.Tensor, groups: int, dout: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4: autograd through
    `warp_group_corr_reference` with depth and mat12 detached. Same
    arguments and result as `warp_group_corr_backward`."""
    with torch.enable_grad():
        s = src.detach().requires_grad_(True)
        r = ref.detach().requires_grad_(True)
        out = warp_group_corr_reference(s, mat12.detach(), depth.detach(), r, groups)
        d_src, d_ref = torch.autograd.grad(out, (s, r), dout)
    return d_src, d_ref


def warp_group_corr_backward(
    src: torch.Tensor, mat12: torch.Tensor, depth: torch.Tensor,
    ref: torch.Tensor, groups: int, dout: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cotangents (d_src [B, Hs, Ws, C], d_ref [B, H, W, C]), in the payload
    dtype, of `warp_group_corr` for the incoming `dout` [B, G, D, H, W] f32.

    CPU tensors run the plain version; CUDA tensors launch K4, and anything
    the kernel does not take raises.
    """
    if src.device.type == "cpu":
        return warp_group_corr_backward_reference(src, mat12, depth, ref, groups, dout)
    b, d, h, w, hs, ws, c = _check_inputs(src, mat12, depth, ref, groups)
    dev = src.device
    cuda_build.check_cuda_tensor("dout", dout, dev, (torch.float32,), (b, groups, d, h, w))
    # d_src sums the terms of many pixels with f32 atomics, then takes the
    # payload dtype; each pixel's d_ref is stored once, in the payload dtype
    d_src = torch.zeros((b, hs, ws, c), dtype=torch.float32, device=dev)
    d_ref = torch.empty((b, h, w, c), dtype=ref.dtype, device=dev)
    lib = cuda_build.kernel_library()
    with torch.cuda.device(dev):
        rc = lib.pmn_warp_group_corr_backward(
            src.data_ptr(), ref.data_ptr(), mat12.data_ptr(), depth.data_ptr(),
            dout.data_ptr(), d_src.data_ptr(), d_ref.data_ptr(), b, d, h, w, hs, ws, c,
            groups, int(src.dtype == torch.bfloat16), cuda_build.stream_handle(dev),
        )
    cuda_build.check_launch("warp_group_corr_backward", rc)
    return d_src.to(src.dtype), d_ref


def k4_scatter_counts(
    src: torch.Tensor, mat12: torch.Tensor, depth: torch.Tensor,
    ref: torch.Tensor, groups: int, dout: torch.Tensor,
) -> Dict[str, int]:
    """How K4 scatters d_src for its arguments (those of
    `warp_group_corr_backward`; `ref`, `groups` and `dout` are not read),
    from its samples' cells, in plain PyTorch on the arguments' device. K4
    walks each pixel's hypotheses in order and merges consecutive samples
    with a valid corner that fall in one cell (the same first pixel and
    valid corners); a merged cell reads its taps once and adds its terms to
    each valid corner once.
    - samples: samples with a valid corner;
    - merged_cells: merged cells;
    - global_atomics: 16-byte f32 atomics into d_src, C / 4 per valid corner
      of a merged cell;
    - parent_atomics: samples x 4 x C / 4, those of the design before (one
      per sample, corner and 4 channels; it skipped invalid corners).
    """
    b, hs, ws, c = src.shape
    _, d, h, w = depth.shape
    ix, iy = warp_coords(mat12, depth, hs, ws)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    x0v, x1v = (x0 >= 0) & (x0 <= ws - 1), (x0 >= -1) & (x0 <= ws - 2)
    y0v, y1v = (y0 >= 0) & (y0 <= hs - 1), (y0 >= -1) & (y0 <= hs - 2)
    valid = (x0v & y0v, x1v & y0v, x0v & y1v, x1v & y1v)  # corners in Taps order
    corners = sum(v.long() for v in valid)
    bits = sum(v.long() << t for t, v in enumerate(valid))
    x0 = torch.where(corners > 0, x0, 0.0).long()
    y0 = torch.where(corners > 0, y0, 0.0).long()
    cell = torch.where(corners > 0, ((y0 + 1) * (ws + 1) + x0 + 1) * 16 + bits, -1)
    last = torch.full_like(cell[:, 0], -1)
    added = n_merged = 0
    for j in range(d):
        new = (cell[:, j] >= 0) & (cell[:, j] != last)
        added += int((new * corners[:, j]).sum())
        n_merged += int(new.sum())
        last = torch.where(cell[:, j] >= 0, cell[:, j], last)
    return {
        "samples": int((corners > 0).sum()),
        "merged_cells": n_merged,
        "global_atomics": added * (c // 4),
        "parent_atomics": b * d * h * w * 4 * (c // 4),
    }


def _refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{name} has no backward (inference only, as in the reference): "
                         "call it under torch.no_grad() or on detached inputs")


def coord_group_corr(
    src: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
    ref: torch.Tensor, groups: int,
) -> torch.Tensor:
    """K7: K1 with the sample coordinates given instead of the warp.

    Replaces `windowed_similarity.py` `_kernel` (API
    `windowed_group_similarity`). The CUDA kernel is `csrc/group_corr.cu`
    (`pmn_coord_group_corr`): K1's tiled kernel reading the coordinates
    where K1 warps, with the cell picked by the code K1 runs after its warp,
    so `coord_group_corr(src, *warp_coords(...), ref, g)` equals
    `warp_group_corr(src, mat12, depth, ref, g)` to the bit.

    Args:
        src: [B, Hs, Ws, C] source features (bf16 or f32).
        ix, iy: [B, D, H, W] f32 source pixel coordinates (align_corners=True
            units, may be off the image, where the zeros padding reads 0).
        ref: [B, H, W, C] reference features, same dtype as `src`.
        groups: G, dividing C.
    Returns:
        [B, G, D, H, W] f32 similarity volume. No backward: raises when grad
        is enabled and an input requires it.

    CPU tensors run the plain version; CUDA tensors launch the kernel, and
    anything the kernel does not take raises.
    """
    _refuse_grad("coord_group_corr", src, ix, iy, ref)
    if src.device.type == "cpu":
        return coord_group_corr_reference(src, ix, iy, ref, groups)
    b, hs, ws, c = src.shape
    _, d, h, w = ix.shape
    if (c, groups) not in SUPPORTED_CHANNELS_GROUPS:
        raise ValueError(f"coord_group_corr: no kernel for C={c}, G={groups}")
    dev = src.device
    cuda_build.check_cuda_tensor("src", src, dev, _PAYLOAD_DTYPES, (b, hs, ws, c))
    cuda_build.check_cuda_tensor("ref", ref, dev, (src.dtype,), (b, h, w, c))
    cuda_build.check_cuda_tensor("ix", ix, dev, (torch.float32,), (b, d, h, w))
    cuda_build.check_cuda_tensor("iy", iy, dev, (torch.float32,), (b, d, h, w))
    out = torch.empty((b, groups, d, h, w), dtype=torch.float32, device=dev)
    lib = cuda_build.kernel_library()
    with torch.cuda.device(dev):
        rc = lib.pmn_coord_group_corr(
            src.data_ptr(), ref.data_ptr(), ix.data_ptr(), iy.data_ptr(), out.data_ptr(),
            b, d, h, w, hs, ws, c, groups, int(src.dtype == torch.bfloat16),
            cuda_build.stream_handle(dev),
        )
    cuda_build.check_launch("coord_group_corr", rc)
    return out


def warp_group_corr_views_reference(
    src: torch.Tensor, mats: torch.Tensor, depth: torch.Tensor,
    ref: torch.Tensor, view_weights: torch.Tensor, groups: int,
) -> torch.Tensor:
    """Plain PyTorch version of K6: K1's plain version per view, times its
    weights, added to a zeroed sum in view order. Same arguments and result
    as `warp_group_corr_views`."""
    b, _, h, w = view_weights.shape
    out = torch.zeros((b, groups, depth.shape[1], h, w), dtype=torch.float32,
                      device=src.device)
    for v in range(src.shape[1]):
        sim = warp_group_corr_reference(src[:, v], mats[:, v], depth, ref, groups)
        out = out + sim * view_weights[:, v, None, None]
    return out


def _launch_views(src: torch.Tensor, mats: torch.Tensor, depth: torch.Tensor,
                  ref: torch.Tensor, view_weights: torch.Tensor, groups: int) -> torch.Tensor:
    b, v, hs, ws, c = src.shape
    _, d, h, w = depth.shape
    if (c, groups) not in SUPPORTED_CHANNELS_GROUPS:
        raise ValueError(f"warp_group_corr_views: no kernel for C={c}, G={groups}")
    dev = src.device
    cuda_build.check_cuda_tensor("src", src, dev, _PAYLOAD_DTYPES, (b, v, hs, ws, c))
    cuda_build.check_cuda_tensor("ref", ref, dev, (src.dtype,), (b, h, w, c))
    cuda_build.check_cuda_tensor("mats", mats, dev, (torch.float32,), (b, v, 12))
    cuda_build.check_cuda_tensor("depth", depth, dev, (torch.float32,), (b, d, h, w))
    cuda_build.check_cuda_tensor("view_weights", view_weights, dev, (torch.float32,),
                                 (b, v, h, w))
    out = torch.empty((b, groups, d, h, w), dtype=torch.float32, device=dev)
    lib = cuda_build.kernel_library()
    with torch.cuda.device(dev):
        rc = lib.pmn_warp_group_corr_views(
            src.data_ptr(), ref.data_ptr(), mats.data_ptr(), depth.data_ptr(),
            view_weights.data_ptr(), out.data_ptr(), b, v, d, h, w, hs, ws, c, groups,
            int(src.dtype == torch.bfloat16), cuda_build.stream_handle(dev),
        )
    cuda_build.check_launch("warp_group_corr_views", rc)
    return out


# K6 as the operator `pmn::warp_group_corr_views` (ops/library.py)
_warp_group_corr_views_op = define_kernel_op(
    "warp_group_corr_views",
    "(Tensor src, Tensor mats, Tensor depth, Tensor ref, Tensor view_weights, int groups) "
    "-> Tensor",
    lambda *args: warp_group_corr_views_reference(*args).contiguous(), _launch_views,
    _similarity_like)


def warp_group_corr_views(
    src: torch.Tensor, mats: torch.Tensor, depth: torch.Tensor,
    ref: torch.Tensor, view_weights: torch.Tensor, groups: int,
) -> torch.Tensor:
    """K6: the view-weighted sum of K1 over all source views, in one kernel.

    Replaces `windowed_similarity.py` `_kernel_proj_views` (API
    `windowed_group_similarity_proj_views`). The CUDA kernel is
    `csrc/group_corr.cu` (`pmn_warp_group_corr_views`, K1's tiled kernel
    with the views looped inside each lane, staged 16 at a time, so any
    number of views); it rounds like the per-view route (K1 per view,
    `sim * vw`, then the sum in view order), so the two agree to the bit.

    Args:
        src: [B, V, Hs, Ws, C] stacked source-view features (bf16 or f32).
        mats: [B, V, 12] f32 warp coefficients (`ops.warp.warp_proj_coeffs`).
        depth: [B, D, H, W] f32 depth hypotheses, shared by the views.
        ref: [B, H, W, C] reference features, same dtype as `src`.
        view_weights: [B, V, H, W] f32 per-pixel view weights.
        groups: G, dividing C.
    Returns:
        [B, G, D, H, W] f32: sum_v view_weights[:, v] * similarity_v.
        Inference only, as in the reference: raises when grad is enabled
        and an input requires it.

    It calls the operator `torch.ops.pmn.warp_group_corr_views`: CPU
    tensors run the plain version; CUDA tensors launch the kernel, and
    anything the kernel does not take raises.
    """
    _refuse_grad("warp_group_corr_views", src, mats, depth, ref, view_weights)
    cuda_build.check_kernel_device("warp_group_corr_views", src.device)
    return _warp_group_corr_views_op(src, mats, depth, ref, view_weights, groups)
