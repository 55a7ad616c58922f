"""Homography warp geometry (reference: `patchmatchnet_tpu/ops/warp.py`).

All camera math is f32. The per-sample warp is ix = px / pz, iy = py / pz
with p = R [u, v, 1]^T * depth + t, where [R | t] = (src_proj @
inv(ref_proj))[:3, :4]; samples with pz <= 1e-3 (behind the source camera)
are pushed to (W, H) so the zeros-padded bilinear tap reads 0.
"""

from __future__ import annotations

from typing import Tuple

import torch


def warp_proj_coeffs(src_proj: torch.Tensor, ref_proj: torch.Tensor) -> torch.Tensor:
    """[..., 12] f32 row-major (src_proj @ inv(ref_proj))[..., :3, :4] for
    [..., 4, 4] projections. `inv_ex` skips the error check, which would
    synchronize with the device."""
    inv = torch.linalg.inv_ex(ref_proj.float()).inverse
    proj = torch.matmul(src_proj.float(), inv)
    return proj[..., :3, :4].reshape(*proj.shape[:-2], 12).contiguous()


def warp_coords(
    mat12: torch.Tensor, depth: torch.Tensor, src_height: int, src_width: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, 12] warp coefficients + [B, D, H, W] depth -> source pixel
    coordinates (ix, iy), each [B, D, H, W] f32 in align_corners=True units,
    unclamped (reference: windowed_similarity.py `_coords_from_depth`)."""
    b, _, h, w = depth.shape
    vv, uu = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=depth.device),
        torch.arange(w, dtype=torch.float32, device=depth.device),
        indexing="ij",
    )
    m = mat12.reshape(b, 12, 1, 1, 1)
    rx = m[:, 0] * uu + m[:, 1] * vv + m[:, 2]
    ry = m[:, 4] * uu + m[:, 5] * vv + m[:, 6]
    rz = m[:, 8] * uu + m[:, 9] * vv + m[:, 10]
    px = rx * depth + m[:, 3]
    py = ry * depth + m[:, 7]
    pz = rz * depth + m[:, 11]
    behind = pz <= 1e-3
    ix = torch.where(behind, torch.full_like(px, float(src_width)), px / pz)
    iy = torch.where(behind, torch.full_like(py, float(src_height)), py / pz)
    return ix, iy
