"""Geometric-consistency math of depth fusion on torch tensors (reference:
`patchmatchnet_tpu/geometry/fusion_math.py`, after eval.py:86-190 of the
original PatchmatchNet).

Reference pixels are projected into each source view, the source depth is
sampled bilinearly there (the cv2.remap INTER_LINEAR convention: pixel
coordinates, each of the four taps zeroed on its own outside the image),
projected back, and compared by reprojection distance and relative depth.
The functions take a leading V axis of source views, so one reference view
is one pass over all its sources, on the device its depth map lies on.

The 3x3 and 4x4 algebra (inverses and products of the cameras) runs on the
host in float32 and the per-pixel work on the device, as element-wise f32
multiply-adds in the reference's order: no product of the geometry goes
through a matmul, so none can run in TF32, and every device starts from
the same matrices.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def _host(m: torch.Tensor) -> torch.Tensor:
    return m.detach().to("cpu", torch.float32)


def _pixel_grid(height: int, width: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y) pixel coordinates, each [H, W] float32."""
    y, x = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=device),
                          torch.arange(width, dtype=torch.float32, device=device),
                          indexing="ij")
    return x, y


def _apply(m: torch.Tensor, v: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The rows of m @ v for m [..., R, len(v)], or of m @ [v; 1] for m
    [..., R, len(v) + 1]; the leading axes of m broadcast against the
    maps' leading axis (a [V, R, C] m against [V, H, W] or [H, W] maps)."""
    m = m[..., None, None]  # [..., R, C, 1, 1]
    rows = []
    for i in range(m.shape[-4]):
        acc = m[..., i, 0, :, :] * v[0]
        for j in range(1, len(v)):
            acc = acc + m[..., i, j, :, :] * v[j]
        if m.shape[-3] == len(v) + 1:
            acc = acc + m[..., i, len(v), :, :]
        rows.append(acc)
    return rows


def _sample_bilinear_pixel(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample img [V, Hs, Ws] at pixel coordinates x, y [V, H, W]: bilinear,
    each tap zeroed outside the image (cv2.remap INTER_LINEAR with a zero
    constant border). A tap's validity is decided on its float corner, so
    NaN, infinite or huge coordinates give invalid taps on every device
    (an integer cast of them is not portable)."""
    v, h, w = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    flat = img.reshape(-1)
    base = (torch.arange(v, device=img.device) * (h * w))[:, None, None]

    def tap(yf, xf):
        valid = (xf >= 0) & (xf <= w - 1) & (yf >= 0) & (yf <= h - 1)
        xi = torch.nan_to_num(xf).clamp(0, w - 1).long()
        yi = torch.nan_to_num(yf).clamp(0, h - 1).long()
        return flat[base + yi * w + xi] * valid.to(img.dtype)

    return (tap(y0, x0) * (1 - wx) * (1 - wy)
            + tap(y0, x0 + 1) * wx * (1 - wy)
            + tap(y0 + 1, x0) * (1 - wx) * wy
            + tap(y0 + 1, x0 + 1) * wx * wy)


def reproject_with_depth(
    depth_ref: torch.Tensor,
    intrinsics_ref: torch.Tensor,
    extrinsics_ref: torch.Tensor,
    depth_src: torch.Tensor,
    intrinsics_src: torch.Tensor,
    extrinsics_src: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference -> source -> reference round trip for V source views.

    Args: depth_ref [H, W], intrinsics_ref [3, 3], extrinsics_ref [4, 4];
    depth_src [V, Hs, Ws], intrinsics_src [V, 3, 3], extrinsics_src
    [V, 4, 4]. The depth maps lie on one device; the cameras anywhere.
    Returns (depth_reprojected, x_reprojected, y_reprojected), each
    [V, H, W], on the depth maps' device.
    """
    dev = depth_ref.device
    k_ref, e_ref, k_src, e_src = (_host(m) for m in (intrinsics_ref, extrinsics_ref,
                                                     intrinsics_src, extrinsics_src))
    k_ref_inv, k_src_inv = torch.linalg.inv(k_ref), torch.linalg.inv(k_src)
    rel = (e_src @ torch.linalg.inv(e_ref))[:, :3]  # [V, 3, 4]
    rel_back = (e_ref @ torch.linalg.inv(e_src))[:, :3]
    k_ref, k_src, k_ref_inv, k_src_inv, rel, rel_back = (
        m.to(dev) for m in (k_ref, k_src, k_ref_inv, k_src_inv, rel, rel_back))

    x_ref, y_ref = _pixel_grid(*depth_ref.shape, dev)
    # reference pixels -> reference camera -> source camera -> source pixels
    xyz_ref = _apply(k_ref_inv, (x_ref * depth_ref, y_ref * depth_ref, depth_ref))
    xyz_src = _apply(rel, xyz_ref)
    k_xyz_src = _apply(k_src, xyz_src)
    x_src, y_src = k_xyz_src[0] / k_xyz_src[2], k_xyz_src[1] / k_xyz_src[2]

    sampled = _sample_bilinear_pixel(depth_src, x_src, y_src)
    # back to the reference view with the sampled source depth
    xyz_src2 = _apply(k_src_inv, (x_src * sampled, y_src * sampled, sampled))
    xyz_reproj = _apply(rel_back, xyz_src2)
    k_xyz_reproj = _apply(k_ref, xyz_reproj)
    return (xyz_reproj[2], k_xyz_reproj[0] / k_xyz_reproj[2],
            k_xyz_reproj[1] / k_xyz_reproj[2])


def check_geometric_consistency(
    depth_ref: torch.Tensor,
    intrinsics_ref: torch.Tensor,
    extrinsics_ref: torch.Tensor,
    depth_src: torch.Tensor,
    intrinsics_src: torch.Tensor,
    extrinsics_src: torch.Tensor,
    geo_pixel_thres: float,
    geo_depth_thres: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixels of the reference consistent with each of V source views, and
    their reprojected depths (arguments as `reproject_with_depth`). Returns
    (mask [V, H, W] bool, depth_reprojected [V, H, W] zeroed where the mask
    is false)."""
    depth_reproj, x2d, y2d = reproject_with_depth(
        depth_ref, intrinsics_ref, extrinsics_ref, depth_src, intrinsics_src, extrinsics_src)
    x_ref, y_ref = _pixel_grid(*depth_ref.shape, depth_ref.device)
    dx, dy = x2d - x_ref, y2d - y_ref
    dist = torch.sqrt(dx * dx + dy * dy)
    relative = torch.abs(depth_reproj - depth_ref) / depth_ref
    mask = (dist < geo_pixel_thres) & (relative < geo_depth_thres)
    return mask, torch.where(mask, depth_reproj, torch.zeros_like(depth_reproj))


def backproject_to_world(depth: torch.Tensor, intrinsics: torch.Tensor,
                         extrinsics: torch.Tensor) -> torch.Tensor:
    """World coordinates [H, W, 3] of every pixel of a depth map [H, W]."""
    dev = depth.device
    k_inv = torch.linalg.inv(_host(intrinsics)).to(dev)
    cam_to_world = torch.linalg.inv(_host(extrinsics))[:3].to(dev)
    x, y = _pixel_grid(*depth.shape, dev)
    xyz_cam = _apply(k_inv, (x * depth, y * depth, depth))
    return torch.stack(_apply(cam_to_world, xyz_cam), dim=-1)
