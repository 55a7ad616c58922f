"""A synthetic calibrated scene in the unified MVS layout, with known depth.

A textured fronto-parallel plane at z = PLANE_Z seen by N cameras with
identity rotation and x offsets of 0.35 between neighbours; the images are
photo-consistent samples of a smooth world texture, so every view's true
depth is PLANE_Z everywhere. It writes the same images, cams, pair.txt and
depth_gt/ maps as the test helper `tests/scene_utils.make_synthetic_scene`
with PNG images (depth range [0.8, 1.3] x PLANE_Z).
"""

from __future__ import annotations

import os

import numpy as np

from patchmatchnet_torch.data.codecs import save_cam_file, save_image, save_pair_file, save_pfm

PLANE_Z = 6.0


def world_texture(x: np.ndarray, y: np.ndarray, scale: float) -> np.ndarray:
    """Smooth RGB texture in [0, 1] over world XY; `scale` multiplies the
    spatial frequency."""
    x, y = scale * x, scale * y
    r = 0.5 + 0.45 * np.sin(3.1 * x) * np.cos(2.3 * y)
    g = 0.5 + 0.45 * np.sin(1.7 * x + 1.0) * np.sin(2.9 * y)
    b = 0.5 + 0.45 * np.cos(2.1 * x) * np.sin(1.3 * y + 0.5)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def make_synthetic_scene(root: str, num_views: int, height: int, width: int,
                         texture_scale: float = 1.0) -> None:
    """Write images/*.png, cams/, depth_gt/*.pfm and pair.txt under `root`."""
    for folder in ("images", "cams", "depth_gt"):
        os.makedirs(os.path.join(root, folder), exist_ok=True)
    f = 1.1 * max(height, width)
    k = np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]], dtype=np.float32)
    uu, vv = np.meshgrid(np.arange(width), np.arange(height))
    for v in range(num_views):
        e = np.eye(4, dtype=np.float32)
        e[0, 3] = 0.35 * (v - (num_views - 1) / 2.0)
        # back-project every pixel at the plane depth to world XY (R = I)
        xs = (uu - k[0, 2]) / k[0, 0] * PLANE_Z - e[0, 3]
        ys = (vv - k[1, 2]) / k[1, 1] * PLANE_Z - e[1, 3]
        save_image(os.path.join(root, "images", f"{v:08d}.png"),
                   world_texture(xs, ys, texture_scale))
        save_cam_file(os.path.join(root, "cams", f"{v:08d}_cam.txt"), k, e,
                      [0.8 * PLANE_Z, 1.3 * PLANE_Z])
        save_pfm(os.path.join(root, "depth_gt", f"{v:08d}.pfm"),
                 np.full((height, width), PLANE_Z, dtype=np.float32))
    save_pair_file(os.path.join(root, "pair.txt"),
                   [(v, [(s, 10.0 - abs(s - v)) for s in range(num_views) if s != v])
                    for v in range(num_views)])


def plane_batch(batch: int, views: int, height: int, width: int, seed: int = 0):
    """An in-memory training batch of textured fronto-parallel planes (depth
    6 + i for batch element i, texture scale 6): cameras with identity
    rotation at x offsets 0, +-0.35, +-0.7, ...; GT = the plane depth +
    N(0, 0.2) noise; 10% of the mask off; and the stage-3 noise
    [B, 48, H/8, W/8]. Arrays are numpy, keyed as a loader batch (+
    "noise")."""
    rng = np.random.default_rng(seed)
    f = 1.1 * max(height, width)
    k = np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]], np.float32)
    uu, vv = np.meshgrid(np.arange(width), np.arange(height))
    images = np.zeros((batch, views, height, width, 3), np.float32)
    extr = np.broadcast_to(np.eye(4, dtype=np.float32), (batch, views, 4, 4)).copy()
    gt = np.zeros((batch, height, width), np.float32)
    offsets = [0.0] + [0.35 * (1 if v % 2 else -1) * ((v + 1) // 2) for v in range(1, views)]
    for i in range(batch):
        z = PLANE_Z + i
        for v in range(views):
            extr[i, v, 0, 3] = offsets[v]
            xs = (uu - k[0, 2]) / k[0, 0] * z - offsets[v]
            ys = (vv - k[1, 2]) / k[1, 1] * z
            images[i, v] = world_texture(xs + 0.3 * i, ys, 6.0)
        gt[i] = z + 0.2 * rng.standard_normal((height, width))
    return {
        "images": images,
        "intrinsics": np.broadcast_to(k, (batch, views, 3, 3)).copy(),
        "extrinsics": extr,
        "depth_min": np.full(batch, 4.0, np.float32),
        "depth_max": np.full(batch, 10.0, np.float32),
        "depth_gt": gt,
        "mask": rng.random((batch, height, width)) > 0.1,
        "noise": rng.random((batch, 48, height // 8, width // 8), dtype=np.float32),
    }
