"""A synthetic calibrated scene in the unified MVS layout, with known depth.

A textured fronto-parallel plane at z = PLANE_Z seen by N cameras with
identity rotation and x offsets of 0.35 between neighbours; the images are
photo-consistent samples of a smooth world texture, so every view's true
depth is PLANE_Z everywhere. It writes the same images, cams and pair.txt
as the test helper `tests/scene_utils.make_synthetic_scene` with PNG
images (depth range [0.8, 1.3] x PLANE_Z), and no depth_gt/ maps.
"""

from __future__ import annotations

import os

import numpy as np

from patchmatchnet_torch.data.codecs import save_cam_file, save_image, save_pair_file

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
    """Write images/*.png, cams/ and pair.txt under `root`."""
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "cams"), exist_ok=True)
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
    save_pair_file(os.path.join(root, "pair.txt"),
                   [(v, [(s, 10.0 - abs(s - v)) for s in range(num_views) if s != v])
                    for v in range(num_views)])
