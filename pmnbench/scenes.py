"""Seeded multi-view scenes with known depth, made on the device.

A scene is a textured height field Z = g(X, Y) in the reference camera's
frame: a tilted plane with a smooth step and a bump, seen by the reference
camera (identity pose) and by source cameras on a ring around it, each
turned to look at the scene's centre. Each view's pixel is rendered by
casting its ray against the height field (a fixed-point iteration on Z),
and coloured by a sum of sinusoids over the surface, with periods of a few
to tens of pixels, so that every scale has texture to match. The
reference view's Z along its rays is the ground-truth depth.

Every number is drawn from one `torch.Generator` on the device in a few
large calls, so a seed gives the same scenes, and every seed gives scenes
of the same sizes: only their content changes.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

WAVES = 24  # sinusoids of the texture
FIXED_POINT_STEPS = 16


def _look_at(center: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """World-to-camera rotations [S, 3, 3] of cameras at `center` [S, 3]
    looking at `target` [S, 3], image y down."""
    z = target - center
    z = z / z.norm(dim=-1, keepdim=True)
    down = torch.tensor([0.0, 1.0, 0.0], device=center.device).expand_as(z)
    x = torch.cross(down, z, dim=-1)
    x = x / x.norm(dim=-1, keepdim=True)
    y = torch.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=1)


def make_scenes(generator: torch.Generator, count: int, traffic: Dict[str, Any]
                ) -> Dict[str, torch.Tensor]:
    """`count` scenes of `traffic`'s shape ("views", "height", "width",
    "depth_range", "baseline_deg", "focal", "texture_period_px",
    "texture_exponent": a wave's amplitude goes as its period to that power,
    1 for the 1/f spectrum of natural images): images
    [S, V, H, W, 3] in [0, 1], intrinsics [S, V, 3, 3], extrinsics
    [S, V, 4, 4] world-to-camera, depth_min / depth_max [S], depth_gt
    [S, H, W] and mask [S, H, W] (GT inside the depth range), all f32 (the
    mask bool) on the generator's device."""
    dev = generator.device
    v, h, w = traffic["views"], traffic["height"], traffic["width"]
    dmin, dmax = (float(x) for x in traffic["depth_range"])
    lo_deg, hi_deg = (float(x) for x in traffic["baseline_deg"])
    p_lo, p_hi = (float(x) for x in traffic["texture_period_px"])
    focal = float(traffic["focal"]) * max(h, w)

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    s = count
    # scene: centre depth, plane slopes, step (height, direction, offset), bump
    u = rand(s, 10)
    zc = 0.5 * (dmin + dmax) * (0.95 + 0.1 * u[:, 0])
    sx, sy = 0.5 * (u[:, 1] - 0.5), 0.5 * (u[:, 2] - 0.5)
    step_h = 0.16 * (u[:, 3] - 0.5)
    step_dir = 2 * math.pi * u[:, 4]
    step_at = 0.3 * (u[:, 5] - 0.5)
    bump_h = 0.2 * (u[:, 6] - 0.5)
    bump_x, bump_y = 0.4 * (u[:, 7] - 0.5), 0.3 * (u[:, 8] - 0.5)
    ring_phase = 2 * math.pi * u[:, 9]

    def height(x, y):  # world X, Y [S, ...] -> Z
        shape = (s,) + (1,) * (x.dim() - 1)
        c = zc.view(shape)
        a, b = x / c, y / c
        along = a * torch.cos(step_dir).view(shape) + b * torch.sin(step_dir).view(shape)
        z = (1 + sx.view(shape) * a + sy.view(shape) * b
             + step_h.view(shape) * torch.sigmoid((along - step_at.view(shape)) / 0.03)
             + bump_h.view(shape) * torch.exp(-((a - bump_x.view(shape)) ** 2
                                                + (b - bump_y.view(shape)) ** 2) / 0.02))
        return c * z

    # cameras: the reference at the origin, sources on a ring, each looking
    # at the scene's centre from an angle in the baseline range
    k = torch.tensor([[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1]], device=dev)
    intrinsics = k.expand(s, v, 3, 3).contiguous()
    extrinsics = torch.eye(4, device=dev).repeat(s, v, 1, 1)
    cam = rand(s, max(v - 1, 1), 2)
    target = torch.stack([torch.zeros_like(zc), torch.zeros_like(zc), zc], dim=-1)
    for i in range(1, v):
        angle = math.radians(1.0) * (lo_deg + (hi_deg - lo_deg) * cam[:, i - 1, 0])
        around = ring_phase + 2 * math.pi * (i - 1) / (v - 1) + 0.5 * (cam[:, i - 1, 1] - 0.5)
        radius = zc * torch.tan(angle)
        center = torch.stack([radius * torch.cos(around), radius * torch.sin(around),
                              torch.zeros_like(zc)], dim=-1)
        rot = _look_at(center, target)
        extrinsics[:, i, :3, :3] = rot
        extrinsics[:, i, :3, 3] = -(rot @ center[:, :, None])[:, :, 0]

    # texture: WAVES sinusoids over the surface (X / zc, Y / zc)
    wave = rand(s, WAVES, 6)
    period = p_lo * (p_hi / p_lo) ** wave[..., 0] / focal  # in units of X / zc
    theta = math.pi * wave[..., 1]
    freq_a = 2 * math.pi * torch.cos(theta) / period
    freq_b = 2 * math.pi * torch.sin(theta) / period
    phase = 2 * math.pi * wave[..., 2]
    colour = wave[..., 3:6] - 0.5  # [S, WAVES, 3]
    amp = (period * focal / p_hi) ** float(traffic["texture_exponent"])
    amp = amp / amp.sum(dim=1, keepdim=True) * 4.0

    yy, xx = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32), indexing="ij")
    pix = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)  # [H, W, 3]
    images = torch.empty((s, v, h, w, 3), device=dev)
    depth_gt = None
    kinv = torch.linalg.inv(k)
    for i in range(v):
        rot = extrinsics[:, i, :3, :3]
        center = -(rot.transpose(1, 2) @ extrinsics[:, i, :3, 3:4])[:, :, 0]  # [S, 3]
        ray = torch.einsum("sji,hwj->shwi", rot, pix @ kinv.T)  # world directions, R^T K^-1 p
        cx, cy, cz = (center[:, j].view(s, 1, 1) for j in range(3))
        z = zc.view(s, 1, 1).expand(s, h, w)
        for _ in range(FIXED_POINT_STEPS):
            t = (z - cz) / ray[..., 2]
            z = height(cx + t * ray[..., 0], cy + t * ray[..., 1])
        t = (z - cz) / ray[..., 2]
        a = (cx + t * ray[..., 0]) / zc.view(s, 1, 1)
        b = (cy + t * ray[..., 1]) / zc.view(s, 1, 1)
        img = torch.zeros((s, h, w, 3), device=dev)
        for j in range(WAVES):
            arg = (freq_a[:, j].view(s, 1, 1) * a + freq_b[:, j].view(s, 1, 1) * b
                   + phase[:, j].view(s, 1, 1))
            img += (amp[:, j].view(s, 1, 1) * torch.sin(arg))[..., None] * colour[:, j].view(
                s, 1, 1, 3)
        images[:, i] = (0.5 + 0.5 * torch.tanh(img)).clamp(0.0, 1.0)
        if i == 0:
            depth_gt = z
    return {
        "images": images,
        "intrinsics": intrinsics,
        "extrinsics": extrinsics,
        "depth_min": torch.full((s,), dmin, device=dev),
        "depth_max": torch.full((s,), dmax, device=dev),
        "depth_gt": depth_gt,
        "mask": (depth_gt > dmin) & (depth_gt < dmax),
    }
