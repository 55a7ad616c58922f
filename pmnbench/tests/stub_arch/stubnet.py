"""A stand-in program of a second architecture, for the benchmark's tests:
a plane-sweep depth network in plain PyTorch (the program under test of
the stub architecture `pmnbench/archs/stub.py`, beside which a test copies
it into a copy of the benchmark).

Features at a quarter of the resolution (two stride-2 3x3 convolutions),
each source view's features warped onto `depths` fronto-parallel planes
between the request's depth range, the group correlation with the
reference averaged over the sources, a 3x3 convolution over the cost,
softmax over the planes, depth regressed from them and confidence the
largest probability; both maps upsampled to the input's size. No random
input: the same request gives the same maps.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def plane_grid(intrinsics, extrinsics, view, depths, height, width, scale):
    """Sampling grid [B, D*h, w, 2] (in [-1, 1]) of source view `view` for
    every reference pixel of an (h, w) = (height // scale, width // scale)
    grid at each plane depth [B, D]."""
    b, d = depths.shape
    h, w = height // scale, width // scale
    k = intrinsics.clone()
    k[:, :, :2] = k[:, :, :2] / scale
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=depths.device),
                            torch.arange(w, dtype=torch.float32, device=depths.device),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=0).reshape(3, -1)  # [3, hw]
    rays = torch.linalg.inv(k[:, 0]) @ pix  # [B, 3, hw]
    points = rays[:, :, None, :] * depths[:, None, :, None]  # [B, 3, D, hw], reference camera
    rel = extrinsics[:, view] @ torch.linalg.inv(extrinsics[:, 0])  # reference -> source
    cam = rel[:, :3, :3] @ points.reshape(b, 3, -1) + rel[:, :3, 3:]
    uv = k[:, view] @ cam
    u = uv[:, 0] / uv[:, 2].clamp(min=1e-6)
    v = uv[:, 1] / uv[:, 2].clamp(min=1e-6)
    grid = torch.stack([2 * u / (w - 1) - 1, 2 * v / (h - 1) - 1], dim=-1)
    return grid.reshape(b, d * h, w, 2)


class PlaneSweepNet(nn.Module):
    def __init__(self, channels: int, depths: int):
        super().__init__()
        self.depths = depths
        self.conv0 = nn.Conv2d(3, channels, 3, 2, 1)
        self.conv1 = nn.Conv2d(channels, channels, 3, 2, 1)
        self.cost = nn.Conv2d(depths, depths, 3, 1, 1)

    def forward(self, images, intrinsics, extrinsics, depth_min, depth_max
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, v, height, width, _ = images.shape
        x = images.permute(0, 1, 4, 2, 3).reshape(b * v, 3, height, width)
        feats = self.conv1(F.relu(self.conv0(x)))
        c, h, w = feats.shape[1:]
        feats = feats.reshape(b, v, c, h, w)
        steps = torch.linspace(0.0, 1.0, self.depths, device=images.device)
        depths = depth_min[:, None] + (depth_max - depth_min)[:, None] * steps  # [B, D]
        cost = 0
        for view in range(1, v):
            grid = plane_grid(intrinsics, extrinsics, view, depths, height, width, 4)
            warped = F.grid_sample(feats[:, view], grid, mode="bilinear",
                                   padding_mode="zeros", align_corners=True)
            warped = warped.reshape(b, c, self.depths, h, w)
            cost = cost + (warped * feats[:, 0, :, None]).mean(dim=1)
        prob = torch.softmax(self.cost(cost / (v - 1)), dim=1)
        depth = (prob * depths[:, :, None, None]).sum(dim=1, keepdim=True)
        confidence = prob.max(dim=1, keepdim=True).values
        depth = F.interpolate(depth, size=(height, width), mode="bilinear", align_corners=False)
        confidence = F.interpolate(confidence, size=(height, width), mode="nearest")
        return depth[:, 0], confidence[:, 0]


class Estimator:
    """A request's numpy depth and confidence maps."""

    def __init__(self, model: PlaneSweepNet, device: torch.device):
        self.model, self.device = model.to(device).eval(), device

    @torch.inference_mode()
    def __call__(self, batch: Dict[str, Any], generator) -> Tuple[np.ndarray, np.ndarray]:
        t = {k: torch.as_tensor(np.asarray(batch[k], np.float32), device=self.device)
             for k in ("images", "intrinsics", "extrinsics", "depth_min", "depth_max")}
        depth, confidence = self.model(t["images"], t["intrinsics"], t["extrinsics"],
                                       t["depth_min"], t["depth_max"])
        return depth.cpu().numpy(), confidence.cpu().numpy()


def train_step(model, optimizer, batch: Dict[str, torch.Tensor], lr: float
               ) -> Dict[str, torch.Tensor]:
    """One Adam step on the smooth-L1 gap to the ground truth inside the
    mask (the mean over the masked pixels)."""
    model.train()
    for group in optimizer.param_groups:
        group["lr"] = lr
    depth, _ = model(batch["images"], batch["intrinsics"], batch["extrinsics"],
                     batch["depth_min"], batch["depth_max"])
    mask = batch["mask"].float()
    loss = (F.smooth_l1_loss(depth, batch["depth_gt"], reduction="none") * mask).sum() \
        / mask.sum().clamp(min=1.0)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return {"loss": loss.detach()}
