"""A small stand-in for PatchmatchNet in data-parallel tests (reference:
`patchmatchnet_tpu/parallel/dryrun.py`).

`DryRunModel` has PatchmatchNet's call signature and output structure
(depth, confidence and the per-stage depth dict that `patchmatchnet_loss`
reads) with a conv, a port BatchNorm, a conv and the stage-3 noise input,
so the train step, the loss, sync-BN, `replicate` and the driver run
unchanged around a per-rank graph that costs next to nothing. Its module
names are the flax stand-in's (`conv0`, `bn0`, `conv1`), so
`compat.state_dict_from_jax` carries that model's variables across.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from patchmatchnet_torch.models.layers import BatchNorm


class DryRunModel(nn.Module):
    """(images [B, N, H, W, 3], intrinsics, extrinsics, depth_min [B],
    depth_max [B], init_noise [B, 48, H/8, W/8]) -> (depth [B, H, W],
    confidence [B, H, W], {stage i: [depth at 1/2^i]}). In train mode it
    adds 1e-6 x the noise's first hypothesis (as the flax stand-in adds
    1e-6 x its own draw), nearest-upsampled."""

    compute_dtype = None

    def __init__(self, features: int = 8):
        super().__init__()
        self.conv0 = nn.Conv2d(3, features, 3, padding=1)
        self.bn0 = BatchNorm(features)
        self.conv1 = nn.Conv2d(features, 1, 3, padding=1)

    def forward(self, images: torch.Tensor, intrinsics: torch.Tensor,
                extrinsics: torch.Tensor, depth_min: torch.Tensor, depth_max: torch.Tensor,
                init_noise: Optional[torch.Tensor] = None):
        b, _, h, w, _ = images.shape
        x = self.conv1(F.relu(self.bn0(self.conv0(images[:, 0].permute(0, 3, 1, 2)))))
        if self.training and init_noise is not None:
            x = x + 1e-6 * F.interpolate(init_noise[:, :1], size=(h, w), mode="nearest")
        # every geometry input reaches the output, as in the real model
        geom = 0.0 * (intrinsics.mean() + extrinsics.mean())
        d0 = x[:, 0] + 0.5 * (depth_min + depth_max)[:, None, None] + geom
        # 1/f nearest as jax.image.resize takes it: pixel f * i + f // 2
        dp = {i: [d0[:, 2**i // 2::2**i, 2**i // 2::2**i]] for i in range(4)}
        return dp[0][-1], torch.ones_like(d0), dp
