"""x2 resizes and the nearest downsample over NCHW tensors, matching the
reference's `patchmatchnet_tpu/ops/resize.py` (which works on NHWC)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_nearest_x2(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of [B, C, H, W]."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def upsample_bilinear_x2(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of [B, C, H, W] with half-pixel centers
    (align_corners=False)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def downsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """1/factor nearest downsample over the last two dims (pixel i takes
    input pixel i * factor, the reference's `x[:, ::f, ::f]`)."""
    return x[..., ::factor, ::factor]
