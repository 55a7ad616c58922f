"""x2 resizes over NCHW tensors, matching the reference's
`patchmatchnet_tpu/ops/resize.py` (which works on NHWC)."""

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
