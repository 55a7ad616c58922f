"""x2 resizes and the nearest downsample over NCHW tensors, matching the
reference's `patchmatchnet_tpu/ops/resize.py` (which works on NHWC); the
resizes of [B, H, W] maps to any size that the estimator's resize back to
the original resolution uses, matching the reference estimator's
(`patchmatchnet_tpu/dataio/image.py` `resize_bilinear_np`,
`patchmatchnet_tpu/infer/depth.py` `_resize_nearest_np`)."""

from __future__ import annotations

import numpy as np
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


def _bilinear_axis(size_in: int, size_out: int):
    """Half-pixel source coordinates of one axis, in float64 and clamped to
    [0, size_in - 1] as the reference computes them: (lower index, upper
    index, f64 fraction)."""
    pos = (np.arange(size_out, dtype=np.float64) + 0.5) * (size_in / size_out) - 0.5
    pos = np.clip(pos, 0.0, size_in - 1.0)
    lo = np.floor(pos).astype(np.int64)
    return lo, np.minimum(lo + 1, size_in - 1), pos - lo


def resize_bilinear_maps(maps: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, H, W] float maps -> [B, height, width], bilinear with half-pixel
    centers; the reference's coordinates (float64, then the weights in the
    maps' dtype) and its order of operations, so the result is the
    reference's to the bit."""
    in_h, in_w = maps.shape[-2:]
    if (in_h, in_w) == (height, width):
        return maps
    dev, dtype = maps.device, maps.dtype
    y0, y1, wy = (torch.from_numpy(a).to(dev) for a in _bilinear_axis(in_h, height))
    x0, x1, wx = (torch.from_numpy(a).to(dev) for a in _bilinear_axis(in_w, width))
    wy, wx = wy.to(dtype)[:, None], wx.to(dtype)
    top = maps[:, y0][:, :, x0] * (1 - wx) + maps[:, y0][:, :, x1] * wx
    bot = maps[:, y1][:, :, x0] * (1 - wx) + maps[:, y1][:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def resize_nearest_maps(maps: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, H, W] maps -> [B, height, width], nearest: output pixel i takes
    input pixel i * in // out, in integers, as the reference does (float
    scales, as F.interpolate uses, pick another row at some sizes)."""
    in_h, in_w = maps.shape[-2:]
    if (in_h, in_w) == (height, width):
        return maps
    ys = torch.arange(height, device=maps.device) * in_h // height
    xs = torch.arange(width, device=maps.device) * in_w // width
    return maps[:, ys][:, :, xs]
