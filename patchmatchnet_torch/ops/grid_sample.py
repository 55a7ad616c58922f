"""Bilinear grid sampling over NHWC features through `F.grid_sample`.

The two conventions of the reference (`patchmatchnet_tpu/ops/grid_sample.py`):
- homography warp: align_corners=True, zeros padding;
- learned-offset neighbour sampling: align_corners=False, border padding.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

Grid = Union[torch.Tensor, Sequence[torch.Tensor]]


def grid_sample_2d(
    image: torch.Tensor, grid: Grid, *, align_corners: bool, padding_mode: str
) -> torch.Tensor:
    """Sample `image` [B, H, W, C] at normalized coordinates.

    `grid` is a (gx, gy) pair of [B, ...] tensors or a stacked [B, ..., 2]
    tensor, as in the reference. Returns [B, ..., C] in the grid's dtype
    (f32): bilinear weights and accumulation stay f32 for bf16 payloads.
    """
    b, _, _, c = image.shape
    if isinstance(grid, (tuple, list)):
        gx, gy = grid
        out_shape = tuple(gx.shape) + (c,)
        xy = torch.stack([gx.reshape(b, -1), gy.reshape(b, -1)], dim=-1)
    else:
        out_shape = tuple(grid.shape[:-1]) + (c,)
        xy = grid.reshape(b, -1, 2)
    inp = image.permute(0, 3, 1, 2).to(xy.dtype)
    out = F.grid_sample(
        inp, xy[:, :, None, :], mode="bilinear",
        padding_mode=padding_mode, align_corners=align_corners,
    )  # [B, C, P, 1]
    return out[..., 0].transpose(1, 2).reshape(out_shape)
