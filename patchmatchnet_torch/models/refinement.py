"""Depth refinement: upsample the 1/2-res depth to full resolution with a
learned residual guided by the reference image (reference:
`patchmatchnet_tpu/models/refinement.py`).

The compute dtype applies to the conv branches only; depth normalization,
the residual add and denormalization stay f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from patchmatchnet_torch.models.layers import BatchNorm, ConvBnReLU, conv2d
from patchmatchnet_torch.ops.resize import upsample_nearest_x2


class Refinement(nn.Module):
    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv0 = ConvBnReLU(3, 8, dtype=dtype)  # image branch
        self.conv1 = ConvBnReLU(1, 8, dtype=dtype)  # depth branch
        self.conv2 = ConvBnReLU(8, 8, dtype=dtype)
        # torch ConvTranspose2d(k=3, s=2, p=1, output_padding=1): exactly 2x
        self.deconv = nn.ConvTranspose2d(8, 8, 3, stride=2, padding=1,
                                         output_padding=1, bias=False)
        self.bn = BatchNorm(8)
        self.conv3 = ConvBnReLU(16, 8, dtype=dtype)
        self.res = nn.Conv2d(8, 1, 3, padding=1, bias=False)

    def forward(self, img: torch.Tensor, depth_0: torch.Tensor,
                depth_min: torch.Tensor, depth_max: torch.Tensor) -> torch.Tensor:
        """img [B, 3, H, W], depth_0 [B, H/2, W/2], depth_min/max [B]
        -> refined depth [B, H, W] f32."""
        dmin = depth_min.reshape(-1, 1, 1)
        dmax = depth_max.reshape(-1, 1, 1)
        depth = ((depth_0 - dmin) / (dmax - dmin))[:, None]  # [B, 1, H/2, W/2]

        conv0 = self.conv0(img)
        x = self.conv2(self.conv1(depth))
        x = F.conv_transpose2d(x, self.deconv.weight.to(x.dtype), stride=2,
                               padding=1, output_padding=1)
        deconv = F.relu(self.bn(x))
        # channel order matches the reference cat((deconv, conv0))
        cat = torch.cat([deconv, conv0], dim=1)
        res = conv2d(self.res, self.conv3(cat), self.dtype).float()  # [B, 1, H, W]
        depth = upsample_nearest_x2(depth) + res
        return depth[:, 0] * (dmax - dmin) + dmin
