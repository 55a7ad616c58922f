"""FPN-style multi-scale feature extractor (reference:
`patchmatchnet_tpu/models/feature.py`, its plain conv path).

11 ConvBnReLU layers down to 1/2, 1/4, 1/8 with lateral 1x1 connections:
{1: 16ch@1/2, 2: 32ch@1/4, 3: 64ch@1/8}. Tensors are NCHW; the caller
passes them in `torch.channels_last` memory format (a permuted NHWC
tensor), which the convolutions keep, so every output is also an NHWC
buffer whose pixels hold their C channels contiguously, as the kernels
read them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from patchmatchnet_torch.models.layers import ConvBnReLU, conv2d
from patchmatchnet_torch.ops.resize import upsample_bilinear_x2


class FeatureNet(nn.Module):
    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dt = dtype
        self.conv0 = ConvBnReLU(3, 8, 3, 1, 1, dtype=dt)
        self.conv1 = ConvBnReLU(8, 8, 3, 1, 1, dtype=dt)
        self.conv2 = ConvBnReLU(8, 16, 5, 2, 2, dtype=dt)
        self.conv3 = ConvBnReLU(16, 16, 3, 1, 1, dtype=dt)
        self.conv4 = ConvBnReLU(16, 16, 3, 1, 1, dtype=dt)
        self.conv5 = ConvBnReLU(16, 32, 5, 2, 2, dtype=dt)
        self.conv6 = ConvBnReLU(32, 32, 3, 1, 1, dtype=dt)
        self.conv7 = ConvBnReLU(32, 32, 3, 1, 1, dtype=dt)
        self.conv8 = ConvBnReLU(32, 64, 5, 2, 2, dtype=dt)
        self.conv9 = ConvBnReLU(64, 64, 3, 1, 1, dtype=dt)
        self.conv10 = ConvBnReLU(64, 64, 3, 1, 1, dtype=dt)
        self.output1 = nn.Conv2d(64, 64, 1, bias=False)
        self.inner1 = nn.Conv2d(32, 64, 1, bias=True)
        self.inner2 = nn.Conv2d(16, 64, 1, bias=True)
        self.output2 = nn.Conv2d(64, 32, 1, bias=False)
        self.output3 = nn.Conv2d(64, 16, 1, bias=False)

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        """x: [B, 3, H, W] -> {stage: [B, C, H / 2^stage, W / 2^stage]}."""
        dt = self.dtype
        conv1 = self.conv1(self.conv0(x))
        conv4 = self.conv4(self.conv3(self.conv2(conv1)))
        conv7 = self.conv7(self.conv6(self.conv5(conv4)))
        conv10 = self.conv10(self.conv9(self.conv8(conv7)))
        out = {3: conv2d(self.output1, conv10, dt)}
        intra = upsample_bilinear_x2(conv10) + conv2d(self.inner1, conv7, dt)
        out[2] = conv2d(self.output2, intra, dt)
        intra = upsample_bilinear_x2(intra) + conv2d(self.inner2, conv4, dt)
        out[1] = conv2d(self.output3, intra, dt)
        return out
