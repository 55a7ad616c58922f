"""CasMVSNet (Gu et al., "Cascade Cost Volume for High-Resolution Multi-View
Stereo and Stereo Matching", CVPR 2020; https://github.com/alibaba/cascade-stereo,
`CasMVSNet/models/cas_mvsnet.py` and `module.py`): inference at its
published settings.

An FPN FeatureNet of base 8 gives 32, 16 and 8 channels at 1/4, 1/2 and 1
of the image. Three stages follow, coarse to fine, each with its own 3D
U-Net (`share_cr=False`):
- stage 1 takes 48 planes spread evenly over [depth_min, depth_max];
- stages 2 and 3 take 32 and 8 planes about the previous stage's depth,
  upsampled bilinearly to the image, at 2 and 1 times the base interval
  (depth_max - depth_min) / 191, DTU's spacing of 192 planes;
- K8 (`ops.variance_volume`) builds the variance cost volume over the
  views [B, D, h, w, C];
- the CostRegNet turns it into one logit a plane, its head `prob` K9
  (`ops.prob_conv3d`); softmax over the planes and depth = sum p d.
The confidence is stage 3's probability of the 4 planes about the regressed
plane index.

Parameters are named as cascade-stereo's modules name them
(`feature.conv0.0.conv.weight`, `cost_regularization.0.conv0.bn.running_var`),
so a released state dict loads (`load_state_dict` drops BatchNorm's
`num_batches_tracked`, which the folded eval-mode BatchNorm does not use).

`compute_dtype=torch.bfloat16` runs the features, the variance volume and
the 3D convolutions in bf16 (cuDNN accumulates in f32); the hypotheses,
softmax, regression and confidence stay f32, and so do K9's weights and
logits on the card. The f32 mode turns TF32 off
for its duration. Inference only: the model is built in eval mode and K8
has no backward. Departures from the published code: K8's warp reads zero
for a point at or behind a source camera (pz <= 1e-3); stage 2's
hypotheses are taken about the 2x2 mean of the upsampled depth, which is
the published trilinear resize of the hypotheses, whose offsets are the
same at every pixel, to rounding.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from patchmatchnet_torch.models.layers import (
    ConvBnReLU,
    Conv3dBnReLU,
    Deconv3dBnReLU,
    conv2d,
)
from patchmatchnet_torch.models.net import full_f32
from patchmatchnet_torch.ops import prob_conv3d as head_op
from patchmatchnet_torch.ops import variance_volume as volume_op
from patchmatchnet_torch.ops.resize import upsample_nearest_x2
from patchmatchnet_torch.ops.warp import warp_proj_coeffs
from patchmatchnet_torch.utils.profiling import span

STAGES = (1, 2, 3)
NDEPTHS = (48, 32, 8)
DEPTH_INTERVAL_RATIO = (4.0, 2.0, 1.0)
BASE_DEPTHS = 192  # planes of the base interval over [depth_min, depth_max]
STAGE_SCALE = (0.25, 0.5, 1.0)  # of the image, and of the intrinsics
FEATURE_CHANNELS = (32, 16, 8)
SHAPE_MULTIPLE = 32  # stage 1 at 1/4, halved three times by the U-Net


class FeatureNet(nn.Module):
    """cascade-stereo's FPN FeatureNet (`arch_mode="fpn"`, base 8) over
    [B, 3, H, W] -> {1: 32 channels at 1/4, 2: 16 at 1/2, 3: 8 at 1}, NCHW
    in the input's memory format (channels last from the model)."""

    def __init__(self, base: int = 8, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dt = dtype
        self.conv0 = nn.Sequential(ConvBnReLU(3, base, 3, 1, 1, dtype=dt),
                                   ConvBnReLU(base, base, 3, 1, 1, dtype=dt))
        self.conv1 = nn.Sequential(ConvBnReLU(base, 2 * base, 5, 2, 2, dtype=dt),
                                   ConvBnReLU(2 * base, 2 * base, 3, 1, 1, dtype=dt),
                                   ConvBnReLU(2 * base, 2 * base, 3, 1, 1, dtype=dt))
        self.conv2 = nn.Sequential(ConvBnReLU(2 * base, 4 * base, 5, 2, 2, dtype=dt),
                                   ConvBnReLU(4 * base, 4 * base, 3, 1, 1, dtype=dt),
                                   ConvBnReLU(4 * base, 4 * base, 3, 1, 1, dtype=dt))
        self.out1 = nn.Conv2d(4 * base, 4 * base, 1, bias=False)
        self.inner1 = nn.Conv2d(2 * base, 4 * base, 1, bias=True)
        self.inner2 = nn.Conv2d(base, 4 * base, 1, bias=True)
        self.out2 = nn.Conv2d(4 * base, 2 * base, 3, padding=1, bias=False)
        self.out3 = nn.Conv2d(4 * base, base, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        dt = self.dtype
        conv0 = self.conv0(x)
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        out = {1: conv2d(self.out1, conv2, dt)}
        intra = upsample_nearest_x2(conv2) + conv2d(self.inner1, conv1, dt)
        out[2] = conv2d(self.out2, intra, dt)
        intra = upsample_nearest_x2(intra) + conv2d(self.inner2, conv0, dt)
        out[3] = conv2d(self.out3, intra, dt)
        return out


class CostRegNet(nn.Module):
    """cascade-stereo's 3D U-Net of base 8: [B, C, D, h, w] (D, h, w
    multiples of 8) -> logits [B, D, h, w] f32."""

    def __init__(self, in_channels: int, base: int = 8, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dt = dtype
        self.conv0 = Conv3dBnReLU(in_channels, base, dtype=dt)
        self.conv1 = Conv3dBnReLU(base, 2 * base, stride=2, dtype=dt)
        self.conv2 = Conv3dBnReLU(2 * base, 2 * base, dtype=dt)
        self.conv3 = Conv3dBnReLU(2 * base, 4 * base, stride=2, dtype=dt)
        self.conv4 = Conv3dBnReLU(4 * base, 4 * base, dtype=dt)
        self.conv5 = Conv3dBnReLU(4 * base, 8 * base, stride=2, dtype=dt)
        self.conv6 = Conv3dBnReLU(8 * base, 8 * base, dtype=dt)
        self.conv7 = Deconv3dBnReLU(8 * base, 4 * base, dtype=dt)
        self.conv9 = Deconv3dBnReLU(4 * base, 2 * base, dtype=dt)
        self.conv11 = Deconv3dBnReLU(2 * base, base, dtype=dt)
        self.prob = nn.Conv3d(base, 1, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        return head_op.prob_conv3d(x, self.prob.weight)


def confidence_of(prob: torch.Tensor) -> torch.Tensor:
    """The probability of the 4 planes about the regressed plane index of
    prob [B, D, H, W]: the index sum p i truncated and clamped to [0, D -
    1], the planes from one below it to two above."""
    d = prob.shape[1]
    padded = F.pad(prob, (0, 0, 0, 0, 1, 2))
    sum4 = sum(padded[:, i:i + d] for i in range(4))
    planes = torch.arange(d, dtype=prob.dtype, device=prob.device).view(1, d, 1, 1)
    index = (prob * planes).sum(1).long().clamp(0, d - 1)
    return torch.gather(sum4, 1, index[:, None])[:, 0]


class CasMVSNet(nn.Module):
    """The three-stage cascade at its published settings: NDEPTHS planes
    and DEPTH_INTERVAL_RATIO times the base interval a stage (stages coarse
    to fine); `compute_dtype` None runs f32, bf16 runs bf16 payloads. Built
    in eval mode."""

    def __init__(self, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.feature = FeatureNet(dtype=compute_dtype)
        self.cost_regularization = nn.ModuleList(
            CostRegNet(c, dtype=compute_dtype) for c in FEATURE_CHANNELS)
        self.eval()

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        state = {k: v for k, v in state_dict.items() if not k.endswith(".num_batches_tracked")}
        return super().load_state_dict(state, strict=strict, assign=assign)

    @staticmethod
    def noise_shape(batch: int, height: int, width: int) -> None:
        """None: CasMVSNet draws nothing at random."""

    def forward(self, images: torch.Tensor, intrinsics: torch.Tensor,
                extrinsics: torch.Tensor, depth_min: torch.Tensor, depth_max: torch.Tensor,
                init_noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Dict[int, Dict[str, torch.Tensor]]]:
        """Args as `PatchmatchNet.forward`'s: images [B, N, H, W, 3] (f32 or
        already in the compute dtype, view 0 the reference, H and W
        multiples of 32), intrinsics [B, N, 3, 3], extrinsics [B, N, 4, 4]
        world-to-camera, depth_min / depth_max [B]; `init_noise` is unused
        (CasMVSNet draws nothing at random).

        Returns (depth [B, H, W], confidence [B, H, W], {stage: {"depth":
        [B, h, w], "prob": [B, D, h, w], "hypotheses": [B, D, h, w]}}) for
        the stages 1-3 at 1/4, 1/2 and 1 of the image.
        """
        ctx = full_f32() if self.compute_dtype is None else contextlib.nullcontext()
        with ctx:
            return self._forward(images, intrinsics, extrinsics, depth_min, depth_max)

    def _forward(self, images, intrinsics, extrinsics, depth_min, depth_max):
        b, n, h, w = images.shape[:4]
        if h % SHAPE_MULTIPLE or w % SHAPE_MULTIPLE:
            raise ValueError(f"CasMVSNet needs H and W multiples of {SHAPE_MULTIPLE} (got "
                             f"{h}x{w}): its 3D U-Net halves stage 1's 1/4 resolution three "
                             "times")
        depth_min = depth_min.float().reshape(b)
        depth_max = depth_max.float().reshape(b)
        with span("pmn.cas.features"):
            nchw = images.reshape(b * n, h, w, 3).permute(0, 3, 1, 2)
            features = {}
            for stage, f in self.feature(nchw).items():
                f = f.permute(0, 2, 3, 1).reshape(b, n, *f.shape[2:], f.shape[1])
                features[stage] = (f[:, 0].contiguous(), f[:, 1:].contiguous())
        base = (depth_max - depth_min) / (BASE_DEPTHS - 1)
        outputs: Dict[int, Dict[str, torch.Tensor]] = {}
        depth = confidence = None
        for i, stage in enumerate(STAGES):
            name = f"pmn.cas.stage{stage}"
            with span(name):
                scale = STAGE_SCALE[i]
                k = intrinsics.float().clone()
                k[:, :, :2] *= scale
                proj = extrinsics.float().clone()
                proj[:, :, :3, :4] = torch.matmul(k, extrinsics[:, :, :3, :4].float())
                mats = warp_proj_coeffs(proj[:, 1:], proj[:, :1])  # [B, N - 1, 12]
                hyp = self._hypotheses(i, depth, depth_min, depth_max, base, h, w)
                ref, src = features[stage]
                with span(f"{name}.volume") as counters:
                    volume = volume_op.variance_volume(ref, src, mats, hyp)
                    counters.add(voxels=hyp.numel(), bytes=volume.nbytes)
                with span(f"{name}.regularize") as counters:
                    logits = self.cost_regularization[i](volume.permute(0, 4, 1, 2, 3))
                    counters.add(head_voxels=logits.numel() if head_op.uses_kernel(volume)
                                 else 0)
                with span(f"{name}.regress"):
                    prob = torch.softmax(logits, dim=1)
                    depth = (prob * hyp).sum(1)
                    if stage == STAGES[-1]:
                        confidence = confidence_of(prob)
                outputs[stage] = {"depth": depth, "prob": prob, "hypotheses": hyp}
        return depth, confidence, outputs

    def _hypotheses(self, i: int, depth: Optional[torch.Tensor], depth_min: torch.Tensor,
                    depth_max: torch.Tensor, base: torch.Tensor, h: int, w: int
                    ) -> torch.Tensor:
        """Stage i's planes [B, D, h, w] f32 at its resolution."""
        d = NDEPTHS[i]
        hs, ws = int(h * STAGE_SCALE[i]), int(w * STAGE_SCALE[i])
        planes = torch.arange(d, dtype=torch.float32, device=depth_min.device)
        if depth is None:
            interval = (depth_max - depth_min) / (d - 1)
            hyp = depth_min[:, None] + planes[None] * interval[:, None]
            return hyp[:, :, None, None].expand(-1, -1, hs, ws).contiguous()
        cur = F.interpolate(depth.detach()[:, None], size=(h, w), mode="bilinear",
                            align_corners=False)
        if (hs, ws) != (h, w):
            cur = F.avg_pool2d(cur, round(h / hs))
        cur = cur[:, 0]
        half = (d / 2 * DEPTH_INTERVAL_RATIO[i] * base)[:, None, None]
        low, high = cur - half, cur + half
        interval = (high - low) / (d - 1)
        return (low[:, None] + planes.view(1, d, 1, 1) * interval[:, None]).contiguous()

