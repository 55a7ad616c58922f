"""PatchmatchNet forward: FeatureNet -> PatchMatch stages 3, 2, 1 ->
Refinement -> photometric confidence, and the training loss (reference:
`patchmatchnet_tpu/models/net.py`, `PatchmatchNet.__call__` and
`patchmatchnet_loss`).

`model.eval()` is the inference forward (`train=False` in the reference).
`model.train()` is the training forward (`train=True`): BatchNorm on batch
statistics, FeatureNet called once per view (so each view has its own
statistics and its own running-statistics update, as in the reference), no
gradient between stages, and zero confidence.

`compute_dtype=torch.bfloat16` runs the feature and correlation payloads in
bf16 while geometry, softmax, regression and the refinement residual stay
f32, at the same cast points as the reference's `compute_dtype`. The f32
mode (`compute_dtype=None`) turns TF32 off for its duration, so cuDNN runs
its convolutions in full f32 as the reference does.

Every inference evaluation after stage 3's first makes one K6 launch over
all source views, the reference's PATCHMATCHNET_TPU_FUSED_VIEWS=1 path (see
`patchmatch.Evaluation`); it gives the per-view route's result to the bit.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from patchmatchnet_torch.config import ModelConfig
from patchmatchnet_torch.models.feature import FeatureNet
from patchmatchnet_torch.models.patchmatch import INITIAL_NUM_SAMPLES, PatchMatch, stage_configs
from patchmatchnet_torch.models.refinement import Refinement
from patchmatchnet_torch.ops.resize import upsample_nearest_x2
from patchmatchnet_torch.utils.profiling import span

STAGE_SPANS = {stage: f"pmn.stage{stage}" for stage in (3, 2, 1)}


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """Turn TF32 off for cuDNN convolutions and CUDA matmuls, restoring the
    previous settings on exit."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


class PatchmatchNet(nn.Module):
    """The cascade with the per-stage options of `model_config` (its six
    per-stage tuples; its precision fields are read by
    `train.driver.build_model`), the released model's
    (`patchmatch.STAGE_CONFIG`) when None; `compute_dtype` None runs f32,
    bf16 runs bf16 payloads. It is built in eval (inference) mode;
    `.train()` selects the training forward."""

    def __init__(self, model_config: Optional[ModelConfig] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.feature = FeatureNet(dtype=compute_dtype)
        for stage, cfg in stage_configs(model_config).items():
            self.add_module(f"patchmatch_{stage}", PatchMatch(stage, cfg, dtype=compute_dtype))
        self.upsample_net = Refinement(dtype=compute_dtype)
        self.eval()

    @staticmethod
    def noise_shape(batch: int, height: int, width: int) -> Tuple[int, int, int, int]:
        """The stage-3 noise of `batch` maps of height x width: [B, 48, H/8, W/8]."""
        return (batch, INITIAL_NUM_SAMPLES, height // 8, width // 8)

    def forward(
        self,
        images: torch.Tensor,
        intrinsics: torch.Tensor,
        extrinsics: torch.Tensor,
        depth_min: torch.Tensor,
        depth_max: torch.Tensor,
        init_noise: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[int, List[torch.Tensor]]]:
        """Args:
            images: [B, N, H, W, 3] f32 or already in the compute dtype,
                view 0 the reference; H, W multiples of 8.
            intrinsics: [B, N, 3, 3] at this resolution; extrinsics
                [B, N, 4, 4] world-to-camera.
            depth_min / depth_max: [B] scene depth range.
            init_noise: [B, 48, H/8, W/8] (`noise_shape`) uniform noise for
                the stage-3 initialization.

        Returns (refined depth [B, H, W], photometric confidence [B, H, W],
        {stage: [per-iteration depths]}) with stage 0 the refined depth.
        """
        ctx = full_f32() if self.compute_dtype is None else contextlib.nullcontext()
        with ctx:
            return self._forward(images, intrinsics, extrinsics, depth_min,
                                 depth_max, init_noise)

    def _forward(self, images, intrinsics, extrinsics, depth_min, depth_max, init_noise):
        b, n, h, w = images.shape[:4]
        if h % 8 or w % 8:
            raise ValueError(f"PatchmatchNet needs H, W multiples of 8 (got {h}x{w})")
        depth_min = depth_min.float().reshape(b)
        depth_max = depth_max.float().reshape(b)

        # Step 1: features as NHWC buffers (channels_last convs), one list
        # of N views [B, h, w, C] per stage.
        features: Dict[int, List[torch.Tensor]] = {s: [] for s in (1, 2, 3)}
        src_stacks: Dict[int, torch.Tensor] = {}  # [B, N-1, h, w, C] for K6
        with span("pmn.features"):
            if self.training:
                # one call per view: per-view batch statistics (reference:
                # net.py:120-123)
                for v in range(n):
                    view = images[:, v].contiguous().permute(0, 3, 1, 2)
                    for s, f in self.feature(view).items():
                        features[s].append(f.permute(0, 2, 3, 1).contiguous())
            else:
                # running statistics: all views in one batch
                nchw = images.reshape(b * n, h, w, 3).permute(0, 3, 1, 2)
                for s, f in self.feature(nchw).items():
                    f = f.permute(0, 2, 3, 1).reshape(b, n, *f.shape[2:], f.shape[1])
                    features[s] = [f[:, v].contiguous() for v in range(n)]
                    src_stacks[s] = f[:, 1:].contiguous()  # no copy when B = 1

        # Step 2: per-stage projection matrices (K scaled per level).
        projs: Dict[int, torch.Tensor] = {}
        scale = 0.125
        for stage in (3, 2, 1):
            k_scaled = intrinsics.float().clone()
            k_scaled[:, :, :2] *= scale
            proj = extrinsics.float().clone()
            proj[:, :, :3, :4] = torch.matmul(k_scaled, extrinsics[:, :, :3, :4].float())
            projs[stage] = proj
            scale *= 2.0

        depth = view_weights = score = None
        depth_patchmatch: Dict[int, List[torch.Tensor]] = {}
        for stage in (3, 2, 1):
            with span(STAGE_SPANS[stage]):
                feats = features[stage]
                depths, score, view_weights = getattr(self, f"patchmatch_{stage}")(
                    ref_feature=feats[0],
                    src_features=feats[1:],
                    ref_proj=projs[stage][:, 0],
                    src_projs=[projs[stage][:, v] for v in range(1, n)],
                    depth_min=depth_min,
                    depth_max=depth_max,
                    depth=depth,
                    view_weights=view_weights,
                    init_noise=init_noise if stage == 3 else None,
                    src_stack=src_stacks.get(stage),
                )
                depth_patchmatch[stage] = depths
                depth = depths[-1].detach()  # no gradient between stages
                if stage > 1:
                    depth = upsample_nearest_x2(depth[:, None])[:, 0]
                    view_weights = upsample_nearest_x2(view_weights)

        # Step 3: refinement to full resolution.
        with span("pmn.refine"):
            depth = self.upsample_net(images[:, 0].permute(0, 3, 1, 2), depth,
                                      depth_min, depth_max)
        depth_patchmatch[0] = [depth]
        if self.training:
            return depth, torch.zeros_like(depth), depth_patchmatch
        with span("pmn.confidence"):
            confidence = self._confidence(score)
        return depth, confidence, depth_patchmatch

    def _confidence(self, score: torch.Tensor) -> torch.Tensor:
        """Probability mass of the 4 hypotheses around the regressed index of
        the final stage-1 score [B, H/2, W/2, D] -> [B, H, W]."""
        num_depth = self.patchmatch_1.config.num_samples
        padded = F.pad(score, (1, 2))
        score_sum4 = sum(padded[..., i : i + num_depth] for i in range(4))
        index = (torch.arange(num_depth, dtype=score.dtype, device=score.device) * score).sum(-1)
        index = index.to(torch.int64).clamp(0, num_depth - 1)
        confidence = torch.gather(score_sum4, -1, index[..., None])  # [B, H/2, W/2, 1]
        return upsample_nearest_x2(confidence.permute(0, 3, 1, 2))[:, 0]


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 (beta 1), as `F.smooth_l1_loss(reduction="none")`."""
    diff = (pred - target).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def patchmatchnet_loss(
    depth_patchmatch: Dict[int, List[torch.Tensor]],
    depth_gt: Sequence[torch.Tensor],
    mask: Sequence[torch.Tensor],
    group: Optional[dist.ProcessGroup] = None,
) -> torch.Tensor:
    """Masked smooth-L1 summed over every iteration of every stage
    (reference: net.py `patchmatchnet_loss`).

    Args:
        depth_patchmatch: {stage: [depths [B, H_s, W_s]]}, stages 0..3.
        depth_gt / mask: per-stage GT pyramid, each [B, H_s, W_s] (mask
            boolean), stage 0 at full resolution.
        group: data-parallel ranks holding the rest of the global batch.
            Each stage's masked sum is then divided by the global batch's
            mask count (one all-reduce of the four counts), so the ranks'
            losses sum to the loss of the global batch.
    """
    masks = [m.float() for m in mask]
    counts = torch.stack([m.sum() for m in masks])
    if group is not None:
        dist.all_reduce(counts, group=group)
    counts = counts.clamp(min=1.0)
    loss = torch.zeros((), dtype=torch.float32, device=depth_gt[0].device)
    for i in range(4):
        for depth in depth_patchmatch[i]:
            loss = loss + (smooth_l1_loss(depth, depth_gt[i]) * masks[i]).sum() / counts[i]
    return loss
