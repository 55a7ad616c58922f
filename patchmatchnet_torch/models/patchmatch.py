"""Learned PatchMatch stage: initialization, adaptive propagation, adaptive
evaluation with group-wise correlation and pixel-wise view weighting
(reference: `patchmatchnet_tpu/models/patchmatch.py`).

Layouts at the public functions follow the reference:
- features:          [B, H, W, C] (contiguous NHWC; NCHW channels_last views
                     for the convolutions)
- depth hypotheses:  [B, D, H, W]
- similarity volume: [B, G, D, H, W]
- sampling grids:    (gx, gy), each [B, K, H, W] normalized
- scores:            [B, H, W, D]
One difference: view weights are channel-first [B, V, H, W] (the reference
keeps [B, H, W, V]); they are only passed between stages.

The evaluation runs four kernels, in f32 and bf16 modes alike: K3
`neighbor_group_corr` on a stage's first iteration, K2 `eval_grid_score`
for the aggregation tail, and for the similarity volume either K1
`warp_group_corr` per source view or, in an inference evaluation whose view
weights are already known (every call after stage 3's first), one K6
`warp_group_corr_views` launch for all source views (the reference's
PATCHMATCHNET_TPU_FUSED_VIEWS=1 path). K6 rounds like the per-view route,
so the result is the same; it has no backward, so a forward that records
gradients (train mode, or eval mode with grad enabled) takes K1.

Train mode (`module.train()`) places the reference's stop-gradients: the
perturbation centre, x_norm and the depth weight carry none; K1 passes
gradients to the features only (K4 backward), K3 to the eval grid only (K5
backward, on the detached reference feature); the returned view weights are
detached while the first evaluation's own weights keep their gradient; and
the aggregation tail is the plain `eval_grid_score_reference`, as the
reference's training tail is plain XLA.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from patchmatchnet_torch.config import ModelConfig
from patchmatchnet_torch.models.layers import Conv2d, Dense1, DenseBnReLU, cast
from patchmatchnet_torch.ops.eval_tail import eval_grid_score, eval_grid_score_reference
from patchmatchnet_torch.ops.grid_sample import grid_sample_2d
from patchmatchnet_torch.ops.neighbor_similarity import neighbor_group_corr
from patchmatchnet_torch.ops.warp import warp_proj_coeffs
from patchmatchnet_torch.ops.warp_similarity import warp_group_corr, warp_group_corr_views

INITIAL_NUM_SAMPLES = 48  # stratified random inverse-depth samples on stage 3
STAGE_FEATURES = {1: 16, 2: 32, 3: 64}  # feature channels C of each stage
STAGE_GROUPS = {1: 4, 2: 8, 3: 8}  # correlation groups G of each stage


class StageConfig(NamedTuple):
    interval_scale: float  # perturbation step, fraction of the inverse-depth range
    propagation_range: int  # dilation of the offset convs and neighbour grids
    iterations: int
    num_samples: int  # hypotheses per pixel after the first stage-3 iteration
    propagate_neighbors: int  # 0: no propagation; else 4, 8 or 16
    evaluate_neighbors: int  # eval-grid neighbours Ke: 9 or 17
    features: int  # feature channels C
    groups: int  # correlation groups G


def stage_configs(model_config: Optional[ModelConfig] = None) -> Dict[int, StageConfig]:
    """The three stages' settings from the per-stage tuples of a
    `config.ModelConfig` (indexed stage 1, 2, 3, as the command line's
    flags); None gives the released model's (`STAGE_CONFIG`)."""
    m = model_config or ModelConfig()
    options = (m.patchmatch_interval_scale, m.propagation_range, m.patchmatch_iteration,
               m.patchmatch_num_sample, m.propagate_neighbors, m.evaluate_neighbors)
    if any(len(values) != 3 for values in options):
        raise ValueError(f"each per-stage option takes 3 values (stages 1, 2, 3): {m}")
    return {stage: StageConfig(float(m.patchmatch_interval_scale[stage - 1]),
                               *(int(values[stage - 1]) for values in options[1:]),
                               STAGE_FEATURES[stage], STAGE_GROUPS[stage])
            for stage in (1, 2, 3)}


# The released model's stages (checkpoints/params_000007.msgpack; the
# reference's defaults, patchmatchnet_tpu/models/net.py).
STAGE_CONFIG = stage_configs()

Grid = Tuple[torch.Tensor, torch.Tensor]


def init_random_depth(noise: torch.Tensor, depth_min: torch.Tensor,
                      depth_max: torch.Tensor) -> torch.Tensor:
    """Stage-3 first-iteration samples, stratified in inverse depth.
    noise [B, D, H, W] uniform [0, 1), depth_min/max [B] -> [B, D, H, W]."""
    b, d = noise.shape[:2]
    inv_min = (1.0 / depth_min).reshape(b, 1, 1, 1)
    inv_max = (1.0 / depth_max).reshape(b, 1, 1, 1)
    strata = noise + torch.arange(d, dtype=noise.dtype, device=noise.device).reshape(1, d, 1, 1)
    inv_sample = inv_max + strata / d * (inv_min - inv_max)
    return 1.0 / inv_sample


def init_perturbed_depth(depth: torch.Tensor, depth_min: torch.Tensor,
                         depth_max: torch.Tensor, num_samples: int,
                         interval_scale: float) -> torch.Tensor:
    """Perturbation around the previous depth [B, H, W], uniform in inverse
    depth and clamped to the scene range -> [B, num_samples, H, W]."""
    b = depth.shape[0]
    inv_min = (1.0 / depth_min).reshape(b, 1, 1, 1)
    inv_max = (1.0 / depth_max).reshape(b, 1, 1, 1)
    offsets = torch.arange(-(num_samples // 2), num_samples // 2,
                           dtype=depth.dtype, device=depth.device)
    inv_interval = (inv_min - inv_max) * interval_scale
    inv_sample = (1.0 / depth.detach()[:, None]
                  + inv_interval * offsets.reshape(1, num_samples, 1, 1))
    inv_sample = torch.clamp(inv_sample, inv_max, inv_min)
    return 1.0 / inv_sample


def propagate(depth_sample: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Sample the middle hypothesis at the learned propagation neighbours
    (border, align_corners=False), append, and sort ascending.
    depth_sample [B, D, H, W] -> [B, D + Kp, H, W]."""
    middle = depth_sample[:, depth_sample.shape[1] // 2, :, :, None]  # [B, H, W, 1]
    prop = grid_sample_2d(middle, grid, align_corners=False, padding_mode="border")[..., 0]
    return torch.sort(torch.cat([depth_sample, prop], dim=1), dim=1).values


def propagation_offsets(neighbors: int, dilation: int) -> List[Tuple[int, int]]:
    """(y, x) offsets of the propagation neighbours at `dilation`: the 4
    of a cross, the 8 of a ring, or for 16 the ring and the same ring at
    twice the dilation (reference: `_fixed_offsets`)."""
    if neighbors == 4:
        return [(-dilation, 0), (0, -dilation), (0, dilation), (dilation, 0)]
    if neighbors not in (8, 16):
        raise NotImplementedError(f"propagate_neighbors={neighbors}")
    ring = [(y, x) for y in (-dilation, 0, dilation) for x in (-dilation, 0, dilation)
            if (y, x) != (0, 0)]
    return ring if neighbors == 8 else ring + [(2 * y, 2 * x) for (y, x) in ring]


def evaluation_offsets(dilation: int, neighbors: int = 9) -> List[Tuple[int, int]]:
    """(y, x) offsets of the evaluation neighbours: the 3x3 pattern at one
    less than the propagation dilation, and for 17 its 8 non-centre
    offsets doubled after it (reference: `_fixed_offsets`)."""
    if neighbors not in (9, 17):
        raise NotImplementedError(f"evaluate_neighbors={neighbors}")
    d = dilation - 1
    square = [(y, x) for y in (-d, 0, d) for x in (-d, 0, d)]
    if neighbors == 9:
        return square
    return square + [(2 * y, 2 * x) for (y, x) in square if (y, x) != (0, 0)]


def build_offset_grid(offset: torch.Tensor, fixed: Sequence[Tuple[int, int]],
                      height: int, width: int) -> Grid:
    """Fixed neighbour offsets plus learned per-pixel offsets
    [B, H, W, 2K] (channel 2k = x, 2k+1 = y) -> normalized (gx, gy), each
    [B, K, H, W]. Normalized with the align_corners=True convention but
    sampled with align_corners=False, as in the reference."""
    b, k = offset.shape[0], len(fixed)
    dev = offset.device
    y, x = torch.meshgrid(torch.arange(height, dtype=offset.dtype, device=dev),
                          torch.arange(width, dtype=offset.dtype, device=dev),
                          indexing="ij")
    off = offset.reshape(b, height, width, k, 2)
    fixed_x = torch.tensor([fx for (_, fx) in fixed], dtype=offset.dtype, device=dev)
    fixed_y = torch.tensor([fy for (fy, _) in fixed], dtype=offset.dtype, device=dev)
    ax = x[None, :, :, None] + fixed_x + off[..., 0]
    ay = y[None, :, :, None] + fixed_y + off[..., 1]
    gx = ax / ((width - 1) / 2.0) - 1.0
    gy = ay / ((height - 1) / 2.0) - 1.0
    return gx.permute(0, 3, 1, 2).contiguous(), gy.permute(0, 3, 1, 2).contiguous()


class PixelwiseNet(nn.Module):
    """Per-source-view visibility weight from the similarity volume."""

    def __init__(self, groups: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv0 = DenseBnReLU(groups, 16, dtype=dtype)
        self.conv1 = DenseBnReLU(16, 8, dtype=dtype)
        self.conv2 = Dense1(8, 1, dtype=dtype)

    def forward(self, similarity: torch.Tensor) -> torch.Tensor:
        """[B, G, D, H, W] -> [B, H, W] f32 (max over D of the sigmoid)."""
        x = self.conv2(self.conv1(self.conv0(similarity)))  # [B, 1, D, H, W]
        return torch.sigmoid(x[:, 0].float()).amax(dim=1)


class SimilarityNet(nn.Module):
    """Per-hypothesis matching cost from the aggregated similarity volume."""

    def __init__(self, groups: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv0 = DenseBnReLU(groups, 16, dtype=dtype)
        self.conv1 = DenseBnReLU(16, 8, dtype=dtype)
        self.similarity = Dense1(8, 1, dtype=dtype)

    def forward(self, x1: torch.Tensor) -> torch.Tensor:
        """[B, G, D, H, W] -> cost [B, H, W, D] in the compute dtype."""
        cost = self.similarity(self.conv1(self.conv0(x1)))[:, 0]  # [B, D, H, W]
        return cost.permute(0, 2, 3, 1).contiguous()


class FeatureWeightNet(nn.Module):
    """Adaptive-aggregation feature weights from the group correlation of
    the reference feature with its eval-grid neighbours."""

    def __init__(self, groups: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv0 = DenseBnReLU(groups, 16, dtype=dtype)
        self.conv1 = DenseBnReLU(16, 8, dtype=dtype)
        self.similarity = Dense1(8, 1, dtype=dtype)

    def forward(self, corr: torch.Tensor) -> torch.Tensor:
        """corr [B, G, Ke, H, W] -> [B, Ke, H, W] f32."""
        out = self.similarity(self.conv1(self.conv0(corr)))  # [B, 1, Ke, H, W]
        return torch.sigmoid(out[:, 0].float())


class Evaluation(nn.Module):
    """Warp each source view at every hypothesis, correlate group-wise,
    weight by per-view visibility, aggregate over the eval grid and regress
    depth. The pixel-wise view-weight net exists on stage 3 only: later
    stages reuse its upsampled weights."""

    def __init__(self, groups: int, pixel_wise: bool, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.groups = groups
        self.dtype = dtype
        if pixel_wise:
            self.pixel_wise_net = PixelwiseNet(groups, dtype)
        self.similarity_net = SimilarityNet(groups, dtype)
        self.feature_weight_net = FeatureWeightNet(groups, dtype)

    def forward(
        self,
        ref_feature: torch.Tensor,
        src_features: Sequence[torch.Tensor],
        warp_mats: Sequence[torch.Tensor],
        depth_sample: torch.Tensor,
        grid: Grid,
        x_norm_img: torch.Tensor,
        feature_weight: Optional[torch.Tensor],
        interval_scale: float,
        view_weights: Optional[torch.Tensor],
        is_inverse: bool,
        src_stack: Optional[torch.Tensor] = None,
        mats: Optional[torch.Tensor] = None,
    ):
        """`src_stack` [B, V, Hs, Ws, C] and `mats` [B, V, 12] are the source
        features and warp coefficients stacked for K6; an inference call
        that is given view weights needs them.
        Returns (depth [B, H, W], score [B, H, W, D] f32,
        view_weights [B, V, H, W], feature_weight [B, Ke, H, W])."""
        b, h, w, _ = ref_feature.shape
        num_depth = depth_sample.shape[1]
        # views accumulate in f32 even when the features are bf16
        similarity_sum = torch.zeros((b, self.groups, num_depth, h, w),
                                     dtype=torch.float32, device=ref_feature.device)
        weight_sum = torch.full((b, 1, 1, 1, 1), 1e-5, dtype=torch.float32,
                                device=ref_feature.device)
        new_view_weights: List[torch.Tensor] = []
        if view_weights is not None and not self.training and not torch.is_grad_enabled():
            # one K6 launch for all views (reference: patchmatch.py:426-459);
            # the weight sum in the per-view loop's order
            if src_stack is None or mats is None:
                raise ValueError("an inference evaluation with view weights needs src_stack "
                                 "and mats")
            similarity_sum = warp_group_corr_views(src_stack, mats, depth_sample, ref_feature,
                                                   view_weights, self.groups)
            for i in range(view_weights.shape[1]):
                weight_sum = weight_sum + view_weights[:, i, None, None]
        else:
            for i, (src, mat12) in enumerate(zip(src_features, warp_mats)):
                similarity = warp_group_corr(src, mat12, depth_sample, ref_feature,
                                             self.groups)  # [B, G, D, H, W] f32
                if view_weights is None:
                    view_weight = self.pixel_wise_net(similarity)  # [B, H, W]
                    new_view_weights.append(view_weight)
                else:
                    view_weight = view_weights[:, i]
                vw = view_weight[:, None, None]  # [B, 1, 1, H, W]
                similarity_sum = similarity_sum + similarity * vw
                weight_sum = weight_sum + vw
        similarity = cast(similarity_sum / weight_sum, self.dtype)
        cost_img = self.similarity_net(similarity)  # [B, H, W, D]

        if feature_weight is None:
            # first iteration of the stage (reference: patchmatch.py:564-573),
            # on the detached feature: the gradient reaches the grid only
            corr = neighbor_group_corr(ref_feature.detach(), grid, self.groups)
            feature_weight = self.feature_weight_net(corr)
        tail = eval_grid_score_reference if self.training else eval_grid_score
        score = tail(x_norm_img, cost_img, grid, feature_weight, interval_scale)
        score = torch.softmax(score, dim=-1)
        if view_weights is None:
            view_weights = torch.stack(new_view_weights, dim=1)  # [B, V, H, W]
        depth = self._regress(score, depth_sample, is_inverse)
        return depth, score, view_weights.detach(), feature_weight

    @staticmethod
    def _regress(score: torch.Tensor, depth_sample: torch.Tensor,
                 is_inverse: bool) -> torch.Tensor:
        """Depth from the probability volume (reference: `Evaluation._finish`)."""
        num_depth = depth_sample.shape[1]
        if is_inverse:
            # inverse-depth index regression (final stage-1 iteration)
            index = torch.arange(num_depth, dtype=score.dtype, device=score.device)
            depth_index = (index * score).sum(dim=-1)
            inv_min = 1.0 / depth_sample[:, -1]
            inv_max = 1.0 / depth_sample[:, 0]
            return 1.0 / (inv_max + depth_index / (num_depth - 1) * (inv_min - inv_max))
        # soft-argmin expectation
        return (depth_sample.permute(0, 2, 3, 1) * score).sum(dim=-1)


class PatchMatch(nn.Module):
    """One cascade stage of iterative learned PatchMatch, configured by
    `config` (the released model's stage `stage` when None; see
    STAGE_CONFIG). As in the reference, propagation runs where the stage
    has propagation neighbours, except on stage 1's last iteration (so never
    on a stage 1 of one iteration), and the propagation offset conv exists
    only where propagation runs. Neighbour counts outside the reference's
    patterns raise NotImplementedError."""

    def __init__(self, stage: int, config: Optional[StageConfig] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stage = stage
        self.config = cfg = config or STAGE_CONFIG[stage]
        d = cfg.propagation_range
        self.has_propagation = cfg.propagate_neighbors > 0 and not (
            stage == 1 and cfg.iterations == 1)
        self.eval_offsets = evaluation_offsets(d, cfg.evaluate_neighbors)
        if self.has_propagation:
            self.propa_offsets = propagation_offsets(cfg.propagate_neighbors, d)
            self.propa_conv = Conv2d(cfg.features, 2 * cfg.propagate_neighbors, 3,
                                     pad=d, dilation=d, dtype=dtype, zero_init=True)
        self.eval_conv = Conv2d(cfg.features, 2 * cfg.evaluate_neighbors, 3,
                                pad=d, dilation=d, dtype=dtype, zero_init=True)
        self.evaluation = Evaluation(cfg.groups, pixel_wise=stage == 3, dtype=dtype)

    def forward(
        self,
        ref_feature: torch.Tensor,
        src_features: Sequence[torch.Tensor],
        ref_proj: torch.Tensor,
        src_projs: Sequence[torch.Tensor],
        depth_min: torch.Tensor,
        depth_max: torch.Tensor,
        depth: Optional[torch.Tensor],
        view_weights: Optional[torch.Tensor],
        init_noise: Optional[torch.Tensor] = None,
        src_stack: Optional[torch.Tensor] = None,
    ) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
        """ref_feature / src_features: [B, H, W, C] (contiguous); depth:
        [B, H, W] previous-stage depth or None on stage 3, which then needs
        `init_noise` [B, 48, H, W]; view_weights [B, V, H, W] or None (made
        by the first evaluation). `src_stack`: the source features as one
        contiguous [B, V, H, W, C] tensor, needed by K6 in inference.
        Returns (per-iteration depths [B, H, W], final score [B, H, W, D],
        view_weights [B, V, H, W])."""
        cfg = self.config
        b, h, w, _ = ref_feature.shape
        ref_nchw = ref_feature.permute(0, 3, 1, 2)  # channels_last view
        propa_grid = None
        if self.has_propagation:
            offset = self.propa_conv(ref_nchw).float().permute(0, 2, 3, 1)
            propa_grid = build_offset_grid(offset, self.propa_offsets, h, w)
        offset = self.eval_conv(ref_nchw).float().permute(0, 2, 3, 1)
        eval_grid = build_offset_grid(offset, self.eval_offsets, h, w)
        mats = warp_proj_coeffs(torch.stack(list(src_projs), 1), ref_proj[:, None])
        warp_mats = [m.contiguous() for m in mats.unbind(1)]  # V x [B, 12]

        inv_min = (1.0 / depth_min).reshape(b, 1, 1, 1)
        inv_max = (1.0 / depth_max).reshape(b, 1, 1, 1)
        feature_weight = None  # made by the first evaluation
        score = None
        depths: List[torch.Tensor] = []
        for it in range(1, cfg.iterations + 1):
            if depth is None:
                if init_noise is None:
                    raise ValueError("stage-3 initialization needs init_noise")
                depth_sample = init_random_depth(init_noise, depth_min, depth_max)
            elif cfg.num_samples == 1:
                depth_sample = depth.detach()[:, None]
            else:
                depth_sample = init_perturbed_depth(
                    depth, depth_min, depth_max, cfg.num_samples, cfg.interval_scale)
            if propa_grid is not None and not (self.stage == 1 and it == cfg.iterations):
                depth_sample = propagate(depth_sample, propa_grid)
            depth_sample = depth_sample.contiguous()

            # normalized inverse depth for the in-aggregation depth weight
            # (no gradient; the hypotheses keep theirs into the regression)
            x_norm = (1.0 / depth_sample.detach() - inv_max) / (inv_min - inv_max)
            x_norm_img = x_norm.permute(0, 2, 3, 1).contiguous()  # [B, H, W, D]

            depth, score, view_weights, feature_weight = self.evaluation(
                ref_feature, src_features, warp_mats, depth_sample, eval_grid,
                x_norm_img, feature_weight, cfg.interval_scale, view_weights,
                is_inverse=self.stage == 1 and it == cfg.iterations,
                src_stack=src_stack, mats=mats,
            )
            depths.append(depth)
        return depths, score, view_weights
