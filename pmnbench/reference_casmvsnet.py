"""Plain PyTorch reference of CasMVSNet's inference forward (Gu et al.,
"Cascade Cost Volume for High-Resolution Multi-View Stereo and Stereo
Matching", CVPR 2020; https://github.com/alibaba/cascade-stereo,
`CasMVSNet/models/cas_mvsnet.py` and `CasMVSNet/models/module.py`).

It imports torch alone and follows the published code step by step, in
f32 on NCHW tensors with TF32 off (`torch.backends.cuda.matmul.allow_tf32`
and `torch.backends.cudnn.allow_tf32` False for the forward):
- FeatureNet, `arch_mode="fpn"`, base 8: conv, BatchNorm, ReLU blocks
  (conv0 3->8, 8->8; conv1 8->16 5x5 stride 2, 16->16 twice; conv2 16->32 5x5
  stride 2, 32->32 twice); out1 1x1 on conv2; inner1 and inner2 1x1 with
  bias added to the nearest x2 upsample; out2 and out3 3x3;
- three stages of 48, 32 and 8 planes at 4, 2 and 1 times the base interval
  (`get_depth_range_samples`: stage 1 even over [depth_min, depth_max];
  later stages about the previous depth, upsampled bilinearly to the image,
  resized trilinearly to the stage), the intrinsics scaled by 1/4, 1/2, 1;
- `homo_warping`: src_proj inv(ref_proj), `F.grid_sample` (bilinear, zeros
  padding, align_corners=True) of each source view at every plane; the
  variance over the N views, the reference view counted once at every plane;
- CostRegNet of base 8 a stage (`share_cr=False`): conv3d and
  conv_transpose3d (stride 2, padding 1, output padding 1) blocks with
  BatchNorm and ReLU, skips added, `prob` 8->1;
- softmax over the planes, depth = sum p d; stage 3's photometric
  confidence, 4 x avg_pool3d of the probabilities padded by (1, 2) planes,
  gathered at the regressed plane index.
BatchNorm is folded from the running statistics (eval mode).

Departures from the published code:
- the base interval is (depth_max - depth_min) / 191, the spacing of DTU's
  192 planes, given by the depth range alone;
- the program's warp reads zero for a point at or behind a source camera
  (pz <= 1e-3), where the published warp (followed here) divides by pz
  whatever its sign. Scenes in front of every camera never reach it.

`Precision` rounds where a model of a lower payload precision rounds: the
inputs, weights and outputs of every convolution, the BatchNorm outputs
and the variance volume ("bf16", or "fp8": e4m3). "f32" rounds nothing.

`seeded_state(seed)` draws the state where no released weights are at
hand: He-normal convolution weights (normal over torch's fan-in, dim 1 of
the weight times its kernel's size, gain sqrt(2)) from one CPU generator
in the published module order, convolution biases 0, BatchNorm at scale 1,
bias 0, mean 0, var 1. Through a random net of 8-64 channels the logits'
scale varies a thousandfold from seed to seed and their structure from
scene to scene: at a small scale the softmax over the planes is flat and
every depth the mean plane, at a large one a hard argmax whose near ties
bf16 breaks; and a random sign puts the peak as often away from the
matching planes as on them. So each stage's `prob` weights are then set in
turn, as a data-dependent initialisation sets a layer, on given scenes
(the benchmark passes its traffic's pool, drawn from the same seed; by
default `probe_scene(seed)`): scaled so that on the least sharp scene the
median over pixels of the largest probability is SHARPNESS / D, and of the
two signs the one whose depth lies nearer the true depth.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
NDEPTHS = (48, 32, 8)
DEPTH_INTERVAL_RATIO = (4.0, 2.0, 1.0)
BASE_DEPTHS = 192
STAGE_SCALE = (4, 2, 1)  # image pixels a feature pixel, by stage
SHARPNESS = 6.0  # `seeded_state`: D x the median largest probability, least sharp scene
# probe scene: H, W, views, depth (mm), baseline (degrees), focal length (px: 1.8 x 1152)
PROBE = (128, 160, 5, 560.0, 10.0, 2073.6)
FEATURE_BLOCKS = {  # FPN FeatureNet blocks: (in, out, kernel, stride)
    "conv0": [(3, 8, 3, 1), (8, 8, 3, 1)],
    "conv1": [(8, 16, 5, 2), (16, 16, 3, 1), (16, 16, 3, 1)],
    "conv2": [(16, 32, 5, 2), (32, 32, 3, 1), (32, 32, 3, 1)],
}
FEATURE_HEADS = {"out1": (32, 32, 1, False), "inner1": (16, 32, 1, True),
                 "inner2": (8, 32, 1, True), "out2": (32, 16, 3, False),
                 "out3": (32, 8, 3, False)}  # (in, out, kernel, bias)
COST_CHANNELS = (32, 16, 8)  # the variance volume's channels, by stage
COST_BLOCKS = [("conv0", None, 8, 1), ("conv1", 8, 16, 2), ("conv2", 16, 16, 1),
               ("conv3", 16, 32, 2), ("conv4", 32, 32, 1), ("conv5", 32, 64, 2),
               ("conv6", 64, 64, 1)]  # (name, in (None: the volume's), out, stride)
COST_DECONVS = [("conv7", 64, 32), ("conv9", 32, 16), ("conv11", 16, 8)]


class Precision:
    """The rounding of payloads: "f32" (none), "bf16", or "fp8" (e4m3)."""

    FORMATS = {"bf16": (torch.bfloat16, None), "fp8": (torch.float8_e4m3fn, 448.0)}

    def __init__(self, name: str = "f32"):
        if name != "f32" and name not in self.FORMATS:
            raise ValueError(f"precision is f32, bf16 or fp8, got {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return x
        dtype, limit = self.FORMATS[self.name]
        if limit is not None:
            x = x.clamp(-limit, limit)
        return x.to(dtype).to(torch.float32)


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _bn(prefix: str, channels: int) -> List[Tuple[str, Tuple[int, ...]]]:
    return [(f"{prefix}.bn.{k}", (channels,)) for k in ("weight", "bias", "running_mean",
                                                         "running_var")]


def parameter_shapes() -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every tensor of the state, in the published
    modules' order and names."""
    out = []
    for block, layers in FEATURE_BLOCKS.items():
        for i, (cin, cout, k, _) in enumerate(layers):
            out.append((f"feature.{block}.{i}.conv.weight", (cout, cin, k, k)))
            out += _bn(f"feature.{block}.{i}", cout)
    for name, (cin, cout, k, bias) in FEATURE_HEADS.items():
        out.append((f"feature.{name}.weight", (cout, cin, k, k)))
        if bias:
            out.append((f"feature.{name}.bias", (cout,)))
    for s, channels in enumerate(COST_CHANNELS):
        pre = f"cost_regularization.{s}"
        for name, cin, cout, _ in COST_BLOCKS:
            out.append((f"{pre}.{name}.conv.weight", (cout, cin or channels, 3, 3, 3)))
            out += _bn(f"{pre}.{name}", cout)
        for name, cin, cout in COST_DECONVS:
            out.append((f"{pre}.{name}.conv.weight", (cin, cout, 3, 3, 3)))
            out += _bn(f"{pre}.{name}", cout)
        out.append((f"{pre}.prob.weight", (1, 8, 3, 3, 3)))
    return out


def probe_scene(seed: int) -> Tuple[torch.Tensor, ...]:
    """A small scene drawn from `seed` for `seeded_state`: a textured
    fronto-parallel plane at PROBE's depth, seen through a crop of PROBE's
    size of a camera of PROBE's focal length (so that a plane's step moves a
    sample as far as at the cell's size) by the reference view and by
    source views on a ring about it, each turned to the plane's centre PROBE's
    baseline away. The texture is a sum of 24 sinusoids of 3-256 px (on the
    plane, in the reference's pixels), amplitudes as their periods. Returns
    images [1, V, H, W, 3], intrinsics, extrinsics, depth_min, depth_max as
    `forward` takes them, on the CPU."""
    h, w, views, depth, baseline, f = PROBE
    gen = torch.Generator().manual_seed(seed)
    waves = torch.rand((24, 6), generator=gen)
    period = 3.0 * (256.0 / 3.0) ** waves[:, 0]
    theta = math.pi * waves[:, 1]
    amp = period / period.sum() * 4.0
    k = torch.tensor([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]])
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                          torch.arange(w, dtype=torch.float32), indexing="ij")
    rays = torch.stack([x, y, torch.ones_like(x)], dim=-1) @ torch.linalg.inv(k).T
    target = torch.tensor([0.0, 0.0, depth])
    radius = depth * math.tan(math.radians(baseline))
    extrinsics = torch.eye(4).repeat(views, 1, 1)
    images = []
    for v in range(views):
        angle = math.pi / 2 * (v - 1)
        center = (torch.zeros(3) if v == 0 else
                  torch.tensor([radius * math.cos(angle), radius * math.sin(angle), 0.0]))
        forward = (target - center) / (target - center).norm()
        right = torch.linalg.cross(torch.tensor([0.0, 1.0, 0.0]), forward)
        right = right / right.norm()
        rot = torch.stack([right, torch.linalg.cross(forward, right), forward])
        extrinsics[v, :3, :3] = rot
        extrinsics[v, :3, 3] = -rot @ center
        world = rays @ rot  # R^T K^-1 p: the ray's direction in the world
        t = (depth - center[2]) / world[..., 2]
        px = f * (center[0] + t * world[..., 0]) / depth + w / 2.0
        py = f * (center[1] + t * world[..., 1]) / depth + h / 2.0
        arg = (2 * math.pi * (torch.cos(theta) * px[..., None] + torch.sin(theta) * py[..., None])
               / period + 2 * math.pi * waves[:, 2])
        img = (amp * torch.sin(arg))[..., None] * (waves[:, 3:] - 0.5)
        images.append(0.5 + 0.5 * torch.tanh(img.sum(2)))
    return (torch.stack(images)[None], k.expand(1, views, 3, 3), extrinsics[None],
            torch.tensor([425.0]), torch.tensor([935.0]))


def seeded_state(seed: int, scenes: Optional[Sequence[Tuple[tuple, torch.Tensor]]] = None
                 ) -> Dict[str, torch.Tensor]:
    """The state drawn from `seed` (see the module's docstring), its `prob`
    layers set on `scenes`: (inputs as `forward` takes them, true depth [B,
    H, W]) pairs, on any one device; `probe_scene(seed)` when None."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, shape in parameter_shapes():
        if key.endswith(("bn.weight", "bn.running_var")):
            out[key] = torch.ones(shape)
        elif len(shape) < 4:
            out[key] = torch.zeros(shape)
        else:
            fan_in = shape[1] * math.prod(shape[2:])
            out[key] = torch.randn(shape, generator=gen) * math.sqrt(2.0 / fan_in)
    if scenes is None:
        scenes = [(probe_scene(seed), torch.full((1, PROBE[0], PROBE[1]), PROBE[3]))]
    device = scenes[0][1].device
    state = {k: v.to(device) for k, v in out.items()}
    for s in range(3):
        runs = []
        for inputs, depth_gt in scenes:
            with torch.no_grad():
                stage = CasMVSNetReference(state).forward(*inputs, stages=s + 1)[2][s + 1]
            logits = torch.log(stage["prob"].clamp(min=1e-30))
            truth = F.interpolate(depth_gt[:, None].float(), size=logits.shape[2:],
                                  mode="nearest")[:, 0]
            runs.append((logits, stage["hypotheses"], truth))
        key = f"cost_regularization.{s}.prob.weight"
        state[key] = state[key] * prob_gain(runs)
    return {k: v.cpu() for k, v in state.items()}


def prob_gain(runs: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]) -> float:
    """The signed gain on a stage's `prob` weights for `seeded_state`, from
    (logits [B, D, h, w] at gain 1, hypotheses [B, D, h, w], true depth [B,
    h, w]) of each scene: for each sign the gain at which the least sharp
    scene's D x median largest probability is SHARPNESS (bisection on its
    logarithm), and of the two the one whose depth lies nearer the truth."""

    def sharpness(gain: float) -> float:
        return min(float(torch.softmax(gain * x, 1).amax(1).median()) * x.shape[1]
                   for x, _, _ in runs)

    best = None
    for sign in (1.0, -1.0):
        low, high = -10.0, 30.0
        for _ in range(32):
            mid = (low + high) / 2
            low, high = (mid, high) if sharpness(sign * 2.0 ** mid) < SHARPNESS else (low, mid)
        gain = sign * 2.0 ** high
        error = sorted(float(((torch.softmax(gain * x, 1) * hyp).sum(1) - truth).abs().median())
                       for x, hyp, truth in runs)[len(runs) // 2]
        if best is None or error < best[0]:
            best = (error, gain)
    return best[1]



class CasMVSNetReference:
    """The forward of the state `params` (cascade-stereo names, f32) at
    `precision`."""

    def __init__(self, params: Dict[str, torch.Tensor], precision: str = "f32",
                 ndepths: Sequence[int] = NDEPTHS,
                 depth_interval_ratio: Sequence[float] = DEPTH_INTERVAL_RATIO):
        self.params = {k: v.float() for k, v in params.items()
                       if not k.endswith("num_batches_tracked")}
        self.q = Precision(precision)
        self.ndepths = tuple(ndepths)
        self.ratios = tuple(depth_interval_ratio)

    # -- layers --------------------------------------------------------------

    def _bn_relu(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        p = self.params
        scale = p[f"{prefix}.bn.weight"] / torch.sqrt(p[f"{prefix}.bn.running_var"] + BN_EPS)
        bias = p[f"{prefix}.bn.bias"] - p[f"{prefix}.bn.running_mean"] * scale
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return F.relu(self.q(x * scale.view(shape) + bias.view(shape)))

    def _conv2d(self, x, name, stride=1, padding=0):
        w = self.params[f"{name}.weight"]
        b = self.params.get(f"{name}.bias")
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride, padding))

    def _conv3d(self, x, name, stride=1):
        return self.q(F.conv3d(self.q(x), self.q(self.params[f"{name}.weight"]), None, stride, 1))

    def _deconv3d(self, x, name):
        return self.q(F.conv_transpose3d(self.q(x), self.q(self.params[f"{name}.weight"]), None,
                                         2, 1, 1))

    def features(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        """FeatureNet of [B, 3, H, W] -> {stage: [B, C, H / s, W / s]}."""
        conv = {}
        for block, layers in FEATURE_BLOCKS.items():
            for i, (_, _, k, stride) in enumerate(layers):
                name = f"feature.{block}.{i}"
                x = self._bn_relu(self._conv2d(x, f"{name}.conv", stride, k // 2), name)
            conv[block] = x
        out = {1: self._conv2d(conv["conv2"], "feature.out1")}
        intra = F.interpolate(conv["conv2"], scale_factor=2, mode="nearest") + self._conv2d(
            conv["conv1"], "feature.inner1")
        out[2] = self._conv2d(intra, "feature.out2", padding=1)
        intra = F.interpolate(intra, scale_factor=2, mode="nearest") + self._conv2d(
            conv["conv0"], "feature.inner2")
        out[3] = self._conv2d(intra, "feature.out3", padding=1)
        return out

    def cost_regularization(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        """CostRegNet of stage `stage` (1-3): [B, C, D, H, W] -> [B, D, H, W]."""
        pre = f"cost_regularization.{stage - 1}"
        skip = {}
        for name, _, _, stride in COST_BLOCKS:
            x = self._bn_relu(self._conv3d(x, f"{pre}.{name}.conv", stride), f"{pre}.{name}")
            skip[name] = x
        for name, to in zip(("conv7", "conv9", "conv11"), ("conv4", "conv2", "conv0")):
            x = skip[to] + self._bn_relu(self._deconv3d(x, f"{pre}.{name}.conv"),
                                         f"{pre}.{name}")
        return self._conv3d(x, f"{pre}.prob")[:, 0]

    # -- geometry --------------------------------------------------------------

    @staticmethod
    def homo_warping(src_fea, src_proj, ref_proj, depth_values):
        """module.py `homo_warping`: [B, C, H, W] at planes [B, D, H, W] ->
        [B, C, D, H, W]."""
        batch, channels, height, width = src_fea.shape
        num_depth = depth_values.shape[1]
        proj = torch.matmul(src_proj, torch.inverse(ref_proj))
        rot, trans = proj[:, :3, :3], proj[:, :3, 3:4]
        y, x = torch.meshgrid(torch.arange(0, height, dtype=torch.float32, device=src_fea.device),
                              torch.arange(0, width, dtype=torch.float32, device=src_fea.device),
                              indexing="ij")
        xyz = torch.stack((x.reshape(-1), y.reshape(-1), torch.ones_like(x.reshape(-1))))
        rot_xyz = torch.matmul(rot, xyz[None].repeat(batch, 1, 1))
        rot_depth_xyz = rot_xyz[:, :, None] * depth_values.view(batch, 1, num_depth, -1)
        proj_xyz = rot_depth_xyz + trans.view(batch, 3, 1, 1)
        proj_xy = proj_xyz[:, :2] / proj_xyz[:, 2:3]
        grid = torch.stack((proj_xy[:, 0] / ((width - 1) / 2) - 1,
                            proj_xy[:, 1] / ((height - 1) / 2) - 1), dim=3)
        warped = F.grid_sample(src_fea, grid.view(batch, num_depth * height, width, 2),
                               mode="bilinear", padding_mode="zeros", align_corners=True)
        return warped.view(batch, channels, num_depth, height, width)

    def hypotheses(self, i: int, cur_depth: Optional[torch.Tensor], depth_min, depth_max,
                   height: int, width: int) -> torch.Tensor:
        """`get_depth_range_samples` at the image's size, resized
        trilinearly to stage i's: [B, D, H / s, W / s]."""
        d = self.ndepths[i]
        dev = depth_min.device
        planes = torch.arange(0, d, dtype=torch.float32, device=dev)
        if cur_depth is None:
            interval = (depth_max - depth_min) / (d - 1)
            samples = depth_min[:, None] + planes.reshape(1, -1) * interval[:, None]
            samples = samples[:, :, None, None].repeat(1, 1, height, width)
        else:
            base = (depth_max - depth_min) / (BASE_DEPTHS - 1)
            pixel_interval = (self.ratios[i] * base)[:, None, None]
            low = cur_depth - d / 2 * pixel_interval
            high = cur_depth + d / 2 * pixel_interval
            interval = (high - low) / (d - 1)
            samples = low[:, None] + planes.reshape(1, -1, 1, 1) * interval[:, None]
        s = STAGE_SCALE[i]
        return F.interpolate(samples[:, None], [d, height // s, width // s], mode="trilinear",
                             align_corners=False)[:, 0]

    # -- forward ---------------------------------------------------------------

    def forward(self, images: torch.Tensor, intrinsics: torch.Tensor,
                extrinsics: torch.Tensor, depth_min: torch.Tensor, depth_max: torch.Tensor,
                stages: int = 3
                ) -> Tuple[torch.Tensor, torch.Tensor, Dict[int, Dict[str, torch.Tensor]]]:
        """images [B, N, H, W, 3], intrinsics [B, N, 3, 3], extrinsics [B, N,
        4, 4] world-to-camera, depth_min / depth_max [B] -> (depth [B, H, W],
        confidence [B, H, W], {stage: {"depth", "prob", "hypotheses"}}); with `stages` < 3
        the first stages alone, and the last one's depth and confidence."""
        with no_tf32():
            return self._forward(images.float(), intrinsics.float(), extrinsics.float(),
                                 depth_min.float().reshape(-1), depth_max.float().reshape(-1),
                                 stages)

    def _forward(self, images, intrinsics, extrinsics, depth_min, depth_max, stages):
        b, n, height, width = images.shape[:4]
        views = [self.features(images[:, v].permute(0, 3, 1, 2)) for v in range(n)]
        outputs = {}
        depth = None
        for i, stage in enumerate((1, 2, 3)[:stages]):
            k = intrinsics.clone()
            k[:, :, :2] /= STAGE_SCALE[i]
            proj = extrinsics.clone()
            proj[:, :, :3, :4] = torch.matmul(k, extrinsics[:, :, :3, :4])
            cur = None if depth is None else F.interpolate(
                depth[:, None], [height, width], mode="bilinear", align_corners=False)[:, 0]
            depth_values = self.hypotheses(i, cur, depth_min, depth_max, height, width)
            d = depth_values.shape[1]
            ref = views[0][stage][:, :, None].repeat(1, 1, d, 1, 1)
            volume_sum, volume_sq_sum = ref, ref ** 2
            for v in range(1, n):
                warped = self.homo_warping(views[v][stage], proj[:, v], proj[:, 0],
                                           depth_values)
                volume_sum = volume_sum + warped
                volume_sq_sum = volume_sq_sum + warped ** 2
            variance = self.q(volume_sq_sum / n - (volume_sum / n) ** 2)
            prob = torch.softmax(self.cost_regularization(variance, stage), dim=1)
            depth = torch.sum(prob * depth_values, 1)
            outputs[stage] = {"depth": depth, "prob": prob, "hypotheses": depth_values}
        sum4 = 4 * F.avg_pool3d(F.pad(prob[:, None], pad=(0, 0, 0, 0, 1, 2)), (4, 1, 1),
                                stride=1, padding=0)[:, 0]
        index = torch.sum(prob * torch.arange(d, device=prob.device, dtype=torch.float32)
                          .view(1, -1, 1, 1), 1).long().clamp(min=0, max=d - 1)
        confidence = torch.gather(sum4, 1, index[:, None])[:, 0]
        return depth, confidence, outputs
