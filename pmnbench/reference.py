"""Plain PyTorch reference of PatchmatchNet (Wang et al., CVPR 2021,
https://github.com/FangjinhuaWang/PatchmatchNet): the inference forward,
the training forward and loss, and Adam.

It imports nothing of the program under test and takes nothing the program
made: it reads the released flax checkpoint itself (`read_flax_msgpack`)
and works on NCHW tensors with `F.conv2d`, `F.grid_sample`, einsum and
autograd. Every operation runs in f32 with TF32 off (`no_tf32`).

`Precision` rounds at the points where a model of a lower payload
precision rounds: the inputs, weights and outputs of every convolution and
per-position channel map, and the BatchNorm outputs. Geometry, the
correlation sums, softmax, regression and the loss stay f32. Gradients
pass the rounding unchanged in value and are rounded like the activations
they belong to ("bf16": bf16 both ways; "fp8": e4m3 forward, e5m2
backward). "f32" rounds nothing: it is the reference. "fp8" is the
control: the reference one precision step below the bf16 model.

Train mode follows the published model's stop-gradients: no gradient
between stages, none through the warp coordinates, the perturbation
centre, the normalized inverse depth or the depth weight of the
aggregation; the view weights made in stage 3's first evaluation keep
their gradient there only; the neighbour correlation takes the detached
reference feature. FeatureNet runs once per view with batch statistics.
"""

from __future__ import annotations

import contextlib
import struct
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5

# ---------------------------------------------------------------------------
# The released checkpoint
# ---------------------------------------------------------------------------


class _Msgpack:
    """The subset of msgpack that flax's `msgpack_serialize` writes: maps,
    arrays, strings, numbers and ndarrays as ext type 1 (or 3 for numpy
    scalars) holding a msgpack (shape, dtype, bytes) tuple."""

    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def read(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if t <= 0x8F:
            return {self.read(): self.read() for _ in range(t & 0x0F)}
        if t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        if t in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[t]
        if t in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.uint(1 << (t - 0xC4))))
        if t in (0xC7, 0xC8, 0xC9):
            n = self.uint(1 << (t - 0xC7))
            return self.ext(int.from_bytes(self.take(1), "big", signed=True), n)
        if t == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if t == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= t <= 0xCF:
            return self.uint(1 << (t - 0xCC))
        if 0xD0 <= t <= 0xD3:
            return int.from_bytes(self.take(1 << (t - 0xD0)), "big", signed=True)
        if 0xD4 <= t <= 0xD8:
            code = int.from_bytes(self.take(1), "big", signed=True)
            return self.ext(code, 1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.uint(1 << (t - 0xD9))), "utf-8")
        if t in (0xDC, 0xDD):
            return [self.read() for _ in range(self.uint(2 if t == 0xDC else 4))]
        if t in (0xDE, 0xDF):
            return {self.read(): self.read() for _ in range(self.uint(2 if t == 0xDE else 4))}
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def ext(self, code: int, n: int) -> Any:
        if code not in (1, 3):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, raw = _Msgpack(bytes(self.take(n))).read()
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
        return arr[()] if code == 3 else arr


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        data = f.read()
    reader = _Msgpack(data)
    tree = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"trailing bytes in {path}")
    return tree


def _flat(tree: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(value, np.float32)


def load_weights(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(params, batch statistics) of a flax checkpoint as f32 CPU tensors keyed
    by their flax path ("feature/conv0/conv/kernel"), convolution kernels
    in torch's layout: OIHW, dense kernels [O, I], and the Refinement's
    deconvolution (a flipped forward-conv kernel in flax) as a
    `conv_transpose2d` weight [I, O, kH, kW]."""
    tree = read_flax_msgpack(path)
    params: Dict[str, torch.Tensor] = {}
    for key, arr in _flat(tree["params"]):
        if key.endswith("kernel"):
            if arr.ndim == 2:
                arr = arr.T
            elif key.endswith("deconv/kernel"):
                arr = np.transpose(arr, (2, 3, 0, 1))[:, :, ::-1, ::-1]
            else:
                arr = np.transpose(arr, (3, 2, 0, 1))
        params[key] = torch.from_numpy(np.ascontiguousarray(arr))
    stats = {key: torch.from_numpy(arr.copy()) for key, arr in _flat(tree["batch_stats"])}
    return params, stats


# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------


def _rounder(dtype: torch.dtype, limit: Optional[float]) -> Callable[[torch.Tensor], torch.Tensor]:
    def round_to(x: torch.Tensor) -> torch.Tensor:
        if limit is not None:
            x = x.clamp(-limit, limit)
        return x.to(dtype).to(torch.float32)
    return round_to


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, forward_round, backward_round):
        ctx.backward_round = backward_round
        return forward_round(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.backward_round(grad), None, None


class Precision:
    """The rounding of payloads: "f32" (none), "bf16", or "fp8"."""

    ROUNDERS = {
        "bf16": (_rounder(torch.bfloat16, None), _rounder(torch.bfloat16, None)),
        "fp8": (_rounder(torch.float8_e4m3fn, 448.0), _rounder(torch.float8_e5m2, 57344.0)),
    }

    def __init__(self, name: str = "f32"):
        if name != "f32" and name not in self.ROUNDERS:
            raise ValueError(f"precision is f32, bf16 or fp8, got {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return x
        fwd, bwd = self.ROUNDERS[self.name]
        if not x.requires_grad:
            return fwd(x)
        return _RoundSTE.apply(x, fwd, bwd)


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Geometry and sampling
# ---------------------------------------------------------------------------


def stage_projections(intrinsics: torch.Tensor, extrinsics: torch.Tensor
                      ) -> Dict[int, torch.Tensor]:
    """[B, N, 4, 4] projections K_s [R | t] with K scaled to stage s's
    resolution (1/8, 1/4, 1/2 for stages 3, 2, 1)."""
    out = {}
    for stage, scale in ((3, 0.125), (2, 0.25), (1, 0.5)):
        k = intrinsics.clone()
        k[:, :, :2] *= scale
        proj = extrinsics.clone()
        proj[:, :, :3, :4] = k @ extrinsics[:, :, :3, :4]
        out[stage] = proj
    return out


def warp_matrices(src_proj: torch.Tensor, ref_proj: torch.Tensor) -> torch.Tensor:
    """[B, 3, 4] = (src_proj @ inv(ref_proj))[:3, :4]."""
    return (src_proj @ torch.linalg.inv(ref_proj))[:, :3, :4]


def _sample(image: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor, align_corners: bool,
            padding: str) -> torch.Tensor:
    """Bilinear samples of image [B, C, H, W] at normalized (gx, gy), each
    [B, *S] -> [B, C, *S]."""
    b, shape = gx.shape[0], gx.shape[1:]
    grid = torch.stack([gx.reshape(b, -1), gy.reshape(b, -1)], dim=-1)[:, :, None]
    out = F.grid_sample(image, grid, mode="bilinear", padding_mode=padding,
                        align_corners=align_corners)
    return out[..., 0].reshape(b, image.shape[1], *shape)


def warp_correlation(src: torch.Tensor, mat: torch.Tensor, depth: torch.Tensor,
                     ref: torch.Tensor, groups: int) -> torch.Tensor:
    """Group-wise correlation [B, G, D, H, W] of ref [B, C, H, W] with src
    [B, C, Hs, Ws] sampled where each hypothesis depth [B, D, H, W] of a
    reference pixel projects (homography warp; align_corners=True, zeros
    padding; points with z <= 1e-3 land outside the image)."""
    b, d, h, w = depth.shape
    hs, ws = src.shape[2:]
    depth = depth.detach()
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=depth.device),
                          torch.arange(w, dtype=torch.float32, device=depth.device),
                          indexing="ij")
    m = mat.reshape(b, 12, 1, 1, 1)
    pts = [(m[:, 4 * r] * u + m[:, 4 * r + 1] * v + m[:, 4 * r + 2]) * depth + m[:, 4 * r + 3]
           for r in range(3)]
    behind = pts[2] <= 1e-3
    ix = torch.where(behind, torch.full_like(depth, float(ws)), pts[0] / pts[2])
    iy = torch.where(behind, torch.full_like(depth, float(hs)), pts[1] / pts[2])
    warped = _sample(src, ix / ((ws - 1) / 2) - 1, iy / ((hs - 1) / 2) - 1, True, "zeros")
    prod = warped * ref[:, :, None]  # [B, C, D, H, W]
    c = ref.shape[1]
    return prod.reshape(b, groups, c // groups, d, h, w).mean(dim=2)


def offset_grid(offset: torch.Tensor, fixed: Sequence[Tuple[int, int]]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Learned offsets [B, 2K, H, W] (channel 2k x, 2k+1 y) plus the fixed
    neighbour offsets (y, x) -> normalized (gx, gy), each [B, K, H, W]
    (normalized as align_corners=True, sampled as align_corners=False)."""
    b, _, h, w = offset.shape
    dev = offset.device
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                          torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    fx = torch.tensor([o[1] for o in fixed], dtype=torch.float32, device=dev).reshape(1, -1, 1, 1)
    fy = torch.tensor([o[0] for o in fixed], dtype=torch.float32, device=dev).reshape(1, -1, 1, 1)
    gx = (x + fx + offset[:, 0::2]) / ((w - 1) / 2) - 1
    gy = (y + fy + offset[:, 1::2]) / ((h - 1) / 2) - 1
    return gx, gy


def propagation_offsets(neighbors: int, dilation: int) -> List[Tuple[int, int]]:
    if neighbors == 4:
        return [(-dilation, 0), (0, -dilation), (0, dilation), (dilation, 0)]
    ring = [(y, x) for y in (-dilation, 0, dilation) for x in (-dilation, 0, dilation)
            if (y, x) != (0, 0)]
    if neighbors == 8:
        return ring
    if neighbors == 16:
        return ring + [(2 * y, 2 * x) for (y, x) in ring]
    raise ValueError(f"propagate_neighbors {neighbors}")


def evaluation_offsets(dilation: int, neighbors: int) -> List[Tuple[int, int]]:
    d = dilation - 1
    square = [(y, x) for y in (-d, 0, d) for x in (-d, 0, d)]
    if neighbors == 9:
        return square
    if neighbors == 17:
        return square + [(2 * y, 2 * x) for (y, x) in square if (y, x) != (0, 0)]
    raise ValueError(f"evaluate_neighbors {neighbors}")


def recomputed(fn, *args):
    """fn(*args); under autograd its activations are not kept but computed
    again in the backward (the same values: every step is deterministic),
    so that a global batch of 32 fits on one card."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------


class ReferenceModel:
    """PatchmatchNet on `params` (flax paths, torch layouts) with the
    per-stage options of `stages` ({1, 2, 3: {interval_scale,
    propagation_range, iterations, num_samples, propagate_neighbors,
    evaluate_neighbors, features, groups}})."""

    def __init__(self, params: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
                 stages: Dict[int, Dict[str, Any]], precision: str = "f32"):
        self.params, self.stats, self.stages = params, stats, stages
        self.q = Precision(precision)
        self.train = False

    # layers -------------------------------------------------------------

    def conv(self, x, name, stride=1, pad=1, dilation=1, bias=False):
        q = self.q
        b = q(self.params[f"{name}/bias"]) if bias else None
        y = F.conv2d(q(x), q(self.params[f"{name}/kernel"]), b, stride, pad, dilation)
        return q(y)

    def dense(self, x, name, bias=True):
        """Per-position channel map over axis 1 of [B, C, ...]."""
        q = self.q
        y = torch.einsum("oc,bc...->bo...", q(self.params[f"{name}/kernel"]), q(x))
        if bias:
            y = y + q(self.params[f"{name}/bias"]).reshape(1, -1, *([1] * (x.dim() - 2)))
        return q(y)

    def bn(self, x, name):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        weight, bias = self.params[f"{name}/scale"], self.params[f"{name}/bias"]
        if self.train:
            dims = [0] + list(range(2, x.dim()))
            mean = x.mean(dim=dims)
            var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
            mul = torch.rsqrt(var + BN_EPS) * weight
            return self.q((x - mean.view(shape)) * mul.view(shape) + bias.view(shape))
        scale = weight * torch.rsqrt(self.stats[f"{name}/var"] + BN_EPS)
        shift = bias - self.stats[f"{name}/mean"] * scale
        return self.q(x * self.q(scale).view(shape) + self.q(shift).view(shape))

    def conv_bn_relu(self, x, name, stride=1, pad=1):
        return F.relu(self.bn(self.conv(x, f"{name}/conv", stride, pad), f"{name}/bn"))

    def dense_bn_relu(self, x, name):
        return F.relu(self.bn(self.dense(x, f"{name}/conv", bias=False), f"{name}/bn"))

    def channel_net(self, x, name, last):
        x = self.dense_bn_relu(self.dense_bn_relu(x, f"{name}/conv0"), f"{name}/conv1")
        return self.dense(x, f"{name}/{last}/dense")[:, 0]

    # feature pyramid ----------------------------------------------------

    def features(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        """[B, 3, H, W] -> {1: [B, 16, H/2, W/2], 2: [B, 32, H/4, W/4],
        3: [B, 64, H/8, W/8]}."""
        q, f = self.q, "feature"
        c1 = self.conv_bn_relu(self.conv_bn_relu(x, f"{f}/conv0"), f"{f}/conv1")
        c4 = self.conv_bn_relu(self.conv_bn_relu(self.conv_bn_relu(
            c1, f"{f}/conv2", 2, 2), f"{f}/conv3"), f"{f}/conv4")
        c7 = self.conv_bn_relu(self.conv_bn_relu(self.conv_bn_relu(
            c4, f"{f}/conv5", 2, 2), f"{f}/conv6"), f"{f}/conv7")
        c10 = self.conv_bn_relu(self.conv_bn_relu(self.conv_bn_relu(
            c7, f"{f}/conv8", 2, 2), f"{f}/conv9"), f"{f}/conv10")
        up = lambda t: q(F.interpolate(t, scale_factor=2, mode="bilinear", align_corners=False))
        out = {3: self.dense(c10, f"{f}/output1", bias=False)}
        intra = q(up(c10) + self.dense(c7, f"{f}/inner1"))
        out[2] = self.dense(intra, f"{f}/output2", bias=False)
        intra = q(up(intra) + self.dense(c4, f"{f}/inner2"))
        out[1] = self.dense(intra, f"{f}/output3", bias=False)
        return out

    # one PatchMatch stage -----------------------------------------------

    def evaluate(self, stage, ref, srcs, mats, depth_sample, grid, x_norm, feature_weight,
                 view_weights, is_inverse):
        cfg, name = self.stages[stage], f"patchmatch_{stage}/evaluation"
        groups = cfg["groups"]
        b, _, h, w = ref.shape
        d = depth_sample.shape[1]
        sim_sum = torch.zeros((b, groups, d, h, w), device=ref.device)
        weight_sum = torch.full((b, 1, 1, 1, 1), 1e-5, device=ref.device)
        made = []
        for i, src in enumerate(srcs):
            sim = recomputed(warp_correlation, src, mats[i], depth_sample, ref, groups)
            if view_weights is None:
                vw = torch.sigmoid(self.channel_net(sim, f"{name}/pixel_wise_net", "conv2")
                                   ).amax(dim=1)
                made.append(vw)
            else:
                vw = view_weights[:, i]
            sim_sum = sim_sum + sim * vw[:, None, None]
            weight_sum = weight_sum + vw[:, None, None]
        cost = self.channel_net(self.q(sim_sum / weight_sum), f"{name}/similarity_net",
                                "similarity")  # [B, D, H, W]
        gx, gy = grid
        if feature_weight is None:
            nb = _sample(ref.detach(), gx, gy, False, "border")  # [B, C, Ke, H, W]
            c = ref.shape[1]
            corr = (nb * ref.detach()[:, :, None]).reshape(b, groups, c // groups,
                                                           *nb.shape[2:]).mean(dim=2)
            feature_weight = torch.sigmoid(
                self.channel_net(corr, f"{name}/feature_weight_net", "similarity"))
        # adaptive spatial aggregation over the eval grid
        joint = torch.cat([x_norm.detach(), cost], dim=1)
        sampled = _sample(joint, gx, gy, False, "border")  # [B, 2D, Ke, H, W]
        x_smp, c_smp = sampled[:, :d], sampled[:, d:]
        with torch.no_grad():
            diff = (x_smp - x_norm[:, :, None]).abs() / cfg["interval_scale"]
            depth_weight = torch.sigmoid(4.0 - 2.0 * diff.clamp(0.0, 4.0))
        weight = depth_weight * feature_weight[:, None]
        weight = weight / weight.sum(dim=2, keepdim=True)
        score = torch.softmax((c_smp * weight).sum(dim=2), dim=1)  # [B, D, H, W]
        if view_weights is None:
            view_weights = torch.stack(made, dim=1)
        if is_inverse:
            index = (torch.arange(d, dtype=torch.float32, device=score.device)
                     .reshape(1, d, 1, 1) * score).sum(dim=1)
            inv_min, inv_max = 1.0 / depth_sample[:, -1], 1.0 / depth_sample[:, 0]
            depth = 1.0 / (inv_max + index / (d - 1) * (inv_min - inv_max))
        else:
            depth = (depth_sample * score).sum(dim=1)
        return depth, score, view_weights.detach(), feature_weight

    def stage(self, stage, feats, projs, depth_min, depth_max, depth, view_weights, noise):
        cfg, name = self.stages[stage], f"patchmatch_{stage}"
        ref, srcs = feats[0], feats[1:]
        dil = cfg["propagation_range"]
        iterations = cfg["iterations"]
        propagates = cfg["propagate_neighbors"] > 0 and not (stage == 1 and iterations == 1)
        propa_grid = None
        if propagates:
            off = self.conv(ref, f"{name}/propa_conv/conv2d", pad=dil, dilation=dil, bias=True)
            propa_grid = offset_grid(off, propagation_offsets(cfg["propagate_neighbors"], dil))
        off = self.conv(ref, f"{name}/eval_conv/conv2d", pad=dil, dilation=dil, bias=True)
        eval_grid = offset_grid(off, evaluation_offsets(dil, cfg["evaluate_neighbors"]))
        mats = [warp_matrices(projs[:, v], projs[:, 0]) for v in range(1, projs.shape[1])]
        b = ref.shape[0]
        inv_min = (1.0 / depth_min).reshape(b, 1, 1, 1)
        inv_max = (1.0 / depth_max).reshape(b, 1, 1, 1)
        feature_weight, score, depths = None, None, []
        for it in range(1, iterations + 1):
            if depth is None:
                d = noise.shape[1]
                strata = noise + torch.arange(d, dtype=torch.float32,
                                              device=noise.device).reshape(1, d, 1, 1)
                sample = 1.0 / (inv_max + strata / d * (inv_min - inv_max))
            elif cfg["num_samples"] == 1:
                sample = depth.detach()[:, None]
            else:
                n = cfg["num_samples"]
                offsets = torch.arange(-(n // 2), n // 2, dtype=torch.float32,
                                       device=depth.device).reshape(1, n, 1, 1)
                inv = (1.0 / depth.detach()[:, None]
                       + (inv_min - inv_max) * cfg["interval_scale"] * offsets)
                sample = 1.0 / torch.clamp(inv, inv_max, inv_min)
            if propa_grid is not None and not (stage == 1 and it == iterations):
                middle = sample[:, sample.shape[1] // 2][:, None]
                prop = _sample(middle, *propa_grid, False, "border")[:, 0]
                sample = torch.sort(torch.cat([sample, prop], dim=1), dim=1).values
            x_norm = (1.0 / sample.detach() - inv_max) / (inv_min - inv_max)
            depth, score, view_weights, feature_weight = recomputed(
                self.evaluate, stage, ref, srcs, mats, sample, eval_grid, x_norm,
                feature_weight, view_weights, stage == 1 and it == iterations)
            depths.append(depth)
        return depths, score, view_weights

    def refine(self, img, depth_half, depth_min, depth_max):
        q, r = self.q, "upsample_net"
        dmin, dmax = depth_min.reshape(-1, 1, 1), depth_max.reshape(-1, 1, 1)
        depth = ((depth_half - dmin) / (dmax - dmin))[:, None]
        conv0 = self.conv_bn_relu(img, f"{r}/conv0")
        x = self.conv_bn_relu(self.conv_bn_relu(depth, f"{r}/conv1"), f"{r}/conv2")
        x = q(F.conv_transpose2d(q(x), q(self.params[f"{r}/deconv/kernel"]), stride=2,
                                 padding=1, output_padding=1))
        deconv = F.relu(self.bn(x, f"{r}/bn"))
        x = self.conv_bn_relu(torch.cat([deconv, conv0], dim=1), f"{r}/conv3")
        res = self.conv(x, f"{r}/res")
        return (upsample_nearest(depth) + res)[:, 0] * (dmax - dmin) + dmin

    # the whole forward --------------------------------------------------

    def forward(self, images, intrinsics, extrinsics, depth_min, depth_max, noise):
        """images [B, N, H, W, 3], intrinsics [B, N, 3, 3], extrinsics
        [B, N, 4, 4] world-to-camera, depth_min / depth_max [B], noise
        [B, 48, H/8, W/8] uniform -> (depth [B, H, W], confidence [B, H, W]
        (zeros in train mode), {stage: [depths]}, stage 0 the refined)."""
        with no_tf32():
            return self._forward(images.float(), intrinsics.float(), extrinsics.float(),
                                 depth_min.float().reshape(-1), depth_max.float().reshape(-1),
                                 noise.float())

    def _forward(self, images, intrinsics, extrinsics, depth_min, depth_max, noise):
        b, n, h, w, _ = images.shape
        nchw = images.permute(0, 1, 4, 2, 3)
        feats: Dict[int, List[torch.Tensor]] = {1: [], 2: [], 3: []}
        if self.train:  # one call per view: per-view batch statistics
            for v in range(n):
                for s, f in recomputed(self.features, nchw[:, v]).items():
                    feats[s].append(f)
        else:
            for s, f in self.features(nchw.reshape(b * n, 3, h, w)).items():
                f = f.reshape(b, n, *f.shape[1:])
                feats[s] = [f[:, v] for v in range(n)]
        projs = stage_projections(intrinsics, extrinsics)
        depth = view_weights = score = None
        out: Dict[int, List[torch.Tensor]] = {}
        for stage in (3, 2, 1):
            depths, score, view_weights = self.stage(
                stage, feats[stage], projs[stage], depth_min, depth_max, depth, view_weights,
                noise if stage == 3 else None)
            out[stage] = depths
            depth = depths[-1].detach()
            if stage > 1:
                depth = upsample_nearest(depth[:, None])[:, 0]
                view_weights = upsample_nearest(view_weights)
        depth = recomputed(self.refine, nchw[:, 0], depth, depth_min, depth_max)
        out[0] = [depth]
        if self.train:
            return depth, torch.zeros_like(depth), out
        return depth, self.confidence(score), out

    @staticmethod
    def confidence(score: torch.Tensor) -> torch.Tensor:
        """Probability of the 4 hypotheses around the regressed index of the
        final score [B, D, H/2, W/2] -> [B, H, W]."""
        d = score.shape[1]
        padded = F.pad(score, (0, 0, 0, 0, 1, 2))
        sum4 = sum(padded[:, i:i + d] for i in range(4))
        index = (torch.arange(d, dtype=score.dtype, device=score.device).reshape(1, d, 1, 1)
                 * score).sum(dim=1)
        index = index.to(torch.int64).clamp(0, d - 1)
        conf = torch.gather(sum4, 1, index[:, None])
        return upsample_nearest(conf)[:, 0]


# ---------------------------------------------------------------------------
# Training: loss and Adam
# ---------------------------------------------------------------------------


def loss_fn(out: Dict[int, List[torch.Tensor]], depth_gt: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 (beta 1) of every depth of every stage against the GT
    pyramid (nearest: every 2nd, 4th, 8th pixel), masked, each stage's sum
    over its mask count."""
    loss = torch.zeros((), device=depth_gt.device)
    for i, f in enumerate((1, 2, 4, 8)):
        gt = depth_gt[:, ::f, ::f]
        m = mask[:, ::f, ::f].float()
        count = m.sum().clamp(min=1.0)
        for depth in out[i]:
            loss = loss + (F.smooth_l1_loss(depth, gt, reduction="none", beta=1.0) * m
                           ).sum() / count
    return loss


class Adam:
    """Adam(0.9, 0.999, eps 1e-8) without weight decay, in f32."""

    def __init__(self, params: Dict[str, torch.Tensor], b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps, self.t = b1, b2, eps, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr: float):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps))


def train_steps(model: ReferenceModel, batches: Sequence[Dict[str, torch.Tensor]],
                noises: Sequence[torch.Tensor], lr: float) -> Dict[str, Any]:
    """Steps of the training forward, the loss and Adam over `batches`
    (images, intrinsics, extrinsics, depth_min, depth_max, depth_gt, mask),
    from `model.params`, which it updates in place. Returns {"losses":
    [per step], "grads": the first step's gradients, "params0": the
    parameters before the first step}."""
    model.train = True
    params = model.params
    params0 = {k: p.detach().clone() for k, p in params.items()}
    adam = Adam(params)
    losses, first = [], None
    for batch, noise in zip(batches, noises):
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        _, _, out = model.forward(batch["images"], batch["intrinsics"], batch["extrinsics"],
                                  batch["depth_min"], batch["depth_max"], noise)
        with no_tf32():
            loss = loss_fn(out, batch["depth_gt"].float(), batch["mask"])
            names = list(params)
            grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        for p in params.values():
            p.requires_grad_(False)
        adam.step(params, grads, lr)
        losses.append(float(loss.detach()))
        if first is None:
            first = grads
        del out, loss
    return {"losses": losses, "grads": first, "params0": params0}
