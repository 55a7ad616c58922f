"""The least time an H100 could take for one PatchmatchNet inference forward
or train step: the benchmark's own count, frozen.

The counting rules are those of `patchmatchnet_torch/dev/roofline.py` at
the time the benchmark was written (`count`, `kernel_work`, `bound`), but
every size comes from a configuration file of `pmnbench/configs/` and the
traffic's shapes, never from the program's modules, so the work counted for
a cell does not change whatever a later change does to the program.

Each component reads every input once and writes every output once at its
dtype; a convolution takes the rate of the unit its precision runs on (bf16
tensor cores, or f32 CUDA cores); the hand kernels' rows are `kernel_work`'s
(f32 on the CUDA cores). Every row belongs to one group: "convolutions",
the hand kernels "K1"-"K6", or "glue". The whole bound is the sum of the
rows' bounds. The peaks are in `peaks.json`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

_PEAKS = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")))
MEMORY_BYTES_PER_S = float(_PEAKS["memory_bytes_per_s"])
F32_OPS_PER_S = float(_PEAKS["f32_ops_per_s"])
BF16_TENSOR_OPS_PER_S = float(_PEAKS["bf16_tensor_ops_per_s"])

F32 = 4
GROUPS = ("convolutions", "K1", "K6", "K2", "K3", "K4", "K5", "glue")
HAND_KERNELS = ("K1", "K6", "K2", "K3", "K4", "K5")
KERNEL_GROUPS = {"warp_group_corr": "K1", "warp_group_corr_views": "K6",
                 "eval_grid_score": "K2", "neighbor_group_corr": "K3",
                 "warp_group_corr_backward": "K4", "neighbor_group_corr_backward": "K5"}


class T(NamedTuple):
    """A tensor's shape and element size: all the count needs of it."""

    shape: Tuple[int, ...]
    size: int

    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def nbytes(*tensors: T) -> int:
    return sum(t.numel() * t.size for t in tensors)


def sample_ops(c: int) -> int:
    """f32 operations to reduce one sample of a C-channel map: 4 bilinear
    taps x C multiply-adds, C multiply-adds with the reference, ~24 more."""
    return 10 * c + 24


def kernel_work(name: str, args, out) -> tuple:
    """(bytes, operations) one call of hand kernel `name` must do."""
    if name == "warp_group_corr":  # src, mat12, depth, ref, g
        src, _, depth, _, _ = args
        return nbytes(*args[:4], out), depth.numel() * sample_ops(src.shape[-1])
    if name == "warp_group_corr_views":  # src [B,V,...], mats, depth, ref, vw, g
        src, _, depth, _, _, g = args
        per_view = sample_ops(src.shape[-1]) + 2 * g
        return nbytes(*args[:5], out), depth.numel() * src.shape[1] * per_view
    if name == "neighbor_group_corr":  # ref, (gx, gy), g
        ref, (gx, gy), _ = args
        return nbytes(ref, gx, gy, out), gx.numel() * sample_ops(ref.shape[-1])
    if name == "eval_grid_score":  # x_norm, cost, (gx, gy), fw, interval
        x_norm, cost, (gx, gy), fw, _ = args
        return nbytes(x_norm, cost, gx, gy, fw, out), x_norm.numel() * gx.shape[1] * 40
    if name == "warp_group_corr_backward":  # src, mat12, depth, ref, g, dout
        src, _, depth, _, _, dout = args
        return (nbytes(*args[:4], dout, *out),
                depth.numel() * (2 * sample_ops(src.shape[-1])))
    if name == "neighbor_group_corr_backward":  # ref, (gx, gy), g, dout
        ref, (gx, gy), _, dout = args
        return nbytes(ref, gx, gy, dout, *out), gx.numel() * (sample_ops(ref.shape[-1]) + 8)
    raise KeyError(name)


def bound(work_bytes: float, work_ops: float, ops_per_s: float = F32_OPS_PER_S):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    by_bytes = work_bytes / MEMORY_BYTES_PER_S * 1e3
    by_ops = work_ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


class Geometry(NamedTuple):
    height: int
    width: int
    views: int
    batch: int
    train: bool


@dataclass
class Row:
    component: str
    group: str
    bytes: float
    flops: float
    ops_per_s: float
    module: Optional[str] = None

    @property
    def bound(self):
        return bound(self.bytes, self.flops, self.ops_per_s)


class Conv(NamedTuple):
    """A convolution's sizes (kernel_size etc. as (h, w) pairs)."""

    in_channels: int
    out_channels: int
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (1, 1)
    dilation: Tuple[int, int] = (1, 1)
    bias: bool = False
    transposed: bool = False
    output_padding: Tuple[int, int] = (0, 0)

    @property
    def weights(self) -> int:
        kh, kw = self.kernel_size
        return self.in_channels * self.out_channels * kh * kw + (self.out_channels if self.bias
                                                                 else 0)


def _conv(cin, cout, k=3, stride=1, pad=1, dilation=1, bias=False) -> Conv:
    return Conv(cin, cout, (k, k), (stride, stride), (pad, pad), (dilation, dilation), bias)


class Architecture:
    """PatchmatchNet's layer sizes from a configuration file: FeatureNet's
    widths, the stages' options, groups and features, the channel nets'
    widths and the Refinement's width."""

    def __init__(self, config: Dict[str, Any]):
        c0, c1, c2, c3 = config["feature_channels"]
        self.initial_samples = int(config["initial_samples"])
        specs = [(3, c0, 3, 1, 1), (c0, c0, 3, 1, 1), (c0, c1, 5, 2, 2), (c1, c1, 3, 1, 1),
                 (c1, c1, 3, 1, 1), (c1, c2, 5, 2, 2), (c2, c2, 3, 1, 1), (c2, c2, 3, 1, 1),
                 (c2, c3, 5, 2, 2), (c3, c3, 3, 1, 1), (c3, c3, 3, 1, 1)]
        self.feature = [_conv(i, o, k, s, p) for i, o, k, s, p in specs]
        self.output1 = _conv(c3, c3, 1, pad=0)
        self.inner1 = _conv(c2, c3, 1, pad=0, bias=True)
        self.inner2 = _conv(c1, c3, 1, pad=0, bias=True)
        self.output2 = _conv(c3, c2, 1, pad=0)
        self.output3 = _conv(c3, c1, 1, pad=0)
        features = {1: c1, 2: c2, 3: c3}
        groups = dict(zip((1, 2, 3), config["stage_groups"]))
        w0, w1 = config["channel_net_widths"]
        self.stages = {}
        for stage in (1, 2, 3):
            i = stage - 1
            opt = {k: config["model"][k][i] for k in config["model"]}
            c, g = features[stage], groups[stage]
            d = int(opt["propagation_range"])
            iterations = int(opt["patchmatch_iteration"])
            kp = int(opt["propagate_neighbors"])
            has_prop = kp > 0 and not (stage == 1 and iterations == 1)
            ke = int(opt["evaluate_neighbors"])
            self.stages[stage] = {
                "features": c, "groups": g, "iterations": iterations,
                "num_samples": int(opt["patchmatch_num_sample"]),
                "interval_scale": float(opt["patchmatch_interval_scale"]),
                "evaluate_neighbors": ke, "propagate_neighbors": kp if has_prop else 0,
                "propa_conv": _conv(c, 2 * kp, 3, 1, d, d, True) if has_prop else None,
                "eval_conv": _conv(c, 2 * ke, 3, 1, d, d, True),
                "channel_net": [_conv(g, w0, 1, pad=0), _conv(w0, w1, 1, pad=0),
                                _conv(w1, 1, 1, pad=0, bias=True)],
                "pixel_wise": stage == 3,
            }
        r = int(config["refinement_channels"])
        self.refinement = {
            "conv0": _conv(3, r), "conv1": _conv(1, r), "conv2": _conv(r, r),
            "deconv": Conv(r, r, (3, 3), (2, 2), (1, 1), (1, 1), False, True, (1, 1)),
            "conv3": _conv(2 * r, r), "res": _conv(r, 1),
        }

    def parameters(self) -> int:
        """Parameters (convolution weights and biases, BatchNorm scales and
        biases), as Adam updates them."""
        bn = lambda conv: 2 * conv.out_channels  # noqa: E731
        total = sum(c.weights + bn(c) for c in self.feature)
        total += sum(c.weights for c in (self.output1, self.inner1, self.inner2, self.output2,
                                         self.output3))
        for st in self.stages.values():
            nets = 3 if st["pixel_wise"] else 2
            net = st["channel_net"]
            total += nets * (sum(c.weights for c in net) + bn(net[0]) + bn(net[1]))
            total += st["eval_conv"].weights
            if st["propa_conv"] is not None:
                total += st["propa_conv"].weights
        ref = self.refinement
        total += sum(ref[k].weights + bn(ref[k]) for k in ("conv0", "conv1", "conv2", "conv3"))
        total += ref["deconv"].weights + 2 * ref["deconv"].out_channels + ref["res"].weights
        return total


class _Counter:
    def __init__(self, precision: str, train: bool):
        self.size = 2 if precision == "bf16" else F32
        self.conv_rate = F32_OPS_PER_S if precision == "f32" else BF16_TENSOR_OPS_PER_S
        self.train = train
        self.rows: List[Row] = []

    def add(self, component, group, work_bytes, flops=0.0, rate=F32_OPS_PER_S, module=None):
        self.rows.append(Row(component, group, float(work_bytes), float(flops), rate, module))

    def glue(self, component, inputs: float, outputs: float, module=None, grad=True,
             flops=0.0) -> None:
        self.add(component, "glue", inputs + outputs, flops, module=module)
        if self.train and grad:
            self.add(f"{component} (backward)", "glue", outputs + 2 * inputs, module=module)

    def conv(self, component, layer: Conv, n: int, h: int, w: int, module: str,
             f32_input: bool = False, input_grad: bool = True):
        (kh, kw), (sh, sw), (ph, pw), (dh, dw) = (layer.kernel_size, layer.stride,
                                                  layer.padding, layer.dilation)
        if layer.transposed:
            oph, opw = layer.output_padding
            ho = (h - 1) * sh - 2 * ph + dh * (kh - 1) + oph + 1
            wo = (w - 1) * sw - 2 * pw + dw * (kw - 1) + opw + 1
        else:
            ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
            wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        cin, cout = layer.in_channels, layer.out_channels
        positions = h * w if layer.transposed else ho * wo
        flops = 2 * n * cin * cout * kh * kw * positions
        weights = layer.weights
        x = n * cin * h * w
        y = n * cout * ho * wo
        s = self.size
        if f32_input and s != F32:
            self.glue(f"{component} input cast", x * F32, x * s, module, grad=input_grad)
        self.add(component, "convolutions", (x + weights + y) * s, flops, self.conv_rate,
                 module)
        if self.train:
            wgrad = y * s + x * s + weights * F32
            dgrad = y * s + weights * s + x * s
            self.add(f"{component} (backward)", "convolutions",
                     wgrad + (dgrad if input_grad else 0),
                     flops * (2 if input_grad else 1), self.conv_rate, module)
        return ho, wo

    def bn_relu(self, component, n: int, c: int, h: int, w: int, module: str) -> None:
        act = n * c * h * w * self.size
        self.glue(component, act * (2 if self.train else 1), act, module)

    def kernel(self, component, name: str, args, out) -> None:
        work_bytes, ops = kernel_work(name, args, out)
        self.add(component, KERNEL_GROUPS[name], work_bytes, ops)


def _feature_net(k: _Counter, arch: Architecture, n: int, h: int, w: int):
    mod = "feature"
    sizes = {}
    for i, layer in enumerate(arch.feature):
        h, w = k.conv(f"FeatureNet conv{i}", layer, n, h, w, mod, f32_input=i == 0,
                      input_grad=i > 0)
        k.bn_relu(f"FeatureNet conv{i} BN+ReLU", n, layer.out_channels, h, w, mod)
        sizes[i] = (h, w)
    (h1, w1), (h2, w2), (h3, w3) = sizes[4], sizes[7], sizes[10]
    s = k.size
    k.conv("FeatureNet output1", arch.output1, n, h3, w3, mod)
    for inner, output, (hi, wi), (hl, wl) in (("inner1", "output2", (h3, w3), (h2, w2)),
                                             ("inner2", "output3", (h2, w2), (h1, w1))):
        lateral = getattr(arch, inner)
        k.conv(f"FeatureNet {inner}", lateral, n, hl, wl, mod)
        c = lateral.out_channels
        k.glue(f"FeatureNet upsample + {inner}", n * c * (hi * wi + hl * wl) * s,
               n * c * hl * wl * s, mod)
        k.conv(f"FeatureNet {output}", getattr(arch, output), n, hl, wl, mod)
    return {1: (h1, w1), 2: (h2, w2), 3: (h3, w3)}


def _channel_net(k: _Counter, layers: Sequence[Conv], label: str, module: str, b: int,
                 depth: int, h: int, w: int, f32_input: bool) -> None:
    positions_h = depth * h
    for i, conv in enumerate(layers):
        k.conv(f"{label} conv{i}", conv, b, positions_h, w, module,
               f32_input=f32_input and i == 0)
        if i < 2:
            k.bn_relu(f"{label} conv{i} BN+ReLU", b, conv.out_channels, positions_h, w, module)


def _stage(k: _Counter, arch: Architecture, stage: int, b: int, views: int, h: int,
           w: int) -> None:
    st, train = arch.stages[stage], k.train
    s = k.size
    mod = f"patchmatch_{stage}"
    c, g = st["features"], st["groups"]
    hw = b * h * w
    ke = st["evaluate_neighbors"]
    kp = st["propagate_neighbors"]
    for name, conv, kn in (("propa_conv", st["propa_conv"], kp),
                           ("eval_conv", st["eval_conv"], ke)):
        if conv is None:
            continue
        k.conv(f"stage {stage} {name}", conv, b, h, w, f"{mod}.{name}")
        k.glue(f"stage {stage} {name} grid", hw * 2 * kn * s, 2 * hw * kn * F32)
    ref = T((b, h, w, c), s)
    src = T((b, h, w, c), s)
    src_stack = T((b, views - 1, h, w, c), s)
    mat12 = T((b, 12), F32)
    mats = T((b, views - 1, 12), F32)
    grid = (T((b, ke, h, w), F32), T((b, ke, h, w), F32))
    emod = f"{mod}.evaluation"
    net = st["channel_net"]
    iterations = st["iterations"]
    for it in range(1, iterations + 1):
        label = f"stage {stage} eval {it}"
        first_stage3 = stage == 3 and it == 1
        d0 = arch.initial_samples if first_stage3 else st["num_samples"]
        propagates = kp and not (stage == 1 and it == iterations)
        d = d0 + (kp if propagates else 0)
        if first_stage3:
            k.glue(f"{label} hypotheses", hw * d0 * F32, hw * d0 * F32, grad=False)
        elif d0 > 1:
            k.glue(f"{label} hypotheses", hw * F32, hw * d0 * F32, grad=False)
        if propagates:
            k.glue(f"{label} propagation", hw * (2 * kp + d0) * F32, hw * d * F32)
        k.glue(f"{label} x_norm", hw * d * F32, hw * d * F32, grad=False)
        depth = T((b, d, h, w), F32)
        volume = b * g * d * h * w * F32
        if not first_stage3 and not train:
            k.kernel(f"{label} K6 (V={views - 1})", "warp_group_corr_views",
                     (src_stack, mats, depth, ref, T((b, views - 1, h, w), F32), g),
                     T((b, g, d, h, w), F32))
            k.glue(f"{label} view-weight normalize", volume, volume // F32 * s)
        else:
            out = T((b, g, d, h, w), F32)
            for v in range(views - 1):
                k.kernel(f"{label} K1 view {v + 1}", "warp_group_corr",
                         (src, mat12, depth, ref, g), out)
                if train:
                    k.kernel(f"{label} K4 view {v + 1}", "warp_group_corr_backward",
                             (src, mat12, depth, ref, g, out), (src, ref))
            if first_stage3:
                for v in range(views - 1):
                    _channel_net(k, net, f"{label} PixelwiseNet", f"{emod}.pixel_wise_net",
                                 b, d, h, w, True)
                    k.glue(f"{label} PixelwiseNet sigmoid + max", b * d * h * w * s, hw * F32,
                           f"{emod}.pixel_wise_net")
            k.glue(f"{label} view-weighted sum", (views - 1) * (volume + hw * F32),
                   volume // F32 * s)
        _channel_net(k, net, f"{label} SimilarityNet", f"{emod}.similarity_net", b, d, h, w,
                     False)
        if it == 1:
            corr = T((b, g, ke, h, w), F32)
            k.kernel(f"{label} K3", "neighbor_group_corr", (ref, grid, g), corr)
            if train:
                k.kernel(f"{label} K5", "neighbor_group_corr_backward",
                         (ref, grid, g, corr), grid)
            _channel_net(k, net, f"{label} FeatureWeightNet", f"{emod}.feature_weight_net",
                         b, ke, h, w, True)
            k.glue(f"{label} FeatureWeightNet sigmoid", b * ke * h * w * s, hw * ke * F32,
                   f"{emod}.feature_weight_net")
        tail_args = (T((b, h, w, d), F32), T((b, h, w, d), s), grid, T((b, ke, h, w), F32),
                     st["interval_scale"])
        score = T((b, h, w, d), F32)
        if train:
            work_bytes, ops = kernel_work("eval_grid_score", tail_args, score)
            k.glue(f"{label} aggregation tail (plain)", work_bytes - nbytes(score),
                   nbytes(score), flops=ops)
        else:
            k.kernel(f"{label} K2", "eval_grid_score", tail_args, score)
        k.glue(f"{label} softmax", hw * d * F32, hw * d * F32)
        k.glue(f"{label} regression", 2 * hw * d * F32, hw * F32)


def count(geometry: Geometry, precision: str, config: Dict[str, Any]) -> List[Row]:
    """The rows of one inference forward (or, for a train geometry, one
    train step) of the configuration's PatchmatchNet at `precision`."""
    if precision not in ("bf16", "f32"):
        raise ValueError(f"precision is bf16 or f32, got {precision!r}")
    h, w, n, b, train = geometry
    if h % 8 or w % 8:
        raise ValueError(f"H, W must be multiples of 8 (got {h}x{w})")
    arch = Architecture(config)
    k = _Counter(precision, train)
    if train:
        for _ in range(n):
            sizes = _feature_net(k, arch, b, h, w)
    else:
        sizes = _feature_net(k, arch, b * n, h, w)
    for stage in (3, 2, 1):
        hs, ws = sizes[stage]
        _stage(k, arch, stage, b, n, hs, ws)
        if stage > 1:
            k.glue(f"stage {stage} upsample", b * n * hs * ws * F32, 4 * b * n * hs * ws * F32,
                   grad=False)
    ref, mod = arch.refinement, "upsample_net"
    h2, w2 = sizes[1]
    r = ref["conv0"].out_channels
    k.glue("Refinement depth normalize", b * h2 * w2 * F32, b * h2 * w2 * F32, mod, grad=False)
    k.conv("Refinement conv0", ref["conv0"], b, h, w, mod, f32_input=True, input_grad=False)
    k.bn_relu("Refinement conv0 BN+ReLU", b, r, h, w, mod)
    k.conv("Refinement conv1", ref["conv1"], b, h2, w2, mod, f32_input=True, input_grad=False)
    k.bn_relu("Refinement conv1 BN+ReLU", b, r, h2, w2, mod)
    k.conv("Refinement conv2", ref["conv2"], b, h2, w2, mod)
    k.bn_relu("Refinement conv2 BN+ReLU", b, r, h2, w2, mod)
    k.conv("Refinement deconv", ref["deconv"], b, h2, w2, mod)
    k.bn_relu("Refinement deconv BN+ReLU", b, r, h, w, mod)
    k.conv("Refinement conv3", ref["conv3"], b, h, w, mod)
    k.bn_relu("Refinement conv3 BN+ReLU", b, r, h, w, mod)
    k.conv("Refinement res", ref["res"], b, h, w, mod)
    k.glue("Refinement residual", b * h2 * w2 * F32 + b * h * w * k.size, b * h * w * F32, mod)
    d1 = arch.stages[1]["num_samples"]
    if train:
        for stage, (hs, ws) in ((0, (h, w)), *((st, sizes[st]) for st in (1, 2, 3))):
            its = 1 if stage == 0 else arch.stages[stage]["iterations"]
            k.glue(f"loss stage {stage}", its * b * hs * ws * (2 * F32 + 1), F32)
        params = arch.parameters()
        k.add(f"Adam ({params:,} parameters)", "glue", 7 * params * F32, 16 * params)
    else:
        k.glue("confidence", b * h2 * w2 * d1 * F32, b * h2 * w2 * F32)
        k.glue("confidence upsample", b * h2 * w2 * F32, b * h * w * F32)
    return k.rows


def summary(rows: Sequence[Row]) -> dict:
    """{"bytes", "flops", "bound_ms", "groups": {group: bound ms}}."""
    groups = {g: 0.0 for g in GROUPS}
    for row in rows:
        groups[row.group] += row.bound[0]
    return {"bytes": sum(r.bytes for r in rows), "flops": sum(r.flops for r in rows),
            "bound_ms": sum(groups.values()),
            "groups": {g: v for g, v in groups.items() if v}}


def cell_bound(config: Dict[str, Any], traffic: Dict[str, Any]) -> dict:
    """`summary` of one unit of a cell's work (a map, or one rank's step) at
    the configuration's precision and the traffic's shapes."""
    train = traffic["kind"] == "train"
    precision = config["train_precision" if train else "precision"]
    geometry = Geometry(traffic["height"], traffic["width"], traffic["views"],
                        traffic["batch"], train)
    return summary(count(geometry, precision, config))
