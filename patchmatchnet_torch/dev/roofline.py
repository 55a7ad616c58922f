"""Speed-of-light bound of the port's inference forward and train step on
one NVIDIA H100: the port of `tools/dev/roofline.py`.

    python -m patchmatchnet_torch.dev.roofline [--geometry dtu|tanks|eth3d|train]
        [--precision bf16|f32]

It only counts: for a geometry (H, W, views, batch), a precision and a
`config.ModelConfig` (the released model's when None) it computes the
bytes and floating-point operations of each component of one forward (or
one train step) and each component's bound, max(bytes / memory rate,
operations / the rate of the unit that runs them), from the published
peaks of an H100 SXM at 700 W; the whole forward's bound is the sum of its
components' bounds. It needs no card and prints no measured time:
`chip_smoke.py` phase 15 (g) holds these bounds against the traced device
time of each group on the card, and `roofline_mfu` = `bound_ms` / the
measured forward ms is the one whole-forward share of peak.

Shapes come from the port's own model: the layers of an instantiated
`PatchmatchNet(model_config)` (FeatureNet, Refinement, each stage's offset
convs, PixelwiseNet, SimilarityNet and FeatureWeightNet) and its stages'
`StageConfig` (iterations, samples, neighbours, C, G). Each component
reads every input tensor once and writes every output tensor once at its
dtype (a convolution: its input, weights and output; a BatchNorm and ReLU
after it: one pass over its output). Convolutions take the rate of the
precision they run in: bf16 on the tensor cores, and f32 on the CUDA
cores, since the f32 model turns TF32 off (`models.net.full_f32`). The
hand kernels' rows are `kernel_work`'s (f32 on the CUDA cores; K10's
bf16 payloads on the tensor cores, the rate its callers pass to `bound`),
the definition `chip_smoke.py`'s kernel table uses. Each row belongs to one
group of a device trace (`utils.trace.trace_group`): "convolutions", the
hand kernels K1-K6 by id, and "glue", the rest.

The train step is the train-mode forward (FeatureNet once per view with
batch statistics, K1 for every evaluation, the plain aggregation tail),
the loss, the backward (dgrad and wgrad of every convolution, dgrad only
where its input needs a gradient; K4 and K5 from `kernel_work`; each glue
row on the gradient path reads its output's gradient and its saved inputs
and writes its inputs' gradients) and the Adam update (p, g, m, v read and
p, m, v written in f32 for every parameter).

Against the JAX tool: its FeatureNet count holds a 64 -> 64 1x1 head at
1/8 resolution twice (`tools/dev/roofline.py:89-91`, `output1` and a copy
of it), where the model has it once; this module follows the model, as
`torch.utils.flop_counter.FlopCounterMode` counts it. The TPU-only rows are
dropped: `quad_tables` (the windowed sampler's tables), the one-hot VPU
compares and gather-ns terms (the one-hot-matmul gather), and the
space-to-depth fold; the port has none of them (ROADMAP North star,
rule 1).
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn

from patchmatchnet_torch.config import ModelConfig

# The card's peak rates (NVIDIA H100 SXM data sheet, dense, at 700 W):
# device memory 3.35 TB/s; f32 outside the tensor cores 67 TFLOP/s; bf16
# on the tensor cores 989 TFLOP/s. Every hand kernel computes in f32 on the
# CUDA cores but K10 on bf16 payloads, which runs its products on the tensor
# cores.
MEMORY_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
PEAKS = "bound from NVIDIA H100 SXM published peaks (700 W)"

F32 = 4
GROUPS = ("convolutions", "K1", "K6", "K2", "K3", "K4", "K5", "glue")
KERNEL_GROUPS = {"warp_group_corr": "K1", "warp_group_corr_views": "K6",
                 "eval_grid_score": "K2", "neighbor_group_corr": "K3",
                 "warp_group_corr_backward": "K4", "neighbor_group_corr_backward": "K5"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def sample_ops(c: int) -> int:
    """f32 operations to reduce one sample of a C-channel map (K1, K3, K7):
    4 bilinear taps x C multiply-adds, C multiply-adds with the reference,
    and ~24 for the cell, the weights and the group scaling."""
    return 10 * c + 24


def kernel_work(name: str, args, out) -> tuple:
    """(bytes, operations) one call of kernel `name` must do on these
    inputs: each input read once and each output written once, and its
    f32 arithmetic (a multiply-add is 2 operations). Meta tensors will do:
    only shapes and dtypes are read."""
    if name == "warp_group_corr":  # src, mat12, depth, ref, g
        src, _, depth, _, _ = args
        return nbytes(*args[:4], out), depth.numel() * sample_ops(src.shape[-1])
    if name == "coord_group_corr":  # src, ix, iy, ref, g
        src, ix, _, _, _ = args
        return nbytes(*args[:4], out), ix.numel() * sample_ops(src.shape[-1])
    if name == "warp_group_corr_views":  # src [B,V,...], mats, depth, ref, vw, g
        src, _, depth, _, _, g = args
        per_view = sample_ops(src.shape[-1]) + 2 * g  # and the weighted sum
        return nbytes(*args[:5], out), depth.numel() * src.shape[1] * per_view
    if name == "neighbor_group_corr":  # ref, (gx, gy), g
        ref, (gx, gy), _ = args
        return nbytes(ref, gx, gy, out), gx.numel() * sample_ops(ref.shape[-1])
    if name == "eval_grid_score":  # x_norm, cost, (gx, gy), fw, interval
        x_norm, cost, (gx, gy), fw, _ = args
        # per (pixel, hypothesis, neighbour): 2 four-tap samples, the
        # sigmoid weight and the two sums, ~40 operations
        return nbytes(x_norm, cost, gx, gy, fw, out), x_norm.numel() * gx.shape[1] * 40
    if name == "warp_group_corr_backward":  # src, mat12, depth, ref, g, dout
        src, _, depth, _, _, dout = args
        return (nbytes(*args[:4], dout, *out),
                depth.numel() * (2 * sample_ops(src.shape[-1])))
    if name == "neighbor_group_corr_backward":  # ref, (gx, gy), g, dout
        ref, (gx, gy), _, dout = args
        return nbytes(ref, gx, gy, dout, *out), gx.numel() * (sample_ops(ref.shape[-1]) + 8)
    if name == "variance_volume":  # ref, src, mats, depth (K8)
        ref, src, _, depth = args
        c = ref.shape[-1]
        # per sample and source view its warp (~20 operations) and per
        # channel the bilinear tap and the two sums (11); per value the
        # reference's square and the variance (5)
        per_sample = src.shape[1] * (20 + 11 * c) + 5 * c
        return nbytes(*args, out), depth.numel() * per_sample
    if name == "prob_conv3d":  # x [B, 8, D, H, W], weight [1, 8, 3, 3, 3] (K9)
        x, weight = args
        return nbytes(x, weight, out), out.numel() * 2 * weight.numel()
    if name == "conv3d_block":  # x, conv, bn, dtype, skip (K10)
        x, conv, bn, _, skip = args
        params = (conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)
        # a transposed convolution's products are those of its input positions
        positions = x if isinstance(conv, nn.ConvTranspose3d) else out
        flops = 2 * conv.weight.numel() * (positions.numel() // positions.shape[1])
        return nbytes(x, *params, out, *([] if skip is None else [skip])), flops
    raise KeyError(name)


def bound(work_bytes: float, work_ops: float, ops_per_s: float = F32_OPS_PER_S):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    by_bytes = work_bytes / MEMORY_BYTES_PER_S * 1e3
    by_ops = work_ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


class Geometry(NamedTuple):
    height: int
    width: int
    views: int  # the reference and its sources
    batch: int
    train: bool  # a train step; else an inference forward


GEOMETRIES = {
    "dtu": Geometry(864, 1152, 5, 1, False),  # the bench's `value`
    "tanks": Geometry(1056, 1920, 7, 1, False),
    "eth3d": Geometry(1792, 2688, 7, 1, False),  # bucket 64 (dev/bench_dataset_configs.py)
    "train": Geometry(512, 640, 5, 2, True),  # the bench's train side
}


@dataclass
class Row:
    """One component's work: `module` is the port module it runs in (a
    name under `PatchmatchNet`, None outside one), `group` its trace
    group."""

    component: str
    group: str
    bytes: float
    flops: float
    ops_per_s: float
    module: Optional[str] = None

    @property
    def bound(self):
        return bound(self.bytes, self.flops, self.ops_per_s)


def _meta(shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


class _Counter:
    """Collects the rows of one forward or train step."""

    def __init__(self, dtype: torch.dtype, train: bool):
        self.size = torch.finfo(dtype).bits // 8  # payload bytes per element
        self.dtype = dtype
        self.conv_rate = F32_OPS_PER_S if dtype == torch.float32 else BF16_TENSOR_OPS_PER_S
        self.train = train
        self.rows: List[Row] = []

    def add(self, component, group, work_bytes, flops=0.0, rate=F32_OPS_PER_S, module=None):
        self.rows.append(Row(component, group, float(work_bytes), float(flops), rate, module))

    def glue(self, component, inputs: float, outputs: float, module=None, grad=True,
             flops=0.0) -> None:
        """An element-wise step reading `inputs` and writing `outputs`
        bytes; in a train step its backward (where `grad`) reads the
        gradient of its outputs and its saved inputs and writes its inputs'
        gradients."""
        self.add(component, "glue", inputs + outputs, flops, module=module)
        if self.train and grad:
            self.add(f"{component} (backward)", "glue", outputs + 2 * inputs, module=module)

    def conv(self, component, layer: nn.Module, n: int, h: int, w: int, module: str,
             f32_input: bool = False, input_grad: bool = True):
        """`layer` (an nn.Conv2d or nn.ConvTranspose2d) over n images of
        h x w in the payload dtype; an f32 input (`f32_input`) of a bf16
        model is cast first, as `models.layers.conv2d` casts it. Returns
        (h, w) of its output. In a train step, its backward: dgrad where
        `input_grad`, wgrad."""
        (kh, kw), (sh, sw), (ph, pw), (dh, dw) = (layer.kernel_size, layer.stride,
                                                  layer.padding, layer.dilation)
        transposed = isinstance(layer, nn.ConvTranspose2d)
        if transposed:
            oph, opw = layer.output_padding
            ho = (h - 1) * sh - 2 * ph + dh * (kh - 1) + oph + 1
            wo = (w - 1) * sw - 2 * pw + dw * (kw - 1) + opw + 1
        else:
            ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
            wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        cin, cout = layer.in_channels, layer.out_channels
        positions = h * w if transposed else ho * wo
        flops = 2 * n * cin * cout * kh * kw * positions
        weights = layer.weight.numel() + (0 if layer.bias is None else layer.bias.numel())
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
        """BatchNorm and ReLU after a convolution: one pass over its output
        with the folded running statistics; with batch statistics (train)
        one more read for the mean and the mean square."""
        act = n * c * h * w * self.size
        self.glue(component, act * (2 if self.train else 1), act, module)

    def kernel(self, component, name: str, args, out) -> None:
        work_bytes, ops = kernel_work(name, args, out)
        self.add(component, KERNEL_GROUPS[name], work_bytes, ops)


def _feature_net(k: _Counter, net: nn.Module, n: int, h: int, w: int) -> Dict[int, tuple]:
    """FeatureNet's 11 ConvBnReLU layers and its lateral 1x1 convs over n
    images (`models/feature.py`); returns {stage: (h, w)}."""
    mod = "feature"
    sizes = {}
    for i in range(11):
        layer = getattr(net, f"conv{i}")
        h, w = k.conv(f"FeatureNet conv{i}", layer.conv, n, h, w, mod, f32_input=i == 0,
                      input_grad=i > 0)
        k.bn_relu(f"FeatureNet conv{i} BN+ReLU", n, layer.conv.out_channels, h, w, mod)
        sizes[i] = (h, w)
    (h1, w1), (h2, w2), (h3, w3) = sizes[4], sizes[7], sizes[10]
    s = k.size
    k.conv("FeatureNet output1", net.output1, n, h3, w3, mod)
    for inner, output, (hi, wi), (hl, wl) in (("inner1", "output2", (h3, w3), (h2, w2)),
                                             ("inner2", "output3", (h2, w2), (h1, w1))):
        lateral = getattr(net, inner)
        k.conv(f"FeatureNet {inner}", lateral, n, hl, wl, mod)
        c = lateral.out_channels
        # bilinear x2 of the coarser map plus the lateral: read both, write the sum
        k.glue(f"FeatureNet upsample + {inner}", n * c * (hi * wi + hl * wl) * s,
               n * c * hl * wl * s, mod)
        k.conv(f"FeatureNet {output}", getattr(net, output), n, hl, wl, mod)
    return {1: (h1, w1), 2: (h2, w2), 3: (h3, w3)}


def _channel_net(k: _Counter, net: nn.Module, label: str, module: str, b: int, depth: int,
                 h: int, w: int, f32_input: bool) -> None:
    """PixelwiseNet, SimilarityNet or FeatureWeightNet: two DenseBnReLU and
    a Dense1 over [b, C, depth, h, w] (1x1 convolutions over depth * h
    rows of w)."""
    positions_h = depth * h
    layers = [net.conv0, net.conv1, getattr(net, "conv2", None) or net.similarity]
    for i, layer in enumerate(layers):
        conv = getattr(layer, "conv", None) or layer.dense
        k.conv(f"{label} conv{i}", conv, b, positions_h, w, module,
               f32_input=f32_input and i == 0)
        if hasattr(layer, "bn"):
            k.bn_relu(f"{label} conv{i} BN+ReLU", b, conv.out_channels, positions_h, w, module)


def _stage(k: _Counter, pm: nn.Module, stage: int, b: int, views: int, h: int,
           w: int) -> None:
    """One PatchMatch stage (`models/patchmatch.py` `PatchMatch.forward`):
    its offset convs and grids, then each evaluation."""
    cfg, train = pm.config, k.train
    s, dt = k.size, k.dtype
    mod = f"patchmatch_{stage}"
    c, g = cfg.features, cfg.groups
    hw = b * h * w
    ke = cfg.evaluate_neighbors
    kp = cfg.propagate_neighbors if pm.has_propagation else 0
    for name, conv, kn in (("propa_conv", getattr(pm, "propa_conv", None), kp),
                           ("eval_conv", pm.eval_conv, ke)):
        if conv is None:
            continue
        k.conv(f"stage {stage} {name}", conv.conv2d, b, h, w, f"{mod}.{name}")
        # offsets -> normalized (gx, gy) of the kn neighbours
        k.glue(f"stage {stage} {name} grid", hw * 2 * kn * s, 2 * hw * kn * F32)
    ref = _meta((b, h, w, c), dt)
    src = _meta((b, h, w, c), dt)
    src_stack = _meta((b, views - 1, h, w, c), dt)
    mat12 = _meta((b, 12), torch.float32)
    mats = _meta((b, views - 1, 12), torch.float32)
    grid = (_meta((b, ke, h, w), torch.float32), _meta((b, ke, h, w), torch.float32))
    emod = f"{mod}.evaluation"
    for it in range(1, cfg.iterations + 1):
        label = f"stage {stage} eval {it}"
        first_stage3 = stage == 3 and it == 1
        d0 = 48 if first_stage3 else cfg.num_samples
        propagates = kp and not (stage == 1 and it == cfg.iterations)
        d = d0 + (kp if propagates else 0)
        # hypotheses: stratified from the noise or perturbed around the
        # previous depth (none for one sample), propagation (the middle
        # hypothesis at kp neighbours, appended and sorted), x_norm
        if first_stage3:
            k.glue(f"{label} hypotheses", hw * d0 * F32, hw * d0 * F32, grad=False)
        elif d0 > 1:
            k.glue(f"{label} hypotheses", hw * F32, hw * d0 * F32, grad=False)
        if propagates:
            k.glue(f"{label} propagation", hw * (2 * kp + d0) * F32, hw * d * F32)
        k.glue(f"{label} x_norm", hw * d * F32, hw * d * F32, grad=False)
        depth = _meta((b, d, h, w), torch.float32)
        volume = b * g * d * h * w * F32
        if not first_stage3 and not train:
            k.kernel(f"{label} K6 (V={views - 1})", "warp_group_corr_views",
                     (src_stack, mats, depth, ref, _meta((b, views - 1, h, w), torch.float32), g),
                     _meta((b, g, d, h, w), torch.float32))
            k.glue(f"{label} view-weight normalize", volume, volume // F32 * s)
        else:
            out = _meta((b, g, d, h, w), torch.float32)
            for v in range(views - 1):
                k.kernel(f"{label} K1 view {v + 1}", "warp_group_corr",
                         (src, mat12, depth, ref, g), out)
                if train:
                    k.kernel(f"{label} K4 view {v + 1}", "warp_group_corr_backward",
                             (src, mat12, depth, ref, g, out), (src, ref))
            if first_stage3:  # the view weights are made here
                for v in range(views - 1):
                    _channel_net(k, pm.evaluation.pixel_wise_net, f"{label} PixelwiseNet",
                                 f"{emod}.pixel_wise_net", b, d, h, w, True)
                    k.glue(f"{label} PixelwiseNet sigmoid + max", b * d * h * w * s, hw * F32,
                           f"{emod}.pixel_wise_net")
            # the views' weighted sum, normalized, in the payload dtype
            k.glue(f"{label} view-weighted sum", (views - 1) * (volume + hw * F32),
                   volume // F32 * s)
        _channel_net(k, pm.evaluation.similarity_net, f"{label} SimilarityNet",
                     f"{emod}.similarity_net", b, d, h, w, False)
        if it == 1:
            corr = _meta((b, g, ke, h, w), torch.float32)
            k.kernel(f"{label} K3", "neighbor_group_corr", (ref, grid, g), corr)
            if train:
                k.kernel(f"{label} K5", "neighbor_group_corr_backward",
                         (ref, grid, g, corr), grid)
            _channel_net(k, pm.evaluation.feature_weight_net, f"{label} FeatureWeightNet",
                         f"{emod}.feature_weight_net", b, ke, h, w, True)
            k.glue(f"{label} FeatureWeightNet sigmoid", b * ke * h * w * s, hw * ke * F32,
                   f"{emod}.feature_weight_net")
        tail_args = (_meta((b, h, w, d), torch.float32), _meta((b, h, w, d), dt), grid,
                     _meta((b, ke, h, w), torch.float32), cfg.interval_scale)
        score = _meta((b, h, w, d), torch.float32)
        if train:  # the plain tail (`eval_grid_score_reference`)
            work_bytes, ops = kernel_work("eval_grid_score", tail_args, score)
            k.glue(f"{label} aggregation tail (plain)", work_bytes - nbytes(score),
                   nbytes(score), flops=ops)
        else:
            k.kernel(f"{label} K2", "eval_grid_score", tail_args, score)
        # softmax over D; regression: the probabilities against the hypotheses
        k.glue(f"{label} softmax", hw * d * F32, hw * d * F32)
        k.glue(f"{label} regression", 2 * hw * d * F32, hw * F32)


def count(geometry: Geometry, precision: str = "bf16",
          model_config: Optional[ModelConfig] = None) -> List[Row]:
    """The rows of one inference forward (or, for a train geometry, one
    train step) of `PatchmatchNet(model_config)` at `precision`."""
    from patchmatchnet_torch.models import PatchmatchNet

    if precision not in ("bf16", "f32"):
        raise ValueError(f"precision is bf16 or f32, got {precision!r}")
    dt = torch.bfloat16 if precision == "bf16" else torch.float32
    h, w, n, b, train = geometry
    if h % 8 or w % 8:
        raise ValueError(f"H, W must be multiples of 8 (got {h}x{w})")
    model = PatchmatchNet(model_config, compute_dtype=dt)
    k = _Counter(dt, train)
    s = k.size
    if train:
        for _ in range(n):  # one call per view (per-view batch statistics)
            sizes = _feature_net(k, model.feature, b, h, w)
    else:
        sizes = _feature_net(k, model.feature, b * n, h, w)
    for stage in (3, 2, 1):
        hs, ws = sizes[stage]
        _stage(k, getattr(model, f"patchmatch_{stage}"), stage, b, n, hs, ws)
        if stage > 1:  # depth and view weights to the next stage
            k.glue(f"stage {stage} upsample", b * n * hs * ws * F32, 4 * b * n * hs * ws * F32,
                   grad=False)
    # Refinement (`models/refinement.py`) at full resolution from stage 1's
    # half-resolution depth
    ref_net, mod = model.upsample_net, "upsample_net"
    h2, w2 = sizes[1]
    k.glue("Refinement depth normalize", b * h2 * w2 * F32, b * h2 * w2 * F32, mod, grad=False)
    k.conv("Refinement conv0", ref_net.conv0.conv, b, h, w, mod, f32_input=True,
           input_grad=False)
    k.bn_relu("Refinement conv0 BN+ReLU", b, 8, h, w, mod)
    k.conv("Refinement conv1", ref_net.conv1.conv, b, h2, w2, mod, f32_input=True,
           input_grad=False)
    k.bn_relu("Refinement conv1 BN+ReLU", b, 8, h2, w2, mod)
    k.conv("Refinement conv2", ref_net.conv2.conv, b, h2, w2, mod)
    k.bn_relu("Refinement conv2 BN+ReLU", b, 8, h2, w2, mod)
    k.conv("Refinement deconv", ref_net.deconv, b, h2, w2, mod)
    k.bn_relu("Refinement deconv BN+ReLU", b, 8, h, w, mod)
    k.conv("Refinement conv3", ref_net.conv3.conv, b, h, w, mod)
    k.bn_relu("Refinement conv3 BN+ReLU", b, 8, h, w, mod)
    k.conv("Refinement res", ref_net.res, b, h, w, mod)
    k.glue("Refinement residual", b * h2 * w2 * F32 + b * h * w * s, b * h * w * F32, mod)
    d1 = model.patchmatch_1.config.num_samples
    if train:
        # the masked smooth-L1 of every depth of every stage: each read with
        # its ground truth (f32) and mask (bool), one scalar out
        for stage, (hs, ws) in ((0, (h, w)), *((st, sizes[st]) for st in (1, 2, 3))):
            its = 1 if stage == 0 else getattr(model, f"patchmatch_{stage}").config.iterations
            k.glue(f"loss stage {stage}", its * b * hs * ws * (2 * F32 + 1), F32)
        params = sum(p.numel() for p in model.parameters())
        # Adam: p, g, m, v read, p, m, v written, f32; ~16 operations each
        k.add(f"Adam ({params:,} parameters)", "glue", 7 * params * F32, 16 * params)
    else:
        # photometric confidence: the final score's 4-hypothesis window at
        # the regressed index, upsampled x2
        k.glue("confidence", b * h2 * w2 * d1 * F32, b * h2 * w2 * F32)
        k.glue("confidence upsample", b * h2 * w2 * F32, b * h * w * F32)
    return k.rows


def summary(rows: Sequence[Row]) -> dict:
    """{"bytes", "flops", "bound_ms", "groups": {group: bound ms}}: the
    whole bound is the sum of the rows' bounds."""
    groups = {g: 0.0 for g in GROUPS}
    for row in rows:
        groups[row.group] += row.bound[0]
    return {"bytes": sum(r.bytes for r in rows), "flops": sum(r.flops for r in rows),
            "bound_ms": sum(groups.values()),
            "groups": {g: v for g, v in groups.items() if v}}


def roofline_mfu(bound_ms: float, measured_ms: float) -> float:
    """The whole forward's (or step's) share of peak: its bound over the
    measured time on the card."""
    return bound_ms / measured_ms


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--geometry", choices=sorted(GEOMETRIES), default="dtu")
    parser.add_argument("--precision", choices=("bf16", "f32"), default="bf16")
    args = parser.parse_args(argv)
    geometry = GEOMETRIES[args.geometry]
    rows = count(geometry, args.precision)
    what = "train step" if geometry.train else "forward"
    print(f"{args.geometry} {what}, {geometry.width}x{geometry.height}, N={geometry.views}, "
          f"B={geometry.batch}, {args.precision}: {PEAKS}")
    print(f"{'component':52s} {'group':12s} {'MB':>9s} {'GFLOP':>9s} {'bound':>10s} "
          f"{'ms':>8s}")
    for row in rows:
        ms, kind = row.bound
        print(f"{row.component:52s} {row.group:12s} {row.bytes / 1e6:9.3f} "
              f"{row.flops / 1e9:9.3f} {kind:>10s} {ms:8.4f}")
    total = summary(rows)
    print("groups: " + ", ".join(f"{g} {ms:.4f} ms" for g, ms in total["groups"].items()))
    print(f"total {total['bytes'] / 1e6:.1f} MB, {total['flops'] / 1e9:.1f} GFLOP; bound "
          f"{total['bound_ms']:.4f} ms ({PEAKS})")
    print(json.dumps({"geometry": args.geometry, "step": what, "precision": args.precision,
                      "height": geometry.height, "width": geometry.width,
                      "views": geometry.views, "batch": geometry.batch, **total,
                      "peaks": PEAKS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
