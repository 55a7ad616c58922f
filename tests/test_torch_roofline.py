"""The port's roofline (`patchmatchnet_torch.dev.roofline`) on the CPU,
before its bounds meet the card (`chip_smoke.py` phase 15 (g)).

- Convolution FLOPs, exactly: at 64x80, N=3, B=1, for the released
  configuration and phase 12 (c)'s variant, in f32 and bf16, the rows of
  each module (FeatureNet, Refinement, each stage's offset convs,
  PixelwiseNet, SimilarityNet and FeatureWeightNet) equal
  `torch.utils.flop_counter.FlopCounterMode`'s count for that module over
  one inference forward and over one train step's forward; the train
  step's backward rows (dgrad and wgrad) equal its convolution-backward
  count over the whole step.
- Bytes, as a bound: each module's rows (FeatureNet, Refinement and each
  stage's three channel nets) move at most what a `TorchDispatchMode`
  counts as read and written by the plain program's aten ops inside that
  module (module hooks attribute them; views move nothing and are not
  counted), and the whole forward's rows at most the whole forward's count.
- Kernel rows unchanged: `kernel_work` over the DTU main path's launches
  gives PERF.md's kernel-table bounds per forward (bound of the summed
  bytes and operations): K1 0.048, K6 0.086, K2 0.029, K3 0.029 ms.
- Against the JAX tool: at 1152x864, N=5, FeatureNet's MACs equal
  `tools/dev/roofline.py`'s `feature_component().macs` less the 64 -> 64
  head at 1/8 that it counts twice (the model has it once).
- `main` prints the table and one JSON line at every geometry, labelled
  with the published peaks, and no measured time.
"""

import collections
import importlib.util
import io
import json
import os
import sys
from contextlib import redirect_stdout

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from patchmatchnet_torch.bench import build_inputs
from patchmatchnet_torch.config import ModelConfig
from patchmatchnet_torch.data import plane_batch
from patchmatchnet_torch.dev import roofline
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.train import batch_to_device, make_optimizer, train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, VIEWS = 64, 80, 3
# phase 12 (c)'s configuration (chip_smoke.py VARIANT_FLAGS), stages 1, 2, 3
VARIANT = ModelConfig(propagate_neighbors=(4, 8, 16), evaluate_neighbors=(17, 9, 17),
                      patchmatch_iteration=(2, 1, 2), patchmatch_num_sample=(8, 12, 16))
CONFIGS = {"released": None, "variant": VARIANT}
DTYPES = {"f32": None, "bf16": torch.bfloat16}
# PERF.md's kernel table: bound ms per DTU forward
KERNEL_TABLE = {"K1": 0.048, "K6": 0.086, "K2": 0.029, "K3": 0.029}


def _modules(model: PatchmatchNet):
    """The modules whose rows are held: FeatureNet, Refinement and each
    stage's offset convs and channel nets."""
    names = ["feature", "upsample_net"]
    for stage in (3, 2, 1):
        pm = getattr(model, f"patchmatch_{stage}")
        prefix = f"patchmatch_{stage}"
        names += [f"{prefix}.{n}" for n in ("propa_conv", "eval_conv") if hasattr(pm, n)]
        names += [f"{prefix}.evaluation.{n}" for n in
                  ("pixel_wise_net", "similarity_net", "feature_weight_net")
                  if hasattr(pm.evaluation, n)]
    return names


def _rows(rows, module, group=None):
    return [r for r in rows if r.module == module and (group is None or r.group == group)]


def _forward_inputs():
    arrays = build_inputs(1, VIEWS, H, W)
    return [torch.from_numpy(a) for a in arrays]


def _conv_flops(model, run):
    """FlopCounterMode's forward convolution FLOPs per held module and its
    convolution-backward FLOPs over the whole run."""
    with FlopCounterMode(display=False) as counter:
        run()
    counts = {name: {str(op): n for op, n in ops.items()}
              for name, ops in counter.get_flop_counts().items()}
    per_module = {name: counts.get(f"PatchmatchNet.{name}", {}).get("aten.convolution", 0)
                  for name in _modules(model)}
    return per_module, counts["Global"].get("aten.convolution_backward", 0)


def _backward(row):
    return row.component.endswith("(backward)")


@pytest.mark.parametrize("precision", sorted(DTYPES))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_forward_conv_flops_equal_flop_counter(config, precision):
    model = PatchmatchNet(CONFIGS[config], compute_dtype=DTYPES[precision])
    images, intr, extr, dmin, dmax, noise = _forward_inputs()

    def run():
        with torch.inference_mode():
            model(images, intr, extr, dmin, dmax, init_noise=noise)

    counted, backward = _conv_flops(model, run)
    rows = roofline.count(roofline.Geometry(H, W, VIEWS, 1, False), precision, CONFIGS[config])
    assert backward == 0 and not any(_backward(r) for r in rows)
    for name, want in counted.items():
        got = sum(r.flops for r in _rows(rows, name, "convolutions"))
        assert want > 0 and got == want, (name, got, want)


@pytest.mark.parametrize("precision", sorted(DTYPES))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_train_step_conv_flops_equal_flop_counter(config, precision):
    """The forward per module; the backward (dgrad and wgrad) over the
    whole step, since FlopCounterMode's module tracker files backward ops
    under the wrong module here (FeatureNet's under Refinement)."""
    model = PatchmatchNet(CONFIGS[config], compute_dtype=DTYPES[precision])
    arrays = plane_batch(1, VIEWS, H, W)
    batch = batch_to_device(arrays, torch.device("cpu"))
    optimizer = make_optimizer(model.parameters(), 1e-3)
    counted, backward = _conv_flops(model, lambda: train_step(
        model, optimizer, batch, 1e-3, torch.from_numpy(arrays["noise"])))
    rows = roofline.count(roofline.Geometry(H, W, VIEWS, 1, True), precision, CONFIGS[config])
    for name, want in counted.items():
        got = sum(r.flops for r in _rows(rows, name, "convolutions") if not _backward(r))
        assert want > 0 and got == want, (name, got, want)
    got = sum(r.flops for r in rows if r.group == "convolutions" and _backward(r))
    assert backward > 0 and got == backward, (got, backward)


class _ByteCounter(TorchDispatchMode):
    """Bytes each aten op reads and writes (its tensor arguments and
    results; views move none), summed under every module on the stack of
    the modules running it ("" is the whole run)."""

    def __init__(self, model):
        super().__init__()
        self.names = {id(m): name for name, m in model.named_modules() if name}
        self.stack = []
        self.bytes = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            moved = sum(t.numel() * t.element_size() for t in tree_leaves((args, kwargs, out))
                        if isinstance(t, torch.Tensor))
            for name in {"", *self.stack}:
                self.bytes[name] += moved
        return out

    def _leave(self, module, args, output) -> None:  # None keeps the module's output
        self.stack.pop()

    def __enter__(self):
        pre = torch.nn.modules.module.register_module_forward_pre_hook(
            lambda m, _: self.stack.append(self.names.get(id(m), "")))
        post = torch.nn.modules.module.register_module_forward_hook(self._leave)
        self.handles = (pre, post)
        return super().__enter__()

    def __exit__(self, *exc):
        for handle in self.handles:
            handle.remove()
        return super().__exit__(*exc)


@pytest.mark.parametrize("precision", sorted(DTYPES))
def test_bytes_at_most_what_the_program_moves(precision):
    model = PatchmatchNet(compute_dtype=DTYPES[precision])
    images, intr, extr, dmin, dmax, noise = _forward_inputs()
    counter = _ByteCounter(model)
    with torch.inference_mode(), counter:
        model(images, intr, extr, dmin, dmax, init_noise=noise)
    rows = roofline.count(roofline.Geometry(H, W, VIEWS, 1, False), precision)
    held = [n for n in _modules(model) if not n.endswith("_conv")]
    for name in held:
        got = sum(r.bytes for r in _rows(rows, name))
        print(f"{name}: {got / counter.bytes[name]:.3f} of what the program moves")
        assert 0 < got <= counter.bytes[name], (name, got, counter.bytes[name])
    total = sum(r.bytes for r in rows)
    print(f"forward: {total / counter.bytes[''] :.3f} of what the program moves")
    assert 0 < total <= counter.bytes[""], (total, counter.bytes[""])


def test_kernel_rows_give_the_kernel_table_bounds():
    rows = roofline.count(roofline.GEOMETRIES["dtu"], "bf16")
    for group, want in KERNEL_TABLE.items():
        mine = [r for r in rows if r.group == group]
        ms, _ = roofline.bound(sum(r.bytes for r in mine), sum(r.flops for r in mine))
        assert round(ms, 3) == want, (group, ms)
    launches = collections.Counter(r.group for r in rows if r.group in KERNEL_TABLE)
    assert launches == {"K1": 4, "K6": 4, "K2": 5, "K3": 3}


def test_feature_net_macs_equal_the_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_roofline", os.path.join(REPO, "tools", "dev", "roofline.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = jax_tool  # its dataclass looks its module up
    try:
        spec.loader.exec_module(jax_tool)
        want = jax_tool.feature_component().macs
    finally:
        del sys.modules[spec.name]
    rows = roofline.count(roofline.GEOMETRIES["dtu"], "bf16")
    macs = sum(r.flops for r in _rows(rows, "feature", "convolutions")) // 2
    views, h8, w8 = 5, 864 // 8, 1152 // 8
    assert macs == want - 64 * 64 * h8 * w8 * views


@pytest.mark.parametrize("geometry", sorted(roofline.GEOMETRIES))
def test_main_prints_the_table_and_one_json_line(geometry):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert roofline.main(["--geometry", geometry, "--precision", "bf16"]) == 0
    lines = buf.getvalue().strip().splitlines()
    assert roofline.PEAKS in lines[0]
    record = json.loads(lines[-1])
    assert record["geometry"] == geometry and record["peaks"] == roofline.PEAKS
    assert record["bound_ms"] == pytest.approx(sum(record["groups"].values()))
    assert set(record["groups"]) <= set(roofline.GROUPS) and record["bound_ms"] > 0
    assert not any("measured" in line for line in lines)
