"""The port's bench (`python -m patchmatchnet_torch.bench`) against the root
bench.py, on the CPU at small sizes.

- `build_inputs` and the per-call noise stack equal bench.py's to the bit.
- The bench's forward (`bench.load_model` + `bench.forward`) on those
  inputs against the JAX model with the same weights and noise: f32 at the
  golden bounds of `tests/test_torch_model.py` `_check_against`
  (per-stage max < 2e-3 and mean < 2e-4 of the depth range, final depth
  within 2e-3 of the range, confidence: at most 0.1% of the pixels off by
  more than 5e-3, median below 1e-4); bf16 at the bounds of
  `test_bf16_matches_jax_bf16` (final depth relative to the range: median
  < 5e-3, 99th percentile < 0.1, max < 0.3; the port's median
  bf16-vs-f32 delta at most 2x the JAX model's; confidence median < 2e-2).
  That test's bound of the median port-vs-JAX difference below the JAX
  model's own bf16-vs-f32 median is not taken: on these random images the
  two bf16 paths, rounding at different points, differ from each other by
  about as much as each differs from f32 (at 48x96, N=7: port vs JAX 0.325,
  JAX bf16 vs f32 0.247, port bf16 vs f32 0.315 depth units, 6e-4 of the
  range), where the golden fixtures' real images leave that margin.
- The command line prints one JSON line whose keys, unit and metric string
  are bench.py's for the same arguments (bench.py's record made by its own
  `main`, with its timed work replaced: its forward by a stub and its train
  step's model and step by stubs), less the train record's `vs_baseline`,
  which the port leaves out; the value is positive.
- The side sections record their exceptions and the deadline as bench.py
  does, and `--device cuda` without CUDA exits non-zero naming
  `torch.cuda.is_available`.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from patchmatchnet_torch import bench
from patchmatchnet_tpu.compat import load_variables
from patchmatchnet_tpu.models import PatchmatchNet as JaxPatchmatchNet
from tests.test_torch_model import _check_against

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "params_000007.msgpack")
SHAPES = [(1, 5, 64, 80), (1, 7, 48, 96)]  # (B, N, H, W)
SMALL = ["--height", "64", "--width", "80", "--iters", "1", "--warmup", "0"]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_build_inputs_equal_bench_py(shape):
    ours, ref = bench.build_inputs(*shape), jax_bench.build_inputs(*shape)
    assert len(ours) == len(ref) == 6
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    # bench.py's staged noise of warm-up + timed calls (bench.py:358-368)
    count, shape_n = 4, ref[-1].shape
    want = np.stack([np.random.default_rng(100 + s).random(shape_n, np.float32)
                     for s in range(count)])
    got = bench.call_noises(count, shape_n)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.fixture(scope="module")
def outputs():
    """(shape, "f32"|"bf16") -> ((port depth, confidence, stages),
    (JAX depth, confidence, stages)) as numpy, on bench inputs."""
    variables = load_variables(CKPT)
    cache = {}

    def run(shape, precision):
        if (shape, precision) not in cache:
            images, intr, extr, dmin, dmax, noise = bench.build_inputs(*shape)
            model = bench.load_model(precision == "bf16", torch.device("cpu"))
            depth, conf, dp = bench.forward(
                model, [torch.from_numpy(a) for a in (images, intr, extr, dmin, dmax)],
                torch.from_numpy(noise))
            ours = (depth.numpy(), conf.numpy(),
                    {s: [d.numpy() for d in v] for s, v in dp.items()})
            jmodel = JaxPatchmatchNet(compute_dtype=jnp.bfloat16 if precision == "bf16" else None)
            fwd = jax.jit(lambda v, *a, noise: jmodel.apply(v, *a, train=False, init_noise=noise))
            jd, jc, jdp = fwd(variables,
                              *[jnp.asarray(a) for a in (images, intr, extr, dmin, dmax)],
                              noise=jnp.asarray(noise))
            cache[shape, precision] = (ours, (np.asarray(jd), np.asarray(jc),
                                              jax.tree.map(np.asarray, jdp)))
        return cache[shape, precision]

    yield run
    jax.clear_caches()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_f32_matches_jax(outputs, shape):
    ours, ref = outputs(shape, "f32")
    _check_against(ours, ref, 935.0 - 425.0)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_bf16_matches_jax(outputs, shape):
    depth_range = 935.0 - 425.0
    ours, ref = outputs(shape, "bf16")
    ours_f32, ref_f32 = outputs(shape, "f32")
    assert np.isfinite(ours[0]).all() and ours[0].shape == ref[0].shape
    rel = np.abs(ours[0] - ref[0]) / depth_range
    assert np.median(rel) < 5e-3, np.median(rel)
    assert np.quantile(rel, 0.99) < 0.1, np.quantile(rel, 0.99)
    assert rel.max() < 0.3, rel.max()
    jax_bf16_delta = np.median(np.abs(ref[0] - ref_f32[0]))
    port_bf16_delta = np.median(np.abs(ours[0] - ours_f32[0]))
    assert port_bf16_delta <= 2.0 * jax_bf16_delta, (port_bf16_delta, jax_bf16_delta)
    assert np.median(np.abs(ours[1] - ref[1])) < 2e-2


def _port_record(argv):
    """The last stdout line of the port's bench on the CPU, as JSON."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "patchmatchnet_torch.bench", "--device", "cpu",
                           *argv], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    return json.loads(lines[0])


def _bench_py_record(monkeypatch, capsys, argv):
    """bench.py's record for `argv`, made by its own main() with the timed
    work stubbed: no compile cache, a forward of 1 MPix/s, and for --train
    a model whose init is empty and a step that returns a zero loss."""
    import patchmatchnet_tpu.models as jax_models
    import patchmatchnet_tpu.train as jax_train

    monkeypatch.setattr(jax_bench, "enable_compile_cache", lambda: None)
    monkeypatch.setattr(jax_bench, "_bench_forward", lambda args, model, variables: 1.0)

    class StubModel:
        def __init__(self, compute_dtype=None):
            pass

        def init(self, rngs, *args, train=True):
            return {}

    monkeypatch.setattr(jax_models, "PatchmatchNet", StubModel)
    monkeypatch.setattr(jax_train, "create_train_state", lambda model, variables, tx: None)
    monkeypatch.setattr(jax_train, "make_train_step", lambda model, tx: (
        lambda state, batch, rng: (state, {"loss": jnp.zeros(())}, None)))
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    capsys.readouterr()
    jax_bench.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_forward_record_matches_bench_py(monkeypatch, capsys):
    argv = [*SMALL, "--no-tanks-metric", "--no-train-metric"]
    ours = _port_record(argv)
    want = _bench_py_record(monkeypatch, capsys, argv)
    assert set(ours) == set(want) == {"metric", "value", "unit", "vs_baseline"}
    assert (ours["metric"] == want["metric"]
            == "depth-map inference throughput, DTU config 80x64 N=5")
    assert ours["unit"] == want["unit"] == "MPix/s"
    assert ours["value"] > 0
    assert ours["vs_baseline"] == pytest.approx(ours["value"] / jax_bench.BASELINE_MPIX_S)


def test_cli_train_record_matches_bench_py(monkeypatch, capsys):
    argv = ["--train", *SMALL, "--batch", "2"]
    ours = _port_record(argv)
    want = _bench_py_record(monkeypatch, capsys, argv)
    # the train line's vs_baseline divides by a TPU figure: left out
    assert set(ours) == set(want) - {"vs_baseline"} == {"metric", "value", "unit"}
    assert ours["metric"] == want["metric"] == "train-step throughput, DTU config 80x64 N=5 B=2"
    assert ours["unit"] == want["unit"] == "samples/s"
    assert ours["value"] > 0


def _side_args(**overrides):
    args = bench.build_parser().parse_args(["--device", "cpu", *SMALL])
    for key, value in overrides.items():
        setattr(args, key, value)
    return args


def test_side_sections_record_errors(monkeypatch):
    """A failing side section leaves its `*_error` key (bench.py's
    contract) and the record keeps its primary metric."""
    def boom(*args, **kwargs):
        raise RuntimeError("kernel failed " + "x" * 300)

    monkeypatch.setattr(bench, "bench_forward", boom)
    monkeypatch.setattr(bench, "bench_train", boom)
    record = {"value": 1.0}
    bench.emit_side_metrics(_side_args(), None, record)
    assert record["value"] == 1.0
    assert record["tanks_error"].startswith("kernel failed") and len(record["tanks_error"]) == 200
    assert record["train_error"].startswith("kernel failed")
    assert "tanks_1056x1920_n7_mpix_s" not in record and "train_samples_per_s" not in record


def test_side_sections_at_their_geometries(monkeypatch):
    """The Tanks section runs the forward at 1056x1920, N=7, 6 iterations
    after 1 warm-up; the train section 640x512, B=2, 4 after 1 (bench.py's
    :443-477), each with the caller's precision."""
    seen = {}

    def fake_forward(args, model):
        seen["tanks"] = (args.height, args.width, args.num_views, args.iters, args.warmup)
        return 2.5

    def fake_train(args, emit=True):
        seen["train"] = (args.height, args.width, args.batch, args.iters, args.warmup, emit)
        return 7.0

    monkeypatch.setattr(bench, "bench_forward", fake_forward)
    monkeypatch.setattr(bench, "bench_train", fake_train)
    record = {}
    args = _side_args(train_f32=True)
    bench.emit_side_metrics(args, None, record)
    assert seen == {"tanks": (1056, 1920, 7, 6, 1), "train": (512, 640, 2, 4, 1, False)}
    assert record == {"tanks_1056x1920_n7_mpix_s": 2.5, "train_samples_per_s": 7.0,
                      "train_precision": "f32"}
    assert (args.height, args.width, args.iters) == (64, 80, 1)  # the caller's args unchanged


def test_side_sections_skip_past_the_deadline(monkeypatch):
    monkeypatch.setenv("BENCH_DEADLINE_S", "0")
    monkeypatch.setattr(bench, "bench_forward", lambda *a: pytest.fail("ran past the deadline"))
    monkeypatch.setattr(bench, "bench_train", lambda *a, **k: pytest.fail("ran past the deadline"))
    record = {}
    bench.emit_side_metrics(_side_args(), None, record)
    assert record["tanks_skipped"] == "deadline"
    assert record["train_skipped"].startswith("deadline: ")


def test_default_device_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("checks behaviour without CUDA; this machine has CUDA")
    proc = subprocess.run([sys.executable, "-m", "patchmatchnet_torch.bench", *SMALL,
                           "--no-tanks-metric", "--no-train-metric"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available" in proc.stderr
    assert proc.stdout.strip() == ""
