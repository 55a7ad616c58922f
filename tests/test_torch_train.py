"""The port's training step (CPU, plain versions of the kernels) against the
JAX trainer on the same inputs, weights and stage-3 noise.

One forward and backward of the full released cascade (iterations 1, 2, 2)
from `checkpoints/params_000007.msgpack` (non-zero offset convs, so every
gradient path is live) at 64x80, N=3, B=2, on a photo-consistent textured
plane with noisy GT (`patchmatchnet_torch.data.plane_batch`). Random images
make the stage-1 gradient ill-conditioned in f32 (measured: the JAX and the
port's f32 gradients then differ from a float64 run of the port by about
the same 1e-4 in cosine), so the scene is textured instead. The JAX side is `jax.value_and_grad` of
`patchmatchnet_loss` over `PatchmatchNet.apply(train=True,
mutable=["batch_stats", "diagnostics"])`, jitted once per precision.

- f32 (`compute_dtype=None`): loss relative difference < 1e-4; every
  gradient leaf above 1e-3 of the largest leaf norm has cosine > 0.999 and
  relative norm difference < 1e-2; updated batch statistics relative
  difference < 1e-4.
- bf16: loss within 1%; the gradient-direction thresholds of
  tests/test_train_step.py (median cosine > 0.93, norm-weighted > 0.9,
  every major-norm leaf > 0.5), where a leaf is major when its f32
  gradient norm is at least 1e-2 of the largest (the analytically zero
  gradient of each SimilarityNet output bias, which the softmax cancels,
  is pure rounding noise in bf16 and reaches 2e-2 of the largest norm in
  the JAX bf16 step); and the norm backstop ||g_bf16|| > 0.1 ||g_f32|| for
  every leaf above the zero-init epsilon.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchmatchnet_tpu.compat import load_variables
from patchmatchnet_tpu.models import PatchmatchNet as JaxPatchmatchNet
from patchmatchnet_tpu.models.net import patchmatchnet_loss as jax_loss
from patchmatchnet_tpu.train.loop import build_stage_pyramid as jax_pyramid
from patchmatchnet_torch.compat import (
    read_flax_msgpack,
    state_dict_from_jax,
    tensors_from_jax_params,
)
from patchmatchnet_torch.data import plane_batch
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.train import batch_to_device, make_optimizer, train_step

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "params_000007.msgpack")


def _jax_step(batch, compute_dtype):
    model = JaxPatchmatchNet(compute_dtype=compute_dtype)
    variables = load_variables(CKPT)

    def loss_fn(params, stats, arrays, noise):
        (_, _, dp), updates = model.apply(
            {"params": params, "batch_stats": stats}, arrays["images"], arrays["intrinsics"],
            arrays["extrinsics"], arrays["depth_min"], arrays["depth_max"], train=True,
            init_noise=noise, mutable=["batch_stats", "diagnostics"])
        gts, masks = jax_pyramid(arrays["depth_gt"], arrays["mask"])
        return jax_loss(dp, gts, masks), updates["batch_stats"]

    arrays = {k: jnp.asarray(v) for k, v in batch.items() if k != "noise"}
    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], arrays, jnp.asarray(batch["noise"]))
    return (float(loss), tensors_from_jax_params(jax.tree.map(np.array, grads)),
            state_dict_from_jax({"batch_stats": jax.tree.map(np.array, stats)}))


def _port_step(batch, compute_dtype):
    model = PatchmatchNet(compute_dtype=compute_dtype)
    model.load_state_dict(state_dict_from_jax(read_flax_msgpack(CKPT)), strict=True)
    metrics, _ = train_step(model, make_optimizer(model.parameters(), 0.0),
                            batch_to_device(batch, torch.device("cpu")), 0.0,
                            torch.from_numpy(batch["noise"]), with_grads=True)
    stats = {k: v for k, v in model.state_dict().items() if k.endswith(("running_mean",
                                                                       "running_var"))}
    return float(metrics["loss"]), metrics["grads"], stats


@pytest.fixture(scope="module")
def steps():
    """{(side, precision): (loss, grads by name, batch statistics by name)}."""
    batch = plane_batch(2, 3, 64, 80)
    out = {}
    for precision, jdt, tdt in (("f32", None, None), ("bf16", jnp.bfloat16, torch.bfloat16)):
        out["jax", precision] = _jax_step(batch, jdt)
        out["port", precision] = _port_step(batch, tdt)
    yield out
    jax.clear_caches()


def _cosines(want, got, names):
    """(cosine, ||want||, ||got||) per leaf name."""
    rows = {}
    for name in names:
        a, b = want[name].double().ravel(), got[name].double().ravel()
        na, nb = float(a.norm()), float(b.norm())
        rows[name] = (float(a @ b) / (na * nb + 1e-30), na, nb)
    return rows


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_loss_matches_jax(steps, precision):
    want, got = steps["jax", precision][0], steps["port", precision][0]
    assert np.isfinite(got)
    bound = 1e-4 if precision == "f32" else 1e-2
    assert abs(got - want) / abs(want) < bound, (got, want)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_gradient_tree_matches_jax(steps, precision):
    """The port produces a gradient for exactly the JAX parameter leaves."""
    want, got = steps["jax", precision][1], steps["port", precision][1]
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert torch.isfinite(got[name]).all(), name


def test_f32_gradients_match_jax(steps):
    want, got = steps["jax", "f32"][1], steps["port", "f32"][1]
    rows = _cosines(want, got, want)
    top = max(na for _, na, _ in rows.values())
    checked = 0
    for name, (cos, na, nb) in rows.items():
        if na < 1e-3 * top:
            continue
        checked += 1
        assert cos > 0.999, (name, cos)
        assert abs(nb - na) / na < 1e-2, (name, na, nb)
    assert checked >= 100, checked


def test_f32_batch_stats_match_jax(steps):
    """Running statistics after one train-mode forward (one EMA update per
    BatchNorm call: N per FeatureNet layer, one per evaluation call)."""
    want, got = steps["jax", "f32"][2], steps["port", "f32"][2]
    assert set(got) == set(want)
    for name, w in want.items():
        rel = float((got[name] - w).abs().max() / w.abs().max().clamp(min=1e-12))
        assert rel < 1e-4, (name, rel)


def test_bf16_gradients_track_jax_bf16(steps):
    f32 = steps["jax", "f32"][1]
    rows = _cosines(steps["jax", "bf16"][1], steps["port", "bf16"][1], f32)
    f32_norm = {name: float(g.norm()) for name, g in f32.items()}
    live = [n for n, (_, na, nb) in rows.items() if na > 1e-12 or nb > 1e-12]
    cos = np.array([rows[n][0] for n in live])
    norms = np.array([rows[n][1] for n in live])
    assert np.median(cos) > 0.93, np.median(cos)
    assert float((cos * norms).sum() / norms.sum()) > 0.9
    top = max(f32_norm.values())
    major = {n: rows[n][0] for n in live if f32_norm[n] >= 1e-2 * top}
    assert len(major) >= 10, len(major)
    assert min(major.values()) > 0.5, min(major.items(), key=lambda kv: kv[1])


def test_bf16_gradient_norm_backstop(steps):
    """ADVICE r5: no gradient path of the bf16 step is zeroed: every leaf
    whose f32 gradient is above the zero-init epsilon keeps more than a
    tenth of its f32 norm."""
    f32, bf16 = steps["port", "f32"][1], steps["port", "bf16"][1]
    for name, g in f32.items():
        na = float(g.norm())
        if na > 1e-6:
            assert float(bf16[name].norm()) > 0.1 * na, (name, na, float(bf16[name].norm()))
