"""The port's f32-against-bf16 trainer comparison
(`patchmatchnet_torch.dev.bf16_train_compare`) against the JAX tool and
the JAX trainer, on the CPU (plain versions of the kernels).

- `build_batch` equals the JAX tool's (`tools/dev/bf16_train_compare.py`)
  bit for bit at 64x80, B=2, N=3.
- Three steps of the port's `run` against three steps of the JAX trainer
  (`make_optimizer(1e-3)`'s optax Adam over `jax.value_and_grad` of
  `patchmatchnet_loss`, the stage-3 noise injected as
  tests/test_torch_train.py `_jax_step` injects it), both from the same
  JAX-initialised weights (`model.init` with the JAX tool's keys, carried
  across by `state_dict_from_jax`) and the same noise (the port's
  `step_noise` of each step), at tests/test_torch_train.py's size and scene
  (`plane_batch(2, 3, 64, 80)`), in f32 and bf16. Relative loss bounds: step
  1 at `test_loss_matches_jax`'s (f32 1e-4, bf16 1e-2); steps 2-3 f32 1e-3,
  bf16 5e-2. Measured (steps 1-3): f32 1.6e-6, 7.4e-6, 5.1e-4; bf16 4.0e-4,
  2.7e-3, 2.1e-2; the port's own f32 step 3 moves by 7e-5 between 1 and 4
  CPU threads. Cause: Adam's first update is lr x sign(g) on every element,
  so an element whose gradient has the other sign in the other trainer
  moves 2 lr apart. After step 1 that is 2 of 221,925 elements in f32 (a
  SimilarityNet output bias, analytically zero, and one Refinement deconv
  weight) and 24,247 in bf16 (11%, mostly FeatureNet conv weights: two bf16
  paths that round at different points).
- `main(["--device", "cpu", "--steps", "2", ...])` prints one JSON line
  with the JAX tool's keys less `windowed_escapes` (a TPU sampler's
  counter the port has no sampler for).
- The default `--device` without CUDA exits non-zero naming
  `torch.cuda.is_available` (skipped where CUDA is present).
"""

import functools
import importlib.util
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from patchmatchnet_tpu.models import PatchmatchNet as JaxPatchmatchNet
from patchmatchnet_tpu.models.net import patchmatchnet_loss as jax_loss
from patchmatchnet_tpu.train import make_optimizer as jax_make_optimizer
from patchmatchnet_tpu.train.loop import build_stage_pyramid as jax_pyramid
from patchmatchnet_torch.compat import state_dict_from_jax
from patchmatchnet_torch.data import plane_batch
from patchmatchnet_torch.dev import bf16_train_compare
from patchmatchnet_torch.train import batch_to_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
# relative loss bounds per step (see the docstring)
BOUNDS = {"f32": (1e-4, 1e-3, 1e-3), "bf16": (1e-2, 5e-2, 5e-2)}
# the JAX tool's record keys (tools/dev/bf16_train_compare.py:126-137)
JAX_KEYS = {"steps", "f32_final_loss", "bf16_final_loss", "rel_loss_div_median",
            "rel_loss_div_p95", "rel_loss_div_max_2nd_half", "f32_final_depth_err",
            "bf16_final_depth_err", "windowed_escapes"}


def _jax_tool():
    """tools/dev/bf16_train_compare.py as a module (it puts the repo and
    tests/ on sys.path for its imports)."""
    spec = importlib.util.spec_from_file_location(
        "jax_bf16_train_compare", os.path.join(REPO, "tools", "dev", "bf16_train_compare.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_build_batch_equals_the_jax_tool():
    want = _jax_tool().build_batch(64, 80, 2, 3)
    got = bf16_train_compare.build_batch(64, 80, 2, 3)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key


def _jax_losses(batch, compute_dtype, variables, noises):
    """The JAX trainer's loss at each step: Adam (`make_optimizer(1e-3)`)
    over the train-mode forward with the given stage-3 noises."""
    model = JaxPatchmatchNet(compute_dtype=compute_dtype)
    tx = jax_make_optimizer(1e-3)
    arrays = {k: jnp.asarray(v) for k, v in batch.items() if k != "noise"}

    @jax.jit
    def step(params, stats, opt_state, noise):
        gts, masks = jax_pyramid(arrays["depth_gt"], arrays["mask"])

        def loss_fn(p):
            (_, _, dp), updates = model.apply(
                {"params": p, "batch_stats": stats}, arrays["images"], arrays["intrinsics"],
                arrays["extrinsics"], arrays["depth_min"], arrays["depth_max"], train=True,
                init_noise=noise, mutable=["batch_stats", "diagnostics"])
            return jax_loss(dp, gts, masks), updates["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), stats, opt_state, loss

    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    losses = []
    for noise in noises:
        params, stats, opt_state, loss = step(params, stats, opt_state, jnp.asarray(noise))
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def curves():
    """{(side, precision): [loss per step]} from the same JAX-initialised
    weights and the same noises."""
    batch = plane_batch(2, 3, 64, 80)
    model = JaxPatchmatchNet()
    init = jax.jit(functools.partial(model.init, train=True))
    variables = init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                     *[jnp.asarray(batch[k]) for k in ("images", "intrinsics", "extrinsics",
                                                       "depth_min", "depth_max")])
    variables = {k: jax.tree.map(np.asarray, variables[k]) for k in ("params", "batch_stats")}
    state_dict = state_dict_from_jax(variables)
    tensors = batch_to_device(batch, torch.device("cpu"))
    noises = [bf16_train_compare.step_noise(tensors, i).numpy() for i in range(STEPS)]
    out = {}
    for precision, jdt, tdt in (("f32", None, None), ("bf16", jnp.bfloat16, torch.bfloat16)):
        out["jax", precision] = _jax_losses(batch, jdt, variables, noises)
        out["port", precision] = bf16_train_compare.run(
            batch, tdt, STEPS, 1, device="cpu", state_dict=state_dict)[0]
    yield out
    jax.clear_caches()


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_loss_curve_matches_jax(curves, precision):
    want, got = curves["jax", precision], curves["port", precision]
    assert len(got) == len(want) == STEPS and np.isfinite(got).all()
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    assert all(r < b for r, b in zip(rel, BOUNDS[precision])), (rel, got, want)
    assert got[-1] < got[0] and want[-1] < want[0]  # both train


def test_main_prints_the_jax_tool_keys():
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert bf16_train_compare.main(["--device", "cpu", "--steps", "2", "--height", "64",
                                        "--width", "80", "--batch", "1", "--num-views", "2"]) == 0
    record = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(record) == JAX_KEYS - {"windowed_escapes"}
    assert record["steps"] == 2
    assert all(np.isfinite(v) for v in record.values())


def test_default_device_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("checks behaviour without CUDA; this machine has CUDA")
    proc = subprocess.run([sys.executable, "-m", "patchmatchnet_torch.dev.bf16_train_compare",
                           "--steps", "1", "--height", "64", "--width", "80"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available" in proc.stderr
    assert proc.stdout.strip() == ""
