"""Does the port's bf16 train step part from the JAX package's bf16 step by
more than two bf16 roundings of one model part from each other?

One train step's gradients from four trainers: JAX f32, JAX bf16, port f32
and port bf16, from the same JAX-initialised weights (`model.init` with
the keys of tests/test_torch_train_compare.py) and the same stage-3 noise
(the port's `step_noise` of step 0), on `plane_batch(2, 3, 64, 80)`, on the
CPU (the port's plain kernel versions; the JAX side jitted
`value_and_grad` of `patchmatchnet_loss` over the train-mode forward).

For each pair the test measures, over all leaves together:
- the cosine between the two gradients;
- the share of gradient L1 mass on elements whose signs disagree,
  sum over disagreeing elements of (|a| + |b|) / sum of (|a| + |b|): a mass
  share, not a count, since a flip on an element near zero is noise.

The controls are (JAX bf16, JAX f32) and (port bf16, port f32): what one
model's bf16 rounding does to its own gradient. The cross-checks are
(port bf16, JAX bf16) and (port f32, JAX f32). The port's bf16 step is held
to the controls: its mass share against JAX bf16 at most 1.5x the larger
control's, and its cosine at least the smaller control's less 0.01. The
f32 cross-check is held as tests/test_torch_train.py holds f32.

Measured (CPU, torch 2.13 and jax on one process): cosine / sign-mass
share / elements of opposite signs, of 221,925
- (JAX bf16, JAX f32)   0.99244 / 0.03351 / 24,128
- (port bf16, port f32) 0.99138 / 0.03929 / 26,749
- (port bf16, JAX bf16) 0.99272 / 0.03298 / 24,227
- (port f32, JAX f32)   1.00000 / 0.00000 / 2
So the 11% of elements whose signs differ between the two bf16 steps is
what bf16 rounding alone does to either model's gradient: not a fault.
Per leaf, the largest sign-mass shares are on the SimilarityNet output
biases, whose gradient the softmax cancels (rounding noise in every
trainer), and on BatchNorm scales and biases.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchmatchnet_tpu.models import PatchmatchNet as JaxPatchmatchNet
from patchmatchnet_tpu.models.net import patchmatchnet_loss as jax_loss
from patchmatchnet_tpu.train.loop import build_stage_pyramid as jax_pyramid
from patchmatchnet_torch.compat import state_dict_from_jax, tensors_from_jax_params
from patchmatchnet_torch.data import plane_batch
from patchmatchnet_torch.dev.bf16_train_compare import step_noise
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.train import batch_to_device, make_optimizer, train_step

CONTROLS = (("jax bf16", "jax f32"), ("port bf16", "port f32"))
CROSS = (("port bf16", "jax bf16"), ("port f32", "jax f32"))
MASS_FACTOR, COSINE_SLACK = 1.5, 0.01


def _jax_grads(batch, noise, compute_dtype, variables):
    model = JaxPatchmatchNet(compute_dtype=compute_dtype)
    arrays = {k: jnp.asarray(v) for k, v in batch.items() if k != "noise"}

    def loss_fn(params):
        (_, _, dp), _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, arrays["images"],
            arrays["intrinsics"], arrays["extrinsics"], arrays["depth_min"],
            arrays["depth_max"], train=True, init_noise=jnp.asarray(noise),
            mutable=["batch_stats", "diagnostics"])
        gts, masks = jax_pyramid(arrays["depth_gt"], arrays["mask"])
        return jax_loss(dp, gts, masks)

    grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    return tensors_from_jax_params(jax.tree.map(np.array, grads))


def _port_grads(tensors, noise, compute_dtype, state_dict):
    model = PatchmatchNet(compute_dtype=compute_dtype)
    model.load_state_dict(state_dict, strict=True)
    metrics, _ = train_step(model, make_optimizer(model.parameters(), 0.0), tensors, 0.0,
                            noise, with_grads=True)
    return {k: v.float() for k, v in metrics["grads"].items()}


@pytest.fixture(scope="module")
def grads():
    """{trainer: {parameter name: gradient}} for the four trainers."""
    batch = plane_batch(2, 3, 64, 80)
    model = JaxPatchmatchNet()
    init = jax.jit(functools.partial(model.init, train=True))
    variables = init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                     *[jnp.asarray(batch[k]) for k in ("images", "intrinsics", "extrinsics",
                                                       "depth_min", "depth_max")])
    variables = {k: jax.tree.map(np.asarray, variables[k]) for k in ("params", "batch_stats")}
    state_dict = state_dict_from_jax(variables)
    tensors = batch_to_device(batch, torch.device("cpu"))
    noise = step_noise(tensors, 0)
    out = {}
    for name, jdt, tdt in (("f32", None, None), ("bf16", jnp.bfloat16, torch.bfloat16)):
        out[f"jax {name}"] = _jax_grads(batch, noise.numpy(), jdt, variables)
        out[f"port {name}"] = _port_grads(tensors, noise, tdt, state_dict)
    yield out
    jax.clear_caches()


def agreement(a, b):
    """(cosine, sign-disagreeing share of the L1 mass, count of elements of
    opposite signs) between two flat gradients."""
    a, b = a.double().flatten(), b.double().flatten()
    cosine = float(a @ b / (a.norm() * b.norm()))
    mass = a.abs() + b.abs()
    flipped = (torch.sign(a) * torch.sign(b)) < 0
    return cosine, float(mass[flipped].sum() / mass.sum()), int(flipped.sum())


def _flat(tree, names):
    return torch.cat([tree[k].flatten() for k in names])


def _measure(grads, pair):
    a, b = grads[pair[0]], grads[pair[1]]
    assert sorted(a) == sorted(b)
    names = sorted(a)
    cosine, mass, flipped = agreement(_flat(a, names), _flat(b, names))
    per_leaf = {k: agreement(a[k], b[k])[1] for k in names}
    worst = sorted(per_leaf.items(), key=lambda kv: -kv[1])[:3]
    print(f"{pair[0]} vs {pair[1]}: cosine {cosine:.5f}, sign-mass share {mass:.5f}, "
          f"{flipped} elements of opposite signs; largest per leaf "
          f"{[(k, round(v, 4)) for k, v in worst]}")
    return cosine, mass


def test_port_bf16_step_agrees_with_jax_bf16_within_the_controls(grads):
    controls = [_measure(grads, pair) for pair in CONTROLS]
    cosine, mass = _measure(grads, CROSS[0])
    assert mass <= MASS_FACTOR * max(m for _, m in controls), (mass, controls)
    assert cosine >= min(c for c, _ in controls) - COSINE_SLACK, (cosine, controls)


def test_port_f32_step_agrees_with_jax_f32(grads):
    cosine, mass = _measure(grads, CROSS[1])
    assert cosine > 0.999 and mass < 1e-3, (cosine, mass)


@pytest.mark.parametrize("pair", CONTROLS, ids=["jax", "port"])
def test_bf16_rounding_keeps_the_gradient_direction(grads, pair):
    """Each control: one model's bf16 step keeps its f32 step's direction
    (tests/test_train_step.py's norm-weighted bound, 0.9)."""
    cosine, _ = _measure(grads, pair)
    assert cosine > 0.9, cosine
