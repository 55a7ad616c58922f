"""Non-default model configurations of the port against the JAX model
(reference: tests/test_model_variants.py).

- The propagation and evaluation offset patterns equal the JAX
  `_fixed_offsets` for every neighbour count the reference supports, and
  other counts raise NotImplementedError in both.
- A combined configuration (propagation (4, 8, 16), evaluation (17, 9,
  17), iterations (2, 1, 2), samples (8, 12, 16)) in f32 at 32x32 with
  1 + 2 views: JAX-initialised variables, with seeded random offset convs,
  carried into the port by `state_dict_from_jax`, the same seeded numpy
  inputs and noise. Every per-stage depth is held to the JAX model's at the
  golden tolerances of tests/test_model_golden.py (max 2e-3 and mean 2e-4
  of the depth range), as are the final depth and the confidence.
- The three configurations of tests/test_model_variants.py, and one with
  a single sample on stage 2, marked slow as there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchmatchnet_tpu.models import PatchmatchNet as JaxPatchmatchNet
from patchmatchnet_tpu.models.patchmatch import _fixed_offsets
from patchmatchnet_torch.compat import state_dict_from_jax
from patchmatchnet_torch.config import ModelConfig
from patchmatchnet_torch.data import plane_batch
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.models.patchmatch import evaluation_offsets, propagation_offsets

INPUTS = ("images", "intrinsics", "extrinsics", "depth_min", "depth_max")


@pytest.mark.parametrize("dilation", [1, 2, 4, 6])
def test_offset_patterns_match_jax(dilation):
    for n in (4, 8, 16):
        assert propagation_offsets(n, dilation) == _fixed_offsets("propagation", n, dilation)
    for n in (9, 17):
        assert evaluation_offsets(dilation, n) == _fixed_offsets("evaluation", n, dilation)
    for kind, n, port in (("propagation", 5, lambda: propagation_offsets(5, dilation)),
                          ("evaluation", 8, lambda: evaluation_offsets(dilation, 8))):
        with pytest.raises(NotImplementedError):
            _fixed_offsets(kind, n, dilation)
        with pytest.raises(NotImplementedError):
            port()


def test_unsupported_neighbours_raise_at_construction():
    with pytest.raises(NotImplementedError):
        PatchmatchNet(ModelConfig(propagate_neighbors=(0, 6, 16)))
    with pytest.raises(NotImplementedError):
        PatchmatchNet(ModelConfig(evaluate_neighbors=(9, 9, 25)))
    with pytest.raises(ValueError):
        PatchmatchNet(ModelConfig(patchmatch_iteration=(1, 2)))


def _run_both(propagate, evaluate, iterations, samples=(8, 8, 16), seed=0):
    """(port outputs, JAX outputs, depth range): each (depth, confidence,
    {stage: [depths]}) as numpy, f32, 32x32, 1 + 2 views."""
    batch = plane_batch(1, 3, 32, 32, seed=seed)
    options = dict(propagate_neighbors=propagate, evaluate_neighbors=evaluate,
                   patchmatch_iteration=iterations, patchmatch_num_sample=samples)
    jax_model = JaxPatchmatchNet(**options)
    args = [jnp.asarray(batch[k]) for k in INPUTS]
    variables = jax.jit(lambda *a: jax_model.init(
        {"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(seed + 1)},
        *a, train=False))(*args)
    variables = jax.tree.map(np.asarray, variables)
    # learned offsets of a few tenths of a pixel, so the grids sample
    # between pixels (the offset convs initialise to zero)
    rng = np.random.default_rng(seed + 2)
    for stage in (1, 2, 3):
        for conv in ("propa_conv", "eval_conv"):
            leaves = variables["params"][f"patchmatch_{stage}"].get(conv)
            if leaves is not None:
                p = leaves["conv2d"]
                p["kernel"] = (rng.standard_normal(p["kernel"].shape) * 0.01).astype(np.float32)
                p["bias"] = (rng.standard_normal(p["bias"].shape) * 0.5).astype(np.float32)
    noise = jnp.asarray(batch["noise"])
    depth, conf, dp = jax.jit(lambda v, *a: jax_model.apply(
        v, *a, train=False, init_noise=noise))(variables, *args)
    ref = (np.asarray(depth), np.asarray(conf), jax.tree.map(np.asarray, dp))

    model = PatchmatchNet(ModelConfig(**options))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        depth, conf, dp = model(*[torch.from_numpy(batch[k]) for k in INPUTS],
                                init_noise=torch.from_numpy(batch["noise"]))
    ours = (depth.numpy(), conf.numpy(), {s: [d.numpy() for d in v] for s, v in dp.items()})
    return ours, ref, float(batch["depth_max"][0] - batch["depth_min"][0])


def _check(ours, ref, depth_range, iterations):
    for stage in (3, 2, 1):
        assert len(ours[2][stage]) == len(ref[2][stage]) == iterations[stage - 1]
    for stage, depths in ref[2].items():
        for it, want in enumerate(depths):
            diff = np.abs(ours[2][stage][it] - want)
            assert np.isfinite(ours[2][stage][it]).all()
            assert diff.max() < 2e-3 * depth_range, f"stage{stage} iter{it} max {diff.max():.3e}"
            assert diff.mean() < 2e-4 * depth_range, f"stage{stage} iter{it} mean {diff.mean():.3e}"
    np.testing.assert_allclose(ours[0], ref[0], atol=2e-3 * depth_range, rtol=0)
    cdiff = np.abs(ours[1] - ref[1])
    assert (cdiff > 5e-3).mean() < 1e-3 and np.median(cdiff) < 1e-4


def test_combined_configuration_matches_jax():
    """Propagation on stage 1 (two iterations there), 4 propagation
    neighbours (D = 12 on stage 1, 20 on stage 2), 17 evaluation
    neighbours on stages 1 and 3, one iteration on stage 2."""
    iterations = (2, 1, 2)
    ours, ref, depth_range = _run_both((4, 8, 16), (17, 9, 17), iterations, (8, 12, 16))
    _check(ours, ref, depth_range, iterations)


@pytest.mark.slow
@pytest.mark.parametrize(
    "propagate,evaluate,iterations,samples",
    [
        ((0, 4, 4), (9, 9, 9), (1, 2, 2), (8, 8, 16)),
        ((0, 8, 16), (17, 17, 17), (1, 1, 1), (8, 8, 16)),
        ((4, 8, 16), (9, 9, 9), (2, 2, 2), (8, 8, 16)),
        # one sample on stage 2: the previous depth itself, then propagation
        ((0, 8, 16), (9, 9, 9), (1, 2, 2), (8, 1, 16)),
    ],
)
def test_variant_configs_match_jax(propagate, evaluate, iterations, samples):
    # slow: as tests/test_model_variants.py, a JAX compile per configuration
    ours, ref, depth_range = _run_both(propagate, evaluate, iterations, samples)
    _check(ours, ref, depth_range, iterations)
