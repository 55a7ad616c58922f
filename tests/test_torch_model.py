"""End-to-end parity of the port's inference forward (CPU, plain versions of
the kernels) with the captured reference outputs and with the JAX model.

- f32 vs the three goldens, at the bounds of tests/test_model_golden.py
  (per-stage max < 2e-3 * range, mean < 2e-4 * range; confidence rules).
- f32 vs the JAX f32 model on the same inputs and noise, at those bounds
  plus a median bound of 1e-5 * range.
- bf16 vs the JAX bf16 model (`compute_dtype=jnp.bfloat16`). The two round
  to bf16 at the same points but inside different conv/interp kernels, so
  isolated pixels pick another hypothesis, as bf16 vs f32 does. Bound on
  the final depth (the form of test_windowed_similarity.py:264-266, scaled
  by the depth range): median < 5e-3, 99th percentile < 0.1, max < 0.3 of
  the range; the median port-vs-JAX difference stays below the JAX model's
  own bf16-vs-f32 median; confidence median < 2e-2. The port's median
  bf16-vs-f32 delta is at most 2x the JAX model's.
- The port's default stage configuration equals the JAX model's defaults.
- `DepthEstimator` + `save_depth_maps` over a synthetic scene read through
  `MVSDataset`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchmatchnet_tpu.compat import load_variables
from patchmatchnet_tpu.models import PatchmatchNet as JaxPatchmatchNet
from patchmatchnet_tpu.models import net as jax_net
from patchmatchnet_tpu.models.patchmatch import _fixed_offsets
from patchmatchnet_torch.compat import read_flax_msgpack, state_dict_from_jax
from patchmatchnet_torch.data import PLANE_Z, BatchLoader, MVSDataset, make_synthetic_scene, read_pfm
from patchmatchnet_torch.infer import DepthEstimator, save_depth_maps
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.models.patchmatch import (
    STAGE_CONFIG,
    evaluation_offsets,
    propagation_offsets,
)

HERE = os.path.dirname(__file__)
CKPT = os.path.join(HERE, "..", "checkpoints", "params_000007.msgpack")
STAGES = [(3, 0), (3, 1), (2, 0), (2, 1), (1, 0), (0, 0)]
JAX_CASES = ["forward_96x128", "forward_80x104_n5"]


def _golden(name):
    return np.load(os.path.join(HERE, "golden", f"{name}.npz"))


def _inputs(g):
    return (g["images"][None], g["intrinsics"][None], g["extrinsics"][None],
            np.asarray([g["depth_min"]], np.float32), np.asarray([g["depth_max"]], np.float32))


@pytest.fixture(scope="module")
def state_dict():
    return state_dict_from_jax(read_flax_msgpack(CKPT))


@pytest.fixture(scope="module")
def port_outputs(state_dict):
    """(name, dtype) -> (depth, confidence, {stage: [depths]}) as numpy."""
    cache = {}

    def run(name, dtype=None):
        if (name, dtype) not in cache:
            g = _golden(name)
            model = PatchmatchNet(compute_dtype=dtype)
            model.load_state_dict(state_dict, strict=True)
            with torch.inference_mode():
                depth, conf, dp = model(
                    *[torch.from_numpy(np.array(a)) for a in _inputs(g)],
                    init_noise=torch.from_numpy(g["noise"]),
                )
            cache[name, dtype] = (depth.numpy(), conf.numpy(),
                                  {s: [d.numpy() for d in v] for s, v in dp.items()})
        return cache[name, dtype]

    return run


@pytest.fixture(scope="module")
def jax_outputs():
    """(name, dtype) -> the jitted JAX model's outputs on the same inputs."""
    variables = load_variables(CKPT)
    cache = {}

    def run(name, dtype=None):
        if (name, dtype) not in cache:
            g = _golden(name)
            model = JaxPatchmatchNet(compute_dtype=dtype)
            fwd = jax.jit(lambda v, *a, noise: model.apply(
                v, *a, train=False, init_noise=noise))
            depth, conf, dp = fwd(variables, *[jnp.asarray(a) for a in _inputs(g)],
                                  noise=jnp.asarray(g["noise"]))
            cache[name, dtype] = (np.asarray(depth), np.asarray(conf),
                                  jax.tree.map(np.asarray, dp))
        return cache[name, dtype]

    yield run
    jax.clear_caches()


def _check_against(ours, ref, depth_range, median_bound=None):
    """Golden bounds (tests/test_model_golden.py) on stage depths, final
    depth and confidence; `ref` is (depth, confidence, {stage: [depths]})."""
    depth, conf, dp = ours
    for stage, it in STAGES:
        diff = np.abs(dp[stage][it] - ref[2][stage][it])
        assert diff.max() < 2e-3 * depth_range, f"stage{stage} iter{it} max {diff.max():.3e}"
        assert diff.mean() < 2e-4 * depth_range, f"stage{stage} iter{it} mean {diff.mean():.3e}"
        if median_bound is not None:
            assert np.median(diff) < median_bound * depth_range
    np.testing.assert_allclose(depth, ref[0], atol=2e-3 * depth_range, rtol=0)
    cdiff = np.abs(conf - ref[1])
    assert (cdiff > 5e-3).mean() < 1e-3, f"{(cdiff > 5e-3).sum()} confidence pixels off"
    assert np.median(cdiff) < 1e-4
    return cdiff


@pytest.mark.parametrize(
    "name", ["forward_96x128", "forward_80x104_n5", "forward_288x400_n5_dtu"]
)
def test_f32_matches_golden(port_outputs, name):
    g = _golden(name)
    depth_range = float(g["depth_max"] - g["depth_min"])
    ref = (g["depth"], g["confidence"],
           {s: [g[f"stage{s}_iter{i}"] for i in range(2) if f"stage{s}_iter{i}" in g]
            for s in range(4)})
    cdiff = _check_against(port_outputs(name), ref, depth_range)
    if name == "forward_96x128":
        assert cdiff.max() < 0.25  # as tests/test_model_golden.py


@pytest.mark.parametrize("name", JAX_CASES)
def test_f32_matches_jax_f32(port_outputs, jax_outputs, name):
    g = _golden(name)
    depth_range = float(g["depth_max"] - g["depth_min"])
    _check_against(port_outputs(name), jax_outputs(name), depth_range, median_bound=1e-5)


@pytest.mark.parametrize("name", JAX_CASES)
def test_bf16_matches_jax_bf16(port_outputs, jax_outputs, name):
    g = _golden(name)
    depth_range = float(g["depth_max"] - g["depth_min"])
    ours, ref = port_outputs(name, torch.bfloat16), jax_outputs(name, jnp.bfloat16)
    ours_f32, ref_f32 = port_outputs(name), jax_outputs(name)
    assert np.isfinite(ours[0]).all() and ours[0].shape == ref[0].shape
    rel = np.abs(ours[0] - ref[0]) / depth_range
    assert np.median(rel) < 5e-3, np.median(rel)
    assert np.quantile(rel, 0.99) < 0.1, np.quantile(rel, 0.99)
    assert rel.max() < 0.3, rel.max()
    jax_bf16_delta = np.median(np.abs(ref[0] - ref_f32[0]))
    port_bf16_delta = np.median(np.abs(ours[0] - ours_f32[0]))
    assert np.median(np.abs(ours[0] - ref[0])) < jax_bf16_delta
    assert port_bf16_delta <= 2.0 * jax_bf16_delta, (port_bf16_delta, jax_bf16_delta)
    assert np.median(np.abs(ours[1] - ref[1])) < 2e-2


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stage_config_matches_jax_defaults(stage):
    """The port's default configuration is the released one: the JAX
    model's default per-stage settings and offset patterns."""
    i = stage - 1
    cfg = STAGE_CONFIG[stage]
    assert cfg.interval_scale == jax_net.DEFAULT_INTERVAL_SCALE[i]
    assert cfg.propagation_range == jax_net.DEFAULT_PROPAGATION_RANGE[i]
    assert cfg.iterations == jax_net.DEFAULT_ITERATIONS[i]
    assert cfg.num_samples == jax_net.DEFAULT_NUM_SAMPLES[i]
    assert cfg.propagate_neighbors == jax_net.DEFAULT_PROPAGATE_NEIGHBORS[i]
    assert cfg.evaluate_neighbors == jax_net.DEFAULT_EVALUATE_NEIGHBORS[i]
    d = cfg.propagation_range
    assert evaluation_offsets(d, cfg.evaluate_neighbors) == _fixed_offsets(
        "evaluation", cfg.evaluate_neighbors, d)
    if cfg.propagate_neighbors:
        assert propagation_offsets(cfg.propagate_neighbors, d) == _fixed_offsets(
            "propagation", cfg.propagate_neighbors, d)


def _scene_estimator(tmp_path, state_dict, dtype, bucket, h=60, w=84, views=3):
    make_synthetic_scene(str(tmp_path / "scene"), num_views=views, height=h, width=w,
                         texture_scale=6.0)
    dataset = MVSDataset(str(tmp_path / "scene"), num_views=views - 1, image_extension=".png")
    model = PatchmatchNet(compute_dtype=dtype)
    model.load_state_dict(state_dict, strict=True)
    return dataset, DepthEstimator(model, device="cpu", bucket_multiple=bucket)


def test_depth_estimator_on_synthetic_scene(tmp_path, state_dict):
    """MVSDataset -> bf16 DepthEstimator -> save_depth_maps at a size that is
    not a multiple of 8: the maps come back at 60x84."""
    h, w, views = 60, 84, 3
    dataset, estimator = _scene_estimator(tmp_path, state_dict, torch.bfloat16, 0, h, w, views)
    out = tmp_path / "out"
    written = save_depth_maps(estimator, BatchLoader(dataset, batch_size=1, num_threads=1),
                              str(out), seed=0)
    assert written == views
    for v in range(views):
        depth = read_pfm(str(out / "depth_est" / f"{v:08d}.pfm"))[..., 0]
        conf = read_pfm(str(out / "confidence" / f"{v:08d}.pfm"))[..., 0]
        assert depth.shape == conf.shape == (h, w)
        assert np.isfinite(depth).all() and np.isfinite(conf).all()
        assert ((conf >= 0) & (conf <= 1 + 1e-5)).all()
        # plane at PLANE_Z; a sanity bound at this tiny size
        assert np.median(np.abs(depth - PLANE_Z)) < 0.1 * PLANE_Z


def test_depth_estimator_bucket_padding(tmp_path, state_dict):
    """bucket_multiple edge-pads (H, W) up to the bucket and crops back: the
    result equals the model run on the padded batch, cropped."""
    dataset, estimator = _scene_estimator(tmp_path, state_dict, None, 32, 64, 72)
    batch = next(iter(BatchLoader(dataset, batch_size=1, num_threads=1)))
    depth, conf = estimator(batch, torch.Generator().manual_seed(5))
    assert depth.shape == conf.shape == (1, 64, 72)
    padded = np.pad(batch["images"], ((0, 0), (0, 0), (0, 0), (0, 24), (0, 0)), mode="edge")
    noise = torch.rand((1, 48, 8, 12), generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        want_d, want_c, _ = estimator.model(
            torch.from_numpy(padded), torch.from_numpy(batch["intrinsics"]),
            torch.from_numpy(batch["extrinsics"]), torch.from_numpy(batch["depth_min"]),
            torch.from_numpy(batch["depth_max"]), init_noise=noise)
    np.testing.assert_array_equal(depth, want_d.numpy()[:, :, :72])
    np.testing.assert_array_equal(conf, want_c.numpy()[:, :, :72])


@pytest.mark.parametrize("h,w", [(60, 84), (198, 52)])
def test_depth_estimator_resize_back_matches_jax_estimator(tmp_path, state_dict, h, w):
    """At an original size that is not a multiple of 8 the estimator resizes
    the model's maps back as the JAX estimator does: depth by
    `resize_bilinear_np`, confidence by `_resize_nearest_np`, applied to the
    same maps. Both evaluate the same f32 expressions on the same source
    pixels, so they agree exactly (tolerance 0). At 198 rows (the model runs
    at 200) F.interpolate's nearest rows differ from the JAX estimator's."""
    from patchmatchnet_tpu.dataio.image import resize_bilinear_np
    from patchmatchnet_tpu.infer.depth import _resize_nearest_np

    dataset, estimator = _scene_estimator(tmp_path, state_dict, None, 0, h, w)
    batch = next(iter(BatchLoader(dataset, batch_size=1, num_threads=1)))
    hm, wm = batch["images"].shape[2:4]
    assert (hm, wm) != (h, w) and hm % 8 == 0 and wm % 8 == 0
    depth, conf = estimator(batch, torch.Generator().manual_seed(5))
    noise = torch.rand((1, 48, hm // 8, wm // 8), generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        model_d, model_c, _ = estimator.model(
            torch.from_numpy(batch["images"]), torch.from_numpy(batch["intrinsics"]),
            torch.from_numpy(batch["extrinsics"]), torch.from_numpy(batch["depth_min"]),
            torch.from_numpy(batch["depth_max"]), init_noise=noise)
    assert depth.shape == conf.shape == (1, h, w)
    np.testing.assert_array_equal(conf[0], _resize_nearest_np(model_c[0].numpy(), h, w))
    np.testing.assert_array_equal(depth[0], resize_bilinear_np(model_d[0].numpy(), h, w))


@pytest.mark.parametrize("shape_in,shape_out", [((200, 48), (198, 52)), ((232, 64), (230, 60)),
                                                ((64, 80), (60, 84)), ((16, 24), (40, 9))])
def test_resize_maps_match_jax_resizers(shape_in, shape_out):
    """The estimator's map resizes equal the JAX estimator's numpy resizes
    exactly, up and down, at sizes where F.interpolate's nearest rows do
    not (200 -> 198, 232 -> 230)."""
    from patchmatchnet_tpu.dataio.image import resize_bilinear_np
    from patchmatchnet_tpu.infer.depth import _resize_nearest_np
    from patchmatchnet_torch.ops.resize import resize_bilinear_maps, resize_nearest_maps

    maps = np.random.default_rng(3).random((2, *shape_in), dtype=np.float32) * 500 + 400
    t = torch.from_numpy(maps)
    got_b, got_n = resize_bilinear_maps(t, *shape_out), resize_nearest_maps(t, *shape_out)
    for i in range(2):
        np.testing.assert_array_equal(got_b[i].numpy(), resize_bilinear_np(maps[i], *shape_out))
        np.testing.assert_array_equal(got_n[i].numpy(), _resize_nearest_np(maps[i], *shape_out))
