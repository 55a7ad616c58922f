"""The port's measurement tools (`patchmatchnet_torch.dev.bench_dataset_configs`,
`bf16_accuracy`, `bf16_scene_check`) on the CPU at small sizes, against
the JAX package on the same inputs.

- `bench_dataset_configs.run_config` on a tiny mixed config (64x128,
  128x64 and 56x120, which pads to 64x128; N=3, bucket 64), f32: the maps
  of its device timing's first call meet the JAX `DepthEstimator`'s
  forward on the same padded inputs and noise at the golden bounds of
  `tests/test_torch_model.py` `_check_against` on the final depth (max
  < 2e-3 and mean < 2e-4 of the depth range) and the confidence (at most
  0.1% of the pixels off by more than 5e-3, median below 1e-4).
- `bf16_accuracy.run` on forward_80x104_n5: its f32 numbers are inside
  those golden bounds against the captured reference, and its bf16 ones
  are finite and the same numbers as a direct computation.
- `bf16_scene_check.run` at 96x128, N=3: its f32 median |depth - GT| is
  within 1e-3 of the depth range of the JAX model's on the scene that the
  JAX test helper writes, with the same noise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from patchmatchnet_torch.dev import bench_dataset_configs, bf16_accuracy, bf16_scene_check
from patchmatchnet_tpu.compat import load_variables
from patchmatchnet_tpu.data import MVSDataset as JaxMVSDataset
from patchmatchnet_tpu.infer import DepthEstimator as JaxDepthEstimator
from patchmatchnet_tpu.models import PatchmatchNet as JaxPatchmatchNet
from tests.scene_utils import PLANE_Z, make_synthetic_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "params_000007.msgpack")
TINY = {"tiny": (3, [(64, 128), (128, 64), (56, 120)], 64)}


@pytest.fixture(scope="module")
def variables():
    yield load_variables(CKPT)
    jax.clear_caches()


@pytest.fixture(scope="module")
def tiny_report():
    return bench_dataset_configs.run_config("tiny", iters=1, device="cpu", bf16=False,
                                            configs=TINY)


def test_dataset_config_report(tiny_report):
    r = tiny_report
    assert (r["config"], r["device"], r["num_views"]) == ("tiny", "cpu", 3)
    assert r["padded_shapes"] == [(64, 128), (128, 64)]
    assert [s["shape"] for s in r["per_shape"]] == TINY["tiny"][1]
    for s in r["per_shape"]:
        for key in ("ms_per_map_e2e", "ms_per_map_device", "mpix_s_device", "first_call_s"):
            assert s[key] > 0, (s["shape"], key)
    assert r["mpix_s_device"] > 0
    assert [m[0].shape for m in r["maps"]] == TINY["tiny"][1]


@pytest.mark.parametrize("index", range(3))
def test_dataset_config_maps_match_jax_estimator(tiny_report, variables, index):
    from patchmatchnet_torch.bench import build_inputs

    num_views, shapes, bucket = TINY["tiny"]
    h, w = shapes[index]
    hb, wb = -(-h // bucket) * bucket, -(-w // bucket) * bucket
    images, intr, extr, dmin, dmax, _ = build_inputs(1, num_views, h, w)
    img_p = np.pad(images, ((0, 0), (0, 0), (0, hb - h), (0, wb - w), (0, 0)), mode="edge")
    noise = np.random.default_rng(7).random((1, 1, 48, hb // 8, wb // 8), np.float32)[0]
    est = JaxDepthEstimator(variables, JaxPatchmatchNet(), bucket_multiple=bucket)
    depth, conf, _ = est._forward(*[jnp.asarray(a) for a in (img_p, intr, extr, dmin, dmax)],
                                  jnp.asarray(noise))
    want_d, want_c = np.asarray(depth)[0, :h, :w], np.asarray(conf)[0, :h, :w]
    got_d, got_c = tiny_report["maps"][index]
    depth_range = float(dmax[0] - dmin[0])
    diff = np.abs(got_d - want_d)
    assert diff.max() < 2e-3 * depth_range, diff.max()
    assert diff.mean() < 2e-4 * depth_range, diff.mean()
    cdiff = np.abs(got_c - want_c)
    assert (cdiff > 5e-3).mean() < 1e-3, f"{(cdiff > 5e-3).sum()} confidence pixels off"
    assert np.median(cdiff) < 1e-4


@pytest.fixture(scope="module")
def accuracy():
    return bf16_accuracy.run("forward_80x104_n5", device="cpu")


def test_bf16_accuracy_f32_inside_golden_bounds(accuracy):
    assert accuracy["device"] == "cpu"
    assert set(accuracy["stages"]) == {"stage3.it0", "stage3.it1", "stage2.it0", "stage2.it1",
                                       "stage1.it0", "stage0.it0"}
    for key, row in accuracy["stages"].items():
        assert row["f32_vs_torch_max"] < 2e-3, key
        assert row["f32_vs_torch_mean"] < 2e-4, key
    assert accuracy["depth"]["f32_vs_torch_max"] < 2e-3
    conf = accuracy["confidence"]["f32"]
    assert conf["share_above_5e-3"] < 1e-3 and conf["median"] < 1e-4


def test_bf16_accuracy_numbers(accuracy):
    """The report's bf16 numbers are the relative errors of the bf16
    forward, computed here again."""
    import torch

    from patchmatchnet_torch.bench import forward, load_model

    g = np.load(os.path.join(REPO, "tests", "golden", "forward_80x104_n5.npz"))
    drange = float(g["depth_max"] - g["depth_min"])
    inputs = [torch.from_numpy(np.asarray(a, np.float32)) for a in (
        g["images"][None], g["intrinsics"][None], g["extrinsics"][None],
        [g["depth_min"]], [g["depth_max"]])]
    noise = torch.from_numpy(g["noise"])
    depth, conf, dp = forward(load_model(True, torch.device("cpu")), inputs, noise)
    d = np.abs(dp[2][1].float().numpy() - g["stage2_iter1"])
    row = accuracy["stages"]["stage2.it1"]
    assert row["bf16_vs_torch_max"] == pytest.approx(d.max() / drange, rel=1e-6)
    assert row["bf16_vs_torch_mean"] == pytest.approx(d.mean() / drange, rel=1e-6)
    cd = np.abs(conf.float().numpy() - g["confidence"])
    assert accuracy["confidence"]["bf16"]["median"] == pytest.approx(np.median(cd), rel=1e-6)
    for row in accuracy["stages"].values():
        assert all(np.isfinite(v) for v in row.values())


def test_bf16_scene_check_matches_jax(tmp_path, variables):
    h, w, views = 96, 128, 3
    report = bf16_scene_check.run(h, w, views, device="cpu", scratch=str(tmp_path))
    assert report["shape"] == (h, w) and report["gt"] == PLANE_Z
    make_synthetic_scene(str(tmp_path / "jax"), num_views=views, height=h, width=w)
    s = JaxMVSDataset(str(tmp_path / "jax"), num_views=views, image_extension=".png")[0]
    noise = np.random.default_rng(0).random((1, 48, h // 8, w // 8)).astype(np.float32)
    model = JaxPatchmatchNet()
    fwd = jax.jit(lambda v, *a, noise: model.apply(v, *a, train=False, init_noise=noise))
    depth, _, _ = fwd(variables, *[jnp.asarray(np.asarray(s[k], np.float32)[None]) for k in (
        "images", "intrinsics", "extrinsics", "depth_min", "depth_max")], noise=jnp.asarray(noise))
    jax_median = float(np.median(np.abs(np.asarray(depth)[0] - PLANE_Z)))
    depth_range = 0.5 * PLANE_Z  # the scene's range: [0.8, 1.3] x PLANE_Z
    assert abs(report["f32"]["median"] - jax_median) < 1e-3 * depth_range, (
        report["f32"]["median"], jax_median)
    assert report["bf16_vs_f32"]["median"] >= 0 and np.isfinite(report["bf16"]["median"])
