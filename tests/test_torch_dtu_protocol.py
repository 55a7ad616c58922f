"""The port's DTU protocol (`patchmatchnet_torch/eval_protocols/dtu.py`):
the known-answer cases of tests/test_dtu_protocol.py, and equality to the
JAX package's protocol to the bit, one scan and the whole protocol on
synthetic evaluation files."""

import math
import os

import numpy as np
import pytest
from scipy.io import savemat

from patchmatchnet_tpu.eval_protocols import evaluate_dtu as jax_evaluate_dtu
from patchmatchnet_tpu.eval_protocols import evaluate_scan as jax_evaluate_scan
from patchmatchnet_tpu.eval_protocols.dtu import _mask_lookup as jax_mask_lookup
from patchmatchnet_torch.data import save_ply
from patchmatchnet_torch.eval_protocols import (
    evaluate_dtu,
    evaluate_scan,
    point_cloud_distances,
    reduce_points,
)
from patchmatchnet_torch.eval_protocols.dtu import _mask_lookup


def test_reduce_points_min_distance():
    rng = np.random.default_rng(0)
    pts = rng.random((5000, 3)) * 10
    reduced = reduce_points(pts, dst=0.5, seed=1)
    assert reduced.shape[0] < pts.shape[0]
    from scipy.spatial import cKDTree

    d, _ = cKDTree(reduced).query(reduced, k=2)
    assert d[:, 1].min() >= 0.5 - 1e-9


def test_point_cloud_distances_exact():
    a = np.array([[0.0, 0, 0], [1, 0, 0], [2, 0, 0]])
    b = np.array([[0.1, 0, 0], [5, 0, 0]])
    np.testing.assert_allclose(point_cloud_distances(a, b, max_dist=60.0), [0.1, 3.0],
                               atol=1e-12)
    assert point_cloud_distances(a, np.array([[100.0, 0, 0]]), max_dist=60.0)[0] == 60.0
    assert point_cloud_distances(np.zeros((0, 3)), b, max_dist=60.0).tolist() == [60.0, 60.0]


def test_evaluate_scan_known_offset():
    """Reconstruction = GT plane shifted by 0.3 mm in z -> acc == comp == 0.3."""
    xs, ys = np.meshgrid(np.arange(0, 100, 0.5), np.arange(0, 100, 0.5))
    stl = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], axis=1)
    data = stl.copy()
    data[:, 2] += 0.3
    bb = np.array([[-5.0, -5.0, -5.0], [105.0, 105.0, 5.0]])
    obs_mask = np.ones(np.ceil((bb[1] - bb[0]) / 1.0).astype(int) + 2, dtype=bool)
    m = evaluate_scan(data, stl, obs_mask, bb, 1.0, np.array([0.0, 0.0, 1.0, 1.0]), dst=0.2)
    assert m["acc_mean"] == pytest.approx(0.3, abs=1e-6)
    assert m["comp_mean"] == pytest.approx(0.3, abs=1e-6)


def test_evaluate_scan_mask_and_plane_filters():
    """Points outside the mask / below the plane are excluded from stats."""
    xs, ys = np.meshgrid(np.arange(0, 50, 1.0), np.arange(0, 50, 1.0))
    stl = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], axis=1)
    data = stl.copy()
    data[:, 2] += 0.5
    data_all = np.concatenate([data, np.array([[500.0, 500, 500], [600, 600, 600]])])
    bb = np.array([[-5.0, -5.0, -15.0], [55.0, 55.0, 5.0]])
    obs_mask = np.ones(np.ceil((bb[1] - bb[0]) / 1.0).astype(int) + 2, dtype=bool)
    # ground plane keeps only stl points with y > 25 for completeness
    m = evaluate_scan(data_all, stl, obs_mask, bb, 1.0, np.array([0.0, 1.0, 0.0, -25.0]),
                      dst=0.2)
    assert m["acc_mean"] == pytest.approx(0.5, abs=1e-6)
    assert m["n_stl"] == 24 * 50
    assert m["comp_mean"] == pytest.approx(0.5, abs=1e-6)


def _random_scan(seed):
    """A noisy reconstruction of a bumpy 60 x 60 mm surface, its reference
    scan, a random observability mask and a tilted ground plane."""
    rng = np.random.default_rng(seed)
    stl = rng.random((20000, 3)) * [60.0, 60.0, 0.0]
    stl[:, 2] = 3 * np.sin(stl[:, 0] / 7) * np.cos(stl[:, 1] / 9)
    data = stl[rng.random(stl.shape[0]) < 0.7]
    data = np.concatenate([data + rng.normal(0, 0.4, data.shape),
                           rng.random((500, 3)) * 200 - 50])  # outliers, some > 20 mm
    bb = np.array([[-2.0, -2.0, -6.0], [62.0, 62.0, 6.0]])
    obs_mask = rng.random(np.ceil((bb[1] - bb[0]) / 2.0).astype(int) + 2) > 0.2
    plane = np.array([0.05, -0.02, 1.0, 2.5])
    return data, stl, obs_mask, bb, 2.0, plane


def _assert_same_metrics(got, want):
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert (math.isnan(got[key]) and math.isnan(value)) or got[key] == value, key


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_scan_equals_jax(seed):
    data, stl, obs_mask, bb, res, plane = _random_scan(seed)
    np.testing.assert_array_equal(_mask_lookup(data, obs_mask, bb, res),
                                  jax_mask_lookup(data, obs_mask, bb, res))
    got = evaluate_scan(data, stl, obs_mask, bb, res, plane, reduce_seed=seed)
    _assert_same_metrics(got, jax_evaluate_scan(data, stl, obs_mask, bb, res, plane,
                                                reduce_seed=seed))
    assert got["n_data"] > 0 and got["n_stl"] > 0


def test_evaluate_dtu_equals_jax(tmp_path):
    """The whole protocol on synthetic SampleSet files: stl*.ply written by
    the port's save_ply, ObsMask*.mat and Plane*.mat by scipy."""
    sets = (1, 4)
    ply_paths = {}
    os.makedirs(tmp_path / "Points" / "stl")
    os.makedirs(tmp_path / "ObsMask")
    rng = np.random.default_rng(5)
    for cset in sets:
        data, stl, obs_mask, bb, res, plane = _random_scan(cset)
        save_ply(str(tmp_path / "Points" / "stl" / f"stl{cset:03d}_total.ply"), stl,
                 rng.integers(0, 256, stl.shape, dtype=np.uint8))
        ply_paths[cset] = str(tmp_path / f"scan{cset}.ply")
        save_ply(ply_paths[cset], data, np.zeros(data.shape, np.uint8))
        savemat(str(tmp_path / "ObsMask" / f"ObsMask{cset}_10.mat"),
                {"ObsMask": obs_mask, "BB": bb, "Res": np.array([[res]])})
        savemat(str(tmp_path / "ObsMask" / f"Plane{cset}.mat"), {"P": plane[:, None]})
    got = evaluate_dtu(ply_paths, str(tmp_path), used_sets=sets, verbose=False)
    want = jax_evaluate_dtu(ply_paths, str(tmp_path), used_sets=sets, verbose=False)
    assert got["per_scan"].keys() == want["per_scan"].keys() == set(sets)
    for cset in sets:
        _assert_same_metrics(got["per_scan"][cset], want["per_scan"][cset])
    for key in ("acc", "comp", "overall"):
        assert got[key] == want[key] and np.isfinite(got[key]), key
