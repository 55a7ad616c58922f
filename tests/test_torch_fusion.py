"""The port's fusion (`geometry/fusion_math.py`, `infer/fusion.py`) against
the JAX package's on the CPU, on seeded inputs.

Tolerances. Both compute the same f32 formulas, in another order inside the
3x3/4x4 products, so coordinates differ by an ulp or so (8e-6 px at x ~ 64),
and a pixel whose source sample straddles the zero border moves by up to
~6 (the depth) per px of that: reprojected depths agree within 1e-4 x
PLANE_Z. Reprojected x and y are depth-divided, which amplifies that where
the reprojected depth is near 0 (a source sample at the border), so they
are held at 1e-4 x W where the reprojected depth lies in the scene's range
(> PLANE_Z / 2), and as the homogeneous x * depth and y * depth within 1e-4
x W x PLANE_Z everywhere. A mask may flip where a pixel's distance or
relative depth sits on its threshold, so masks are compared wherever the
JAX values lie more than 1e-4 (relative) from both thresholds.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import patchmatchnet_torch.infer.fusion as fusion_mod
from patchmatchnet_tpu.dataio import read_cam_file as jax_read_cam_file
from patchmatchnet_tpu.dataio import read_ply as jax_read_ply
from patchmatchnet_tpu.dataio import save_map as jax_save_map
from patchmatchnet_tpu.geometry import backproject_to_world as jax_backproject
from patchmatchnet_tpu.geometry import check_geometric_consistency as jax_check
from patchmatchnet_tpu.geometry import reproject_with_depth as jax_reproject
from patchmatchnet_tpu.infer import FusionConfig as JaxFusionConfig
from patchmatchnet_tpu.infer import filter_and_fuse as jax_filter_and_fuse
from patchmatchnet_tpu.infer.fusion import _consistency_all_sources
from patchmatchnet_torch.data import read_ply
from patchmatchnet_torch.geometry import (
    backproject_to_world,
    check_geometric_consistency,
    reproject_with_depth,
)
from patchmatchnet_torch.infer import FusionConfig, filter_and_fuse
from patchmatchnet_torch.infer.fusion import consistency_all_sources
from tests.scene_utils import PLANE_Z, make_synthetic_scene
from tests.test_fusion import _numpy_reproject, cam_setup  # noqa: F401 (a fixture)

H, W = 48, 64
PIX_THRES, DEPTH_THRES = 1.0, 0.01
BAND = 1e-4


def _rot(ax, ay):
    cx, sx, cy, sy = np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return (rx @ ry).astype(np.float32)


def _extrinsics(rot, t):
    e = np.eye(4, dtype=np.float32)
    e[:3, :3] = rot
    e[:3, 3] = t
    return e


@pytest.fixture(scope="module")
def rig():
    """The tests/test_fusion.py rig (a source rotated 0.06 about y, 0.4 to
    the side) plus: a source rotated about x and y, one so far to the side
    that most pixels project off-image, one that the nearer half of the
    scene lies behind, and one with a rotated reference; zero depth in a
    block of the reference and of every source."""
    rng = np.random.default_rng(3)
    f = 1.1 * W
    k = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    e_ref = np.eye(4, dtype=np.float32)
    sources = [
        _extrinsics(_rot(0.0, 0.06), (0.4, 0, 0)),
        _extrinsics(_rot(0.05, -0.12), (-0.3, 0.2, 0.1)),
        _extrinsics(_rot(0.0, 0.02), (3.0, 0, 0)),
        _extrinsics(_rot(0.0, 0.0), (0.1, 0, -PLANE_Z)),
    ]
    depth_ref = (PLANE_Z + 0.3 * rng.standard_normal((H, W))).astype(np.float32)
    depth_ref[:, W // 2:] += 1.0  # the far half stays in front of the last source
    depth_ref[5:10, 40:50] = 0.0
    depth_src = (PLANE_Z + 0.3 * rng.standard_normal((len(sources), H, W))).astype(np.float32)
    depth_src[:, 20:30, 10:16] = 0.0
    k_src = np.stack([k] * len(sources))
    k_src[1, 0, 0] *= 1.1  # another focal length
    return depth_ref, k, e_ref, depth_src, k_src, np.stack(sources)


def _port(rig, e_ref=None):
    depth_ref, k, e, depth_src, k_src, e_src = rig
    e = e if e_ref is None else e_ref
    return [torch.from_numpy(a) for a in (depth_ref, k, e, depth_src, k_src, e_src)]


def _jax_source(rig, v, e_ref=None):
    depth_ref, k, e, depth_src, k_src, e_src = rig
    e = e if e_ref is None else e_ref
    return [jnp.asarray(a) for a in (depth_ref, k, e, depth_src[v], k_src[v], e_src[v])]


def _assert_close_in_scale(got, want):
    """(depth, x, y) of the port against JAX's, the tolerances of the
    module note."""
    (gd, gx, gy), (wd, wx, wy) = got, want
    np.testing.assert_allclose(gd, wd, rtol=0, atol=BAND * PLANE_Z, err_msg="depth")
    in_range = np.abs(wd) > PLANE_Z / 2
    assert in_range.mean() > 0.3
    for name, g, w in (("x", gx, wx), ("y", gy, wy)):
        np.testing.assert_allclose(g[in_range], w[in_range], rtol=0, atol=BAND * W,
                                   err_msg=name)
        np.testing.assert_allclose(g * gd, w * wd, rtol=0, atol=BAND * W * PLANE_Z,
                                   err_msg=f"{name} * depth")


def _off_threshold(depth_ref, reprojected):
    """Pixels whose JAX distance and relative depth both lie more than BAND
    (relative) from their thresholds."""
    d, x2d, y2d = (np.asarray(a) for a in reprojected)
    y_ref, x_ref = np.mgrid[:depth_ref.shape[0], :depth_ref.shape[1]].astype(np.float32)
    dist = np.sqrt((x2d - x_ref) ** 2 + (y2d - y_ref) ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        relative = np.abs(d - depth_ref) / depth_ref
    return ~((np.abs(dist - PIX_THRES) <= BAND * PIX_THRES)
             | (np.abs(relative - DEPTH_THRES) <= BAND * DEPTH_THRES))


@pytest.mark.parametrize("rotated_ref", [False, True])
def test_reproject_matches_jax(rig, rotated_ref):
    """Every source of the rig in one batched call, against the JAX round
    trip per source: off-image, behind the camera and zero depths included."""
    e_ref = _extrinsics(_rot(-0.04, 0.03), (0.05, -0.1, 0.2)) if rotated_ref else None
    got = [a.numpy() for a in reproject_with_depth(*_port(rig, e_ref))]
    depth_src = rig[3]
    for v in range(depth_src.shape[0]):
        want = [np.asarray(a) for a in jax_reproject(*_jax_source(rig, v, e_ref))]
        _assert_close_in_scale([a[v] for a in got], want)
    # the rig reaches the cases it names: zero depths, and reference points
    # behind the last source (z < 0 in its camera) as well as in front
    _, k, _, _, _, e_src = rig
    y, x = np.mgrid[:H, :W]
    xyz = np.linalg.inv(k) @ (np.stack([x.ravel(), y.ravel(), np.ones(H * W)])
                              * rig[0].ravel())
    z_last = e_src[3, 2, :3] @ xyz + e_src[3, 2, 3]
    assert (z_last < 0).mean() > 0.1 and (z_last > 0).mean() > 0.1
    assert (rig[0] == 0).any() and (depth_src == 0).any()


@pytest.mark.parametrize("rotated_ref", [False, True])
def test_consistency_masks_match_jax_off_threshold(rig, rotated_ref):
    e_ref = _extrinsics(_rot(-0.04, 0.03), (0.05, -0.1, 0.2)) if rotated_ref else None
    masks, reproj = check_geometric_consistency(*_port(rig, e_ref), PIX_THRES, DEPTH_THRES)
    consistent = 0
    for v in range(rig[3].shape[0]):
        args = _jax_source(rig, v, e_ref)
        want_mask, want_reproj = (np.asarray(a) for a in jax_check(*args, PIX_THRES,
                                                                   DEPTH_THRES))
        off = _off_threshold(rig[0], jax_reproject(*args))
        assert off.mean() > 0.99
        np.testing.assert_array_equal(masks[v].numpy()[off], want_mask[off])
        np.testing.assert_allclose(reproj[v].numpy()[off], want_reproj[off], rtol=0,
                                   atol=BAND * PLANE_Z)
        consistent += want_mask.sum()
    assert consistent > 0.1 * H * W  # not a rig of all-inconsistent pixels


def test_backproject_matches_jax(rig):
    depth, k = rig[0], rig[1]
    e = _extrinsics(_rot(0.1, -0.2), (0.3, -0.4, 1.5))
    got = backproject_to_world(*(torch.from_numpy(a) for a in (depth, k, e))).numpy()
    want = np.asarray(jax_backproject(*(jnp.asarray(a) for a in (depth, k, e))))
    assert got.shape == want.shape == (H, W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_all_sources_consistency_matches_jax(rig):
    """The port's one batched pass over V sources against the JAX
    vmapped `_consistency_all_sources`: counts equal off threshold, sums of
    the consistent reprojected depths within V x 1e-4 x PLANE_Z."""
    port = _port(rig)
    geo_sum, reproj_sum = consistency_all_sources(*port, PIX_THRES, DEPTH_THRES)
    want_sum, want_reproj = (np.asarray(a) for a in _consistency_all_sources(
        *(jnp.asarray(a.numpy()) for a in port),
        geo_pixel_thres=PIX_THRES, geo_depth_thres=DEPTH_THRES))
    off = np.logical_and.reduce([_off_threshold(rig[0], jax_reproject(*_jax_source(rig, v)))
                                 for v in range(rig[3].shape[0])])
    assert geo_sum.dtype == torch.int32 and off.mean() > 0.98
    np.testing.assert_array_equal(geo_sum.numpy()[off], want_sum[off])
    np.testing.assert_allclose(reproj_sum.numpy()[off], want_reproj[off], rtol=0,
                               atol=4 * BAND * PLANE_Z)


def test_reproject_matches_numpy_cv2(cam_setup):
    """The tests/test_fusion.py check on the port, on its rig: the round
    trip against numpy + cv2.remap (which quantizes coordinates to 1/32 px)."""
    pytest.importorskip("cv2")
    depth_ref, k_ref, e_ref, depth_src, k_src, e_src = cam_setup
    got = reproject_with_depth(*(torch.from_numpy(a) for a in (
        depth_ref, k_ref, e_ref, depth_src[None], k_src[None], e_src[None])))
    want = _numpy_reproject(depth_ref, k_ref, e_ref, depth_src, k_src, e_src)
    for a, b, name in zip(got, want, ("depth", "x", "y")):
        np.testing.assert_allclose(a[0].numpy(), b, atol=5e-2, rtol=1e-4, err_msg=name)


# ---- filter_and_fuse on a scene --------------------------------------------

VIEWS = 4


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 4-view tests/scene_utils plane at 48x64 (PNG images) with noisy
    depth maps: the plane + N(0, 0.5% of PLANE_Z), an outlier block at 1.3 x
    PLANE_Z, and uniform seeded confidences; the maps are written in .pfm
    and .bin under one output folder for each implementation."""
    root = tmp_path_factory.mktemp("fusion_scene")
    make_synthetic_scene(str(root), num_views=VIEWS, height=H, width=W)
    rng = np.random.default_rng(11)
    maps = []
    for v in range(VIEWS):
        depth = (PLANE_Z + 0.005 * PLANE_Z * rng.standard_normal((H, W))).astype(np.float32)
        depth[8 + 4 * v:20 + 4 * v, 30:42] = 1.3 * PLANE_Z
        maps.append((depth, rng.random((H, W)).astype(np.float32)))
    for impl in ("port", "jax"):
        for ext in (".pfm", ".bin"):
            for v, (depth, conf) in enumerate(maps):
                for folder, data in (("depth_est", depth), ("confidence", conf)):
                    os.makedirs(root / impl / ext[1:] / folder, exist_ok=True)
                    jax_save_map(str(root / impl / ext[1:] / folder / f"{v:08d}{ext}"), data)
    return root, maps


def _masks(folder, view):
    return {name: np.asarray(Image.open(os.path.join(folder, "mask",
                                                     f"{view:08d}_{name}.png"))) > 0
            for name in ("photo", "geo", "final")}


@pytest.mark.parametrize("ext", [".pfm", ".bin"])
def test_filter_and_fuse_matches_jax(scene, ext, monkeypatch):
    root, maps = scene
    port_out, jax_out = str(root / "port" / ext[1:]), str(root / "jax" / ext[1:])
    counts = {"image": 0, "map": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fusion_mod, "read_image", counting("image", fusion_mod.read_image))
    monkeypatch.setattr(fusion_mod, "read_map", counting("map", fusion_mod.read_map))
    cfg = dict(geo_mask_thres=2, image_extension=".png", file_format=ext)
    timings = {}
    port_ply = filter_and_fuse(str(root), port_out, "", FusionConfig(**cfg), verbose=False,
                               device="cpu", timings=timings)
    jax_ply = jax_filter_and_fuse(str(root), jax_out, "", JaxFusionConfig(**cfg),
                                  verbose=False)
    # decode once: N image decodes and N depth + N confidence map reads
    assert counts == {"image": VIEWS, "map": 2 * VIEWS}
    assert set(timings) == {"read", "consistency", "masks", "backproject", "ply"}

    xyz, rgb = read_ply(port_ply)
    want_xyz, want_rgb = jax_read_ply(jax_ply)
    assert abs(xyz.shape[0] - want_xyz.shape[0]) <= 1e-3 * want_xyz.shape[0]
    assert 0.05 * VIEWS * H * W < want_xyz.shape[0] < 0.95 * VIEWS * H * W
    cams = [jax_read_cam_file(str(root / "cams" / f"{v:08d}_cam.txt"))[:2]
            for v in range(VIEWS)]
    start = want_start = 0
    for v in range(VIEWS):
        got, want = _masks(port_out, v), _masks(jax_out, v)
        np.testing.assert_array_equal(got["photo"], want["photo"])
        np.testing.assert_array_equal(got["photo"], maps[v][1] > 0.5)
        # pixels off threshold for every source of this reference
        off = np.logical_and.reduce([_off_threshold(maps[v][0], jax_reproject(
            *(jnp.asarray(a) for a in (maps[v][0], *cams[v], maps[s][0], *cams[s]))))
            for s in range(VIEWS) if s != v])
        assert off.mean() > 0.99
        for name in ("geo", "final"):
            np.testing.assert_array_equal(got[name][off], want[name][off], err_msg=name)
        # points and colours of the pixels in both final masks, in row-major order
        n, n_want = got["final"].sum(), want["final"].sum()
        both = got["final"] & want["final"]
        p = xyz[start:start + n][both[got["final"]]]
        q = want_xyz[want_start:want_start + n_want][both[want["final"]]]
        assert np.all(np.linalg.norm(p - q, axis=1) <= 1e-5 * np.linalg.norm(q, axis=1))
        np.testing.assert_array_equal(rgb[start:start + n][both[got["final"]]],
                                      want_rgb[want_start:want_start + n_want][
                                          both[want["final"]]])
        start, want_start = start + n, want_start + n_want
    assert start == xyz.shape[0] and want_start == want_xyz.shape[0]
