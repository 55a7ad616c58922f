"""Plain PyTorch versions of the port's three kernels (CPU) against their
JAX counterparts on the same numpy inputs.

- K1 `warp_group_corr_reference` vs `windowed_group_similarity_proj` (its
  `_jnp_windowed` path on CPU, at a geometry with zero escapes) and vs the
  gather path `warp_taps` + `similarity_kernel._jnp_impl`.
- K3 `neighbor_group_corr_reference` vs `_feature_weight_corr` with the
  Pallas kernel in interpret mode (as tests/test_pallas_kernels.py runs it).
- K2 `eval_grid_score_reference` vs the f32 unfused tail
  (tests/test_eval_tail.py) and vs `eval_grid_score` on CPU.

Every case runs on f32 inputs and on bf16-rounded inputs (bf16 payloads in
the port, the same bf16 values in JAX); the arithmetic is f32 on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchmatchnet_tpu.models.patchmatch import _feature_weight_corr
from patchmatchnet_tpu.ops.pallas.eval_tail import eval_grid_score as jax_eval_grid_score
from patchmatchnet_tpu.ops.pallas.similarity_kernel import SLICE_PAD, _jnp_impl
from patchmatchnet_tpu.ops.pallas.windowed_similarity import (
    _coords_from_depth,
    escape_count,
    make_config,
    make_quad_table_2d,
    windowed_group_similarity_proj,
)
from patchmatchnet_tpu.ops.quad_sample import make_quad_image
from patchmatchnet_tpu.ops.warp import warp_proj_coeffs as jax_warp_proj_coeffs
from patchmatchnet_tpu.ops.warp import warp_taps
from patchmatchnet_torch.ops import (
    eval_grid_score,
    eval_grid_score_reference,
    neighbor_group_corr_reference,
    warp_group_corr,
    warp_group_corr_reference,
)
from patchmatchnet_torch.ops.warp_similarity import group_mean_matrix
from test_eval_tail import _inputs as eval_tail_inputs
from test_eval_tail import _unfused_score

PAYLOADS = ["f32", "bf16"]


def _payload(x: np.ndarray, payload: str):
    """(torch tensor in the payload dtype, numpy f32 of the same values)."""
    t = torch.from_numpy(np.array(x, np.float32))
    if payload == "bf16":
        t = t.to(torch.bfloat16)
    return t, t.float().numpy()


def _jax_payload(x: np.ndarray, payload: str):
    return jnp.asarray(x, jnp.bfloat16 if payload == "bf16" else jnp.float32)


def _projections(h, w, baseline):
    """Reference/source 4x4 projections of a small rig (f = 1.1 max(h, w),
    identity rotations, x baseline) that also sees points behind it."""
    f = 1.1 * max(h, w)
    k = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]], np.float32)
    projs = []
    for tx, tz in ((0.0, 0.0), (baseline, 0.3)):
        p = np.eye(4, dtype=np.float32)
        p[:3, :4] = k @ np.array([[1, 0, 0, tx], [0, 1, 0, 0], [0, 0, 1, tz]], np.float32)
        projs.append(p)
    return projs[0][None], projs[1][None]


def _warp_case(rng, d, h, w, c):
    src = rng.standard_normal((1, h, w, c)).astype(np.float32)
    ref = rng.standard_normal((1, h, w, c)).astype(np.float32)
    depth = (4.0 + 4.0 * rng.random((1, d, h, w))).astype(np.float32)
    # behind the source camera (pz <= 1e-3): pushed off-image, reads zero
    depth[:, 0, :4] = -0.5
    ref_proj, src_proj = _projections(h, w, baseline=0.35)
    return src, ref, depth, ref_proj, src_proj


@pytest.mark.parametrize("payload", PAYLOADS)
def test_warp_group_corr_matches_windowed(payload):
    """Plain K1 vs the windowed JAX path at zero escapes; samples leave the
    image on the right (baseline) and some are behind the camera."""
    rng = np.random.default_rng(0)
    d, h, w, c, g = 4, 16, 128, 16, 4
    src, ref, depth, ref_proj, src_proj = _warp_case(rng, d, h, w, c)
    mat12 = np.array(jax_warp_proj_coeffs(jnp.asarray(src_proj), jnp.asarray(ref_proj)))
    cfg = make_config(h, w)
    quad = make_quad_table_2d(_jax_payload(src, payload))
    ix, iy = _coords_from_depth(jnp.asarray(mat12), jnp.asarray(depth), h, w)
    assert int(escape_count(ix, iy, cfg, h, w, quad.shape[1], quad.shape[2])) == 0
    ixn = np.asarray(ix)
    assert (ixn[:, 0, :4] == w).all(), "pz <= 1e-3 samples must be pushed to (W, H)"
    assert (ixn > w - 1).any() and (ixn < w - 1).any(), "fixture must leave the image"
    want = np.asarray(windowed_group_similarity_proj(
        quad, jnp.asarray(mat12), jnp.asarray(depth), _jax_payload(ref, payload),
        jnp.asarray(group_mean_matrix(c, g).numpy()), cfg))
    src_t, _ = _payload(src, payload)
    ref_t, _ = _payload(ref, payload)
    got = warp_group_corr(src_t, torch.from_numpy(mat12), torch.from_numpy(depth), ref_t, g)
    assert got.shape == (1, g, d, h, w) and got.dtype == torch.float32
    # f32 math on both sides; the plain version's F.grid_sample normalizes
    # coordinates and back (~1 ulp of x ~ 128 against O(1) feature jumps)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert np.abs(got.numpy() - want).mean() < 2e-6
    assert (got[:, :, 0, :4] == 0).all()


@pytest.mark.parametrize("payload", PAYLOADS)
def test_warp_group_corr_matches_gather_path(payload):
    """Plain K1 vs the JAX gather path: warp_taps + similarity _jnp_impl."""
    rng = np.random.default_rng(1)
    d, h, w, c, g = 3, 12, 20, 32, 8
    src, ref, depth, ref_proj, src_proj = _warp_case(rng, d, h, w, c)
    jsrc, jref = _jax_payload(src, payload), _jax_payload(ref, payload)
    taps, w4, hwp = warp_taps(make_quad_image(jsrc, "zeros"), jnp.asarray(src_proj),
                              jnp.asarray(ref_proj), jnp.asarray(depth))
    gm = group_mean_matrix(c, g).numpy()
    want = np.asarray(_jnp_impl(taps, w4, jref.reshape(1, h * w, c), jnp.asarray(gm), d))
    want = want.reshape(1, g, d, h, w)
    mat12 = np.array(jax_warp_proj_coeffs(jnp.asarray(src_proj), jnp.asarray(ref_proj)))
    got = warp_group_corr_reference(_payload(src, payload)[0], torch.from_numpy(mat12),
                                    torch.from_numpy(depth), _payload(ref, payload)[0], g)
    # the gather path warps through normalized grid coordinates computed by
    # a different association (matmul, then normalize): ulp-level shifts
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert np.abs(got.numpy() - want).mean() < 2e-6


def _eval_grid(rng, b, ke, h, w):
    """Normalized (gx, gy) eval grids [B, Ke, H, W] in the reference's
    align_corners=True normalization, with offsets reaching past the border."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ax = xx[None, None] + rng.normal(0, 3.0, (b, ke, h, w))
    ay = yy[None, None] + rng.normal(0, 3.0, (b, ke, h, w))
    gx = (ax / ((w - 1) / 2.0) - 1.0).astype(np.float32)
    gy = (ay / ((h - 1) / 2.0) - 1.0).astype(np.float32)
    return gx, gy


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("c,g", [(16, 4), (64, 8)])
def test_neighbor_group_corr_matches_feature_weight_corr(monkeypatch, payload, c, g):
    """Plain K3 vs `_feature_weight_corr`, whose Pallas similarity kernel
    runs in interpret mode on CPU."""
    monkeypatch.setenv("PATCHMATCHNET_TPU_INTERPRET", "1")
    rng = np.random.default_rng(2)
    b, ke, h, w = 1, 9, 12, 20
    assert SLICE_PAD % 128 == 0  # padded slices take the Pallas path
    ref = rng.standard_normal((b, h, w, c)).astype(np.float32)
    gx, gy = _eval_grid(rng, b, ke, h, w)
    want = np.asarray(_feature_weight_corr(
        _jax_payload(ref, payload), (jnp.asarray(gx), jnp.asarray(gy)), g))
    got = neighbor_group_corr_reference(
        _payload(ref, payload)[0], (torch.from_numpy(gx), torch.from_numpy(gy)), g)
    assert got.shape == (b, g, ke, h, w)
    # identical coordinate formulas; sums in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _torch_eval_inputs(x_norm, cost, grid, fw, payload):
    gx, gy = np.array(grid[..., 0]), np.array(grid[..., 1])
    cost_t, cost_np = _payload(np.asarray(cost), payload)
    args = (torch.from_numpy(np.array(x_norm)), cost_t,
            (torch.from_numpy(gx), torch.from_numpy(gy)), torch.from_numpy(np.array(fw)))
    return args, jnp.asarray(cost_np)


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("d,ke,h,w", [(8, 9, 16, 48), (16, 9, 24, 32), (12, 9, 10, 14)])
def test_eval_grid_score_matches_unfused_tail(payload, d, ke, h, w):
    """Plain K2 vs the f32 unfused tail: the same math, normalize-then-sum
    vs sum-then-normalize, so f32 tolerance. D=12 is not a power of two:
    the port takes any D."""
    x_norm, cost, grid, fw = eval_tail_inputs(d, ke, h, w)
    args, cost_j = _torch_eval_inputs(x_norm, cost, grid, fw, payload)
    got = eval_grid_score(*args, 0.025)
    want = np.asarray(_unfused_score(x_norm, cost_j, grid, fw, 0.025))
    assert got.shape == (1, h, w, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("d", [8, 32])
def test_eval_grid_score_matches_quantized_eval_tail(payload, d):
    """Plain K2 vs the JAX `eval_grid_score` (CPU oracle path), which stores
    x_norm as 16-bit fixed point and the cost as bf16. Bound: x_norm error
    <= 2^-17, times 1/interval = 40, times the sigmoid-weight slope (<= 1)
    -> ~3e-4 relative weight error on |cost| <= 2; plus, for f32 costs, the
    bf16 cost rounding of <= 2^-9 relative -> 4e-3 absolute."""
    x_norm, cost, grid, fw = eval_tail_inputs(d, 9, 16, 48, seed=3)
    args, cost_j = _torch_eval_inputs(x_norm, cost, grid, fw, payload)
    got = eval_grid_score_reference(*args, 0.025).numpy()
    want = np.asarray(jax_eval_grid_score(x_norm, cost_j, grid, fw, 0.025))
    atol = 5e-3 if payload == "f32" else 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
