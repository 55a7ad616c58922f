"""The fused-views path (K6 `warp_group_corr_views`) and the coordinate-input
correlation (K7 `coord_group_corr`) of the port on the CPU, against the JAX
package on the same numpy inputs.

- K6's plain version vs `windowed_group_similarity_proj_views` (its
  `_jnp_windowed` path on the CPU) on the fixture of
  tests/test_windowed_similarity.py, at zero escapes.
- K7's plain version vs `windowed_group_similarity` on the escape-free,
  off-image and padded-width fixtures; on the escaping fixture the port
  (which reads the source directly) matches the dense oracle everywhere and
  JAX differs from it only where JAX wrote 0.
- K1's plain version is K7's applied to the warp coordinates.
- `Evaluation` on K6 (inference) and on the per-view route (a forward that
  records gradients) in f32, the whole bf16 and f32 model (which takes K6
  in inference) against the JAX model with PATCHMATCHNET_TPU_FUSED_VIEWS=1
  and the golden, and which kernels one forward routes through.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchmatchnet_tpu.compat import load_variables
from patchmatchnet_tpu.models import PatchmatchNet as JaxPatchmatchNet
from patchmatchnet_tpu.ops.pallas import windowed_similarity as jax_ws
from patchmatchnet_tpu.ops.pallas.windowed_similarity import (
    _coords_from_depth,
    escape_count,
    make_config,
    make_quad_table_2d,
    windowed_group_similarity,
    windowed_group_similarity_proj_views,
)
from patchmatchnet_torch.compat import read_flax_msgpack, state_dict_from_jax
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.models import patchmatch as port_patchmatch
from patchmatchnet_torch.models.patchmatch import Evaluation
from patchmatchnet_torch.ops import (
    coord_group_corr,
    coord_group_corr_reference,
    warp_group_corr_reference,
    warp_group_corr_views,
    warp_group_corr_views_reference,
)
from patchmatchnet_torch.ops.warp import warp_coords
from patchmatchnet_torch.ops.warp_similarity import group_mean_matrix
from test_torch_kernels_cpu import _jax_payload
from test_torch_kernels_cpu import _payload as _torch_payload
from test_torch_model import _check_against, _golden, _inputs
from test_windowed_similarity import _oracle, _smooth_coords

HERE = os.path.dirname(__file__)
CKPT = os.path.join(HERE, "..", "checkpoints", "params_000007.msgpack")
PAYLOADS = ["f32", "bf16"]


def _payload(x: np.ndarray, payload: str):
    """(torch tensor in the payload dtype, JAX array of the same values)."""
    return _torch_payload(x, payload)[0], _jax_payload(x, payload)


def _gm(c, g):
    return jnp.asarray(group_mean_matrix(c, g).numpy())


def _views_against_jax(payload, c, g, v, h, w, d, shifts):
    """Plain K6 vs the JAX views-fused entry on `v` views of a seeded
    [1, v, h, w, c] stack, view i warped by the translation shifts(i) (px
    per unit depth), with every view escape-free; tolerance 1e-5."""
    rng = np.random.default_rng(7)
    b = 1
    feats = rng.random((b, v, h, w, c), np.float32)
    ref = rng.random((b, h, w, c), np.float32)
    mats = np.zeros((b, v, 12), np.float32)
    for i in range(v):
        mats[:, i, 0] = mats[:, i, 5] = mats[:, i, 10] = 1.0
        mats[:, i, 3], mats[:, i, 7] = shifts(i)
    depth = (rng.random((b, d, h, w)) * 2 + 4).astype(np.float32)
    vw = rng.random((b, v, h, w)).astype(np.float32)
    cfg = make_config(h, w)
    feats_t, feats_j = _payload(feats, payload)
    ref_t, ref_j = _payload(ref, payload)
    quads = make_quad_table_2d(feats_j.reshape(b * v, h, w, c))
    quads = quads.reshape(b, v, *quads.shape[1:])
    for i in range(v):
        ix, iy = _coords_from_depth(jnp.asarray(mats[:, i]), jnp.asarray(depth), h, w)
        assert int(escape_count(ix, iy, cfg, h, w, quads.shape[2], quads.shape[3])) == 0
    want = np.asarray(windowed_group_similarity_proj_views(
        quads, jnp.asarray(mats), jnp.asarray(depth), ref_j, _gm(c, g), jnp.asarray(vw), cfg))
    got = warp_group_corr_views(feats_t, torch.from_numpy(mats), torch.from_numpy(depth),
                                ref_t, torch.from_numpy(vw), g)
    assert got.shape == (b, g, d, h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("c,g", [(16, 4), (32, 8), (64, 8)])
def test_views_reference_matches_jax_views(payload, c, g):
    """Plain K6 vs the JAX views-fused entry on the fixture of
    test_windowed_similarity.py::test_views_fused_matches_per_view_weighted_sum,
    with every view escape-free."""
    _views_against_jax(payload, c, g, 3, 32, 48, 8, lambda i: (0.3 * i, 0.2 * (i - 1)))


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("c,g", [(16, 4), (32, 8), (64, 8)])
def test_views_reference_matches_jax_views_at_51_views(payload, c, g):
    """Plain K6 at 51 views (more than the card kernel stages at once, and
    past the 50 its bf16 stage-1 block once fit in shared memory) vs the
    JAX views-fused entry, whose views are a grid axis with no limit; every
    view escape-free."""
    _views_against_jax(payload, c, g, 51, 16, 24, 4,
                       lambda i: (0.3 * (i % 5 - 2), 0.2 * (i // 5 % 3 - 1)))


@pytest.mark.parametrize("stage", [3, 2, 1])
def test_sweep_coords_are_the_jax_warp_of_fronto_parallel_planes(stage):
    """`dev.profile_coord.sweep_coords` (the coordinates of chip_smoke.py's
    plane sweep) on the synthetic scene's cameras: the JAX warp of the same
    projections and planes, planes far to near, and on a rig with identity
    rotations a shift of f * baseline / depth along x alone."""
    from patchmatchnet_torch.dev.profile_coord import sweep_coords

    n, height, width, d = 5, 64, 96, 6
    f = 1.1 * max(height, width)
    intr = torch.tensor([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]]).expand(n, 3, 3)
    extr = torch.eye(4).repeat(n, 1, 1)
    extr[:, 0, 3] = 0.35 * (torch.arange(n) - (n - 1) / 2.0)
    h, w = height >> stage, width >> stage
    mats, depth, hyp, coords = sweep_coords(intr, extr, torch.tensor(4.8), torch.tensor(7.8),
                                            stage, d, h, w)
    assert mats.shape == (n - 1, 12) and depth.shape == (1, d, h, w) and len(coords) == n - 1
    assert (hyp.diff() < 0).all() and 4.8 < hyp.min() and hyp.max() < 7.8
    xx = torch.arange(w, dtype=torch.float32).expand(h, w)
    for v, (ix, iy) in enumerate(coords):
        jx, jy = _coords_from_depth(jnp.asarray(mats[v:v + 1].numpy()), jnp.asarray(depth.numpy()),
                                    h, w)
        np.testing.assert_allclose(ix.numpy(), np.asarray(jx), rtol=0, atol=1e-4)
        np.testing.assert_allclose(iy.numpy(), np.asarray(jy), rtol=0, atol=1e-4)
        shift = (f / 2 ** stage) * 0.35 * (v + 1) / hyp
        np.testing.assert_allclose((ix[0] - xx).numpy(), shift[:, None, None].expand(d, h, w),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(iy[0].numpy(), torch.arange(h, dtype=torch.float32)[:, None]
                                   .expand(d, h, w).numpy(), rtol=0, atol=1e-4)


def test_profile_coord_inputs_do_not_depend_on_the_cases_run_before(monkeypatch):
    """`dev.profile_coord` seeds each case's inputs on its own, so a run
    that adds K6 cases with more views (which a tree whose K6 takes at most
    50 views leaves out) gives every other case the same inputs and outputs
    (plain versions on the CPU, a 64x48 scene)."""
    from patchmatchnet_torch.dev import profile_coord

    monkeypatch.setattr(profile_coord, "H", 48)
    monkeypatch.setattr(profile_coord, "W", 64)
    runs = [{f"{kid} {layout} {label}": fns["f32"]()
             for kid, layout, label, _, fns in profile_coord.cases(torch.device("cpu"), views)}
            for views in ([4], [4, 20])]
    assert set(runs[1]) - set(runs[0]) == {"K6 V20 stage2 C32 G8 D16 12x16"}
    for key, outs in runs[0].items():
        assert all(torch.equal(a, b) for a, b in zip(outs, runs[1][key])), key


def _coord_fixture(seed, h, w, d, edit=None):
    rng = np.random.default_rng(seed)
    b, c = 1, 16
    feature = rng.standard_normal((b, h, w, c)).astype(np.float32)
    ref = rng.standard_normal((b, h, w, c)).astype(np.float32)
    ix, iy = _smooth_coords(rng, b, d, h, w)
    if edit is not None:
        edit(ix, iy)
    return feature, ref, ix, iy


def _off_image(ix, iy):
    ix[0, 1] = 128 + 50.0  # whole slice off the image (the behind-camera push)


def _teleport(ix, iy):
    ix[0, 1, 4:6, 8:16] = 5.0
    iy[0, 1, 4:6, 8:16] = 2.0
    ix[0, 1, :, 100:] = 20.0
    iy[0, 1, :, 100:] = 10.0


def _jax_and_port(feature, ref, ix, iy, payload, g=4):
    h, w = feature.shape[1:3]
    f_t, f_j = _payload(feature, payload)
    r_t, r_j = _payload(ref, payload)
    cfg = make_config(h, w)
    quad = make_quad_table_2d(f_j)
    esc = int(escape_count(jnp.asarray(ix), jnp.asarray(iy), cfg, h, w,
                           quad.shape[1], quad.shape[2]))
    want = np.asarray(windowed_group_similarity(
        quad, jnp.asarray(ix), jnp.asarray(iy), r_j, _gm(feature.shape[-1], g), cfg))
    got = coord_group_corr(f_t, torch.from_numpy(ix), torch.from_numpy(iy), r_t, g).numpy()
    oracle = _oracle(f_t.float().numpy(), ix, iy, r_t.float().numpy(),
                     _gm(feature.shape[-1], g))
    return esc, got, want, oracle


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("case", ["covered", "off_image", "padded_width"])
def test_coord_reference_matches_jax_windowed(payload, case):
    """Plain K7 vs `windowed_group_similarity` on the escape-free fixtures
    of test_windowed_similarity.py (seeds 1, 3, 4)."""
    seed, h, w, d, edit = {"covered": (1, 16, 128, 4, None),
                           "off_image": (3, 16, 128, 2, _off_image),
                           "padded_width": (4, 16, 104, 4, None)}[case]
    esc, got, want, _ = _jax_and_port(*_coord_fixture(seed, h, w, d, edit), payload)
    assert esc == 0
    assert got.shape == (1, 4, d, h, w)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if case == "off_image":
        assert np.abs(got[0, :, 1]).max() == 0.0


@pytest.mark.parametrize("payload", PAYLOADS)
def test_coord_reference_is_exact_where_jax_escapes(payload):
    """On the escaping fixture (seed 2) JAX zeroes the escaped samples; the
    port reads the source directly, so it matches the dense oracle
    everywhere, and JAX differs from the oracle only where JAX wrote 0."""
    esc, got, want, oracle = _jax_and_port(*_coord_fixture(2, 16, 128, 2, _teleport), payload)
    assert esc > 0
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    differs = ~np.isclose(want, oracle, rtol=1e-5, atol=1e-5)
    assert differs.sum() > 0
    assert np.abs(want[differs]).max() == 0.0


@pytest.mark.parametrize("payload", PAYLOADS)
def test_warp_reference_is_coord_reference_of_warp_coords(payload):
    """K1's plain version equals K7's on `warp_coords`, to the bit, with
    samples behind the camera and off the image."""
    gen = torch.Generator().manual_seed(0)
    h, w, c, g, d = 12, 20, 32, 8, 5
    src = torch.randn((2, h, w, c), generator=gen)
    ref = torch.randn((2, h, w, c), generator=gen)
    if payload == "bf16":
        src, ref = src.to(torch.bfloat16), ref.to(torch.bfloat16)
    mat12 = torch.tensor([[1.0, 0.01, -3.0, 4.0, 0.0, 1.0, 0.5, -2.0, 1e-3, 0.0, 1.0, 0.2]] * 2)
    depth = 0.5 + 6.0 * torch.rand((2, d, h, w), generator=gen)
    depth[:, 0, :3] = -1.0
    ix, iy = warp_coords(mat12, depth, h, w)
    assert (ix == w).any() and (ix < 0).any()
    want = coord_group_corr_reference(src, ix, iy, ref, g)
    assert torch.equal(warp_group_corr_reference(src, mat12, depth, ref, g), want)
    assert torch.equal(coord_group_corr(src, ix, iy, ref, g), want)


def test_views_wrappers_refuse_grad():
    """K6 and K7 are inference only: with grad enabled, an input that
    requires grad raises; under no_grad the same call runs."""
    h, w, c, g = 6, 8, 16, 4
    src = torch.randn((1, 2, h, w, c), requires_grad=True)
    mats = torch.zeros((1, 2, 12))
    mats[..., 0] = mats[..., 5] = mats[..., 10] = 1.0
    depth = torch.full((1, 3, h, w), 2.0)
    ref = torch.randn((1, h, w, c))
    vw = torch.rand((1, 2, h, w))
    with pytest.raises(ValueError, match="no backward"):
        warp_group_corr_views(src, mats, depth, ref, vw, g)
    ix, iy = warp_coords(mats[:, 0], depth, h, w)
    with pytest.raises(ValueError, match="no backward"):
        coord_group_corr(src[:, 0], ix, iy, ref, g)
    with torch.no_grad():
        assert warp_group_corr_views(src, mats, depth, ref, vw, g).shape == (1, g, 3, h, w)


def _evaluation_inputs(rng, b, v, h, w, c, d):
    ref = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32))
    srcs = torch.from_numpy(rng.standard_normal((b, v, h, w, c)).astype(np.float32))
    mats = np.zeros((b, v, 12), np.float32)
    for i in range(v):
        mats[:, i, 0] = mats[:, i, 5] = mats[:, i, 10] = 1.0
        mats[:, i, 3] = 0.7 * (i + 1)
        mats[:, i, 7] = -0.4 * i
    mats = torch.from_numpy(mats)
    depth = torch.from_numpy(np.sort(2.0 + 4.0 * rng.random((b, d, h, w)), 1).astype(np.float32))
    gx = torch.from_numpy(rng.uniform(-1, 1, (b, 9, h, w)).astype(np.float32))
    gy = torch.from_numpy(rng.uniform(-1, 1, (b, 9, h, w)).astype(np.float32))
    x_norm = torch.from_numpy(rng.random((b, h, w, d)).astype(np.float32))
    vw = torch.from_numpy(rng.random((b, v, h, w)).astype(np.float32))
    return ref, srcs, mats, depth, (gx, gy), x_norm, vw


def test_evaluation_fused_matches_per_view(monkeypatch):
    """f32 eval-mode `Evaluation` given view weights: under no_grad one K6
    call; with grad enabled (K6 has no backward) K1 per view and the
    weighted sum. Same weights and inputs, B = 2."""
    rng = np.random.default_rng(11)
    b, v, h, w, c, g, d = 2, 4, 10, 14, 32, 8, 16
    ref, srcs, mats, depth, grid, x_norm, vw = _evaluation_inputs(rng, b, v, h, w, c, d)
    torch.manual_seed(0)
    evaluation = Evaluation(g, pixel_wise=False).eval()
    for p in evaluation.parameters():
        p.data.uniform_(-0.5, 0.5)
    k6_calls = []
    real = port_patchmatch.warp_group_corr_views
    monkeypatch.setattr(port_patchmatch, "warp_group_corr_views",
                        lambda *a: k6_calls.append(1) or real(*a))
    common = (ref, list(srcs.unbind(1)), [m.contiguous() for m in mats.unbind(1)], depth,
              grid, x_norm, None, 0.0125, vw, False)
    want = [t.detach() for t in evaluation(*common, src_stack=srcs, mats=mats)]
    assert not k6_calls
    with torch.no_grad():
        got = evaluation(*common, src_stack=srcs, mats=mats)
        assert len(k6_calls) == 1
        with pytest.raises(ValueError, match="src_stack"):
            evaluation(*common)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def state_dict():
    return state_dict_from_jax(read_flax_msgpack(CKPT))


def _port_forward(state_dict, name, dtype):
    g = _golden(name)
    model = PatchmatchNet(compute_dtype=dtype)
    model.load_state_dict(state_dict, strict=True)
    with torch.inference_mode():
        depth, conf, dp = model(*[torch.from_numpy(np.array(a)) for a in _inputs(g)],
                                init_noise=torch.from_numpy(g["noise"]))
    return depth.numpy(), conf.numpy(), {s: [d.numpy() for d in v] for s, v in dp.items()}


def _jax_forward(name, dtype):
    g = _golden(name)
    model = JaxPatchmatchNet(compute_dtype=dtype)
    fwd = jax.jit(lambda v, *a, noise: model.apply(v, *a, train=False, init_noise=noise))
    depth, conf, dp = fwd(load_variables(CKPT), *[jnp.asarray(a) for a in _inputs(g)],
                          noise=jnp.asarray(g["noise"]))
    return np.asarray(depth), np.asarray(conf), jax.tree.map(np.asarray, dp)


def test_fused_bf16_matches_jax_fused_bf16(monkeypatch, state_dict):
    """The port's bf16 inference forward (K6 after stage 3's first
    evaluation) vs the JAX bf16 model with PATCHMATCHNET_TPU_FUSED_VIEWS=1 (read at trace time, so a fresh
    jit), on forward_80x104_n5 at the bounds of
    test_torch_model.py::test_bf16_matches_jax_bf16. The JAX model fuses
    where its windowed sampler runs (stages 2 and 1 here)."""
    name = "forward_80x104_n5"
    g = _golden(name)
    depth_range = float(g["depth_max"] - g["depth_min"])
    ref_f32 = _jax_forward(name, None)
    jax_views = []
    real = jax_ws.windowed_group_similarity_proj_views
    monkeypatch.setattr(jax_ws, "windowed_group_similarity_proj_views",
                        lambda *a: jax_views.append(1) or real(*a))
    monkeypatch.setenv("PATCHMATCHNET_TPU_FUSED_VIEWS", "1")
    ref = _jax_forward(name, jnp.bfloat16)
    jax.clear_caches()
    assert len(jax_views) == 3  # stage 2 (2 iterations) and stage 1, traced once
    ours = _port_forward(state_dict, name, torch.bfloat16)
    ours_f32 = _port_forward(state_dict, name, None)
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
    # the f32 inference forward meets the golden at the golden bounds
    want = (g["depth"], g["confidence"],
            {s: [g[f"stage{s}_iter{i}"] for i in range(2) if f"stage{s}_iter{i}" in g]
             for s in range(4)})
    _check_against(ours_f32, want, depth_range)


def test_fused_forward_routes_through_k6(monkeypatch, state_dict):
    """One inference forward at N=5 calls K1 4 times (stage 3's first
    evaluation, one per source view) and K6 4 times (every later
    evaluation); a forward that records gradients, in train mode or in eval
    mode with grad enabled, never calls K6."""
    calls = {"warp_group_corr": 0, "warp_group_corr_views": 0}
    for name in calls:
        real = getattr(port_patchmatch, name)

        def spy(*args, _real=real, _name=name):
            calls[_name] += 1
            return _real(*args)

        monkeypatch.setattr(port_patchmatch, name, spy)
    g = _golden("forward_80x104_n5")
    args = [torch.from_numpy(np.array(a)) for a in _inputs(g)]
    noise = torch.from_numpy(g["noise"])
    model = PatchmatchNet()
    model.load_state_dict(state_dict, strict=True)
    with torch.inference_mode():
        model(*args, init_noise=noise)
    assert calls == {"warp_group_corr": 4, "warp_group_corr_views": 4}
    for train in (False, True):
        calls.update({k: 0 for k in calls})
        model.train(train)
        model(*args, init_noise=noise)
        assert calls == {"warp_group_corr": 20, "warp_group_corr_views": 0}
