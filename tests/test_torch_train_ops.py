"""The port's training pieces against the JAX package, on the CPU:

- K4's plain version (autograd through `warp_group_corr_reference`, depth
  and projection detached) vs `jax.vjp` of the gather formulation
  (`ops/warp.py` `differentiable_warp` x ref, group mean) and of
  `windowed_group_similarity_proj` (its own VJP, `_wgsp_bwd`), with
  respect to (src, ref); samples behind the camera and off the image; no
  gradient reaches depth. f32 bound: 1e-5 of the largest gradient entry.
- K5's plain version vs `jax.vjp` of `_feature_weight_corr(ref_sg, (gx,
  gy), G)` with respect to the grid, with grid points clamped at the
  border; the wrapper refuses a reference feature that requires grad.
- Train-mode BatchNorm vs flax `nn.BatchNorm(momentum=0.9)`.
- Adam + MultiStep vs `make_optimizer` / `multistep_lr` (optax), across a
  milestone and with weight decay: parameters agree to 1e-6 of their
  largest entry.
- A JAX `save_train_checkpoint` file resumed by the port (parameters, batch
  statistics, Adam moments, step, epoch), then one step on each side with
  the same gradients; the port's own checkpoint round trip is bit-exact.
- The training data layer (scan list, lights, max_dim, depth_gt, mask,
  seeded shuffle) vs `patchmatchnet_tpu.data` on a tests/scene_utils scene.
- `run_training` on a tiny synthetic scene, and its resume.
"""

import json
import os
import shutil

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from patchmatchnet_tpu.data import BatchLoader as JaxBatchLoader
from patchmatchnet_tpu.data import MVSDataset as JaxMVSDataset
from patchmatchnet_tpu.models.patchmatch import _feature_weight_corr
from patchmatchnet_tpu.ops.pallas.windowed_similarity import (
    _coords_from_depth,
    escape_count,
    make_config,
    make_quad_table_2d,
    windowed_group_similarity_proj,
)
from patchmatchnet_tpu.ops.warp import differentiable_warp
from patchmatchnet_tpu.ops.warp import warp_proj_coeffs as jax_warp_proj_coeffs
from patchmatchnet_tpu.train.loop import build_stage_pyramid as jax_build_stage_pyramid
from patchmatchnet_tpu.train.loop import create_train_state
from patchmatchnet_tpu.train.loop import make_optimizer as jax_make_optimizer
from patchmatchnet_tpu.train.loop import multistep_lr as jax_multistep_lr
from patchmatchnet_tpu.train.loop import save_train_checkpoint as jax_save_train_checkpoint
from patchmatchnet_tpu.utils.metrics import absolute_depth_error as jax_abs_err
from patchmatchnet_tpu.utils.metrics import threshold_error as jax_threshold_error
from patchmatchnet_torch.compat import read_flax_msgpack, tensors_from_jax_params
from patchmatchnet_torch.config import Config
from patchmatchnet_torch.data import BatchLoader, MVSDataset, make_synthetic_scene
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.models.layers import BatchNorm
from patchmatchnet_torch.ops import (
    neighbor_group_corr,
    neighbor_group_corr_backward,
    warp_group_corr,
    warp_group_corr_backward,
)
from patchmatchnet_torch.ops import warp_similarity
from patchmatchnet_torch.ops.warp_similarity import group_mean_matrix
from patchmatchnet_torch.train import (
    build_stage_pyramid,
    find_latest_checkpoint,
    load_train_checkpoint,
    make_optimizer,
    multistep_lr,
    run_training,
    save_train_checkpoint,
)
from patchmatchnet_torch.utils import absolute_depth_error, threshold_error
from test_torch_kernels_cpu import _eval_grid, _projections
from tests.scene_utils import make_synthetic_scene as jax_make_synthetic_scene

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "params_000007.msgpack")


def _assert_close_to_max(got, want, bound=1e-5):
    """max |got - want| <= bound * max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max()
    assert err <= bound * scale, (err, scale)


def _warp_inputs(seed, d, h, w, c, g):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((1, h, w, c)).astype(np.float32)
    ref = rng.standard_normal((1, h, w, c)).astype(np.float32)
    depth = (4.0 + 4.0 * rng.random((1, d, h, w))).astype(np.float32)
    depth[:, 0, :4] = -0.5  # behind the source camera: pushed off-image
    dout = rng.standard_normal((1, g, d, h, w)).astype(np.float32)
    ref_proj, src_proj = _projections(h, w, baseline=0.35)
    mat12 = np.array(jax_warp_proj_coeffs(jnp.asarray(src_proj), jnp.asarray(ref_proj)))
    return src, ref, depth, dout, ref_proj, src_proj, mat12


@pytest.mark.parametrize("c,g", [(16, 4), (32, 8), (64, 8)])
def test_warp_backward_matches_jax_gather_vjp(c, g):
    d, h, w = 3, 12, 20
    src, ref, depth, dout, ref_proj, src_proj, mat12 = _warp_inputs(1, d, h, w, c, g)
    ix, _ = _coords_from_depth(jnp.asarray(mat12), jnp.asarray(depth), h, w)
    assert (np.asarray(ix) > w - 1).any(), "fixture must leave the image"
    gm = jnp.asarray(group_mean_matrix(c, g).numpy())

    def jax_sim(s, r):
        warped = differentiable_warp(s, jnp.asarray(src_proj), jnp.asarray(ref_proj),
                                     jnp.asarray(depth))  # [B, D, H, W, C]
        return jnp.einsum("bdhwc,cg->bgdhw", warped * r[:, None], gm,
                          precision=jax.lax.Precision.HIGHEST)

    _, vjp = jax.vjp(jax_sim, jnp.asarray(src), jnp.asarray(ref))
    want_src, want_ref = vjp(jnp.asarray(dout))
    got_src, got_ref = warp_group_corr_backward(
        torch.from_numpy(src), torch.from_numpy(mat12), torch.from_numpy(depth),
        torch.from_numpy(ref), g, torch.from_numpy(dout))
    _assert_close_to_max(got_src.numpy(), want_src)
    _assert_close_to_max(got_ref.numpy(), want_ref)


@pytest.mark.parametrize("payload", ["f32", "bf16"])
def test_warp_backward_matches_windowed_vjp(payload):
    """The wrapper's autograd (CPU route) vs the windowed path's own VJP at
    a geometry `make_config` admits, with zero escapes."""
    d, h, w, c, g = 4, 16, 128, 16, 4
    src, ref, depth, dout, _, _, mat12 = _warp_inputs(0, d, h, w, c, g)
    jdt = jnp.bfloat16 if payload == "bf16" else jnp.float32
    tdt = torch.bfloat16 if payload == "bf16" else torch.float32
    cfg = make_config(h, w)
    gm = jnp.asarray(group_mean_matrix(c, g).numpy())
    jsrc, jref = jnp.asarray(src, jdt), jnp.asarray(ref, jdt)
    quad = make_quad_table_2d(jsrc)
    ix, iy = _coords_from_depth(jnp.asarray(mat12), jnp.asarray(depth), h, w)
    assert int(escape_count(ix, iy, cfg, h, w, quad.shape[1], quad.shape[2])) == 0
    _, vjp = jax.vjp(lambda s, r: windowed_group_similarity_proj(
        make_quad_table_2d(s), jnp.asarray(mat12), jnp.asarray(depth), r, gm, cfg),
        jsrc, jref)
    want_src, want_ref = (np.asarray(x, np.float32) for x in vjp(jnp.asarray(dout)))

    src_t = torch.from_numpy(src).to(tdt).requires_grad_(True)
    ref_t = torch.from_numpy(ref).to(tdt).requires_grad_(True)
    depth_t = torch.from_numpy(depth).requires_grad_(True)
    out = warp_group_corr(src_t, torch.from_numpy(mat12), depth_t, ref_t, g)
    out.backward(torch.from_numpy(dout))
    assert depth_t.grad is None, "the warp coordinates carry no gradient"
    assert src_t.grad.dtype == tdt and ref_t.grad.dtype == tdt
    # bf16: the port rounds its f32 sums to bf16 once (2^-9 relative); the
    # JAX side rounds each of the 4 quad-table cotangents and their sums
    # through the table's VJP in bf16, up to ~5 roundings of 2^-9 of the
    # largest entry (measured 1.02e-2)
    bound = 1e-5 if payload == "f32" else 2e-2
    _assert_close_to_max(src_t.grad.float().numpy(), want_src, bound)
    _assert_close_to_max(ref_t.grad.float().numpy(), want_ref, bound)


@pytest.mark.parametrize("payload", ["f32", "bf16"])
@pytest.mark.parametrize("c,g", [(16, 4), (64, 8)])
def test_neighbor_backward_matches_jax_vjp(payload, c, g):
    rng = np.random.default_rng(3)
    b, ke, h, w = 1, 9, 12, 20
    ref = rng.standard_normal((b, h, w, c)).astype(np.float32)
    gx, gy = _eval_grid(rng, b, ke, h, w)
    sx = ((gx + 1.0) * w - 1.0) * 0.5
    assert (sx < 0).any() and (sx > w - 1).any(), "fixture must clamp at the border"
    dout = rng.standard_normal((b, g, ke, h, w)).astype(np.float32)
    jdt = jnp.bfloat16 if payload == "bf16" else jnp.float32
    tdt = torch.bfloat16 if payload == "bf16" else torch.float32
    jref = jnp.asarray(ref, jdt)
    _, vjp = jax.vjp(lambda x, y: _feature_weight_corr(jref, (x, y), g),
                     jnp.asarray(gx), jnp.asarray(gy))
    want_gx, want_gy = vjp(jnp.asarray(dout))
    got_gx, got_gy = neighbor_group_corr_backward(
        torch.from_numpy(ref).to(tdt), (torch.from_numpy(gx), torch.from_numpy(gy)), g,
        torch.from_numpy(dout))
    _assert_close_to_max(got_gx.numpy(), want_gx)
    _assert_close_to_max(got_gy.numpy(), want_gy)
    clamped = (sx < 0) | (sx > w - 1)
    assert (got_gx.numpy()[clamped] == 0).all(), "no gradient where the clamp binds"


def _scatter_brute_force(mat12, depth, hs, ws, c):
    """`k4_scatter_counts` recomputed sample by sample in numpy: the warp of
    `warp_taps` in f32 operations, and each pixel's hypotheses in order,
    consecutive samples with a valid corner in one cell (first pixel and
    valid corners) merged."""
    b, d, h, w = depth.shape
    f32 = np.float32
    out = dict(samples=0, merged_cells=0, global_atomics=0,
               parent_atomics=b * d * h * w * 4 * (c // 4))
    vv, uu = np.meshgrid(np.arange(h, dtype=f32), np.arange(w, dtype=f32), indexing="ij")
    for bi in range(b):
        m = mat12[bi].astype(f32)
        rx, ry, rz = (m[i] * uu + m[i + 1] * vv + m[i + 2] for i in (0, 4, 8))
        last = {}
        for di in range(d):
            dep = depth[bi, di].astype(f32)
            px, py, pz = rx * dep + m[3], ry * dep + m[7], rz * dep + m[11]
            behind = pz <= f32(1e-3)
            with np.errstate(divide="ignore", invalid="ignore"):
                ix = np.where(behind, f32(ws), px / pz)
                iy = np.where(behind, f32(hs), py / pz)
            for y in range(h):
                for x in range(w):
                    x0, y0 = np.floor(ix[y, x]), np.floor(iy[y, x])
                    vx = (0 <= x0 <= ws - 1, -1 <= x0 <= ws - 2)
                    vy = (0 <= y0 <= hs - 1, -1 <= y0 <= hs - 2)
                    valid = [t for t in range(4) if vx[t & 1] and vy[t >> 1]]
                    if not valid:
                        continue
                    out["samples"] += 1
                    if last.get((y, x)) != (x0, y0, tuple(valid)):
                        out["merged_cells"] += 1
                        out["global_atomics"] += len(valid) * (c // 4)
                    last[y, x] = (x0, y0, tuple(valid))
    return out


@pytest.mark.parametrize("case", ["plane", "iid", "behind_and_off"])
@pytest.mark.parametrize("c", [16, 64])
def test_k4_scatter_counts_match_brute_force(case, c):
    """`k4_scatter_counts` against `_scatter_brute_force`: a plane (each
    pixel's hypotheses 0.002 apart in inverse depth: most merge), i.i.d.
    depths over a wide range (few merge), and the plane with samples behind
    the camera and far off the image (no valid corner: counted nowhere, and
    they do not break a merged run)."""
    rng = np.random.default_rng(7)
    b, d, h, w = 2, 16, 12, 21
    ref_proj, src_proj = _projections(h, w, baseline=0.35)
    mat12 = np.array(jax_warp_proj_coeffs(jnp.asarray(src_proj), jnp.asarray(ref_proj)))
    mat12 = np.repeat(mat12, b, axis=0)
    inv = 1.0 / 6.0 + 0.002 * (np.arange(d) - d // 2)[None, :, None, None]
    depth = np.broadcast_to(1.0 / inv, (b, d, h, w)).astype(np.float32).copy()
    if case == "iid":
        depth = (1.0 / rng.uniform(0.02, 2.0, (b, d, h, w))).astype(np.float32)
    if case == "behind_and_off":
        depth[:, 3, :4] = -1.0  # behind the source camera
        depth[:, 5, 4:8] = 0.01  # so near that the warp leaves the image
    src = torch.zeros((b, h, w, c), dtype=torch.bfloat16)
    got = warp_similarity.k4_scatter_counts(src, torch.from_numpy(mat12),
                                            torch.from_numpy(depth), src, c // 4, None)
    assert got == _scatter_brute_force(mat12, depth, h, w, c)
    if case == "iid":
        assert got["merged_cells"] > 0.8 * got["samples"]
    else:
        assert got["merged_cells"] < 0.5 * got["samples"]
    assert 0 < got["global_atomics"] < got["parent_atomics"]


def test_profile_backward_records_calls_and_lays_out_the_path():
    """`dev.profile_backward`: `record_calls` returns cloned arguments of a
    step's K4 and K5 calls and puts the wrappers back, `call_cases` turns
    them into cases; `path_depth` at stage 3 D64 puts hypothesis d of every
    pixel in inverse-depth bin d, and elsewhere is sorted around the plane."""
    from patchmatchnet_torch.dev import profile_backward
    from patchmatchnet_torch.ops import neighbor_similarity

    gen = torch.Generator().manual_seed(0)
    b, d, h, w, c, g = 1, 4, 6, 8, 16, 4
    mat12 = profile_backward.rig_mat12(h, w, 8, b, "cpu")
    src, ref = torch.randn((b, h, w, c)), torch.randn((b, h, w, c))
    depth = profile_backward.iid_depth(b, d, h, w, gen, "cpu")
    k4_args = (src, mat12, depth, ref, g, torch.randn((b, g, d, h, w)))
    grid = (torch.rand((b, 9, h, w)) * 2 - 1, torch.rand((b, 9, h, w)) * 2 - 1)
    k5_args = (ref, grid, g, torch.randn((b, g, 9, h, w)))
    wrappers = (warp_similarity.warp_group_corr_backward,
                neighbor_similarity.neighbor_group_corr_backward)

    def step():
        warp_similarity.warp_group_corr_backward(*k4_args)
        neighbor_similarity.neighbor_group_corr_backward(*k5_args)

    calls = profile_backward.record_calls(step)
    assert (warp_similarity.warp_group_corr_backward,
            neighbor_similarity.neighbor_group_corr_backward) == wrappers
    assert [kid for kid, _ in calls] == ["K4", "K5"]
    assert torch.equal(calls[0][1][2], depth) and calls[0][1][2] is not depth
    assert torch.equal(calls[1][1][1][0], grid[0]) and calls[1][1][2] == g
    cases = profile_backward.call_cases(calls)
    assert [(kid, layout, n) for kid, _, layout, _, n in cases] == [("K4", "train", 1),
                                                                    ("K5", "train", 1)]
    inv_lo, inv_hi = 1 / profile_backward.DEPTH_MAX, 1 / profile_backward.DEPTH_MIN
    strata = profile_backward.path_depth(3, b, 64, h, w, gen, "cpu")
    bins = ((1 / strata - inv_lo) / (inv_hi - inv_lo) * 64).floor()
    assert torch.equal(bins, torch.arange(64.0).reshape(1, 64, 1, 1).expand_as(bins))
    plane = profile_backward.path_depth(2, b, 16, h, w, gen, "cpu")
    assert (plane.diff(dim=1) < 0).all() and (plane - profile_backward.PLANE).abs().max() < 0.5


def test_neighbor_corr_refuses_a_feature_with_grad():
    ref = torch.randn((1, 6, 8, 16), requires_grad=True)
    grid = (torch.zeros((1, 9, 6, 8)), torch.zeros((1, 9, 6, 8)))
    with pytest.raises(ValueError, match="detached"):
        neighbor_group_corr(ref, grid, 4)
    assert neighbor_group_corr(ref.detach(), grid, 4).shape == (1, 4, 9, 6, 8)


@pytest.mark.parametrize("shape", [(4, 8, 5, 6), (2, 16, 3, 5, 7)])
def test_train_batch_norm_matches_flax(shape):
    """Batch statistics in f32, biased running variance, 0.9/0.1 EMA."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    c = shape[1]
    scale = rng.random(c).astype(np.float32) + 0.5
    bias = rng.standard_normal(c).astype(np.float32)
    mean0 = rng.standard_normal(c).astype(np.float32)
    var0 = rng.random(c).astype(np.float32) + 0.5
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, axis=1)
    want, updates = bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm(c).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(), updates["batch_stats"]["mean"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), updates["batch_stats"]["var"],
                               rtol=1e-6, atol=1e-6)
    # bf16 input: f32 statistics, bf16 output
    assert port(torch.from_numpy(x).to(torch.bfloat16)).dtype == torch.bfloat16


def test_stage_pyramid_and_metrics_match_jax():
    rng = np.random.default_rng(4)
    gt = (rng.random((2, 32, 40)) * 4 + 2).astype(np.float32)
    mask = rng.random((2, 32, 40)) > 0.3
    est = gt + rng.standard_normal(gt.shape).astype(np.float32) * 2
    gts, masks = build_stage_pyramid(torch.from_numpy(gt), torch.from_numpy(mask))
    jgts, jmasks = jax_build_stage_pyramid(jnp.asarray(gt), jnp.asarray(mask))
    for a, b, ma, mb in zip(gts, jgts, masks, jmasks):
        np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(ma.numpy(), mb)
    args = (torch.from_numpy(est), torch.from_numpy(gt), torch.from_numpy(mask))
    jargs = tuple(jnp.asarray(a.numpy()) for a in args)
    np.testing.assert_allclose(float(absolute_depth_error(*args)), float(jax_abs_err(*jargs)),
                               rtol=1e-6)
    for t in (1.0, 2.0):
        np.testing.assert_allclose(float(threshold_error(*args, t)),
                                   float(jax_threshold_error(*jargs, t)), rtol=1e-6)


def _tree_and_params(seed):
    """A small params tree (flax layout) and the same values as torch
    parameters keyed like the port's state dict."""
    rng = np.random.default_rng(seed)
    tree = {"a": {"conv": {"kernel": rng.standard_normal((3, 3, 4, 5)).astype(np.float32)},
                  "bn": {"scale": rng.random(5).astype(np.float32) + 0.5,
                         "bias": rng.standard_normal(5).astype(np.float32)}},
            "d": {"dense": {"kernel": rng.standard_normal((6, 2)).astype(np.float32),
                            "bias": rng.standard_normal(2).astype(np.float32)}}}
    params = {k: torch.nn.Parameter(v) for k, v in tensors_from_jax_params(tree).items()}
    return tree, params


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adam_multistep_matches_optax(weight_decay):
    """Same gradient trees into both optimizers for 6 steps at 2 steps per
    epoch with milestones at epochs 1 and 2 (steps 2 and 4)."""
    tree, params = _tree_and_params(0)
    schedule = multistep_lr(1e-2, "1,2:2", steps_per_epoch=2)
    jax_schedule = jax_multistep_lr(1e-2, "1,2:2", steps_per_epoch=2)
    tx = jax_make_optimizer(jax_schedule, weight_decay)
    jparams = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(jparams)
    opt = make_optimizer(params.values(), 1e-2, weight_decay)
    rng = np.random.default_rng(1)
    for step in range(6):
        assert np.isclose(schedule(step), float(jax_schedule(step)), rtol=1e-7)
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), tree)
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, g in tensors_from_jax_params(grads).items():
            params[name].grad = g
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
        want = tensors_from_jax_params(jax.tree.map(np.asarray, jparams))
        for name, p in params.items():
            # the two round the same update in another order: ~1 ulp
            _assert_close_to_max(p.detach().numpy(), want[name].numpy(), 1e-6)
    assert schedule(1) == 1e-2 and schedule(2) == 5e-3 and schedule(4) == 2.5e-3


def test_jax_train_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX training checkpoint (after one Adam step) loads into the port;
    one more step with the same gradients gives the same parameters."""
    variables = read_flax_msgpack(CKPT)
    tx = jax_make_optimizer(1e-3, 1e-4)
    state = create_train_state(None, jax.tree.map(jnp.asarray, variables), tx)
    rng = np.random.default_rng(2)

    def grad_tree():
        return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-2).astype(np.float32),
                            variables["params"])

    def jax_step(state, grads):
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), state.opt_state,
                                       state.params)
        return state.replace(params=optax.apply_updates(state.params, updates),
                             opt_state=opt_state, step=state.step + 1)

    state = jax_step(state, grad_tree())
    path = str(tmp_path / "params_000003.ckpt.msgpack")
    jax_save_train_checkpoint(path, state, epoch=3)

    model = PatchmatchNet()
    opt = make_optimizer(model.parameters(), 1e-3, 1e-4)
    step, epoch = load_train_checkpoint(path, model, opt)
    assert (step, epoch) == (1, 3)
    sd = model.state_dict()
    for name, want in tensors_from_jax_params(jax.tree.map(np.asarray, state.params)).items():
        assert torch.equal(sd[name], want), name
    assert torch.equal(sd["feature.conv0.bn.running_var"],
                       torch.from_numpy(np.asarray(
                           variables["batch_stats"]["feature"]["conv0"]["bn"]["var"])))

    grads = grad_tree()
    state = jax_step(state, grads)
    for name, g in tensors_from_jax_params(grads).items():
        dict(model.named_parameters())[name].grad = g
    opt.step()
    want = tensors_from_jax_params(jax.tree.map(np.asarray, state.params))
    for name, p in model.named_parameters():
        _assert_close_to_max(p.detach().numpy(), want[name].numpy(), 1e-6)


def test_port_checkpoint_round_trip_is_exact(tmp_path):
    torch.manual_seed(0)
    model = PatchmatchNet()
    opt = make_optimizer(model.parameters(), 1e-3)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    with torch.no_grad():
        for buf in model.buffers():
            buf.uniform_(0.5, 1.5)
    path = str(tmp_path / "params_000002.ckpt.pt")
    save_train_checkpoint(path, model, opt, step=7, epoch=2)
    assert find_latest_checkpoint(str(tmp_path)) == path
    model2 = PatchmatchNet()
    opt2 = make_optimizer(model2.parameters(), 1e-3)
    assert load_train_checkpoint(path, model2, opt2) == (7, 2)
    for (k, a), (_, b) in zip(model.state_dict().items(), model2.state_dict().items()):
        assert torch.equal(a, b), k
    for p, p2 in zip(model.parameters(), model2.parameters()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][key], opt2.state[p2][key]), key


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """Two reference-layout scans (60x84, 4 views, depth_gt) with two light
    folders each, and a scan list."""
    root = tmp_path_factory.mktemp("scans")
    for scan in ("scan1", "scan2"):
        jax_make_synthetic_scene(str(root / scan), num_views=4, height=60, width=84,
                                 image_extension=".png", texture_scale=6.0)
        images = root / scan / "images"
        for light in ("0", "1"):
            (images / light).mkdir()
            for png in images.glob("*.png"):
                shutil.copy(png, images / light / png.name)
    (root / "scans.txt").write_text("scan1\nscan2\n")
    return str(root), str(root / "scans.txt")


@pytest.mark.parametrize("max_dim", [-1, 48])
def test_training_dataset_matches_reference(scans, max_dim):
    root, scan_list = scans
    kw = dict(max_dim=max_dim, scan_list=scan_list, num_light_idx=2)
    got = MVSDataset(root, 2, ".png", **kw)
    want = JaxMVSDataset(root, num_views=2, image_extension=".png", **kw)
    assert len(got) == len(want) == 16
    assert got.metas == want.metas
    for idx in (0, 5, 15):
        g, w = got[idx], want[idx]
        assert g["filename"] == w["filename"]
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_allclose(g["intrinsics"], w["intrinsics"], rtol=1e-6)
        np.testing.assert_allclose(g["depth_gt"], w["depth_gt"], rtol=1e-6)
        np.testing.assert_array_equal(g["mask"], w["mask"])
        for key in ("extrinsics", "depth_min", "depth_max"):
            np.testing.assert_array_equal(g[key], w[key])
    if max_dim > 0:
        assert got[0]["images"].shape[1:3] == (34, 48)


def test_seeded_shuffle_matches_reference_first_epoch(scans):
    root, scan_list = scans
    kw = dict(scan_list=scan_list, num_light_idx=2)
    got = BatchLoader(MVSDataset(root, 2, ".png", **kw), batch_size=3, shuffle=True,
                      drop_last=True, seed=5, num_threads=2)
    want = JaxBatchLoader(JaxMVSDataset(root, num_views=2, image_extension=".png", **kw),
                          batch_size=3, shuffle=True, drop_last=True, seed=5, num_threads=1)
    assert len(got) == len(want) == 5
    names = [b["filename"] for b in got]
    assert names == [b["filename"] for b in want]
    got.set_epoch(1)
    assert [b["filename"] for b in got] != names  # a new order per epoch
    got.set_epoch(0)
    assert [b["filename"] for b in got] == names  # a function of (seed, epoch)


def test_robust_train_is_seeded(scans):
    root, scan_list = scans
    a = MVSDataset(root, 2, ".png", scan_list=scan_list, robust_train=True, seed=1)
    b = MVSDataset(root, 2, ".png", scan_list=scan_list, robust_train=True, seed=1)
    views = [a[i]["extrinsics"][1:, 0, 3].tolist() for i in range(len(a))]
    assert views == [b[i]["extrinsics"][1:, 0, 3].tolist() for i in range(len(b))]
    a.epoch = 1
    assert views != [a[i]["extrinsics"][1:, 0, 3].tolist() for i in range(len(a))]


def _config(scene, out, epochs, resume=False):
    cfg = Config()
    cfg.model.train_precision = "f32"
    cfg.data.input_folder = scene
    cfg.data.num_views = 2
    cfg.data.image_extension = ".png"
    cfg.data.batch_size = 2
    cfg.train.output_folder = out
    cfg.train.checkpoint_path = CKPT
    cfg.train.resume = resume
    cfg.train.epochs = epochs
    cfg.train.summary_freq = 1
    cfg.train.device = "cpu"
    return cfg


def test_run_training_writes_checkpoints_and_resumes(tmp_path):
    """2 steps per epoch on a 4-view 32x40 plane, warm-started from the
    released weights. A run stopped after epoch 0 and resumed continues at
    step 2 with the uninterrupted run's batches, noise and loss."""
    scene = str(tmp_path / "scene")
    make_synthetic_scene(scene, num_views=4, height=32, width=40, texture_scale=6.0)
    full = run_training(_config(scene, str(tmp_path / "full"), epochs=2))
    assert [r["step"] for r in full] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in full)
    for name in ("params_000000.ckpt.pt", "params_000001.ckpt.pt", "module_000001.pt",
                 "metrics.jsonl", "config.json"):
        assert os.path.isfile(tmp_path / "full" / name), name
    with open(tmp_path / "full" / "metrics.jsonl") as f:
        modes = [json.loads(line)["mode"] for line in f]
    assert modes.count("train") == 4 and modes.count("full_test") == 2

    part = str(tmp_path / "part")
    first = run_training(_config(scene, part, epochs=1))
    assert [r["loss"] for r in first] == [r["loss"] for r in full[:2]]
    cfg = _config(scene, part, epochs=2, resume=True)
    cfg.train.checkpoint_path = ""  # resume from the latest in the output folder
    resumed = run_training(cfg)
    assert [r["step"] for r in resumed] == [2, 3]
    np.testing.assert_allclose([r["loss"] for r in resumed], [r["loss"] for r in full[2:]],
                               rtol=1e-5)
    assert find_latest_checkpoint(part).endswith("params_000001.ckpt.pt")
    # the state after the resumed epoch: parameters (updated with the
    # restored Adam moments and step count), running statistics, Adam state
    want = torch.load(tmp_path / "full" / "params_000001.ckpt.pt", weights_only=True)
    got = torch.load(os.path.join(part, "params_000001.ckpt.pt"), weights_only=True)
    assert got["step"] == want["step"] == 4 and got["epoch"] == want["epoch"] == 1
    for name, w in want["model"].items():
        np.testing.assert_allclose(got["model"][name].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    for idx, w in want["optimizer"]["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(got["optimizer"]["state"][idx][key].numpy(),
                                       w[key].numpy(), rtol=1e-5, atol=1e-12,
                                       err_msg=f"{idx} {key}")
