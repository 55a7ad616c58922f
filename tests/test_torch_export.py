"""Export of the port's inference forward and `ModuleEstimator` on the CPU
(reference: tests/test_export.py, `compat/export.py` and
`infer/depth.py` `ModuleEstimator`).

- Each kernel is the custom op `torch.ops.pmn.*`, whose CPU implementation
  is the plain version to the bit; K1's and K3's gradients through the op
  equal autograd through the plain versions to the bit.
- The export round trip at 32x40, N=2 (tests/test_export.py's geometry):
  the exported f32 program holds the kernels as `pmn::` nodes (K1 once per
  source view, K6 on the 4 later evaluations, K2 5, K3 3), equals the
  port's eager forward to the bit, and meets the JAX forward
  (`model.apply(..., init_noise=noise)` with params_000007 carried across
  by `compat.weights`) at tests/test_model_golden.py's final-depth and
  confidence bounds. A bf16 export equals bf16 eager to the bit.
- `ModuleEstimator` refuses a batch of another geometry and draws the
  noise `DepthEstimator` draws at one seed; on a synthetic scene, `export`
  then `eval --input_type module --device cpu` writes the maps `eval
  --input_type params --precision f32` writes, byte for byte;
  `save_depth_maps` takes (…, file_format, seed) as the JAX one does.
"""

import filecmp
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchmatchnet_tpu.compat import load_variables
from patchmatchnet_tpu.models import PatchmatchNet as JaxPatchmatchNet
from patchmatchnet_torch import cli
from patchmatchnet_torch.compat import (
    export_inference,
    kernel_nodes,
    load_exported,
    read_flax_msgpack,
    state_dict_from_jax,
)
from patchmatchnet_torch.data import BatchLoader, MVSDataset, make_synthetic_scene
from patchmatchnet_torch.infer import ModuleEstimator
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.ops import (
    eval_grid_score_reference,
    neighbor_group_corr_reference,
    warp_group_corr_reference,
    warp_group_corr_views_reference,
)
from patchmatchnet_torch.ops.warp import warp_proj_coeffs

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "params_000007.msgpack")
B, N, H, W = 1, 2, 32, 40


def _kernel_inputs(dtype):
    """Stage-1-like inputs (C 16, G 4, D 3, Ke 9) made with numpy."""
    rng = np.random.default_rng(0)
    b, v, h, w, c, d, ke = 1, 2, 8, 10, 16, 3, 9
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    src = t(rng.standard_normal((b, v, h, w, c))).to(dtype)
    ref = t(rng.standard_normal((b, h, w, c))).to(dtype)
    proj = np.tile(np.eye(4, dtype=np.float32), (b, v + 1, 1, 1))
    proj[:, :, :3, :3] = [[12.0, 0, 5], [0, 12.0, 4], [0, 0, 1]]
    proj[:, 1:, 0, 3] = [[0.3, -0.4]]
    mats = warp_proj_coeffs(t(proj[:, 1:]), t(proj[:, :1])).contiguous()
    depth = t(rng.uniform(2.0, 8.0, (b, d, h, w)))
    grid = (t(rng.uniform(-1.1, 1.1, (b, ke, h, w))), t(rng.uniform(-1.1, 1.1, (b, ke, h, w))))
    vw = t(rng.random((b, v, h, w)))
    x_norm = t(rng.random((b, h, w, d)))
    cost = t(rng.standard_normal((b, h, w, d))).to(dtype)
    fw = t(rng.random((b, ke, h, w)))
    return src, ref, mats, depth, grid, vw, x_norm, cost, fw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_equal_plain_versions_on_cpu(dtype):
    src, ref, mats, depth, grid, vw, x_norm, cost, fw = _kernel_inputs(dtype)
    pmn = torch.ops.pmn
    assert torch.equal(pmn.warp_group_corr(src[:, 0].contiguous(), mats[:, 0], depth, ref, 4),
                       warp_group_corr_reference(src[:, 0], mats[:, 0], depth, ref, 4))
    assert torch.equal(pmn.warp_group_corr_views(src, mats, depth, ref, vw, 4),
                       warp_group_corr_views_reference(src, mats, depth, ref, vw, 4))
    assert torch.equal(pmn.neighbor_group_corr(ref, *grid, 4),
                       neighbor_group_corr_reference(ref, grid, 4))
    assert torch.equal(pmn.eval_grid_score(x_norm, cost, *grid, fw, 0.025),
                       eval_grid_score_reference(x_norm, cost, grid, fw, 0.025))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_gradients_equal_autograd_through_plain_versions(dtype):
    """K1 (to src and ref) and K3 (to the grid) through the ops, whose
    backward is K4/K5's plain version on the CPU."""
    src, ref, mats, depth, grid, *_ = _kernel_inputs(dtype)
    rng = np.random.default_rng(1)
    s = src[:, 0].contiguous()
    leaves = [s.clone().requires_grad_(True), ref.clone().requires_grad_(True)]
    plain_leaves = [s.clone().requires_grad_(True), ref.clone().requires_grad_(True)]
    out = torch.ops.pmn.warp_group_corr(leaves[0], mats[:, 0], depth, leaves[1], 4)
    want = warp_group_corr_reference(plain_leaves[0], mats[:, 0], depth, plain_leaves[1], 4)
    dout = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    for g, w in zip(torch.autograd.grad(out, leaves, dout),
                    torch.autograd.grad(want, plain_leaves, dout)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    gx, gy = (g.clone().requires_grad_(True) for g in grid)
    px, py = (g.clone().requires_grad_(True) for g in grid)
    out = torch.ops.pmn.neighbor_group_corr(ref, gx, gy, 4)
    want = neighbor_group_corr_reference(ref, (px, py), 4)
    dout = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    for g, w in zip(torch.autograd.grad(out, (gx, gy), dout),
                    torch.autograd.grad(want, (px, py), dout)):
        assert torch.equal(g, w)


def _forward_inputs():
    """tests/test_export.py's inputs, made with numpy."""
    rng = np.random.default_rng(0)
    images = rng.random((B, N, H, W, 3)).astype(np.float32)
    k = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    intr = np.broadcast_to(k, (B, N, 3, 3)).copy()
    extr = np.broadcast_to(np.eye(4, dtype=np.float32), (B, N, 4, 4)).copy()
    extr[:, 1, 0, 3] = 0.4
    dmin, dmax = np.asarray([2.0], np.float32), np.asarray([10.0], np.float32)
    noise = rng.random((B, 48, H // 8, W // 8)).astype(np.float32)
    return images, intr, extr, dmin, dmax, noise


@pytest.fixture(scope="module")
def state_dict():
    return state_dict_from_jax(read_flax_msgpack(CKPT))


@pytest.fixture(scope="module")
def f32_blob(state_dict):
    return export_inference(state_dict, B, N, H, W, device="cpu")


def _eager(state_dict, dtype, inputs):
    model = PatchmatchNet(compute_dtype=dtype)
    model.load_state_dict(state_dict, strict=True)
    with torch.inference_mode():
        depth, conf, _ = model(*[torch.from_numpy(a) for a in inputs[:5]],
                               init_noise=torch.from_numpy(inputs[5]))
    return depth, conf


def test_export_roundtrip_equals_eager_and_jax(state_dict, f32_blob):
    exported = load_exported(f32_blob)
    assert exported.precision == "f32" and exported.shape == (B, N, H, W, 3)
    assert kernel_nodes(exported.program) == {
        "warp_group_corr": N - 1, "warp_group_corr_views": 4, "eval_grid_score": 5,
        "neighbor_group_corr": 3}
    inputs = _forward_inputs()
    depth_e, conf_e = exported(*[torch.from_numpy(a) for a in inputs])
    depth_d, conf_d = _eager(state_dict, None, inputs)
    assert depth_e.shape == conf_e.shape == (B, H, W)
    assert torch.equal(depth_e, depth_d) and torch.equal(conf_e, conf_d)

    model = JaxPatchmatchNet()
    fwd = jax.jit(lambda v, *a, noise: model.apply(v, *a, train=False, init_noise=noise))
    depth_j, conf_j, _ = fwd(load_variables(CKPT), *[jnp.asarray(a) for a in inputs[:5]],
                             noise=jnp.asarray(inputs[5]))
    jax.clear_caches()
    depth_range = float(inputs[4][0] - inputs[3][0])
    np.testing.assert_allclose(depth_e.numpy(), np.asarray(depth_j), atol=2e-3 * depth_range,
                               rtol=0)
    cdiff = np.abs(conf_e.numpy() - np.asarray(conf_j))
    assert (cdiff > 5e-3).mean() < 1e-3 and np.median(cdiff) < 1e-4 and cdiff.max() < 0.25


def test_bf16_export_equals_bf16_eager(state_dict):
    blob = export_inference(state_dict, B, N, H, W,
                            model=PatchmatchNet(compute_dtype=torch.bfloat16), device="cpu")
    exported = load_exported(blob, "cpu")
    assert exported.precision == "bf16"
    inputs = _forward_inputs()
    depth_e, conf_e = exported(*[torch.from_numpy(a) for a in inputs])
    depth_d, conf_d = _eager(state_dict, torch.bfloat16, inputs)
    assert torch.equal(depth_e, depth_d) and torch.equal(conf_e, conf_d)


def test_load_refuses_other_bytes(tmp_path):
    path = tmp_path / "weights.pt"
    torch.save({"w": torch.zeros(2)}, path)
    with pytest.raises(Exception):
        load_exported(path.read_bytes())


def test_module_estimator_refuses_another_geometry(f32_blob):
    estimator = ModuleEstimator(f32_blob, "cpu")
    assert estimator.bucket_multiple == 0
    images, intr, extr, dmin, dmax, _ = _forward_inputs()
    batch = {"images": np.concatenate([images, images[:, :1]], axis=1),
             "intrinsics": np.concatenate([intr, intr[:, :1]], axis=1),
             "extrinsics": np.concatenate([extr, extr[:, :1]], axis=1),
             "depth_min": dmin, "depth_max": dmax}
    with pytest.raises(ValueError, match=r"expects images \(1, 2, 32, 40, 3\), got "
                                         r"\(1, 3, 32, 40, 3\); re-export"):
        estimator(batch, torch.Generator().manual_seed(0))


def test_cli_export_then_eval_module_equals_params(tmp_path):
    scene = str(tmp_path / "scene")
    make_synthetic_scene(scene, num_views=3, height=64, width=80, texture_scale=6.0)
    blob = str(tmp_path / "model.pt2")
    cli.main(["export", "--checkpoint_path", CKPT, "--output", blob, "--num_views", "3",
              "--height", "64", "--width", "80", "--device", "cpu"])
    common = ["--input_folder", scene, "--num_views", "2", "--image_extension", ".png",
              "--output_type", "depth", "--device", "cpu", "--seed", "4"]
    module_out, params_out = str(tmp_path / "module"), str(tmp_path / "params")
    cli.main(["eval", *common, "--output_folder", module_out, "--input_type", "module",
              "--checkpoint_path", blob])
    cli.main(["eval", *common, "--output_folder", params_out, "--checkpoint_path", CKPT,
              "--precision", "f32"])
    for folder in ("depth_est", "confidence"):
        for v in range(3):
            name = os.path.join(folder, f"{v:08d}.pfm")
            assert filecmp.cmp(os.path.join(module_out, name), os.path.join(params_out, name),
                               shallow=False), name
    # a scene of another size is refused before any map is written
    other = str(tmp_path / "other")
    make_synthetic_scene(other, num_views=3, height=72, width=80, texture_scale=6.0)
    with pytest.raises(ValueError, match="re-export"):
        cli.main(["eval", *common[2:], "--input_folder", other, "--output_folder",
                  str(tmp_path / "refused"), "--input_type", "module", "--checkpoint_path",
                  blob])
    assert not os.path.exists(tmp_path / "refused" / "depth_est")


def test_module_estimator_draws_the_noise_of_depth_estimator(f32_blob, state_dict):
    """One seed gives both estimators the same stage-3 noise: the module's
    maps equal the f32 DepthEstimator's to the bit."""
    from patchmatchnet_torch.infer import DepthEstimator

    images, intr, extr, dmin, dmax, _ = _forward_inputs()
    batch = {"images": images, "intrinsics": intr, "extrinsics": extr,
             "depth_min": dmin, "depth_max": dmax}
    model = PatchmatchNet()
    model.load_state_dict(state_dict, strict=True)
    got = ModuleEstimator(f32_blob, "cpu")(batch, torch.Generator().manual_seed(9))
    want = DepthEstimator(model, "cpu")(batch, torch.Generator().manual_seed(9))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


class _Spy:
    """An artifact's stand-in that records the dtype of the images it is
    handed and runs the artifact."""

    def __init__(self, exported):
        self.exported, self.shape, self.dtypes = exported, exported.shape, []

    def __call__(self, images, *args):
        self.dtypes.append(images.dtype)
        return self.exported(images, *args)


def test_module_estimator_hands_its_artifact_f32(f32_blob):
    """The artifact gets the f32 images it was exported with, through the
    estimator's staging buffer, and returns the maps of a direct call."""
    images, intr, extr, dmin, dmax, _ = _forward_inputs()
    batch = {"images": images, "intrinsics": intr, "extrinsics": extr,
             "depth_min": dmin, "depth_max": dmax}
    estimator = ModuleEstimator(f32_blob, "cpu")
    estimator.exported = spy = _Spy(estimator.exported)
    got = estimator(batch, torch.Generator().manual_seed(2))
    assert estimator.staging_dtype == torch.float32 and spy.dtypes == [torch.float32]
    assert estimator.images_buffer.dtype == torch.float32
    noise = torch.rand((B, 48, H // 8, W // 8), generator=torch.Generator().manual_seed(2))
    want = spy.exported(*(torch.from_numpy(x) for x in (images, intr, extr, dmin, dmax)),
                        noise)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_save_depth_maps_takes_file_format_then_seed(f32_blob, tmp_path):
    """The JAX order (…, file_format, seed): a positional call writes the
    maps of the keyword call, and ModuleEstimator serves save_depth_maps."""
    from patchmatchnet_tpu.infer.depth import save_depth_maps as jax_save_depth_maps
    from patchmatchnet_torch.infer import save_depth_maps

    names = list(inspect.signature(save_depth_maps).parameters)
    jax_names = list(inspect.signature(jax_save_depth_maps).parameters)
    assert names[:5] == jax_names[:5] == ["estimator", "loader", "output_folder",
                                         "file_format", "seed"]
    scene = str(tmp_path / "scene")
    make_synthetic_scene(scene, num_views=N, height=H, width=W, texture_scale=6.0)
    estimator = ModuleEstimator(f32_blob, "cpu")
    loader = BatchLoader(MVSDataset(scene, N - 1, ".png"), 1, num_threads=1)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert save_depth_maps(estimator, loader, a, ".bin", 5) == N
    assert save_depth_maps(estimator, loader, b, file_format=".bin", seed=5) == N
    for v in range(N):
        name = os.path.join("depth_est", f"{v:08d}.bin")
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False)
