"""CasMVSNet on the port (`models/casmvsnet.py`, K8 `ops/variance_volume.py`)
against the plain reference `pmnbench/reference_casmvsnet.py`, on the CPU at
1 + 2 views and 128x160 with the reference's seeded random weights.

- the forward: depth, confidence and each stage's probabilities in f32 to
  rounding (cuDNN-free CPU convolutions in two memory layouts), and in bf16
  within what bf16 payloads move a depth (stated below);
- K8's plain version against the reference's per-view `homo_warping`, with
  samples off the source image;
- K9's plain version (the head) against `nn.Conv3d`, and its device
  symbol in the benchmark's `convolutions` group;
- the 3D blocks against `nn.Conv3d`, `nn.ConvTranspose3d`, `nn.BatchNorm3d`
  (K10, `ops.conv3d_block`, in `tests/test_torch_conv3d_block.py`);
- `DepthEstimator`, `build_model`, `load_weights` (both architectures), the
  `casmvsnet` command, the spans, the seeded state's sharpness and the
  shape check.

Marked `cuda` (skipped without a card): K8's kernel against its plain
version; K9's kernel against `F.conv3d` in f32 at the cell's stage shapes
and two ragged ones; the bf16 and f32 models on the card, their launches
(K10 30 a map), their `head_voxels` and `fused_blocks`. On a machine with a
GPU:
    python -m pytest tests/test_torch_casmvsnet.py -q -m cuda --noconftest
This file imports no JAX.
"""

import filecmp
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn as nn

from patchmatchnet_torch import cli
from patchmatchnet_torch.config import Config, ModelConfig
from patchmatchnet_torch.data import BatchLoader, MVSDataset
from patchmatchnet_torch.infer import DepthEstimator, save_depth_maps
from patchmatchnet_torch.models.casmvsnet import CasMVSNet, CostRegNet
from patchmatchnet_torch.models.layers import Conv3dBnReLU, Deconv3dBnReLU
from patchmatchnet_torch.ops import cuda_build
from patchmatchnet_torch.ops.prob_conv3d import (
    KERNEL,
    prob_conv3d,
    prob_conv3d_reference,
    uses_kernel,
)
from patchmatchnet_torch.ops.variance_volume import variance_volume, variance_volume_reference
from patchmatchnet_torch.ops.warp import warp_proj_coeffs
from patchmatchnet_torch.train.driver import build_model, load_weights
from patchmatchnet_torch.utils.profiling import reset_spans, span_summary, trace_spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from pmnbench import devtrace  # noqa: E402
from pmnbench import reference_casmvsnet as reference  # noqa: E402
from pmnbench import scenes  # noqa: E402

SEED = 3
H, W = 128, 160
TRAFFIC = {"views": 3, "height": H, "width": W, "depth_range": [425.0, 935.0],
           "baseline_deg": [6.0, 14.0], "focal": 1.8, "texture_period_px": [3.0, 48.0],
           "texture_exponent": 1.0}
NAMES = ("images", "intrinsics", "extrinsics", "depth_min", "depth_max")
RANGE = 510.0  # depth_max - depth_min
# bf16 payloads against the f32 reference, as a share of the depth range:
# the median pixel moves by under 2e-3 and the 90th percentile by under 6e-3
# (a stage-3 plane is 5.2e-3); the bf16 reference moves them alike
BF16_MEDIAN, BF16_P90 = 2e-3, 6e-3


@pytest.fixture(scope="module")
def state():
    return reference.seeded_state(SEED)


@pytest.fixture(scope="module")
def inputs():
    scene = scenes.make_scenes(torch.Generator().manual_seed(SEED + 100), 1, TRAFFIC)
    return [scene[k] for k in NAMES]


@pytest.fixture(scope="module")
def ref_out(state, inputs):
    return reference.CasMVSNetReference(state).forward(*inputs)


def _model(state, dtype=None):
    model = CasMVSNet(compute_dtype=dtype)
    model.load_state_dict(state)
    return model


def test_f32_forward_matches_reference(state, inputs, ref_out):
    with torch.no_grad():
        depth, conf, stages = _model(state)(*inputs)
    ref_depth, ref_conf, ref_stages = ref_out
    assert depth.shape == conf.shape == (1, H, W)
    torch.testing.assert_close(depth, ref_depth, atol=0.02, rtol=0)  # mm, of 510
    for s in (1, 2, 3):
        assert stages[s]["prob"].shape == ref_stages[s]["prob"].shape
        torch.testing.assert_close(stages[s]["prob"], ref_stages[s]["prob"], atol=2e-3, rtol=0)
        torch.testing.assert_close(stages[s]["depth"], ref_stages[s]["depth"], atol=0.02, rtol=0)
    # the confidence's plane index is truncated: a pixel whose index lies at
    # an integer may take the next window of four planes
    off = (conf - ref_conf).abs() > 1e-3
    assert off.float().mean() <= 1e-3


def test_bf16_forward_within_bf16_of_reference(state, inputs, ref_out):
    with torch.no_grad():
        depth, conf, stages = _model(state, torch.bfloat16)(*inputs)
        witness, _, _ = reference.CasMVSNetReference(state, "bf16").forward(*inputs)
    assert depth.dtype == conf.dtype == torch.float32
    assert stages[1]["prob"].dtype == torch.float32
    for moved in (depth, witness):
        gap = (moved - ref_out[0]).abs().flatten() / RANGE
        assert float(gap.median()) < BF16_MEDIAN
        assert float(torch.quantile(gap, 0.9)) < BF16_P90


def test_plain_volume_matches_reference_warping():
    """K8's plain version against the reference's `homo_warping` of each
    source view and its variance, with hypotheses near enough that samples
    leave the source image."""
    gen = torch.Generator().manual_seed(0)
    b, v, d, h, w, c = 2, 2, 5, 12, 16, 8
    f = 1.8 * w
    k = torch.tensor([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]])
    proj = torch.eye(4).repeat(b, v + 1, 1, 1)
    proj[:, 1:, 0, 3] = torch.tensor([[-40.0, 25.0], [30.0, -60.0]])
    proj[:, 2, 1, 3] = 15.0
    proj[:, :, :3, :4] = k @ proj[:, :, :3, :4]
    depth = 300.0 + 600.0 * torch.rand((b, d, h, w), generator=gen)
    depth[:, 0] = 20.0  # far off the source images
    feats = torch.randn((b, v + 1, h, w, c), generator=gen)
    mats = warp_proj_coeffs(proj[:, 1:], proj[:, :1])
    out = variance_volume_reference(feats[:, 0].contiguous(), feats[:, 1:].contiguous(), mats,
                                    depth)
    ref = feats[:, 0].permute(0, 3, 1, 2)[:, :, None].repeat(1, 1, d, 1, 1)
    total, squares = ref, ref ** 2
    for s in range(1, v + 1):
        warped = reference.CasMVSNetReference.homo_warping(
            feats[:, s].permute(0, 3, 1, 2), proj[:, s], proj[:, 0], depth)
        total, squares = total + warped, squares + warped ** 2
    expected = (squares / (v + 1) - (total / (v + 1)) ** 2).permute(0, 2, 3, 4, 1)
    assert out.shape == (b, d, h, w, c)
    torch.testing.assert_close(out, expected, atol=1e-4, rtol=1e-4)
    # at the near plane every source sample is off its image: only the
    # reference view is seen, so the variance is that of {f_ref, 0, 0}
    only_ref = feats[:, 0] ** 2 / (v + 1) - (feats[:, 0] / (v + 1)) ** 2
    torch.testing.assert_close(out[:, 0], only_ref, atol=1e-5, rtol=1e-5)


def test_variance_volume_refuses_gradients_and_keeps_dtype():
    ref = torch.randn((1, 4, 6, 8), requires_grad=True)
    src = torch.randn((1, 1, 4, 6, 8))
    mats = warp_proj_coeffs(torch.eye(4)[None, None], torch.eye(4)[None, None])
    depth = torch.full((1, 3, 4, 6), 5.0)
    with pytest.raises(ValueError, match="no backward"):
        variance_volume(ref, src, mats, depth)
    with torch.no_grad():
        out = variance_volume(ref.bfloat16(), src.bfloat16(), mats, depth)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 3, 4, 6, 8)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_3d_blocks_match_torch_modules(dtype):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 6, 8, 10, 12), generator=gen).to(memory_format=torch.channels_last_3d)
    for ours, conv in ((Conv3dBnReLU(6, 5, stride=2, dtype=dtype),
                        nn.Conv3d(6, 5, 3, stride=2, padding=1, bias=False)),
                       (Deconv3dBnReLU(6, 5, dtype=dtype),
                        nn.ConvTranspose3d(6, 5, 3, stride=2, padding=1, output_padding=1,
                                           bias=False))):
        bn = nn.BatchNorm3d(5).eval()
        with torch.no_grad():
            for p in (bn.weight, bn.bias, bn.running_mean):
                p.copy_(torch.randn(5, generator=gen))
            bn.running_var.copy_(torch.rand(5, generator=gen) + 0.5)
        ours.conv.weight.data.copy_(conv.weight.data)
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(ours.bn, name).data.copy_(getattr(bn, name).data)
        ours.eval()
        with torch.no_grad():
            got = ours(x)
            want = torch.relu(bn(conv(x)))
        assert got.dtype == (dtype or torch.float32)
        assert got.is_contiguous(memory_format=torch.channels_last_3d)
        tol = 1e-5 if dtype is None else 4e-2
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


def test_cost_regnet_halves_three_times_and_returns_f32_logits():
    net = CostRegNet(16, dtype=torch.bfloat16).eval()
    x = torch.randn((1, 16, 8, 8, 16)).to(memory_format=torch.channels_last_3d)
    with torch.no_grad():
        logits = net(x)
    assert logits.shape == (1, 8, 8, 16) and logits.dtype == torch.float32


@pytest.mark.parametrize("shape", [(96, 112), (80, 96), (100, 128)])
def test_shapes_must_be_multiples_of_32(state, shape):
    h, w = shape
    images = torch.rand((1, 3, h, w, 3))
    k = torch.eye(3).expand(1, 3, 3, 3)
    with pytest.raises(ValueError, match="multiples of 32"):
        _model(state)(images, k, torch.eye(4).expand(1, 3, 4, 4), torch.tensor([1.0]),
                      torch.tensor([2.0]))


def test_seeded_state_is_sharp_and_repeats(state):
    """The reference's seeded state loads into the program under its names,
    draws the same again, and on its probe scene no stage's softmax is
    flat: D x the median largest probability is at least 5."""
    CasMVSNet().load_state_dict(state, strict=True)
    again = reference.seeded_state(SEED)
    assert list(again) == list(state) and all(torch.equal(again[k], state[k]) for k in state)
    with torch.no_grad():
        stages = reference.CasMVSNetReference(state).forward(*reference.probe_scene(SEED))[2]
    for s in (1, 2, 3):
        prob = stages[s]["prob"]
        assert float(prob.amax(1).median()) * prob.shape[1] >= 5.0, s


def test_released_state_dict_loads():
    """cascade-stereo's names, BatchNorm's `num_batches_tracked` included."""
    model = CasMVSNet()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    for key in list(state):
        if key.endswith("bn.running_var"):
            state[key.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    model.load_state_dict(state)
    names = set(model.state_dict())
    assert {"feature.conv0.0.conv.weight", "feature.out1.weight", "feature.inner1.bias",
            "cost_regularization.0.conv0.conv.weight", "cost_regularization.2.conv11.bn.bias",
            "cost_regularization.1.prob.weight"} <= names
    assert names == {k for k, _ in reference.parameter_shapes()}


def _batch(inputs, orig=None):
    arrays = {k: t.numpy() for k, t in zip(NAMES, inputs)}
    arrays["filename"] = ["00000000/{}{}"]
    if orig is not None:
        arrays["orig_height"], arrays["orig_width"] = np.array([orig[0]]), np.array([orig[1]])
    return arrays


def test_depth_estimator_draws_no_noise(state, inputs):
    model = _model(state, torch.bfloat16)
    estimator = DepthEstimator(model, "cpu")
    assert model.noise_shape(1, H, W) is None
    gen = torch.Generator().manual_seed(11)
    before = gen.get_state()
    depth, conf = estimator(_batch(inputs, orig=(2 * H, 2 * W)), gen)
    assert torch.equal(gen.get_state(), before)
    assert depth.shape == conf.shape == (1, 2 * H, 2 * W)
    with torch.no_grad():
        direct, _, _ = model(inputs[0].bfloat16(), *inputs[1:])
    same, _ = estimator(_batch(inputs), gen)
    np.testing.assert_array_equal(same, direct.numpy())


def test_build_model_dispatches_on_the_architecture():
    cfg = Config(architecture="casmvsnet")
    model = build_model(cfg, inference=True)
    assert isinstance(model, CasMVSNet) and model.compute_dtype == torch.bfloat16
    cfg = Config(model=ModelConfig(precision="f32"), architecture="casmvsnet")
    assert build_model(cfg, inference=True).compute_dtype is None
    with pytest.raises(ValueError, match="inference only"):
        build_model(Config(architecture="casmvsnet"))
    with pytest.raises(ValueError, match="architecture"):
        build_model(Config(architecture="mvsnet"), inference=True)
    assert type(build_model(Config(), inference=True)).__name__ == "PatchmatchNet"
    assert Config.from_json(cfg.to_json()) == cfg


@pytest.mark.parametrize("architecture", ["patchmatchnet", "casmvsnet"])
def test_load_weights_reads_a_saved_state(architecture, tmp_path):
    """A `torch.save` state dict, plain and under "model", read back through
    the architecture's reader, loads into a new model of it."""
    cfg = Config(architecture=architecture)
    state = build_model(cfg, inference=True).state_dict()
    for i, saved in enumerate((state, {"model": state})):
        path = str(tmp_path / f"state_{i}.pt")
        torch.save(saved, path)
        read = load_weights(cfg, path)
        assert list(read) == list(state)
        assert all(torch.equal(read[k], v) for k, v in state.items())
        build_model(cfg, inference=True).load_state_dict(read, strict=True)
    with pytest.raises(ValueError, match="patchmatchnet, casmvsnet"):
        load_weights(Config(architecture="mvsnet"), path)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from scene_utils import make_synthetic_scene

    root = str(tmp_path_factory.mktemp("cas_scene"))
    make_synthetic_scene(root, num_views=3, height=64, width=96, texture_scale=6.0)
    return root


def test_command_line_writes_the_librarys_maps(scene, state, tmp_path):
    """`casmvsnet` from a state-dict file (plain, or under "model" as
    cascade-stereo saves it) writes the maps `save_depth_maps` writes with
    the same state."""
    model = CasMVSNet(compute_dtype=torch.bfloat16)
    model.load_state_dict(state)
    lib = str(tmp_path / "library")
    written = save_depth_maps(DepthEstimator(model, "cpu"),
                              BatchLoader(MVSDataset(scene, 2, ".png"), 1), lib)
    assert written == 3
    maps = [os.path.join(folder, f"{v:08d}.pfm") for folder in ("depth_est", "confidence")
            for v in range(3)]
    for saved in (state, {"model": state}):
        path = str(tmp_path / "state.pt")
        torch.save(saved, path)
        out = str(tmp_path / f"cli_{len(saved)}")
        cli.main(["casmvsnet", "--input_folder", scene, "--output_folder", out, "--device",
                  "cpu", "--image_extension", ".png", "--num_views", "2",
                  "--checkpoint_path", path])
        for name in maps:
            assert filecmp.cmp(os.path.join(out, name), os.path.join(lib, name),
                               shallow=False)


def test_command_line_needs_a_state(scene, capsys):
    with pytest.raises(SystemExit):
        cli.main(["casmvsnet", "--input_folder", scene, "--device", "cpu"])
    assert "--checkpoint_path" in capsys.readouterr().err


def test_spans_and_counters(state, inputs):
    model = _model(state, torch.bfloat16)
    previous = trace_spans(True)
    reset_spans()
    try:
        with torch.no_grad():
            _, _, stages = model(inputs[0], *inputs[1:])
        spans = span_summary()
    finally:
        trace_spans(previous)
        reset_spans()
    names = ["pmn.cas.features"] + [f"pmn.cas.stage{s}{part}" for s in (1, 2, 3)
                                    for part in ("", ".volume", ".regularize", ".regress")]
    assert set(names) <= set(spans)
    for s, (d, c) in zip((1, 2, 3), zip((48, 32, 8), (32, 16, 8))):
        scale = (4, 2, 1)[s - 1]
        voxels = d * (H // scale) * (W // scale)
        numbers = spans[f"pmn.cas.stage{s}.volume"].numbers
        assert numbers == {"voxels": voxels, "bytes": voxels * c * 2}
        # the CPU runs the head's and the blocks' plain versions: no voxel
        # of K9, no block through K10
        assert spans[f"pmn.cas.stage{s}.regularize"].numbers == {"head_voxels": 0,
                                                                 "fused_blocks": 0}
        assert stages[s]["prob"].shape == (1, d, H // scale, W // scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_plain_version_is_the_published_conv(dtype):
    """K9's plain version: `nn.Conv3d(8, 1, 3, padding=1, bias=False)` in
    the input's dtype, its channel widened to f32; no backward."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 8, 5, 7, 9), generator=gen).to(dtype)
    x = x.to(memory_format=torch.channels_last_3d)
    conv = nn.Conv3d(8, 1, 3, padding=1, bias=False)
    with torch.no_grad():
        got = prob_conv3d(x, conv.weight)
        want = conv.to(dtype)(x)[:, 0].float()
    assert not uses_kernel(x)
    assert got.dtype == torch.float32 and got.shape == (2, 5, 7, 9)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="no backward"):
        prob_conv3d(x, nn.Conv3d(8, 1, 3, padding=1, bias=False).weight)


def test_cost_regnet_ends_in_the_head(state):
    """The CostRegNet's logits are K9 (its plain version here) over what
    the last block leaves, its skip (conv0's output) added in the block."""
    net = CostRegNet(8).eval()
    net.load_state_dict({k[len("cost_regularization.2."):]: v for k, v in state.items()
                         if k.startswith("cost_regularization.2.")})
    x = torch.randn((1, 8, 8, 16, 16)).to(memory_format=torch.channels_last_3d)
    seen = {}
    net.conv11.register_forward_hook(lambda m, i, o: seen.setdefault("conv11", (i, o)) and None)
    net.conv0.register_forward_hook(lambda m, i, o: seen.setdefault("conv0", o))
    with torch.no_grad():
        logits = net(x)
        (block_in, skip), head_in = seen["conv11"]
        assert skip is seen["conv0"]
        torch.testing.assert_close(head_in, seen["conv0"] + net.conv11(block_in),
                                   atol=0, rtol=0)
        torch.testing.assert_close(logits, prob_conv3d_reference(head_in, net.prob.weight),
                                   atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["__nv_bfloat16", "float"])
def test_head_kernel_symbol_is_a_convolution(dtype):
    """K9's device symbol, as the wrapper and `csrc/prob_conv3d.cu` name it,
    falls in the benchmark's `convolutions` group (`pmnbench/kernel_groups/`),
    where the roofline counts the head's bound."""
    with open(os.path.join(REPO, "patchmatchnet_torch", "csrc", "prob_conv3d.cu")) as f:
        source = f.read()
    namespace, function = KERNEL.split("::")
    assert f"namespace {namespace} {{" in source
    assert f"    {function}(const T* __restrict__ x" in source
    traced = (f"void {KERNEL}<{dtype}, 2>({dtype} const*, float const*, float*, int, int, "
              "int, int)")
    assert devtrace.group_of(traced, devtrace.kernel_groups()) == "convolutions"


def test_reference_imports_torch_alone():
    with open(os.path.join(REPO, "pmnbench", "reference_casmvsnet.py")) as f:
        lines = f.read().splitlines()
    imports = {ln.split()[1].split(".")[0] for ln in lines if ln.startswith(("import ", "from "))}
    assert imports <= {"__future__", "contextlib", "math", "typing", "torch"}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [8, 16, 32])
def test_kernel_matches_plain_version(device, dtype, channels):
    gen = torch.Generator(device=device).manual_seed(channels)
    b, v, d, h, w = 2, 4, 6, 24, 40
    f = 1.8 * w
    k = torch.tensor([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]], device=device)
    proj = torch.eye(4, device=device).repeat(b, v + 1, 1, 1)
    proj[:, 1:, 0, 3] = torch.linspace(-50.0, 50.0, v, device=device)
    proj[:, 1:, 1, 3] = torch.linspace(30.0, -30.0, v, device=device)
    proj[:, :, :3, :4] = k @ proj[:, :, :3, :4]
    mats = warp_proj_coeffs(proj[:, 1:], proj[:, :1])
    depth = 300.0 + 600.0 * torch.rand((b, d, h, w), generator=gen, device=device)
    depth[:, 0] = 20.0  # off the source images
    depth[:, 1, :2] = -5.0  # behind the source cameras
    feats = torch.randn((b, v + 1, h, w, channels), generator=gen, device=device).to(dtype)
    ref, src = feats[:, 0].contiguous(), feats[:, 1:].contiguous()
    before = cuda_build.launch_counts().get("variance_volume", 0)
    with torch.no_grad():
        out = variance_volume(ref, src, mats, depth)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts()["variance_volume"] == before + 1
    plain = variance_volume_reference(ref, src, mats, depth)
    assert out.dtype == dtype and out.shape == (b, d, h, w, channels)
    # f32: the warp and the sums to rounding; bf16: the one rounding of the
    # result, one bf16 step either way
    tol = 1e-3 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), plain.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 48, 216, 288), (1, 32, 432, 576), (1, 8, 864, 1152),
                                   (2, 11, 45, 83), (1, 9, 19, 33)],
                         ids=["stage1", "stage2", "stage3", "b2-ragged", "ragged"])
def test_head_kernel_matches_conv3d(device, dtype, shape):
    """K9 against `F.conv3d` in f32 (TF32 off) on the same inputs: the
    cell's three stage shapes, a batch of 2 whose D crosses a block's chunk
    of planes and whose H and W are multiples of no tile, and one more
    ragged shape. One launch a call."""
    b, d, h, w = shape
    gen = torch.Generator(device=device).manual_seed(d * h)
    x = torch.randn((b, 8, d, h, w), generator=gen, device=device).to(dtype)
    x = x.to(memory_format=torch.channels_last_3d)
    weight = 0.1 * torch.randn((1, 8, 3, 3, 3), generator=gen, device=device)
    before = cuda_build.launch_counts().get("prob_conv3d", 0)
    with torch.no_grad():
        out = prob_conv3d(x, weight)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts()["prob_conv3d"] == before + 1
    assert out.dtype == torch.float32 and out.shape == (b, d, h, w) and out.is_contiguous()
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = torch.nn.functional.conv3d(x.float(), weight, None, 1, 1)[:, 0]
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    # the same 216 f32 products a voxel summed in another order (outputs
    # ~1.5, each sum's rounding ~1e-6)
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_head_kernel_refuses_other_layouts(device):
    weight = torch.randn((1, 8, 3, 3, 3), device=device)
    x = torch.randn((1, 8, 4, 6, 8), device=device)  # contiguous, not channels last
    with pytest.raises(ValueError, match="channels_last_3d"):
        prob_conv3d(x, weight)
    with pytest.raises(ValueError, match=r"\[B, 8, D, H, W\]"):
        prob_conv3d(torch.randn((1, 4, 4, 6, 8), device=device), weight)
    with pytest.raises(TypeError, match="dtype"):
        prob_conv3d(x.to(memory_format=torch.channels_last_3d), weight.bfloat16())


@pytest.mark.cuda
def test_model_on_the_card_runs_k8_and_k9(device, state, inputs, ref_out):
    """The bf16 model on the card: K8 and K9 once a stage, K10 for each of
    a stage's 10 U-Net blocks, each stage's `head_voxels` D h w and
    `fused_blocks` 10; its depth within bf16 of the f32 reference, as on
    the CPU."""
    model = _model(state, torch.bfloat16).to(device)
    cuda_build.reset_launch_counts()
    previous = trace_spans(True)
    reset_spans()
    try:
        with torch.no_grad():
            depth, _, _ = model(*(t.to(device) for t in inputs))
        torch.cuda.synchronize()
        spans = span_summary()
    finally:
        trace_spans(previous)
        reset_spans()
    assert cuda_build.launch_counts() == {"variance_volume": 3, "prob_conv3d": 3,
                                          "conv3d_block": 30}
    for s, d in zip((1, 2, 3), (48, 32, 8)):
        scale = (4, 2, 1)[s - 1]
        numbers = spans[f"pmn.cas.stage{s}.regularize"].numbers
        assert numbers["head_voxels"] == d * (H // scale) * (W // scale)
        assert numbers["fused_blocks"] == 10
    gap = (depth.cpu() - ref_out[0]).abs().flatten() / RANGE
    assert float(gap.median()) < BF16_MEDIAN
    assert float(torch.quantile(gap, 0.9)) < BF16_P90


@pytest.mark.cuda
def test_f32_model_on_the_card_runs_k10_for_every_block(device, state, inputs, ref_out):
    """The f32 model (TF32 off) on the card: K8 and K9 once a stage and K10,
    on its f32 payloads, for each of a stage's 10 U-Net blocks; its depth
    within the CPU's f32 tolerances of the f32 reference."""
    model = _model(state).to(device)
    cuda_build.reset_launch_counts()
    previous = trace_spans(True)
    reset_spans()
    try:
        with torch.no_grad():
            depth, _, stages = model(*(t.to(device) for t in inputs))
        torch.cuda.synchronize()
        spans = span_summary()
    finally:
        trace_spans(previous)
        reset_spans()
    assert cuda_build.launch_counts() == {"variance_volume": 3, "prob_conv3d": 3,
                                          "conv3d_block": 30}
    for s in (1, 2, 3):
        assert spans[f"pmn.cas.stage{s}.regularize"].numbers["fused_blocks"] == 10
    ref_depth, _, ref_stages = ref_out
    assert depth.dtype == torch.float32
    torch.testing.assert_close(depth.cpu(), ref_depth, atol=0.02, rtol=0)  # mm, of 510
    for s in (1, 2, 3):
        torch.testing.assert_close(stages[s]["prob"].cpu(), ref_stages[s]["prob"], atol=2e-3,
                                   rtol=0)
