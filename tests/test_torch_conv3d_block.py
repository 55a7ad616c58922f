"""K10, `ops.conv3d_block`: one block of CasMVSNet's 3D U-Nets (a 3x3x3
convolution of stride 1 or 2 or a stride-2 transposed one, the eval
BatchNorm, the ReLU and the decoder's skip) in one pass.

On the CPU (the plain version):
- it equals the composition the blocks ran before K10, `models.layers.conv3d`,
  the eval `BatchNorm`, ReLU, then the skip added as the published code adds
  it (`conv4 + conv7(x)`), to the bit in f32 and bf16, for each kind of block
  at the channel pairs of CostRegNet (stride 1: 32/16/8 -> 8, 16 -> 16,
  32 -> 32, 64 -> 64; stride 2: 8 -> 16, 16 -> 32, 32 -> 64; transposed:
  64 -> 32, 32 -> 16, 16 -> 8, with and without a skip), through the op and
  through the block modules;
- a CostRegNet in eval mode gives the same logits as the composition with
  the three skips added outside the blocks, to the bit;
- train mode keeps the composition with batch statistics;
- the blocks the kernel takes (`block_mode`, `output_size`, the shapes
  `csrc/conv3d_block.cu` dispatches) and its two device symbols in the
  benchmark's `convolutions` group (`pmnbench/kernel_groups/`).

Marked `cuda` (skipped without a card): K10 on bf16 payloads against the
plain arithmetic in f32 on the same bf16 inputs and bf16-rounded weights,
and K10 on f32 payloads against the plain version in f32 (TF32 off), at
every block of the cell's three CostRegNets (DTU's 1152x864, D 48/32/8),
and at ragged shapes with a batch of 2; its refusals. On a machine with a
GPU:
    python -m pytest tests/test_torch_conv3d_block.py -q -m cuda --noconftest
This file imports no JAX.
"""

import os
import re
import sys

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from patchmatchnet_torch.models.casmvsnet import CostRegNet
from patchmatchnet_torch.models.layers import Conv3dBnReLU, Deconv3dBnReLU, conv3d
from patchmatchnet_torch.models.net import full_f32
from patchmatchnet_torch.ops import cuda_build
from patchmatchnet_torch.ops.conv3d_block import (
    KERNEL,
    KERNEL_F32,
    STRIDE1,
    STRIDE2,
    TRANSPOSED,
    block_mode,
    conv3d_block,
    conv3d_block_unrounded,
    conv3d_block_reference,
    output_size,
    uses_kernel,
)
from patchmatchnet_torch.ops.prob_conv3d import prob_conv3d_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from pmnbench import devtrace  # noqa: E402

# CostRegNet's blocks: (kind, Cin, Cout, skip)
BLOCKS = [(STRIDE1, 32, 8, False), (STRIDE1, 16, 8, False), (STRIDE1, 8, 8, False),
          (STRIDE2, 8, 16, False), (STRIDE1, 16, 16, False), (STRIDE2, 16, 32, False),
          (STRIDE1, 32, 32, False), (STRIDE2, 32, 64, False), (STRIDE1, 64, 64, False),
          (TRANSPOSED, 64, 32, True), (TRANSPOSED, 32, 16, True), (TRANSPOSED, 16, 8, True),
          (TRANSPOSED, 16, 8, False)]
KIND = {STRIDE1: "stride1", STRIDE2: "stride2", TRANSPOSED: "transposed"}
BLOCK_IDS = [f"{KIND[m]}-{ci}to{co}{'-skip' if s else ''}" for m, ci, co, s in BLOCKS]
DTYPES = {"f32": None, "bf16": torch.bfloat16}
SOURCE = os.path.join(REPO, "patchmatchnet_torch", "csrc", "conv3d_block.cu")


def _block(mode, cin, cout, dtype, gen, device="cpu"):
    """A block in eval mode with random weights and BatchNorm statistics."""
    if mode == TRANSPOSED:
        block = Deconv3dBnReLU(cin, cout, dtype=dtype)
    else:
        block = Conv3dBnReLU(cin, cout, stride=1 if mode == STRIDE1 else 2, dtype=dtype)
    with torch.no_grad():
        block.conv.weight.copy_(torch.randn(block.conv.weight.shape, generator=gen)
                                * (27 * cin) ** -0.5)
        block.bn.weight.copy_(0.5 + torch.rand(cout, generator=gen))
        block.bn.bias.copy_(0.3 * torch.randn(cout, generator=gen))
        block.bn.running_mean.copy_(0.2 * torch.randn(cout, generator=gen))
        block.bn.running_var.copy_(0.5 + torch.rand(cout, generator=gen))
    return block.eval().to(device)


def _inputs(mode, cin, cout, size, skip, dtype, gen, batch=1):
    d, h, w = size
    x = torch.randn((batch, cin, d, h, w), generator=gen)
    x = x.to(dtype or torch.float32).to(memory_format=torch.channels_last_3d)
    out = tuple(output_size(mode, n) for n in size)
    s = None
    if skip:
        s = torch.relu(torch.randn((batch, cout) + out, generator=gen))
        s = s.to(dtype or torch.float32).to(memory_format=torch.channels_last_3d)
    return x, s


@pytest.mark.parametrize("precision", sorted(DTYPES))
@pytest.mark.parametrize("mode,cin,cout,skip", BLOCKS, ids=BLOCK_IDS)
def test_plain_version_is_the_composition(mode, cin, cout, skip, precision):
    dtype = DTYPES[precision]
    gen = torch.Generator().manual_seed(cin * 7 + cout + mode)
    block = _block(mode, cin, cout, dtype, gen)
    x, s = _inputs(mode, cin, cout, (4, 6, 10), skip, dtype, gen)
    with torch.no_grad():
        y = F.relu(block.bn(conv3d(block.conv, x, dtype)))
        want = y if s is None else s + y  # the published conv4 + conv7(x)
        got = conv3d_block(x, block.conv, block.bn, dtype, s)
        by_module = block(x, s)
    assert not uses_kernel(x)
    assert got.dtype == (dtype or torch.float32)
    assert got.shape == (1, cout) + tuple(output_size(mode, n) for n in (4, 6, 10))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(by_module, want, atol=0, rtol=0)
    torch.testing.assert_close(conv3d_block_reference(x, block.conv, block.bn, dtype, s), want,
                               atol=0, rtol=0)


def _logits_with_skips_outside(net, x):
    """CostRegNet's forward as it ran before the skips moved into the
    decoder blocks: the published `conv4 + self.conv7(x)` and so on."""
    conv0 = net.conv0(x)
    conv2 = net.conv2(net.conv1(conv0))
    conv4 = net.conv4(net.conv3(conv2))
    y = net.conv6(net.conv5(conv4))
    y = conv4 + net.conv7(y)
    y = conv2 + net.conv9(y)
    y = conv0 + net.conv11(y)
    return prob_conv3d_reference(y, net.prob.weight)


@pytest.mark.parametrize("precision", sorted(DTYPES))
def test_cost_regnet_logits_unchanged_by_the_fused_skips(precision):
    dtype = DTYPES[precision]
    gen = torch.Generator().manual_seed(26)
    net = CostRegNet(16, dtype=dtype)
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, (Conv3dBnReLU, Deconv3dBnReLU)):
                cout = module.bn.weight.numel()
                module.conv.weight.normal_(0.0, 1.5 / (27 * module.conv.in_channels) ** 0.5,
                                           generator=gen)
                module.bn.weight.copy_(0.5 + torch.rand(cout, generator=gen))
                module.bn.bias.copy_(0.2 * torch.randn(cout, generator=gen))
                module.bn.running_mean.copy_(0.1 * torch.randn(cout, generator=gen))
                module.bn.running_var.copy_(0.5 + torch.rand(cout, generator=gen))
    net.eval()
    x = torch.randn((1, 16, 8, 16, 24), generator=gen).to(dtype or torch.float32)
    x = x.to(memory_format=torch.channels_last_3d)
    with torch.no_grad():
        logits = net(x)
        want = _logits_with_skips_outside(net, x)
    assert logits.shape == (1, 8, 16, 24) and logits.dtype == torch.float32
    torch.testing.assert_close(logits, want, atol=0, rtol=0)


@pytest.mark.parametrize("mode", [STRIDE1, TRANSPOSED], ids=["stride1", "transposed"])
def test_train_mode_keeps_the_composition(mode):
    """Batch statistics cannot be folded: train mode normalizes with them
    and updates the running ones, then adds the skip after the ReLU."""
    gen = torch.Generator().manual_seed(5)
    block = _block(mode, 16, 8, None, gen).train()
    twin = _block(mode, 16, 8, None, torch.Generator().manual_seed(5)).train()
    x, s = _inputs(mode, 16, 8, (4, 6, 8), True, None, gen)
    initial = block.bn.running_mean.clone()
    got = block(x, s)
    want = F.relu(twin.bn(conv3d(twin.conv, x, None))) + s
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(block.bn.running_mean, twin.bn.running_mean, atol=0, rtol=0)
    assert not torch.equal(block.bn.running_mean, initial)


def test_block_modes_and_output_sizes():
    assert block_mode(nn.Conv3d(8, 8, 3, padding=1, bias=False)) == STRIDE1
    assert block_mode(nn.Conv3d(8, 16, 3, stride=2, padding=1, bias=False)) == STRIDE2
    assert block_mode(nn.ConvTranspose3d(16, 8, 3, stride=2, padding=1, output_padding=1,
                                         bias=False)) == TRANSPOSED
    for conv in (nn.Conv3d(8, 8, 3, padding=1), nn.Conv3d(8, 8, 5, padding=2, bias=False),
                 nn.Conv3d(8, 8, 3, padding=1, dilation=2, bias=False),
                 nn.ConvTranspose3d(16, 8, 3, stride=2, padding=1, bias=False),
                 nn.Conv2d(8, 8, 3, padding=1, bias=False)):
        with pytest.raises(ValueError, match="3x3x3"):
            block_mode(conv)
    # CostRegNet's levels: 48 -> 24 -> 12 -> 6 and back; 27 (stage 1's
    # height at 1/8) from 54; odd extents halve as F.conv3d does
    assert [output_size(STRIDE2, n) for n in (48, 54, 27, 5)] == [24, 27, 14, 3]
    assert [output_size(TRANSPOSED, n) for n in (6, 27)] == [12, 54]
    assert output_size(STRIDE1, 37) == 37
    # the kernel is built for CostRegNet's blocks, and only those
    with open(SOURCE) as f:
        built = re.findall(r"^  PMN_CONV3D_BLOCK\((\d), (\d+), (\d+)\)$", f.read(), re.M)
    assert {tuple(map(int, b)) for b in built} == {(m, ci, co) for m, ci, co, _ in BLOCKS}
    assert len(built) == 12


def test_plain_version_refuses_gradients():
    block = _block(STRIDE1, 8, 8, None, torch.Generator().manual_seed(0))
    x = torch.randn((1, 8, 2, 4, 4))
    with pytest.raises(ValueError, match="no backward"):
        conv3d_block(x, block.conv, block.bn, None)
    with torch.no_grad():
        assert conv3d_block(x, block.conv, block.bn, None).shape == (1, 8, 2, 4, 4)


@pytest.mark.parametrize("mode", sorted(KIND), ids=[KIND[m] for m in sorted(KIND)])
def test_kernel_symbol_is_a_convolution(mode):
    """K10's device symbols (bf16 and f32 payloads), as the wrapper and
    `csrc/conv3d_block.cu` name them, fall in the benchmark's `convolutions`
    group (`pmnbench/kernel_groups/`), where the roofline counts the blocks'
    bound."""
    with open(SOURCE) as f:
        source = f.read()
    namespace, function = KERNEL.split("::")
    assert f"namespace {namespace} {{" in source
    assert f"    {function}(const __nv_bfloat16* __restrict__ x" in source
    assert f"    {KERNEL_F32.split('::')[1]}(const float* __restrict__ x" in source
    cin, cout = {STRIDE1: (16, 8), STRIDE2: (8, 16), TRANSPOSED: (32, 16)}[mode]
    ints = ", ".join(["int"] * 8)
    traced = (f"void {KERNEL}<{mode}, {cin}, {cout}, {min(cout, 16)}>(__nv_bfloat16 const*, "
              "float const*, float const*, float const*, float const*, float const*, "
              f"__nv_bfloat16 const*, __nv_bfloat16*, {ints})")
    assert devtrace.group_of(traced, devtrace.kernel_groups()) == "convolutions"
    traced = (f"void {KERNEL_F32}<{mode}, {cin}, {cout}>(float const*, float const*, "
              "float const*, float const*, float const*, float const*, float const*, "
              f"float*, {ints})")
    assert devtrace.group_of(traced, devtrace.kernel_groups()) == "convolutions"


# -- on the card ---------------------------------------------------------------

# the cell's CostRegNets (DTU 1152x864): each stage's input (D, h, w, C)
STAGES = {"stage1": (48, 216, 288, 32), "stage2": (32, 432, 576, 16), "stage3": (8, 864, 1152, 8)}


def stage_blocks(d, h, w, c):
    """The 10 blocks of a CostRegNet on a [1, c, d, h, w] volume: (name,
    kind, Cin, Cout, input size, skip)."""
    sizes = [(d, h, w)]
    for _ in range(3):
        sizes.append(tuple(output_size(STRIDE2, n) for n in sizes[-1]))
    return [("conv0", STRIDE1, c, 8, sizes[0], False),
            ("conv1", STRIDE2, 8, 16, sizes[0], False),
            ("conv2", STRIDE1, 16, 16, sizes[1], False),
            ("conv3", STRIDE2, 16, 32, sizes[1], False),
            ("conv4", STRIDE1, 32, 32, sizes[2], False),
            ("conv5", STRIDE2, 32, 64, sizes[2], False),
            ("conv6", STRIDE1, 64, 64, sizes[3], False),
            ("conv7", TRANSPOSED, 64, 32, sizes[3], True),
            ("conv9", TRANSPOSED, 32, 16, sizes[2], True),
            ("conv11", TRANSPOSED, 16, 8, sizes[1], True)]


# K10 against conv3d_block_unrounded: one bf16 rounding of the result (2^-8 of it) and
# the f32 sums' order
KERNEL_TOL = (2e-3, 2 ** -8)


def check_against_plain(block, x, skip):
    """K10 on (x, skip): one launch, channels_last_3d bf16, every value
    within KERNEL_TOL of `conv3d_block_unrounded`; returns (max |K10 - conv3d_block_unrounded|, max
    |K10 - the bf16 plain version|)."""
    before = cuda_build.launch_counts().get("conv3d_block", 0)
    with torch.no_grad():
        got = conv3d_block(x, block.conv, block.bn, torch.bfloat16, skip)
        torch.cuda.synchronize()
        assert cuda_build.launch_counts()["conv3d_block"] == before + 1
        want = conv3d_block_unrounded(x, block.conv, block.bn, skip)
        bf16 = conv3d_block_reference(x, block.conv, block.bn, torch.bfloat16, skip)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    atol, rtol = KERNEL_TOL
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)
    return (float((got.float() - want).abs().max()),
            float((got.float() - bf16.float()).abs().max()))


# K10 on f32 payloads against the plain version in f32 (TF32 off): the same
# products summed in another order
KERNEL_F32_TOL = (1e-4, 1e-4)


def check_f32_against_plain(block, x, skip):
    """K10 on f32 (x, skip): one launch, channels_last_3d f32, every value
    within KERNEL_F32_TOL of the plain version in f32 with TF32 off."""
    before = cuda_build.launch_counts().get("conv3d_block", 0)
    with torch.no_grad(), full_f32():
        got = conv3d_block(x, block.conv, block.bn, None, skip)
        torch.cuda.synchronize()
        assert cuda_build.launch_counts()["conv3d_block"] == before + 1
        want = conv3d_block_reference(x, block.conv, block.bn, None, skip)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    atol, rtol = KERNEL_F32_TOL
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# K10 against the plain arithmetic: bf16 payloads against `conv3d_block_unrounded`,
# f32 payloads against the plain version in f32
CHECKS = {"bf16": check_against_plain, "f32": check_f32_against_plain}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", sorted(DTYPES))
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_kernel_matches_plain_at_the_cells_blocks(device, stage, precision):
    dtype = DTYPES[precision]
    gen = torch.Generator().manual_seed(len(stage) + sum(STAGES[stage]) + (dtype is None))
    for name, mode, cin, cout, size, skip in stage_blocks(*STAGES[stage]):
        block = _block(mode, cin, cout, dtype, gen, device)
        x, s = _inputs(mode, cin, cout, size, skip, dtype, gen)
        x = x.to(device)
        s = None if s is None else s.to(device)
        CHECKS[precision](block, x, s)
        del x, s


@pytest.mark.cuda
@pytest.mark.parametrize("precision", sorted(DTYPES))
@pytest.mark.parametrize("mode,cin,cout,skip", BLOCKS, ids=BLOCK_IDS)
def test_kernel_matches_plain_at_ragged_shapes(device, mode, cin, cout, skip, precision):
    """A batch of 2 whose D crosses a block's chunk of planes and whose H
    and W are multiples of no tile, odd extents included."""
    dtype = DTYPES[precision]
    gen = torch.Generator().manual_seed(cin + 3 * cout + (dtype is None))
    block = _block(mode, cin, cout, dtype, gen, device)
    x, s = _inputs(mode, cin, cout, (11, 19, 37) if mode != TRANSPOSED else (5, 9, 19), skip,
                   dtype, gen, batch=2)
    CHECKS[precision](block, x.to(device), None if s is None else s.to(device))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(device):
    gen = torch.Generator().manual_seed(1)
    block = _block(STRIDE1, 16, 8, torch.bfloat16, gen, device)
    x = torch.randn((1, 16, 4, 8, 8), device=device).bfloat16()  # contiguous, not channels last
    with torch.no_grad():
        with pytest.raises(ValueError, match="channels_last_3d"):
            conv3d_block(x, block.conv, block.bn, torch.bfloat16)
        with pytest.raises(TypeError, match="dtype"):
            conv3d_block(x.half().to(memory_format=torch.channels_last_3d), block.conv,
                         block.bn, None)
        skip = torch.zeros((1, 8, 4, 8, 8), device=device).to(
            memory_format=torch.channels_last_3d)  # f32, x bf16
        with pytest.raises(TypeError, match="dtype"):
            conv3d_block(x.to(memory_format=torch.channels_last_3d), block.conv, block.bn,
                         torch.bfloat16, skip)
        odd = _block(STRIDE1, 8, 16, torch.bfloat16, gen, device)
        with pytest.raises(RuntimeError, match="conv3d_block launch failed"):
            conv3d_block(torch.randn((1, 8, 4, 8, 8), device=device).bfloat16().to(
                memory_format=torch.channels_last_3d), odd.conv, odd.bn, torch.bfloat16)
        with pytest.raises(ValueError, match="eval mode"):
            conv3d_block(x.to(memory_format=torch.channels_last_3d), block.conv,
                         block.bn.train(), torch.bfloat16)
