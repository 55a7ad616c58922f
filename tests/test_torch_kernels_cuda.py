"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: every test skips without a CUDA device (decided inside the
fixture). On a machine with a GPU:
    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda --noconftest
This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from patchmatchnet_torch import ops
from patchmatchnet_torch.models.patchmatch import build_offset_grid, evaluation_offsets
from patchmatchnet_torch.ops import cuda_build, warp_similarity
from patchmatchnet_torch.ops.warp import warp_proj_coeffs

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _hypotheses(gen, device, b, d, h, w, where):
    """[b, d, h, w] depths: "mixed" in front of the cameras with the first
    hypothesis of the first two rows behind them, "behind" all behind
    (pz <= 1e-3), "off" all so near that every warp leaves the image."""
    depth = torch.rand((b, d, h, w), generator=gen, device=device)
    if where == "behind":
        return -1.0 - depth
    if where == "off":
        return 0.01 + 0.01 * depth
    depth = 4.0 + 4.0 * depth
    depth[:, 0, :2] = -1.0  # behind the source camera
    return depth


# Shapes and hypotheses of the warp kernels' cases (b, d, h, w, where): the
# tiled kernel's ragged edges (H x W not a multiple of its pixel tile, W
# below it, H = 1), D = 1 and D not a multiple of its hypothesis chunk,
# B = 2, and samples all behind the cameras or all off the image.
WARP_CASES = [(1, 6, 20, 36, "mixed"), (2, 11, 13, 17, "mixed"), (1, 1, 9, 40, "mixed"),
              (1, 5, 1, 7, "mixed"), (1, 6, 20, 36, "behind"), (1, 6, 20, 36, "off")]


def _case(device, c, d, h, w, dtype, seed=0, b=1, where="mixed"):
    gen = torch.Generator(device=device).manual_seed(seed)
    f = 1.1 * max(h, w)
    k = torch.tensor([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]])
    projs = []
    for tx in (0.0, 0.35):
        p = torch.eye(4)
        p[:3, :4] = k @ torch.tensor([[1.0, 0, 0, tx], [0, 1, 0, 0], [0, 0, 1, 0]])
        projs.append(p)
    mat12 = warp_proj_coeffs(projs[1][None], projs[0][None]).to(device)
    mat12 = mat12.expand(b, 12).contiguous()
    # the plain versions' align_corners=True normalization needs a source of
    # at least 2 x 2 pixels
    src = torch.randn((b, max(h, 2), max(w, 2), c), generator=gen, device=device).to(dtype)
    ref = torch.randn((b, h, w, c), generator=gen, device=device).to(dtype)
    depth = _hypotheses(gen, device, b, d, h, w, where)
    offset = torch.randn((b, h, w, 18), generator=gen, device=device) * 3.0
    grid = build_offset_grid(offset, evaluation_offsets(2), h, w)
    return src, ref, mat12, depth, grid, gen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,g", [(16, 4), (32, 8), (64, 8)])
@pytest.mark.parametrize("b,d,h,w,where", WARP_CASES)
def test_warp_and_neighbor_kernels_match_plain(device, dtype, c, g, b, d, h, w, where):
    """K1 at each of WARP_CASES against its plain version, and in the first
    case also K3 (its case does not depend on K1's shapes); one launch
    counted each."""
    src, ref, mat12, depth, grid, _ = _case(device, c, d, h, w, dtype, b=b, where=where)
    with_k3 = (b, d, h, w, where) == WARP_CASES[0]
    before = cuda_build.launch_counts()
    got = ops.warp_group_corr(src, mat12, depth, ref, g)
    want = ops.warp_group_corr_reference(src, mat12, depth, ref, g)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)
    if with_k3:
        got = ops.neighbor_group_corr(ref, grid, g)
        want = ops.neighbor_group_corr_reference(ref, grid, g)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    after = cuda_build.launch_counts()
    assert after.get("warp_group_corr", 0) == before.get("warp_group_corr", 0) + 1
    assert after.get("neighbor_group_corr", 0) == before.get("neighbor_group_corr", 0) + with_k3


def _close_to_max(got, want, bound):
    """max |got - want| <= bound * max |want| (f32 sums in another order;
    the source gradient's atomics make it non-deterministic)."""
    scale = want.float().abs().max()
    assert scale > 0
    err = (got.float() - want.float()).abs().max()
    assert err <= bound * scale, (err.item(), scale.item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,g", [(16, 4), (32, 8), (64, 8)])
@pytest.mark.parametrize("b,d,h,w", [(1, 6, 20, 36), (2, 11, 13, 17)])
def test_backward_kernels_match_plain(device, dtype, c, g, b, d, h, w):
    """K4 (d_src, d_ref) and K5 (d_gx, d_gy) vs autograd through the plain
    forwards: samples behind the camera (depth < 0), off the image and
    clamped at the border; D that is not a multiple of the kernel's depth
    chunk; launches counted once each."""
    src, ref, mat12, depth, grid, gen = _case(device, c, d, h, w, dtype)
    if b > 1:
        src, ref, depth = (t.expand(b, *t.shape[1:]).contiguous() for t in (src, ref, depth))
        mat12 = mat12.expand(b, 12).contiguous()
        grid = tuple(t.expand(b, *t.shape[1:]).contiguous() for t in grid)
    dout = torch.randn((b, g, d, h, w), generator=gen, device=device)
    bound = 1e-3 if dtype == torch.float32 else 1e-2
    before = cuda_build.launch_counts()
    got = ops.warp_group_corr_backward(src, mat12, depth, ref, g, dout)
    want = ops.warp_group_corr_backward_reference(src, mat12, depth, ref, g, dout)
    for x, y in zip(got, want):
        assert x.dtype == dtype and x.shape == y.shape
        _close_to_max(x, y, bound)
    dout = torch.randn((b, g, 9, h, w), generator=gen, device=device)
    got = ops.neighbor_group_corr_backward(ref, grid, g, dout)
    want = ops.neighbor_group_corr_backward_reference(ref, grid, g, dout)
    for x, y in zip(got, want):
        _close_to_max(x, y, 1e-3)
    after = cuda_build.launch_counts()
    for name in ("warp_group_corr_backward", "neighbor_group_corr_backward"):
        assert after.get(name, 0) == before.get(name, 0) + 1


def test_autograd_runs_the_backward_kernels(device):
    """Autograd through the wrappers launches K4 and K5; depth gets no
    gradient; a reference feature with grad is refused by K3."""
    src, ref, mat12, depth, grid, gen = _case(device, 32, 5, 16, 24, torch.bfloat16)
    src.requires_grad_(True)
    ref.requires_grad_(True)
    depth.requires_grad_(True)
    gx, gy = (t.detach().requires_grad_(True) for t in grid)
    before = cuda_build.launch_counts()
    loss = ops.warp_group_corr(src, mat12, depth, ref, 8).square().sum()
    loss = loss + ops.neighbor_group_corr(ref.detach(), (gx, gy), 8).square().sum()
    loss.backward()
    after = cuda_build.launch_counts()
    for name in ("warp_group_corr", "warp_group_corr_backward", "neighbor_group_corr",
                 "neighbor_group_corr_backward"):
        assert after.get(name, 0) == before.get(name, 0) + 1, name
    assert depth.grad is None
    assert src.grad.dtype == torch.bfloat16 and torch.isfinite(src.grad.float()).all()
    assert torch.isfinite(gx.grad).all() and gx.grad.abs().sum() > 0
    with pytest.raises(ValueError, match="detached"):
        ops.neighbor_group_corr(ref, grid, 8)


def _grid_case(device, b, h, w, where, seed):
    """Eval grid [b, 9, h, w] x 2 from `build_offset_grid`: offsets of a few
    pixels ("near"), or so large that most neighbours lie far off the image
    and are clamped to its border ("far")."""
    gen = torch.Generator(device=device).manual_seed(seed)
    scale = 3.0 if where == "near" else 60.0
    offset = torch.randn((b, h, w, 18), generator=gen, device=device) * scale
    return build_offset_grid(offset, evaluation_offsets(2), h, w), gen


# Shapes and grids of the eval-grid kernels' cases (b, h, w, where): H x W
# not a multiple of a block's pixels, B = 2, H or W = 2, and neighbours far
# off the image.
GRID_CASES = [(1, 20, 36, "near"), (2, 13, 17, "near"), (1, 2, 40, "near"), (1, 9, 2, "near"),
              (1, 20, 36, "far")]


def _within_backward_tol(got, want, dtype):
    """The bound of `chip_smoke.py` `backward_tol`, relative to the largest
    plain entry: max 2e-3 and mean 2e-5 for f32 payloads, 8e-3 and 5e-4 for
    bf16 (f32 sums in another order; a bf16 result may round to the
    neighbouring value). All-zero gradients must be exact."""
    scale = want.float().abs().max()
    err = (got.float() - want.float()).abs()
    if scale == 0:
        assert err.max() == 0
        return
    tol_max, tol_mean = (2e-3, 2e-5) if dtype == torch.float32 else (8e-3, 5e-4)
    assert err.max() <= tol_max * scale and err.mean() <= tol_mean * scale, (
        err.max().item(), err.mean().item(), scale.item())


def _scatter_case(device, c, g, b, d, h, w, layout, dtype, seed=0):
    """K4's arguments with the depth hypotheses laid out for its scatter.
    The source camera sits right of and above the reference (baseline 0.35
    each way), so a sample moves right and up with its inverse depth.
    "plane": the training path's layout, every pixel's hypotheses 0.002
    apart in inverse depth around a plane at 6, so consecutive ones mostly
    share a cell; "wide": inverse depths uniform over [0.02, 2], so they
    rarely do; "mixed": the plane in the top half, wide in the bottom;
    "behind": every sample behind the source camera."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f = 1.1 * max(h, w)
    k = torch.tensor([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]])
    projs = []
    for tx, ty in ((0.0, 0.0), (0.35, -0.35)):
        p = torch.eye(4)
        p[:3, :4] = k @ torch.tensor([[1.0, 0, 0, tx], [0, 1, 0, ty], [0, 0, 1, 0]])
        projs.append(p)
    mat12 = warp_proj_coeffs(projs[1][None], projs[0][None]).to(device).expand(b, 12)
    steps = torch.arange(d, device=device).reshape(1, d, 1, 1) - d // 2
    inv = (1.0 / 6.0 + 0.002 * steps
           + 0.001 * torch.rand((b, 1, h, w), generator=gen, device=device)).expand(b, d, h, w)
    wide = 0.02 + 1.98 * torch.rand((b, d, h, w), generator=gen, device=device)
    if layout == "wide":
        inv = wide
    elif layout == "mixed":
        inv = torch.where(torch.arange(h, device=device).reshape(1, 1, h, 1) >= h // 2, wide, inv)
    depth = 1.0 / inv
    if layout == "behind":
        depth = -depth
    src = torch.randn((b, max(h, 2), max(w, 2), c), generator=gen, device=device).to(dtype)
    ref = torch.randn((b, h, w, c), generator=gen, device=device).to(dtype)
    dout = torch.randn((b, g, d, h, w), generator=gen, device=device)
    return src, mat12.contiguous(), depth.contiguous(), ref, g, dout


# K4's cases (b, d, h, w, layout): consecutive hypotheses mostly in one cell,
# rarely, both in one launch, all behind the camera; H x W not a multiple
# of a block's pixels, D = 1, D odd, H = 1.
SCATTER_CASES = [(2, 16, 20, 36, "plane"), (2, 16, 20, 36, "wide"), (2, 16, 40, 36, "mixed"),
                 (1, 6, 20, 36, "behind"), (1, 11, 13, 17, "plane"), (1, 1, 9, 40, "plane"),
                 (1, 6, 1, 7, "plane")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,g", [(16, 4), (32, 8), (64, 8)])
@pytest.mark.parametrize("b,d,h,w,layout", SCATTER_CASES)
def test_warp_backward_kernel_matches_plain_on_depth_layouts(device, dtype, c, g, b, d, h, w,
                                                             layout):
    """K4 (d_src, d_ref) against its plain version on depth layouts that
    keep its window of source positions in place, move it far each time,
    or both in one launch (as `k4_scatter_counts` shows); one launch
    counted; d_src and d_ref in the payload dtype."""
    args = _scatter_case(device, c, g, b, d, h, w, layout, dtype)
    counts = warp_similarity.k4_scatter_counts(*args)
    share = counts["merged_cells"] / max(counts["samples"], 1)
    if layout == "behind":
        assert counts["samples"] == 0 and counts["global_atomics"] == 0
    elif layout == "wide":
        assert share > 0.8, counts
    elif d > 4:
        assert share < (0.8 if layout == "mixed" else 0.5), counts
    before = cuda_build.launch_counts().get("warp_group_corr_backward", 0)
    got = ops.warp_group_corr_backward(*args)
    assert cuda_build.launch_counts()["warp_group_corr_backward"] == before + 1
    want = ops.warp_group_corr_backward_reference(*args)
    for x, y in zip(got, want):
        assert x.dtype == dtype and x.shape == y.shape
        _within_backward_tol(x, y, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,g", [(16, 4), (32, 8), (64, 8)])
@pytest.mark.parametrize("b,h,w,where", [(1, 20, 36, "near"), (2, 13, 17, "near"),
                                         (1, 2, 40, "near"), (1, 9, 2, "near"),
                                         (1, 20, 36, "far")])
def test_neighbor_backward_kernel_matches_plain(device, dtype, c, g, b, h, w, where):
    """K5 (d_gx, d_gy) against its plain version on ragged pixel tiles (H x
    W not a multiple of a block's pixels, H or W = 2) and on neighbours
    clamped at the border ("far"); one launch counted."""
    grid, gen = _grid_case(device, b, h, w, where, seed=c + 1)
    ref = torch.randn((b, h, w, c), generator=gen, device=device).to(dtype)
    dout = torch.randn((b, g, 9, h, w), generator=gen, device=device)
    before = cuda_build.launch_counts().get("neighbor_group_corr_backward", 0)
    got = ops.neighbor_group_corr_backward(ref, grid, g, dout)
    assert cuda_build.launch_counts()["neighbor_group_corr_backward"] == before + 1
    want = ops.neighbor_group_corr_backward_reference(ref, grid, g, dout)
    for x, y in zip(got, want):
        assert x.dtype == torch.float32 and x.shape == y.shape
        _within_backward_tol(x, y, dtype)


@pytest.mark.parametrize("cost_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 12, 5])
@pytest.mark.parametrize("b,h,w,where", GRID_CASES)
def test_eval_grid_score_kernel_matches_plain(device, cost_dtype, d, b, h, w, where):
    """K2 against its plain version at the main path's D (runs of 8), D = 12
    (runs of 4) and D = 5 (runs of 1), f32 and bf16 cost, at each of
    GRID_CASES; one launch counted per call."""
    grid, gen = _grid_case(device, b, h, w, where, seed=d)
    x_norm = torch.rand((b, h, w, d), generator=gen, device=device)
    cost = torch.randn((b, h, w, d), generator=gen, device=device).to(cost_dtype)
    fw = torch.rand((b, 9, h, w), generator=gen, device=device) * 0.9 + 0.1
    before = cuda_build.launch_counts().get("eval_grid_score", 0)
    got = ops.eval_grid_score(x_norm, cost, grid, fw, 0.025)
    assert cuda_build.launch_counts()["eval_grid_score"] == before + 1
    want = ops.eval_grid_score_reference(x_norm, cost, grid, fw, 0.025)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,g", [(16, 4), (32, 8), (64, 8)])
@pytest.mark.parametrize("b,h,w,where", GRID_CASES)
def test_neighbor_kernel_matches_plain(device, dtype, c, g, b, h, w, where):
    """K3 (the tiled kernel on the eval grid) against its plain version at
    each of GRID_CASES; one launch counted per call."""
    grid, gen = _grid_case(device, b, h, w, where, seed=c)
    ref = torch.randn((b, h, w, c), generator=gen, device=device).to(dtype)
    before = cuda_build.launch_counts().get("neighbor_group_corr", 0)
    got = ops.neighbor_group_corr(ref, grid, g)
    assert cuda_build.launch_counts()["neighbor_group_corr"] == before + 1
    want = ops.neighbor_group_corr_reference(ref, grid, g)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(device):
    src, ref, mat12, depth, grid, _ = _case(device, 16, 4, 8, 12, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.warp_group_corr(src, mat12, depth.transpose(2, 3).contiguous().transpose(2, 3),
                            ref, 4)
    with pytest.raises(TypeError):
        ops.warp_group_corr(src, mat12, depth, ref.to(torch.bfloat16), 4)
    with pytest.raises(ValueError, match="no kernel"):
        ops.neighbor_group_corr(ref, grid, 2)


def test_model_f32_on_card_matches_cpu(device):
    """The f32 forward with kernels on the card vs plain versions on the CPU
    (random weights from a seed, 64x80, 3 views)."""
    from patchmatchnet_torch.models import PatchmatchNet

    torch.manual_seed(0)
    model = PatchmatchNet().eval()
    for p in model.parameters():
        p.data.uniform_(-0.2, 0.2)
    rng = np.random.default_rng(0)
    h, w, n = 64, 80, 3
    images = torch.from_numpy(rng.random((1, n, h, w, 3), dtype=np.float32))
    k = torch.tensor([[80.0, 0, w / 2], [0, 80.0, h / 2], [0, 0, 1]])
    intr = k.expand(1, n, 3, 3).contiguous()
    extr = torch.eye(4).repeat(1, n, 1, 1)
    extr[0, :, 0, 3] = torch.tensor([0.0, 0.3, -0.3])
    dmin, dmax = torch.tensor([4.0]), torch.tensor([10.0])
    noise = torch.rand((1, 48, h // 8, w // 8), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        cpu = model(images, intr, extr, dmin, dmax, init_noise=noise)[0]
        gpu = model.to(device)(images.to(device), intr.to(device), extr.to(device),
                               dmin.to(device), dmax.to(device),
                               init_noise=noise.to(device))[0].cpu()
    assert torch.isfinite(gpu).all()
    diff = (gpu - cpu).abs() / 6.0
    assert diff.mean() < 2e-4 and diff.median() < 1e-5, (diff.mean(), diff.median())


def _baseline(v):
    """(x, y) baseline of source view v: +-0.35, +-0.7, +-1.05, +-1.4 in x,
    and 0.2 higher in y for each 8 views before it."""
    return 0.35 * ((v // 2) % 4 + 1) * (1 if v % 2 == 0 else -1), 0.2 * (v // 8)


def _views_case(device, b, c, d, h, w, dtype, views=4, seed=3, where="mixed"):
    """A rig of `views` sources around the reference (`_baseline`: x
    baselines +-0.35, +-0.7 for the first 4), stacked [B, V, h, w, C]
    features, depth hypotheses as `_hypotheses` makes them, and per-pixel
    view weights."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f = 1.1 * max(h, w)
    k = torch.tensor([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]])
    projs = []
    for tx, ty in [(0.0, 0.0)] + [_baseline(v) for v in range(views)]:
        p = torch.eye(4)
        p[:3, :4] = k @ torch.tensor([[1.0, 0, 0, tx], [0, 1, 0, ty], [0, 0, 1, 0]])
        projs.append(p)
    projs = torch.stack(projs)[None].expand(b, -1, -1, -1)
    mats = warp_proj_coeffs(projs[:, 1:], projs[:, :1]).to(device).contiguous()
    src = torch.randn((b, views, max(h, 2), max(w, 2), c), generator=gen,
                      device=device).to(dtype)
    ref = torch.randn((b, h, w, c), generator=gen, device=device).to(dtype)
    depth = _hypotheses(gen, device, b, d, h, w, where)
    vw = torch.rand((b, views, h, w), generator=gen, device=device)
    return src, mats, depth, ref, vw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,g", [(16, 4), (32, 8), (64, 8)])
@pytest.mark.parametrize("b,d,h,w,views,where", [
    (1, 6, 20, 36, 4, "mixed"), (2, 5, 13, 17, 4, "mixed"), (1, 1, 1, 7, 1, "mixed"),
    (2, 11, 9, 40, 1, "mixed"), (1, 6, 20, 36, 4, "behind"), (1, 6, 20, 36, 4, "off"),
    (1, 6, 20, 36, 51, "mixed"), (2, 5, 13, 17, 64, "mixed")])
def test_views_kernel_matches_plain_and_per_view_route(device, dtype, c, g, b, d, h, w, views,
                                                       where):
    """K6 vs its plain version (1e-4 per view, at least 4e-4: twice K1's
    bound for a sum of up to 4 views with weights below 1) and, to the bit,
    vs the per-view route it replaces: K1 per view, times the weights,
    summed in view order as `Evaluation` does; one launch counted. The
    cases cover the tiled kernel's ragged pixel tiles and hypothesis chunks,
    H = 1, D = 1, B = 2, V = 1 and 4, V = 51 and 64 (several chunks of
    views), and samples all behind the cameras or all off the image."""
    src, mats, depth, ref, vw = _views_case(device, b, c, d, h, w, dtype, views=views,
                                            where=where)
    before = cuda_build.launch_counts()
    got = ops.warp_group_corr_views(src, mats, depth, ref, vw, g)
    after = cuda_build.launch_counts()
    assert after.get("warp_group_corr_views", 0) == before.get("warp_group_corr_views", 0) + 1
    want = ops.warp_group_corr_views_reference(src, mats, depth, ref, vw, g)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * max(views, 4))
    route = torch.zeros_like(got)
    for v in range(src.shape[1]):
        sim = ops.warp_group_corr(src[:, v].contiguous(), mats[:, v].contiguous(), depth, ref, g)
        route = route + sim * vw[:, v, None, None]
    assert torch.equal(got, route)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,g", [(16, 4), (32, 8), (64, 8)])
@pytest.mark.parametrize("b,d,h,w,where", WARP_CASES)
def test_coord_kernel_matches_plain_and_warp_kernel(device, dtype, c, g, b, d, h, w, where):
    """K7 (the tiled kernel reading the coordinates) on the warp
    coordinates equals K1 (the tiled kernel warping) to the bit at each of
    WARP_CASES; on jittered coordinates (off the image too) it is within
    K1's bound of its plain version; one launch counted per call."""
    src, ref, mat12, depth, _, gen = _case(device, c, d, h, w, dtype, b=b, where=where)
    from patchmatchnet_torch.ops.warp import warp_coords

    ix, iy = warp_coords(mat12, depth, src.shape[1], src.shape[2])
    before = cuda_build.launch_counts()
    got = ops.coord_group_corr(src, ix, iy, ref, g)
    assert cuda_build.launch_counts().get("coord_group_corr", 0) == \
        before.get("coord_group_corr", 0) + 1
    assert torch.equal(got, ops.warp_group_corr(src, mat12, depth, ref, g))
    jx = ix + 3.0 * torch.randn(ix.shape, generator=gen, device=device)
    jy = iy + 3.0 * torch.randn(iy.shape, generator=gen, device=device)
    torch.testing.assert_close(ops.coord_group_corr(src, jx, jy, ref, g),
                               ops.coord_group_corr_reference(src, jx, jy, ref, g),
                               rtol=0, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,g", [(16, 4), (32, 8), (64, 8)])
@pytest.mark.parametrize("hs,ws", [(31, 45), (7, 11)])
def test_coord_kernel_on_a_source_of_another_size(device, dtype, c, g, hs, ws):
    """K7 and K1 with a source map larger or smaller than the 20 x 36
    reference grid: equal to the bit on the warp coordinates, and K7 within
    K1's bound of its plain version on coordinates spread over and past the
    source (many corners off it)."""
    src, ref, mat12, depth, _, gen = _case(device, c, 6, 20, 36, dtype)
    src = torch.randn((1, hs, ws, c), generator=gen, device=device).to(dtype)
    from patchmatchnet_torch.ops.warp import warp_coords

    ix, iy = warp_coords(mat12, depth, hs, ws)
    assert torch.equal(ops.coord_group_corr(src, ix, iy, ref, g),
                       ops.warp_group_corr(src, mat12, depth, ref, g))
    jx = (ws + 4) * torch.rand(ix.shape, generator=gen, device=device) - 2
    jy = (hs + 4) * torch.rand(iy.shape, generator=gen, device=device) - 2
    torch.testing.assert_close(ops.coord_group_corr(src, jx, jy, ref, g),
                               ops.coord_group_corr_reference(src, jx, jy, ref, g),
                               rtol=0, atol=2e-4)


def test_views_and_coord_wrappers_reject_what_the_kernels_do_not_take(device):
    src, mats, depth, ref, vw = _views_case(device, 1, 16, 3, 8, 12, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.warp_group_corr_views(src, mats, depth, ref, vw.transpose(2, 3).contiguous()
                                  .transpose(2, 3), 4)
    with pytest.raises(ValueError, match="no kernel"):
        ops.warp_group_corr_views(src, mats, depth, ref, vw, 2)
    with pytest.raises(ValueError, match="no backward"):
        ops.warp_group_corr_views(src.requires_grad_(True), mats, depth, ref, vw, 4)
    ix = torch.zeros((1, 3, 8, 12), device=device)
    with pytest.raises(TypeError):
        ops.coord_group_corr(src[:, 0].detach(), ix, ix.double(), ref, 4)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_fused_model_on_card_equals_unfused(device, dtype):
    """The inference forward on the card (K1 4 and K6 4 launches) gives, to
    the bit, the depth and confidence of the same eval-mode forward with grad
    enabled, which takes the per-view route (K1 20 launches, no K6);
    random weights from a seed, 64x80, N=5."""
    from patchmatchnet_torch.models import PatchmatchNet

    torch.manual_seed(0)
    model = PatchmatchNet(compute_dtype=dtype).eval()
    for p in model.parameters():
        p.data.uniform_(-0.2, 0.2)
    model.to(device)
    rng = np.random.default_rng(0)
    h, w, n = 64, 80, 5
    images = torch.from_numpy(rng.random((1, n, h, w, 3), dtype=np.float32)).to(device)
    k = torch.tensor([[80.0, 0, w / 2], [0, 80.0, h / 2], [0, 0, 1]])
    intr = k.expand(1, n, 3, 3).contiguous().to(device)
    extr = torch.eye(4).repeat(1, n, 1, 1)
    extr[0, :, 0, 3] = torch.tensor([0.0, 0.3, -0.3, 0.6, -0.6])
    extr = extr.to(device)
    dmin, dmax = torch.tensor([4.0], device=device), torch.tensor([10.0], device=device)
    noise = torch.rand((1, 48, h // 8, w // 8), generator=torch.Generator().manual_seed(1))
    args = (images, intr, extr, dmin, dmax)
    cuda_build.reset_launch_counts()
    with torch.inference_mode():
        fused = model(*args, init_noise=noise.to(device))[:2]
    counts = cuda_build.launch_counts()
    assert counts["warp_group_corr"] == 4 and counts["warp_group_corr_views"] == 4
    cuda_build.reset_launch_counts()
    per_view = [t.detach() for t in model(*args, init_noise=noise.to(device))[:2]]
    counts = cuda_build.launch_counts()
    assert counts["warp_group_corr"] == 20 and "warp_group_corr_views" not in counts
    assert torch.equal(fused[0], per_view[0]) and torch.equal(fused[1], per_view[1])


def _gather_case(device, shape, index_size, seed=5):
    gen = torch.Generator(device=device).manual_seed(seed)
    win = torch.randn(shape, generator=gen, device=device)
    idx = torch.randint(0, index_size, shape, generator=gen, device=device, dtype=torch.int32)
    return win, idx


@pytest.mark.parametrize("shape", [(16, 32, 128), (5, 256, 128), (3, 7, 12)])
def test_gather_lanes_kernel_matches_plain_and_torch_gather(device, shape):
    """D1-D3: bit for bit against the plain version and torch.gather (int64
    index), one launch counted."""
    win, idx = _gather_case(device, shape, shape[2])
    before = cuda_build.launch_counts().get("gather_lanes", 0)
    got = ops.gather_lanes(win, idx)
    assert cuda_build.launch_counts()["gather_lanes"] == before + 1
    assert torch.equal(got, ops.gather_lanes_reference(win, idx))
    assert torch.equal(got, torch.gather(win, 2, idx.long()))


@pytest.mark.parametrize("shape", [(16, 8, 128), (3, 5, 20), (2, 1, 4)])
def test_gather_sublanes_kernel_matches_plain_and_torch_gather(device, shape):
    """D4: bit for bit against the plain version and torch.gather."""
    win, idx = _gather_case(device, shape, shape[1])
    before = cuda_build.launch_counts().get("gather_sublanes", 0)
    got = ops.gather_sublanes(win, idx)
    assert cuda_build.launch_counts()["gather_sublanes"] == before + 1
    assert torch.equal(got, ops.gather_sublanes_reference(win, idx))
    assert torch.equal(got, torch.gather(win, 1, idx.long()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,r,p,c", [(4, 128, 16, 64), (2, 256, 33, 256), (1, 700, 50, 8)])
def test_gather_rows_kernel_matches_plain_and_torch_gather(device, dtype, n, r, p, c):
    """D5 and the xla row gather: f32 and bf16 rows, bit for bit against the
    plain version and torch.gather on the index expanded to C."""
    gen = torch.Generator(device=device).manual_seed(6)
    win = torch.randn((n, r, c), generator=gen, device=device).to(dtype)
    idx = torch.randint(0, r, (n, p), generator=gen, device=device, dtype=torch.int32)
    before = cuda_build.launch_counts().get("gather_rows", 0)
    got = ops.gather_rows(win, idx)
    assert cuda_build.launch_counts()["gather_rows"] == before + 1
    assert got.dtype == dtype and got.shape == (n, p, c)
    assert torch.equal(got, ops.gather_rows_reference(win, idx))
    assert torch.equal(got, torch.gather(win, 1, idx.long()[..., None].expand(n, p, c)))


def test_gather_wrappers_reject_what_the_kernels_do_not_take(device):
    win, idx = _gather_case(device, (2, 4, 6), 6)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.gather_lanes(win, idx)
    win, idx = _gather_case(device, (2, 4, 8), 4)
    with pytest.raises(TypeError):
        ops.gather_sublanes(win, idx.long())
    win9, idx9 = _gather_case(device, (2, 9, 8), 9)
    with pytest.raises(ValueError, match="S <= 8"):
        ops.gather_sublanes(win9, idx9)
    with pytest.raises(ValueError, match="16 bytes"):
        ops.gather_rows(win[:, :, :6].contiguous().to(torch.bfloat16), idx[:, :, 0].contiguous())
    with pytest.raises(IndexError):
        ops.gather_rows_reference(win, idx[:, :, 0].contiguous() + 4)
