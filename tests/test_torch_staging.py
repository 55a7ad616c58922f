"""The request's staging buffers (`infer/depth.py` `DepthEstimator`): the
images go to the device in the model's compute dtype, cast on the host view
by view through a buffer the estimator keeps, and the maps come back
through another.

On the CPU (unpinned buffers, the same code): the staging cast equals
`Tensor.to` to the bit on rounding ties, signed zeros, subnormals,
infinities and the largest finite value (a NaN stays NaN); the maps equal
those of the model called on the f32 images with the same noise, to the
bit, for an f32 and a bf16 model, with and without bucket padding; a
request draws one `PatchmatchNet.noise_shape` of the padded size from its
generator; a result never shares memory with the buffers and survives the next
request; same-shape requests reuse the buffers and a new shape allocates
them again.

Marked `cuda` (skipped without a card): the buffers are pinned, the host's
bf16 cast equals the card's, and the maps equal the route that sends f32
images from pageable memory and casts on the card (the f32 model with
cuDNN's deterministic algorithms: its default ones are not the same from
call to call). On a machine with a GPU:
    python -m pytest tests/test_torch_staging.py -q -m cuda --noconftest
This file imports no JAX.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn as nn

from patchmatchnet_torch.data import plane_batch
from patchmatchnet_torch.infer import DepthEstimator
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.ops.resize import resize_bilinear_maps, resize_nearest_maps
from patchmatchnet_torch.train.driver import load_any_checkpoint
from patchmatchnet_torch.utils.profiling import reset_spans, span_records, trace_spans

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "params_000007.msgpack")
CAMERAS = ("intrinsics", "extrinsics", "depth_min", "depth_max")


def _bits(x: np.ndarray) -> np.ndarray:
    """f32 values from their bit patterns."""
    return np.asarray(x, np.uint32).view(np.float32)


def special_values() -> np.ndarray:
    """f32 values where a cast to bf16 can go wrong, then random ones."""
    tie_even, tie_odd = 0x3F808000, 0x3F818000  # halfway; the kept lsb 0, 1
    specials = np.concatenate([
        _bits([tie_even, tie_odd, tie_even | 0x80000000, tie_odd | 0x80000000,
               tie_even + 1, tie_odd - 1, 0x00008000, 0x00018000, 0x7F7F8000]),
        [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan],
        _bits([0x00000001, 0x00007FFF, 0x0000C000, 0x007FFFFF, 0x807FFFFF, 0x00800000]),
        [np.finfo(np.float32).max, -np.finfo(np.float32).max,
         np.finfo(np.float32).tiny, 1.0, 1.0 / 3.0, -2.5e-3],
    ]).astype(np.float32)
    rng = np.random.default_rng(0)
    extra = rng.standard_normal(2 * 8 * 16 * 3 - specials.size).astype(np.float32)
    values = np.concatenate([specials, extra * 10.0 ** rng.integers(-40, 38, extra.size)])
    return values.astype(np.float32).reshape(1, 2, 8, 16, 3)


def assert_same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    """Equal to the bit, but that a NaN need only stay a NaN."""
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int16), want[~nan].view(torch.int16))


class Recorder(nn.Module):
    """A stand-in model that keeps the images it was handed and returns
    maps of their size made from their first channel."""

    noise_shape = staticmethod(PatchmatchNet.noise_shape)

    def __init__(self, compute_dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.seen = None

    def forward(self, images, intrinsics, extrinsics, depth_min, depth_max, init_noise=None):
        self.seen = images.clone()
        depth = images[:, 0, ..., 0].float() + depth_min.reshape(-1, 1, 1)
        return depth, images[:, -1, ..., 0].float(), {}


def _batch(images: np.ndarray):
    b, n = images.shape[:2]
    cams = {k: v[:b, :n] if v.ndim > 1 else v[:b]
            for k, v in plane_batch(b, n, 8, 8).items() if k in CAMERAS}
    return {"images": images, **cams}


@pytest.fixture(scope="module")
def state_dict():
    return load_any_checkpoint(CKPT)


def _model(state_dict, dtype):
    model = PatchmatchNet(compute_dtype=dtype)
    model.load_state_dict(state_dict, strict=True)
    return model


def _direct(model, batch, noise, bucket, device):
    """The model called on the f32 images sent as they are (pageable, cast
    by the model's first convolutions), cropped and resized as the
    estimator does."""
    images = np.asarray(batch["images"], np.float32)
    h0, w0 = images.shape[2:4]
    if bucket:
        hb, wb = -(-h0 // bucket) * bucket, -(-w0 // bucket) * bucket
        images = np.pad(images, ((0, 0), (0, 0), (0, hb - h0), (0, wb - w0), (0, 0)), mode="edge")
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    with torch.inference_mode():
        depth, conf, _ = model(t(images), *(t(batch[k]).float() for k in CAMERAS),
                               init_noise=noise)
        depth = resize_bilinear_maps(depth[:, :h0, :w0], h0, w0)
        conf = resize_nearest_maps(conf[:, :h0, :w0], h0, w0)
    return depth.cpu().numpy(), conf.cpu().numpy()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_staging_cast_equals_tensor_to(dtype):
    images = special_values()
    model = Recorder(None if dtype == torch.float32 else dtype)
    estimator = DepthEstimator(model, "cpu")
    assert estimator.staging_dtype == dtype
    estimator(_batch(images), torch.Generator().manual_seed(0))
    assert model.seen.is_contiguous()
    assert_same_bits(model.seen, torch.from_numpy(images).to(dtype))


@pytest.mark.parametrize("dtype,bucket,b", [(None, 0, 1), (torch.bfloat16, 0, 1),
                                            (None, 32, 1), (torch.bfloat16, 32, 1),
                                            (torch.bfloat16, 0, 2)])
def test_maps_equal_the_model_on_f32_images(state_dict, dtype, bucket, b):
    h, w = (56, 72) if bucket else (64, 80)
    batch = plane_batch(b, 3, h, w)
    estimator = DepthEstimator(_model(state_dict, dtype), "cpu", bucket_multiple=bucket)
    depth, conf = estimator(batch, torch.Generator().manual_seed(3))
    hm, wm = (64, 96) if bucket else (h, w)
    noise = torch.rand((b, 48, hm // 8, wm // 8), generator=torch.Generator().manual_seed(3))
    want_depth, want_conf = _direct(estimator.model, batch, noise, bucket, "cpu")
    assert depth.shape == conf.shape == (b, h, w)
    np.testing.assert_array_equal(depth, want_depth)
    np.testing.assert_array_equal(conf, want_conf)


@pytest.mark.parametrize("bucket", [0, 32])
def test_request_draws_the_models_noise(state_dict, bucket):
    """A PatchmatchNet request consumes the generator as one draw of
    `PatchmatchNet.noise_shape` at the padded size does."""
    estimator = DepthEstimator(_model(state_dict, torch.bfloat16), "cpu", bucket_multiple=bucket)
    gen, want = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    estimator(plane_batch(1, 3, 56, 72), gen)
    hm, wm = (64, 96) if bucket else (56, 72)
    torch.rand(PatchmatchNet.noise_shape(1, hm, wm), generator=want)
    assert torch.equal(gen.get_state(), want.get_state())


def test_results_are_the_callers_own(state_dict):
    """A result survives the next request of another scene and shares no
    memory with the buffers."""
    estimator = DepthEstimator(_model(state_dict, torch.bfloat16), "cpu")
    first = estimator(plane_batch(1, 3, 64, 80, seed=0), torch.Generator().manual_seed(0))
    kept = [a.copy() for a in first]
    other = plane_batch(1, 3, 64, 80, seed=1)
    other["images"] = np.ascontiguousarray(other["images"][..., ::-1])
    second = estimator(other, torch.Generator().manual_seed(1))
    assert not np.array_equal(second[0], kept[0])
    for got, want in zip(first, kept):
        np.testing.assert_array_equal(got, want)
    for a in (*first, *second):
        for buffer in (estimator.images_buffer, estimator.maps_buffer):
            assert not np.shares_memory(a, buffer.view(torch.uint8).numpy())
    assert not np.shares_memory(second[0], second[1])


def test_same_shape_requests_reuse_the_buffers():
    estimator = DepthEstimator(Recorder(torch.bfloat16), "cpu")
    small = _batch(special_values())
    large = _batch(np.zeros((1, 2, 16, 16, 3), np.float32))
    previous = trace_spans(True)
    reset_spans()
    try:
        pointers = []
        for batch in (small, small, dict(small, orig_height=np.array([4])), large, large):
            estimator(batch, torch.Generator().manual_seed(0))
            pointers.append((estimator.images_buffer.data_ptr(),
                             estimator.maps_buffer.data_ptr()))
        copy_in = span_records("pmn.request.copy_in")
        copy_out = span_records("pmn.request.copy_out")
    finally:
        trace_spans(previous)
        reset_spans()
    assert [r.numbers["staging_allocs"] for r in copy_in] == [1, 0, 1, 1, 0]
    assert pointers[0] == pointers[1] and pointers[3] == pointers[4]
    assert all(r.numbers["staged_bytes"] == 0 for r in copy_in + copy_out)  # nothing pinned
    assert copy_in[0].numbers["bytes"] == (small["images"].size * 2
                                           + sum(small[k].nbytes for k in CAMERAS))
    assert estimator.images_buffer.dtype == torch.bfloat16
    assert estimator.maps_buffer.shape == (2, 1, 16, 16)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_host_cast_equals_the_cards_and_buffers_are_pinned(device):
    images = special_values()
    model = Recorder(torch.bfloat16)
    estimator = DepthEstimator(model, device)
    previous = trace_spans(True)
    reset_spans()
    try:
        estimator(_batch(images), torch.Generator(device=device).manual_seed(0))
        (copy_in,) = span_records("pmn.request.copy_in")
        (copy_out,) = span_records("pmn.request.copy_out")
    finally:
        trace_spans(previous)
        reset_spans()
    assert estimator.images_buffer.is_pinned() and estimator.maps_buffer.is_pinned()
    assert copy_in.numbers["staged_bytes"] == images.size * 2
    assert copy_out.numbers["staged_bytes"] == estimator.maps_buffer.nbytes
    assert_same_bits(model.seen, torch.from_numpy(images).to(device).to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bucket", [(torch.bfloat16, 0), (torch.bfloat16, 32), (None, 0)])
def test_maps_equal_the_pageable_f32_route_on_the_card(state_dict, device, dtype, bucket,
                                                       monkeypatch):
    if dtype is None:
        # cuDNN's default choice for the f32 convolutions differs by an ulp
        # in a few dozen pixels from call to call, down either route
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    h, w = (120, 152) if bucket else (128, 160)
    batch = plane_batch(1, 4, h, w)
    estimator = DepthEstimator(_model(state_dict, dtype), device, bucket_multiple=bucket)
    for seed in (5, 6):  # the second request reuses the buffers
        depth, conf = estimator(batch, torch.Generator(device=device).manual_seed(seed))
        hm, wm = (128, 160)
        noise = torch.rand((1, 48, hm // 8, wm // 8),
                           generator=torch.Generator(device=device).manual_seed(seed),
                           device=device)
        want_depth, want_conf = _direct(estimator.model, batch, noise, bucket, device)
        np.testing.assert_array_equal(depth, want_depth)
        np.testing.assert_array_equal(conf, want_conf)
