"""The port's host data layer against the JAX package's: codecs, synthetic
scene, MVSDataset samples and the loader's multiple-of-8 adjustment, on the
same files. Decoded images equal the JAX package's to the bit: both decode
an 8-bit level x as x * f32(1/255) (its native host library, which loads
here). The multiple-of-8 resize is compared at 1e-5: torch
computes the source coordinate in f32 (an ulp of x ~ 84 is 8e-6 px), and
the texture changes by up to ~0.5 per pixel."""

import filecmp
import os

import numpy as np
import pytest

from patchmatchnet_tpu import native
from patchmatchnet_tpu.data import BatchLoader as JaxBatchLoader
from patchmatchnet_tpu.data import MVSDataset as JaxMVSDataset
from patchmatchnet_tpu.dataio import read_cam_file as jax_read_cam_file
from patchmatchnet_tpu.dataio import read_pfm as jax_read_pfm
from patchmatchnet_tpu.dataio import save_image as jax_save_image
from patchmatchnet_tpu.dataio.image import read_image as jax_read_image
from patchmatchnet_tpu.dataio import save_pfm as jax_save_pfm
from patchmatchnet_torch.data import (
    BatchLoader,
    MVSDataset,
    make_synthetic_scene,
    read_cam_file,
    read_image,
    read_pfm,
    save_image,
    save_pfm,
)
from tests.scene_utils import make_synthetic_scene as jax_make_synthetic_scene


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """(port scene, reference scene) of 3 views at 60x84 (not multiples of 8)."""
    root = tmp_path_factory.mktemp("scenes")
    port, ref = str(root / "port"), str(root / "ref")
    make_synthetic_scene(port, num_views=3, height=60, width=84, texture_scale=6.0)
    jax_make_synthetic_scene(ref, num_views=3, height=60, width=84, image_extension=".png",
                             texture_scale=6.0)
    return port, ref


def test_synthetic_scene_writes_the_reference_files(scenes):
    port, ref = scenes
    names = ["pair.txt"] + [f"{d}/{v:08d}{ext}" for v in range(3)
                            for d, ext in (("images", ".png"), ("cams", "_cam.txt"))]
    for name in names:
        assert filecmp.cmp(os.path.join(port, name), os.path.join(ref, name), shallow=False), name
    intr, extr, params = read_cam_file(os.path.join(port, "cams", "00000001_cam.txt"))
    want = jax_read_cam_file(os.path.join(port, "cams", "00000001_cam.txt"))
    for got, w in zip((intr, extr, params), want):
        np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("shape", [(5, 7), (1, 9), (8, 1)])
def test_pfm_matches_reference_codec(tmp_path, shape):
    data = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    save_pfm(str(tmp_path / "port.pfm"), data)
    jax_save_pfm(str(tmp_path / "ref.pfm"), data)
    assert filecmp.cmp(tmp_path / "port.pfm", tmp_path / "ref.pfm", shallow=False)
    got = read_pfm(str(tmp_path / "ref.pfm"))
    np.testing.assert_array_equal(got, jax_read_pfm(str(tmp_path / "port.pfm"))[0])
    np.testing.assert_array_equal(got.reshape(shape), data)


def test_image_decode_matches_reference_at_every_level(tmp_path):
    """All 256 levels of an 8-bit PNG decode as the JAX read_image decodes
    them, to the bit; a division by 255 differs at 126 of them."""
    assert native.get_lib() is not None, "the JAX package's native decode did not load"
    levels = np.arange(256, dtype=np.uint8).reshape(16, 16)
    path = str(tmp_path / "levels.png")
    jax_save_image(path, np.stack([levels, levels[::-1], levels.T], axis=2))
    got = read_image(path)
    np.testing.assert_array_equal(got, jax_read_image(path)[0])
    np.testing.assert_array_equal(got[:, :, 0].ravel(),
                                  np.arange(256, dtype=np.float32) * np.float32(1 / 255))
    np.testing.assert_array_equal((got * 255).astype(np.uint8)[:, :, 0], levels)


@pytest.mark.parametrize("idx", [0, 2])
def test_dataset_sample_matches_reference(scenes, idx):
    port, _ = scenes
    got = MVSDataset(port, num_views=2, image_extension=".png")[idx]
    want = JaxMVSDataset(port, num_views=2, image_extension=".png")[idx]
    assert native.get_lib() is not None, "the JAX package's native decode did not load"
    np.testing.assert_array_equal(got["images"], want["images"])
    for key in ("intrinsics", "extrinsics", "depth_min", "depth_max"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["filename"] == want["filename"]


@pytest.mark.parametrize("max_dim", [-1, 64])
def test_dataset_sizes_a_source_of_another_size_like_reference(tmp_path, max_dim):
    """A portrait source (view 1 stored transposed, 84x60) of a landscape
    reference takes the reference's size with its intrinsics rescaled, as
    the JAX dataset does (`patchmatchnet_tpu/data/mvs.py:164-169`), to the
    bit; the port refused such a scan before (views must share a size)."""
    root = str(tmp_path / "scene")
    make_synthetic_scene(root, num_views=3, height=60, width=84, texture_scale=6.0)
    path = os.path.join(root, "images", "00000001.png")
    portrait = np.transpose(read_image(path), (1, 0, 2))
    save_image(path, portrait)
    got = MVSDataset(root, num_views=2, image_extension=".png", max_dim=max_dim)[0]
    want = JaxMVSDataset(root, num_views=2, image_extension=".png", max_dim=max_dim)[0]
    assert got["images"].shape == want["images"].shape
    assert got["images"].shape[1:3] == ((60, 84) if max_dim < 0 else (45, 64))
    np.testing.assert_array_equal(got["images"], want["images"])
    for key in ("intrinsics", "extrinsics", "depth_min", "depth_max", "depth_gt"):
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("num_threads", [1, 3])
def test_loader_adjusts_like_reference(scenes, num_threads):
    """60x84 becomes 64x80 with rescaled intrinsics; batches keep dataset
    order whether loaded on one thread or a pool."""
    port, _ = scenes
    got = list(BatchLoader(MVSDataset(port, 2, ".png"), batch_size=2, num_threads=num_threads))
    want = list(JaxBatchLoader(JaxMVSDataset(port, 2, image_extension=".png"), batch_size=2,
                               num_threads=1))
    assert [b["filename"] for b in got] == [b["filename"] for b in want]
    for g, w in zip(got, want):
        assert g["images"].shape == w["images"].shape == (len(g["filename"]), 3, 64, 80, 3)
        np.testing.assert_allclose(g["images"], w["images"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["intrinsics"], w["intrinsics"], rtol=1e-7)
        for key in ("orig_height", "orig_width", "depth_min", "depth_max"):
            np.testing.assert_array_equal(g[key], w[key])
