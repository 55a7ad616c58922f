"""The port's map, PLY and image codecs against the JAX package's
(`patchmatchnet_tpu/dataio`): files written by either are byte-identical
and read back by the other; `read_map` dispatches by extension; images,
their header sizes and `scaled_dims` match. Shrunk images and maps, and
`adjust_sample_dims`'s stretch to multiples of 8, equal the JAX package's
to the bit, also at DTU's and Tanks' sizes: the port's resize follows the
native resize's arithmetic (f64 source coordinates, f32 weights and lerps).
`read_image_dictionary` reads what the JAX one reads; `save_pfm` writes
[H, W, 1] maps as the JAX writer does."""

import filecmp

import numpy as np
import pytest

from patchmatchnet_tpu.dataio import read_map as jax_read_map
from patchmatchnet_tpu.dataio import read_ply as jax_read_ply
from patchmatchnet_tpu.dataio import save_map as jax_save_map
from patchmatchnet_tpu.dataio import save_ply as jax_save_ply
from patchmatchnet_tpu.dataio.colmap_bin import read_bin as jax_read_bin
from patchmatchnet_tpu.dataio.colmap_bin import save_bin as jax_save_bin
from patchmatchnet_tpu.data.mvs import adjust_sample_dims as jax_adjust_sample_dims
from patchmatchnet_tpu.dataio import read_image_dictionary as jax_read_image_dictionary
from patchmatchnet_tpu.dataio import read_pfm as jax_read_pfm
from patchmatchnet_tpu.dataio import save_pfm as jax_save_pfm
from patchmatchnet_tpu.dataio.image import read_image as jax_read_image
from patchmatchnet_tpu.dataio.image import read_image_size as jax_read_image_size
from patchmatchnet_tpu.dataio.image import save_image as jax_save_image
from patchmatchnet_tpu.dataio.image import scale_to_max_dim as jax_scale_to_max_dim
from patchmatchnet_tpu.dataio.image import scaled_dims as jax_scaled_dims
from patchmatchnet_torch.data import (
    adjust_sample_dims,
    read_bin,
    read_image,
    read_image_dictionary,
    read_image_size,
    read_map,
    read_ply,
    save_bin,
    save_image,
    save_map,
    save_pfm,
    save_ply,
    scale_to_max_dim,
    scaled_dims,
)


@pytest.mark.parametrize("shape", [(5, 7), (6, 4, 1), (3, 9, 3), (1, 1)])
def test_bin_matches_reference_codec(tmp_path, shape):
    data = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    save_bin(str(tmp_path / "port.bin"), data)
    jax_save_bin(str(tmp_path / "ref.bin"), data)
    assert filecmp.cmp(tmp_path / "port.bin", tmp_path / "ref.bin", shallow=False)
    got = read_bin(str(tmp_path / "ref.bin"))
    np.testing.assert_array_equal(got, jax_read_bin(str(tmp_path / "port.bin")))
    np.testing.assert_array_equal(got, data.reshape(shape[:2] + (-1,)))


def test_bin_rejects_what_the_reference_rejects(tmp_path):
    with pytest.raises(ValueError, match="float32"):
        save_bin(str(tmp_path / "a.bin"), np.zeros((2, 3)))
    with pytest.raises(ValueError, match="HxW"):
        save_bin(str(tmp_path / "a.bin"), np.zeros((2, 3, 2), np.float32))
    (tmp_path / "short.bin").write_bytes(b"3&2&")
    with pytest.raises(ValueError, match="truncated"):
        read_bin(str(tmp_path / "short.bin"))
    (tmp_path / "size.bin").write_bytes(b"3&2&1&" + np.zeros(5, np.float32).tobytes())
    with pytest.raises(ValueError, match="size mismatch"):
        read_bin(str(tmp_path / "size.bin"))


@pytest.mark.parametrize("ext", [".pfm", ".bin"])
def test_map_dispatch_matches_reference(tmp_path, ext):
    """save_map/read_map by extension, both ways, and the max_dim shrink."""
    data = np.random.default_rng(2).random((40, 30)).astype(np.float32)
    port, ref = str(tmp_path / f"port{ext}"), str(tmp_path / f"ref{ext}")
    save_map(port, data)
    jax_save_map(ref, data)
    assert filecmp.cmp(port, ref, shallow=False)
    got = read_map(ref)
    assert got.shape == (40, 30, 1)
    np.testing.assert_array_equal(got, jax_read_map(port))
    np.testing.assert_array_equal(got[:, :, 0], data)
    small = read_map(port, max_dim=20)
    want = jax_read_map(port, max_dim=20)
    assert small.shape == want.shape == (20, 15, 1)
    np.testing.assert_array_equal(small, want)
    with pytest.raises(ValueError, match="only .pfm and .bin"):
        read_map(str(tmp_path / "map.png"))
    with pytest.raises(ValueError, match="only .pfm and .bin"):
        save_map(str(tmp_path / "map.png"), data)


@pytest.mark.parametrize("n", [0, 1, 1000])
def test_ply_matches_reference_codec(tmp_path, n):
    rng = np.random.default_rng(n)
    xyz = rng.standard_normal((n, 3)) * 100  # float64: both writers store f32
    rgb = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    save_ply(str(tmp_path / "port.ply"), xyz, rgb)
    jax_save_ply(str(tmp_path / "ref.ply"), xyz, rgb)
    assert filecmp.cmp(tmp_path / "port.ply", tmp_path / "ref.ply", shallow=False)
    got_xyz, got_rgb = read_ply(str(tmp_path / "ref.ply"))
    want_xyz, want_rgb = jax_read_ply(str(tmp_path / "port.ply"))
    np.testing.assert_array_equal(got_xyz, want_xyz)
    np.testing.assert_array_equal(got_rgb, want_rgb)
    np.testing.assert_array_equal(got_xyz, xyz.astype(np.float32))
    np.testing.assert_array_equal(got_rgb, rgb)


def test_ply_reads_variants_like_reference(tmp_path):
    """A PLY with a comment, double coordinates and no colour."""
    data = np.array([(1.5, -2.0, 3.25), (0.0, 7.0, -1.0)],
                    dtype=[("x", "<f8"), ("y", "<f8"), ("z", "<f8")])
    path = tmp_path / "variant.ply"
    header = ("ply\nformat binary_little_endian 1.0\ncomment made by hand\n"
              "element vertex 2\nproperty double x\nproperty double y\nproperty double z\n"
              "end_header\n")
    path.write_bytes(header.encode() + data.tobytes())
    xyz, rgb = read_ply(str(path))
    want_xyz, want_rgb = jax_read_ply(str(path))
    np.testing.assert_array_equal(xyz, want_xyz)
    np.testing.assert_array_equal(rgb, want_rgb)
    assert xyz.dtype == np.float32 and not rgb.any()
    with pytest.raises(ValueError, match="shape"):
        save_ply(str(tmp_path / "bad.ply"), np.zeros((2, 3)), np.zeros((3, 3), np.uint8))


def _write_png(path, image):
    jax_save_image(str(path), image)
    return str(path)


def test_image_decode_size_and_shrink_match_reference(tmp_path):
    rng = np.random.default_rng(3)
    path = _write_png(tmp_path / "im.png", rng.integers(0, 256, (45, 70, 3), dtype=np.uint8))
    np.testing.assert_array_equal(read_image(path), jax_read_image(path)[0])
    assert read_image_size(path) == jax_read_image_size(path) == (45, 70)
    small = read_image(path, max_dim=50)
    want = jax_read_image(path, max_dim=50)[0]
    assert small.shape == want.shape == (32, 50, 3)
    np.testing.assert_array_equal(small, want)
    np.testing.assert_array_equal(read_image(path, max_dim=100), read_image(path))


@pytest.mark.parametrize("size,max_dim", [((864, 1152), -1), ((864, 1152), 1600),
                                          ((864, 1152), 640), ((1200, 1600), 1153),
                                          ((7, 3), 5), ((100, 100), 99)])
def test_scaled_dims_matches_reference(size, max_dim):
    assert scaled_dims(*size, max_dim) == jax_scaled_dims(*size, max_dim)


def test_save_image_matches_reference(tmp_path):
    """Bool masks as 0/255 and floats truncated, as the JAX writer."""
    rng = np.random.default_rng(4)
    for name, image in (("mask", rng.random((9, 11)) > 0.5),
                        ("float", rng.random((9, 11, 3)).astype(np.float32))):
        save_image(str(tmp_path / f"port_{name}.png"), image)
        jax_save_image(str(tmp_path / f"ref_{name}.png"), image)
        assert filecmp.cmp(tmp_path / f"port_{name}.png", tmp_path / f"ref_{name}.png",
                           shallow=False), name


@pytest.mark.parametrize("size,max_dim", [((1200, 1600), 1152), ((1080, 1920), 1600)])
def test_shrink_equals_reference_to_the_bit(tmp_path, size, max_dim):
    """scale_to_max_dim on 8-bit images (x * f32(1/255)), read_image and
    read_map with max_dim, at DTU's and Tanks' image sizes."""
    rng = np.random.default_rng(sum(size))
    levels = rng.integers(0, 256, size + (3,), dtype=np.uint8)
    image = levels.astype(np.float32) * np.float32(1 / 255)
    got, want = scale_to_max_dim(image, max_dim), jax_scale_to_max_dim(image, max_dim)
    assert got[0].shape == want[0].shape and got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], want[0])
    path = _write_png(tmp_path / "im.png", levels)
    np.testing.assert_array_equal(read_image(path, max_dim), jax_read_image(path, max_dim)[0])
    depth = rng.uniform(425.0, 935.0, size).astype(np.float32)
    for ext in (".pfm", ".bin"):
        map_path = str(tmp_path / f"depth{ext}")
        save_map(map_path, depth)
        small = read_map(map_path, max_dim)
        np.testing.assert_array_equal(small, jax_read_map(map_path, max_dim))
        assert max(small.shape[:2]) <= max_dim


@pytest.mark.parametrize("size", [(1067, 1600), (1080, 1913), (60, 84)])
def test_adjust_sample_dims_equals_reference_to_the_bit(size):
    """The stretch of a sample's views to multiples of 8, and its
    intrinsics."""
    rng = np.random.default_rng(size[1])
    views = rng.integers(0, 256, (3,) + size + (3,), dtype=np.uint8)
    k = np.array([[1100.0, 0, size[1] / 2], [0, 1100.0, size[0] / 2], [0, 0, 1]], np.float32)
    sample = {"images": views.astype(np.float32) * np.float32(1 / 255),
              "intrinsics": np.tile(k, (3, 1, 1))}
    got, want = adjust_sample_dims(sample), jax_adjust_sample_dims(sample)
    assert got["images"].shape == want["images"].shape == (
        3, int(round(size[0] / 8)) * 8, int(round(size[1] / 8)) * 8, 3)
    np.testing.assert_array_equal(got["images"], want["images"])
    np.testing.assert_array_equal(got["intrinsics"], want["intrinsics"])
    assert (got["orig_height"], got["orig_width"]) == (want["orig_height"], want["orig_width"])


def test_grey_image_kept_single_channel_like_reference(tmp_path):
    levels = np.random.default_rng(4).integers(0, 256, (90, 120), dtype=np.uint8)
    path = _write_png(tmp_path / "grey.png", levels)
    got, want = read_image(path, 100, rgb=False), jax_read_image(path, 100)[0]
    assert got.shape == want.shape == (75, 100)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_image(path, 100)[..., 1], got)


def test_image_dictionary_matches_reference(tmp_path):
    path = tmp_path / "index2prefix.txt"
    path.write_text("3\n0 images/dslr_images_undistorted/DSC_0286.JPG\n"
                    "1 images/dslr_images_undistorted/DSC_0287.JPG \n12 b.png\n")
    got = read_image_dictionary(str(path))
    assert got == jax_read_image_dictionary(str(path)) and sorted(got) == [0, 1, 12]


def test_pfm_with_a_channel_axis_matches_reference(tmp_path):
    data = np.random.default_rng(8).standard_normal((20, 30, 1)).astype(np.float32)
    save_pfm(str(tmp_path / "port.pfm"), data)
    jax_save_pfm(str(tmp_path / "ref.pfm"), data)
    assert filecmp.cmp(tmp_path / "port.pfm", tmp_path / "ref.pfm", shallow=False)
    np.testing.assert_array_equal(jax_read_pfm(str(tmp_path / "port.pfm"))[0], data)
