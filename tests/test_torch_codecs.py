"""The port's map, PLY and image codecs against the JAX package's
(`patchmatchnet_tpu/dataio`): files written by either are byte-identical
and read back by the other; `read_map` dispatches by extension; images,
their header sizes and `scaled_dims` match. Shrunk images and maps are
compared at 1e-5: the port's bilinear shrink (`F.interpolate`) computes the
source coordinate in f32 where the JAX native resize uses f64 (an ulp of a
coordinate near 100 is 8e-6 px), and the random test images change by up
to 1 per pixel."""

import filecmp

import numpy as np
import pytest

from patchmatchnet_tpu.dataio import read_map as jax_read_map
from patchmatchnet_tpu.dataio import read_ply as jax_read_ply
from patchmatchnet_tpu.dataio import save_map as jax_save_map
from patchmatchnet_tpu.dataio import save_ply as jax_save_ply
from patchmatchnet_tpu.dataio.colmap_bin import read_bin as jax_read_bin
from patchmatchnet_tpu.dataio.colmap_bin import save_bin as jax_save_bin
from patchmatchnet_tpu.dataio.image import read_image as jax_read_image
from patchmatchnet_tpu.dataio.image import read_image_size as jax_read_image_size
from patchmatchnet_tpu.dataio.image import save_image as jax_save_image
from patchmatchnet_tpu.dataio.image import scaled_dims as jax_scaled_dims
from patchmatchnet_torch.data import (
    read_bin,
    read_image,
    read_image_size,
    read_map,
    read_ply,
    save_bin,
    save_image,
    save_map,
    save_ply,
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
    np.testing.assert_allclose(small, want, rtol=0, atol=1e-5)
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
    np.testing.assert_allclose(small, want, rtol=0, atol=1e-5)
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
