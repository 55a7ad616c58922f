"""The port's host library (`patchmatchnet_torch/native.py`, g++-built from
`patchmatchnet_torch/csrc/hostops.cpp`) on the CPU: each function equal to
the bit (max |diff| 0, tolerance 0) to its numpy twin and to the JAX
package's own host library (`patchmatchnet_tpu.native`, compared where it
loads) on seeded inputs: shrinks at ETH3D's and DTU's ratios, an upscale,
odd sizes, C = 1 and 3, the batch at 1 and 4 threads, u8 at all 256 levels
and the vertical flip; the image path's outputs in C order. Builds run in a copy of the module and its source:
two processes that build at once load one library, and a failed build or a
missing compiler raises."""

import importlib.util
import shutil
import subprocess
import sys

import numpy as np
import pytest

from patchmatchnet_torch import native
from patchmatchnet_torch.data import (
    adjust_sample_dims,
    read_image,
    read_map,
    save_image,
    save_map,
    scale_to_max_dim,
)
from patchmatchnet_tpu import native as jax_native

# (input shape, output size): ETH3D's 6048x4032 -> 2688x1792 ratio, DTU's
# 1600x1200 -> 1152x864, an upscale, odd sizes, C = 1, a 2-D map
RESIZE_CASES = [
    ((63, 94, 3), (28, 42)),
    ((75, 100, 3), (54, 72)),
    ((16, 24, 3), (32, 48)),
    ((37, 53, 1), (20, 31)),
    ((41, 29, 3), (17, 23)),
    ((21, 35), (9, 15)),
]


def _images(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_version():
    assert native.get_lib().hostops_version() == 1
    assert native.library_path().is_file()


@pytest.mark.parametrize("shape,size", RESIZE_CASES)
def test_resize_equals_twin_and_jax_library(shape, size):
    image = _images(shape, sum(shape))
    got = native.resize_bilinear(image, *size)
    assert got.shape == size + shape[2:] and got.dtype == np.float32
    np.testing.assert_array_equal(got, native.resize_bilinear_reference(image, *size))
    if jax_native.get_lib() is not None:
        np.testing.assert_array_equal(got, jax_native.resize_bilinear(image, *size))


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("shape,size", [((5, 63, 94, 3), (28, 42)),
                                        ((5, 37, 53, 1), (40, 56))])
def test_batch_resize_equals_twin_and_jax_library(shape, size, threads):
    images = _images(shape, threads)
    got = native.resize_bilinear_batch(images, *size, num_threads=threads)
    assert got.shape == shape[:1] + size + shape[3:]
    np.testing.assert_array_equal(got, native.resize_bilinear_batch_reference(images, *size))
    np.testing.assert_array_equal(got, np.stack([native.resize_bilinear(i, *size)
                                                 for i in images]))
    if jax_native.get_lib() is not None:
        np.testing.assert_array_equal(
            got, jax_native.resize_bilinear_batch(images, *size, num_threads=threads))


@pytest.mark.parametrize("shape", [(256,), (16, 16), (4, 8, 8, 3)])
def test_u8_to_f32_equals_twin_and_jax_library_at_all_levels(shape):
    levels = np.random.default_rng(7).permutation(np.tile(
        np.arange(256, dtype=np.uint8), int(np.prod(shape)) // 256)).reshape(shape)
    assert len(np.unique(levels)) == 256
    got = native.u8_to_f32(levels)
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, native.u8_to_f32_reference(levels))
    if jax_native.get_lib() is not None:
        np.testing.assert_array_equal(got, jax_native.u8_to_f32(levels))


def test_flip_vertical_equals_flipud_and_jax_library():
    """Bound with the rest; no path of either package calls it."""
    image = _images((13, 7, 3), 5)
    out = np.empty_like(image)
    native.get_lib().flip_vertical_f32(image, 13, 21, out)
    np.testing.assert_array_equal(out, np.flipud(image))
    jax_lib = jax_native.get_lib()
    if jax_lib is not None:
        want = np.empty_like(image)
        jax_lib.flip_vertical_f32(image, 13, 21, want)
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("path", ["scale_to_max_dim", "read_image", "read_map",
                                  "adjust_sample_dims"])
def test_image_path_returns_c_ordered_arrays(tmp_path, path):
    """What the image path shrinks or stretches comes back in C order, as
    from the JAX package's library (the numpy shrink returned a W-major
    array, and the estimator's maps depended on that layout)."""
    rng = np.random.default_rng(11)
    levels = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
    if path == "scale_to_max_dim":
        out = scale_to_max_dim(levels.astype(np.float32) / 255, 50)[0]
    elif path == "read_image":
        save_image(str(tmp_path / "im.png"), levels.astype(np.float32) / 255)
        out = read_image(str(tmp_path / "im.png"), 50)
    elif path == "read_map":
        save_map(str(tmp_path / "d.pfm"), rng.random((45, 70), dtype=np.float32))
        out = read_map(str(tmp_path / "d.pfm"), 50)
    else:
        sample = {"images": rng.random((3, 45, 70, 3), dtype=np.float32),
                  "intrinsics": np.tile(np.eye(3, dtype=np.float32), (3, 1, 1))}
        out = adjust_sample_dims(sample)["images"]
    assert out.shape[:2] in ((32, 50), (3, 48)) and out.flags["C_CONTIGUOUS"]


@pytest.mark.parametrize("call", ["resize_f64", "resize_1d", "batch_3d", "u8_f32", "empty"])
def test_wrappers_refuse_what_the_library_cannot_take(call):
    with pytest.raises(ValueError):
        if call == "resize_f64":
            native.resize_bilinear(np.zeros((4, 4, 3)), 2, 2)
        elif call == "resize_1d":
            native.resize_bilinear(np.zeros(4, np.float32), 2, 2)
        elif call == "batch_3d":
            native.resize_bilinear_batch(np.zeros((4, 4, 3), np.float32), 2, 2)
        elif call == "u8_f32":
            native.u8_to_f32(np.zeros(4, np.float32))
        else:
            native.resize_bilinear(np.zeros((4, 4, 3), np.float32), 0, 2)


def _copy(tmp_path, source=None):
    """native.py and its source in a fresh tree (its own build/ directory)."""
    pkg = tmp_path / "patchmatchnet_torch"
    (pkg / "csrc").mkdir(parents=True)
    shutil.copy(native.__file__, pkg / "native.py")
    (pkg / "csrc" / "hostops.cpp").write_text(source or native.SOURCE.read_text())
    return pkg / "native.py"


def _load(path):
    spec = importlib.util.spec_from_file_location("hostops_copy", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_RACER = """
import importlib.util, os, sys, time
import numpy as np
spec = importlib.util.spec_from_file_location("hostops_copy", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print("ready", flush=True)
while not os.path.exists(sys.argv[2]):
    time.sleep(0.001)
image = np.arange(60, dtype=np.float32).reshape(5, 4, 3)
out = mod.resize_bilinear(image, 3, 2)
print(mod.library_path(), mod.build_seconds() is not None, out.tobytes().hex(), flush=True)
"""


def test_two_processes_building_at_once_load_one_library(tmp_path):
    path = _copy(tmp_path)
    go = tmp_path / "go"
    procs = [subprocess.Popen([sys.executable, "-c", _RACER, str(path), str(go)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    try:
        for proc in procs:
            assert proc.stdout.readline().strip() == "ready"
        go.touch()
        results = [proc.communicate(timeout=120) for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    for proc, (_, err) in zip(procs, results):
        assert proc.returncode == 0, err
    lines = [out.split() for out, _ in results]
    assert lines[0][0] == lines[1][0] and lines[0][2] == lines[1][2]
    image = np.arange(60, dtype=np.float32).reshape(5, 4, 3)
    assert lines[0][2] == native.resize_bilinear_reference(image, 3, 2).tobytes().hex()
    built = _load(path).library_path()
    assert str(built) == lines[0][0]
    assert built.is_relative_to(tmp_path / "build" / "hostops")
    assert sorted(p.name for p in built.parent.iterdir()) == ["libhostops.so"]


def test_failed_build_raises_with_compiler_output(tmp_path):
    module = _load(_copy(tmp_path, source="extern \"C\" int hostops_version() { return }\n"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on hostops.cpp(.|\n)*error"):
        module.u8_to_f32(np.zeros(3, np.uint8))
    assert not module.library_path().exists()
    assert not list(module.library_path().parent.iterdir())  # no partial file left


def test_missing_compiler_raises(tmp_path, monkeypatch):
    module = _load(_copy(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        module.get_lib()
