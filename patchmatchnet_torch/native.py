"""The port's host library (`csrc/hostops.cpp`), the counterpart of the JAX
package's `patchmatchnet_tpu/native.py`: the image path's bilinear resize
(one image, or a batch on threads), u8 -> f32 and a vertical flip, in C++.

g++ builds it at first use, never at import, into
`<repo>/build/hostops/<hash>/libhostops.so`, where the hash covers the
source and the flags; a finished build is reused by later processes, and
processes that build at once each write their own file and move it into
place. A missing compiler, a failed build or a failed load raises: there is
no fallback. The library is host code, so it serves CPU and CUDA runs alike.

Each function has a numpy twin (`*_reference`) of the same arithmetic, equal
to the bit; the tests hold the library against the twins.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "hostops.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "hostops"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread", "-Wall")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_seconds: Optional[float] = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / "libhostops.so"


def _build(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's host library (csrc/hostops.cpp) needs it")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    start = time.perf_counter()
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name} ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    finally:
        tmp.unlink(missing_ok=True)
    global _build_seconds
    _build_seconds = time.perf_counter() - start


def build_seconds() -> Optional[float]:
    """Seconds this process spent building the library (None: reused)."""
    return _build_seconds


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises if it cannot be built
    or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.is_file():
            _build(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"cannot load the host library {path}: {e}") from e
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        lib.resize_bilinear_f32.argtypes = [f32p, i64, i64, i64, f32p, i64, i64]
        lib.resize_bilinear_f32.restype = None
        lib.resize_bilinear_batch_f32.argtypes = [f32p, i64, i64, i64, i64, f32p, i64, i64,
                                                  ctypes.c_int]
        lib.resize_bilinear_batch_f32.restype = None
        lib.u8_to_f32_scale.argtypes = [u8p, i64, f32p]
        lib.u8_to_f32_scale.restype = None
        lib.flip_vertical_f32.argtypes = [f32p, i64, i64, f32p]
        lib.flip_vertical_f32.restype = None
        lib.hostops_version.argtypes = []
        lib.hostops_version.restype = ctypes.c_int
        _lib = lib
        return lib


def _check(array: np.ndarray, dtype, ndims: Tuple[int, ...], name: str) -> None:
    if array.dtype != dtype or array.ndim not in ndims:
        raise ValueError(f"{name} takes {np.dtype(dtype).name} arrays of "
                         f"{' or '.join(map(str, ndims))} dimensions, not {array.dtype} "
                         f"{array.shape}")


def _check_sizes(h: int, w: int, out_h: int, out_w: int) -> None:
    if min(h, w, out_h, out_w) < 1:
        raise ValueError(f"resize from {h}x{w} to {out_h}x{out_w}: sizes must be positive")


def resize_bilinear(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """float32 (H, W[, C]) -> (out_h, out_w[, C]), bilinear with half-pixel
    centres (cv2.INTER_LINEAR convention), no antialiasing."""
    _check(image, np.float32, (2, 3), "resize_bilinear")
    img = np.ascontiguousarray(image[:, :, None] if image.ndim == 2 else image)
    h, w, c = img.shape
    _check_sizes(h, w, out_h, out_w)
    out = np.empty((out_h, out_w, c), np.float32)
    get_lib().resize_bilinear_f32(img, h, w, c, out, out_h, out_w)
    return out[:, :, 0] if image.ndim == 2 else out


def resize_bilinear_batch(images: np.ndarray, out_h: int, out_w: int,
                          num_threads: int = 4) -> np.ndarray:
    """float32 [N, H, W, C] -> [N, out_h, out_w, C], `resize_bilinear` of
    each image, the images shared among `num_threads` threads."""
    _check(images, np.float32, (4,), "resize_bilinear_batch")
    imgs = np.ascontiguousarray(images)
    n, h, w, c = imgs.shape
    _check_sizes(h, w, out_h, out_w)
    out = np.empty((n, out_h, out_w, c), np.float32)
    get_lib().resize_bilinear_batch_f32(imgs, n, h, w, c, out, out_h, out_w, num_threads)
    return out


def u8_to_f32(image: np.ndarray) -> np.ndarray:
    """uint8 levels of any shape -> float32 x * f32(1/255)."""
    if image.dtype != np.uint8:
        raise ValueError(f"u8_to_f32 takes uint8 arrays, not {image.dtype}")
    img = np.ascontiguousarray(image)
    out = np.empty(img.shape, np.float32)
    get_lib().u8_to_f32_scale(img.reshape(-1), img.size, out.reshape(-1))
    return out


def _resize_axis(size: int, out: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Source indices (i0, i1) and f32 weights of one axis: half-pixel
    centres in f64, clamped to the image, truncated to the lower index."""
    s = (np.arange(out, dtype=np.float64) + 0.5) * (size / out) - 0.5
    s = np.clip(s, 0.0, size - 1.0)
    i0 = s.astype(np.int64)
    return i0, np.minimum(i0 + 1, size - 1), (s - i0).astype(np.float32)


def resize_bilinear_batch_reference(images: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """numpy twin of `resize_bilinear_batch`, to the bit: f64 source
    coordinates, f32 weights, and in f32 `top = p00 + (p01 - p00) * fx`,
    the same below, then `top + (bot - top) * fy`."""
    _check(images, np.float32, (4,), "resize_bilinear_batch_reference")
    y0, y1, fy = _resize_axis(images.shape[1], out_h)
    x0, x1, fx = _resize_axis(images.shape[2], out_w)
    fx, fy = fx[None, None, :, None], fy[None, :, None, None]
    rows0, rows1 = images[:, y0], images[:, y1]
    top = rows0[:, :, x0] + (rows0[:, :, x1] - rows0[:, :, x0]) * fx
    bot = rows1[:, :, x0] + (rows1[:, :, x1] - rows1[:, :, x0]) * fx
    return top + (bot - top) * fy


def resize_bilinear_reference(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """numpy twin of `resize_bilinear`, to the bit."""
    _check(image, np.float32, (2, 3), "resize_bilinear_reference")
    img = image[:, :, None] if image.ndim == 2 else image
    out = resize_bilinear_batch_reference(img[None], out_h, out_w)[0]
    return out[:, :, 0] if image.ndim == 2 else out


def u8_to_f32_reference(image: np.ndarray) -> np.ndarray:
    """numpy twin of `u8_to_f32`, to the bit."""
    return image.astype(np.float32) * np.float32(1 / 255)
