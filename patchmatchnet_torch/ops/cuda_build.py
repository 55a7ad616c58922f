"""Build and load the hand-written CUDA kernels in `patchmatchnet_torch/csrc/`.

Each `csrc/*.cu` file compiles in its own `nvcc` process, all started
together, and one more `nvcc` call links the objects into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), loaded with ctypes. The build runs at first use, never at import, into
`<repo>/build/kernels/<hash>/` where the hash covers the sources and the
flags; a finished build is reused by later processes.

Each kernel wrapper counts its launches here: `check_launch` adds one for
every successful kernel launch and nothing else does, so a run can show
which kernels its main path went through (`launch_counts`).
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
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (all return an int cudaError_t)
_SIGNATURES = {
    # src, ref, mat12, depth, out, B, D, H, W, Hs, Ws, C, G, bf16, stream
    "pmn_warp_group_corr": [_P, _P, _P, _P, _P] + [_I] * 9 + [_P],
    # ref, gx, gy, out, B, K, H, W, C, G, bf16, stream
    "pmn_neighbor_group_corr": [_P, _P, _P, _P] + [_I] * 7 + [_P],
    # src, ref, ix, iy, out, B, D, H, W, Hs, Ws, C, G, bf16, stream
    "pmn_coord_group_corr": [_P] * 5 + [_I] * 9 + [_P],
    # src, ref, mats, depth, vw, out, B, V, D, H, W, Hs, Ws, C, G, bf16, stream
    "pmn_warp_group_corr_views": [_P] * 6 + [_I] * 10 + [_P],
    # xnorm, cost, gx, gy, fw, out, B, K, H, W, D, inv_interval, cost_bf16, stream
    "pmn_eval_grid_score": [_P] * 6 + [_I] * 5 + [_F, _I, _P],
    # src, ref, mat12, depth, dout, d_src, d_ref, B, D, H, W, Hs, Ws, C, G, bf16, stream
    "pmn_warp_group_corr_backward": [_P] * 7 + [_I] * 9 + [_P],
    # ref, gx, gy, dout, d_gx, d_gy, B, K, H, W, C, G, bf16, stream
    "pmn_neighbor_group_corr_backward": [_P] * 6 + [_I] * 7 + [_P],
    # win, idx, out, N, A, L, stream
    "pmn_gather_lanes": [_P] * 3 + [_I] * 3 + [_P],
    # win, idx, out, N, S, L, stream
    "pmn_gather_sublanes": [_P] * 3 + [_I] * 3 + [_P],
    # win, idx, out, N, R, P, C, bf16, stream
    "pmn_gather_rows": [_P] * 3 + [_I] * 5 + [_P],
    # ref, src, mats, depth, out, B, V, D, H, W, C, bf16, stream
    "pmn_variance_volume": [_P] * 5 + [_I] * 7 + [_P],
    # x, weight, out, B, D, H, W, bf16, stream
    "pmn_prob_conv3d": [_P] * 3 + [_I] * 5 + [_P],
    # x, weight, gamma, beta, mean, var, skip, out, B, D, H, W, Do, Ho, Wo, cin, cout, mode,
    # bf16, stream
    "pmn_conv3d_block": [_P] * 8 + [_I] * 11 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_seconds: Optional[float] = None
_launches: Dict[str, int] = {}


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the kernels need the CUDA toolkit")
    return path


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + ("-shared",)).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / "libpmn_kernels.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = out.with_name(f"{out.name}.{tag}")
    start = time.perf_counter()
    sources = [p for p in _sources() if p.suffix == ".cu"]
    objects = [out.with_name(f"{p.stem}.{tag}.o") for p in sources]
    procs = [
        subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objects)
    ]
    logs = [proc.communicate()[0] for proc in procs]  # waits for every process
    try:
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
        link = subprocess.run([_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objects)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    (out.parent / "nvcc.log").write_text("".join(logs))
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    global _build_seconds
    _build_seconds = time.perf_counter() - start


def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use. Raises when CUDA or the
    toolkit is missing: there is no fallback for CUDA tensors."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: the kernels need an NVIDIA GPU")
        path = library_path()
        if not path.is_file():
            _build(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.pmn_error_string.argtypes = [ctypes.c_int]
        lib.pmn_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def build_seconds() -> Optional[float]:
    """Seconds the nvcc build took in this process (None if it was reused)."""
    return _build_seconds


def check_launch(name: str, rc: int) -> None:
    """Raise on a nonzero cudaError_t from a launch; count it otherwise."""
    if rc != 0:
        err = kernel_library().pmn_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {rc} ({err})")
    _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_kernel_device(name: str, device: torch.device) -> None:
    """Raise unless `device` is the CPU (plain version) or a CUDA device
    (kernel): the kernel ops would give a tensor elsewhere (such as on the
    meta device) only its shape."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"{name}: tensors must be on the CPU (plain version) or on a CUDA "
            f"device (kernel), got {device}"
        )


def check_cuda_tensor(name: str, t: torch.Tensor, device: torch.device,
                      dtypes: Tuple[torch.dtype, ...], shape: Tuple[int, ...]) -> None:
    """Raise unless `t` is a contiguous tensor of `shape` and one of `dtypes`
    on the CUDA `device`, 16-byte aligned (the kernels load 16-byte vectors)."""
    if device.type != "cuda":
        raise ValueError(
            f"{name}: tensors must be on the CPU (plain version) or on a CUDA "
            f"device (kernel), got {device}"
        )
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
