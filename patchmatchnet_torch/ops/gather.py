"""Gathers of the gather microbenchmarks (`patchmatchnet_torch/dev/bench_gather.py`).

They replace the Pallas kernels D1-D5 of `tools/dev/bench_gather.py`; the
CUDA kernels are `csrc/gather.cu`, whose source note says what bounds them
on the card and how they are laid out:

- `gather_lanes`: out[n, a, l] = win[n, a, idx[n, a, l]], the
  `take_along_axis` along lanes of `_pallas_lane_kernel` (D1 :96, D2 :112,
  D3 :145; the TPU block shapes are one function here).
- `gather_sublanes`: out[n, s, l] = win[n, idx[n, s, l], l] (D4 :180).
- `gather_rows`: out[n, p, :] = win[n, idx[n, p], :] (D5 :219, which the TPU
  computes as a one-hot matrix product), f32 or bf16 rows.

Indices are int32. The kernels assume them in range, as the tool draws
them; the plain versions raise on an index out of range. The plain versions
index explicitly and do not call `torch.gather`, the library call the
kernels are timed against.
"""

from __future__ import annotations

import torch

from patchmatchnet_torch.ops import cuda_build

_ROW_DTYPES = (torch.float32, torch.bfloat16)
_MAX_ELEMENTS = 2**31 - 1  # the kernels' index arithmetic is 32-bit
MAX_SUBLANES = 8  # gather_sublanes' kernel holds a block's rows in registers


def _check_index(idx: torch.Tensor, shape, size: int) -> None:
    """Raise unless `idx` is an int32 tensor of `shape` with values in [0, size)."""
    if idx.dtype != torch.int32:
        raise TypeError(f"index has dtype {idx.dtype}, expected torch.int32")
    if tuple(idx.shape) != tuple(shape):
        raise ValueError(f"index has shape {tuple(idx.shape)}, expected {tuple(shape)}")
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= size:
            raise IndexError(f"index out of range: [{lo}, {hi}] not in [0, {size})")


def gather_lanes_reference(win: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `gather_lanes`: the same arguments and result."""
    n, a, l = win.shape
    _check_index(idx, win.shape, l)
    ns = torch.arange(n, device=win.device)[:, None, None]
    rows = torch.arange(a, device=win.device)[None, :, None]
    return win[ns, rows, idx.long()]


def gather_sublanes_reference(win: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `gather_sublanes`: the same arguments and result."""
    n, s, l = win.shape
    _check_index(idx, win.shape, s)
    ns = torch.arange(n, device=win.device)[:, None, None]
    cols = torch.arange(l, device=win.device)[None, None, :]
    return win[ns, idx.long(), cols]


def gather_rows_reference(win: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `gather_rows`: the same arguments and result."""
    n, r, _ = win.shape
    if idx.dim() != 2:
        raise ValueError(f"index must be [N, P], got {tuple(idx.shape)}")
    _check_index(idx, (n, idx.shape[1]), r)
    return win[torch.arange(n, device=win.device)[:, None], idx.long()]


def _launch(name: str, win: torch.Tensor, idx: torch.Tensor, out_shape, *sizes) -> torch.Tensor:
    out = torch.empty(out_shape, dtype=win.dtype, device=win.device)
    lib = cuda_build.kernel_library()
    with torch.cuda.device(win.device):
        rc = getattr(lib, f"pmn_{name}")(win.data_ptr(), idx.data_ptr(), out.data_ptr(), *sizes,
                                         cuda_build.stream_handle(win.device))
    cuda_build.check_launch(name, rc)
    return out


def _check_block_gather(name: str, win: torch.Tensor, idx: torch.Tensor) -> None:
    dev = win.device
    cuda_build.check_cuda_tensor("win", win, dev, (torch.float32,), tuple(win.shape))
    cuda_build.check_cuda_tensor("idx", idx, dev, (torch.int32,), tuple(win.shape))
    if win.dim() != 3 or win.shape[2] % 4 or win.numel() > _MAX_ELEMENTS:
        raise ValueError(f"{name}: win must be [N, A, L] with L a multiple of 4 and fewer "
                         f"than 2^31 elements, got {tuple(win.shape)}")


def gather_lanes(win: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[n, a, l] = win[n, a, idx[n, a, l]].

    Args:
        win: [N, A, L] f32 (on CUDA, L a multiple of 4 and fewer than 2^31
            elements).
        idx: [N, A, L] int32 in [0, L).
    Returns:
        [N, A, L] f32.

    CPU tensors run the plain version; CUDA tensors launch the kernel, and
    anything the kernel does not take raises.
    """
    if win.device.type == "cpu":
        return gather_lanes_reference(win, idx)
    _check_block_gather("gather_lanes", win, idx)
    return _launch("gather_lanes", win, idx, win.shape, *win.shape)


def gather_sublanes(win: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[n, s, l] = win[n, idx[n, s, l], l].

    Args:
        win: [N, S, L] f32 (on CUDA, S <= 8, L a multiple of 4 and fewer
            than 2^31 elements).
        idx: [N, S, L] int32 in [0, S).
    Returns:
        [N, S, L] f32.

    CPU tensors run the plain version; CUDA tensors launch the kernel, and
    anything the kernel does not take raises.
    """
    if win.device.type == "cpu":
        return gather_sublanes_reference(win, idx)
    _check_block_gather("gather_sublanes", win, idx)
    if win.shape[1] > MAX_SUBLANES:
        raise ValueError(f"gather_sublanes: the kernel takes S <= {MAX_SUBLANES}, got "
                         f"{win.shape[1]}")
    return _launch("gather_sublanes", win, idx, win.shape, *win.shape)


def gather_rows(win: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[n, p, :] = win[n, idx[n, p], :].

    Args:
        win: [N, R, C] f32 or bf16 (on CUDA, rows of a multiple of 16 bytes:
            C a multiple of 4 in f32, of 8 in bf16; the table and the output
            hold fewer than 2^31 elements).
        idx: [N, P] int32 in [0, R).
    Returns:
        [N, P, C] of win's dtype.

    CPU tensors run the plain version; CUDA tensors launch the kernel, and
    anything the kernel does not take raises.
    """
    if win.device.type == "cpu":
        return gather_rows_reference(win, idx)
    dev = win.device
    if win.dim() != 3 or idx.dim() != 2:
        raise ValueError(f"gather_rows: win must be [N, R, C] and idx [N, P], got "
                         f"{tuple(win.shape)} and {tuple(idx.shape)}")
    n, r, c = win.shape
    p = idx.shape[1]
    cuda_build.check_cuda_tensor("win", win, dev, _ROW_DTYPES, (n, r, c))
    cuda_build.check_cuda_tensor("idx", idx, dev, (torch.int32,), (n, p))
    if (c * win.element_size()) % 16:
        raise ValueError(f"gather_rows: rows of {c} x {win.element_size()} bytes are not a "
                         "multiple of 16 bytes")
    if max(n * r, n * p) * c > _MAX_ELEMENTS:
        raise ValueError("gather_rows: the table and the output must hold fewer than 2^31 "
                         "elements")
    bf16 = int(win.dtype == torch.bfloat16)
    return _launch("gather_rows", win, idx, (n, p, c), n, r, p, c, bf16)
