"""File codecs of the unified MVS layout on numpy + PIL: images, `*_cam.txt`,
`pair.txt` and PFM maps, in the formats `patchmatchnet_tpu/dataio` reads
and writes (MVSNet/PatchmatchNet convention)."""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image


def read_image(path: str) -> np.ndarray:
    """Image as [H, W, 3] float32 in [0, 1] (grey images repeated to RGB)."""
    with Image.open(path) as im:
        image = np.asarray(im).astype(np.float32) / 255.0
    return np.repeat(image[:, :, None], 3, axis=2) if image.ndim == 2 else image


def save_image(path: str, image: np.ndarray) -> None:
    """Save a float image in [0, 1] as 8-bit."""
    Image.fromarray((image * 255).astype(np.uint8)).save(path)


def read_cam_file(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(intrinsics [3, 3], extrinsics [4, 4], depth params (min, max) or
    empty) of a cam.txt: "extrinsic", 4 rows, blank, "intrinsic", 3 rows,
    blank, "DEPTH_MIN DEPTH_MAX"."""
    with open(path) as f:
        lines = [line.rstrip() for line in f]
    extrinsics = np.array(" ".join(lines[1:5]).split(), np.float32).reshape(4, 4)
    intrinsics = np.array(" ".join(lines[7:10]).split(), np.float32).reshape(3, 3)
    depth_params = np.array(lines[11].split() if len(lines) >= 12 else [], np.float32)
    return intrinsics, extrinsics, depth_params


def save_cam_file(path: str, intrinsics: np.ndarray, extrinsics: np.ndarray,
                  depth_params: Sequence[float]) -> None:
    lines = ["extrinsic"]
    lines += [" ".join(repr(float(v)) for v in row)
              for row in np.asarray(extrinsics, np.float64).reshape(4, 4)]
    lines += ["", "intrinsic"]
    lines += [" ".join(repr(float(v)) for v in row)
              for row in np.asarray(intrinsics, np.float64).reshape(3, 3)]
    lines += ["", " ".join(repr(float(v)) for v in depth_params)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_pair_file(path: str) -> List[Tuple[int, List[int]]]:
    """(reference view, [source views]) per entry of a pair.txt, scores
    dropped; references without sources are skipped."""
    pairs = []
    with open(path) as f:
        for _ in range(int(f.readline())):
            ref = int(f.readline())
            srcs = [int(x) for x in f.readline().split()[1::2]]
            if srcs:
                pairs.append((ref, srcs))
    return pairs


def save_pair_file(path: str, pairs: Sequence[Tuple[int, Sequence[Tuple[int, float]]]]) -> None:
    """`pairs`: (reference view, [(source view, score), ...]) entries."""
    with open(path, "w") as f:
        f.write(f"{len(pairs)}\n")
        for ref, srcs in pairs:
            entries = "".join(f" {s} {score}" for s, score in srcs)
            f.write(f"{ref}\n{len(srcs)}{entries}\n")


def read_pfm(path: str) -> np.ndarray:
    """PFM map as [H, W, C] float32, C in {1, 3} (rows stored bottom-up,
    negative scale = little-endian)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"not a PFM file: {path!r}")
        channels = 3 if header == b"PF" else 1
        width, height = (int(v) for v in f.readline().split())
        endian = "<" if float(f.readline()) < 0 else ">"
        data = np.fromfile(f, dtype=endian + "f4")
    if data.size != width * height * channels:
        raise ValueError(f"PFM payload size mismatch in {path!r}")
    return np.flipud(data.reshape(height, width, channels)).astype(np.float32)


def save_pfm(path: str, depth_map: np.ndarray) -> None:
    """Write a float32 [H, W] map as a little-endian single-channel PFM."""
    if depth_map.dtype != np.float32 or depth_map.ndim != 2:
        raise ValueError("save_pfm writes float32 [H, W] maps")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(f"Pf\n{depth_map.shape[1]} {depth_map.shape[0]}\n-1.000000\n".encode())
        np.flipud(depth_map).astype("<f4").tofile(f)
