"""File codecs of the unified MVS layout on numpy + PIL: images, `*_cam.txt`,
`pair.txt`, PFM and COLMAP `.bin` maps and binary PLY point clouds, in the
formats `patchmatchnet_tpu/dataio` reads and writes (MVSNet/PatchmatchNet
convention), and the shrink of images and maps to a longest side (through
the port's host library, `patchmatchnet_torch.native`)."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
from PIL import Image

from patchmatchnet_torch import native


def resize_bilinear_image(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """[H, W, C] float -> [height, width, C], bilinear with half-pixel
    centers in the arithmetic of the JAX package's numpy resize
    (`patchmatchnet_tpu/dataio/image.py` `resize_bilinear_np`), to the
    bit: f64 source coordinates, weights in the image's dtype, and
    `p00 * (1 - fx) + p01 * fx`, the same below, then `top * (1 - fy) +
    bot * fy`. The dataset sizes a source view to its reference with it."""
    in_h, in_w = image.shape[:2]
    if (in_h, in_w) == (height, width):
        return image
    yy = (np.arange(height, dtype=np.float64) + 0.5) * (in_h / height) - 0.5
    xx = (np.arange(width, dtype=np.float64) + 0.5) * (in_w / width) - 0.5
    yy, xx = np.clip(yy, 0.0, in_h - 1.0), np.clip(xx, 0.0, in_w - 1.0)
    y0, x0 = np.floor(yy).astype(np.int64), np.floor(xx).astype(np.int64)
    y1, x1 = np.minimum(y0 + 1, in_h - 1), np.minimum(x0 + 1, in_w - 1)
    wy = (yy - y0).astype(image.dtype)[:, None, None]
    wx = (xx - x0).astype(image.dtype)[None, :, None]
    top = image[y0][:, x0] * (1 - wx) + image[y0][:, x1] * wx
    bot = image[y1][:, x0] * (1 - wx) + image[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def scaled_dims(height: int, width: int, max_dim: int) -> Tuple[int, int]:
    """The (H, W) that `scale_to_max_dim` gives an H x W image, without it."""
    scale = max_dim / max(height, width)
    if 0 < scale < 1:
        return int(scale * height), int(scale * width)
    return height, width


def scale_to_max_dim(image: np.ndarray, max_dim: int) -> Tuple[np.ndarray, int, int]:
    """Shrink [H, W, C] so max(H, W) <= max_dim (never grows; max_dim <= 0
    keeps it). Returns (image, original height, original width)."""
    height, width = image.shape[:2]
    new_h, new_w = scaled_dims(height, width, max_dim)
    if (new_h, new_w) != (height, width):
        image = native.resize_bilinear(image, new_h, new_w)
    return image, height, width


def read_image(path: str, max_dim: int = -1, rgb: bool = True) -> np.ndarray:
    """Image as [H, W, 3] float32 in [0, 1] (grey images repeated to RGB;
    kept [H, W] with `rgb=False`, as the JAX package reads them), shrunk so
    max(H, W) <= max_dim. 8-bit levels decode as x * f32(1/255)
    (`native.u8_to_f32`), as the JAX package's host library decodes them."""
    with Image.open(path) as im:
        raw = np.asarray(im)
    if raw.dtype == np.uint8:
        image = native.u8_to_f32(raw)
    else:
        image = raw.astype(np.float32) / np.float32(255)
    if image.ndim == 2:
        if not rgb:
            return scale_to_max_dim(image[:, :, None], max_dim)[0][:, :, 0]
        image = np.repeat(image[:, :, None], 3, axis=2)
    return scale_to_max_dim(image, max_dim)[0]


def read_image_size(path: str) -> Tuple[int, int]:
    """(height, width) of an image from its header, without decoding it."""
    with Image.open(path) as im:
        width, height = im.size
    return height, width


def save_image(path: str, image: np.ndarray) -> None:
    """Save an image as 8-bit: bool masks as 0/255, floats in [0, 1] as
    (x * 255) truncated."""
    if image.dtype == bool:
        image = image.astype(np.uint8) * 255
    else:
        image = (image * 255).astype(np.uint8)
    Image.fromarray(image).save(path)


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


def read_image_dictionary(path: str) -> Dict[int, str]:
    """The `index -> image file name` entries of an ETH3D index2prefix.txt:
    a count, then one "index name" line per entry."""
    entries: Dict[int, str] = {}
    with open(path) as f:
        for _ in range(int(f.readline().strip())):
            parts = f.readline().strip().split(" ")
            entries[int(parts[0].strip())] = parts[1].strip()
    return entries


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
    """Write a float32 [H, W] or [H, W, 1] map as a little-endian
    single-channel PFM."""
    if depth_map.dtype != np.float32 or depth_map.shape[2:] not in ((), (1,)):
        raise ValueError("save_pfm writes float32 [H, W] or [H, W, 1] maps")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(f"Pf\n{depth_map.shape[1]} {depth_map.shape[0]}\n-1.000000\n".encode())
        np.flipud(depth_map).astype("<f4").tofile(f)


def read_bin(path: str) -> np.ndarray:
    """COLMAP dense map as [H, W, C] float32: an ASCII "W&H&C&" header, then
    float32 data in Fortran order over (W, H, C)."""
    with open(path, "rb") as f:
        header = b""
        while header.count(b"&") < 3:
            byte = f.read(1)
            if not byte:
                raise ValueError(f"truncated COLMAP bin header in {path!r}")
            header += byte
        width, height, channels = (int(v) for v in header.split(b"&")[:3])
        data = np.fromfile(f, "<f4")
    if data.size != width * height * channels:
        raise ValueError(f"COLMAP bin payload size mismatch in {path!r}")
    return np.ascontiguousarray(
        data.reshape((width, height, channels), order="F").transpose(1, 0, 2))


def save_bin(path: str, data: np.ndarray) -> None:
    """Write a float32 [H, W], [H, W, 1] or [H, W, 3] map as COLMAP .bin."""
    if data.dtype != np.float32:
        raise ValueError("COLMAP bin data dtype must be float32")
    if data.ndim == 2:
        data = data[:, :, None]
    if data.ndim != 3 or data.shape[2] not in (1, 3):
        raise ValueError("map must be HxW, HxWx1 or HxWx3")
    height, width, channels = data.shape
    with open(path, "wb") as f:
        f.write(f"{width}&{height}&{channels}&".encode("ascii"))
        data.transpose(1, 0, 2).reshape(-1, order="F").astype("<f4").tofile(f)


def read_map(path: str, max_dim: int = -1) -> np.ndarray:
    """A .pfm or .bin map as [H, W, C] float32, shrunk so max(H, W) <= max_dim."""
    if path.endswith(".bin"):
        data = read_bin(path)
    elif path.endswith(".pfm"):
        data = read_pfm(path)
    else:
        raise ValueError(f"map format of {path!r}: only .pfm and .bin are supported")
    return scale_to_max_dim(data, max_dim)[0]


def save_map(path: str, data: np.ndarray) -> None:
    """Write a float32 map as .pfm ([H, W]) or .bin, by the path's extension."""
    if path.endswith(".bin"):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        save_bin(path, data)
    elif path.endswith(".pfm"):
        save_pfm(path, data)
    else:
        raise ValueError(f"map format of {path!r}: only .pfm and .bin are supported")


_PLY_VERTEX = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                        ("red", "u1"), ("green", "u1"), ("blue", "u1")])
_PLY_TYPES = {b"float": "<f4", b"float32": "<f4", b"double": "<f8", b"uchar": "u1",
              b"uint8": "u1", b"int": "<i4", b"int32": "<i4"}


def save_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Write a coloured point cloud (xyz [N, 3] as float32, rgb [N, 3] as
    uint8) as a binary little-endian PLY with one vertex element."""
    xyz, rgb = np.asarray(xyz), np.asarray(rgb)
    if xyz.ndim != 2 or xyz.shape[1] != 3:
        raise ValueError("xyz must be (N, 3)")
    if rgb.shape != xyz.shape:
        raise ValueError("rgb must match xyz shape")
    vertices = np.empty(xyz.shape[0], _PLY_VERTEX)
    for i, name in enumerate(("x", "y", "z")):
        vertices[name] = xyz[:, i]
    for i, name in enumerate(("red", "green", "blue")):
        vertices[name] = rgb[:, i].astype(np.uint8)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {xyz.shape[0]}"]
    header += [f"property float {c}" for c in "xyz"]
    header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header += ["end_header"]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        vertices.tofile(f)


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(xyz [N, 3] float32, rgb [N, 3] uint8, zeros without colour) of a
    binary little-endian PLY whose only element is `vertex`."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a PLY file: {path!r}")
        if b"binary_little_endian" not in f.readline():
            raise ValueError("only binary little-endian PLY is supported")
        n, props = 0, []
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected end of file in the PLY header")
            parts = line.split()
            if parts[0] == b"end_header":
                break
            if parts[0] == b"element":
                if parts[1] != b"vertex":
                    raise ValueError("only vertex-only PLY files are supported")
                n = int(parts[2])
            elif parts[0] == b"property":
                props.append((parts[2].decode("ascii"), _PLY_TYPES[parts[1]]))
        data = np.fromfile(f, dtype=np.dtype(props), count=n)
    xyz = np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float32)
    if "red" in data.dtype.names:
        rgb = np.stack([data["red"], data["green"], data["blue"]], axis=1).astype(np.uint8)
    else:
        rgb = np.zeros((n, 3), np.uint8)
    return xyz, rgb
