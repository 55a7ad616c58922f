"""COLMAP sparse-model codecs (cameras / images / points3D, text + binary)
and quaternion utilities: the port of `patchmatchnet_tpu/tools/colmap_model.py`,
which the two COLMAP tools read and write through.

Format definitions follow COLMAP's src/base/reconstruction.cc (same formats
the reference parses — reference: colmap_input.py:70-232). Implementation is
numpy-vectorized where the payloads are large (binary point/track parsing).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

# model_name -> (model_id, num_params)
CAMERA_MODELS: Dict[str, Tuple[int, int]] = {
    "SIMPLE_PINHOLE": (0, 3),
    "PINHOLE": (1, 4),
    "SIMPLE_RADIAL": (2, 4),
    "RADIAL": (3, 5),
    "OPENCV": (4, 8),
    "OPENCV_FISHEYE": (5, 8),
    "FULL_OPENCV": (6, 12),
    "FOV": (7, 5),
    "SIMPLE_RADIAL_FISHEYE": (8, 4),
    "RADIAL_FISHEYE": (9, 5),
    "THIN_PRISM_FISHEYE": (10, 12),
}
MODEL_ID_TO_NAME = {mid: name for name, (mid, _) in CAMERA_MODELS.items()}

# parameter names per model (for intrinsics extraction)
PARAM_NAMES: Dict[str, List[str]] = {
    "SIMPLE_PINHOLE": ["f", "cx", "cy"],
    "PINHOLE": ["fx", "fy", "cx", "cy"],
    "SIMPLE_RADIAL": ["f", "cx", "cy", "k"],
    "SIMPLE_RADIAL_FISHEYE": ["f", "cx", "cy", "k"],
    "RADIAL": ["f", "cx", "cy", "k1", "k2"],
    "RADIAL_FISHEYE": ["f", "cx", "cy", "k1", "k2"],
    "OPENCV": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"],
    "OPENCV_FISHEYE": ["fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"],
    "FULL_OPENCV": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "k4", "k5", "k6"],
    "FOV": ["fx", "fy", "cx", "cy", "omega"],
    "THIN_PRISM_FISHEYE": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "k4", "sx1", "sy1"],
}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: List[float]

    def intrinsics(self) -> np.ndarray:
        """3x3 K matrix (distortion parameters, if any, are dropped)."""
        names = PARAM_NAMES[self.model]
        p = dict(zip(names, self.params))
        fx = p.get("fx", p.get("f"))
        fy = p.get("fy", p.get("f"))
        return np.array(
            [[fx, 0, p["cx"]], [0, fy, p["cy"]], [0, 0, 1]], dtype=np.float64
        )


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) w, x, y, z
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    point3d_ids: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))

    def extrinsics(self) -> np.ndarray:
        e = np.eye(4, dtype=np.float64)
        e[:3, :3] = quaternion_to_rotation(self.qvec)
        e[:3, 3] = self.tvec
        return e


@dataclass
class ColmapPoints:
    """Structure-of-arrays 3D point set."""

    ids: np.ndarray  # (P,) int64
    xyz: np.ndarray  # (P, 3) float64
    rgb: np.ndarray  # (P, 3) uint8
    error: np.ndarray  # (P,)

    def index_of(self) -> Dict[int, int]:
        return {int(pid): i for i, pid in enumerate(self.ids)}


def quaternion_to_rotation(qvec) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion to rotation matrix."""
    w, x, y, z = (float(v) for v in qvec)
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotation_to_quaternion(rot: np.ndarray) -> np.ndarray:
    """Rotation matrix to COLMAP (w, x, y, z) quaternion (w >= 0)."""
    rxx, ryx, rzx, rxy, ryy, rzy, rxz, ryz, rzz = np.asarray(rot, np.float64).flat
    k = (
        np.array(
            [
                [rxx - ryy - rzz, 0, 0, 0],
                [ryx + rxy, ryy - rxx - rzz, 0, 0],
                [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0],
                [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz],
            ]
        )
        / 3.0
    )
    eigenvalues, eigenvectors = np.linalg.eigh(k)
    qvec = eigenvectors[[3, 0, 1, 2], np.argmax(eigenvalues)]
    if qvec[0] < 0:
        qvec = -qvec
    return qvec


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------


def _data_lines(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cameras = {}
    for line in _data_lines(path):
        el = line.split()
        cameras[int(el[0])] = ColmapCamera(
            int(el[0]), el[1], int(el[2]), int(el[3]), [float(x) for x in el[4:]]
        )
    return cameras


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            cam_id, model_id, width, height = struct.unpack("<iiQQ", f.read(24))
            name = MODEL_ID_TO_NAME[model_id]
            n = CAMERA_MODELS[name][1]
            params = list(struct.unpack(f"<{n}d", f.read(8 * n)))
            cameras[cam_id] = ColmapCamera(cam_id, name, width, height, params)
    return cameras


def read_images_text(path: str) -> List[ColmapImage]:
    images = []
    with open(path) as f:
        raw = [ln.rstrip("\n") for ln in f if not ln.startswith("#")]
    # images come in line PAIRS: pose line + points2D line (may be blank)
    i = 0
    while i < len(raw):
        if not raw[i].strip():
            i += 1
            continue
        el = raw[i].split()
        img = ColmapImage(
            int(el[0]),
            np.array([float(x) for x in el[1:5]]),
            np.array([float(x) for x in el[5:8]]),
            int(el[8]),
            el[9],
        )
        i += 1
        if i < len(raw):
            pts = raw[i].split()
            img.point3d_ids = (
                np.array(pts[2::3], dtype=np.int64) if pts else np.empty(0, np.int64)
            )
            i += 1
        images.append(img)
    return images


def read_images_binary(path: str) -> List[ColmapImage]:
    images = []
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            vals = struct.unpack("<idddddddi", f.read(64))
            im_id, cam_id = vals[0], vals[8]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            name_bytes = bytearray()
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name_bytes += c
            (n2d,) = struct.unpack("<Q", f.read(8))
            raw = np.frombuffer(f.read(24 * n2d), dtype="<f8").reshape(n2d, 3)
            p3d = raw[:, 2].view(np.int64).copy() if n2d else np.empty(0, np.int64)
            images.append(
                ColmapImage(im_id, qvec, tvec, cam_id, name_bytes.decode("utf-8"), p3d)
            )
    return images


def read_points3d_text(path: str) -> ColmapPoints:
    ids, xyz, rgb, err = [], [], [], []
    for line in _data_lines(path):
        el = line.split()
        ids.append(int(el[0]))
        xyz.append([float(x) for x in el[1:4]])
        rgb.append([int(x) for x in el[4:7]])
        err.append(float(el[7]))
    return ColmapPoints(
        np.asarray(ids, np.int64),
        np.asarray(xyz, np.float64).reshape(-1, 3),
        np.asarray(rgb, np.uint8).reshape(-1, 3),
        np.asarray(err, np.float64),
    )


def read_points3d_binary(path: str) -> ColmapPoints:
    ids, xyz, rgb, err = [], [], [], []
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            vals = struct.unpack("<QdddBBBd", f.read(43))
            ids.append(vals[0])
            xyz.append(vals[1:4])
            rgb.append(vals[4:7])
            err.append(vals[7])
            (track_len,) = struct.unpack("<Q", f.read(8))
            f.seek(8 * track_len, os.SEEK_CUR)
    return ColmapPoints(
        np.asarray(ids, np.int64),
        np.asarray(xyz, np.float64).reshape(-1, 3),
        np.asarray(rgb, np.uint8).reshape(-1, 3),
        np.asarray(err, np.float64),
    )


def read_model(path: str, ext: str = ".bin"):
    """Read a COLMAP sparse model directory (.bin or .txt)."""
    if ext == ".txt":
        return (
            read_cameras_text(os.path.join(path, "cameras.txt")),
            read_images_text(os.path.join(path, "images.txt")),
            read_points3d_text(os.path.join(path, "points3D.txt")),
        )
    return (
        read_cameras_binary(os.path.join(path, "cameras.bin")),
        read_images_binary(os.path.join(path, "images.bin")),
        read_points3d_binary(os.path.join(path, "points3D.bin")),
    )


# ---------------------------------------------------------------------------
# Text writers (for exporting a minimal sparse model)
# ---------------------------------------------------------------------------


def write_cameras_text(path: str, cameras: List[ColmapCamera]) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write(f"# Number of cameras: {len(cameras)}\n")
        for c in cameras:
            params = " ".join(str(p) for p in c.params)
            f.write(f"{c.id} {c.model} {c.width} {c.height} {params}\n")


def write_images_text(path: str, images: List[ColmapImage]) -> None:
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        f.write(f"# Number of images: {len(images)}, mean observations per image: 0\n")
        for i in images:
            q, t = i.qvec, i.tvec
            f.write(
                f"{i.id} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]} "
                f"{i.camera_id} {i.name}\n\n"
            )


def write_points3d_text(path: str) -> None:
    """Empty points3D file (we carry no sparse points when exporting)."""
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        f.write("# Number of points: 0, mean track length: 0")
