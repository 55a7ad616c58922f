"""COLMAP dense workspace -> unified MVS input layout: the port of
`patchmatchnet_tpu/tools/colmap_import.py`, writing the same files byte for
byte through `data.codecs`.

Capability parity with the reference importer (reference:
colmap_input.py:248-406): per-image intrinsics from the camera-model table,
extrinsics from quaternions, depth ranges from the 1%/99% percentiles of
sparse point depths, MVSNet-style pairwise view selection scored by
triangulation angle, and cams/ + pair.txt + renamed images output.

The O(N^2 x points) Python scoring loop of the reference is vectorized with
numpy (shared-point masks + batched angle computation).
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Dict, List, Tuple

import numpy as np

from patchmatchnet_torch.data.codecs import save_cam_file, save_pair_file
from patchmatchnet_torch.tools.colmap_model import (
    ColmapImage,
    ColmapPoints,
    read_model,
)


def compute_depth_ranges(
    images: List[ColmapImage], points: ColmapPoints, extrinsics: List[np.ndarray]
) -> List[Tuple[float, float]]:
    """Relaxed per-image depth range: 1%/99% percentile of visible sparse
    point depths (reference: colmap_input.py:319-334)."""
    idx_of = points.index_of()
    ranges = []
    for img, extr in zip(images, extrinsics):
        pids = [idx_of[int(p)] for p in img.point3d_ids if int(p) != -1 and int(p) in idx_of]
        if not pids:
            ranges.append((0.1, 100.0))
            continue
        xyz = points.xyz[pids]  # [M, 3]
        z = (xyz @ extr[2, :3]) + extr[2, 3]
        z_sorted = np.sort(z)
        lo = z_sorted[int(len(z) * 0.01)]
        hi = z_sorted[int(len(z) * 0.99)]
        ranges.append((float(lo), float(hi)))
    return ranges


def view_selection_scores(
    images: List[ColmapImage],
    points: ColmapPoints,
    extrinsics: List[np.ndarray],
    theta0: float = 5.0,
    sigma1: float = 1.0,
    sigma2: float = 10.0,
) -> np.ndarray:
    """Pairwise view-selection score matrix (reference: colmap_input.py:336-373):

        score(i, j) = sum over shared points p of
            exp(-(theta - theta0)^2 / (2 sigma^2)),  sigma = sigma1 if
            theta <= theta0 else sigma2,
        theta = triangulation angle at p between camera centers i and j.
    """
    n = len(images)
    idx_of = points.index_of()
    num_points = len(points.ids)

    member = np.zeros((n, num_points), dtype=bool)
    for i, img in enumerate(images):
        rows = [idx_of[int(p)] for p in img.point3d_ids if int(p) != -1 and int(p) in idx_of]
        member[i, rows] = True

    centers = np.stack(
        [-(e[:3, :3].T @ e[:3, 3]) for e in extrinsics]
    )  # [N, 3] camera centers in world

    score = np.zeros((n, n))
    for i in range(n):
        di = centers[i] - points.xyz  # [P, 3]
        ni = np.linalg.norm(di, axis=1)
        for j in range(i + 1, n):
            shared = member[i] & member[j]
            if not shared.any():
                continue
            dj = centers[j] - points.xyz[shared]
            cosang = np.einsum("pk,pk->p", di[shared], dj) / (
                ni[shared] * np.linalg.norm(dj, axis=1)
            )
            theta = np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))
            sigma = np.where(theta <= theta0, sigma1, sigma2)
            s = float(np.sum(np.exp(-((theta - theta0) ** 2) / (2 * sigma**2))))
            score[i, j] = score[j, i] = s
    return score


def colmap_to_mvs(
    input_folder: str,
    output_folder: str,
    num_src_images: int = -1,
    theta0: float = 5.0,
    sigma1: float = 1.0,
    sigma2: float = 10.0,
    convert_format: bool = False,
    model_ext: str = ".bin",
) -> int:
    """Convert a COLMAP workspace (images/ + sparse/) into the unified MVS
    layout (cams/, images/ renamed as %08d.jpg, pair.txt).

    Returns the number of images converted.
    """
    image_dir = os.path.join(input_folder, "images")
    model_dir = os.path.join(input_folder, "sparse")
    cam_dir = os.path.join(output_folder, "cams")
    renamed_dir = os.path.join(output_folder, "images")
    os.makedirs(cam_dir, exist_ok=True)
    os.makedirs(renamed_dir, exist_ok=True)

    cameras, images, points = read_model(model_dir, model_ext)
    num_images = len(images)

    intrinsics: Dict[int, np.ndarray] = {
        cid: cam.intrinsics() for cid, cam in cameras.items()
    }
    extrinsics = [img.extrinsics() for img in images]
    depth_ranges = compute_depth_ranges(images, points, extrinsics)
    score = view_selection_scores(images, points, extrinsics, theta0, sigma1, sigma2)

    if num_src_images < 0:
        num_src_images = num_images

    pairs = []
    for i in range(num_images):
        order = np.argsort(score[i])[::-1][:num_src_images]
        pairs.append((i, [(int(k), float(score[i, k])) for k in order]))

    for i, img in enumerate(images):
        save_cam_file(
            os.path.join(cam_dir, f"{i:08d}_cam.txt"),
            intrinsics[img.camera_id],
            extrinsics[i],
            depth_ranges[i],
        )

    save_pair_file(os.path.join(output_folder, "pair.txt"), pairs)

    for i, img in enumerate(images):
        src = os.path.join(image_dir, img.name)
        dst = os.path.join(renamed_dir, f"{i:08d}.jpg")
        if convert_format and os.path.splitext(img.name)[1].lower() not in (".jpg", ".jpeg"):
            from PIL import Image as PilImage

            PilImage.open(src).convert("RGB").save(dst)
        else:
            shutil.copyfile(src, dst)

    return num_images


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert COLMAP results into unified MVS input"
    )
    parser.add_argument("--input_folder", type=str, required=True)
    parser.add_argument("--output_folder", type=str, default="")
    parser.add_argument("--num_src_images", type=int, default=-1)
    parser.add_argument("--theta0", type=float, default=5)
    parser.add_argument("--sigma1", type=float, default=1)
    parser.add_argument("--sigma2", type=float, default=10)
    parser.add_argument("--convert_format", action="store_true", default=False)
    parser.add_argument("--model_ext", type=str, default=".bin", choices=[".bin", ".txt"])
    args = parser.parse_args(argv)

    if not os.path.isdir(args.input_folder):
        raise FileNotFoundError(f"Invalid input folder: {args.input_folder}")
    output = args.output_folder or args.input_folder
    n = colmap_to_mvs(
        args.input_folder,
        output,
        args.num_src_images,
        args.theta0,
        args.sigma1,
        args.sigma2,
        args.convert_format,
        args.model_ext,
    )
    print(f"Converted {n} images -> {output}")


if __name__ == "__main__":
    main()
