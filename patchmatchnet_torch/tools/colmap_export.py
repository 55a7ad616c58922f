"""Unified MVS reconstruction -> COLMAP MVS workspace (for COLMAP's fusion):
the port of `patchmatchnet_tpu/tools/colmap_export.py`, writing the same
files byte for byte through `data.codecs`.

Capability parity with the reference exporter (reference: colmap_output.py):
copies depth/confidence maps as `.geometric.bin`, writes a minimal sparse
text model (PINHOLE cameras, quaternion poses, empty points3D) plus
patch-match.cfg / fusion.cfg.
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Dict, List, Tuple

import numpy as np
from PIL import Image as PilImage

from patchmatchnet_torch.data.codecs import read_cam_file, read_map, read_pair_file, save_map
from patchmatchnet_torch.tools.colmap_model import (
    ColmapCamera,
    ColmapImage,
    rotation_to_quaternion,
    write_cameras_text,
    write_images_text,
    write_points3d_text,
)


def create_output_dirs(path: str) -> None:
    for sub in (
        "",
        "images",
        "sparse",
        "stereo",
        "stereo/confidence_maps",
        "stereo/consistency_graphs",
        "stereo/depth_maps",
        "stereo/normal_maps",
    ):
        os.makedirs(os.path.join(path, sub), exist_ok=True)


def copy_maps(input_path: str, results_path: str, output_path: str) -> None:
    shutil.copytree(
        os.path.join(input_path, "images"),
        os.path.join(output_path, "images"),
        dirs_exist_ok=True,
    )
    depth_dir = os.path.join(results_path, "depth_est")
    ext = os.path.splitext(os.listdir(depth_dir)[0])[1]
    for image_file in os.listdir(os.path.join(input_path, "images")):
        name, _ = os.path.splitext(image_file)
        depth_in = os.path.join(depth_dir, name + ext)
        conf_in = os.path.join(results_path, "confidence", name + ext)
        depth_out = os.path.join(
            output_path, "stereo/depth_maps", image_file + ".geometric.bin"
        )
        conf_out = os.path.join(
            output_path, "stereo/confidence_maps", image_file + ".geometric.bin"
        )
        if ext == ".bin":
            shutil.copy(depth_in, depth_out)
            shutil.copy(conf_in, conf_out)
        else:
            save_map(depth_out, read_map(depth_in))
            save_map(conf_out, read_map(conf_in))


def read_reconstruction(
    path: str,
) -> Tuple[List[ColmapCamera], List[ColmapImage], List[Tuple[int, List[int]]]]:
    cameras: List[ColmapCamera] = []
    images: List[ColmapImage] = []
    for cam_file in sorted(os.listdir(os.path.join(path, "cams"))):
        im_id = int(cam_file.split("_")[0])
        im_file = cam_file.split("_")[0] + ".jpg"
        with PilImage.open(os.path.join(path, "images", im_file)) as image:
            width, height = image.width, image.height
        intrinsics, extrinsics, _ = read_cam_file(os.path.join(path, "cams", cam_file))
        cameras.append(
            ColmapCamera(
                im_id,
                "PINHOLE",
                width,
                height,
                [
                    float(intrinsics[0, 0]),
                    float(intrinsics[1, 1]),
                    float(intrinsics[0, 2]),
                    float(intrinsics[1, 2]),
                ],
            )
        )
        qvec = rotation_to_quaternion(extrinsics[:3, :3])
        images.append(
            ColmapImage(im_id, qvec, extrinsics[:3, 3].astype(np.float64), im_id, im_file)
        )
    return cameras, images, read_pair_file(os.path.join(path, "pair.txt"))


def write_patch_match_config(
    path: str, images: List[ColmapImage], pairs: List[Tuple[int, List[int]]]
) -> None:
    names: Dict[int, str] = {img.id: img.name for img in images}
    with open(path, "w") as f:
        for ref_id, src_ids in pairs:
            f.write(names[ref_id] + "\n")
            f.write(", ".join(names[s] for s in src_ids) + "\n")


def write_fusion_config(
    path: str, images: List[ColmapImage], pairs: List[Tuple[int, List[int]]]
) -> None:
    names: Dict[int, str] = {img.id: img.name for img in images}
    with open(path, "w") as f:
        f.writelines(
            ",".join(names[v] for v in [ref] + srcs) + "\n" for ref, srcs in pairs
        )


def write_sparse(path: str, cameras: List[ColmapCamera], images: List[ColmapImage]) -> None:
    write_cameras_text(os.path.join(path, "cameras.txt"), cameras)
    write_images_text(os.path.join(path, "images.txt"), images)
    write_points3d_text(os.path.join(path, "points3D.txt"))


def mvs_to_colmap(input_folder: str, results_folder: str, output_folder: str) -> None:
    """Export a full COLMAP MVS workspace from MVS inputs + our depth maps."""
    create_output_dirs(output_folder)
    copy_maps(input_folder, results_folder, output_folder)
    cams, ims, pairs = read_reconstruction(input_folder)
    write_patch_match_config(
        os.path.join(output_folder, "stereo/patch-match.cfg"), ims, pairs
    )
    write_fusion_config(os.path.join(output_folder, "stereo/fusion.cfg"), ims, pairs)
    write_sparse(os.path.join(output_folder, "sparse"), cams, ims)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Export results as a COLMAP MVS workspace"
    )
    parser.add_argument("--input_folder", type=str, required=True)
    parser.add_argument("--results_folder", type=str, default="")
    parser.add_argument("--output_folder", type=str, default="")
    args = parser.parse_args(argv)

    results = args.results_folder or args.input_folder
    output = args.output_folder or args.input_folder
    if not os.path.isdir(args.input_folder):
        raise FileNotFoundError(f"Invalid input folder: {args.input_folder}")
    mvs_to_colmap(args.input_folder, results, output)
    print(f"Exported COLMAP workspace -> {output}")


if __name__ == "__main__":
    main()
