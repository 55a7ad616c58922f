"""Raw DTU training data -> unified MVS layout: the port of
`patchmatchnet_tpu/tools/convert_dtu.py`, writing the same files byte for
byte through `data.codecs` (the depth maps and masks shrunk by its resize,
which follows the JAX package's to the bit).

Capability parity with the reference converter (reference:
convert_dtu_dataset.py): intrinsics x4 to match training image size, GT
depth resized to max-dim 800 then cropped [44:556, 80:720], mask from the
visual PNG > 0.04, 7 light-index image folders.
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
from PIL import Image

from patchmatchnet_torch.data.codecs import read_image, read_map, save_image, save_map

NUM_LIGHT_IDX = 7
DEPTH_CROP = (slice(44, 556), slice(80, 720))


def convert_scan(input_folder: str, output_folder: str, scan: str) -> int:
    scan_path = os.path.join(output_folder, scan)
    cam_path = os.path.join(scan_path, "cams")
    depth_path = os.path.join(scan_path, "depth_gt")
    image_path = os.path.join(scan_path, "images")
    mask_path = os.path.join(scan_path, "masks")
    for p in (scan_path, cam_path, depth_path, image_path, mask_path):
        os.makedirs(p, exist_ok=True)

    shutil.copy(
        os.path.join(input_folder, "Cameras_1/pair.txt"),
        os.path.join(scan_path, "pair.txt"),
    )

    count = 0
    for cam_file in os.listdir(os.path.join(input_folder, "Cameras_1/train")):
        view_id = int(cam_file.split("_")[0])

        # intrinsics x4 (cameras are given at 1/4 of the training image size)
        with open(os.path.join(input_folder, "Cameras_1/train", cam_file)) as f:
            lines = [line.rstrip() for line in f.readlines()]
        for row in (7, 8):
            vals = np.fromstring(lines[row], dtype=np.float32, sep=" ") * 4.0
            lines[row] = "{} {} {}".format(*vals)
        with open(os.path.join(cam_path, cam_file), "w") as f:
            f.write("\n".join(lines) + "\n")

        depth_map = read_map(
            os.path.join(
                input_folder, "Depths_raw", scan, f"depth_map_{view_id:04d}.pfm"
            ),
            800,
        )
        depth_map = depth_map[DEPTH_CROP]
        save_map(os.path.join(depth_path, f"{view_id:08d}.pfm"), depth_map)

        mask = read_image(
            os.path.join(
                input_folder, "Depths_raw", scan, f"depth_visual_{view_id:04d}.png"
            ),
            800,
            rgb=False,
        )
        mask = mask[DEPTH_CROP] > 0.04
        save_image(os.path.join(mask_path, f"{view_id:08d}.png"), mask)

        for light_idx in range(NUM_LIGHT_IDX):
            light_dir = os.path.join(image_path, str(light_idx))
            os.makedirs(light_dir, exist_ok=True)
            image = Image.open(
                os.path.join(
                    input_folder,
                    f"Rectified/{scan}_train/rect_{view_id + 1:03d}_{light_idx}_r5000.png",
                )
            )
            image.save(os.path.join(light_dir, f"{view_id:08d}.jpg"))
        count += 1
    return count


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert raw DTU training dataset to unified MVS format"
    )
    parser.add_argument("--input_folder", type=str, required=True)
    parser.add_argument("--output_folder", type=str, required=True)
    parser.add_argument("--scan_list", type=str, required=True)
    args = parser.parse_args(argv)

    if not os.path.isdir(args.input_folder):
        raise FileNotFoundError(f"Invalid input folder: {args.input_folder}")
    if not os.path.isfile(args.scan_list):
        raise FileNotFoundError(f"Invalid scan list: {args.scan_list}")
    os.makedirs(args.output_folder, exist_ok=True)

    with open(args.scan_list) as f:
        scans = [line.rstrip() for line in f.readlines()]
    for scan in scans:
        n = convert_scan(args.input_folder, args.output_folder, scan)
        print(f"{scan}: {n} views")


if __name__ == "__main__":
    main()
