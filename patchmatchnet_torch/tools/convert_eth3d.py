"""ETH3D training data -> unified MVS layout: the port of
`patchmatchnet_tpu/tools/convert_eth3d.py`, writing the same files byte for
byte through `data.codecs`.

Capability parity with the reference converter (reference:
convert_eth3d_dataset.py): resolves images through index2prefix.txt, copies
cams/pair/images/GT depths, and derives masks from depth > 0.
"""

from __future__ import annotations

import argparse
import os
import shutil

from patchmatchnet_torch.data.codecs import read_image_dictionary, read_map, save_image


def convert_scan(input_folder: str, output_folder: str, scan: str) -> int:
    scan_path = os.path.join(output_folder, scan)
    cam_path = os.path.join(scan_path, "cams")
    depth_path = os.path.join(scan_path, "depth_gt")
    image_path = os.path.join(scan_path, "images")
    mask_path = os.path.join(scan_path, "masks")
    for p in (scan_path, cam_path, depth_path, image_path, mask_path):
        os.makedirs(p, exist_ok=True)

    input_cam_path = os.path.join(input_folder, scan, "cams")
    image_index = read_image_dictionary(os.path.join(input_cam_path, "index2prefix.txt"))
    shutil.copy(
        os.path.join(input_cam_path, "pair.txt"), os.path.join(scan_path, "pair.txt")
    )

    count = 0
    for cam_file in os.listdir(input_cam_path):
        if cam_file in ("index2prefix.txt", "pair.txt"):
            continue
        view_id = int(cam_file.split("_")[0])
        shutil.copy(
            os.path.join(input_cam_path, cam_file), os.path.join(cam_path, cam_file)
        )

        image_filename = os.path.join(input_folder, scan, "images", image_index[view_id])
        shutil.copy(image_filename, os.path.join(image_path, f"{view_id:08d}.png"))

        depth_gt_filename = os.path.join(input_folder, scan, "depths", image_index[view_id])
        depth_gt_filename = (
            os.path.splitext(depth_gt_filename.replace("_undistorted", ""))[0] + ".pfm"
        )
        shutil.copy(depth_gt_filename, os.path.join(depth_path, f"{view_id:08d}.pfm"))

        mask = (read_map(depth_gt_filename) > 0.0)[:, :, 0]
        save_image(os.path.join(mask_path, f"{view_id:08d}.png"), mask)
        count += 1
    return count


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert ETH3D training dataset to unified MVS format"
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
