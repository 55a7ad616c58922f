"""The raw DTU training layout (`Rectified/`, `Depths_raw/`, `Cameras_1/`),
as the original PatchmatchNet's legacy trainer reads it (reference:
`patchmatchnet_tpu/data/dtu_legacy.py`).

Seven light indexes per view, cam files at 1/4 resolution (intrinsics x4),
the 1600x1200 ground-truth depth and visual mask taken to the 640x512
training images by a nearest 2x downsample and a centre crop, mask =
visual PNG > 10. `num_views` counts the reference view too, as in the
legacy trainer. The sample schema is `MVSDataset`'s, so `BatchLoader` and
the training driver take either dataset.

With `robust_train`, each sample's source views are a random choice seeded
by (seed, epoch, index), as `MVSDataset` draws them, so a resumed run sees
the views the uninterrupted run would have (the reference draws them from
the unseeded global generator).
"""

from __future__ import annotations

import os
import random
from typing import Any, Dict, List, Tuple

import numpy as np
from PIL import Image

from patchmatchnet_torch.data.codecs import read_cam_file, read_image, read_map, read_pair_file

NUM_LIGHT_IDX = 7
CROP_H, CROP_W = 512, 640
_EPOCH_STRIDE = 1000003


def prepare_hr_image(hr_img: np.ndarray) -> np.ndarray:
    """Nearest 2x downsample, then the centre 512x640 crop: [H, W] ->
    [512, 640]."""
    ds = hr_img[::2, ::2]
    h, w = ds.shape
    top, left = (h - CROP_H) // 2, (w - CROP_W) // 2
    return ds[top:top + CROP_H, left:left + CROP_W]


def read_mask_hr(filename: str) -> np.ndarray:
    """The 640x512 mask of a 1600x1200 visual depth PNG (levels > 10)."""
    with Image.open(filename) as im:
        raw = (np.array(im, dtype=np.float32) > 10).astype(np.float32)
    return prepare_hr_image(raw) > 0


def read_depth_hr(filename: str) -> np.ndarray:
    """The 640x512 ground-truth depth of a 1600x1200 depth map."""
    return prepare_hr_image(read_map(filename)[:, :, 0]).astype(np.float32)


class DTULegacyDataset:
    """Raw DTU training samples of the scans in `list_file`: every
    (scan, light, reference) with the reference's first `num_views` - 1
    sources of `Cameras_1/pair.txt`, or a seeded random choice of them
    under `robust_train`."""

    def __init__(self, data_path: str, list_file: str, num_views: int = 5,
                 robust_train: bool = False, seed: int = 0):
        self.data_path = data_path
        self.num_views = num_views
        self.robust_train = robust_train
        self.seed = seed
        self.epoch = 0  # set by BatchLoader.set_epoch
        with open(list_file) as f:
            scans = [line.rstrip() for line in f]
        pairs = read_pair_file(os.path.join(data_path, "Cameras_1", "pair.txt"))
        self.metas: List[Tuple[str, int, int, List[int]]] = [
            (scan, light, ref, srcs) for scan in scans for light in range(NUM_LIGHT_IDX)
            for ref, srcs in pairs]

    def __len__(self) -> int:
        return len(self.metas)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        scan, light, ref_view, src_views = self.metas[idx]
        if self.robust_train:
            rng = random.Random((self.seed + _EPOCH_STRIDE * self.epoch) * _EPOCH_STRIDE + idx)
            chosen = rng.sample(range(len(src_views)), self.num_views - 1)
            view_ids = [ref_view] + [src_views[i] for i in chosen]
        else:
            view_ids = [ref_view] + src_views[:self.num_views - 1]
        root = self.data_path
        images, intrinsics, extrinsics = [], [], []
        for i, vid in enumerate(view_ids):
            # image file names count views from 1
            images.append(read_image(os.path.join(
                root, "Rectified", f"{scan}_train", f"rect_{vid + 1:03d}_{light}_r5000.png")))
            intrinsic, extrinsic, depth_params = read_cam_file(
                os.path.join(root, "Cameras_1", "train", f"{vid:08d}_cam.txt"))
            intrinsic = intrinsic.copy()
            intrinsic[:2, :] *= 4.0  # the cam files are at 1/4 resolution
            intrinsics.append(intrinsic)
            extrinsics.append(extrinsic)
            if i == 0:
                depth_min, depth_max = float(depth_params[0]), float(depth_params[1])
        depth_dir = os.path.join(root, "Depths_raw", scan)
        return {
            "images": np.stack(images),  # [N, 512, 640, 3]
            "intrinsics": np.stack(intrinsics),
            "extrinsics": np.stack(extrinsics),
            "depth_min": np.float32(depth_min),
            "depth_max": np.float32(depth_max),
            "depth_gt": read_depth_hr(os.path.join(depth_dir, f"depth_map_{ref_view:04d}.pfm")),
            "mask": read_mask_hr(os.path.join(depth_dir, f"depth_visual_{ref_view:04d}.png")),
            "filename": os.path.join(scan, "{}", f"{ref_view:08d}" + "{}"),
        }
