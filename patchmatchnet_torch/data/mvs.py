"""MVS scene index, sample loading and batching for inference (the
inference subset of `patchmatchnet_tpu/data/mvs.py`).

A sample stacks its views [N, H, W, 3] at one resolution, view 0 the
reference. `BatchLoader` adjusts (H, W) to multiples of 8 the way the
reference does (bilinear stretch, intrinsics rescaled, original size kept
under `orig_height` / `orig_width`) and prefetches on threads.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from patchmatchnet_torch.data.codecs import read_cam_file, read_image, read_pair_file


def _resize_bilinear(images: np.ndarray, height: int, width: int) -> np.ndarray:
    """[N, H, W, C] float32 -> [N, height, width, C], bilinear with
    half-pixel centers (cv2.INTER_LINEAR convention)."""
    nchw = torch.from_numpy(np.ascontiguousarray(images)).permute(0, 3, 1, 2)
    out = F.interpolate(nchw, size=(height, width), mode="bilinear", align_corners=False)
    return out.permute(0, 2, 3, 1).contiguous().numpy()


def adjust_sample_dims(sample: Dict[str, Any]) -> Dict[str, Any]:
    """Stretch the images to the nearest multiples of 8 (int(round(x / 8)) * 8)
    and rescale the intrinsics; records the original size."""
    height, width = sample["images"].shape[1:3]
    new_h, new_w = int(round(height / 8)) * 8, int(round(width / 8)) * 8
    out = dict(sample, orig_height=height, orig_width=width)
    if (new_h, new_w) != (height, width):
        out["images"] = _resize_bilinear(sample["images"], new_h, new_w)
        intrinsics = sample["intrinsics"].copy()
        intrinsics[:, 0] *= new_w / width
        intrinsics[:, 1] *= new_h / height
        out["intrinsics"] = intrinsics
    return out


class MVSDataset:
    """One scene in the unified layout: `images/{view:08d}{ext}`,
    `cams/{view:08d}_cam.txt`, `pair.txt`. Sample i is the i-th reference
    view of pair.txt with its first `num_views` sources."""

    def __init__(self, data_path: str, num_views: int, image_extension: str = ".jpg"):
        self.data_path = data_path
        self.num_views = num_views
        self.image_extension = image_extension
        self.metas = read_pair_file(os.path.join(data_path, "pair.txt"))

    def __len__(self) -> int:
        return len(self.metas)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.num_views]
        images, intrinsics, extrinsics = [], [], []
        for view in view_ids:
            image = read_image(os.path.join(
                self.data_path, "images", f"{view:08d}{self.image_extension}"))
            if images and image.shape != images[0].shape:
                raise ValueError(f"view {view} is {image.shape[:2]}, the reference "
                                 f"{images[0].shape[:2]}: views must share a size")
            intrinsic, extrinsic, depth_params = read_cam_file(
                os.path.join(self.data_path, "cams", f"{view:08d}_cam.txt"))
            if not images:
                depth_min, depth_max = float(depth_params[0]), float(depth_params[1])
            images.append(image)
            intrinsics.append(intrinsic)
            extrinsics.append(extrinsic)
        return {
            "images": np.stack(images),  # [N, H, W, 3]
            "intrinsics": np.stack(intrinsics),  # [N, 3, 3]
            "extrinsics": np.stack(extrinsics),  # [N, 4, 4]
            "depth_min": np.float32(depth_min),
            "depth_max": np.float32(depth_max),
            "filename": os.path.join("{}", f"{ref_view:08d}" + "{}"),
        }


def _stack_batch(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    return {k: [s[k] for s in samples] if isinstance(v, str)
            else np.stack([s[k] for s in samples])
            for k, v in samples[0].items()}


class BatchLoader:
    """Batches of adjusted samples in dataset order. With `num_threads` > 1
    a thread pool loads samples concurrently (PIL and numpy release the
    GIL), keeping up to `prefetch` batches in flight."""

    def __init__(self, dataset: MVSDataset, batch_size: int = 1, num_threads: int = 4,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_threads = max(1, num_threads)
        self.prefetch = max(1, prefetch)

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _load(self, idx: int) -> Dict[str, Any]:
        return adjust_sample_dims(self.dataset[idx])

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        n = len(self.dataset)
        batches: List[range] = [range(i, min(i + self.batch_size, n))
                                for i in range(0, n, self.batch_size)]
        if self.num_threads == 1:
            for batch in batches:
                yield _stack_batch([self._load(i) for i in batch])
            return
        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            pending: deque = deque()
            for batch in batches:
                pending.append([pool.submit(self._load, i) for i in batch])
                if len(pending) == self.prefetch:
                    yield _stack_batch([f.result() for f in pending.popleft()])
            while pending:
                yield _stack_batch([f.result() for f in pending.popleft()])
