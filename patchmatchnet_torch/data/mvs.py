"""MVS scene index, sample loading and batching (reference:
`patchmatchnet_tpu/data/mvs.py`).

A sample stacks its views [N, H, W, 3] at one resolution, view 0 the
reference (a source of another size, such as a portrait view among
landscape ones, is resized to the reference's with its intrinsics
rescaled, as the reference does), with the reference view's ground-truth depth and the mask
`depth_gt >= depth_min` when `depth_gt/{view:08d}.pfm` exists. Scenes may be
listed in a scan list, with per-light image folders; `max_dim` shrinks
images and depth maps so the longer side fits. `BatchLoader` adjusts (H, W)
to multiples of 8 the way the reference does (bilinear stretch, intrinsics
rescaled, original size kept under `orig_height` / `orig_width`), shuffles
with a seed and prefetches on threads.

Randomness is a function of (seed, epoch) rather than of a running
generator, so a resumed run sees the epoch it would have seen: epoch e's
order is `random.Random(seed + 1000003 * e).shuffle`, whose epoch 0 is the
reference's first order; `robust_train` picks each sample's source views
from `random.Random` seeded by (seed, epoch, index) (the reference draws
them from the unseeded global generator).
"""

from __future__ import annotations

import os
import random
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from patchmatchnet_torch import native
from patchmatchnet_torch.data.codecs import (
    read_cam_file,
    read_image,
    read_pair_file,
    read_pfm,
    resize_bilinear_image,
    scale_to_max_dim,
)
from patchmatchnet_torch.parallel.mesh import rank_rows

_EPOCH_STRIDE = 1000003


def adjust_sample_dims(sample: Dict[str, Any]) -> Dict[str, Any]:
    """Stretch the images to the nearest multiples of 8 (int(round(x / 8)) * 8)
    and rescale the intrinsics; records the original size."""
    height, width = sample["images"].shape[1:3]
    new_h, new_w = int(round(height / 8)) * 8, int(round(width / 8)) * 8
    out = dict(sample, orig_height=height, orig_width=width)
    if (new_h, new_w) != (height, width):
        out["images"] = native.resize_bilinear_batch(sample["images"], new_h, new_w)
        intrinsics = sample["intrinsics"].copy()
        intrinsics[:, 0] *= new_w / width
        intrinsics[:, 1] *= new_h / height
        out["intrinsics"] = intrinsics
    return out


class MVSDataset:
    """Scenes in the unified layout: `[scan/]images/[light/]{view:08d}{ext}`,
    `[scan/]cams/{view:08d}_cam.txt`, `[scan/]pair.txt` and optionally
    `[scan/]depth_gt/{view:08d}.pfm`. Scans come from `scan_list` (a file
    of scan folder names) or are the single scene at `data_path`; with
    `num_light_idx` > 0 every pair entry repeats per light folder. Sample i
    is a reference view with its first `num_views` sources, or a seeded
    random choice of them under `robust_train`."""

    def __init__(self, data_path: str, num_views: int, image_extension: str = ".jpg",
                 max_dim: int = -1, scan_list: str = "", num_light_idx: int = -1,
                 robust_train: bool = False, seed: int = 0):
        self.data_path = data_path
        self.num_views = num_views
        self.image_extension = image_extension
        self.max_dim = max_dim
        self.robust_train = robust_train
        self.seed = seed
        self.epoch = 0
        scans = [""]
        if scan_list and os.path.isfile(scan_list):
            with open(scan_list) as f:
                scans = [line.rstrip() for line in f]
        lights = [str(i) for i in range(num_light_idx)] if num_light_idx > 0 else [""]
        self.metas: List[Tuple[str, str, int, List[int]]] = []
        for scan in scans:
            pairs = read_pair_file(os.path.join(data_path, scan, "pair.txt"))
            for light in lights:
                self.metas += [(scan, light, ref, srcs) for ref, srcs in pairs]

    def __len__(self) -> int:
        return len(self.metas)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        scan, light, ref_view, src_views = self.metas[idx]
        num_src = min(len(src_views), self.num_views)
        if self.robust_train:
            rng = random.Random((self.seed + _EPOCH_STRIDE * self.epoch) * _EPOCH_STRIDE + idx)
            view_ids = [ref_view] + [src_views[i]
                                     for i in rng.sample(range(len(src_views)), num_src)]
        else:
            view_ids = [ref_view] + src_views[:num_src]
        root = os.path.join(self.data_path, scan)
        images, intrinsics, extrinsics = [], [], []
        for view in view_ids:
            image, orig_h, orig_w = scale_to_max_dim(read_image(os.path.join(
                root, "images", light, f"{view:08d}{self.image_extension}")), self.max_dim)
            intrinsic, extrinsic, depth_params = read_cam_file(
                os.path.join(root, "cams", f"{view:08d}_cam.txt"))
            intrinsic = intrinsic.copy()
            intrinsic[0] *= image.shape[1] / orig_w
            intrinsic[1] *= image.shape[0] / orig_h
            if images and image.shape != images[0].shape:
                # a source of another size (a portrait view among landscape
                # ones) takes the reference's, its intrinsics rescaled
                ref_h, ref_w = images[0].shape[:2]
                intrinsic[0] *= ref_w / image.shape[1]
                intrinsic[1] *= ref_h / image.shape[0]
                image = resize_bilinear_image(image, ref_h, ref_w)
            if not images:
                depth_min, depth_max = float(depth_params[0]), float(depth_params[1])
            images.append(image)
            intrinsics.append(intrinsic)
            extrinsics.append(extrinsic)
        depth_gt = np.empty(0, np.float32)
        mask = np.empty(0, bool)
        gt_path = os.path.join(root, "depth_gt", f"{ref_view:08d}.pfm")
        if os.path.isfile(gt_path):
            depth_gt = scale_to_max_dim(read_pfm(gt_path), self.max_dim)[0][:, :, 0]
            mask = depth_gt >= depth_min
        return {
            "images": np.stack(images),  # [N, H, W, 3]
            "intrinsics": np.stack(intrinsics),  # [N, 3, 3]
            "extrinsics": np.stack(extrinsics),  # [N, 4, 4]
            "depth_min": np.float32(depth_min),
            "depth_max": np.float32(depth_max),
            "depth_gt": depth_gt,  # [H, W] f32 or empty
            "mask": mask,  # [H, W] bool or empty
            "filename": os.path.join(scan, "{}", f"{ref_view:08d}" + "{}"),
        }


def _stack_batch(samples: Sequence[Dict[str, Any]],
                 rows: Optional[Tuple[int, int]] = None) -> Dict[str, Any]:
    batch = {k: [s[k] for s in samples] if isinstance(v, str)
             else np.stack([s[k] for s in samples])
             for k, v in samples[0].items()}
    if rows is not None:
        batch["rows"] = rows
    return batch


class BatchLoader:
    """Batches of adjusted samples, in dataset order or shuffled (seeded per
    epoch, see the module note; `set_epoch` picks the epoch), optionally
    dropping a last short batch. With `num_threads` > 1 a thread pool loads
    samples concurrently (PIL and numpy release the GIL), keeping up to
    `prefetch` batches in flight.

    With `shard` = (rank, world size), `batch_size` is the global batch: the
    order and the view choice stay those of the unsharded loader, and only
    the rank's rows of each global batch are loaded (`parallel.rank_rows`:
    contiguous, ceil(rows / world size) each). Each batch records
    (first row, rows) of its global batch under "rows". A short last batch
    may leave a rank no rows, and that rank then has one batch fewer."""

    def __init__(self, dataset: MVSDataset, batch_size: int = 1, num_threads: int = 4,
                 prefetch: int = 2, shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0, shard: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_threads = max(1, num_threads)
        self.prefetch = max(1, prefetch)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.shard = shard

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.dataset.epoch = epoch

    def __len__(self) -> int:
        return len(self._batches())

    def _load(self, idx: int) -> Dict[str, Any]:
        return adjust_sample_dims(self.dataset[idx])

    def _batches(self) -> List[Tuple[List[int], Optional[Tuple[int, int]]]]:
        """(dataset indices to load, (first row, rows) of the global batch
        or None when unsharded) per batch."""
        order = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + _EPOCH_STRIDE * self.epoch).shuffle(order)
        batches = [order[i : i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.shard is None:
            return [(b, None) for b in batches]
        rank, world = self.shard
        out = []
        for b in batches:
            rows = rank_rows(len(b), rank, world)
            if rows.start < rows.stop:
                out.append((b[rows], (rows.start, len(b))))
        return out

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._batches()
        if self.num_threads == 1:
            for indices, rows in batches:
                yield _stack_batch([self._load(i) for i in indices], rows)
            return
        def collect(futures, rows):
            return _stack_batch([f.result() for f in futures], rows)

        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            pending: deque = deque()
            for indices, rows in batches:
                pending.append(([pool.submit(self._load, i) for i in indices], rows))
                if len(pending) == self.prefetch:
                    yield collect(*pending.popleft())
            while pending:
                yield collect(*pending.popleft())
