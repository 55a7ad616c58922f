"""Depth/confidence map inference and export (reference:
`patchmatchnet_tpu/infer/depth.py`, `DepthEstimator` and `save_depth_maps`).

Host-side pre/post-processing around the forward: optional bucket padding
of (H, W) with edge replication, and the resize back to the original
resolution (bilinear for depth, nearest for confidence, both the
reference's to the bit). The reference's window derivation, escape counter
and sampler demotion are not needed: the port's warp kernel reads the
source features directly, so no sample can leave a window.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from patchmatchnet_torch.data.codecs import save_map
from patchmatchnet_torch.models.net import PatchmatchNet
from patchmatchnet_torch.models.patchmatch import INITIAL_NUM_SAMPLES
from patchmatchnet_torch.ops.resize import resize_bilinear_maps, resize_nearest_maps


class DepthEstimator:
    """PatchmatchNet inference on one explicit device.

    The model runs as it was built (any configuration; the command line
    builds it with `train.driver.build_model(cfg, inference=True)`), under
    `torch.inference_mode`, so every evaluation call that has view weights
    makes one K6 launch in place of a K1 launch per source view. `bucket_multiple` > 0 rounds (H, W) up to
    that multiple with edge-replicated padding and crops the outputs back
    (see the reference; the command line's `--shape_bucket`); 0 keeps exact
    shapes."""

    def __init__(self, model: PatchmatchNet, device: Union[str, torch.device],
                 bucket_multiple: int = 0):
        if bucket_multiple and bucket_multiple % 8 != 0:
            raise ValueError("bucket_multiple must be a multiple of 8")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")
        self.model = model.to(self.device).eval()
        self.bucket_multiple = bucket_multiple

    def _tensor(self, x: Any) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(self.device, non_blocking=True)

    @torch.inference_mode()
    def __call__(self, batch: Dict[str, Any],
                 generator: torch.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """batch: adjusted sample batch (see data.adjust_sample_dims);
        `generator` (on this estimator's device) draws the stage-3 noise.
        Returns (depth [B, Ho, Wo], confidence [B, Ho, Wo]) as numpy arrays at
        the original resolution."""
        images = np.asarray(batch["images"], np.float32)
        b, _, h0, w0 = images.shape[:4]
        if self.bucket_multiple:
            m = self.bucket_multiple
            hb, wb = -(-h0 // m) * m, -(-w0 // m) * m
            images = np.pad(images, ((0, 0), (0, 0), (0, hb - h0), (0, wb - w0), (0, 0)),
                            mode="edge")
        h, w = images.shape[2:4]
        noise = torch.rand((b, INITIAL_NUM_SAMPLES, h // 8, w // 8),
                           generator=generator, device=self.device)
        depth, confidence, _ = self.model(
            self._tensor(images),
            self._tensor(batch["intrinsics"]).float(),
            self._tensor(batch["extrinsics"]).float(),
            self._tensor(batch["depth_min"]).float().reshape(b),
            self._tensor(batch["depth_max"]).float().reshape(b),
            init_noise=noise,
        )
        depth, confidence = depth[:, :h0, :w0], confidence[:, :h0, :w0]
        orig_h = int(np.asarray(batch.get("orig_height", h0)).reshape(-1)[0])
        orig_w = int(np.asarray(batch.get("orig_width", w0)).reshape(-1)[0])
        depth = resize_bilinear_maps(depth, orig_h, orig_w)
        confidence = resize_nearest_maps(confidence, orig_h, orig_w)
        return depth.cpu().numpy(), confidence.cpu().numpy()


def save_depth_maps(
    estimator: DepthEstimator,
    loader: Iterable[Dict[str, Any]],
    output_folder: str,
    seed: int = 0,
    file_format: str = ".pfm",
    request_ms: Optional[List[float]] = None,
) -> int:
    """Run inference over a loader and write depth_est/ + confidence/ maps in
    `file_format` (.pfm or COLMAP .bin), named as the reference names them
    ("depth_est/{view:08d}.pfm" etc.). The stage-3 noise comes from one
    torch.Generator seeded with `seed`. With `request_ms`, appends each
    estimator call's host milliseconds to it (the call returns host
    arrays, so its device work is done). Returns the number of maps
    written."""
    generator = torch.Generator(device=estimator.device).manual_seed(seed)
    count = 0
    for batch in loader:
        start = time.perf_counter()
        depth, confidence = estimator(batch, generator)
        if request_ms is not None:
            request_ms.append((time.perf_counter() - start) * 1e3)
        for filename, d, c in zip(batch["filename"], depth, confidence):
            for folder, value in (("depth_est", d), ("confidence", c)):
                save_map(os.path.join(output_folder, filename.format(folder, file_format)),
                         value.astype(np.float32))
            count += 1
    return count
