"""Depth/confidence map inference and export (reference:
`patchmatchnet_tpu/infer/depth.py`, `DepthEstimator`, `ModuleEstimator` and
`save_depth_maps`).

Host-side pre/post-processing around the forward: optional bucket padding
of (H, W) with edge replication, and the resize back to the original
resolution (bilinear for depth, nearest for confidence, both the
reference's to the bit). The images travel to the device, and the maps
back, through host buffers the estimator keeps and reuses (pinned on a
CUDA device). The reference's window derivation, escape counter
and sampler demotion are not needed: the port's warp kernel reads the
source features directly, so no sample can leave a window.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from patchmatchnet_torch.compat.export import load_exported
from patchmatchnet_torch.data.codecs import save_map
from patchmatchnet_torch.models.net import PatchmatchNet
from patchmatchnet_torch.ops.resize import resize_bilinear_maps, resize_nearest_maps
from patchmatchnet_torch.utils.profiling import span


class DepthEstimator:
    """PatchmatchNet (or CasMVSNet) inference on one explicit device.

    The model runs as it was built (any configuration; the command line
    builds it with `train.driver.build_model(cfg, inference=True)`), under
    `torch.inference_mode`, so every evaluation call that has view weights
    makes one K6 launch in place of a K1 launch per source view. `bucket_multiple` > 0 rounds (H, W) up to
    that multiple with edge-replicated padding and crops the outputs back
    (see the reference; the command line's `--shape_bucket`); 0 keeps exact
    shapes."""

    def __init__(self, model: torch.nn.Module, device: Union[str, torch.device],
                 bucket_multiple: int = 0):
        if bucket_multiple and bucket_multiple % 8 != 0:
            raise ValueError("bucket_multiple must be a multiple of 8")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")
        self.model = model.to(self.device).eval()
        self.bucket_multiple = bucket_multiple
        # the dtype the model's first convolutions cast the images to
        self.staging_dtype = model.compute_dtype or torch.float32
        self.noise_shape = model.noise_shape  # (batch, h, w) -> shape, or None: no noise
        self.images_buffer: Optional[torch.Tensor] = None
        self.maps_buffer: Optional[torch.Tensor] = None
        self._images_sent: Optional[torch.cuda.Event] = None

    def _tensor(self, x: Any) -> torch.Tensor:
        # in C order: convolutions and matmuls pick their kernels by memory
        # layout, so a batch's values give the same maps whatever its strides
        return torch.as_tensor(np.asarray(x)).contiguous().to(self.device, non_blocking=True)

    def _buffers(self, images_shape: Tuple[int, ...], maps_shape: Tuple[int, ...]) -> int:
        """Allocate the staging buffers unless the last request's have these
        shapes: `images_buffer` [B, N, H, W, 3] in `staging_dtype` and
        `maps_buffer` [2, B, Ho, Wo] f32 (depth, confidence), pinned on a
        CUDA device. Returns the number of allocations (0 or 1)."""
        if (self.images_buffer is not None and self.images_buffer.shape == images_shape
                and self.maps_buffer.shape == (2, *maps_shape)):
            return 0
        pin = self.device.type == "cuda"
        self.images_buffer = torch.empty(images_shape, dtype=self.staging_dtype, pin_memory=pin)
        self.maps_buffer = torch.empty((2, *maps_shape), dtype=torch.float32, pin_memory=pin)
        return 1

    def _stage_images(self, images: np.ndarray) -> torch.Tensor:
        """f32 images [B, N, H, W, 3] (any strides) -> a C-ordered device
        tensor in `staging_dtype`, through `images_buffer` one view at a
        time: torch's copy_ casts the view into its slice on the host's
        threads (round to nearest even, the model's own cast), then the
        slice's copy to the device is queued, so the host casts the next
        view while the card receives this one."""
        if self._images_sent is not None:
            self._images_sent.synchronize()  # the last request's copies out of the buffer
        src, buffer = torch.from_numpy(images), self.images_buffer
        out = torch.empty(buffer.shape, dtype=buffer.dtype, device=self.device)
        for b in range(buffer.shape[0]):
            for v in range(buffer.shape[1]):
                buffer[b, v].copy_(src[b, v])
                out[b, v].copy_(buffer[b, v], non_blocking=True)
        if buffer.is_pinned():
            self._images_sent = torch.cuda.Event()
            self._images_sent.record(torch.cuda.current_stream(self.device))
        return out

    @torch.inference_mode()
    def __call__(self, batch: Dict[str, Any],
                 generator: torch.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """batch: adjusted sample batch (see data.adjust_sample_dims), or a
        rank's rows of one (data parallel: the noise is then drawn for the
        global batch and sliced, as the JAX estimator shards it);
        `generator` (on this estimator's device) draws the stage-3 noise of
        `noise_shape`, and is left untouched when that is None.
        Returns (depth [B, Ho, Wo], confidence [B, Ho, Wo]) as numpy arrays at
        the original resolution."""
        with span("pmn.request"):
            with span("pmn.request.prepare"):
                images = np.asarray(batch["images"], np.float32)
                b, _, h0, w0 = images.shape[:4]
                if self.bucket_multiple:
                    m = self.bucket_multiple
                    hb, wb = -(-h0 // m) * m, -(-w0 // m) * m
                    images = np.pad(images, ((0, 0), (0, 0), (0, hb - h0), (0, wb - w0), (0, 0)),
                                    mode="edge")
                h, w = images.shape[2:4]
                orig_h = int(np.asarray(batch.get("orig_height", h0)).reshape(-1)[0])
                orig_w = int(np.asarray(batch.get("orig_width", w0)).reshape(-1)[0])
                # the noise of the whole global batch, of which a rank's batch
                # (`BatchLoader(shard=...)`) takes its rows; none for a model
                # that draws nothing at random
                start, rows = batch.get("rows", (0, b))
                shape = self.noise_shape(rows, h, w)
                noise = None if shape is None else torch.rand(
                    shape, generator=generator, device=self.device)[start:start + b]
            with span("pmn.request.copy_in") as copy_in:
                allocs = self._buffers(images.shape, (b, orig_h, orig_w))
                images = self._stage_images(images)
                cameras = [self._tensor(batch[k]) for k in ("intrinsics", "extrinsics",
                                                            "depth_min", "depth_max")]
                copy_in.add(bytes=images.nbytes + sum(t.nbytes for t in cameras),
                            staged_bytes=images.nbytes if self.images_buffer.is_pinned() else 0,
                            staging_allocs=allocs)
                intrinsics, extrinsics, depth_min, depth_max = cameras
            with span("pmn.request.forward"):
                depth, confidence = self._forward(
                    images, intrinsics.float(), extrinsics.float(),
                    depth_min.float().reshape(b), depth_max.float().reshape(b), noise)
            with span("pmn.request.resize"):
                depth, confidence = depth[:, :h0, :w0], confidence[:, :h0, :w0]
                maps = self.maps_buffer
                maps[0].copy_(resize_bilinear_maps(depth, orig_h, orig_w), non_blocking=True)
                maps[1].copy_(resize_nearest_maps(confidence, orig_h, orig_w), non_blocking=True)
            with span("pmn.request.wait"):
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
            with span("pmn.request.copy_out") as copy_out:
                # arrays of the caller's own, never views of the buffer
                depth = np.empty(maps.shape[1:], np.float32)
                confidence = np.empty(maps.shape[1:], np.float32)
                torch.from_numpy(depth).copy_(maps[0])
                torch.from_numpy(confidence).copy_(maps[1])
                copy_out.add(bytes=maps.nbytes,
                             staged_bytes=maps.nbytes if maps.is_pinned() else 0)
        return depth, confidence

    def _forward(self, images, intrinsics, extrinsics, depth_min, depth_max, noise):
        depth, confidence, _ = self.model(images, intrinsics, extrinsics, depth_min,
                                          depth_max, init_noise=noise)
        return depth, confidence


class ModuleEstimator(DepthEstimator):
    """Inference from an artifact of `compat.export.export_inference` (the
    reference's `--input_type module` path).

    The artifact bakes in the weights and a fixed input geometry: batches
    must match its images shape [B, N, H, W, 3] exactly, so there is no
    bucket padding. An artifact exported on another device is moved to
    `device` (`compat.export.load_exported`), where its kernel nodes launch
    the kernels (CUDA) or run their plain versions (CPU). The stage-3 noise
    is drawn as `DepthEstimator` draws it, so one seed gives both estimators
    the same noise; an f32 artifact runs with TF32 off."""

    def __init__(self, blob: bytes, device: Union[str, torch.device]):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")
        self.bucket_multiple = 0  # shapes are baked into the artifact
        self.exported = load_exported(blob, self.device)
        self.staging_dtype = torch.float32  # the artifact's images dtype
        self.noise_shape = PatchmatchNet.noise_shape  # an artifact is always PatchmatchNet
        self.images_buffer = self.maps_buffer = self._images_sent = None

    def _forward(self, images, intrinsics, extrinsics, depth_min, depth_max, noise):
        if tuple(images.shape) != self.exported.shape:
            raise ValueError(
                f"exported module expects images {self.exported.shape}, got "
                f"{tuple(images.shape)}; re-export for this geometry or set "
                "--image_max_dim/--batch_size to match")
        return self.exported(images, intrinsics, extrinsics, depth_min, depth_max, noise)


def save_depth_maps(
    estimator: DepthEstimator,
    loader: Iterable[Dict[str, Any]],
    output_folder: str,
    file_format: str = ".pfm",
    seed: int = 0,
) -> int:
    """Run inference over a loader and write depth_est/ + confidence/ maps in
    `file_format` (.pfm or COLMAP .bin), named as the reference names them
    ("depth_est/{view:08d}.pfm" etc.). The stage-3 noise comes from one
    torch.Generator seeded with `seed`; under data parallel each rank's
    loader holds its rows of every global batch (`BatchLoader(shard=...)`),
    draws each global batch's noise from its own generator of that seed
    and writes the maps of its own views. Each estimator call is a
    `pmn.request` span (`utils.profiling`). Returns the number of maps
    written (by this rank)."""
    generator = torch.Generator(device=estimator.device).manual_seed(seed)
    count = 0
    for batch in loader:
        depth, confidence = estimator(batch, generator)
        for filename, d, c in zip(batch["filename"], depth, confidence):
            for folder, value in (("depth_est", d), ("confidence", c)):
                save_map(os.path.join(output_folder, filename.format(folder, file_format)),
                         value.astype(np.float32))
            count += 1
    return count
