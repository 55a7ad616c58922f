"""Depth-map filtering and fusion into a coloured point cloud (reference:
`patchmatchnet_tpu/infer/fusion.py`, after eval.py:193-297 of the original
PatchmatchNet).

Per reference view: a photometric mask from the confidence map, a
geometric mask from consistency with every source view, the depth averaged
over the consistent views, the masks saved as PNGs, and the pixels of both
masks backprojected to world coordinates; the points of all views go into
one binary PLY. The consistency of a reference with all its sources is one
pass on the device (`geometry.fusion_math`, batched over sources).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from patchmatchnet_torch.data.codecs import (
    read_cam_file,
    read_image,
    read_image_size,
    read_map,
    read_pair_file,
    save_image,
    save_ply,
    scaled_dims,
)
from patchmatchnet_torch.geometry import backproject_to_world, check_geometric_consistency


@dataclass
class FusionConfig:
    image_max_dim: int = -1
    geo_pixel_thres: float = 1.0
    geo_depth_thres: float = 0.01
    geo_mask_thres: int = 5
    photo_thres: float = 0.5
    file_format: str = ".pfm"
    image_extension: str = ".jpg"
    save_masks: bool = True


def consistency_all_sources(
    ref_depth: torch.Tensor,
    ref_intr: torch.Tensor,
    ref_extr: torch.Tensor,
    src_depths: torch.Tensor,
    src_intrs: torch.Tensor,
    src_extrs: torch.Tensor,
    geo_pixel_thres: float,
    geo_depth_thres: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Consistency of a reference view with V source views (depth maps
    [H, W] and [V, H, W] on one device). Returns (number of consistent
    views [H, W] int32, sum of the consistent reprojected depths [H, W])."""
    masks, reprojected = check_geometric_consistency(
        ref_depth, ref_intr, ref_extr, src_depths, src_intrs, src_extrs,
        geo_pixel_thres, geo_depth_thres)
    return masks.sum(0, dtype=torch.int32), reprojected.sum(0)


def _squeeze(data: np.ndarray) -> np.ndarray:
    return data[:, :, 0] if data.ndim == 3 else data


class _ViewCache:
    """Per-scan decode-once store of fusion inputs: each view's cams and
    depth map are read once per scan (the depth map copied to the device
    once), where the original fusion re-reads every source for every
    reference that names it; the image is decoded only on the view's own
    turn as reference, since the intrinsics' rescale needs just the image
    size, which comes from the file header."""

    def __init__(self, input_folder: str, output_folder: str, scan: str, cfg: FusionConfig,
                 device: torch.device):
        self.input_folder = input_folder
        self.output_folder = output_folder
        self.scan = scan
        self.cfg = cfg
        self.device = device
        self._cam_depth: Dict[int, Tuple[np.ndarray, np.ndarray, torch.Tensor]] = {}

    def _img_path(self, view: int) -> str:
        return os.path.join(self.input_folder, self.scan, "images",
                            f"{view:08d}{self.cfg.image_extension}")

    def cam_depth(self, view: int) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
        """(intrinsics, extrinsics, depth map on the device), cached."""
        hit = self._cam_depth.get(view)
        if hit is not None:
            return hit
        orig_h, orig_w = read_image_size(self._img_path(view))
        h, w = scaled_dims(orig_h, orig_w, self.cfg.image_max_dim)
        intr, extr, _ = read_cam_file(
            os.path.join(self.input_folder, self.scan, "cams", f"{view:08d}_cam.txt"))
        intr = intr.copy()
        intr[0] *= w / orig_w
        intr[1] *= h / orig_h
        depth = _squeeze(read_map(os.path.join(
            self.output_folder, self.scan, "depth_est", f"{view:08d}{self.cfg.file_format}")))
        out = (intr, extr, torch.from_numpy(depth.astype(np.float32)).to(self.device))
        self._cam_depth[view] = out
        return out

    def image(self, view: int) -> np.ndarray:
        """The decoded (shrunk) image; not cached: a view is a reference
        once per scan."""
        return read_image(self._img_path(view), self.cfg.image_max_dim)


class _Laps:
    """Adds the seconds since the last lap to `timings[name]` (if given)."""

    def __init__(self, timings: Optional[Dict[str, float]]):
        self.timings = timings
        self.last = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        if self.timings is not None:
            self.timings[name] = self.timings.get(name, 0.0) + now - self.last
        self.last = now


def filter_and_fuse(
    input_folder: str,
    output_folder: str,
    scan: str = "",
    cfg: Optional[FusionConfig] = None,
    verbose: bool = True,
    device: Union[str, torch.device] = "cuda",
    timings: Optional[Dict[str, float]] = None,
) -> str:
    """Fuse one scan's depth maps into `<output_folder>/<scan>/fused.ply` on
    `device` (CUDA unless the caller asks for the CPU; raises if CUDA is
    asked for and missing). Writes mask/{view:08d}_{photo,geo,final}.png
    when `cfg.save_masks`. With `timings`, adds the host seconds of each
    section to it: "read" (maps, cams, image and the depth maps' copy to
    the device), "consistency" (up to the masks on the host), "masks" (the
    PNGs), "backproject" (points and colours on the host) and "ply".
    Returns the PLY path."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    cfg = cfg or FusionConfig()
    pair_data = read_pair_file(os.path.join(input_folder, scan, "pair.txt"))
    cache = _ViewCache(input_folder, output_folder, scan, cfg, device)
    vertices: List[np.ndarray] = []
    vertex_colors: List[np.ndarray] = []
    laps = _Laps(timings)
    for ref_view, src_views in pair_data:
        ref_intr, ref_extr, ref_depth = cache.cam_depth(ref_view)
        ref_img = cache.image(ref_view)
        confidence = _squeeze(read_map(os.path.join(
            output_folder, scan, "confidence", f"{ref_view:08d}{cfg.file_format}")))
        photo_mask = confidence > cfg.photo_thres
        sources = [cache.cam_depth(sv) for sv in src_views]
        laps.lap("read")

        geo_sum, reproj_sum = consistency_all_sources(
            ref_depth, torch.from_numpy(ref_intr), torch.from_numpy(ref_extr),
            torch.stack([d for _, _, d in sources]),
            torch.from_numpy(np.stack([k for k, _, _ in sources])),
            torch.from_numpy(np.stack([e for _, e, _ in sources])),
            cfg.geo_pixel_thres, cfg.geo_depth_thres)
        depth_avg = (reproj_sum + ref_depth) / (geo_sum + 1)
        geo_mask_dev = geo_sum >= cfg.geo_mask_thres
        final_mask_dev = geo_mask_dev & torch.from_numpy(photo_mask).to(device)
        geo_mask, final_mask = geo_mask_dev.cpu().numpy(), final_mask_dev.cpu().numpy()
        laps.lap("consistency")

        if cfg.save_masks:
            mask_dir = os.path.join(output_folder, scan, "mask")
            os.makedirs(mask_dir, exist_ok=True)
            for name, mask in (("photo", photo_mask), ("geo", geo_mask), ("final", final_mask)):
                save_image(os.path.join(mask_dir, f"{ref_view:08d}_{name}.png"), mask)
        if verbose:
            print(f"processing {os.path.join(input_folder, scan)}, ref-view{ref_view:03d}, "
                  f"geo_mask:{geo_mask.mean():3f} photo_mask:{photo_mask.mean():3f} "
                  f"final_mask:{final_mask.mean():3f}")
        laps.lap("masks")

        world = backproject_to_world(depth_avg, torch.from_numpy(ref_intr),
                                     torch.from_numpy(ref_extr))
        vertices.append(world[final_mask_dev].cpu().numpy())
        vertex_colors.append((ref_img[final_mask] * 255).astype(np.uint8))
        laps.lap("backproject")

    xyz = np.concatenate(vertices, axis=0)
    rgb = np.concatenate(vertex_colors, axis=0)
    ply_path = os.path.join(output_folder, scan, "fused.ply")
    save_ply(ply_path, xyz, rgb)
    laps.lap("ply")
    if verbose:
        print(f"saving the final model to {ply_path} ({xyz.shape[0]} points)")
    return ply_path
