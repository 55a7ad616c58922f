"""Host-side data layer: codecs, the MVS scene dataset and batch loader, the
raw DTU training layout, and a synthetic scene with known depth."""

from patchmatchnet_torch.data.codecs import (
    read_bin,
    read_cam_file,
    read_image,
    read_image_size,
    read_map,
    read_pair_file,
    read_pfm,
    read_ply,
    save_bin,
    save_cam_file,
    save_image,
    save_map,
    save_pair_file,
    save_pfm,
    save_ply,
    scale_to_max_dim,
    scaled_dims,
)
from patchmatchnet_torch.data.dtu_legacy import DTULegacyDataset
from patchmatchnet_torch.data.mvs import BatchLoader, MVSDataset, adjust_sample_dims
from patchmatchnet_torch.data.synthetic import PLANE_Z, make_synthetic_scene, plane_batch

__all__ = [
    "BatchLoader",
    "DTULegacyDataset",
    "MVSDataset",
    "PLANE_Z",
    "adjust_sample_dims",
    "make_synthetic_scene",
    "plane_batch",
    "read_bin",
    "read_cam_file",
    "read_image",
    "read_image_size",
    "read_map",
    "read_pair_file",
    "read_pfm",
    "read_ply",
    "save_bin",
    "save_cam_file",
    "save_image",
    "save_map",
    "save_pair_file",
    "save_pfm",
    "save_ply",
    "scale_to_max_dim",
    "scaled_dims",
]
