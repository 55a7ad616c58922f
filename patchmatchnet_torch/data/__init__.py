"""Host-side data layer: codecs, the MVS scene dataset and batch loader, and
a synthetic scene with known depth."""

from patchmatchnet_torch.data.codecs import (
    read_cam_file,
    read_image,
    read_pair_file,
    read_pfm,
    save_cam_file,
    save_image,
    save_pair_file,
    save_pfm,
)
from patchmatchnet_torch.data.mvs import (
    BatchLoader,
    MVSDataset,
    adjust_sample_dims,
    scale_to_max_dim,
)
from patchmatchnet_torch.data.synthetic import PLANE_Z, make_synthetic_scene, plane_batch

__all__ = [
    "BatchLoader",
    "MVSDataset",
    "PLANE_Z",
    "adjust_sample_dims",
    "make_synthetic_scene",
    "plane_batch",
    "read_cam_file",
    "read_image",
    "read_pair_file",
    "read_pfm",
    "save_cam_file",
    "save_image",
    "save_pair_file",
    "save_pfm",
    "scale_to_max_dim",
]
