"""Inference entry points of the port: depth/confidence maps and their
fusion into a point cloud."""

from patchmatchnet_torch.infer.depth import DepthEstimator, ModuleEstimator, save_depth_maps
from patchmatchnet_torch.infer.fusion import FusionConfig, filter_and_fuse

__all__ = ["DepthEstimator", "FusionConfig", "ModuleEstimator", "filter_and_fuse",
           "save_depth_maps"]
