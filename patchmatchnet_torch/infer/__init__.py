"""Inference entry points of the port."""

from patchmatchnet_torch.infer.depth import DepthEstimator, save_depth_maps

__all__ = ["DepthEstimator", "save_depth_maps"]
