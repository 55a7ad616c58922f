"""Camera geometry of depth fusion on torch tensors."""

from patchmatchnet_torch.geometry.fusion_math import (
    backproject_to_world,
    check_geometric_consistency,
    reproject_with_depth,
)

__all__ = ["backproject_to_world", "check_geometric_consistency", "reproject_with_depth"]
