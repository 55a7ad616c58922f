"""Depth-map quality metrics and a dict averaging meter (reference:
`patchmatchnet_tpu/utils/metrics.py`): per-image masked means, averaged
over the batch."""

from __future__ import annotations

from typing import Any, Dict

import torch


def _per_image_masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of `values` [B, H, W] over `mask` per image, then over the batch."""
    b = values.shape[0]
    m = mask.to(values.dtype).reshape(b, -1)
    num = (values.reshape(b, -1) * m).sum(dim=1)
    return (num / m.sum(dim=1).clamp(min=1.0)).mean()


def absolute_depth_error(depth_est: torch.Tensor, depth_gt: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean absolute depth error over masked pixels (per image, then batch)."""
    return _per_image_masked_mean((depth_est - depth_gt).abs(), mask)


def threshold_error(depth_est: torch.Tensor, depth_gt: torch.Tensor, mask: torch.Tensor,
                    threshold: float) -> torch.Tensor:
    """Fraction of masked pixels whose absolute error exceeds `threshold`."""
    err = ((depth_est - depth_gt).abs() > threshold).float()
    return _per_image_masked_mean(err, mask)


class DictAverageMeter:
    """Running mean of a dict of floats."""

    def __init__(self) -> None:
        self.data: Dict[Any, float] = {}
        self.count = 0

    def update(self, new_input: Dict[Any, float]) -> None:
        self.count += 1
        for k, v in new_input.items():
            self.data[k] = self.data.get(k, 0.0) + float(v)

    def mean(self) -> Dict[Any, float]:
        return {k: v / max(self.count, 1) for k, v in self.data.items()}
