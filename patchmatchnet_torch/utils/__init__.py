"""Metrics and logging of the training driver."""

from patchmatchnet_torch.utils.logging import MetricsLogger
from patchmatchnet_torch.utils.metrics import (
    DictAverageMeter,
    absolute_depth_error,
    threshold_error,
)

__all__ = ["DictAverageMeter", "MetricsLogger", "absolute_depth_error", "threshold_error"]
