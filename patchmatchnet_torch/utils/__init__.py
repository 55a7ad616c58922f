"""Metrics, logging and profiling of the training driver."""

from patchmatchnet_torch.utils.logging import MetricsLogger
from patchmatchnet_torch.utils.metrics import (
    DictAverageMeter,
    absolute_depth_error,
    threshold_error,
)
from patchmatchnet_torch.utils.profiling import PhaseTimer, torch_trace

__all__ = ["DictAverageMeter", "MetricsLogger", "PhaseTimer", "absolute_depth_error",
           "threshold_error", "torch_trace"]
