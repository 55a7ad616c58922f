"""Benchmark evaluation protocols (Python ports of the official scripts)."""

from patchmatchnet_torch.eval_protocols.dtu import (
    DTU_EVAL_SETS,
    evaluate_dtu,
    evaluate_scan,
    point_cloud_distances,
    reduce_points,
)

__all__ = ["DTU_EVAL_SETS", "evaluate_dtu", "evaluate_scan", "point_cloud_distances",
           "reduce_points"]
