"""Tensor ops of the port: plain PyTorch helpers and the kernel wrappers
(K1 `warp_group_corr`, K2 `eval_grid_score`, K3 `neighbor_group_corr`, the
backward kernels K4 `warp_group_corr_backward` and K5
`neighbor_group_corr_backward`, the fused-views K6 `warp_group_corr_views`,
the coordinate-input K7 `coord_group_corr`, and the gathers of the gather
microbenchmarks, D1-D5, `gather_lanes`, `gather_sublanes` and
`gather_rows`), each with a `*_reference` plain version. K1, K6, K2 and K3
are called through the operators `torch.ops.pmn.*` (`library.py`)."""

from patchmatchnet_torch.ops.eval_tail import eval_grid_score, eval_grid_score_reference
from patchmatchnet_torch.ops.gather import (
    gather_lanes,
    gather_lanes_reference,
    gather_rows,
    gather_rows_reference,
    gather_sublanes,
    gather_sublanes_reference,
)
from patchmatchnet_torch.ops.neighbor_similarity import (
    neighbor_group_corr,
    neighbor_group_corr_backward,
    neighbor_group_corr_backward_reference,
    neighbor_group_corr_reference,
)
from patchmatchnet_torch.ops.warp_similarity import (
    coord_group_corr,
    coord_group_corr_reference,
    warp_group_corr,
    warp_group_corr_backward,
    warp_group_corr_backward_reference,
    warp_group_corr_reference,
    warp_group_corr_views,
    warp_group_corr_views_reference,
)

__all__ = [
    "coord_group_corr",
    "coord_group_corr_reference",
    "eval_grid_score",
    "eval_grid_score_reference",
    "gather_lanes",
    "gather_lanes_reference",
    "gather_rows",
    "gather_rows_reference",
    "gather_sublanes",
    "gather_sublanes_reference",
    "neighbor_group_corr",
    "neighbor_group_corr_backward",
    "neighbor_group_corr_backward_reference",
    "neighbor_group_corr_reference",
    "warp_group_corr",
    "warp_group_corr_backward",
    "warp_group_corr_backward_reference",
    "warp_group_corr_reference",
    "warp_group_corr_views",
    "warp_group_corr_views_reference",
]
