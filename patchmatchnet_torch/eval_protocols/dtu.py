"""The official DTU MVS evaluation protocol in Python (reference:
`patchmatchnet_tpu/eval_protocols/dtu.py`, after the MATLAB scripts the
original PatchmatchNet bundles: BaseEvalMain_web.m, PointCompareMain.m,
MaxDistCP.m, reducePts_haa.m, ComputeStat_web.m). numpy and scipy on the
host.

- stochastic 0.2 mm point-cloud reduction;
- accuracy = distances from the (masked) reconstruction to the reference
  structured-light scan;
- completeness = distances from the (above-ground-plane) reference scan to
  the reconstruction;
- 20 mm outlier threshold; per-scan means/medians; overall = (acc + comp)/2.

Differences from MATLAB, none of which change the reported stats:
- nearest-neighbour distances use one global scipy cKDTree instead of the
  MATLAB 60 mm box partitioning (exact distances; the box scheme only
  distorts distances > 60 mm, which the 20 mm filter discards anyway);
- point reduction uses a seeded RNG for reproducibility.

Needs the official "SampleSet" DTU evaluation data (Points/stl + ObsMask):
ObsMask<set>_10.mat with ObsMask/BB/Res and Plane<set>.mat with P.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from patchmatchnet_torch.data.codecs import read_ply

DTU_EVAL_SETS = (
    1, 4, 9, 10, 11, 12, 13, 15, 23, 24, 29, 32, 33, 34, 48, 49, 62, 75, 77,
    110, 114, 118,
)
MAX_DIST_STAT = 20.0  # outlier threshold (mm)
MAX_DIST_CP = 60.0  # distance cap during NN computation
REDUCE_DST = 0.2  # point reduction radius (mm)
MASK_MARGIN = 10


def reduce_points(
    pts: np.ndarray, dst: float = REDUCE_DST, seed: int = 0
) -> np.ndarray:
    """Stochastic reduction so surviving points are >= dst apart
    (reference: reducePts_haa.m). pts: [N, 3]. Returns the reduced [M, 3]."""
    from scipy.spatial import cKDTree

    n = pts.shape[0]
    keep = np.ones(n, dtype=bool)
    order = np.random.default_rng(seed).permutation(n)
    tree = cKDTree(pts)

    chunk = 4_000_000
    for start in range(0, n, chunk):
        ids = order[start : start + chunk]
        neighbor_lists = tree.query_ball_point(pts[ids], dst, workers=-1)
        for pid, neighbors in zip(ids, neighbor_lists):
            if keep[pid]:
                keep[neighbors] = False
                keep[pid] = True
    return pts[keep]


def point_cloud_distances(
    q_to: np.ndarray, q_from: np.ndarray, max_dist: float = MAX_DIST_CP
) -> np.ndarray:
    """Nearest-neighbor distance from each q_from point to q_to, capped at
    max_dist (reference: MaxDistCP.m semantics, exact global KD-tree)."""
    from scipy.spatial import cKDTree

    if q_to.shape[0] == 0:
        return np.full(q_from.shape[0], max_dist)
    tree = cKDTree(q_to)
    dist, _ = tree.query(q_from, k=1, workers=-1)
    return np.minimum(dist, max_dist)


def _mask_lookup(
    pts: np.ndarray, obs_mask: np.ndarray, bb: np.ndarray, res: float
) -> np.ndarray:
    """Which reconstruction points fall inside the observability mask
    (reference: PointCompareMain.m:37-47). MATLAB rounds 1-based voxel
    coords; reproduced exactly."""
    qv = np.round((pts - bb[0]) / res + 1).astype(np.int64)  # 1-based
    inside = (
        (qv[:, 0] > 0) & (qv[:, 0] <= obs_mask.shape[0])
        & (qv[:, 1] > 0) & (qv[:, 1] <= obs_mask.shape[1])
        & (qv[:, 2] > 0) & (qv[:, 2] <= obs_mask.shape[2])
    )
    result = np.zeros(pts.shape[0], dtype=bool)
    idx = qv[inside] - 1
    result[inside] = obs_mask[idx[:, 0], idx[:, 1], idx[:, 2]].astype(bool)
    return result


def evaluate_scan(
    data_points: np.ndarray,
    stl_points: np.ndarray,
    obs_mask: np.ndarray,
    bb: np.ndarray,
    res: float,
    ground_plane: np.ndarray,
    dst: float = REDUCE_DST,
    max_dist_stat: float = MAX_DIST_STAT,
    reduce_seed: int = 0,
) -> Dict[str, float]:
    """Evaluate one scan.

    Args:
        data_points: [N, 3] fused reconstruction.
        stl_points: [M, 3] reference scan (already 0.2 mm reduced upstream).
        obs_mask: 3-D boolean observability grid; bb: [2, 3]; res: voxel size.
        ground_plane: [4] plane coefficients P (stl kept where P . [x;1] > 0).
    Returns:
        dict with acc/comp mean + median and filtered point counts.
    """
    qdata = reduce_points(data_points, dst, seed=reduce_seed)

    ddata = point_cloud_distances(stl_points, qdata)  # data -> stl (accuracy)
    dstl = point_cloud_distances(qdata, stl_points)  # stl -> data (completeness)

    in_mask = _mask_lookup(qdata, obs_mask, bb, res)
    above = (
        stl_points @ ground_plane[:3] + ground_plane[3]
    ) > 0

    fd = ddata[in_mask]
    fd = fd[fd < max_dist_stat]
    fs = dstl[above]
    fs = fs[fs < max_dist_stat]

    return {
        "acc_mean": float(np.mean(fd)) if fd.size else float("nan"),
        "acc_median": float(np.median(fd)) if fd.size else float("nan"),
        "comp_mean": float(np.mean(fs)) if fs.size else float("nan"),
        "comp_median": float(np.median(fs)) if fs.size else float("nan"),
        "n_data": int(fd.size),
        "n_stl": int(fs.size),
    }


def _load_mat(path: str) -> Dict:
    from scipy.io import loadmat

    return loadmat(path)


def evaluate_dtu(
    ply_paths: Dict[int, str],
    dataset_path: str,
    used_sets: Sequence[int] = DTU_EVAL_SETS,
    margin: int = MASK_MARGIN,
    verbose: bool = True,
) -> Dict[str, object]:
    """Run the full DTU protocol.

    Args:
        ply_paths: {scan_id: fused ply path}.
        dataset_path: official SampleSet "MVS Data" directory with Points/stl
            and ObsMask subfolders.
    Returns:
        {"per_scan": {set: metrics}, "acc": float, "comp": float,
         "overall": float}
    """
    per_scan: Dict[int, Dict[str, float]] = {}
    for cset in used_sets:
        xyz, _ = read_ply(ply_paths[cset])

        stl_path = os.path.join(
            dataset_path, "Points", "stl", f"stl{cset:03d}_total.ply"
        )
        stl_xyz, _ = read_ply(stl_path)

        mask_mat = _load_mat(
            os.path.join(dataset_path, "ObsMask", f"ObsMask{cset}_{margin}.mat")
        )
        plane_mat = _load_mat(
            os.path.join(dataset_path, "ObsMask", f"Plane{cset}.mat")
        )
        metrics = evaluate_scan(
            xyz.astype(np.float64),
            stl_xyz.astype(np.float64),
            np.asarray(mask_mat["ObsMask"]),
            np.asarray(mask_mat["BB"], dtype=np.float64),
            float(np.asarray(mask_mat["Res"]).squeeze()),
            np.asarray(plane_mat["P"], dtype=np.float64).reshape(4),
        )
        per_scan[cset] = metrics
        if verbose:
            print(
                f"scan{cset}: acc {metrics['acc_mean']:.4f}/"
                f"{metrics['acc_median']:.4f} comp {metrics['comp_mean']:.4f}/"
                f"{metrics['comp_median']:.4f}"
            )

    acc = float(np.mean([m["acc_mean"] for m in per_scan.values()]))
    comp = float(np.mean([m["comp_mean"] for m in per_scan.values()]))
    overall = (acc + comp) / 2
    if verbose:
        print(f"final: acc {acc:.4f} comp {comp:.4f} overall {overall:.4f}")
    return {"per_scan": per_scan, "acc": acc, "comp": comp, "overall": overall}
