"""Per-point sweep-time recovery for scans that carry no time field — a
copy of the JAX package's ``utils/sweep.py`` (numpy).

The reference's FAST-LIO front end consumes a per-point time field with a
configured unit (``preprocess/timestamp_unit``, kitti.yaml:9-13) and, for
sources without one, synthesizes offsets from the scan geometry in its
Preprocess stage.  This module is that synthesis, selected by the
configured ``lidar_type`` (kitti.yaml:9 — 1 livox, 2 velodyne, 3 ouster):

- spinning LiDARs (velodyne / ouster): azimuth is the sweep coordinate, so
  the fraction of the sweep elapsed at a point is its azimuth fraction,
  quantized to firing columns (the ``scan_line`` rings of one column share
  a stamp);
- livox (non-repetitive prism pattern): a linear ramp over the point index.

True per-point times, when the dataset provides them (``rel_times/%06d.npy``
written by ``tools/bag_convert.py``), always win over synthesis.
"""
from __future__ import annotations

import os

import numpy as np


def synthesize_rel_times(pts: np.ndarray, duration: float,
                         lidar_type: str = "velodyne",
                         scan_line: int = 64) -> np.ndarray:
    """Synthetic per-point sweep times in [0, duration) for an (N, 3+)
    scan: the azimuth pattern for spinning heads (firing columns of
    ``scan_line`` points share a time), an index ramp for livox."""
    n = len(pts)
    if n == 0 or duration <= 0:
        return np.zeros(n, np.float32)
    if lidar_type == "livox":
        return (np.arange(n, dtype=np.float32) / n) * np.float32(duration)
    az = np.arctan2(pts[:, 1], pts[:, 0])
    frac = ((-az + np.pi) % (2 * np.pi)) / (2 * np.pi)
    n_cols = max(n // max(scan_line, 1), 1)
    frac = np.floor(frac * n_cols) / n_cols
    return (frac * duration).astype(np.float32)


def load_rel_times(dataset_dir: str, index: int, n_points: int
                   ) -> np.ndarray | None:
    """True per-point times of scan ``index`` from the rel_times/ sidecar
    (seconds from the scan's start), or None when the dataset has none."""
    path = os.path.join(dataset_dir, "rel_times", f"{index:06d}.npy")
    if not os.path.exists(path):
        return None
    rel = np.load(path).astype(np.float32)
    if len(rel) < n_points:  # decoder capacity may have truncated the scan
        rel = np.pad(rel, (0, n_points - len(rel)))
    return rel[:n_points]
