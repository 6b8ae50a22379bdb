"""Dataset IO and result persistence — port of the JAX package's
``utils/io.py`` (numpy and file code; the quaternions come from the port's
``ops/se3.py``).

Mirrors the reference's save surface (saveFlagCallback + destructor,
src/fast_lio_sam_qn.cpp:327-450):

- per-keyframe body-frame scans as ``scans/%06d.pcd`` (ASCII, XYZI),
- ``poses_kitti.txt``: corrected pose 3x4 row-major per line (:359-362),
- ``poses_tum.txt``: header + "timestamp x y z qx qy qz qw" at fixed 8
  decimals (:346,365-372),
- accumulated corrected map voxelized and saved as ``<seq>_map.pcd``
  (:398-412),
- the reference's ``result.bag`` itself — a real indexed rosbag 2.0 with
  /keyframe_pcd + /keyframe_pose at keyframe timestamps (:380-396),
  written by ``utils/rosbag.py``'s BagWriter — plus a fast-loading
  ``result_keyframes.npz`` twin of the same content.

Plus readers: PCD (ASCII + binary), KITTI velodyne ``.bin``, KITTI/TUM pose
files (for the evaluation harness).
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np
import torch

from ..ops import se3
from .rosbag import BagWriter, encode_pointcloud2, encode_pose_stamped


# ---------------------------------------------------------------------------
# PCD
# ---------------------------------------------------------------------------

def save_pcd(path: str, points: np.ndarray, intensity: Optional[np.ndarray] = None):
    """ASCII PCD with XYZI layout (pcl::io::savePCDFileASCII<PointXYZI>)."""
    points = np.asarray(points, np.float32)
    n = len(points)
    inten = (np.zeros(n, np.float32) if intensity is None
             else np.asarray(intensity, np.float32))
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\n")
        f.write("VERSION 0.7\n")
        f.write("FIELDS x y z intensity\n")
        f.write("SIZE 4 4 4 4\n")
        f.write("TYPE F F F F\n")
        f.write("COUNT 1 1 1 1\n")
        f.write(f"WIDTH {n}\n")
        f.write("HEIGHT 1\n")
        f.write("VIEWPOINT 0 0 0 1 0 0 0\n")
        f.write(f"POINTS {n}\n")
        f.write("DATA ascii\n")
        # one vectorized write: a per-point loop is minutes-slow for a
        # multi-million-point global map
        np.savetxt(f, np.column_stack([points, inten]), fmt="%.9g")


def load_pcd(path: str, with_intensity: bool = False) -> np.ndarray:
    """Reads ASCII or binary PCD; returns (N, 3) xyz float32, or (N, 4)
    xyzi when with_intensity is True (zero-filled if the file has no
    intensity field). Raises ValueError for undecodable DATA modes
    (binary_compressed etc.) rather than decoding garbage."""
    with open(path, "rb") as f:
        header = {}
        fields = []
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "FIELDS":
                fields = val.split()
            if key == "DATA":
                mode = val
                break
        if mode not in ("ascii", "binary"):
            raise ValueError(f"{path}: unsupported PCD DATA mode {mode!r}")
        n = int(header["POINTS"])
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        out_names = ("x", "y", "z", "intensity") if with_intensity \
            else ("x", "y", "z")
        width = 4 if with_intensity else 3
        if n == 0:
            return np.zeros((0, width), np.float32)
        has_i = "intensity" in fields
        # PCD COUNT: elements per field (default 1). COUNT>1 fields (PCL '_'
        # padding, histograms) change the record stride; ignoring them
        # silently decodes garbage coordinates.
        counts = [int(c) for c in header.get("COUNT", "").split()] or \
            [1] * len(fields)
        eoff = np.cumsum([0] + counts[:-1])
        if mode == "ascii":
            data = np.loadtxt(f, dtype=np.float32, max_rows=n)
            if data.ndim == 1:
                data = data[None]
            cols = []
            for name in out_names:
                if name == "intensity" and not has_i:
                    cols.append(np.zeros(data.shape[0], np.float32))
                else:
                    cols.append(data[:, int(eoff[fields.index(name)])])
            return np.stack(cols, -1).astype(np.float32)
        # binary
        formats = []
        for t, s, c in zip(types, sizes, counts):
            fmt = f"{t.lower()}{s}"
            formats.append(fmt if c == 1 else (fmt, (c,)))
        # PCL writes every pad region as a field named '_': uniquify
        # duplicates (np.dtype rejects repeated names); x/y/z/intensity
        # keep their first-occurrence names so the lookups below hold
        names, seen = [], set()
        for fld in fields:
            nm, k = fld, 0
            while nm in seen:
                k += 1
                nm = f"{fld}__pad{k}"
            seen.add(nm)
            names.append(nm)
        dtype = np.dtype({"names": names, "formats": formats})
        raw = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        cols = []
        for name in out_names:
            if name == "intensity" and not has_i:
                cols.append(np.zeros(len(raw), np.float32))
            else:
                col = raw[name]
                cols.append(col[:, 0] if col.ndim > 1 else col)
        return np.stack(cols, -1).astype(np.float32)


# ---------------------------------------------------------------------------
# Pose formats
# ---------------------------------------------------------------------------

def save_poses_kitti(path: str, poses: np.ndarray):
    """3x4 row-major per line, default-precision floats (reference :359-362)."""
    with open(path, "w") as f:
        for T in poses:
            row = [T[i, j] for i in range(3) for j in range(4)]
            f.write(" ".join(f"{v:.6g}" for v in row) + "\n")


def save_poses_tum(path: str, poses: np.ndarray, timestamps):
    """'#timestamp x y z qx qy qz qw' at fixed 8 decimals (reference
    :346,365-372)."""
    qs = se3.rot_to_quat(torch.from_numpy(
        np.asarray(poses, np.float32)[:, :3, :3])).numpy()
    with open(path, "w") as f:
        f.write("#timestamp x y z qx qy qz qw\n")
        for T, q, t in zip(poses, qs, timestamps):
            f.write(
                f"{t:.8f} {T[0, 3]:.8f} {T[1, 3]:.8f} {T[2, 3]:.8f} "
                f"{q[0]:.8f} {q[1]:.8f} {q[2]:.8f} {q[3]:.8f}\n")


def load_poses_kitti(path: str) -> np.ndarray:
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    n = len(rows)
    out = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    out[:, :3, :4] = rows
    return out


def load_poses_tum(path: str):
    data = np.loadtxt(path, comments="#").reshape(-1, 8)
    R = se3.quat_to_rot(torch.from_numpy(
        data[:, 4:8].astype(np.float32))).numpy()
    n = len(data)
    out = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    out[:, :3, :3] = R
    out[:, :3, 3] = data[:, 1:4]
    return data[:, 0], out


# ---------------------------------------------------------------------------
# KITTI raw data
# ---------------------------------------------------------------------------

def read_velodyne_bin(path: str) -> np.ndarray:
    """KITTI velodyne .bin -> (N, 4) x y z intensity float32."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def load_keyframe_archive(path: str):
    """Read a result_keyframes.npz archive (the result.bag stand-in the
    localization sibling consumes, config/config.yaml:47). Returns
    (clouds list[(Ni,3)], poses (N,4,4), timestamps (N,))."""
    z = np.load(path)
    clouds = [c[m] for c, m in zip(z["clouds"], z["masks"])]
    return clouds, z["poses"], z["timestamps"]


# ---------------------------------------------------------------------------
# Full result saving (saveFlagCallback equivalent)
# ---------------------------------------------------------------------------

def save_results(pipeline, save_dir: str, raw_scans=None):
    """Reference saveFlagCallback (:327-413): recreate <dir>/<seq>/,
    write scans + KITTI/TUM poses + voxelized map + keyframe archive per
    the config flags. raw_scans: optional list of (N,3) body clouds to use
    instead of the device store (byte-accurate raw export)."""
    cfg = pipeline.cfg
    seq_dir = os.path.join(save_dir, cfg.seq_name)
    n = pipeline.current_kf_idx
    poses = pipeline.get_corrected_keyframe_poses()
    stamps = pipeline.kf_timestamps
    # one device -> host pull of the keyframe store, shared by the kitti
    # and bag branches (the cloud store is the save's largest transfer)
    cl = ms = ii = None
    if cfg.save_in_kitti_format or cfg.save_map_bag:
        st = pipeline.store
        cl, ms, ii = (x[:n].cpu().numpy() for x in (
            st.clouds, st.cloud_masks, st.intensities))

    if cfg.save_in_kitti_format:
        scans_dir = os.path.join(seq_dir, "scans")
        if os.path.exists(seq_dir):
            shutil.rmtree(seq_dir)
        os.makedirs(scans_dir)
        clouds = raw_scans
        if clouds is None:
            clouds = [c[m] for c, m in zip(cl, ms)]
            intens = [iv[m] for iv, m in zip(ii, ms)]
        else:
            # raw_scans rows may carry intensity as a 4th column
            intens = [c[:, 3] if c.shape[1] >= 4 else None for c in clouds]
            clouds = [c[:, :3] for c in clouds]
        for i in range(n):
            save_pcd(os.path.join(scans_dir, f"{i:06d}.pcd"), clouds[i],
                     intensity=intens[i])
        save_poses_kitti(os.path.join(seq_dir, "poses_kitti.txt"), poses)
        save_poses_tum(os.path.join(seq_dir, "poses_tum.txt"), poses, stamps)

    if cfg.save_map_bag:
        os.makedirs(seq_dir, exist_ok=True)
        np.savez_compressed(
            os.path.join(seq_dir, "result_keyframes.npz"),
            clouds=cl, masks=ms, poses=poses, intensities=ii,
            timestamps=np.asarray(stamps))
        # the reference's result.bag: /keyframe_pcd + /keyframe_pose at
        # keyframe timestamps (fast_lio_sam_qn.cpp:380-396) — consumed by
        # FAST-LIO-Localization-QN (config/config.yaml:47)
        bag = BagWriter(os.path.join(seq_dir, "result.bag"))
        for i in range(n):
            t = float(stamps[i])
            xyzi = np.concatenate(
                [cl[i][ms[i]], ii[i][ms[i]][:, None]], axis=-1)
            bag.write("/keyframe_pcd", "sensor_msgs/PointCloud2", t,
                      encode_pointcloud2(t, xyzi,
                                         frame_id=cfg.map_frame))
            bag.write("/keyframe_pose", "geometry_msgs/PoseStamped", t,
                      encode_pose_stamped(t, poses[i],
                                          frame_id=cfg.map_frame))
        bag.close()

    if cfg.save_map_pcd:
        os.makedirs(seq_dir, exist_ok=True)
        pts = pipeline.get_global_map(cfg.save_voxel_resolution)
        save_pcd(os.path.join(seq_dir, f"{cfg.seq_name}_map.pcd"), pts)
    return seq_dir
