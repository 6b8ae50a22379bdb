"""Convert a KITTI raw-data drive into this framework's dataset layout.

The reference is driven on KITTI via rosbags (kitti.yaml:2-3 subscribes
/kitti/velo/pointcloud + /kitti/oxts/imu, typically produced by
kitti2bag). This tool provides the bag-free equivalent: point
`run.py --kitti` at the converted directory.

Input (KITTI raw synced+rectified or extract drive directory):
    <drive>/velodyne_points/data/*.bin        packed float32 xyzi scans
    <drive>/velodyne_points/timestamps.txt    ISO timestamps per scan
    <drive>/oxts/data/*.txt                   30-field OXTS rows
    <drive>/oxts/timestamps.txt

Output (layout consumed by run.run_kitti):
    <out>/scans/%06d.bin     (symlinked or copied)
    <out>/times.txt          scan timestamps, seconds from the first sample
    <out>/imu.txt            rows: t gx gy gz ax ay az  (body frame; OXTS
                             fields wx,wy,wz = 17..19, ax,ay,az = 11..13)

Usage:
    python -m fast_lio_sam_qn_tpu_torch.tools.kitti_convert <drive_dir> <out_dir>

A copy of the JAX package's tool of the same name: the same layout,
file for file.
"""
from __future__ import annotations

import glob
import os
import sys

import numpy as np


def _parse_timestamps(path: str) -> np.ndarray:
    """KITTI timestamps.txt ('YYYY-MM-DD HH:MM:SS.nnnnnnnnn') -> seconds."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            date, clock = line.split(" ")
            h, m, s = clock.split(":")
            out.append(int(h) * 3600 + int(m) * 60 + float(s))
    t = np.asarray(out, dtype=np.float64)
    # day wrap (midnight crossing) — monotonicize
    wrap = np.where(np.diff(t) < -3600)[0]
    for w in wrap:
        t[w + 1:] += 86400.0
    return t


# OXTS packet field indices (KITTI raw dataformat.txt)
_AX, _AY, _AZ = 11, 12, 13      # accelerations in vehicle/body frame [m/s^2]
_WX, _WY, _WZ = 17, 18, 19      # angular rates in vehicle/body frame [rad/s]


def convert(drive_dir: str, out_dir: str, link: bool = True) -> dict:
    velo_dir = os.path.join(drive_dir, "velodyne_points")
    oxts_dir = os.path.join(drive_dir, "oxts")
    scan_files = sorted(glob.glob(os.path.join(velo_dir, "data", "*.bin")))
    oxts_files = sorted(glob.glob(os.path.join(oxts_dir, "data", "*.txt")))
    if not scan_files:
        raise FileNotFoundError(f"no scans under {velo_dir}/data")
    if not oxts_files:
        raise FileNotFoundError(f"no OXTS rows under {oxts_dir}/data")
    scan_t = _parse_timestamps(os.path.join(velo_dir, "timestamps.txt"))
    oxts_t = _parse_timestamps(os.path.join(oxts_dir, "timestamps.txt"))
    n_scans = min(len(scan_files), len(scan_t))
    n_imu = min(len(oxts_files), len(oxts_t))

    t0 = min(scan_t[0], oxts_t[0])
    os.makedirs(os.path.join(out_dir, "scans"), exist_ok=True)
    for i in range(n_scans):
        dst = os.path.join(out_dir, "scans", f"{i:06d}.bin")
        if os.path.lexists(dst):
            os.remove(dst)
        if link:
            os.symlink(os.path.abspath(scan_files[i]), dst)
        else:
            import shutil

            shutil.copyfile(scan_files[i], dst)
    np.savetxt(os.path.join(out_dir, "times.txt"), scan_t[:n_scans] - t0,
               fmt="%.9f")

    imu_rows = np.zeros((n_imu, 7))
    for i in range(n_imu):
        row = np.loadtxt(oxts_files[i])
        imu_rows[i, 0] = oxts_t[i] - t0
        imu_rows[i, 1:4] = row[[_WX, _WY, _WZ]]
        imu_rows[i, 4:7] = row[[_AX, _AY, _AZ]]
    np.savetxt(os.path.join(out_dir, "imu.txt"), imu_rows, fmt="%.9f")
    return {"scans": n_scans, "imu_rows": n_imu,
            "duration_s": float(scan_t[n_scans - 1] - scan_t[0])}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 2
    info = convert(argv[0], argv[1], link="--copy" not in argv)
    print(info)
    return 0


if __name__ == "__main__":
    sys.exit(main())
