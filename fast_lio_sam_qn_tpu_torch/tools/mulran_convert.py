"""Convert a MulRan sequence into this framework's dataset layout.

The reference is driven on MulRan via rosbag playback with the `mulran`
preset (`fast_lio_sam_qn/launch/run.launch:32-34`,
`third_party/fastlio_config_launch/mulran.yaml` — Ouster OS1-64,
extrinsic_T (1.77, 0, -0.05), R = diag(-1,-1,1)).  This tool is the
bag-free equivalent of the MulRan "file player": point
`run.py --kitti <out> --preset mulran` at the converted directory.

Input (MulRan native sequence layout, e.g. KAIST03/):
    <seq>/sensor_data/Ouster/<stamp_ns>.bin   packed float32 xyzi scans
                                              (stamped at scan END)
    <seq>/sensor_data/xsens_imu.csv           rows: stamp_ns, quaternion
                                              x y z w, euler x y z,
                                              gyro x y z, accel x y z,
                                              [magnetic x y z]
    <seq>/global_pose.csv                     optional ground truth:
                                              stamp_ns, 12 row-major 3x4

(`sensor_data/` is optional — files directly under <seq>/ also work.)

Output (the layout consumed by run.run_kitti — shared across converters):
    <out>/scans/%06d.bin     (symlinked or copied)
    <out>/times.txt          scan-END timestamps, seconds from t0
    <out>/imu.txt            rows: t gx gy gz ax ay az (body frame)
    <out>/gt_poses_kitti.txt optional 3x4 ground-truth rows (+gt_times.txt)

Usage:
    python -m fast_lio_sam_qn_tpu_torch.tools.mulran_convert <seq_dir> <out_dir>

A copy of the JAX package's tool of the same name: the same layout,
file for file.
"""
from __future__ import annotations

import glob
import os
import sys

import numpy as np


def _find(seq_dir: str, name: str) -> str | None:
    for cand in (os.path.join(seq_dir, "sensor_data", name),
                 os.path.join(seq_dir, name)):
        if os.path.exists(cand):
            return cand
    return None


# xsens_imu.csv column indices (MulRan file-player format):
# 0 stamp_ns, 1-4 quaternion xyzw, 5-7 euler, 8-10 gyro xyz, 11-13 acc xyz,
# (14-16 magnetic, optional)
_GX, _AX = 8, 11


def convert(seq_dir: str, out_dir: str, link: bool = True) -> dict:
    ouster_dir = _find(seq_dir, "Ouster")
    imu_csv = _find(seq_dir, "xsens_imu.csv")
    if ouster_dir is None or imu_csv is None:
        raise FileNotFoundError(
            f"{seq_dir}: expected Ouster/ and xsens_imu.csv under the "
            "sequence (or its sensor_data/) directory")
    # sort by the parsed integer stamp, not lexicographically: ns filenames
    # with differing digit counts would otherwise scramble the sequence
    scan_files = sorted(
        glob.glob(os.path.join(ouster_dir, "*.bin")),
        key=lambda p: int(os.path.splitext(os.path.basename(p))[0]))
    if not scan_files:
        raise FileNotFoundError(f"no .bin scans in {ouster_dir}")
    # scan stamp = filename (nanoseconds, scan END per MulRan docs)
    scan_ns = np.asarray(
        [int(os.path.splitext(os.path.basename(p))[0]) for p in scan_files],
        dtype=np.int64)

    imu_raw = np.loadtxt(imu_csv, delimiter=",", dtype=np.float64, ndmin=2)
    if imu_raw.shape[1] < _AX + 3:
        raise ValueError(
            f"{imu_csv}: expected >= {_AX + 3} columns, got "
            f"{imu_raw.shape[1]}")
    imu_ns = imu_raw[:, 0].astype(np.int64)

    t0_ns = min(int(scan_ns[0]), int(imu_ns[0]) if len(imu_ns) else
                int(scan_ns[0]))
    times = (scan_ns - t0_ns) * 1e-9
    imu_t = (imu_ns - t0_ns) * 1e-9

    os.makedirs(os.path.join(out_dir, "scans"), exist_ok=True)
    for i, src in enumerate(scan_files):
        dst = os.path.join(out_dir, "scans", f"{i:06d}.bin")
        if os.path.lexists(dst):
            os.remove(dst)
        if link:
            os.symlink(os.path.abspath(src), dst)
        else:
            import shutil

            shutil.copyfile(src, dst)
    np.savetxt(os.path.join(out_dir, "times.txt"), times, fmt="%.9f")
    imu_out = np.column_stack(
        [imu_t, imu_raw[:, _GX:_GX + 3], imu_raw[:, _AX:_AX + 3]])
    np.savetxt(os.path.join(out_dir, "imu.txt"), imu_out, fmt="%.9f")

    report = {"scans": len(scan_files), "imu_samples": len(imu_out),
              "duration_s": float(times[-1] - times[0])}

    gt_csv = _find(seq_dir, "global_pose.csv") or os.path.join(
        seq_dir, "global_pose.csv")
    if os.path.exists(gt_csv):
        gt = np.loadtxt(gt_csv, delimiter=",", dtype=np.float64, ndmin=2)
        gt_t = (gt[:, 0].astype(np.int64) - t0_ns) * 1e-9
        rows = gt[:, 1:13]
        np.savetxt(os.path.join(out_dir, "gt_poses_kitti.txt"), rows,
                   fmt="%.9f")
        np.savetxt(os.path.join(out_dir, "gt_times.txt"), gt_t, fmt="%.9f")
        report["gt_poses"] = len(rows)
    return report


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        return 2
    report = convert(argv[0], argv[1])
    print(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
