"""The port's dataset entry points held against the JAX CLI's on one
fixture (``tools/datasets.py``: the sim golden's room, a loop from rest,
2,048-point scans at 10 Hz): ``--kitti`` (with the ``rel_times/`` sidecar
and with the synthesized sweep), ``--scans/--poses`` (index-paired, and
ApproximateTime-paired with ``--odom-times`` and ``--loop-batch 4``),
``--bag`` in LIO mode (PointCloud2 with a time field, Livox CustomMsg,
``time_sync_en``) and with ``--odom-topic``.

Both CLIs run in-process on the CPU (the port with ``--device cpu``).  The
reports' fields are equal (scans, dropped, keyframes, loop counts, the
clock offset) and the exported keyframe poses agree within 1e-4 m and 1e-4
rad (tests/test_torch_lio.py's stream tolerance: the LIO runs free over the
whole fixture).  The JAX side is cached with conftest.deterministic_cache.
"""
import contextlib
import io as _io
import json
import os

import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu_torch import run
from fast_lio_sam_qn_tpu_torch.ops import se3
from fast_lio_sam_qn_tpu_torch.tools import datasets
from fast_lio_sam_qn_tpu_torch.utils import io, sim

torch.set_num_threads(1)

N_SCANS, RAW = 24, 8192
SMALL = ["--preset", "sim", "--scan-cap", "2048", "--table-size", "8192"]
# the report's fields both CLIs fill; timing and paths aside
FIELDS = ("mode", "scans", "keyframes", "loops_accepted", "loop_attempts",
          "dropped_unmatched", "resumed_at", "scan_topic", "imu_topic",
          "odom_topic", "time_sync_offset")
MISSING_ODOM = (5, 6, 12, 13, 20)


def _scene():
    return (sim.World.room(size=26.0, height=5.0, n_boxes=10, seed=3),
            datasets.ramped_loop(ramp=0.3, rest=0.1))


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """The recording, a KITTI-style directory with and without the sweep
    sidecar, body-frame scans with drifted odometry and stamps, and bags."""
    root = tmp_path_factory.mktemp("modes")
    rec = datasets.record(N_SCANS, RAW, scene=_scene(), standstill=0.3,
                          imu_hz=200.0)
    datasets.write_kitti(str(root / "kitti"), rec.scans, rec.imu)
    # no sidecar: the sweep is synthesized, as a livox-pattern index ramp
    # over scans in firing order
    fired = datasets.record(N_SCANS, RAW, scene=_scene(), standstill=0.3,
                            imu_hz=200.0, ring_major=False)
    datasets.write_kitti(str(root / "synth"), fired.scans, fired.imu,
                         rel_times=False)
    (root / "livox.yaml").write_text("preprocess:\n  lidar_type: 1\n")
    os.makedirs(root / "body")
    for i, xyzi in enumerate(datasets.body_frame_scans(rec)):
        xyzi.tofile(str(root / "body" / f"{i:06d}.bin"))
    odom = datasets.drifted_odometry(rec.truth, seed=1, sigma=0.01)
    io.save_poses_kitti(str(root / "odom.txt"), odom)
    np.savetxt(str(root / "stamps.txt"), rec.stamps, fmt="%.9f")
    keep = [i for i in range(N_SCANS) if i not in MISSING_ODOM]
    io.save_poses_kitti(str(root / "odom_kept.txt"), odom[keep])
    np.savetxt(str(root / "odom_times.txt"), rec.stamps[keep] + 0.012,
               fmt="%.9f")
    for name, kw in (("pc2", {}), ("livox", dict(fmt="livox")),
                     ("odom", dict(odometry=odom, odom_skip=MISSING_ODOM))):
        datasets.write_bag(str(root / f"{name}.bag"),
                           datasets.bag_messages(rec, **kw), "lz4")
    skew = datasets.Recording(rec.scans, rec.imu + np.eye(7)[0] * 5.0)
    datasets.write_bag(str(root / "skew.bag"), datasets.bag_messages(skew),
                       "bz2")
    (root / "sync.yaml").write_text("common:\n  time_sync_en: true\n")
    return root


def _mode_args(root, mode):
    r = str(root)
    return {
        "kitti": ["--kitti", f"{r}/kitti"],
        "kitti-synth-sweep": ["--kitti", f"{r}/synth", "--lio-config",
                              f"{r}/livox.yaml"],
        "parity": ["--scans", f"{r}/body", "--poses", f"{r}/odom.txt",
                   "--stamps", f"{r}/stamps.txt"],
        "parity-sync": ["--scans", f"{r}/body", "--poses",
                        f"{r}/odom_kept.txt", "--stamps", f"{r}/stamps.txt",
                        "--odom-times", f"{r}/odom_times.txt",
                        "--sync-slop", "0.05", "--loop-batch", "4"],
        "bag": ["--bag", f"{r}/pc2.bag"],
        "bag-livox": ["--bag", f"{r}/livox.bag"],
        "bag-time-sync": ["--bag", f"{r}/skew.bag", "--lio-config",
                          f"{r}/sync.yaml"],
        "bag-odom": ["--bag", f"{r}/odom.bag", "--odom-topic", "/Odometry"],
    }[mode]


def _run(main, argv):
    out = _io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    report = json.loads(out.getvalue())
    seq = report["exported_to"]
    return ({k: report[k] for k in FIELDS if k in report},
            io.load_poses_kitti(os.path.join(seq, "poses_kitti.txt")),
            np.loadtxt(os.path.join(seq, "poses_tum.txt"), ndmin=2)[:, 0])


def _jax_run(root, mode):
    from conftest import deterministic_cache
    from fast_lio_sam_qn_tpu.run import main as jmain

    def build():
        return _run(jmain, _mode_args(root, mode) + SMALL + [
            "--out", str(root / f"jax-{mode}")])

    # the fixture is a function of the port's sources: key on them too
    files = [__file__, datasets.__file__, sim.__file__]
    return deterministic_cache("torch_run_modes", (mode, N_SCANS, RAW),
                               build, extra_files=files)


def _pose_gaps(a, b):
    dp = np.abs(a[:, :3, 3] - b[:, :3, 3]).max()
    dr = max(float(torch.linalg.norm(se3.so3_log(torch.from_numpy(
        x[:3, :3].T @ y[:3, :3])))) for x, y in zip(a, b))
    return float(dp), dr


@pytest.mark.parametrize("mode", [
    "kitti", "kitti-synth-sweep", "parity", "parity-sync", "bag",
    "bag-livox", "bag-time-sync", "bag-odom"])
def test_mode_matches_jax_cli(fixture, mode, tmp_path):
    got, poses, stamps = _run(run.main, _mode_args(fixture, mode) + SMALL + [
        "--device", "cpu", "--out", str(tmp_path)])
    want, jposes, jstamps = _jax_run(fixture, mode)
    assert got == want
    np.testing.assert_array_equal(stamps, jstamps)
    dp, dr = _pose_gaps(poses, jposes)
    print(f"{mode}: {got}; keyframe poses within {dp:.2e} m / {dr:.2e} rad")
    assert dp < 1e-4 and dr < 1e-4
    assert got["scans"] == {"parity-sync": N_SCANS - len(MISSING_ODOM),
                            "bag-odom": N_SCANS - len(MISSING_ODOM)}.get(
                                mode, N_SCANS)
    assert got["keyframes"] >= 2
    if mode in ("parity-sync", "bag-odom"):
        assert got["dropped_unmatched"] == len(MISSING_ODOM)
    if mode == "bag-time-sync":
        # the first-stamp rule: the first IMU stamp less the first scan's,
        # standstill included, not the clocks' 5 s (ROADMAP queue 3)
        imu_t0 = np.loadtxt(str(fixture / "kitti" / "imu.txt"))[0, 0]
        assert got["time_sync_offset"] == round(5.0 + imu_t0 - 0.1, 6)


def test_kitti_tracks_the_truth(fixture, tmp_path):
    """The port's --kitti keyframes follow the recording's truth (the LIO
    frame is the body frame at t = 0)."""
    _, poses, stamps = _run(run.main, _mode_args(fixture, "kitti") + SMALL
                            + ["--device", "cpu", "--out", str(tmp_path)])
    rec_t = np.loadtxt(str(fixture / "kitti" / "times.txt"))
    _, traj = _scene()
    T0i = np.linalg.inv(traj.pose(0.0))
    for T, t in zip(poses, stamps):
        assert t in rec_t
        err = np.linalg.norm(T[:3, 3] - (T0i @ traj.pose(t))[:3, 3])
        assert err < 0.05, (t, err)
