"""The port's CLI layer held against the JAX package's: the reference-YAML
loaders and ``apply_strict_parity`` (``utils/config.py``), the writers and
readers of ``utils/io.py`` and the result bag (``utils/rosbag.py``), the
CLI's config assembly, and ``run.main`` in ``--sim`` mode on the CPU.

Everything here is exact: every config field equal, every exported file
byte for byte (the TUM file's quaternions come from the port's
``rot_to_quat``, fp32 like the reference's), every read-back array equal.
The ``--sim`` run is cut with ``--n-scans``, ``--scan-cap`` and
``--table-size`` to a few seconds on one thread."""
import dataclasses
import filecmp
import json
import os
import types

import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu.utils import config as jconfig
from fast_lio_sam_qn_tpu.utils import io as jio
from fast_lio_sam_qn_tpu.runtime import rosbag as jrosbag
from fast_lio_sam_qn_tpu_torch import run
from fast_lio_sam_qn_tpu_torch.utils import config, io, rosbag

torch.set_num_threads(1)

# the reference's config/config.yaml values (tests/test_config.py's dict)
REFERENCE_YAML = {
    "basic": {"map_frame": "map", "loop_update_hz": 2.0, "vis_hz": 1.0},
    "keyframe": {"keyframe_threshold": 1.5, "num_submap_keyframes": 10,
                 "enable_submap_matching": False},
    "loop": {"loop_detection_radius": 35.0,
             "loop_detection_timediff_threshold": 30.0},
    "quatro_nano_gicp_voxel_resolution": 0.3,
    "save_voxel_resolution": 0.3,
    "nano_gicp": {"thread_number": 0, "icp_score_threshold": 1.5,
                  "correspondences_number": 15, "max_iter": 32,
                  "transformation_epsilon": 0.01,
                  "euclidean_fitness_epsilon": 0.01,
                  "ransac": {"max_iter": 5,
                             "outlier_rejection_threshold": 1.0}},
    "quatro": {"enable": True, "optimize_matching": True,
               "distance_threshold": 35.0, "max_correspondences": 500,
               "fpfh_normal_radius": 0.9, "fpfh_radius": 1.5,
               "estimating_scale": False, "noise_bound": 0.3,
               "rotation": {"num_max_iter": 50, "gnc_factor": 1.4,
                            "rot_cost_diff_threshold": 0.0001}},
    "result": {"save_map_pcd": True, "save_map_bag": True,
               "save_in_kitti_format": True, "seq_name": "sequence"},
}
# every key of a FAST-LIO per-dataset YAML (fastlio_config_launch/*.yaml),
# those the loader ignores included
FAST_LIO_YAML = {
    "common": {"lid_topic": "/points_raw", "imu_topic": "/imu_raw",
               "time_sync_en": True, "time_offset_lidar_to_imu": -0.02},
    "preprocess": {"lidar_type": 3, "scan_line": 128, "scan_rate": 10,
                   "timestamp_unit": 3, "blind": 4.5},
    "mapping": {"acc_cov": 0.2, "gyr_cov": 0.05, "b_acc_cov": 0.001,
                "b_gyr_cov": 0.0005, "fov_degree": 180, "det_range": 150.0,
                "extrinsic_est_en": True,
                "extrinsic_T": [1.77, 0.0, -0.05],
                "extrinsic_R": [-1, 0, 0, 0, -1, 0, 0, 0, 1]},
    "publish": {"path_en": False, "scan_publish_en": True,
                "dense_publish_en": True, "scan_bodyframe_pub_en": True},
    "pcd_save": {"pcd_save_en": False, "interval": -1},
}
# the field of the JAX package's config that belongs to the sharded solve,
# which is not ported; no loader sets it
JAX_ONLY = {"pgo_shard_min_factors"}
# the report of the JAX CLI's --sim mode (fast_lio_sam_qn_tpu/run.py:
# 284-290, plus the export directory)
SIM_REPORT_KEYS = {"mode", "scans", "keyframes", "loops_accepted",
                   "loop_attempts", "ate_rmse_m", "timing", "exported_to"}


def _assert_same_config(port, ref):
    """Every field of the port's dataclass equals the reference's, nested
    blocks recursively; the reference's others are the unported ones."""
    mine = {f.name for f in dataclasses.fields(port)}
    theirs = {f.name for f in dataclasses.fields(ref)}
    assert mine <= theirs and theirs - mine <= JAX_ONLY, theirs - mine
    for name in mine:
        a, b = getattr(port, name), getattr(ref, name)
        if dataclasses.is_dataclass(a):
            _assert_same_config(a, b)
        else:
            assert a == b and type(a) is type(b), (name, a, b)


@pytest.mark.parametrize("tree", ["reference", "empty", "partial"])
@pytest.mark.parametrize("strict", [True, False])
def test_reference_yaml_matches_jax(tree, strict):
    tree = {"reference": REFERENCE_YAML, "empty": {},
            "partial": {"loop": {"loop_detection_radius": 20.0},
                        "quatro": {"rotation": {"numax_iter": 7}}}}[tree]
    got = config.load_reference_yaml(tree, strict_parity=strict)
    _assert_same_config(got, jconfig.load_reference_yaml(
        tree, strict_parity=strict))
    assert got.loop.num_submap_keyframes == 5      # the typo'd keys
    assert got.loop.quatro.max_num_corres == 200


@pytest.mark.parametrize("base", [None, "kitti"])
@pytest.mark.parametrize("tree", ["fast-lio", "empty"])
def test_lio_yaml_matches_jax(base, tree):
    from fast_lio_sam_qn_tpu.configs.presets import LIO_PRESETS as JPRESETS
    from fast_lio_sam_qn_tpu_torch.configs.presets import LIO_PRESETS

    tree = FAST_LIO_YAML if tree == "fast-lio" else {}
    got = config.load_lio_yaml(tree, base=base and LIO_PRESETS[base])
    want = jconfig.load_lio_yaml(tree, base=base and JPRESETS[base])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if base:
        assert got is not LIO_PRESETS[base]


def test_loaders_read_yaml_files(tmp_path):
    yaml = pytest.importorskip("yaml")
    ref, lio = tmp_path / "config.yaml", tmp_path / "kitti.yaml"
    ref.write_text(yaml.safe_dump(REFERENCE_YAML))
    lio.write_text(yaml.safe_dump(FAST_LIO_YAML))
    _assert_same_config(config.load_reference_yaml(str(ref)),
                        jconfig.load_reference_yaml(str(ref)))
    assert dataclasses.asdict(config.load_lio_yaml(str(lio))) == \
        dataclasses.asdict(jconfig.load_lio_yaml(str(lio)))


def test_json_config_reads_without_pyyaml(tmp_path, monkeypatch):
    """A JSON file is YAML too: without PyYAML (a host may lack it) the
    loaders read it as JSON, to the same config."""
    path = tmp_path / "config.json"
    path.write_text(json.dumps(REFERENCE_YAML))
    lio = tmp_path / "lio.json"
    lio.write_text(json.dumps(FAST_LIO_YAML))
    monkeypatch.setitem(__import__("sys").modules, "yaml", None)
    _assert_same_config(config.load_reference_yaml(str(path)),
                        jconfig.load_reference_yaml(REFERENCE_YAML))
    assert dataclasses.asdict(config.load_lio_yaml(str(lio))) == \
        dataclasses.asdict(jconfig.load_lio_yaml(FAST_LIO_YAML))


def test_apply_strict_parity_matches_jax():
    got, want = config.PipelineConfig(), jconfig.PipelineConfig()
    _assert_same_config(got, want)
    assert got.apply_strict_parity() is got
    want.apply_strict_parity()
    _assert_same_config(got, want)
    assert (got.loop.consensus_window, got.loop.degeneracy_gate,
            got.loop.loop_batch, got.robust_delta) == (0, False, 0, 0.0)


@pytest.mark.parametrize("kw", [
    dict(), dict(scan_cap=1024, table_size=1 << 12, loop_batch=0),
    dict(ref_config=REFERENCE_YAML, lio_config=FAST_LIO_YAML, loop_batch=3),
    dict(ref_config=REFERENCE_YAML, no_strict_parity=True)],
    ids=["preset", "overrides", "yamls", "native-gates"])
def test_cli_config_matches_jax(kw):
    """The CLI's config assembly (the YAML arguments given as dicts, which
    both loaders take) against the JAX CLI's, devices aside."""
    from fast_lio_sam_qn_tpu.run import _get_pipeline_config as jget

    args = run.parser().parse_args([])
    vars(args).update(kw)
    got = run._get_pipeline_config(args, "sim")
    _assert_same_config(got, jget(args, "sim"))
    # a copy: the preset is untouched
    assert run._get_pipeline_config(run.parser().parse_args([]), "sim") \
        .lio.max_points_per_scan == 4096


# ---------------------------------------------------------------------------
# utils/io.py and utils/rosbag.py against the JAX package's
# ---------------------------------------------------------------------------

def _poses(n, seed):
    rng = np.random.default_rng(seed)
    from fast_lio_sam_qn_tpu_torch.ops import se3

    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    # rotations near every Shepperd branch: small angles and near-pi ones
    w = rng.normal(0, 1, (n, 3))
    w[::3] *= 3.1 / np.linalg.norm(w[::3], axis=-1, keepdims=True)
    out[:, :3, :3] = se3.so3_exp(
        torch.from_numpy(w.astype(np.float32))).numpy()
    out[:, :3, 3] = rng.normal(0, 20, (n, 3))
    return out


def _same_files(a, b):
    assert open(a, "rb").read() == open(b, "rb").read(), (a, b)


def test_pose_files_byte_identical_and_read_back(tmp_path):
    poses = _poses(40, 0)
    stamps = np.cumsum(np.random.default_rng(1).uniform(0.05, 0.2, 40))
    for name, port_fn, jax_fn in (
            ("kitti", io.save_poses_kitti, jio.save_poses_kitti),
            ("tum", io.save_poses_tum, jio.save_poses_tum)):
        args = (poses,) if name == "kitti" else (poses, stamps)
        port_fn(str(tmp_path / f"port_{name}.txt"), *args)
        jax_fn(str(tmp_path / f"jax_{name}.txt"), *args)
        _same_files(tmp_path / f"port_{name}.txt",
                    tmp_path / f"jax_{name}.txt")
    path = str(tmp_path / "port_kitti.txt")
    np.testing.assert_array_equal(io.load_poses_kitti(path),
                                  jio.load_poses_kitti(path))
    np.testing.assert_allclose(io.load_poses_kitti(path), poses, atol=1e-4)
    path = str(tmp_path / "port_tum.txt")
    (t, got), (jt, want) = io.load_poses_tum(path), jio.load_poses_tum(path)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got[:, :3, :3], poses[:, :3, :3], atol=1e-6)


@pytest.mark.parametrize("intensity", [False, True])
def test_pcd_byte_identical_and_read_back(tmp_path, intensity):
    rng = np.random.default_rng(2)
    pts = rng.normal(0, 30, (500, 3)).astype(np.float32)
    inten = rng.uniform(0, 255, 500).astype(np.float32) if intensity \
        else None
    io.save_pcd(str(tmp_path / "port.pcd"), pts, intensity=inten)
    jio.save_pcd(str(tmp_path / "jax.pcd"), pts, intensity=inten)
    _same_files(tmp_path / "port.pcd", tmp_path / "jax.pcd")
    for wi in (False, True):
        got = io.load_pcd(str(tmp_path / "port.pcd"), with_intensity=wi)
        np.testing.assert_array_equal(
            got, jio.load_pcd(str(tmp_path / "port.pcd"), with_intensity=wi))
        np.testing.assert_array_equal(got[:, :3], pts)
    # a binary PCD with PCL's '_' padding fields, read alike
    rec = np.zeros(4, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("_", "<f4"), ("intensity", "<f4"),
                             ("__pad1", "<f4", (3,))])
    rec["x"], rec["intensity"] = [1, 2, 3, 4], [5, 6, 7, 8]
    head = ("VERSION 0.7\nFIELDS x y z _ intensity _\nSIZE 4 4 4 4 4 4\n"
            "TYPE F F F F F F\nCOUNT 1 1 1 1 1 3\nWIDTH 4\nHEIGHT 1\n"
            "POINTS 4\nDATA binary\n")
    (tmp_path / "bin.pcd").write_bytes(head.encode() + rec.tobytes())
    np.testing.assert_array_equal(
        io.load_pcd(str(tmp_path / "bin.pcd"), with_intensity=True),
        jio.load_pcd(str(tmp_path / "bin.pcd"), with_intensity=True))


def test_velodyne_bin_and_keyframe_archive(tmp_path):
    rng = np.random.default_rng(3)
    xyzi = rng.normal(0, 10, (300, 4)).astype(np.float32)
    xyzi.tofile(str(tmp_path / "000000.bin"))
    np.testing.assert_array_equal(
        io.read_velodyne_bin(str(tmp_path / "000000.bin")), xyzi)
    masks = rng.random((3, 100)) > 0.3
    np.savez_compressed(str(tmp_path / "kf.npz"),
                        clouds=rng.normal(0, 1, (3, 100, 3)), masks=masks,
                        poses=_poses(3, 4), timestamps=np.arange(3.0))
    got = io.load_keyframe_archive(str(tmp_path / "kf.npz"))
    want = jio.load_keyframe_archive(str(tmp_path / "kf.npz"))
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


def test_result_bag_byte_identical(tmp_path):
    poses = _poses(5, 5)
    for mod, name in ((rosbag, "port.bag"), (jrosbag, "jax.bag")):
        bag = mod.BagWriter(str(tmp_path / name))
        for i in range(5):
            t = 1.25 + 0.3 * i
            xyzi = np.random.default_rng(i).normal(0, 5, (50 + i, 4))
            bag.write("/keyframe_pcd", "sensor_msgs/PointCloud2", t,
                      mod.encode_pointcloud2(t, xyzi, frame_id="map"))
            bag.write("/keyframe_pose", "geometry_msgs/PoseStamped", t,
                      mod.encode_pose_stamped(t, poses[i], frame_id="map"))
        bag.close()
    _same_files(tmp_path / "port.bag", tmp_path / "jax.bag")
    msgs = list(jrosbag.BagReader(str(tmp_path / "port.bag")).messages())
    assert len(msgs) == 10


class _FakePipeline:
    """What ``save_results`` reads of a pipeline, the store as tensors
    (the port's) or numpy arrays (the JAX package's)."""

    def __init__(self, cfg, tensors: bool, seed=6):
        rng = np.random.default_rng(seed)
        n, pts = 4, 64
        arrays = dict(
            clouds=rng.normal(0, 5, (n + 2, pts, 3)).astype(np.float32),
            cloud_masks=rng.random((n + 2, pts)) > 0.2,
            intensities=rng.uniform(0, 100, (n + 2, pts)).astype(
                np.float32))
        wrap = torch.from_numpy if tensors else (lambda x: x)
        self.store = types.SimpleNamespace(
            **{k: wrap(v) for k, v in arrays.items()})
        self.cfg = cfg
        self.current_kf_idx = n
        self.kf_timestamps = [0.2, 1.4, 2.6, 3.8]
        self._poses = _poses(n, seed)
        self._map = rng.normal(0, 10, (200, 3)).astype(np.float32)

    def get_corrected_keyframe_poses(self):
        return self._poses

    def get_global_map(self, voxel_res=None):
        return self._map


def test_save_results_byte_identical(tmp_path):
    """Every file of the export (scans, KITTI and TUM poses, the keyframe
    archive, result.bag, the map) equal to the JAX package's."""
    got = io.save_results(_FakePipeline(config.PipelineConfig(), True),
                          str(tmp_path / "port"))
    want = jio.save_results(_FakePipeline(jconfig.PipelineConfig(), False),
                            str(tmp_path / "jax"))
    names = sorted(os.path.relpath(os.path.join(d, f), want)
                   for d, _, fs in os.walk(want) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), got)
                           for d, _, fs in os.walk(got) for f in fs)
    assert {"poses_kitti.txt", "poses_tum.txt", "result.bag",
            "result_keyframes.npz", "sequence_map.pcd",
            os.path.join("scans", "000003.pcd")} <= set(names)
    for name in names:
        if name.endswith(".npz"):
            a, b = np.load(os.path.join(got, name)), np.load(
                os.path.join(want, name))
            for k in b.files:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            assert filecmp.cmp(os.path.join(got, name),
                               os.path.join(want, name), shallow=False), name


# ---------------------------------------------------------------------------
# run.main --sim on the CPU
# ---------------------------------------------------------------------------

def test_main_sim_exports_and_reports(tmp_path, capsys):
    """A 10-scan --sim run at 1,024 points: exit 0, the JAX CLI's report
    keys, the exports on disk and readable, the watch directory's dumps,
    and a save trigger consumed mid-run."""
    out, watch = tmp_path / "out", tmp_path / "watch"
    trig, dest = tmp_path / "save_now", tmp_path / "midrun"
    trig.write_text(str(dest))
    watch.mkdir()
    (watch / "map.request").write_text("")
    rc = run.main(["--sim", "--device", "cpu", "--n-scans", "10",
                   "--scan-cap", "1024", "--table-size", "8192",
                   "--out", str(out), "--watch", str(watch),
                   "--save-trigger", str(trig)])
    assert rc == 0
    report = json.loads(capsys.readouterr().out)
    assert set(report) == SIM_REPORT_KEYS
    assert report["mode"] == "sim" and report["scans"] == 10
    assert report["keyframes"] >= 1 and np.isfinite(report["ate_rmse_m"])
    assert {"sim", "lio", "pgo"} <= set(report["timing"])
    seq = report["exported_to"]
    assert seq == os.path.join(str(out), "sequence")
    poses = io.load_poses_kitti(os.path.join(seq, "poses_kitti.txt"))
    assert poses.shape == (report["keyframes"], 4, 4)
    stamps, tum = jio.load_poses_tum(os.path.join(seq, "poses_tum.txt"))
    np.testing.assert_allclose(tum[:, :3, 3], poses[:, :3, 3], atol=1e-5)
    assert len(io.load_pcd(os.path.join(seq, "sequence_map.pcd"))) > 100
    assert os.path.exists(os.path.join(seq, "result.bag"))
    for name in ("corrected_path.txt", "odom_path.txt", "loops.json",
                 "corrected_current.pcd", "corrected_map.pcd"):
        assert (watch / name).exists(), name
    assert not (watch / "map.request").exists() and not trig.exists()
    assert (dest / "sequence" / "poses_kitti.txt").exists()


def test_main_auto_save_and_no_auto_save(tmp_path, monkeypatch, capsys):
    """Without --out the save flags export to ./results/<seq_name>, as the
    reference's destructor; --no-auto-save skips it."""
    monkeypatch.chdir(tmp_path)
    small = ["--sim", "--device", "cpu", "--n-scans", "3", "--scan-cap",
             "512", "--table-size", "4096"]
    assert run.main(small + ["--no-auto-save"]) == 0
    assert "exported_to" not in json.loads(capsys.readouterr().out)
    assert not (tmp_path / "results").exists()
    assert run.main(small) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["exported_to"] == os.path.join("results", "sequence")
    assert (tmp_path / "results" / "sequence" / "poses_tum.txt").exists()


def test_main_sim_plot_writes_png(tmp_path, capsys):
    """--plot renders the trajectories, loop edges and map to a PNG and
    names it in the report, as the JAX CLI (run.py:904-907)."""
    pytest.importorskip("matplotlib")
    png = tmp_path / "run.png"
    assert run.main(["--sim", "--device", "cpu", "--n-scans", "6",
                     "--scan-cap", "512", "--table-size", "4096",
                     "--no-auto-save", "--plot", str(png)]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["plot"] == str(png)
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_plot_without_matplotlib_stops_before_the_run(monkeypatch):
    """A host without matplotlib: --plot raises ImportError naming it
    before any scan is processed, never accepted and then ignored."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a:
                        None if name == "matplotlib" else real(name, *a))
    monkeypatch.setattr(run, "run_sim", lambda args: pytest.fail("ran"))
    with pytest.raises(ImportError, match="matplotlib") as exc:
        run.main(["--sim", "--device", "cpu", "--plot", "x.png"])
    assert exc.value.name == "matplotlib"


@pytest.mark.parametrize("flag", sorted(run._NOT_PORTED))
def test_unported_flags_stop_with_their_roadmap_item(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        run.main(["--sim", flag, "x", "--device", "cpu"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert f"{flag} is not ported yet" in err
    assert f"queue 1 item {run._NOT_PORTED[flag]}" in err


# every flag of the dataset modes: (argv, the mode it reaches, the parsed
# field and value)
PORTED_FLAGS = {
    "--kitti": (["--kitti", "D"], "run_kitti", "kitti", "D"),
    "--scans": (["--scans", "S", "--poses", "P"], "run_parity", "scans",
                "S"),
    "--poses": (["--scans", "S", "--poses", "P"], "run_parity", "poses",
                "P"),
    "--stamps": (["--scans", "S", "--poses", "P", "--stamps", "T"],
                 "run_parity", "stamps", "T"),
    "--odom-times": (["--scans", "S", "--poses", "P", "--odom-times", "O"],
                     "run_parity", "odom_times", "O"),
    "--sync-slop": (["--scans", "S", "--poses", "P", "--sync-slop", "0.2"],
                    "run_parity", "sync_slop", 0.2),
    "--world-frame": (["--scans", "S", "--poses", "P", "--world-frame"],
                      "run_parity", "world_frame", True),
    "--bag": (["--bag", "B"], "run_bag", "bag", "B"),
    "--scan-topic": (["--bag", "B", "--scan-topic", "/p"], "run_bag",
                     "scan_topic", "/p"),
    "--imu-topic": (["--bag", "B", "--imu-topic", "/i"], "run_bag",
                    "imu_topic", "/i"),
    "--odom-topic": (["--bag", "B", "--odom-topic", "/o"], "run_bag",
                     "odom_topic", "/o"),
    "--checkpoint": (["--kitti", "D", "--checkpoint", "C"], "run_kitti",
                     "checkpoint", "C"),
    "--checkpoint-every": (["--kitti", "D", "--checkpoint-every", "5"],
                           "run_kitti", "checkpoint_every", 5),
    "--resume": (["--kitti", "D", "--resume", "R"], "run_kitti", "resume",
                 "R"),
}


@pytest.mark.parametrize("flag", sorted(PORTED_FLAGS))
def test_ported_flags_reach_their_mode(flag, monkeypatch, capsys):
    """Each flag of the dataset modes parses to the JAX CLI's field and
    value and reaches its mode (the mode itself stubbed), on cuda by
    default."""
    argv, mode, field, value = PORTED_FLAGS[flag]
    seen = []

    def fake(args):
        seen.append((mode, args))
        cfg = config.PipelineConfig()
        return types.SimpleNamespace(cfg=cfg), {"mode": mode,
                                                "checkpoint": "C"}

    for name in ("run_kitti", "run_parity", "run_bag", "run_sim"):
        monkeypatch.setattr(run, name, lambda a, n=name: (
            fake(a) if n == mode else pytest.fail(f"{n} reached")))
    assert run.main(argv + ["--no-auto-save"]) == 0
    assert json.loads(capsys.readouterr().out)["mode"] == mode
    (reached, args), = seen
    assert reached == mode and getattr(args, field) == value
    assert args.device == "cuda"
    import fast_lio_sam_qn_tpu.run as jrun

    monkeypatch.setattr(jrun, mode, fake)
    monkeypatch.setattr(jrun, "_enable_compile_cache", lambda: None)
    assert jrun.main(argv + ["--no-auto-save"]) == 0
    assert getattr(seen[1][1], field) == value


@pytest.mark.parametrize("argv", [["--sim"], ["--bag", "B"],
                                  ["--scans", "S", "--poses", "P"]])
def test_resume_needs_kitti_as_in_the_jax_cli(argv, capsys):
    from fast_lio_sam_qn_tpu.run import main as jmain

    msgs = []
    for main in (run.main, jmain):
        with pytest.raises(SystemExit) as exc:
            main(argv + ["--resume", "R"])
        assert exc.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert msgs[0].endswith(
        "error: --resume is supported in integrated (--kitti) mode")
    assert msgs[0].split("error:")[1] == msgs[1].split("error:")[1]


def test_a_mode_is_required(capsys):
    with pytest.raises(SystemExit) as exc:
        run.main(["--out", "x"])
    assert exc.value.code != 0
    assert "pick a mode" in capsys.readouterr().err
