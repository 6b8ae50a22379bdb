"""The port's checkpoint / resume (``utils/checkpoint.py``, ``run.py
--checkpoint / --checkpoint-every / --resume``) on the CPU:

- a port checkpoint read back and written again is the same file, array
  for array;
- a run resumed from a checkpoint equals the uninterrupted run (keyframe
  count equal, poses within 1e-4 m: tests/test_run_cli.py's tolerance);
- a checkpoint written by the JAX package's ``save_checkpoint`` resumes in
  the port, within 1e-4 m of the JAX package's own resume of it;
- a config that does not fit the file raises the JAX module's error.

The fixture is a ``tools/datasets.py`` KITTI-style directory (2,048-point
scans, the "sim" preset); the port's runs keep a small keyframe store.  The
JAX side is cached with conftest.deterministic_cache."""
import contextlib
import dataclasses
import io as _io
import json
import os

import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu_torch import run
from fast_lio_sam_qn_tpu_torch.models.lio import LIO
from fast_lio_sam_qn_tpu_torch.models.pipeline import FastLioSamQnPipeline
from fast_lio_sam_qn_tpu_torch.tools import datasets
from fast_lio_sam_qn_tpu_torch.utils import checkpoint, io, sim
from fast_lio_sam_qn_tpu_torch.utils.config import Capacities

torch.set_num_threads(1)

N_SCANS, HALF = 24, 12
SMALL = ["--preset", "sim", "--scan-cap", "2048", "--table-size", "8192"]


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    scene = (sim.World.room(size=26.0, height=5.0, n_boxes=10, seed=3),
             datasets.ramped_loop(ramp=0.3, rest=0.1))
    rec = datasets.record(N_SCANS, 8192, scene=scene, standstill=0.3,
                          imu_hz=200.0, seed=5)
    datasets.write_kitti(str(root / "kitti"), rec.scans, rec.imu)
    # body-frame scans and their poses, for a run without a LIO
    os.makedirs(root / "body")
    for i, xyzi in enumerate(datasets.body_frame_scans(rec)):
        xyzi.tofile(str(root / "body" / f"{i:06d}.bin"))
    io.save_poses_kitti(str(root / "poses.txt"), rec.truth)
    return root


def _main(main, argv):
    out = _io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue())


def _poses(report):
    return io.load_poses_kitti(os.path.join(report["exported_to"],
                                            "poses_kitti.txt"))


def _small_caps(args, preset):
    """The CLI's config with a small keyframe store (64 keyframes of 2,048
    points): a checkpoint of the default store (4,096 x 8,192) takes
    seconds to compress."""
    cfg = _get_pipeline_config(args, preset)
    cfg.caps = Capacities(max_keyframes=64, max_loop_factors=16,
                          keyframe_points=2048, src_points=2048,
                          dst_points=4096)
    return cfg


_get_pipeline_config = run._get_pipeline_config


def _port(argv, small_store=True):
    """run.main on the CPU; a resume needs the saving run's capacities."""
    with pytest.MonkeyPatch.context() as mp:
        if small_store:
            mp.setattr(run, "_get_pipeline_config", _small_caps)
        return _main(run.main, argv + SMALL + ["--device", "cpu"])


def _template(**lio_over):
    """A fresh CPU pipeline and LIO template state of the fixture's config
    (with LIO fields replaced)."""
    cfg = _small_caps(run.parser().parse_args(SMALL), "sim")
    cfg.lio = dataclasses.replace(cfg.lio, **lio_over)
    lio = LIO(cfg.lio, device="cpu")
    return FastLioSamQnPipeline(cfg, device="cpu"), lio.init_state()


@pytest.fixture(scope="module")
def port_half(kitti_dir, tmp_path_factory):
    """The port's first half with periodic checkpoints (at scan 7, and the
    last one at scan 12)."""
    ck = str(tmp_path_factory.mktemp("port") / "state.npz")
    rep = _port(["--kitti", str(kitti_dir / "kitti"), "--n-scans",
                 str(HALF), "--checkpoint", ck, "--checkpoint-every", "7",
                 "--no-auto-save"])
    assert rep["checkpoint"] == ck and rep["scans"] == HALF
    return ck


def test_round_trip_is_exact(port_half, tmp_path):
    """Read into a fresh pipeline and written again: every array and the
    host block equal; the LIO state under named keys, scans included."""
    pipe, tmpl = _template()
    pipe, state, extra = checkpoint.load_checkpoint(pipe, port_half,
                                                    lio_template=tmpl)
    assert extra == {"scan_index": HALF}
    assert state.scans == HALF == int(state.num_scans)
    again = str(tmp_path / "again.npz")
    checkpoint.save_checkpoint(pipe, again, lio_state=state, extra=extra)
    a, b = np.load(port_half), np.load(again)
    assert sorted(a.files) == sorted(b.files)
    assert int(a["schema"]) == checkpoint.SCHEMA
    assert "lio.grid.key" in a.files and "lio.scans" in a.files
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    host = json.loads(bytes(a["host_json"]).decode())
    assert host["current_kf_idx"] == pipe.current_kf_idx >= 1


def test_resume_equals_the_uninterrupted_run(kitti_dir, port_half, tmp_path):
    full = _port(["--kitti", str(kitti_dir / "kitti"), "--out",
                  str(tmp_path / "full")])
    res = _port(["--kitti", str(kitti_dir / "kitti"), "--resume", port_half,
                 "--out", str(tmp_path / "resumed")])
    assert res["resumed_at"] == HALF and res["scans"] == N_SCANS
    assert res["keyframes"] == full["keyframes"] >= 2
    a, b = _poses(res), _poses(full)
    print(f"resumed vs uninterrupted: {np.abs(a - b).max():.3e} m, "
          f"bit-identical {np.array_equal(a, b)}")
    np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.fixture(scope="module")
def jax_half(kitti_dir, tmp_path_factory):
    """The JAX package's checkpoint after the first half, and its own
    resume of it (report and poses)."""
    from conftest import deterministic_cache
    from fast_lio_sam_qn_tpu.run import main as jmain

    d = str(kitti_dir / "kitti")

    def build():
        root = tmp_path_factory.mktemp("jax")
        ck = str(root / "state.npz")
        _main(jmain, ["--kitti", d, "--n-scans", str(HALF), "--checkpoint",
                      ck, "--no-auto-save"] + SMALL)
        rep = _main(jmain, ["--kitti", d, "--resume", ck, "--out",
                            str(root / "out")] + SMALL)
        return open(ck, "rb").read(), rep["keyframes"], _poses(rep)

    data, kf, poses = deterministic_cache(
        "torch_checkpoint_jax", (N_SCANS, HALF), build,
        extra_files=(__file__, datasets.__file__, sim.__file__))
    path = tmp_path_factory.mktemp("jaxfile") / "state.npz"
    path.write_bytes(data)
    return str(path), kf, poses


def test_jax_checkpoint_resumes_in_the_port(kitti_dir, jax_half, tmp_path):
    path, kf, want = jax_half
    z = np.load(path)
    assert "schema" not in z.files and "lio_leaf_16" in z.files
    res = _port(["--kitti", str(kitti_dir / "kitti"), "--resume", path,
                 "--out", str(tmp_path)], small_store=False)
    assert res["resumed_at"] == HALF and res["keyframes"] == kf
    got = _poses(res)
    print(f"port resume of the JAX file vs the JAX resume: "
          f"{np.abs(got - want).max():.3e} m")
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_pre_extrinsic_jax_file_takes_the_template_extrinsic(jax_half,
                                                            tmp_path):
    """A JAX file from before the extrinsic leaves (two fewer, appended
    last) loads with the configured extrinsic."""
    z = np.load(jax_half[0])
    old = str(tmp_path / "old.npz")
    np.savez_compressed(old, **{k: z[k] for k in z.files
                                if k not in ("lio_leaf_15", "lio_leaf_16")})
    pipe, tmpl = _template()
    _, state, extra = checkpoint.load_checkpoint(pipe, old, tmpl)
    assert extra["scan_index"] == HALF and state.scans == HALF
    assert torch.equal(state.ext.R, tmpl.ext.R)
    assert torch.equal(state.ext.t, tmpl.ext.t)
    np.testing.assert_array_equal(state.P.numpy(), z["lio_leaf_6"])


@pytest.mark.parametrize("which", ["port", "jax"])
@pytest.mark.parametrize("change", ["extrinsic_est_en", "map_table_size",
                                    "map_backend"])
def test_config_mismatch_raises(port_half, jax_half, which, change):
    over = {"extrinsic_est_en": dict(extrinsic_est_en=True),
            "map_table_size": dict(map_table_size=1 << 12),
            "map_backend": dict(map_backend="point")}[change]
    pipe, tmpl = _template(**over)
    path = port_half if which == "port" else jax_half[0]
    with pytest.raises(ValueError, match="different config"):
        checkpoint.load_checkpoint(pipe, path, lio_template=tmpl)
    assert pipe.current_kf_idx == 0     # untouched


def test_pipeline_only_checkpoint(kitti_dir, tmp_path, capsys):
    """A parity run saves the pipeline alone: it loads without a LIO state,
    and --resume refuses it."""
    ck = str(tmp_path / "p.npz")
    rep = _port(["--scans", str(kitti_dir / "body"), "--poses",
                 str(kitti_dir / "poses.txt"), "--checkpoint", ck,
                 "--no-auto-save"])
    assert rep["checkpoint"] == ck
    pipe, tmpl = _template()
    pipe, state, extra = checkpoint.load_checkpoint(pipe, ck, tmpl)
    assert state is None and extra == {}
    assert pipe.current_kf_idx == rep["keyframes"]
    with pytest.raises(SystemExit, match="holds no LIO state"):
        run.main(["--kitti", str(kitti_dir / "kitti"), "--resume", ck]
                 + SMALL + ["--device", "cpu", "--no-auto-save"])


def test_newer_schema_is_refused(port_half, tmp_path):
    host = json.loads(bytes(np.load(port_half)["host_json"]).decode())
    host["schema"] = checkpoint.SCHEMA + 1
    path = str(tmp_path / "new.npz")
    np.savez(path, schema=np.int32(host["schema"]), host_json=np.frombuffer(
        json.dumps(host).encode(), np.uint8))
    pipe, _ = _template()
    with pytest.raises(ValueError, match="newer"):
        checkpoint.load_checkpoint(pipe, path)
