"""The port's benchmark entry point (``fast_lio_sam_qn_tpu_torch.bench``)
held against the JAX package's ``bench.py`` on the CPU: the benchmark's
scan pair, the whole match in both matching modes, and the product run's
decisions at a cut size; and ``main`` without a card."""
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench  # noqa: E402  (the JAX package's benchmark, at the root)
from fast_lio_sam_qn_tpu.models import pipeline as jpipeline  # noqa: E402
from fast_lio_sam_qn_tpu.ops import se3 as jse3  # noqa: E402
from fast_lio_sam_qn_tpu.ops import voxel as jvoxel  # noqa: E402
from fast_lio_sam_qn_tpu.utils import sim  # noqa: E402
from fast_lio_sam_qn_tpu_torch import bench as tbench  # noqa: E402
from fast_lio_sam_qn_tpu_torch.ops import se3  # noqa: E402

torch.set_num_threads(1)


def test_build_pair_matches_jax():
    """The benchmark's pair at its own size (16,384 rays, caps 4,352 /
    5,632): masks equal, points within 1e-5 m, viewpoints within 1e-6."""
    want = bench.build_pair()
    got = tbench.build_pair("cpu")
    np.testing.assert_allclose(got[2], np.asarray(want[2]), atol=1e-7)
    for (gv, gm, gp), (wv, wm, wp) in zip(got[:2], want[:2]):
        wm = np.asarray(wm)
        np.testing.assert_array_equal(gm.numpy(), wm)
        np.testing.assert_allclose(gv.numpy()[wm], np.asarray(wv)[wm],
                                   atol=1e-5)
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=1e-6)


# The pair of tests/test_torch_loop_closure.py: 4,096-ray scans of a 16 m
# room with 12 boxes (world seed 6), voxelized into 1,536 rows.  The JAX
# reference passes the gate on it on the CPU, whereas the benchmark's own
# 16k pair lands in its 90-degree-rotated basin on the CPU in the JAX
# package (fp32 summation order alone selects the basin there).
N_RAYS, CAP = 4096, 1536


def _small_pair():
    """((va, vma, vp1), (vb, vmb, vp2)) as numpy, voxelized by the JAX
    package, and the drift (float32) that moved scan 1."""
    world = sim.World.room(size=16.0, height=5.0, n_boxes=12, seed=6)
    T1 = np.eye(4)
    T1[:3, 3] = [2.0, -1.5, 1.5]
    T2 = np.eye(4)
    T2[:3, :3] = np.asarray(jse3.so3_exp(jnp.array([0.0, 0.0, 0.5])))
    T2[:3, 3] = [4.0, -3.0, 1.5]
    s1, _ = sim.simulate_scan(world, T1, n_points=N_RAYS, noise=0.01, seed=1)
    s2, _ = sim.simulate_scan(world, T2, n_points=N_RAYS, noise=0.01, seed=2)
    drift = np.asarray(jse3.se3_exp(jnp.array([0.0, 0.0, 0.15, 1.5, -1.0,
                                               0.1])))
    w1 = (s1 @ T1[:3, :3].T + T1[:3, 3]) @ drift[:3, :3].T + drift[:3, 3]
    w2 = s2 @ T2[:3, :3].T + T2[:3, 3]
    out = []
    for w, vp in ((w1, drift[:3, :3] @ T1[:3, 3] + drift[:3, 3]),
                  (w2, T2[:3, 3])):
        p, m = sim.pad_cloud(w, N_RAYS)
        v, vm = jvoxel.voxel_downsample(jnp.asarray(p), jnp.asarray(m), 0.3,
                                        out_cap=CAP)
        out.append((np.array(v), np.array(vm), vp.astype(np.float32)))
    return out, drift


@pytest.mark.parametrize("optimized", [True, False])
def test_full_match_matches_jax(optimized):
    """Both packages pass the gate (< 6 cm, < 0.01 rad) on the same
    clouds; converged equal, the transforms within 2 cm / 0.005 rad, the
    fitness within 5 %."""
    (src, dst), drift = _small_pair()
    wT, wfit, wconv = jax.jit(lambda s, d: bench.full_match(
        s, d, optimized=optimized))(
            tuple(map(jnp.asarray, src)), tuple(map(jnp.asarray, dst)))
    gT, gfit, gconv = tbench.full_match(
        tuple(map(torch.from_numpy, src)), tuple(map(torch.from_numpy, dst)),
        optimized=optimized)
    for T in (gT, torch.tensor(np.asarray(wT))):
        t_err, r_err = tbench.gate_error(T, drift)
        assert t_err < tbench.GATE_T and r_err < tbench.GATE_R, (t_err, r_err)
    assert bool(gconv) == bool(wconv)
    d = se3.se3_log(torch.linalg.inv(gT.double()) @ torch.tensor(
        np.asarray(wT), dtype=torch.float64))
    assert float(d[3:].norm()) < 0.02 and float(d[:3].norm()) < 0.005
    np.testing.assert_allclose(float(gfit), float(wfit), rtol=0.05)


CUT = dict(n_prefill=16, n_live=12, warm=2, lio_scan_cap=2048, kf_cap=64)


def test_pipeline_per_scan_decisions_match_jax(capsys, monkeypatch):
    """The product run at a cut size in both packages: equal active
    keyframes and live loop attempts, and equal decisions: the JAX side's
    accepted count from its stderr line, and every loop event's query,
    candidate and verdict (its pipeline caught as bench.py builds it)."""
    made = []

    class Caught(jpipeline.FastLioSamQnPipeline):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(jpipeline, "FastLioSamQnPipeline", Caught)
    want = bench.pipeline_per_scan(0.0, **CUT)
    line = capsys.readouterr().err
    n_acc = int(re.search(r"(\d+) accepted total", line).group(1))
    got, pipe, live = tbench.pipeline_per_scan(0.0, device="cpu", **CUT)
    assert set(got) == set(want)
    for key in ("pipeline_keyframes_active", "pipeline_live_loop_attempts"):
        assert got[key] == want[key], key
    assert len(live) == got["pipeline_live_loop_attempts"] > 0
    assert sum(e.accepted for e in pipe.loop_events) == n_acc

    def decisions(events):
        return [(e.query_idx, e.closest_idx, bool(e.accepted))
                for e in events]

    assert decisions(pipe.loop_events) == decisions(made[0].loop_events)
    assert got["pipeline_ms_per_scan"] > 0.0


def test_main_without_a_card_exits_nonzero(monkeypatch, capsys):
    """No CUDA device and no ``--device cpu``: main prints why and exits
    non-zero, with no record."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tbench.main([]) != 0
    out = capsys.readouterr()
    assert "no CUDA device" in out.err
    assert tbench.METRIC not in out.out
