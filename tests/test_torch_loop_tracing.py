"""The registration's spans and the loop closure's counters on the CPU: a
pipeline fed three keyframes of a simulated room, whose tick registers the
two pending ones in one batched registration and commits the accepted
loop at once, and whose next keyframe solve takes 5 Gauss-Newton steps.  The spans and
counters add no host read: every ``feed`` makes the same reads with the
registration's spans on and off."""
import dataclasses

import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu_torch.models.pipeline import FastLioSamQnPipeline
from fast_lio_sam_qn_tpu_torch.ops import se3
from fast_lio_sam_qn_tpu_torch.utils import config, profiling, sim

torch.set_num_threads(1)

N_RAYS = 4096
REG_SPANS = ["reg.clouds", "reg.fpfh", "reg.match", "reg.quatro",
             "reg.gicp"]


def _feeds():
    """(odometry pose, body cloud, mask, time) of four scans: a room scan,
    two drifted revisits 100 s later and a fourth keyframe."""
    world = sim.World.room(size=16.0, height=5.0, n_boxes=12, seed=6)
    out = []
    for seed, yaw, xyz, twist, t in (
            (2, 0.5, (4.0, -3.0, 1.5), None, 0.0),
            (3, 0.3, (3.0, -2.0, 1.5), (0.0, 0.0, -0.1, -1.0, 0.8, 0.0),
             100.0),
            (1, 0.0, (2.0, -1.5, 1.5), (0.0, 0.0, 0.15, 1.5, -1.0, 0.1),
             110.0),
            (1, 0.0, (2.0, -1.5, 1.5), None, 250.0)):
        T = np.eye(4)
        T[:3, :3] = sim.so3_exp_np(np.array([0.0, 0.0, yaw]))
        T[:3, 3] = xyz
        scan, _ = sim.simulate_scan(world, T, n_points=N_RAYS, noise=0.01,
                                    seed=seed)
        p, m = sim.pad_cloud(scan, N_RAYS)
        if twist is not None:
            T = se3.se3_exp(torch.tensor(twist)).double().numpy() @ T
        out.append((torch.from_numpy(T.astype(np.float32)),
                    torch.from_numpy(p), torch.from_numpy(m), t))
    return out


def _run(reg_spans: bool):
    cfg = config.PipelineConfig()
    cfg.caps = config.Capacities(max_keyframes=8, max_loop_factors=4,
                                 keyframe_points=1536, src_points=1536,
                                 dst_points=1536)
    cfg.loop_update_hz = 0.005           # ticks at 0 s and 200 s
    cfg.loop.loop_batch = 4
    cfg.loop.consensus_window = 0        # commit each accepted loop
    cfg.loop.quatro = dataclasses.replace(cfg.loop.quatro,
                                          planarity_threshold=65.0)
    p = profiling.Profiler("cpu")
    pipe = FastLioSamQnPipeline(cfg, profiler=p, device="cpu")
    if not reg_spans:
        pipe.loop_closure.profiler = None
    for pose, cloud, mask, t in _feeds():
        pipe.feed(pose, cloud, mask, t)
    return p.records(), pipe


@pytest.fixture(scope="module")
def runs():
    return _run(True), _run(False)


def test_the_tick_opens_the_registration_spans(runs):
    (recs, pipe), _ = runs
    loops = [k for k, r in enumerate(recs) if r.name == "loop"]
    assert len(loops) == 2
    first, tick = loops
    assert [r.name for r in recs if r.parent == first
            and not r.name.startswith("sync.")] == []
    assert [r.name for r in recs if r.parent == tick
            and not r.name.startswith("sync.")] == REG_SPANS
    assert recs[first].reg_lanes == 0
    assert recs[tick].reg_lanes == 2
    assert recs[tick].reg_valid == sum(e.accepted for e in pipe.loop_events)
    assert recs[tick].reg_valid >= 1
    gicp = [r for r in recs if r.name == "reg.gicp"]
    assert len(gicp) == 1 and 0 < gicp[0].gicp_iters <= 32
    assert recs[tick].gicp_iters == gicp[0].gicp_iters


def test_commits_and_gauss_newton_steps(runs):
    (recs, pipe), _ = runs
    n = len(pipe.loop_idx_pairs)
    assert n == sum(e.accepted for e in pipe.loop_events) >= 1
    assert sum(r.loop_commits for r in recs if r.name == "loop") == n
    assert [r.gn_steps for r in recs if r.name == "opt"] == [2, 2, 5]
    feeds = [r for r in recs if r.name == "feed"]
    assert sum(r.gn_steps for r in feeds) == 9
    assert sum(r.loop_commits for r in feeds) == n
    assert {"reg_lanes", "reg_valid", "loop_commits", "gicp_iters",
            "gn_steps"} <= set(profiling.COUNTERS)


def test_the_spans_make_no_host_read(runs):
    (on, pipe_on), (off, pipe_off) = runs
    assert not any(r.name.startswith("reg.") for r in off)

    def reads(recs):
        return [(r.scan, r.syncs) for r in recs if r.name == "feed"]
    assert reads(on) == reads(off)
    assert [r.name for r in on if r.name.startswith("sync.")] == \
        [r.name for r in off if r.name.startswith("sync.")]
    assert pipe_on.loop_idx_pairs == pipe_off.loop_idx_pairs
    torch.testing.assert_close(pipe_on.graph.poses, pipe_off.graph.poses,
                               rtol=0, atol=0)
