"""The port's tracer (``utils/profiling.py``) and the spans the program
opens with it, on the CPU: records, parents and self time; the host reads'
``sync.*`` spans and their counters on every open ancestor; the op-level
sites with no profiler open; the PCG's iteration count and its graphs'
counters; the LIO's ``scan`` with its six stages; the pipeline's ``feed``
with its stages and reads; and records placed on a ``torch.profiler``
trace through the anchor."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu_torch.configs.presets import get_pipeline_config
from fast_lio_sam_qn_tpu_torch.models.lio import LIO
from fast_lio_sam_qn_tpu_torch.models.pipeline import FastLioSamQnPipeline
from fast_lio_sam_qn_tpu_torch.ops import pgo, voxel
from fast_lio_sam_qn_tpu_torch.run import initial_state, sim_scan_inputs
from fast_lio_sam_qn_tpu_torch.utils import config, profiling, sim

torch.set_num_threads(1)

STAGES = ["preprocess", "propagate", "deskew", "update", "evict", "insert"]


@pytest.fixture
def clock(monkeypatch):
    """The tracer's clock stepped by hand: ``clock.t`` nanoseconds."""
    class Clock:
        t = 0

        def __call__(self):
            return self.t
    c = Clock()
    monkeypatch.setattr(profiling, "_clock", c)
    return c


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_records_parents_and_self_time(clock):
    p = profiling.Profiler()
    with p.span("a", scan=7):
        clock.t += 1_000_000
        with p.span("b"):
            clock.t += 2_000_000
            with p.span("c"):
                clock.t += 500_000
        clock.t += 1_000_000
        with p.span("b"):
            clock.t += 3_000_000
    recs = p.records()
    assert [r.name for r in recs] == ["a", "b", "c", "b"]
    assert [r.parent for r in recs] == [-1, 0, 1, 0]
    assert [r.scan for r in recs] == [7, 7, 7, 7]
    assert [r.host_ms for r in recs] == [7.5, 2.5, 0.5, 3.0]
    assert [r.self_ms for r in recs] == [2.0, 2.0, 0.5, 3.0]
    assert all(r.device_ms is None for r in recs)
    s = p.summary()
    assert s["b"] == {"count": 2, "avg_ms": 2.75, "max_ms": 3.0}
    assert "device_avg_ms" not in s["a"]
    with p.span("top"):
        pass
    assert p.records()[-1].scan == -1 and p.records()[-1].parent == -1


def test_a_read_counts_on_every_open_ancestor(clock):
    p = profiling.Profiler()
    with p.span("feed", scan=3):
        with p.span("opt"):
            for _ in range(2):
                with profiling.sync("pcg"):
                    clock.t += 250_000
            profiling.add("pcg_iters", 16)
        with profiling.sync("pull"):
            clock.t += 1_000_000
    rec = _by_name(p.records())
    feed, opt = rec["feed"][0], rec["opt"][0]
    assert (feed.syncs, feed.sync_wait_ms, feed.pcg_iters) == (3, 1.5, 16)
    assert (opt.syncs, opt.sync_wait_ms, opt.pcg_iters) == (2, 0.5, 16)
    assert [(r.syncs, r.sync_wait_ms) for r in rec["sync.pcg"]] == \
        [(1, 0.25), (1, 0.25)]
    assert all(r.scan == 3 and r.events is None for r in rec["sync.pcg"])
    assert rec["sync.pull"][0].parent == 0
    s = p.summary()
    assert (s["feed"]["syncs"], s["feed"]["pcg_iters"]) == (3, 16)
    assert "pcg_iters" not in s["sync.pull"]
    p.clear()
    assert p.records() == [] and p.summary() == {}


@pytest.mark.parametrize("span", ["insert", "opt"])
@pytest.mark.parametrize("counter", ["graph_captures", "graph_replays"])
def test_graph_counters_roll_up_like_pcg_iters(clock, counter, span):
    """The CUDA-graph runner's counters count on every open ancestor and
    show in ``summary()``, as ``pcg_iters`` does, on the span of the work
    they replay: the surfel insert inside the LIO's ``scan``, the PCG
    inside a feed's ``opt``; a sibling span counts none."""
    parent = {"insert": "scan", "opt": "feed"}[span]
    p = profiling.Profiler()
    with p.span(parent, scan=1):
        with p.span(span):
            profiling.add(counter, 8)
            profiling.add("pcg_iters", 64)
            with profiling.sync("pcg"):
                clock.t += 100_000
            profiling.add(counter, 8)
        with p.span("update"):
            pass
        with p.span(span):
            profiling.add(counter, 1)
    rec = _by_name(p.records())
    assert getattr(rec[parent][0], counter) == 17
    assert [getattr(r, counter) for r in rec[span]] == [16, 1]
    assert getattr(rec["sync.pcg"][0], counter) == 0
    s = p.summary()
    assert s[parent][counter] == 17 and s[span][counter] == 17
    assert s[span]["pcg_iters"] == 64
    assert counter not in s["sync.pcg"] and counter not in s["update"]
    assert {"graph_captures", "graph_replays"} <= set(profiling.COUNTERS)
    assert not [c for c in profiling.COUNTERS if "_graph_" in c]


def test_a_solve_on_the_cpu_captures_and_replays_no_graph():
    from fast_lio_sam_qn_tpu_torch.tools.pgo_graph import build_graph

    g, _, _ = build_graph(32, device="cpu")
    var = (1e-4, 1e-4, 1e-4, 1e-2, 1e-2, 1e-2)
    p = profiling.Profiler("cpu")
    with p.span("opt"):
        pgo.optimize(g, var, var, gn_iters=2, pcg_iters=16)
    opt = p.records()[0]
    assert opt.pcg_iters > 0
    assert opt.graph_captures == opt.graph_replays == 0
    assert "graph_replays" not in p.summary()["opt"]


def test_sites_do_nothing_without_an_open_span():
    p = profiling.Profiler()
    assert profiling.sync("x") is profiling.sync("y")
    profiling.add("pcg_iters", 5)
    pts = torch.rand(64, 3) * 4.0
    voxel.voxel_downsample(pts, torch.ones(64, dtype=torch.bool), 1.0)
    assert p.records() == [] and profiling._active is None
    with p.span("x"):
        assert profiling._active is p
    assert profiling._active is None
    with pytest.raises(ValueError):
        with p.span("y"):
            raise ValueError("the span closes on the way out")
    assert profiling._active is None and p.records()[-1].t1_ns > 0


@pytest.mark.parametrize("iters", [64, 5, 0])
def test_pcg_iters_counts_the_iterations_run(iters):
    g = torch.Generator().manual_seed(1)
    n = 12
    A = torch.randn(n * 6, n * 6, generator=g, dtype=torch.float64)
    H = A @ A.T + n * torch.eye(n * 6, dtype=torch.float64)
    b = torch.randn(n, 6, generator=g, dtype=torch.float64)
    blocks = torch.stack([H[6 * i:6 * i + 6, 6 * i:6 * i + 6]
                          for i in range(n)])
    calls = []

    def hx(v):
        calls.append(1)
        return (H @ v.reshape(-1)).reshape(n, 6)
    active = torch.ones(n, 1, dtype=torch.float64)
    p = profiling.Profiler()
    with p.span("opt"):
        pgo.pcg(b, torch.linalg.inv(blocks), hx, active, iters)
    rec = _by_name(p.records())
    assert rec["opt"][0].pcg_iters == len(calls) <= iters
    assert len(rec.get("sync.pcg", [])) == len(calls) // pgo.PCG_CHECK
    if iters == 64:
        assert 0 < len(calls) < 64     # converged and stopped at a check


def _lio(profiler):
    cfg = get_pipeline_config("sim")
    cfg.lio = dataclasses.replace(cfg.lio, max_points_per_scan=2048,
                                  map_table_size=1 << 13)
    world = sim.World.room(size=26.0, height=5.0, n_boxes=10, seed=3)
    traj = sim.Trajectory.loop(radius=7.0, period=40.0)
    lio = LIO(cfg.lio, device="cpu", profiler=profiler)
    return lio, initial_state(lio, traj), world, traj


def test_process_scan_is_one_scan_span_over_its_six_stages():
    p = profiling.Profiler("cpu")
    lio, state, world, traj = _lio(p)
    for i in range(2):
        state, _ = lio.process_scan(
            state, *sim_scan_inputs(world, traj, i, 0.2, 4 * 2048))
    recs = p.records()
    scans = [k for k, r in enumerate(recs) if r.name == "scan"]
    assert [recs[k].scan for k in scans] == [0, 1]
    for k in scans:
        kids = [r for r in recs if r.parent == k]
        assert [r.name for r in kids if not r.name.startswith("sync.")] \
            == STAGES
        # numpy inputs reach the device in one copy
        assert [r.name for r in kids if r.name.startswith("sync.")] == \
            ["sync.inputs"]
        assert all(r.scan == recs[k].scan for r in kids)
        assert sum(r.host_ms for r in kids) <= recs[k].host_ms
        assert recs[k].parent == -1
        assert recs[k].syncs == sum(r.syncs for r in kids)
    assert {"scan", *STAGES, "sync.inputs"} <= set(p.summary())


def _scan_inputs(world, traj, i, kind):
    """Scan i's inputs: ``numpy`` as the simulator makes them, ``tensors``
    all as CPU tensors and no intensities, ``mixed`` numpy points, rel_t
    and mask beside tensor IMU samples."""
    inputs = list(sim_scan_inputs(world, traj, i, 0.2, 4 * 2048))
    last = {"numpy": 0, "tensors": 7, "mixed": 7}[kind]
    first = {"numpy": 0, "tensors": 0, "mixed": 3}[kind]
    inputs[first:last] = map(torch.from_numpy, inputs[first:last])
    return inputs


@pytest.mark.parametrize("kind", ["tensors", "mixed"])
def test_a_scan_sends_its_inputs_to_the_device_once_at_most(kind):
    """Tensor inputs go to the LIO's device without a trip through the
    host: with no numpy input (intensities left out) a scan opens no
    ``sync.inputs``, and with some it opens one, the numpy inputs' packed
    transfer.  The states equal those of numpy inputs bit for bit."""
    want_p, got_p = profiling.Profiler("cpu"), profiling.Profiler("cpu")
    lio_w, want, world, traj = _lio(want_p)
    lio_g, got, _, _ = _lio(got_p)
    for i in range(2):
        want, _ = lio_w.process_scan(want, *_scan_inputs(world, traj, i,
                                                         "numpy"))
        got, _ = lio_g.process_scan(got, *_scan_inputs(world, traj, i, kind))
    for p, n in ((want_p, 1), (got_p, int(kind == "mixed"))):
        recs = p.records()
        for k in [k for k, r in enumerate(recs) if r.name == "scan"]:
            assert [r.name for r in recs if r.parent == k and
                    r.name.startswith("sync.")] == ["sync.inputs"] * n
    flat = [torch.utils._pytree.tree_leaves(s) for s in (want, got)]
    assert len(flat[0]) == len(flat[1]) > 10
    assert all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(*flat))


def _pipe(profiler):
    cfg = config.PipelineConfig()
    cfg.caps = config.Capacities(max_keyframes=16, max_loop_factors=4,
                                 keyframe_points=256, src_points=512,
                                 dst_points=1024)
    cfg.loop_update_hz = 0.01      # no loop tick in these feeds
    return FastLioSamQnPipeline(cfg, profiler=profiler, device="cpu")


def _feed(pipe, x, t):
    pose = torch.eye(4)
    pose[0, 3] = x
    g = torch.Generator().manual_seed(int(t * 10))
    cloud = torch.rand(512, 3, generator=g) * 10.0
    pipe.feed(pose, cloud, torch.ones(512, dtype=torch.bool), t)


def _children(recs, k, reads=False):
    """The names of record k's children: its stages, or with ``reads`` its
    host reads but ``sync.make_pose`` (a copy inside the pose algebra)."""
    return [r.name for r in recs if r.parent == k
            and r.name.startswith("sync.") == reads
            and r.name != "sync.make_pose"]


def test_feed_spans_reads_and_pcg_iters():
    p = profiling.Profiler("cpu")
    pipe = _pipe(p)
    _feed(pipe, 0.0, 0.0)      # the first keyframe
    _feed(pipe, 0.1, 0.0)      # no keyframe, no tick
    _feed(pipe, 2.0, 0.0)      # a keyframe and a solve
    _feed(pipe, 2.1, 0.1)      # the tick armed at 0 s, no keyframe
    recs = p.records()
    feeds = [k for k, r in enumerate(recs) if r.name == "feed"]
    assert [recs[k].scan for k in feeds] == [0, 1, 2, 3]
    first, plain, key, tick = feeds
    kf_reads = ["sync.voxel", "sync.voxel", "sync.kf_count", "sync.kf_stamp"]
    assert _children(recs, first) == ["real"]
    assert _children(recs, first, reads=True) == kf_reads
    assert _children(recs, plain) == ["real"]
    assert _children(recs, plain, reads=True) == []
    real = plain + 1
    assert _children(recs, real, reads=True) == ["sync.pull"]
    assert recs[plain].host_ms > recs[real].host_ms
    assert recs[plain].syncs == recs[real].syncs >= 1
    assert recs[plain].pcg_iters == 0
    assert _children(recs, key) == ["real", "key_add", "opt"]
    k_add = next(k for k in range(key, len(recs)) if recs[k].name == "key_add")
    k_opt = next(k for k in range(key, len(recs)) if recs[k].name == "opt")
    assert _children(recs, k_add, reads=True) == kf_reads
    assert set(_children(recs, k_opt, reads=True)) == {"sync.pcg",
                                                       "sync.pgo_inv"}
    assert recs[k_opt].pcg_iters > 0
    assert recs[key].pcg_iters == recs[k_opt].pcg_iters
    assert recs[key].syncs == sum(recs[k].syncs for k in range(key + 1,
                                                              len(recs))
                                  if recs[k].parent == key)
    assert _children(recs, tick) == ["loop", "real"]
    loop = tick + 1
    names = [r.name for r in recs[loop:] if r.t0_ns < recs[loop].t1_ns]
    assert {"sync.loop_fetch", "sync.loop_closest", "sync.pull"} <= \
        set(names)
    assert pipe.current_kf_idx == 2


def test_a_pipeline_without_a_profiler_keeps_no_record():
    p = profiling.Profiler("cpu")
    pipe = _pipe(None)
    for i in range(3):
        _feed(pipe, 2.0 * i, 0.1 * i)
    assert pipe.profiler is None and pipe.current_kf_idx == 3
    assert p.records() == [] and profiling._active is None


def test_records_land_on_the_trace_through_the_anchor(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    p = profiling.Profiler("cpu", annotate=True)
    x = torch.rand(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as tp:
        p.anchor()
        for i in range(6):
            with p.span(f"block{i}"):
                for _ in range(i + 1):
                    x = torch.tanh(x @ x)
    path = tmp_path / "trace.json"
    tp.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events)
    ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    off = p.trace_offset_us(ranges)
    assert off is not None
    by_name = {n: (a, b) for n, a, b in ranges}
    gaps = []
    for r in p.records():
        a, b = by_name[r.name]
        gaps += [abs(r.t0_ns / 1e3 + off - a), abs(r.t1_ns / 1e3 + off - b)]
    assert max(gaps) < 100.0, gaps
    assert profiling.Profiler().trace_offset_us(ranges) is None
    assert np.isfinite(off)
