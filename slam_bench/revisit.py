"""The revisit driver: a closed route driven through the port's LIO and
pipeline until it comes back past where it started, then measured while
every loop tick registers the pending keyframes against the lap before
(the cells ``*.revisit-*``).

The route is ``gen.Route``'s circle moved (``Shifted``) so that its centre
lies ``centre_m`` from the world origin, and the filter starts at the
route's first pose in that frame: the float32 frame of a car that has
driven that far from where its map began.  Set-up casts the stream on the
device and drives the first lap through ``LIO.process_scan`` and
``FastLioSamQnPipeline.feed``, as the drive does, up to the first tick that
finds a candidate.  The window then goes on, scan after scan, closed loop:
each 2 Hz tick registers its pending keyframes against the keyframes one
lap back in one batched registration, accepted loops are committed after
consensus, and the keyframe solve after a commit takes 5 Gauss-Newton
steps.  A scan's time runs from handing it to ``process_scan`` to
``feed``'s return.

For ``correct``, as in the drive, runs of scans drawn from the seed are
held to the LIO reference and the solves they ran (those with loop factors)
to the pose-graph reference; besides, registrations drawn from the seed
over the window (a reservoir sample) keep each stage's inputs and results
(``RegProbe``), held to the registration reference stage by stage
(``check_loop``), and every loop factor committed in the window is held to
the route's true relative pose.  With ``--trace 1`` the port's own tracer
(``utils/profiling.Profiler``) is passed to the LIO and the pipeline, so
that its spans (``lio``, ``loop``, ``reg.*``, ``opt``) and counters
(``reg_lanes``) can be read.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import NamedTuple

import torch

from . import check, check_loop, gen, stream
from . import harness as H

IMU_CAP = stream.IMU_CAP


class Shifted(NamedTuple):
    """``route`` moved by ``offset`` (x, y, z): the same speed, headings
    and lap."""

    route: gen.Route
    offset: tuple

    @property
    def speed(self) -> float:
        return self.route.speed

    @property
    def lap(self) -> float:
        return self.route.lap

    def pos(self, t: torch.Tensor) -> torch.Tensor:
        return self.route.pos(t) + torch.tensor(self.offset, dtype=t.dtype,
                                                device=t.device)

    def yaw(self, t: torch.Tensor) -> torch.Tensor:
        return self.route.yaw(t)

    def pose(self, t: torch.Tensor) -> torch.Tensor:
        return gen.pose_from(self.pos(t), self.yaw(t))


def route_of(work: dict) -> Shifted:
    """The cell's circle with its centre at ``centre_m`` (gen's circle is
    centred at (-radius, 0))."""
    base = gen.Route(**work["route"])
    cx, cy = work["centre_m"]
    return Shifted(base, (cx + base.radius, cy, 0.0))


def initial_state(lio, route, device):
    """A fresh filter state at the route's pose and velocity at t = 0."""
    state = lio.init_state()
    dt = 1e-4
    t = torch.tensor([-dt, 0.0, dt], dtype=torch.float64, device=device)
    p = route.pos(t)
    v = (p[2] - p[0]) / (2 * dt)
    R = gen.rot_z(route.yaw(t[1:2]))[0]
    nav = state.nav._replace(R=R.to(torch.float32), p=p[1].to(torch.float32),
                             v=v.to(torch.float32))
    return state._replace(nav=nav)


# ---------------------------------------------------------------------------
# the registration probe
# ---------------------------------------------------------------------------

class RegProbe:
    """Stage by stage captures of the window's registrations: registration
    r of the window replaces a kept one with chance k / (r + 1), drawn from
    the seed, as it begins (``LoopClosure._register``); while it runs, its
    features (``fpfh_stream.fpfh_radius[_batched]``), matches
    (``quatro.match_features[_batched]``), coarse solves (``quatro.solve``)
    and fine alignment (``gicp.align_batched``, with the plane covariances
    it was given) are kept.  Every tensor
    kept is one the program made for that call and does not write again:
    a reference is kept, no copy is made on the device and nothing is
    read.  Every loop
    factor added while the window is open (``pgo.add_loop_factor``) is
    kept, and with ``roof`` a list, every feature call's clouds (the
    profiled steps' work for the FPFH roofline)."""

    def __init__(self, seed: int, k: int):
        self.k = k
        self.g = torch.Generator()
        self.g.manual_seed((int(seed) * 1_000_033 + 29) % (1 << 62))
        self.kept: list = []
        self.seen = 0
        self.on = False
        self.current = None
        self.commits: list = []
        self.roof = None
        self.five_step = 0
        self.solves: list = []    # (the graph's loop count, commits made)

    def _begin(self, cs) -> None:
        r = self.seen
        self.seen += 1
        slot = r if r < self.k else int(
            torch.randint(r + 1, (1,), generator=self.g))
        if slot < self.k:
            self.current = {"slot": slot, "lanes": [
                b for b, c in enumerate(cs) if c >= 0],
                "fpfh": [], "match": [], "solve": []}

    def _end(self, out) -> None:
        cap, self.current = self.current, None
        if cap is None:
            return
        cap["valid"] = out.is_valid
        if cap["match"]:
            cap["match"] = tuple(torch.stack(x) for x in zip(*cap["match"]))
        else:
            del cap["match"]
        if cap["slot"] < len(self.kept):
            self.kept[cap["slot"]] = cap
        else:
            self.kept.append(cap)

    def wraps(self):
        """The probe's wrappers around the program's stage functions, as
        one context."""
        from fast_lio_sam_qn_tpu_torch.models.loop_closure import LoopClosure
        from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream, gicp, pgo, \
            quatro

        probe = self

        def register(orig):
            def _register(lc, store, qs, cs, batched):
                if probe.on:
                    probe._begin(cs)
                out = orig(lc, store, qs, cs, batched)
                probe._end(out)
                return out
            return _register

        def features(batched):
            def make(orig):
                def fpfh(points, mask, normal_radius, feature_radius,
                         viewpoint=None, cov_radius=0.6):
                    out = orig(points, mask, normal_radius, feature_radius,
                               viewpoint, cov_radius=cov_radius)
                    lanes = (lambda x: x) if batched else (
                        lambda x: x[None])
                    desc, valid, (_, n_valid, _) = out
                    if probe.current is not None:
                        probe.current["fpfh"].append(tuple(
                            lanes(x) for x in (
                                points, mask, viewpoint, desc, valid)))
                    if probe.roof is not None:
                        probe.roof.append(tuple(
                            lanes(x) for x in (points, mask, n_valid)))
                    return out
                return fpfh
            return make

        def matches(batched):
            def make(orig):
                def match(*args, **kwargs):
                    out = orig(*args, **kwargs)
                    if probe.current is not None:
                        lanes = zip(*out) if batched else [out]
                        probe.current["match"] += [tuple(lane)
                                                   for lane in lanes]
                    return out
                return match
            return make

        def solve(orig):
            def quatro_solve(*args, **kwargs):
                out = orig(*args, **kwargs)
                if probe.current is not None:
                    probe.current["solve"].append(out.transform)
                return out
            return quatro_solve

        def align(orig):
            def align_batched(src, src_mask, dst, dst_mask, *args, src_cov,
                              dst_cov, **kwargs):
                out = orig(src, src_mask, dst, dst_mask, *args,
                           src_cov=src_cov, dst_cov=dst_cov, **kwargs)
                if probe.current is not None:
                    probe.current["gicp"] = (src, src_mask, dst, dst_mask,
                                             out.transform)
                    probe.current["gicp_cov"] = (*src_cov, *dst_cov)
                return out
            return align_batched

        def commit(orig):
            def add_loop_factor(graph, i, j, meas, score):
                if probe.on:
                    probe.commits.append((int(i), int(j), meas))
                return orig(graph, i, j, meas, score)
            return add_loop_factor

        def steps(orig):
            def optimize(graph, *args, **kwargs):
                if probe.on:
                    probe.five_step += kwargs.get("gn_iters") == 5
                    probe.solves.append((graph.num_loops,
                                         len(probe.commits)))
                return orig(graph, *args, **kwargs)
            return optimize

        stack = contextlib.ExitStack()
        for mod, attr, make in (
                (LoopClosure, "_register", register),
                (fpfh_stream, "fpfh_radius_batched", features(True)),
                (fpfh_stream, "fpfh_radius", features(False)),
                (quatro, "match_features_batched", matches(True)),
                (quatro, "match_features", matches(False)),
                (quatro, "solve", solve),
                (gicp, "align_batched", align),
                (pgo, "add_loop_factor", commit),
                (pgo, "optimize", steps)):
            stack.enter_context(H.wrapped(mod, attr, make))
        return stack


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def _spans(records) -> tuple[dict, list]:
    """CUDA-event ms by span name (host ms on the CPU), and each loop
    tick's ``reg_lanes`` (None where the program has no such counter)."""
    spans: dict[str, list[float]] = {}
    lanes = []
    for r in records:
        if r.t1_ns == 0 or r.name.startswith("sync."):
            continue
        ms = r.device_ms if r.device_ms is not None else r.host_ms
        spans.setdefault(r.name, []).append(ms)
        if r.name == "loop":
            lanes.append(getattr(r, "reg_lanes", None))
    return spans, lanes


def run(cell: str, work: dict, cfgj: dict, seed: int, seconds: float,
        trace: bool, device, control: bool = False) -> dict:
    from fast_lio_sam_qn_tpu_torch.models.lio import LIO
    from fast_lio_sam_qn_tpu_torch.models.pipeline import FastLioSamQnPipeline
    from fast_lio_sam_qn_tpu_torch.ops import pgo as prog_pgo
    from fast_lio_sam_qn_tpu_torch.utils import config as prog_config
    from fast_lio_sam_qn_tpu_torch.utils import profiling

    device = torch.device(device)
    cfg = H.pipeline_config(prog_config, cfgj)
    sensor = gen.Sensor(**{k: cfgj["sensor"][k] for k in gen.Sensor._fields})
    route = route_of(work)
    marks = [("start", time.perf_counter() - H.T_PROCESS)]
    strm = gen.Stream(sensor, route, work["scene"], cfg.lio.extrinsic_R,
                      cfg.lio.extrinsic_T, seed, work["stream_scans"],
                      device, IMU_CAP, log=H.say)
    prof = profiling.Profiler(device) if trace else None
    lio = LIO(cfg.lio, imu_cap=IMU_CAP, device=device, profiler=prof)
    pipe = FastLioSamQnPipeline(cfg, profiler=prof, device=device)
    state = initial_state(lio, route, device)
    H.sync(device)
    marks.append(("cast", time.perf_counter() - H.T_PROCESS))

    def one_scan(state, i):
        inputs = strm.inputs(i)
        with profiling.span(prof, "lio"):
            state, res = lio.process_scan(state, *inputs)
        pipe.feed(res.pose, res.cloud_body, res.cloud_mask, inputs[-1])
        return state, inputs

    # --- set-up: the first lap, to the first tick that finds a candidate
    i = 0
    while not pipe.loop_events:
        if i >= work["setup_scans_max"]:
            H.say(f"{cell}: no loop candidate in {i} scans of set-up")
            raise RuntimeError("the route never came back")
        state, _ = one_scan(state, i)
        i += 1
    warm = i
    H.sync(device)
    setup_s = time.perf_counter() - H.T_PROCESS
    marks.append(("lap", setup_s))
    H.say(f"{cell}: set-up {setup_s:.3f} s ({len(strm)} scans of "
          f"{sensor.rays} rays cast; {warm} scans driven, "
          f"{pipe.current_kf_idx} keyframes, first candidate at keyframe "
          f"{pipe.loop_events[0].query_idx} against "
          f"{pipe.loop_events[0].closest_idx}; "
          + ", ".join(f"{k} at {v:.3f} s" for k, v in marks) + ")")

    # --- the measured window ---
    sample = stream.Sample(seed, work["samples"])
    probe = RegProbe(seed, work["reg_samples"])
    profile = H.Profile(device) if trace else None
    n_prof = work["profile_scans"] if trace else 0
    if prof:
        prof.records()
        prof.clear()
    kf0, ev0 = pipe.current_kf_idx, len(pipe.loop_events)
    loops0 = int(pipe.graph.num_loops)
    times, host = [], []
    window_rf = None
    with H.wrapped(prog_pgo, "optimize", stream._solve_probe(sample)), \
            probe.wraps():
        probe.on = True
        t_start, t_epoch = time.perf_counter(), time.time()
        host.append(stream._host_reading())
        while True:
            j = i - warm
            if profile and j == 0:
                profile.start()
                prof.annotate = True
                probe.roof = []
                window_rf = torch.profiler.record_function("window")
                window_rf.__enter__()
            sample.start(j)
            before = check.clone(state) if sample.current else None
            kf_before = pipe.current_kf_idx
            t0 = time.perf_counter()
            state, inputs = one_scan(state, i)
            times.append(time.perf_counter() - t0)
            if before is not None:
                kf = None
                if pipe.current_kf_idx > kf_before:
                    kf = (pipe.store.clouds[kf_before].clone(),
                          pipe.store.cloud_masks[kf_before].clone())
                sample.add(before, inputs, check.clone(state), kf)
            i += 1
            if j % 10 == 9:
                host.append(stream._host_reading())
            if window_rf and (j + 1 == n_prof
                              or time.perf_counter() - t_start >= seconds):
                H.sync(device)
                window_rf.__exit__(None, None, None)
                window_rf = None
                profile.stop()
                # the profiled steps ran slower: their spans are dropped
                prof.annotate = False
                roof, probe.roof = probe.roof, None
                prof.records()
                prof.clear()
                n_prof = j + 1
            if time.perf_counter() - t_start >= seconds:
                break
        H.sync(device)
        window_s = time.perf_counter() - t_start
        host.append(stream._host_reading())
        probe.on = False
    n = len(times)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    events = pipe.loop_events[ev0:]
    ticks = sorted({e.tick_time for e in events})
    H.say(f"{cell}: {n} scans in {window_s:.3f} s from {t_epoch:.3f} s "
          f"(epoch), {pipe.current_kf_idx - kf0} keyframes, {len(ticks)} "
          f"ticks registering {len(events)} lanes "
          f"({sum(e.accepted for e in events)} accepted; by thirds of the "
          f"window, accepted of lanes: {_thirds_accepted(events)}), "
          f"{len(probe.commits)} loop factors committed, "
          f"{probe.five_step} 5-step solves; scan ms "
          f"{H.summary([t * 1e3 for t in times])}, medians by thirds of the "
          f"window {H.thirds([t * 1e3 for t in times])}; host by tens of "
          f"scans [wall s, user s, system s, involuntary switches, steal s]: "
          f"{H.deltas(host)}")

    result = {"correct": False, "attempted": n, "failed": 0}
    values = {"scans_per_s": n / window_s,
              "scan_ms_p95": H.quantile(times, 0.95) * 1e3,
              "setup_s": setup_s}
    tr = None
    if trace:
        sp, lanes = _spans(prof.records())
        tr = H.Trace(sp, {"fpfh": _fpfh_bound_ms(roof),
                          "insert": stream._insert_bound_ms(cfg)},
                     profile.reduce())
        tr.reg_lanes = lanes
        result["metrics"] = H.read_per_layer(cell, tr)
        result["breakdown"] = tr.breakdown()
        H.say(f"{cell}: profiled steps: {len(tr.ops)} device operations; "
              f"by span [spans, operations, device ms]: {tr.ops_in_spans()}")
    else:
        result["metrics"] = H.end_to_end(cell, values)
    result["device"] = H.device_block(device, 1, peak, tr)

    # --- once the window has closed: the program's state goes, the
    # reference runs ---
    runs = sample.kept + ([sample.current] if sample.current else [])
    stamps = list(pipe.kf_timestamps)
    regs, commits = probe.kept, probe.commits
    # every loop committed before a solve is in its graph
    held = all(int(n) == loops0 + made for n, made in probe.solves)
    del pipe, lio, state, strm, inputs, sample, probe
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result["checks"] = compare(work, cfgj, runs, regs, commits, stamps,
                               route, control, held)
    result["correct"] = H.verdict(result["checks"])
    return result


def _thirds_accepted(events) -> list:
    """[accepted, lanes] of the loop events in each third of the window's
    ticks, for the log: where along the lap registrations are rejected."""
    n = len(events)
    return [[sum(e.accepted for e in events[i * n // 3:(i + 1) * n // 3]),
             len(events[i * n // 3:(i + 1) * n // 3])] for i in range(3)]


def _fpfh_bound_ms(clouds) -> float | None:
    """The least time of the profiled steps' FPFH calls, K3-K5 over every
    lane's cloud (``roofline_fpfh``); None where none ran."""
    from . import roofline_fpfh

    if not clouds:
        return None
    return sum(roofline_fpfh.fpfh_bound_ms(p, m, nv) for p, m, nv in clouds)


def compare(work, cfgj, runs, regs, commits, stamps, route,
            control: bool, held: bool = True) -> dict:
    """Every number compared, beside its limit.  With ``control`` the
    program's results are replaced by the reference's computed in float32
    with TF32 matrix products.  ``held`` False (a committed loop missing
    from a later solve's graph) makes ``loop_truth_m`` infinite: the
    measurement never reached the graph."""
    t0 = time.perf_counter()
    gaps = {k: [] for k in check.NUMBERS + check_loop.NUMBERS}
    for run in runs:
        for before, inputs, after, kf in run["scans"]:
            stand_in = check.control_scan(cfgj, before, inputs) \
                if control else None
            for k, v in check.scan(cfgj, before, inputs, after, kf,
                                   stand_in=stand_in).items():
                gaps[k].append(v)
        for g_in, kwargs, g_out in run["solves"]:
            if int(g_in.num_loops) == 0:
                continue
            stand_in = check.control_solve(cfgj, g_in, kwargs) \
                if control else None
            gaps["pgo_pos_m"].append(check.solve(cfgj, g_in, kwargs, g_out,
                                                 stand_in=stand_in))
    for cap in regs:
        for k, v in check_loop.registration(cfgj, cap, control).items():
            gaps[k] += v
    dev = commits[0][2].device if commits else "cpu"
    for qi, ci, meas in commits:
        ts = torch.tensor([stamps[qi], stamps[ci]], dtype=torch.float64,
                          device=dev)
        T = route.pose(ts)
        t, r = check_loop.loop_truth(meas, T[0], T[1])
        gaps["loop_truth_m"].append(t)
        gaps["loop_truth_rad"].append(r)
    if commits:
        worst = max(range(len(commits)),
                    key=lambda k: gaps["loop_truth_rad"][k])
        H.say(f"the worst loop factor by angle: window commit {worst}, "
              f"keyframes {commits[worst][:2]}, "
              f"{gaps['loop_truth_m'][worst]:.4g} m, "
              f"{gaps['loop_truth_rad'][worst]:.4g} rad")
    if not held:
        gaps["loop_truth_m"].append(math.inf)
    H.say(f"gaps ({time.perf_counter() - t0:.1f} s, "
          f"{sum(len(r['scans']) for r in runs)} scans from runs at window "
          f"scans {sorted(r['at'] for r in runs)}, {len(regs)} "
          f"registrations of {sum(len(c['lanes']) for c in regs)} lanes, "
          f"{len(commits)} loop factors): "
          + "; ".join(f"{k} {v}" for k, v in gaps.items() if v))
    return {name: {"value": check.worst(gaps[name]), "limit": limit}
            for name, limit in work["limits"].items()}
