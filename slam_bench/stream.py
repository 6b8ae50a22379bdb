"""The stream driver: a drive replayed scan by scan through the port's LIO
and pipeline (the cells ``*.drive``).

Set-up casts the cell's whole sensor stream on the device and warms up on
the stream's first scans.  The window then hands scan after scan to
``LIO.process_scan`` and its result to ``FastLioSamQnPipeline.feed``; the
next scan goes in when ``feed`` has returned (a closed loop, as a recorded
drive is replayed).  A scan's time runs from handing it to
``process_scan`` to ``feed``'s return, which ends in the pipeline's one
host read.

For ``correct`` the window keeps a few runs of scans drawn from the seed
over the whole window (a reservoir sample): each run starts at a drawn
scan and lasts until a scan makes a keyframe, and keeps the LIO's state
before and after each scan, the keyframe stored and the pose-graph solves
run; ``check`` holds them to the reference once the window has closed.
"""
from __future__ import annotations

import contextlib
import resource
import time

import torch

from . import check, gen
from . import harness as H

IMU_CAP = 64
RUN_SCANS = 6        # a sampled run ends at its first keyframe or here


class Sample:
    """The reservoir of sampled runs: run r of the window's candidates
    replaces a kept one with chance k / (r + 1), drawn from the seed."""

    def __init__(self, seed: int, k: int):
        self.k = k
        self.g = torch.Generator()
        self.g.manual_seed((int(seed) * 1_000_003 + 11) % (1 << 62))
        self.kept: list = []
        self.seen = 0
        self.current = None   # the run being captured, or None

    def start(self, scan: int) -> None:
        """Open a run at this scan of the window, where none is open and
        the draw keeps it."""
        if self.current is not None:
            return
        r = self.seen
        self.seen += 1
        slot = r if r < self.k else int(
            torch.randint(r + 1, (1,), generator=self.g))
        if slot < self.k:
            self.current = {"slot": slot, "at": scan, "scans": [],
                            "solves": []}

    def add(self, before, inputs, after, keyframe):
        run = self.current
        run["scans"].append((before, inputs, after, keyframe))
        if keyframe is not None or len(run["scans"]) >= RUN_SCANS:
            if run["slot"] < len(self.kept):
                self.kept[run["slot"]] = run
            else:
                self.kept.append(run)
            self.current = None


def _solve_probe(sample: Sample):
    def make(orig):
        def optimize(graph, *args, **kwargs):
            on = sample.current is not None
            g_in = check.clone(graph) if on else None
            out = orig(graph, *args, **kwargs)
            if on:
                sample.current["solves"].append(
                    (g_in, dict(kwargs), check.clone(out)))
            return out
        return optimize
    return make


def initial_state(lio, route: gen.Route, device):
    """A fresh filter state whose world frame is the body frame at t = 0,
    moving with the route's initial velocity in that frame."""
    state = lio.init_state()
    dt = 1e-4
    t = torch.tensor([-dt, 0.0, dt], dtype=torch.float64, device=device)
    p = route.pos(t)
    v_w = (p[2] - p[0]) / (2 * dt)
    R0 = gen.rot_z(route.yaw(t[1:2]))[0]
    v0 = (R0.T @ v_w).to(torch.float32)
    return state._replace(nav=state.nav._replace(v=v0))


def _host_reading():
    """(wall seconds, process user and system CPU seconds, involuntary
    context switches, the machine's steal seconds) now, for the log."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    steal = float("nan")
    try:
        with open("/proc/stat", encoding="ascii") as fh:
            f = fh.readline().split()
        steal = int(f[8]) / 100.0
    except (OSError, IndexError, ValueError):
        pass
    return (time.perf_counter(), ru.ru_utime, ru.ru_stime, ru.ru_nivcsw,
            steal)


def run(cell: str, work: dict, cfgj: dict, seed: int, seconds: float,
        trace: bool, device, control: bool = False) -> dict:
    from fast_lio_sam_qn_tpu_torch.models.lio import LIO
    from fast_lio_sam_qn_tpu_torch.models.pipeline import FastLioSamQnPipeline
    from fast_lio_sam_qn_tpu_torch.ops import pgo as prog_pgo
    from fast_lio_sam_qn_tpu_torch.utils import config as prog_config

    device = torch.device(device)
    cfg = H.pipeline_config(prog_config, cfgj)
    sensor = gen.Sensor(**{k: cfgj["sensor"][k] for k in gen.Sensor._fields})
    route = gen.Route(**work["route"])
    marks = [("start", time.perf_counter() - H.T_PROCESS)]
    stream = gen.Stream(sensor, route, work["scene"], cfg.lio.extrinsic_R,
                        cfg.lio.extrinsic_T, seed, work["stream_scans"],
                        device, IMU_CAP, log=H.say)
    spans = H.Spans(device) if trace else None
    lio = LIO(cfg.lio, imu_cap=IMU_CAP, device=device, profiler=spans)
    pipe = FastLioSamQnPipeline(cfg, profiler=spans, device=device)
    state = initial_state(lio, route, device)
    H.sync(device)
    marks.append(("cast", time.perf_counter() - H.T_PROCESS))

    def one_scan(state, i):
        inputs = stream.inputs(i)
        lio_span = spans.span("lio") if spans else contextlib.nullcontext()
        with lio_span:
            state, res = lio.process_scan(state, *inputs)
        pipe.feed(res.pose, res.cloud_body, res.cloud_mask, inputs[-1])
        return state, inputs

    warm = work["warm_scans"]
    for i in range(warm):
        state, _ = one_scan(state, i)
    H.sync(device)
    setup_s = time.perf_counter() - H.T_PROCESS
    marks.append(("warm", setup_s))
    H.say(f"{cell}: set-up {setup_s:.3f} s ({len(stream)} scans of "
          f"{sensor.rays} rays cast, {pipe.current_kf_idx} keyframes; "
          + ", ".join(f"{k} at {v:.3f} s" for k, v in marks) + ")")

    # --- the measured window ---
    sample = Sample(seed, work["samples"])
    prof = H.Profile(device) if trace else None
    n_prof = work["profile_scans"] if trace else 0
    if spans:
        spans.ms()
        spans._open.clear()
    kf0 = pipe.current_kf_idx
    times, host = [], []
    window_rf = None
    with H.wrapped(prog_pgo, "optimize", _solve_probe(sample)):
        i = warm
        t_start, t_epoch = time.perf_counter(), time.time()
        host.append(_host_reading())
        while True:
            j = i - warm
            if prof and j == 0:
                prof.start()
                spans.annotate = True
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
                host.append(_host_reading())
            if window_rf and (j + 1 == n_prof
                              or time.perf_counter() - t_start >= seconds):
                H.sync(device)
                window_rf.__exit__(None, None, None)
                window_rf = None
                prof.stop()
                # the profiled steps ran slower: their spans are dropped
                spans.annotate = False
                spans.ms()
                spans._open.clear()
                n_prof = j + 1
            if time.perf_counter() - t_start >= seconds:
                break
        H.sync(device)
        window_s = time.perf_counter() - t_start
        host.append(_host_reading())
    n = len(times)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    occupied = int((state.grid.key[:, 3] > 0).sum())
    H.say(f"{cell}: {n} scans in {window_s:.3f} s from {t_epoch:.3f} s "
          f"(epoch), "
          f"{pipe.current_kf_idx - kf0} keyframes, "
          f"{len(pipe.loop_events)} registrations, {occupied} of "
          f"{state.grid.key.shape[0]} map slots occupied; scan ms "
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
        sp = spans.ms()
        work_ms = {"insert": _insert_bound_ms(cfg)}
        tr = H.Trace(sp, work_ms, prof.reduce())
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
    del pipe, lio, state, stream, inputs, sample
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result["checks"] = compare(work, cfgj, runs, control)
    result["correct"] = H.verdict(result["checks"])
    return result


def _insert_bound_ms(cfg) -> float:
    from . import roofline

    lc = cfg.lio
    return roofline.insert_budget(
        lc.max_points_per_scan, lc.map_table_size,
        lc.surfel_hood_cap or lc.max_points_per_scan,
        lc.surfel_halo_cap or lc.max_points_per_scan,
        lc.surfel_hood_window)["hbm_bound_ms"]


def compare(work, cfgj, runs, control: bool) -> dict:
    """Every number compared, beside its limit.  With ``control`` the
    program's results are replaced by the reference's computed in float32
    with TF32 matrix products (the precision below the configuration's
    float32)."""
    t0 = time.perf_counter()
    gaps = {k: [] for k in check.NUMBERS}
    for run in runs:
        for before, inputs, after, kf in run["scans"]:
            stand_in = check.control_scan(cfgj, before, inputs) \
                if control else None
            for k, v in check.scan(cfgj, before, inputs, after, kf,
                                   stand_in=stand_in).items():
                gaps[k].append(v)
        for g_in, kwargs, g_out in run["solves"]:
            stand_in = check.control_solve(cfgj, g_in, kwargs) \
                if control else None
            gaps["pgo_pos_m"].append(check.solve(cfgj, g_in, kwargs, g_out,
                                                 stand_in=stand_in))
    H.say(f"gaps ({time.perf_counter() - t0:.1f} s, "
          f"{sum(len(r['scans']) for r in runs)} scans from runs at window "
          f"scans {sorted(r['at'] for r in runs)}): "
          + "; ".join(f"{k} {v}" for k, v in gaps.items() if v))
    return {name: {"value": check.worst(gaps[name]), "limit": limit}
            for name, limit in work["limits"].items()}
