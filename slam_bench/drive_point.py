"""The point-map drive (the cell ``kitti-hdl64-point.drive``): the stream
driver's drive through the port's LIO with ``map_backend = "point"``
(FAST-LIO2's map: one point per voxel, planes fitted to the 5 nearest map
points, searched again at every iteration) and its pipeline.

Set-up, the closed loop, the sampled runs of scans and the window are
``stream.py``'s.  What differs is the map: the LIO's spans ``assoc`` (one
a plane search, four a scan) time the association, whose least time
(``roofline_point.py``) the traced run reads; the map's occupied slots are
read from ``HashGrid.occupied`` once the window has closed, with the share
of the last scan's voxels that the table could not place; and ``correct``
holds each sampled scan to ``reference/lio_points.py``
(``check_points.py``), the program's matched rows read from its last plane
search.
"""
from __future__ import annotations

import contextlib
import time

import torch

from . import check, check_points, gen, roofline_point
from . import harness as H
from .stream import IMU_CAP, Sample, _host_reading, _solve_probe, \
    initial_state


def _match_probe(sample: Sample, kept: list):
    """The plane search, wrapped: while a run is captured, the rows each
    search matched, the scan's last search (its posterior) kept."""
    def make(orig):
        def search(*args, **kwargs):
            out = orig(*args, **kwargs)
            if sample.current is not None:
                kept[:] = [out[2].clone()]
            return out
        return search
    return make


def _unplaced_share(state, res) -> float:
    """The share of the last scan's voxels that its insert left out of the
    map (every probe slot taken): its body points moved by the state's
    pose as the insert moves them, looked up in the table."""
    from fast_lio_sam_qn_tpu_torch.ops import hashgrid, voxel

    body, mask = res.cloud_body, res.cloud_mask
    pts_w = body @ state.nav.R.T + state.nav.p
    coords = torch.unique(voxel.voxel_coords(pts_w[mask], state.grid.res),
                          dim=0)
    if coords.shape[0] == 0:
        return 0.0
    missing = ~hashgrid.contains(state.grid, coords)
    return float(missing.sum()) / coords.shape[0]


def run(cell: str, work: dict, cfgj: dict, seed: int, seconds: float,
        trace: bool, device, control: bool = False) -> dict:
    from fast_lio_sam_qn_tpu_torch.models.lio import LIO
    from fast_lio_sam_qn_tpu_torch.models.pipeline import FastLioSamQnPipeline
    from fast_lio_sam_qn_tpu_torch.ops import ieskf as prog_ieskf
    from fast_lio_sam_qn_tpu_torch.ops import pgo as prog_pgo
    from fast_lio_sam_qn_tpu_torch.utils import config as prog_config

    device = torch.device(device)
    cfg = H.pipeline_config(prog_config, cfgj)
    if cfg.lio.map_backend != "point":
        raise ValueError(f"{cell}: the point drive runs the point map, not "
                         f"{cfg.lio.map_backend!r}")
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
        return state, inputs, res

    warm = work["warm_scans"]
    for i in range(warm):
        state, _, _ = one_scan(state, i)
    H.sync(device)
    setup_s = time.perf_counter() - H.T_PROCESS
    marks.append(("warm", setup_s))
    H.say(f"{cell}: set-up {setup_s:.3f} s ({len(stream)} scans of "
          f"{sensor.rays} rays cast, {pipe.current_kf_idx} keyframes; "
          + ", ".join(f"{k} at {v:.3f} s" for k, v in marks) + ")")

    # --- the measured window ---
    sample = Sample(seed, work["samples"])
    matched: list = []
    prof = H.Profile(device) if trace else None
    n_prof = work["profile_scans"] if trace else 0
    if spans:
        spans.ms()
        spans._open.clear()
    kf0 = pipe.current_kf_idx
    times, host = [], []
    window_rf = None
    with H.wrapped(prog_pgo, "optimize", _solve_probe(sample)), \
            H.wrapped(prog_ieskf, "_plane_correspondences",
                      _match_probe(sample, matched)):
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
            state, inputs, res = one_scan(state, i)
            times.append(time.perf_counter() - t0)
            if before is not None:
                kf = None
                if pipe.current_kf_idx > kf_before:
                    kf = (pipe.store.clouds[kf_before].clone(),
                          pipe.store.cloud_masks[kf_before].clone())
                sample.current.setdefault("matched", []).append(matched[0])
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
    occupied = int(state.grid.occupied.sum())
    table = state.grid.table_size
    H.say(f"{cell}: {n} scans in {window_s:.3f} s from {t_epoch:.3f} s "
          f"(epoch), "
          f"{pipe.current_kf_idx - kf0} keyframes, "
          f"{len(pipe.loop_events)} registrations; point map: {occupied} of "
          f"{table} slots occupied ({100.0 * occupied / table:.2f} %), "
          f"{100.0 * _unplaced_share(state, res):.4f} % of the last scan's "
          f"voxels left unplaced; scan ms "
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
        lc = cfg.lio
        work_ms = {"assoc": roofline_point.plane_assoc_budget(
            lc.max_points_per_scan, lc.map_table_size)["bound_ms"]}
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
    del pipe, lio, state, stream, inputs, sample, res, matched
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result["checks"] = compare(work, cfgj, runs, control)
    result["correct"] = H.verdict(result["checks"])
    return result


def compare(work, cfgj, runs, control: bool) -> dict:
    """Every number compared, beside its limit.  With ``control`` the
    program's results are replaced by the reference's computed in float32
    with TF32 matrix products (the precision below the configuration's
    float32)."""
    t0 = time.perf_counter()
    gaps = {k: [] for k in check_points.NUMBERS}
    for run in runs:
        for (before, inputs, after, kf), matched in zip(run["scans"],
                                                        run["matched"]):
            stand_in = check_points.control_scan(cfgj, before, inputs) \
                if control else None
            for k, v in check_points.scan(cfgj, before, inputs, after, kf,
                                          matched, stand_in=stand_in
                                          ).items():
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
