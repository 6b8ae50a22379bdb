"""The port's benchmark entry point: per-loop Quatro + Nano-GICP match
latency and the whole product's time per scan; the counterpart of the JAX
package's ``bench.py``, whose names, workload, gates and JSON record it
keeps.

Reference baseline (BASELINE.md): 128.6 ms average per match for
FAST-LIO-SAM-QN with optimized matching (200-correspondence cap) on an
i9-10900K, KITTI seq 05 (140 ms with advanced matching).  The workload has
that shape: two ~0.3 m-voxelized keyframe scans, streaming radius FPFH,
Quatro coarse alignment, covariance-weighted GICP fine alignment.

What it runs, in order (stage lines on stderr, each with the card's name
and power limit; the record as one JSON line, the last on stdout):

1. the kernels against their plain versions on the benchmark's clouds
   (``_assert_kernel_parity``, ``_assert_batched_parity``);
2. ``full_match`` in both matching modes against the ground truth (< 6 cm,
   < 0.01 rad, converged); the single-call median of 10;
3. the host's round trip to the device (``_null_dispatch_ms``) and the
   steady-state time per match in both modes (``_amortized_ms``);
4. the product at scale (``pipeline_per_scan``): 256 keyframes of history,
   then 80 live scans at the kitti width through the LIO and the pipeline.

Usage (from the repository root; the card unless ``--device cpu``)::

    python3 -m fast_lio_sam_qn_tpu_torch.bench [--device cuda]

Without a CUDA device, and without ``--device cpu``, it exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import kernels
from .configs.presets import LIO_PRESETS
from .models.lio import LIO
from .models.loop_closure import LoopClosure
from .models.pipeline import FastLioSamQnPipeline
from .ops import fpfh_stream, knn, knn_cuda, se3, voxel
from .run import IMU_CAP, initial_state, sim_scan_inputs
from .tools import bench_pair as bp
from .utils import sim
from .utils.config import Capacities, PipelineConfig
from .utils.profiling import Profiler

BASELINE_MS = 128.6           # optimized matching (BASELINE.md)
BASELINE_ADVANCED_MS = 140.0  # advanced matching (BASELINE.md)
SRC_CAP = bp.SRC_CAP   # fits the ~3.8k occupied voxels of scan 1 (+13%)
DST_CAP = bp.DST_CAP   # fits the ~5.0k occupied voxels of scan 2 (+12%)
ADV_CORRES = 2048      # advanced-matching static correspondence ceiling
GATE_T, GATE_R = 0.06, 0.01   # ground-truth gate [m], [rad]
METRIC = "quatro_nano_gicp_loop_match_amortized_latency"

N_PREFILL_KF = 256   # active keyframes before the measured window
N_LIVE = 80          # live scans (the first PIPE_WARM warm the caches)
PIPE_WARM = 20


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    the CPU's name for a CPU device: every stage line carries it."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _say(msg: str, card: str) -> None:
    print(f"{msg} [{card}]", file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_pair(device):
    """The benchmark's scan pair on ``device``: ((va, vma, vp1), (vb, vmb,
    vp2), drift).  Scan 1 is moved by ``drift`` (the loop's error), both
    are voxelized at 0.3 m into SRC_CAP / DST_CAP rows; vp1 / vp2 are the
    sensor positions (FPFH viewpoints); drift is (4, 4) float32 numpy.
    Scan 2's rotation is taken in float32, as the JAX package's bench
    takes it."""
    device = torch.device(device)
    R2 = se3.so3_exp(torch.tensor([0.0, 0.0, bp.YAW2])).numpy()
    (s1, T1), (s2, T2) = bp.scans(R2)
    drift = se3.se3_exp(torch.tensor(bp.DRIFT_TWIST)).numpy()
    w1 = s1 @ T1[:3, :3].T + T1[:3, 3]
    w1d = w1 @ drift[:3, :3].T + drift[:3, 3]
    w2 = s2 @ T2[:3, :3].T + T2[:3, 3]
    out = []
    for w, cap, vp in ((w1d, SRC_CAP, drift[:3, :3] @ T1[:3, 3]
                        + drift[:3, 3]), (w2, DST_CAP, T2[:3, 3])):
        p, m = sim.pad_cloud(w, bp.N_SCAN)
        v, vm = voxel.voxel_downsample(
            torch.from_numpy(p).to(device), torch.from_numpy(m).to(device),
            0.3, out_cap=cap)
        out.append((v, vm, torch.from_numpy(vp.astype(np.float32)).to(
            device)))
    return out[0], out[1], drift


def _matcher(optimized: bool) -> LoopClosure:
    """The loop-closure module at the benchmark's setting (planarity 65,
    ADV_CORRES) in the given matching mode."""
    cfg = bp.bench_config(optimized)
    cfg.quatro = dataclasses.replace(cfg.quatro,
                                     advanced_max_corres=ADV_CORRES)
    return LoopClosure(cfg, SRC_CAP, DST_CAP)


def full_match(src, dst, optimized=True):
    """FPFH + Quatro coarse + GICP fine, the complete per-loop match
    (loop_closure.cpp:138-159 equivalent) on two voxelized clouds with
    their viewpoints; no voxelization inside.  ``optimized`` selects the
    reference's matching mode: True = 200-correspondence cap + spatial
    gate, False = advanced (all mutual matches up to ADV_CORRES).

    The streaming radius FPFH (0.9 m normals, 1.5 m features) also gives
    GICP's plane covariances (0.6 m), the source's rotated into the
    coarse-aligned frame, C' = R C R^T; the distinctive filter runs at
    planarity 65.  These are ``LoopClosure.coarse_to_fine_alignment``'s
    steps on one lane.  Returns (T (4, 4), fitness, converged), converged
    being Quatro's and GICP's."""
    (va, vma, vp1), (vb, vmb, vp2) = src, dst
    T, fit, _, q_conv, fine_conv = _matcher(
        optimized).coarse_to_fine_alignment(
            va[None], vma[None], vb[None], vmb[None], vp1[None], vp2[None],
            batched=False)
    return T[0], fit[0], (q_conv & fine_conv)[0]


def gate_error(T, drift):
    """(m, rad) of a match against the truth: build_pair moves scan 1 by
    ``drift``, so a correct match satisfies T @ drift ~ I."""
    err = se3.se3_log(T.detach().double().cpu()
                      @ torch.from_numpy(np.asarray(drift, np.float64)))
    return float(torch.linalg.norm(err[3:])), float(torch.linalg.norm(
        err[:3]))


def _assert_kernel_parity(cloud, mask):
    """K1 (the kNN kernel) at k = 15 on the first 2,048 rows of ``cloud``
    against ``knn.brute_knn``: validity equal, d2 within 2e-3 relative;
    K2 (the banded kernel) equal to K1 bit for bit on the Morton-sorted
    rows.  Returns the measured gaps; on a CPU tensor, where the wrappers
    take their plain versions, it returns None at once."""
    if cloud.device.type != "cuda":
        return None
    sub, smask = cloud[:2048].contiguous(), mask[:2048].contiguous()
    d_k, _, v_k = knn_cuda.knn(sub, smask, sub, smask, 15)
    d_x, _, v_x = knn.brute_knn(sub, smask, sub, smask, 15)
    if not torch.equal(v_k, v_x):
        raise AssertionError("kNN kernel validity mismatch")
    rel = float(torch.where(v_k, torch.abs(d_k - d_x) / torch.clamp(
        d_x, min=1e-6), 0.0).max())
    if not rel < 2e-3:
        raise AssertionError(f"kNN kernel distance mismatch: {rel}")
    order = knn_cuda.morton_order(sub, smask)
    qs, ms = sub[order], smask[order]
    d_b, i_b, v_b = knn_cuda.knn_banded(qs, ms, qs, ms, 1)
    d_u, i_u, v_u = knn_cuda.knn(qs, ms, qs, ms, 1)
    if not torch.equal(v_b, v_u):
        raise AssertionError("banded kNN validity mismatch")
    differ = int((v_b & ((d_b != d_u) | (i_b != i_u))).sum())
    if differ:
        raise AssertionError(f"banded kNN != kNN on sorted inputs: {differ} "
                             f"rows differ")
    return {"knn_k15_d2_rel": rel, "banded_vs_knn_rows_differ": differ}


def _assert_batched_parity(src, dst):
    """The batched kernels against the single-cloud calls on two lanes
    with different masks and boxes: the banded kNN (K2b) bit for bit on
    each lane's Morton-sorted rows, and ``fpfh_radius_batched`` (K3b-K5b)
    against ``fpfh_radius`` on each lane: descriptors within 5e-3,
    validity exact, covariances within 1e-5.  Returns the measured gaps;
    None at once on CPU tensors."""
    (va, vma, vp1), (vb, vmb, _) = src, dst
    if va.device.type != "cuda":
        return None
    n = 2048
    sub_s, sm = va[:n], vma[:n]
    sub_d, dm = vb[:n], vmb[:n]
    ar = torch.arange(n, device=va.device)
    src_b = torch.stack([sub_s, sub_s + 0.05])
    dst_b = torch.stack([sub_d, sub_d - 0.05])
    sm_b = torch.stack([sm, sm & (ar % 7 != 0)])
    dm_b = torch.stack([dm, dm & (ar % 5 != 0)])
    so = knn_cuda.morton_order_batched(src_b, sm_b)
    do = knn_cuda.morton_order_batched(dst_b, dm_b)
    lanes = [knn_cuda.take_rows(x, o) for x, o in
             ((src_b, so), (sm_b, so), (dst_b, do), (dm_b, do))]
    got = knn_cuda.knn_banded_batched(*lanes, 1)
    for i in range(2):
        want = knn_cuda.knn_banded(*(x[i] for x in lanes), 1)
        if not torch.equal(got[2][i], want[2]):
            raise AssertionError(f"batched banded kNN validity (lane {i})")
        ok = torch.where(want[2], (got[0][i] == want[0])
                         & (got[1][i] == want[1]), True)
        if not bool(ok.all()):
            raise AssertionError(f"batched banded kNN != per-lane (lane {i})")
    vps = torch.stack([vp1, vp1 + 0.1])
    d, f, (_, _, cv) = fpfh_stream.fpfh_radius_batched(
        src_b, sm_b, 0.9, 1.5, vps, cov_radius=0.6)
    gaps = {}
    for i in range(2):
        wd, wf, (_, _, wc) = fpfh_stream.fpfh_radius(
            src_b[i], sm_b[i], 0.9, 1.5, viewpoint=vps[i], cov_radius=0.6)
        for g, w, name, tol in ((d[i], wd, "desc", 5e-3),
                                (f[i], wf, "valid", 0.0),
                                (cv[i], wc, "cov", 1e-5)):
            diff = float(torch.abs(g.float() - w.float()).max())
            gaps[f"lane{i}_{name}"] = diff
            if not diff <= tol:
                raise AssertionError(
                    f"batched streaming FPFH != per-lane: lane {i} field "
                    f"{name} maxdiff {diff}")
    return gaps


def pipeline_per_scan(null_ms, n_prefill=N_PREFILL_KF, n_live=N_LIVE,
                      warm=PIPE_WARM, lio_scan_cap=None, kf_cap=512,
                      device="cuda", card="cpu", live_window=None):
    """The whole product's cost per scan: the LIO step, the keyframe
    voxelization and append, a pose-graph solve per keyframe, the share of
    the loop ticks and the host loop, by the host clock over a steady
    window of the real pipeline with >= 256 active keyframes.

    Set-up: the kitti preset's LIO (32,768-point scans, 2^19-slot map;
    identity extrinsics: the simulated IMU rides the body frame) on a 15 m
    circle at 4 m/s in an 80 m room.  The store is first filled with 256
    keyframes of history through the pipeline itself (external-odometry
    feeds of 8,192-ray scans along earlier laps, stamped more than 30 s
    before the live window, so every one passes the loop's time gate);
    the prefill's seconds go to stderr, outside the number.  Then the live
    window runs the LIO and the pipeline at 10 Hz with loop ticks that
    register against the history.  The live scans (131,072 rays) and
    their 200 Hz IMU are generated and moved to ``device`` first; each
    ``feed`` ends in the pipeline's one host read a scan, and the window
    ends in a synchronize and one read of the last pose.  ``live_window``,
    where given, is a context manager entered around the timed window
    (chip_smoke.py counts the kernels' launches in it).

    ``lio_scan_cap`` cuts the LIO's width (with a 2^17-slot map) for the
    CPU tests.  Returns (record, pipeline, live loop events), the record
    holding bench.py's ``pipeline_*`` keys."""
    device = torch.device(device)
    cfg = PipelineConfig()
    cfg.caps = Capacities(max_keyframes=kf_cap, max_loop_factors=256,
                          keyframe_points=2048, src_points=2048,
                          dst_points=4096)
    cfg.lio = dataclasses.replace(
        LIO_PRESETS["kitti"], extrinsic_T=(0.0, 0.0, 0.0),
        extrinsic_R=(1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0))
    if lio_scan_cap:
        cfg.lio = dataclasses.replace(
            cfg.lio, max_points_per_scan=lio_scan_cap,
            map_table_size=1 << 17)

    speed = 4.0
    radius = 15.0  # the whole circle within the 35 m loop radius
    lap = 2.0 * np.pi * radius
    traj = sim.Trajectory.loop(radius=radius, period=lap / speed)
    world = sim.World.room(size=80.0, height=6.0, n_boxes=24, seed=11)
    T0_inv = np.linalg.inv(traj.pose(0.0))

    pipe = FastLioSamQnPipeline(cfg, device=device)
    step_t = 1.6 / speed  # 1.6 m spacing > the 1.5 m keyframe gate
    t_pre = -(n_prefill + 1) * step_t - 31.0  # clear the 30 s timediff
    raw_n = 4 * cfg.lio.max_points_per_scan

    def prefill_scan(k):
        scan, _ = sim.simulate_scan(world, traj.pose(t_pre + k * step_t),
                                    n_points=8192, noise=0.01, seed=500 + k)
        return sim.pad_cloud(scan, 8192)

    def live_scan(i):
        return sim_scan_inputs(world, traj, i, 0.1, raw_n, seed=700)

    # the simulator is numpy, which releases the GIL in its ray casts: a
    # thread pool generates the scans (each from its own seed) ahead
    t_start = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        history = list(pool.map(prefill_scan, range(n_prefill)))
        live = list(pool.map(live_scan, range(n_live)))
    _say(f"pipeline scans: {n_prefill} x 8192 and {n_live} x {raw_n} rays "
         f"generated in {time.perf_counter() - t_start:.1f} s", card)

    # --- prefill: n_prefill keyframes of history along earlier laps ---
    t_start = time.perf_counter()
    for k, (cloud, mask) in enumerate(history):
        t = t_pre + k * step_t
        pipe.feed(T0_inv @ traj.pose(t), torch.from_numpy(cloud).to(device),
                  torch.from_numpy(mask).to(device), float(t))
    if pipe.current_kf_idx < n_prefill:
        raise AssertionError(f"prefill made {pipe.current_kf_idx} keyframes")
    _say(f"pipeline prefill: {n_prefill} feeds, {pipe.current_kf_idx} "
         f"keyframes, {len(pipe.loop_events)} loop attempts in "
         f"{time.perf_counter() - t_start:.1f} s", card)

    # --- the live 10 Hz window, moved to the device ahead ---
    lio = LIO(cfg.lio, imu_cap=IMU_CAP, device=device)
    state = initial_state(lio, traj)
    inten = np.zeros(raw_n, np.float32)
    feeds = [[torch.from_numpy(a).to(device) for a in (*arrays, inten)]
             + [t0g, t1g] for *arrays, t0g, t1g in live]
    _sync(device)

    def one_scan(state, f, prof=None):
        cloud, rel_t, mask, it, ig, ia, im, inten, t0g, t1g = f
        with (contextlib.nullcontext() if prof is None
              else prof.span("lio")):
            state, res = lio.process_scan(state, cloud, rel_t, mask, it, ig,
                                          ia, im, t0g, t1g, inten=inten)
        pipe.feed(res.pose, res.cloud_body, res.cloud_mask, t1g)
        return state

    for f in feeds[:warm]:
        state = one_scan(state, f)

    live_prof = Profiler()
    pipe.profiler = live_prof
    kf0, att0 = pipe.current_kf_idx, len(pipe.loop_events)
    with live_window() if live_window else contextlib.nullcontext():
        t0 = time.perf_counter()
        for f in feeds[warm:]:
            state = one_scan(state, f, live_prof)
        _sync(device)
        # the last scan's trailing work, forced by one read
        float(pipe.graph.poses[pipe.current_kf_idx - 1].sum())
        wall_ms = (time.perf_counter() - t0) * 1e3
    n_timed = n_live - warm
    ms = wall_ms / n_timed

    s = live_prof.stats
    d_kf = pipe.current_kf_idx - kf0
    live = pipe.loop_events[att0:]
    n_acc = sum(1 for e in pipe.loop_events if e.accepted)
    if pipe.current_kf_idx < min(256, n_prefill):
        raise AssertionError(f"{pipe.current_kf_idx} active keyframes")
    if not live:
        raise AssertionError("live window never attempted a loop "
                             "registration")
    _say(f"pipeline per-scan: {ms:.1f} ms over {n_timed} scans "
         f"({pipe.current_kf_idx} active kfs, +{d_kf} live kfs, "
         f"{len(live)} live loop attempts, {n_acc} accepted total) | "
         f"stage avgs: "
         f"{live_prof.report_line(['lio', 'real', 'key_add', 'opt', 'loop'])}"
         f" | counts: { {k: v.count for k, v in s.items()} }", card)
    record = {
        "pipeline_ms_per_scan": ms,
        "pipeline_hz": 1000.0 / ms,
        # the host's round trip per scan (the pipeline's one read) beside
        # the whole: both views, as bench.py gives them
        "pipeline_ms_per_scan_less_dispatch": ms - null_ms,
        "pipeline_keyframes_active": int(pipe.current_kf_idx),
        "pipeline_live_loop_attempts": len(live),
        "pipeline_stage_opt_ms": s["opt"].avg_ms if "opt" in s else None,
        "pipeline_stage_loop_ms": s["loop"].avg_ms if "loop" in s else None,
    }
    return record, pipe, live


def _null_dispatch_ms(device):
    """The host's round trip to the device: the median of 10 one-element
    ops, each ending in ``.item()``."""
    a = torch.zeros((), device=device)
    (a + 1.0).item()
    ts = []
    for _ in range(10):
        t0 = time.perf_counter()
        (a + 1.0).item()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def _amortized_ms(src, dst, optimized=True):
    """Steady-state time per match: chains of r1 = 3 and r2 = 13 matches,
    each match's inputs (both clouds and both viewpoints) moved by the
    previous match's output, each chain ending in a synchronize; the
    result is (t13 - t3) / 10 by the host clock.

    The JAX package chains the matches inside one ``fori_loop``, where the
    dependency keeps XLA from hoisting loop-invariant work out of the
    loop.  Eager PyTorch hoists nothing; the dependency stays so that the
    number means the same in both packages."""
    (va, vma, vp1), (vb, vmb, vp2) = src, dst
    device = va.device

    def chain(r):
        carry = torch.zeros((), device=device)
        for _ in range(r):
            eps = carry * 1e-9
            T, fit, _ = full_match((va + eps, vma, vp1 + eps),
                                   (vb + eps, vmb, vp2 + eps),
                                   optimized=optimized)
            carry = fit + T.sum() * 1e-9
        _sync(device)
        return carry

    r1, r2 = 3, 13
    chain(r1)
    chain(r2)
    t0 = time.perf_counter()
    chain(r1)
    ta = time.perf_counter() - t0
    t0 = time.perf_counter()
    chain(r2)
    tb = time.perf_counter() - t0
    return (tb - ta) * 1e3 / (r2 - r1)


def gated_match(src, dst, drift, optimized, card):
    """One ``full_match`` held to the ground truth: converged, and within
    GATE_T / GATE_R.  Returns (T, fitness, (m, rad))."""
    T, fit, conv = full_match(src, dst, optimized=optimized)
    mode = "optimized" if optimized else "advanced"
    if not bool(conv):
        raise AssertionError(f"{mode}-matching bench match did not converge")
    t_err, r_err = gate_error(T, drift)
    _say(f"match error vs ground truth ({mode}): {t_err * 100:.2f} cm, "
         f"{np.degrees(r_err):.3f} deg ({r_err:.5f} rad), fitness "
         f"{float(fit):.4f}", card)
    if not (t_err < GATE_T and r_err < GATE_R):
        raise AssertionError(f"{mode} bench match inaccurate: {t_err:.4f} m "
                             f"/ {r_err:.5f} rad")
    return T, fit, (t_err, r_err)


def measure(device, card, live_window=None):
    """Everything the benchmark measures, in bench.py's order, on
    ``device`` (kernels already built there); returns the record, whose
    keys are bench.py's."""
    device = torch.device(device)
    src, dst, drift = build_pair(device)
    gaps = _assert_kernel_parity(dst[0], dst[1])
    _say(f"kernel parity: {gaps}", card)
    gaps = _assert_batched_parity(src, dst)
    _say(f"batched kernel parity: {gaps}", card)

    gated_match(src, dst, drift, True, card)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        _, fit, _ = full_match(src, dst)
        float(fit)
        times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times))

    null_ms = _null_dispatch_ms(device)
    amort_ms = _amortized_ms(src, dst)
    gated_match(src, dst, drift, False, card)
    adv_ms = _amortized_ms(src, dst, optimized=False)
    _say(f"single-call {ms:.1f} ms | dispatch floor {null_ms:.4f} ms | "
         f"amortized steady-state {amort_ms:.1f} ms/match | advanced "
         f"matching {adv_ms:.1f} ms/match", card)

    pipe_keys, _, _ = pipeline_per_scan(null_ms, device=device, card=card,
                                        live_window=live_window)
    return {
        "metric": METRIC,
        "value": amort_ms,
        "unit": "ms",
        "vs_baseline": BASELINE_MS / amort_ms,
        "single_call_ms": ms,
        "dispatch_floor_ms": null_ms,
        "amortized_ms": amort_ms,
        "advanced_ms": adv_ms,
        "vs_baseline_advanced": BASELINE_ADVANCED_MS / adv_ms,
        **pipe_keys,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device; the benchmark runs on the card "
              "(--device cpu runs it on the CPU)", file=sys.stderr)
        return 1
    card = card_line(device)
    if device.type == "cuda":
        path, nvcc_s = kernels.build()
        kernels.load_library()
        _say(f"kernels built in {nvcc_s:.1f} s: {path.name}", card)
    print(json.dumps(measure(device, card)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
