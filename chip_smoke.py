"""Drive the PyTorch port's loop-closure attempt (both FPFH backends), its
pose-graph pipeline, its per-scan LIO (both map backends, the extrinsic
co-estimated), its CLI (``--sim`` and the dataset modes ``--kitti``,
``--scans/--poses``, ``--bag``, checkpoint / resume) and the 1,600-scan
long run on one CUDA card.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 chip_smoke.py
    python3 chip_smoke.py --trace-fpfh-order   # phase 6 on three FPFH
                                               # row orders, loop events

Phases, in order; any failure raises and the script exits non-zero:

1. the card: a CUDA device is required (there is no CPU fallback); prints
   ``nvidia-smi``'s name and power limit;
2. builds the hand-written CUDA kernels from ``fast_lio_sam_qn_tpu_torch/csrc``,
   then holds K1, K1b, K2 and K2b against their plain versions on edge cases
   of small-integer clouds, where every d2 is exact: ties planted across
   tile, thread and split-slice edges, masks with holes, an all-masked lane,
   sizes off every tile, F in {3, 33, 64}, k in {1, 15, 32, 48, 64} (K2 to
   32); outputs must be equal, K2 must equal K1 and every lane its
   single-cloud kernel;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the main path, on the benchmark's voxelized clouds at the
   benchmark's capacities and at the pipeline's; K2 must also equal K1 bit
   for bit on the Morton-sorted clouds.  K3, K4 and K5 run on the
   Morton-sorted clouds, as ``fpfh_radius`` calls them (K3 also on the
   caller's rows), K4 and K5 with one shared radius prune: masked query
   rows must be zero, K3 with its own prune must equal it with one given,
   K4 on the unsorted cloud must equal it after unpermuting, K5's count
   column must equal K4's, and a repeat must be bit-identical; the shares
   of (block, tile) pairs that the keep rule keeps (K3 at 0.9 m, K4 / K5
   at 1.5 m) are printed;
4. drives the main path, ``LoopClosure(cfg, src_cap, dst_cap)
   .fetch_and_perform(store, 1)`` on a two-keyframe store, in both matching
   modes and at the pipeline's capacities, with every launch counter reset
   just before and read just after; each run must find keyframe 0, converge,
   pass the ground-truth gate (< 6 cm, < 0.01 rad) and repeat bit-identically;
5. holds every batched kernel (K1, K2 and K3-K5 over a batch of clouds,
   the batch on the grid's y axis) on jittered, differently masked lanes of
   the bench clouds against its plain batched version and, bit for bit,
   against the single-cloud kernel on each lane: B = 3 lanes at the bench's
   padding, and at the pipeline's padding as many lanes as the pipeline's
   batched tick runs (``loop_batch = 4``); K2 batched must also equal K1
   batched bit for bit on Morton-sorted lanes; K3b-K5b as K3-K5 in phase
   3, on Morton-sorted lanes, and on four edge-case lanes: holed (both
   extents below N), all-masked, 500 m from the origin, and with
   duplicate points;
6. drives the pipeline, ``FastLioSamQnPipeline(cfg).feed(...)``, over a
   simulated revisiting run at full width (16,384-point scans, default
   capacities, ``loop_batch = 4``) with every launch counter reset just
   before and read just after: at least 3 ticks register 2 or more
   candidate lanes in one batched registration, which launches only the
   batched kernels; every keyframe stamped before the last tick is
   processed; a loop is accepted and committed; the corrected ATE beats
   the drifted odometry's and is below 0.5 m;
7. re-registers each candidate lane of one batched tick alone
   (``perform_loop_closure``) on the same store: the same decisions, the
   pose within 1 mm / 1e-3 rad; the batched tick and a pose-graph solve
   repeat bit for bit;
8. times every kernel and its plain version, and the library yardsticks
   (timed here, never used by the port, fp32 with TF32 off): for the kNN
   kernels ``torch.cdist``, masked, then ``min``; for K3 ``cdist``, the
   radius masks, then W @ features at both radii; for K5 ``cdist``, the
   radius and not-self masks, then rsqrt(d2) @ SPFH; at the main path's
   shapes (K1 at F = 33, K3-K5 on the Morton-sorted rows); one whole
   attempt per mode, the batched tick against single ticks on the same
   candidates, the pose-graph solve at full capacity and the pipeline's
   feeds, with CUDA events (median of 10 calls) or the host clock where a
   host read ends the call;
9. knn_fpfh: the kNN FPFH backend.  K1 at k = 48 and 64 (F = 3) on the
   self-search of the bench clouds at the bench's and the pipeline's
   paddings, and K1b at k = 15, 48, 64 on 4 jittered lanes, equal to
   their plain versions bit for bit (each lane to K1); the four loop
   pairs of tests/test_quatro.py (16,384 rays voxelized into 8,192)
   through ``fpfh.fpfh``, Quatro and GICP at that file's tolerances;
   ``LoopClosure`` with ``fpfh_backend="knn"`` at the pipeline's caps in
   both matching modes, single attempts then a 4-lane batched
   registration, counters reset just before and read just after each
   (K1 at k = 48 and 15, then K1b at k = 48 and 15, must launch), each
   lane within 1 mm / 1e-3 rad of the single attempt with its decision;
   the bench gate's error is printed, not gated; K1 / K1b at k = 15 and
   48 timed against their plain versions and ``cdist`` + ``topk``, and K1
   at k = 64, F = 33 on the kNN descriptors;
10. grid_cov: ``gicp.plane_covariances(backend="grid")`` of a loop pair's
   clouds on the card against the CPU (the same neighbours, equal valid
   masks, covariances within 1e-5 but where the normal is ill-defined),
   then ``gicp.align(cov_backend="grid")`` within 2 cm / 0.15 rad;
11. lio_golden: the 240-scan sim golden through the port, ``run.
   sim_lio_stream`` (the "sim" preset) replayed into ``FastLioSamQnPipeline``
   with the golden's capacities: 34 keyframes, 4-8 committed pairs, 12 loop
   events, ATE 0.0417 m +- 20 % (tests/test_golden.py:95-112); LIO ms per
   scan and its stage spans (CUDA events), feed ms, peak memory;
12. lio_kitti: the LIO at ``LioConfig()`` (32,768 points, 2^19 slots,
   0.5 m) on a straight drive, 10 warm and 20 timed scans: every scan
   after the first matches planes, the final position error within 2x the
   CPU run's (``KITTI_CPU_ERR``); ms per scan and stage spans, host syncs
   and kernels per scan, peak memory;
13. lio_card_vs_cpu: 5 scans at a small width on the card and on the CPU,
   poses within 1e-4 m / 1e-4 rad; each scan from the CPU's state gives
   the CPU's match count;
14. lio_repeat: one scan at the sim width twice from one state, the map,
   nav state and P bit-identical; host syncs and kernels per scan;
15. lio_point: the point-map backend at the sim width: 5 scans on the card
   and on the CPU as in 13 (free-running only while the two maps hold the
   same voxels), a bit-identical repeat, and a 60-scan stream whose
   largest position error stays within 1.5x the JAX package's
   (``POINT_JAX_ERR``); ms per scan, stage spans, syncs, kernels, memory;
16. lio_extrinsic: the reference's extrinsic convergence test
   (tests/test_extrinsic.py:108-212) on the card with its tolerances, and
   the same timings;
17. cli_sim: ``run.main`` in-process as a user starts it (``--sim
   --trajectory corridor --n-scans 40 --out DIR``: rc 0, >= 5 keyframes,
   ATE < 1 m, the exports in DIR), then 170 scans of the loop, whose loop
   attempts launch K1-K5; every kernel against its plain version, as in
   3, on the clouds of that run's first and last tick at its capacities;
18. native_runtime: the native host runtime (``runtime/runtime.cpp``)
   built into build/runtime/ and in use; its scan decoders, loader, sync
   pairs and LZ4 frames against the Python versions; bag ingest rates at
   65,536-point scans (PointCloud2 / Livox, none / bz2 / lz4 chunks);
19. cli_kitti: a KITTI-style directory (``tools/datasets.py``: 360 scans of
   131,072 rays in the LiDAR frame of the kitti preset's extrinsic, 100 Hz
   IMU from a standstill, the golden's room, a 7 m loop every 30 s) through
   ``run.main(["--kitti", DIR, "--preset", "kitti", "--out", OUT])``: the
   exports, ATE < 0.5 m, loop attempts that launch K1-K5, and K1-K5
   against their plain versions on its first and last tick's clouds; LIO
   and feed ms, scans/s, memory; then 60 scans straight against 30 with
   ``--checkpoint`` and 30 after ``--resume`` (equal keyframes, 1e-4 m);
20. cli_parity: the same scans in the body frame with drifted odometry,
   ``--stamps``, ``--odom-times`` missing 5 stamps and ``--loop-batch 4``:
   5 dropped, K1b-K5b launched and held against their plain versions on a
   batched tick's lanes, the corrected ATE below the odometry's;
21. cli_bag: a 60-scan full-width bag (PointCloud2 with a time field, Imu
   at 200 Hz, lz4 chunks): ``--bag`` equal to ``bag_convert`` + ``--kitti``
   within 1e-3 m, ``--odom-topic`` drop accounting, a Livox bag end to end;
22. longrun: tools/longrun.py's 1,600-scan course (a 26 m radius loop at
   4 m/s, 3.9 laps, 10 Hz, 2,048-point scans) through ``sim_lio_stream``
   and the pipeline on the card, every pin of
   tests/test_golden_longrun.py held (400 keyframes, 64 attempts, 39-59
   commits, ATE 0.1274 m +- 30 %, odometry ATE < 0.05 m, the keyframe
   store 128 -> >= 512, the loop factors 8 -> >= 32); ms per scan, LIO
   and feed spans, peak memory;
23. prints the kernel table as one JSON line (time, launches on the main
   path, bound from this run's inputs, library time), the card, then the
   result line.  The LIO launches none of K1-K5 (its reference has no
   Pallas kernel).  K3, K4 and K5 skip what the radius prune rules out, so
   their bound counts the math of the pairs within the radius only (the
   all-pairs figure is logged beside it).
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

GATE_T, GATE_R = 0.06, 0.01
REPO = "fast_lio_sam_qn_tpu_torch"
LANES = 3                   # batched parity at the bench caps
PIPE_SCANS, PIPE_POINTS = 160, 16384
# the H100 SXM's published peaks: fp32 outside
# the tensor cores, and HBM3
FP32_FLOPS, HBM_BYTES_S = 67e12, 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Median wall time of ``fn`` on the card, by CUDA events, after one
    warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# kernel vs plain version
# ---------------------------------------------------------------------------

def check_rows(name, got, want, atol, rtol, explain):
    """Elementwise |got - want| <= atol + rtol |want|; every row that
    breaks it must be accepted by ``explain(rows) -> bool per row``."""
    import torch

    from fast_lio_sam_qn_tpu_torch.parity import rows_beyond

    rows = rows_beyond(got, want, atol, rtol)
    if len(rows):
        ok = explain(rows)
        if not bool(ok.all()):
            raise AssertionError(
                f"{name}: {int((~ok).sum())} rows differ beyond tolerance "
                f"without a boundary pair (first: {rows[~ok][:5].tolist()})")
    err = float(torch.max(torch.abs(got - want)))
    log(f"{name}: max |kernel - plain| {err:.3e}, {len(rows)} rows beyond "
        f"atol {atol} / rtol {rtol}, all at radius or bin boundaries")
    return err


def check_knn(name, kern, plain, q, qm, db, dbm, k):
    """A kNN kernel against its plain version: valid flags equal; d2 within
    1e-4 + 1e-5 d2 + 2^-20 (|q|^2 + |v|^2) (the expansion's own fp32
    rounding of its two large terms); a differing index only at a tie of
    that size, checked in float64."""
    import torch

    from fast_lio_sam_qn_tpu_torch.ops import knn

    dk, ik, vk = kern(q, qm, db, dbm, k)
    dp, ip, vp = plain(q, qm, db, dbm, k)
    if not torch.equal(vk, vp):
        raise AssertionError(f"{name}: valid flags differ")
    qq = knn.sq_norms(q)[:, None]
    vv = knn.sq_norms(db)[torch.clamp(ip, min=0).long()]
    tol = 1e-4 + 1e-5 * dp.abs() + 2.0 ** -20 * (qq + vv)
    diff = torch.where(vp, torch.abs(dk - dp), 0.0)
    if bool((diff > tol).any()):
        raise AssertionError(f"{name}: d2 differs by {float(diff.max())}")
    mism = (ik != ip) & vp
    if bool(mism.any()):
        q64, db64 = q.double(), db.double()
        rows = torch.nonzero(mism.any(dim=1)).flatten()
        dtrue = torch.cdist(q64[rows], db64) ** 2
        a = dtrue.gather(1, ik[rows].clamp(min=0).long())
        b = dtrue.gather(1, ip[rows].clamp(min=0).long())
        gap = torch.where(mism[rows], torch.abs(a - b), 0.0)
        if bool((gap > tol[rows].double()).any()):
            raise AssertionError(f"{name}: index differs beyond a tie")
    err = float(diff.max())
    log(f"{name}: max |d2 kernel - plain| {err:.3e} (max / 1e-4+1e-5 d2: "
        f"{float((diff / (1e-4 + 1e-5 * dp.abs())).max()):.3f}), "
        f"{int(mism.sum())} tie index swaps")
    return err


def edge_clouds(rng, f, m, n, lanes=3):
    """``lanes`` clouds of small integers (every product and sum of the d2
    expansion exact in fp32) with holed masks and a masked tail; lane 1 has
    no valid query and lane 2 no valid db row.  Rows e - 1 and e of the db
    are one valid point, and a query sits on it, at every edge e of a
    thread's rows, a warp's half tile and a tile (so at every split slice
    edge, which is a tile edge: ops/knn_cuda.py split_lo)."""
    lo, hi = (-4, 5) if f == 3 else (-2, 3)
    q = rng.integers(lo, hi, (lanes, m, f)).astype(np.float32)
    db = rng.integers(lo, hi, (lanes, n, f)).astype(np.float32)
    qm = rng.random((lanes, m)) > 0.25
    dm = rng.random((lanes, n)) > 0.25
    qm[:, m - m // 5:] = False
    dm[:, n - n // 7:] = False
    edges = [e for e in range(4, n - n // 7)
             if e % 128 in (0, 4, 32, 64, 96) or (e < 128 and e % 4 == 0)]
    for j, e in enumerate(edges):
        db[:, e] = db[:, e - 1]
        dm[:, e - 1:e + 1] = True
        r = (7 * j) % (m - m // 5)
        q[:, r] = db[:, e]
        qm[:, r] = True
    qm[1] = False
    dm[2] = False
    q[:, m - m // 5:] = 0.0
    db[:, n - n // 7:] = 0.0
    return q, qm, db, dm, len(edges)


def same(name, got, want):
    import torch

    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name}: differs")


def knn_edge_cases(dev):
    """K1/K1b (F 3, 33, 64; k 1, 15, 32, 48, 64) and K2/K2b (F 3; k 1, 15,
    32) on edge_clouds against their plain versions: d2, indices and flags
    equal; every lane equal to the single-cloud kernel; K2 equal to K1 on
    Morton-sorted lanes.  Returns the number of cases."""
    import torch

    from fast_lio_sam_qn_tpu_torch.ops import knn_cuda

    rng = np.random.default_rng(17)
    cases = 0
    for f in (3, 33, 64):
        for m, n in ((37, 300), (461, 2477)):
            q, qm, db, dm, n_edges = edge_clouds(rng, f, m, n)
            args = [torch.from_numpy(a).to(dev) for a in (q, qm, db, dm)]
            lanes = [tuple(a[i] for a in args) for i in range(len(q))]
            splits = (knn_cuda.split_count(len(q), m, n, 1),
                      knn_cuda.split_count(1, m, n, 1))
            for k in (1, 15, 32) + BIG_K:
                tag = f"F={f} k={k} {m}x{n}"
                got = knn_cuda.knn_batched(*args, k)
                same(f"K1b {tag}", got, knn_cuda.knn_batched_plain(*args, k))
                for i, one in enumerate(lanes):
                    same(f"K1 {tag} lane {i}", tuple(g[i] for g in got),
                         knn_cuda.knn(*one, k))
                cases += 1
                if f != 3 or k > knn_cuda.BAND_MAX_K:
                    continue
                so = torch.stack([knn_cuda.morton_order(p, mk)
                                  for p, mk in zip(args[0], args[1])])
                do = torch.stack([knn_cuda.morton_order(p, mk)
                                  for p, mk in zip(args[2], args[3])])
                srt = (torch.gather(args[0], 1, so[..., None].expand(
                    -1, -1, 3)), torch.gather(args[1], 1, so),
                    torch.gather(args[2], 1, do[..., None].expand(-1, -1, 3)),
                    torch.gather(args[3], 1, do))
                got = knn_cuda.knn_banded_batched(*srt, k)
                same(f"K2b {tag}", got,
                     knn_cuda.knn_banded_batched_plain(*srt, k))
                same(f"K2b == K1b {tag}", got, knn_cuda.knn_batched(*srt, k))
                for i in range(len(q)):
                    one = tuple(a[i] for a in srt)
                    same(f"K2 {tag} lane {i}", tuple(g[i] for g in got),
                         knn_cuda.knn_banded(*one, k))
                cases += 1
            log(f"kNN edge cases F={f} {m}x{n}: {n_edges} planted ties, "
                f"splits {splits[0]} batched / {splits[1]} single; K1, K1b"
                f"{', K2, K2b' if f == 3 else ''} equal their plain "
                f"versions at k = 1, 15, 32, 48, 64 (K2 to 32)")
    torch.cuda.synchronize()
    return cases


def knn_library(q, qm, db, dbm):
    """The library yardstick of a k = 1 kNN kernel: torch.cdist, the masked
    db rows set to +inf, then min (timed, never used by the port)."""
    import torch

    d = torch.cdist(q, db)
    d.masked_fill_(~dbm.unsqueeze(-2), torch.inf)
    v, i = torch.min(d, dim=-1)
    return torch.where(qm, v * v, torch.inf), torch.where(qm, i, -1)


def _strict_fp32():
    import torch

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on: the yardsticks must run in fp32")


def moments_library(p, m):
    """K3's library yardstick (timed, never used by the port), one
    composed call chain for (N, 3) or (B, N, 3) clouds in fp32, TF32 off:
    torch.cdist, the radius masks at 0.9 m and 0.6 m over valid pairs,
    then W @ [1, x, y, z, xx, xy, xz, yy, yz, zz] at each radius."""
    import torch

    _strict_fp32()
    d2 = torch.cdist(p, p).square_()
    pair = m[..., :, None] & m[..., None, :]
    feats = torch.cat([torch.ones_like(p[..., :1]), p, p[..., 0:1] * p,
                       p[..., 1:2] * p[..., 1:], p[..., 2:3] * p[..., 2:]],
                      dim=-1)
    return torch.cat([((d2 <= r * r) & pair).float() @ feats
                      for r in (0.9, 0.6)], dim=-1)


def agg_library(p, m, v, spn):
    """K5's library yardstick (timed, never used by the port), in fp32 with
    TF32 off: torch.cdist, the masks of valid queries, valid db points
    (mask & n_valid) within 1.5 m and not the query itself, then
    rsqrt(d2) @ SPFH beside the neighbour count."""
    import torch

    _strict_fp32()
    n = p.shape[-2]
    d2 = torch.cdist(p, p).square_()
    w = (d2 <= 1.5 * 1.5) & m[..., :, None] & (m & v)[..., None, :]
    w &= ~torch.eye(n, dtype=torch.bool, device=p.device)
    wt = torch.where(w, torch.rsqrt(d2.clamp_(min=1e-12)), 0.0)
    return torch.cat([wt @ spn, w.sum(-1, keepdim=True, dtype=p.dtype)],
                     dim=-1)


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of the operations over the fp32
    peak and the bytes over the HBM rate."""
    t_ops = float(flops) / FP32_FLOPS * 1e3
    t_bytes = float(nbytes) / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def per_run(mask, rows):
    """Valid rows in each run of ``rows`` consecutive rows (float64)."""
    import torch

    pad = torch.nn.functional.pad(mask.double(), (0, -mask.shape[0] % rows))
    return pad.view(-1, rows).sum(-1)


def knn_bound(q, qm, db, dbm, k, keep=None):
    """A kNN kernel's bound over this run's data: 2F + 2 flops (the cross
    term's F products and the d2 expansion) for each (valid query, valid db
    row) pair, or for each pair of a kept (block, tile) for K2 (``keep``,
    one bitmap per lane); each valid row's F + 1 floats and mask byte read
    once, every output row written once."""
    import torch

    from fast_lio_sam_qn_tpu_torch.ops import knn_cuda

    if q.dim() == 2:
        q, qm, db, dbm = q[None], qm[None], db[None], dbm[None]
        keep = None if keep is None else [keep]
    f = q.shape[-1]
    nq = qm.sum(-1).double()
    nd = dbm.sum(-1).double()
    if keep is None:
        pairs = float((nq * nd).sum())
    else:
        pairs = 0.0
        for qml, dml, kp in zip(qm, dbm, keep):
            cq = per_run(qml, knn_cuda.BAND_BLOCK)
            cd = per_run(dml, knn_cuda.BAND_TILE)
            pairs += float(cq @ kp.double() @ cd)
    nbytes = (float((nq + nd).sum()) * (4 * f + 5)
              + q.shape[0] * q.shape[1] * k * 8)
    return bound(pairs * (2 * f + 2), nbytes)


def radius_bound(p, qm, dbm, radii, pair_flops, hit_flops, row_in, row_out):
    """An FPFH kernel's bound over this run's data, per lane: 9 flops of
    distance test for each (valid query, valid db point) pair plus
    hit_flops[r] for each pair within radii[r]; each valid row's row_in
    bytes read once, every output row's row_out bytes written once."""
    import torch

    if p.dim() == 2:
        p, qm, dbm = p[None], qm[None], dbm[None]
    flops = 0.0
    rows_in = 0.0
    for pl, ql, dl in zip(p, qm, dbm):
        a, b = pl[ql].double(), pl[dl].double()
        d2 = torch.cdist(a, b) ** 2
        flops += pair_flops * d2.numel()
        for r, hf in zip(radii, hit_flops):
            flops += hf * float((d2 <= r * r).sum())
        rows_in += float(ql.sum())
    return bound(flops, rows_in * row_in + p.shape[0] * p.shape[1] * row_out)


class FpfhSorted(NamedTuple):
    """K3-K5's operands on Morton-sorted lanes, as ``fpfh_radius`` gives
    them to the kernels: (B, N, ...) points, mask, normals, n_valid, the
    plain version's normalized SPFH, K4 / K5's shared radius prune, and
    the shares of (block, tile) pairs below the extents that the keep rule
    keeps for K4 / K5 (1.5 m over mask & n_valid) and for K3 (0.9 m over
    mask)."""
    p: object
    m: object
    n: object
    v: object
    spn: object
    prune: object
    share: float
    share3: float


def check_fpfh_rows(name, got, want, qmask, atol, rtol, explain):
    """A K3 / K4 / K5 output against its plain version under the kernels'
    contract: rows of masked queries are zero; valid rows within atol /
    rtol, each row beyond accepted by ``explain(rows)`` (indices of the
    full output)."""
    import torch

    if bool(got[~qmask].any()):
        raise AssertionError(f"{name}: a masked query row is not zero")
    valid = torch.nonzero(qmask).flatten()
    if len(valid) == 0:
        log(f"{name}: no valid query; every row zero")
        return 0.0
    return check_rows(name, got[valid], want[valid], atol, rtol,
                      lambda r: explain(valid[r]))


def kept_share(p, m, dbkeep, radius):
    """Of the (query block, db tile) pairs below the lane's extents (the
    query rows of ``m``, the db rows of ``dbkeep``), the share that the
    FPFH kernels' keep rule at ``radius`` keeps (``radius_tile_keep``)."""
    import torch

    from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream as fs
    from fast_lio_sam_qn_tpu_torch.ops import knn_cuda

    qb = -(-int(knn_cuda.lane_extents(m)) // fs.FP_BLOCK)
    tb = -(-int(knn_cuda.lane_extents(dbkeep)) // fs.FP_TILE)
    if qb == 0 or tb == 0:
        return 0.0
    kept = fs.radius_tile_keep(p, m, dbkeep, radius)[:qb, :tb]
    return float(torch.mean(kept.float()))


def moments_parity(tag, p, m, errs=None, batched=True, far=()):
    """K3 (``batched``: K3b) on (B, N) lanes: against ``moments_plain`` on
    every lane (masked query rows zero; valid rows within 1e-3 / 1e-5,
    each row beyond holding a pair on 0.9 m or 0.6 m; for the lanes in
    ``far``, that band widened by the fp32 expansion's error); with its
    own prune and with one given, equal; with ``batched``, each lane equal
    to the single kernel; a repeat bit-identical.  Returns the plain
    moments."""
    from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream as fs
    from fast_lio_sam_qn_tpu_torch.parity import radius_boundary_rows

    sfx = "b" if batched else ""
    key = "moments" + "_b" * batched

    def k3(prune=None):
        if batched:
            return fs.moments_batched(p, m, 0.9, 0.6, prune)
        return fs.moments(p[0], m[0], 0.9, 0.6, prune)[None]

    prune = fs.radius_prune(p, m)
    got = k3(prune)
    want = fs.moments_batched_plain(p, m, 0.9, 0.6)
    for i in range(p.shape[0]):
        err = check_fpfh_rows(
            f"K3{sfx} {tag} lane {i}", got[i], want[i], m[i], 1e-3, 1e-5,
            lambda r: radius_boundary_rows(p[i], m[i], r, (0.9, 0.6),
                                           i in far))
        if errs is not None:
            errs[key] = max(errs[key], err)
    same(f"K3{sfx} {tag} repeat", (k3(prune),), (got,))
    same(f"K3{sfx} {tag} own prune", (k3(),), (got,))
    if batched:
        same_lanes(f"K3b {tag}", got,
                   lambda i: fs.moments(p[i], m[i], 0.9, 0.6))
    return want


def fpfh_parity(tag, P, M, VP=None, errs=None, batched=True, far=()):
    """K3-K5 (``batched``: K3b-K5b) on the Morton-sorted lanes of (B, N)
    clouds, as ``fpfh_radius`` / ``fpfh_radius_batched`` call them: K3 as
    ``moments_parity`` says; the normals from the plain moments, toward
    the viewpoints ``VP`` (B, 3) or each lane's centroid; K4 / K5 with one
    radius prune shared by both, against the plain versions on every lane
    (masked query rows zero; valid rows within K4's rules, K5's 1e-2 /
    1e-4 and radius boundaries; for the lanes in ``far``, a boundary band
    widened by the fp32 expansion's error); K4 on the unsorted lanes equal
    after unpermuting; K5's count column equal to K4's; with ``batched``,
    each lane equal to the single kernel; a repeat bit-identical.
    Returns ``FpfhSorted``."""
    import torch

    from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream as fs
    from fast_lio_sam_qn_tpu_torch.ops import knn_cuda
    from fast_lio_sam_qn_tpu_torch.parity import (radius_boundary_rows,
                                                  spfh_rows_explained)

    sfx = "b" if batched else ""
    b, nr = M.shape
    VP = fs._viewpoints(P, M, VP)
    order = knn_cuda.morton_order_batched(P, M)
    p, m = knn_cuda.take_rows(P, order), knn_cuda.take_rows(M, order)
    mom = moments_parity(tag, p, m, errs, batched, far)
    n, v, _, _ = fs.moments_to_normals_covs(
        mom.reshape(b * nr, 20), p.reshape(b * nr, 3), m.reshape(-1),
        VP[:, None, :].expand(b, nr, 3).reshape(b * nr, 3))
    n, v = n.reshape(b, nr, 3).contiguous(), v.reshape(b, nr)
    NRM, NV = knn_cuda.put_rows(n, order), knn_cuda.put_rows(v, order)
    prune = fs.radius_prune(p, m, v)

    def k4(*a, prune=None):
        if batched:
            return fs.spfh_batched(*a, 1.5, prune)
        return fs.spfh(*(x[0] for x in a), 1.5, prune)[None]

    def k5(*a, prune=None):
        if batched:
            return fs.fpfh_agg_batched(*a, 1.5, prune)
        return fs.fpfh_agg(*(x[0] for x in a), 1.5, prune)[None]

    sp_k = k4(p, m, n, v, prune=prune)
    sp_p = fs.spfh_batched_plain(p, m, n, v, 1.5)
    spn = (sp_p[..., :33] / torch.clamp(sp_p[..., 33:], min=1.0)
           ).contiguous()
    ag_k = k5(p, m, v, spn, prune=prune)
    ag_p = fs.fpfh_agg_batched_plain(p, m, v, spn, 1.5)
    for i in range(P.shape[0]):
        keep, wide = m[i] & v[i], i in far
        err = check_fpfh_rows(
            f"K4{sfx} {tag} lane {i}", sp_k[i], sp_p[i], m[i], 1e-3, 0.0,
            lambda r: spfh_rows_explained(sp_k[i], sp_p[i], p[i], n[i], keep,
                                          r, 1.5, wide))
        if errs is not None:
            errs["spfh" + "_b" * batched] = max(
                errs["spfh" + "_b" * batched], err)
        err = check_fpfh_rows(
            f"K5{sfx} {tag} lane {i}", ag_k[i], ag_p[i], m[i], 1e-2, 1e-4,
            lambda r: radius_boundary_rows(p[i], keep, r, (1.5,), wide))
        if errs is not None:
            errs["agg" + "_b" * batched] = max(errs["agg" + "_b" * batched],
                                               err)
    if not torch.equal(knn_cuda.put_rows(sp_k, order), k4(P, M, NRM, NV)):
        raise AssertionError(f"K4{sfx} {tag}: sorted and unsorted input "
                             f"differ after unpermuting")
    if not torch.equal(ag_k[..., 33], sp_k[..., 33]):
        raise AssertionError(f"K5{sfx} {tag}: count column differs from "
                             f"K4's")
    same(f"K4{sfx} {tag} repeat", (k4(p, m, n, v, prune=prune),), (sp_k,))
    same(f"K5{sfx} {tag} repeat", (k5(p, m, v, spn, prune=prune),), (ag_k,))
    if batched:
        same_lanes(f"K4b {tag}", sp_k,
                   lambda i: fs.spfh(p[i], m[i], n[i], v[i], 1.5))
        same_lanes(f"K5b {tag}", ag_k,
                   lambda i: fs.fpfh_agg(p[i], m[i], v[i], spn[i], 1.5))
    share = float(np.mean([kept_share(p[i], m[i], m[i] & v[i], 1.5)
                           for i in range(P.shape[0])]))
    share3 = float(np.mean([kept_share(p[i], m[i], m[i], 0.9)
                            for i in range(P.shape[0])]))
    log(f"K3{sfx} / K4{sfx} / K5{sfx} {tag}: Morton-sorted lanes; masked "
        f"rows zero, sorted == unsorted (K4), count columns equal, repeats "
        f"equal{', every lane == its single kernel' if batched else ''}; "
        f"the keep rule keeps {share3:.4f} (K3, 0.9 m) and {share:.4f} "
        f"(K4 / K5, 1.5 m) of the (block, tile) pairs below the extents")
    return FpfhSorted(p, m, n, v, spn, prune, share, share3)


def fpfh_edge_cases(store):
    """K3b-K5b on four lanes of the bench source at the bench padding:
    holed (30 % of rows dropped and the last fifth masked, so both extents
    end before N), all-masked, moved 500 m from the origin, and with 300
    valid points duplicated (d2 = 0 pairs)."""
    import torch

    from fast_lio_sam_qn_tpu_torch.models.loop_closure import _single_frame
    from fast_lio_sam_qn_tpu_torch.tools import bench_pair as bp

    src, sm = _single_frame(store, 1, bp.SRC_CAP, 0.3)
    n = src.shape[0]
    g = torch.Generator(device=src.device).manual_seed(21)
    holed = sm & (torch.rand(n, generator=g, device=src.device) > 0.3)
    holed[n - n // 5:] = False
    idx = torch.nonzero(sm).flatten()
    dup = src.clone()
    dup[idx[300:600]] = src[idx[:300]]
    far = src + torch.tensor([500.0, -300.0, 40.0], device=src.device)
    P = torch.stack([src, src, far, dup]).contiguous()
    M = torch.stack([holed, torch.zeros_like(sm), sm, sm])
    srt = fpfh_parity("edge cases (holed, all-masked, 500 m, duplicates)",
                      P, M, far=(2,))
    torch.cuda.synchronize()
    return srt


def kernel_parity(store, src_cap, dst_cap, errs, pair=(1, 0), where=""):
    """Every kernel against its plain version on the voxelized clouds of
    keyframes ``pair`` (source, target), padded to (src_cap, dst_cap), as
    the single-candidate tick builds them; K3 on the caller's rows and,
    with K4 and K5, on the Morton-sorted rows (``fpfh_parity``); K2 also
    against K1, bit for bit.  Returns the inputs the timing phase
    reuses."""
    import torch

    from fast_lio_sam_qn_tpu_torch.models.loop_closure import _single_frame
    from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream as fs
    from fast_lio_sam_qn_tpu_torch.ops import knn, knn_cuda, se3
    from fast_lio_sam_qn_tpu_torch.parity import radius_boundary_rows

    caps = f"@{src_cap}/{dst_cap}{where}"
    src, sm = _single_frame(store, pair[0], src_cap, 0.3)
    dst, dm = _single_frame(store, pair[1], dst_cap, 0.3)
    inputs = {}
    for tag, p, m, vp in (
            ("src", src, sm, store.poses_corrected[pair[0]][:3, 3]),
            ("dst", dst, dm, store.poses_corrected[pair[1]][:3, 3])):
        mom_k = fs.moments(p, m, 0.9, 0.6)
        mom_p = fs.moments_plain(p, m, 0.9, 0.6)
        errs["moments"] = max(errs["moments"], check_fpfh_rows(
            f"K3 {tag}{caps} on the caller's rows", mom_k, mom_p, m, 1e-3,
            1e-5, lambda r: radius_boundary_rows(p, m, r, (0.9, 0.6))))
        srt = fpfh_parity(f"{tag}{caps}", p[None], m[None], vp[None], errs,
                          batched=False)
        inputs[tag] = (p, m, vp, srt)

    desc_s, val_s, _ = fs.fpfh_radius(src, sm, 0.9, 1.5,
                                      viewpoint=inputs["src"][2])
    desc_d, val_d, _ = fs.fpfh_radius(dst, dm, 0.9, 1.5,
                                      viewpoint=inputs["dst"][2])
    moved = se3.transform_points(src, se3.se3_exp(torch.tensor(
        [0.0, 0.0, 0.1, 0.3, -0.2, 0.0], device=src.device))).contiguous()
    for name, args in (
            ("K1 knn k=1 F=3 (GICP NN)", (moved, sm, dst, dm, 1)),
            ("K1 knn k=1 F=33 (matching)", (desc_s, val_s, desc_d, val_d, 1)),
            ("K1 knn k=15 F=3 (covariances)", (dst, dm, dst, dm, 15))):
        errs["knn"] = max(errs["knn"], check_knn(
            f"{name} {caps}", knn_cuda.knn, knn.brute_knn, *args))

    # K2 on the Morton-sorted clouds, as gicp.align calls it
    so = knn_cuda.morton_order(moved, sm)
    do = knn_cuda.morton_order(dst, dm)
    sorted_nn = (moved[so].contiguous(), sm[so], dst[do].contiguous(), dm[do])
    for k in (1, 15):
        errs["knn_banded"] = max(errs["knn_banded"], check_knn(
            f"K2 knn_banded k={k} F=3 {caps}", knn_cuda.knn_banded,
            knn_cuda.knn_banded_plain, *sorted_nn, k))
        got = knn_cuda.knn_banded(*sorted_nn, k)
        want = knn_cuda.knn(*sorted_nn, k)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K2 k={k} {caps}: differs from K1")
    keep = knn_cuda.block_tile_keep(*sorted_nn, 1)
    log(f"K2 {caps}: equal to K1 bit for bit at k=1 and k=15; the keep "
        f"rule searches {float(keep.float().mean()):.4f} of the (block, "
        f"tile) pairs")
    torch.cuda.synchronize()
    return inputs, (moved, sm, dst, dm), sorted_nn, (desc_s, val_s, desc_d,
                                                      val_d)


def jittered_lanes(p, m, lanes, seed):
    """``lanes`` copies of one padded cloud: lane i moves every valid point
    by N(0, (0.01 i m)^2) per axis and drops 10 i % of them."""
    import torch

    g = torch.Generator(device=p.device).manual_seed(seed)
    ps, ms = [], []
    for i in range(lanes):
        noise = torch.randn(p.shape, generator=g, device=p.device) * 0.01 * i
        keep = torch.rand(m.shape, generator=g, device=p.device) >= 0.1 * i
        ps.append(torch.where(m[:, None], p + noise, p))
        ms.append(m & keep)
    return torch.stack(ps).contiguous(), torch.stack(ms)


def same_lanes(name, batched, single_fn):
    """Every lane of a batched kernel's output equals the single-cloud
    kernel on that lane, bit for bit."""
    import torch

    if isinstance(batched, torch.Tensor):
        batched = (batched,)
    for i in range(batched[0].shape[0]):
        one = single_fn(i)
        if isinstance(one, torch.Tensor):
            one = (one,)
        if not all(torch.equal(b[i], o) for b, o in zip(batched, one)):
            raise AssertionError(f"{name}: lane {i} differs from the "
                                 f"single-cloud kernel")


def lane_view(out, i):
    return lambda *args: tuple(o[i] for o in out)


def tick_lanes(store, tick, src_cap, dst_cap):
    """The lanes a batched tick ``(queries, candidates)`` registers, as
    ``LoopClosure._register`` builds them (a pad lane, candidate -1, on
    keyframe 0): {"src": (P, M, viewpoints), "dst": ...}."""
    import torch

    from fast_lio_sam_qn_tpu_torch.models.loop_closure import _single_frame

    qs, cs = tick
    out = {}
    for tag, idx, cap in (("src", qs, src_cap),
                          ("dst", [max(c, 0) for c in cs], dst_cap)):
        P, M = (torch.stack(x).contiguous() for x in zip(
            *(_single_frame(store, i, cap, 0.3) for i in idx)))
        out[tag] = (P, M, store.poses_corrected[idx][:, :3, 3].contiguous())
    return out


def batched_parity(store, src_cap, dst_cap, errs, lanes=LANES, tick=None):
    """Every batched kernel on ``lanes`` jittered lanes of the bench clouds
    padded to (src_cap, dst_cap), or on the lanes of a pipeline's batched
    ``tick`` ((queries, candidates), ``tick_lanes``): against its plain
    batched version lane by lane (the single-cloud tolerances and boundary
    rules) and against the single-cloud kernel (bit for bit); K2 batched
    against K1 batched bit for bit on Morton-sorted lanes.  Returns inputs
    for the timings."""
    import torch

    from fast_lio_sam_qn_tpu_torch.models.loop_closure import _single_frame
    from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream as fs
    from fast_lio_sam_qn_tpu_torch.ops import knn_cuda, se3

    if tick is None:
        lane_clouds = {}
        for tag, k, cap, seed in (("src", 1, src_cap, 11),
                                  ("dst", 0, dst_cap, 12)):
            P, M = jittered_lanes(*_single_frame(store, k, cap, 0.3), lanes,
                                  seed)
            lane_clouds[tag] = (P, M, store.poses_corrected[k][:3, 3].expand(
                lanes, 3).contiguous())
    else:
        lane_clouds = tick_lanes(store, tick, src_cap, dst_cap)
        lanes = len(tick[0])
    caps = f"B={lanes} @{src_cap}/{dst_cap}" + (
        "" if tick is None else f" (the tick {tick[0]} -> {tick[1]})")
    clouds = {}
    for tag in ("src", "dst"):
        P, M, vp = lane_clouds[tag]
        srt = fpfh_parity(f"{tag} {caps}", P, M, vp, errs)
        desc, val, _ = fs.fpfh_radius_batched(P, M, 0.9, 1.5, vp)
        clouds[tag] = (P, M, srt, desc, val)

    P, M = clouds["src"][:2]
    D, DM = clouds["dst"][:2]
    moved = se3.transform_points(P, se3.se3_exp(torch.tensor(
        [0.0, 0.0, 0.1, 0.3, -0.2, 0.0], device=P.device))).contiguous()
    desc_s, val_s = clouds["src"][3:]
    desc_d, val_d = clouds["dst"][3:]
    for name, args in (
            ("K1 batched k=1 F=3 (GICP NN)", (moved, M, D, DM, 1)),
            ("K1 batched k=1 F=33 (matching)", (desc_s, val_s, desc_d,
                                                val_d, 1)),
            ("K1 batched k=15 F=3 (covariances)", (D, DM, D, DM, 15))):
        got = knn_cuda.knn_batched(*args)
        want = knn_cuda.knn_batched_plain(*args)
        same_lanes(f"{name} {caps}", got, lambda i: knn_cuda.knn(
            *(a[i] for a in args[:4]), args[4]))
        for i in range(lanes):
            errs["knn_b"] = max(errs["knn_b"], check_knn(
                f"{name} lane {i} {caps}", lane_view(got, i),
                lane_view(want, i), *(a[i] for a in args[:4]), args[4]))
    so = torch.stack([knn_cuda.morton_order(p, m) for p, m in zip(moved, M)])
    do = torch.stack([knn_cuda.morton_order(p, m) for p, m in zip(D, DM)])
    sorted_nn = (torch.gather(moved, 1, so[..., None].expand(-1, -1, 3)),
                 torch.gather(M, 1, so),
                 torch.gather(D, 1, do[..., None].expand(-1, -1, 3)),
                 torch.gather(DM, 1, do))
    for k in (1, 15):
        got = knn_cuda.knn_banded_batched(*sorted_nn, k)
        want = knn_cuda.knn_banded_batched_plain(*sorted_nn, k)
        same_lanes(f"K2 batched k={k} {caps}", got, lambda i: (
            knn_cuda.knn_banded(*(a[i] for a in sorted_nn), k)))
        for i in range(lanes):
            errs["knn_banded_b"] = max(errs["knn_banded_b"], check_knn(
                f"K2 batched k={k} lane {i} {caps}", lane_view(got, i),
                lane_view(want, i), *(a[i] for a in sorted_nn), k))
        if not all(torch.equal(g, w) for g, w in zip(
                got, knn_cuda.knn_batched(*sorted_nn, k))):
            raise AssertionError(f"K2 batched k={k} {caps}: differs from "
                                 f"K1 batched")
    log(f"batched kernels {caps}: every lane equals its single-cloud kernel "
        f"bit for bit; K2 batched equals K1 batched bit for bit at k=1 and "
        f"k=15")
    torch.cuda.synchronize()
    return clouds, sorted_nn


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def gate_error(T, drift):
    """(m, rad) error of a registration T against the bench pair's truth."""
    import torch

    from fast_lio_sam_qn_tpu_torch.ops import se3

    err = se3.se3_log(T.double().cpu() @ torch.tensor(drift))
    return float(torch.linalg.norm(err[3:])), float(torch.linalg.norm(
        err[:3]))


def pose_gap(a, b):
    """(m, rad) between two (4, 4) poses."""
    import torch

    from fast_lio_sam_qn_tpu_torch.ops import se3

    d = se3.se3_log(torch.linalg.inv(a.double().cpu()) @ b.double().cpu())
    return float(d[3:].norm()), float(d[:3].norm())


def gate(reg, drift, label):
    import torch

    T = reg.pose_between
    if T.shape != (4, 4) or not bool(torch.isfinite(T).all()):
        raise AssertionError(f"{label}: non-finite or misshapen transform")
    if int(reg.closest_idx) != 0:
        raise AssertionError(f"{label}: closest_idx {int(reg.closest_idx)}")
    if not bool(reg.is_converged):
        raise AssertionError(f"{label}: did not converge")
    t_err, r_err = gate_error(T, drift)
    log(f"{label}: closest 0, converged, valid={bool(reg.is_valid)}, "
        f"fitness {float(reg.score):.4f}, error vs ground truth "
        f"{t_err * 100:.2f} cm / {r_err:.5f} rad")
    if not (t_err < GATE_T and r_err < GATE_R):
        raise AssertionError(f"{label}: fails the gate ({t_err:.4f} m, "
                             f"{r_err:.5f} rad)")


def main_path_runs(store, drift):
    import torch

    from fast_lio_sam_qn_tpu_torch.models.loop_closure import LoopClosure
    from fast_lio_sam_qn_tpu_torch.tools import bench_pair as bp

    runs = {}
    for label, optimized, caps in (
            ("optimized", True, (bp.SRC_CAP, bp.DST_CAP)),
            ("advanced", False, (bp.SRC_CAP, bp.DST_CAP)),
            ("optimized@pipeline caps", True,
             (bp.PIPE_SRC_CAP, bp.PIPE_DST_CAP))):
        lc = LoopClosure(bp.bench_config(optimized), *caps)
        reg, meas = lc.fetch_and_perform(store, 1)
        reg2, meas2 = lc.fetch_and_perform(store, 1)
        torch.cuda.synchronize()
        gate(reg, drift, label)
        same = all(torch.equal(a, b) for a, b in zip(reg, reg2)) and \
            torch.equal(meas, meas2)
        if not same:
            raise AssertionError(f"{label}: a repeated call differs")
        if not bool(torch.isfinite(meas).all()):
            raise AssertionError(f"{label}: non-finite measurement")
        runs[label] = lc
    return runs


BATCHED = ("knn_b", "knn_banded_b", "moments_b", "spfh_b", "agg_b")


def launch_counters():
    from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream as fs
    from fast_lio_sam_qn_tpu_torch.ops import knn_cuda

    return {"knn": knn_cuda.knn, "knn_banded": knn_cuda.knn_banded,
            "moments": fs.moments, "spfh": fs.spfh, "agg": fs.fpfh_agg,
            "knn_b": knn_cuda.knn_batched,
            "knn_banded_b": knn_cuda.knn_banded_batched,
            "moments_b": fs.moments_batched, "spfh_b": fs.spfh_batched,
            "agg_b": fs.fpfh_agg_batched}


# K1 / K1b launches by k, read from the wrappers' ``launches_k``
BY_K = {"knn_k15": ("knn", 15), "knn_k48": ("knn", 48),
        "knn_b_k15": ("knn_b", 15), "knn_b_k48": ("knn_b", 48)}


def reset_launches():
    """Every launch counter to 0, the counts by k cleared."""
    for cnt in launch_counters().values():
        cnt.launches = 0
        if hasattr(cnt, "launches_k"):
            cnt.launches_k.clear()


def launches_now():
    counters = launch_counters()
    out = {k: c.launches for k, c in counters.items()}
    out.update({key: counters[base].launches_k.get(k, 0)
                for key, (base, k) in BY_K.items()})
    return out


def pipeline_config():
    """Default capacities (4096 keyframes, 512 loop factors, 8192 points a
    keyframe, src/dst caps 16384/32768) and loop_batch 4, with the compact
    loop timing of tests/test_pipeline.py (12 s time gap, 5 m radius) and
    a tick every 2 s, so that most ticks find two or more keyframes
    pending."""
    from fast_lio_sam_qn_tpu_torch.utils.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.loop.loop_detection_timediff_threshold = 12.0
    cfg.loop.loop_detection_radius = 5.0
    cfg.loop.loop_batch = 4
    cfg.loop_update_hz = 0.5
    return cfg


def pipeline_run(dev):
    """tests/test_pipeline.py's recipe at full width: a 26 m room, a 7 m
    circle lapped every 20 s, scans at 5 Hz, odometry drifting by a
    seeded random twist per scan.  Returns (pipeline, ground truth at the
    keyframes, drifted-odometry ATE, batched ticks, feed timings)."""
    import torch

    from fast_lio_sam_qn_tpu_torch.models.pipeline import FastLioSamQnPipeline
    from fast_lio_sam_qn_tpu_torch.ops import se3
    from fast_lio_sam_qn_tpu_torch.utils import evaluation, sim
    from fast_lio_sam_qn_tpu_torch.utils.profiling import Profiler

    world = sim.World.room(size=26.0, height=5.0, n_boxes=10, seed=3)
    traj = sim.Trajectory.loop(radius=7.0, period=20.0)
    rng = np.random.default_rng(0)
    pipe = FastLioSamQnPipeline(pipeline_config(), Profiler(), device=dev)
    lc = pipe.loop_closure
    batch_fn = lc.perform_loop_closure_batch
    ticks = []

    def traced(store, q, c):
        before = launches_now()
        out = batch_fn(store, q, c)
        torch.cuda.synchronize()
        after = launches_now()
        ticks.append((list(q), list(c),
                      {k: after[k] - before[k] for k in after}))
        return out

    lc.perform_loop_closure_batch = traced
    odom = prev = None
    gt_kf, feeds = [], []
    for i in range(PIPE_SCANS):
        t = i * 0.2
        T_gt = traj.pose(t)
        if odom is None:
            odom = T_gt.copy()
        else:
            xi = rng.normal(0, 0.004, 6) * np.array([0.2, 0.2, 1, 1, 1, 0.2])
            noise = se3.se3_exp(torch.tensor(xi, dtype=torch.float32))
            odom = odom @ np.linalg.inv(prev) @ T_gt @ noise.double().numpy()
        prev = T_gt
        scan, _ = sim.simulate_scan(world, T_gt, n_points=PIPE_POINTS,
                                    noise=0.01, seed=100 + i)
        cloud, mask = sim.pad_cloud(scan, PIPE_POINTS)
        n_kf = pipe.current_kf_idx
        n_tick = pipe.profiler.stats["loop"].count
        t0 = time.perf_counter()
        pipe.feed(odom.astype(np.float32), cloud, mask, t)
        ms = (time.perf_counter() - t0) * 1e3
        kf = pipe.current_kf_idx > n_kf
        feeds.append((ms, kf, pipe.profiler.stats["loop"].count > n_tick))
        if kf:
            gt_kf.append(T_gt)
    lc.perform_loop_closure_batch = batch_fn
    odom_kf, _ = pipe.get_trajectories()
    gt_kf = np.stack(gt_kf)
    return pipe, gt_kf, evaluation.ate_rmse(odom_kf, gt_kf, align=False), \
        ticks, feeds


def check_pipeline(pipe, gt_kf, ate_odom, ticks):
    from fast_lio_sam_qn_tpu_torch.utils import evaluation

    single = ("knn", "knn_banded", "moments", "spfh", "agg")
    multi = [t for t in ticks if sum(c >= 0 for c in t[1]) >= 2]
    for q, c, d in ticks:
        if any(d[k] for k in single) or not all(d[k] > 0 for k in BATCHED):
            raise AssertionError(f"batched tick {q} -> {c} launched {d}")
    log(f"pipeline: {pipe.current_kf_idx} keyframes, {len(ticks)} batched "
        f"ticks ({len(multi)} with 2+ candidate lanes), "
        f"{len(pipe.loop_events)} loop events, "
        f"{sum(e.accepted for e in pipe.loop_events)} accepted, "
        f"{len(pipe.loop_idx_pairs)} committed")
    if len(multi) < 3:
        raise AssertionError(f"only {len(multi)} batched ticks with 2+ "
                             f"candidate lanes")
    last_tick = max(e.tick_time for e in pipe.loop_events)
    n_before = sum(1 for t in pipe.kf_timestamps if t <= last_tick)
    if not all(pipe._kf_processed[:n_before]):
        raise AssertionError("a keyframe before the last tick was skipped")
    if not pipe.loop_idx_pairs:
        raise AssertionError("no loop was accepted and committed")
    _, corrected = pipe.get_trajectories()
    if not np.isfinite(corrected).all() or corrected.shape != gt_kf.shape:
        raise AssertionError("corrected trajectory non-finite or misshapen")
    ate = evaluation.ate_rmse(corrected, gt_kf, align=False)
    log(f"pipeline ATE: corrected {ate:.4f} m, drifted odometry "
        f"{ate_odom:.4f} m")
    if not (ate < ate_odom and ate < 0.5):
        raise AssertionError(f"corrected ATE {ate} (odometry {ate_odom})")
    return multi


def lane_vs_single(pipe, tick):
    """One batched tick re-run lane by lane through perform_loop_closure on
    the same store; the batched tick and a solve repeat bit for bit."""
    import torch

    from fast_lio_sam_qn_tpu_torch.ops import pgo

    lc, store = pipe.loop_closure, pipe.store
    q, c, _ = tick
    reg = lc.perform_loop_closure_batch(store, q, c)
    again = lc.perform_loop_closure_batch(store, q, c)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(reg, again)):
        raise AssertionError("a repeated batched tick differs")
    worst_t = worst_r = 0.0
    for b, (qi, ci) in enumerate(zip(q, c)):
        if ci < 0:
            continue
        one = lc.perform_loop_closure(store, qi, ci)
        for f in ("closest_idx", "is_converged", "is_valid"):
            if not torch.equal(getattr(one, f), getattr(reg, f)[b]):
                raise AssertionError(f"lane {b} ({qi} -> {ci}): {f} differs")
        t, r = pose_gap(one.pose_between, reg.pose_between[b])
        worst_t, worst_r = max(worst_t, t), max(worst_r, r)
    log(f"lane vs single on tick {q} -> {c}: same decisions, largest pose "
        f"difference {worst_t:.3e} m / {worst_r:.3e} rad; the batched "
        f"tick repeats bit for bit")
    if not (worst_t < 1e-3 and worst_r < 1e-3):
        raise AssertionError("a lane differs from its single run")
    args = (pipe.graph, pipe._prior_var, pipe._odom_var)
    g1 = pgo.optimize(*args, gn_iters=5, robust_delta=pipe.cfg.robust_delta)
    g2 = pgo.optimize(*args, gn_iters=5, robust_delta=pipe.cfg.robust_delta)
    if not all(torch.equal(a, b) for a, b in zip(g1, g2)):
        raise AssertionError("a repeated pose-graph solve differs")
    log("pgo.optimize (5 GN steps) repeats bit for bit")


# the port's kernels, as the profiler names them (csrc/*.cu)
PORT_KERNELS = ("knn1_kernel", "knnk_kernel", "banded1_kernel",
                "bandedk_kernel", "tile_bbox_kernel", "merge_slices",
                "moments_kernel", "spfh_kernel", "agg_kernel")


def device_ms(fn, reps: int = 10, windows: int = 3):
    """Device time per call of ``fn`` spent in the port's own kernels
    (torch.profiler, after one warm-up call), without the wrapper's host
    time and its small torch ops; the first of up to ``windows``
    profiling windows that records any (a window now and then records no
    device event), else None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", 0.0)
                 for e in prof.key_averages()
                 if any(k in e.key for k in PORT_KERNELS))
        if us > 0:
            return us / reps / 1e3
    return None


def kernel_ms(timing):
    """A kernel's time: its device time where the profiler gave one, else
    the CUDA-event time of its wrapper's call."""
    return timing[0] if timing[2] is None else timing[2]


def time_pairs(timed, card, plain_reps=10):
    """kernel and plain version in turns (plain, kernel, kernel, plain);
    the better of each pair of medians (CUDA events around the wrapper's
    call; ``plain_reps`` calls a median for the plain version), then the
    kernels' own device time (``device_ms``)."""
    ms = {}
    for name, (kern, plain) in timed.items():
        a = cuda_ms(plain, plain_reps)
        b = cuda_ms(kern)
        c = cuda_ms(kern)
        d = cuda_ms(plain, plain_reps)
        dev = device_ms(kern)
        ms[name] = (min(b, c), min(a, d), dev)
        log(f"time {name}: kernel {b:.4f} / {c:.4f} ms, plain {a:.4f} / "
            f"{d:.4f} ms; the kernel's device time "
            f"{'not measured' if dev is None else f'{dev:.4f} ms'} [{card}]")
    return ms


def pipeline_timings(pipe, multi, feeds, card):
    import torch

    from fast_lio_sam_qn_tpu_torch.ops import pgo
    from fast_lio_sam_qn_tpu_torch.tools.pgo_graph import build_graph

    lc, store = pipe.loop_closure, pipe.store
    q, c, _ = max(multi, key=lambda t: sum(ci >= 0 for ci in t[1]))
    pairs = [(qi, ci) for qi, ci in zip(q, c) if ci >= 0]
    tb = cuda_ms(lambda: lc.perform_loop_closure_batch(store, q, c))
    ts = cuda_ms(lambda: [lc.perform_loop_closure(store, qi, ci)
                          for qi, ci in pairs])
    log(f"time batched tick B={len(q)} ({len(pairs)} candidate lanes): "
        f"{tb:.3f} ms; {len(pairs)} single registrations on the same "
        f"candidates: {ts:.3f} ms [{card}]")
    cfg = pipe.cfg
    g, _, n_loops = build_graph(1024, device=pipe.device,
                                capacity=cfg.caps.max_keyframes,
                                loop_capacity=cfg.caps.max_loop_factors)
    for gn in (2, 5):
        t = cuda_ms(lambda: pgo.optimize(
            g, pipe._prior_var, pipe._odom_var, gn_iters=gn,
            robust_delta=cfg.robust_delta))
        log(f"time pgo.optimize {gn} GN steps, 1024 of "
            f"{cfg.caps.max_keyframes} nodes, {n_loops} of "
            f"{cfg.caps.max_loop_factors} loops: {t:.3f} ms [{card}]")
    for label, sel in (("non-keyframe", lambda kf, tick: not kf and not tick),
                       ("keyframe", lambda kf, tick: kf and not tick),
                       ("with a loop tick", lambda kf, tick: tick)):
        ms = [f[0] for f in feeds if sel(f[1], f[2])]
        if ms:
            log(f"time feed, {label} scans: median {np.median(ms):.3f} ms, "
                f"max {max(ms):.3f} ms over {len(ms)} scans (host clock; "
                f"feed ends in a host read) [{card}]")
    for name, st in pipe.profiler.summary().items():
        log(f"  span {name}: {st}")
    torch.cuda.synchronize()


def k3_caller_order_route(points, mask, radii, viewpoint, batched=True):
    """The route before the sort moved ahead of K3: K3 and the normals on
    the caller's rows, K4 and K5 on the Morton-sorted rows.  K3 sums each
    valid row in ascending caller order, the unpruned kernel's chain, so
    this route gives that tree's bits."""
    from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream as fs
    from fast_lio_sam_qn_tpu_torch.ops import knn_cuda

    normal_radius, feature_radius, cov_radius = radii
    viewpoint = fs._viewpoints(points, mask, viewpoint)
    normals, n_valid, cov_reg = fs.surface_stage(
        points, mask, normal_radius, cov_radius, viewpoint, batched)
    order = knn_cuda.morton_order_batched(points, mask)
    p, m, nrm, nv = (knn_cuda.take_rows(x, order)
                     for x in (points, mask, normals, n_valid))
    raw, agg = fs.spfh_agg(p, m, nrm, nv, feature_radius, batched)
    desc, valid = fs._descriptor(fs._normalized_spfh(raw), raw, agg, nv)
    return (knn_cuda.put_rows(desc, order), knn_cuda.put_rows(valid, order),
            normals, n_valid, cov_reg)


def caller_order_route(points, mask, radii, viewpoint, batched=True):
    """Every stage on the caller's rows, K3-K5 included.  K5 then sums each
    row's in-radius pairs in ascending caller order with the same fmaf
    chain as the unpruned K5 before the sorted route, so this route gives
    that kernel's bits."""
    from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream as fs

    return fs._stages(points, mask, radii,
                      fs._viewpoints(points, mask, viewpoint), batched)


def trace_fpfh_order(dev):
    """``--trace-fpfh-order``: the pipeline run of phase 6 on three routes
    (everything on the Morton-sorted rows; K3 on the caller's rows and K4 /
    K5 sorted; everything on the caller's rows), every loop event of each,
    and where consecutive routes part: a decision that moves between the
    first two comes from K3's summation order, one between the last two
    from K4 / K5's."""
    from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream as fs
    from fast_lio_sam_qn_tpu_torch.utils import evaluation

    sorted_route = fs.sorted_route
    events = {}
    for label, route in (("all sorted", sorted_route),
                         ("K3 on caller order, K4 / K5 sorted",
                          k3_caller_order_route),
                         ("all on caller order", caller_order_route)):
        fs.sorted_route = route
        try:
            pipe, gt_kf, _, ticks, _ = pipeline_run(dev)
        finally:
            fs.sorted_route = sorted_route
        _, corrected = pipe.get_trajectories()
        ev = [(e.tick_time, e.query_idx, e.closest_idx, e.score, e.accepted)
              for e in pipe.loop_events]
        events[label] = ev
        log(f"trace {label}: {pipe.current_kf_idx} keyframes, {len(ev)} "
            f"loop events, {sum(e[4] for e in ev)} accepted, committed "
            f"{pipe.loop_idx_pairs}, ATE "
            f"{evaluation.ate_rmse(corrected, gt_kf, align=False)!r} m")
        for e in ev:
            log(f"  t={e[0]} {e[1]} -> {e[2]}: score {e[3]!r}, accepted "
                f"{e[4]}")
        log(f"  K2b launches (GICP iterations + 1) per tick: "
            f"{[(q, c, d['knn_banded_b']) for q, c, d in ticks]}")
    labels = list(events)
    for la, lb, cause in ((labels[0], labels[1], "K3's order"),
                          (labels[1], labels[2], "K4 / K5's order")):
        a, b = events[la], events[lb]
        moved = [i for i, (x, y) in enumerate(zip(a, b))
                 if (x[1], x[2], x[4]) != (y[1], y[2], y[4])]
        rel = max((abs(x[3] - y[3]) / max(abs(y[3]), 1e-30)
                   for x, y in zip(a, b)), default=0.0)
        log(f"trace {la!r} vs {lb!r} ({cause}): {len(a)} / {len(b)} events;"
            f" decisions (query, candidate, accepted) differ at events "
            f"{moved}; the largest relative score difference is {rel:.3e}")


# ---------------------------------------------------------------------------
# the per-scan LIO (Slice D)
# ---------------------------------------------------------------------------

GOLDEN_SCANS, GOLDEN_HZ = 240, 5.0
# the final position error (m) of the lio_kitti run (30 scans at the
# kitti width) through the port on the CPU of the H100 host: `python3 -m
# fast_lio_sam_qn_tpu_torch.tools.profile_insert --drift --device cpu`
KITTI_CPU_ERR = 5.373919584431193
# the largest position error (m) of the JAX package's LIO over the sim
# golden's stream with map_backend="point", 60 scans (lio_point's stream),
# on the CPU: `python -m pytest tests/test_torch_lio_ext.py -m slow -k
# drift_pin -s`
POINT_JAX_ERR = 0.006550378210050167
SMALL_WIDTH = dict(max_points_per_scan=2048, map_table_size=1 << 13)


class EventSpans:
    """Named spans timed with CUDA events, with the ``span(name)`` of
    ``utils.profiling.Profiler``; ``ms(name)`` reads them after a sync.
    A span measures the device's clock between the work enqueued before
    it and after it, host-bound gaps included."""

    def __init__(self):
        self.events = {}

    @contextlib.contextmanager
    def span(self, name):
        import torch

        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        try:
            yield
        finally:
            b.record()
            self.events.setdefault(name, []).append((a, b))

    def ms(self, name, skip=0):
        import torch

        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events[name][skip:]]

    def report(self, label, card, skip=0):
        for name in self.events:
            t = self.ms(name, skip)
            log(f"{label} span {name}: median {np.median(t):.3f} ms, p90 "
                f"{np.percentile(t, 90):.3f} ms, mean {np.mean(t):.3f} ms "
                f"over {len(t)} (CUDA events) [{card}]")


class PhaseMemory:
    """Peak device memory of a phase above what was allocated when it
    started (earlier phases' tensors excluded)."""

    def __init__(self, dev):
        import torch

        self.dev = dev
        self.base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    def __str__(self):
        import torch

        peak = torch.cuda.max_memory_allocated(self.dev)
        return (f"peak device memory {(peak - self.base) / 2**30:.3f} GiB "
                f"above the phase's start ({peak / 2**30:.3f} GiB in all)")


def golden_config():
    """The 240-scan sim golden's config: the "sim" preset with run_sim's
    capacities (tests/test_golden.py:25-37)."""
    from fast_lio_sam_qn_tpu_torch.configs.presets import get_pipeline_config
    from fast_lio_sam_qn_tpu_torch.utils.config import Capacities

    cfg = get_pipeline_config("sim")
    cfg.caps = Capacities(max_keyframes=256, max_loop_factors=32,
                          keyframe_points=2048, src_points=2048,
                          dst_points=4096)
    return cfg


def syncs_and_launches(fn):
    """(host syncs, kernels on the card, kernel-launch calls, the syncs'
    source lines) of one call of ``fn``: the syncs counted by torch's sync
    debug mode (garbage collection held off, so that no finalizer of an
    earlier phase's objects lands in the count), the kernels and launch
    calls by torch.profiler."""
    import gc
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # the first switch into the debug mode in a process records one sync
    # of its own (inside torch.cuda): switch once before counting
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    gc.collect()
    gc.disable()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            gc.enable()
    sites = [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    kernels = sum(e.count for e in ka if e.device_type == DeviceType.CUDA)
    calls = sum(e.count for e in ka
                if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                             "cuLaunchKernel", "cuLaunchKernelEx"))
    return len(sites), kernels, calls, sites


def lio_golden(dev, card):
    """The 240-scan sim golden through the port on the card:
    ``run.sim_lio_stream`` with the "sim" preset (26 m room, 7 m loop
    lapped every 40 s, 5 Hz scans), replayed into the pipeline with the
    golden's capacities; 34 keyframes, 4-8 committed pairs, 12 loop
    events and ATE 0.0417 m +- 20 % (tests/test_golden.py:95-112)."""
    import torch

    from fast_lio_sam_qn_tpu_torch.models.pipeline import FastLioSamQnPipeline
    from fast_lio_sam_qn_tpu_torch.run import sim_lio_stream
    from fast_lio_sam_qn_tpu_torch.tools import lio_scenarios as ls
    from fast_lio_sam_qn_tpu_torch.utils import evaluation

    cfg = golden_config()
    world, traj = ls.golden_world()
    spans = EventSpans()
    mem = PhaseMemory(dev)
    t0 = time.perf_counter()
    feed = list(sim_lio_stream(cfg, world, traj, GOLDEN_SCANS, GOLDEN_HZ,
                               prof=spans, device=dev))
    torch.cuda.synchronize()
    log(f"lio_golden stream: {GOLDEN_SCANS} scans of "
        f"{cfg.lio.max_points_per_scan} points in "
        f"{time.perf_counter() - t0:.1f} s (simulation included), {mem}")
    spans.report("lio_golden (sim width)", card, skip=1)
    poses = torch.stack([f[0] for f in feed])
    if not bool(torch.isfinite(poses).all()):
        raise AssertionError("lio_golden: a non-finite LIO pose")

    reset_launches()
    mem = PhaseMemory(dev)
    pipe = FastLioSamQnPipeline(cfg, device=dev)
    gt, feed_ms = [], []
    for pose, cloud, mask, t1, gt_pose in feed:
        a = time.perf_counter()
        pipe.feed(pose, cloud, mask, t1)
        feed_ms.append((time.perf_counter() - a) * 1e3)
        gt.append(gt_pose)
    log(f"lio_golden replay: kernel launches {launches_now()}, {mem}")
    log(f"lio_golden feed: median {np.median(feed_ms):.3f} ms, p90 "
        f"{np.percentile(feed_ms, 90):.3f} ms, max {max(feed_ms):.3f} ms over "
        f"{len(feed_ms)} feeds (host clock; feed ends in a host read) "
        f"[{card}]")
    for name, st in pipe.profiler.summary().items():
        log(f"  span {name}: {st}")
    period = 1.0 / GOLDEN_HZ
    gtn = np.stack(gt)
    gt_kf = [gtn[min(int(round(t / period)) - 1, len(gtn) - 1)]
             for t in pipe.kf_timestamps]
    _, corrected = pipe.get_trajectories()
    ate = evaluation.ate_rmse(corrected, np.stack(gt_kf))
    kf, pairs = pipe.current_kf_idx, len(pipe.loop_idx_pairs)
    events = len(pipe.loop_events)
    log(f"lio_golden: {kf} keyframes, {events} loop events, "
        f"{sum(e.accepted for e in pipe.loop_events)} accepted, {pairs} "
        f"committed, ATE {ate!r} m (pinned: 34, 12, 4-8, 0.0417 m +- 20 %)")
    if not (kf == 34 and 4 <= pairs <= 8 and events == 12
            and abs(ate - 0.0417) < 0.2 * 0.0417):
        raise AssertionError(f"lio_golden: {kf} keyframes, {pairs} pairs, "
                             f"{events} events, ATE {ate}")


def lio_kitti(dev, card):
    """The LIO at the kitti width (``LioConfig()``: 32,768 points, 2^19
    slots, 0.5 m) on a straight 2 m/s drive through a 120 m room, 10 warm
    scans then 20 timed: every scan after the first matches planes, the
    final position error stays within 2x the same run's on the CPU."""
    import torch

    from fast_lio_sam_qn_tpu_torch.tools import profile_insert as pi

    spans = EventSpans()
    mem = PhaseMemory(dev)
    lio, state = pi.kitti_lio(dev, profiler=spans)
    matches = []
    for s in range(pi.KITTI_SCANS):
        inputs = pi.kitti_inputs(s)
        with spans.span("lio"):
            state, res = lio.process_scan(state, *inputs)
        matches.append(res.num_matches)
    torch.cuda.synchronize()
    matches = [int(m) for m in matches]
    err = float(np.linalg.norm(res.pose.cpu().numpy()[:3, 3]
                               - pi.kitti_truth(inputs[-1])[:3, 3]))
    log(f"lio_kitti: {pi.KITTI_SCANS} scans, matches {matches}, final "
        f"position error {err!r} m (the CPU run's {KITTI_CPU_ERR!r} m), "
        f"{mem}")
    spans.report("lio_kitti (kitti width, 20 timed scans)", card, skip=10)
    syncs, kernels, calls, sites = syncs_and_launches(
        lambda: lio.process_scan(state, *inputs))
    log(f"lio_kitti per scan: {syncs} host syncs ({', '.join(sites)}), "
        f"{kernels} kernels on the card, {calls} launch calls")
    if not all(m > 0 for m in matches[1:]):
        raise AssertionError(f"lio_kitti: a scan matched no plane {matches}")
    if KITTI_CPU_ERR is not None and not err <= 2 * KITTI_CPU_ERR:
        raise AssertionError(f"lio_kitti: error {err} m beyond 2x the CPU "
                             f"run's {KITTI_CPU_ERR} m")


def voxel_gap(a, b):
    """(voxels that one of two point maps holds and the other does not,
    voxels both hold with a different representative point, voxels either
    holds), whatever slots the two hash tables put them in."""
    import torch

    def keyed(g):
        c = g.coords[g.occupied].to("cpu", torch.int64) + (1 << 20)
        key, order = torch.sort((c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2])
        return key, g.src_idx[g.occupied].cpu()[order]

    (ka, ia), (kb, ib) = keyed(a), keyed(b)
    ina, inb = torch.isin(ka, kb), torch.isin(kb, ka)
    only = int((~ina).sum() + (~inb).sum())
    return only, int((ia[ina] != ib[inb]).sum()), len(ka) + int(
        (~inb).sum())


def card_vs_cpu(dev, cfg, label, maps_may_part=False):
    """5 scans of the golden's stream through the port with LIO config
    ``cfg`` on the card and on the CPU: each scan run on the card from the
    CPU run's state before it gives the CPU's match count and its pose
    within 1e-4 m and 1e-4 rad; free-running, the poses stay within 1e-4
    m and rad.  With ``maps_may_part`` (the point map), the free-running
    limit holds while the two maps hold the same voxels and points
    (``voxel_gap``); once they part (a point's fp32 world position,
    rounded differently on the two devices, lands across a voxel face),
    the scans after are held by the check from the CPU's state alone, and
    the free-running gap and the maps' gap are logged."""
    import torch

    from fast_lio_sam_qn_tpu_torch.models.lio import LIO
    from fast_lio_sam_qn_tpu_torch.ops import se3
    from fast_lio_sam_qn_tpu_torch.run import initial_state, sim_scan_inputs
    from fast_lio_sam_qn_tpu_torch.tools import lio_scenarios as ls

    world, traj = ls.golden_world()
    lios = {d: LIO(cfg, device=d) for d in (dev, torch.device("cpu"))}
    states = {d: initial_state(lio, traj) for d, lio in lios.items()}
    cpu = torch.device("cpu")

    def to(x, d):
        if isinstance(x, torch.Tensor):
            return x.to(d)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(to(v, d) for v in x))
        return x

    worst = [0.0] * 6   # free-running (held), from the CPU's state, after
    counts, gaps, parted = [], [], None
    for i in range(5):
        inputs = sim_scan_inputs(world, traj, i, 1.0 / GOLDEN_HZ,
                                 4 * cfg.max_points_per_scan)
        shared = to(states[cpu], dev)
        _, r_shared = lios[dev].process_scan(shared, *inputs)
        out = {}
        for d, lio in lios.items():
            states[d], out[d] = lio.process_scan(states[d], *inputs)
        for k, (a, b) in enumerate(((out[dev].pose, out[cpu].pose),
                                    (r_shared.pose, out[cpu].pose))):
            if k == 0 and parted is not None:
                k = 2
            a, b = a.double().cpu(), b.double()
            worst[2 * k] = max(worst[2 * k],
                               float((a[:3, 3] - b[:3, 3]).abs().max()))
            worst[2 * k + 1] = max(worst[2 * k + 1], float(torch.linalg.norm(
                se3.so3_log(a[:3, :3].T @ b[:3, :3]))))
        counts.append((int(out[dev].num_matches), int(out[cpu].num_matches),
                       int(r_shared.num_matches)))
        if maps_may_part:
            gaps.append(voxel_gap(states[dev].grid, states[cpu].grid))
            if parted is None and (gaps[-1][0] or gaps[-1][1]):
                parted = i
    held = "every scan" if parted is None else \
        f"scans 0-{parted}, the maps parting after scan {parted}"
    log(f"{label}: free-running poses ({held}) differ by at most "
        f"{worst[0]:.3e} m / {worst[1]:.3e} rad; each scan from the CPU's "
        f"state: {worst[2]:.3e} m / {worst[3]:.3e} rad; matches (card, CPU, "
        f"card from the CPU's state) {counts}"
        + (f"; free-running after the maps part {worst[4]:.3e} m / "
           f"{worst[5]:.3e} rad; voxels in one map only, represented "
           f"differently, in either, after each scan {gaps}"
           if maps_may_part else ""))
    if not all(w < 1e-4 for w in worst[:4]):
        raise AssertionError(f"{label}: poses differ beyond the limits")
    if any(c[1] != c[2] for c in counts):
        raise AssertionError(f"{label}: match counts differ")


def lio_card_vs_cpu(dev):
    """5 scans of the golden's stream at a small width (2,048 points, 2^13
    slots) on the card and on the CPU (``card_vs_cpu``)."""
    import dataclasses

    card_vs_cpu(dev, dataclasses.replace(golden_config().lio, **SMALL_WIDTH),
                "lio_card_vs_cpu")


def repeat_scan(dev, cfg, label, card):
    """One process_scan with LIO config ``cfg`` run twice from the same
    state (after 6 scans of the golden's stream) on the card: every map
    field, the nav state and P bit-identical; the scan's host syncs and
    kernels are counted on a third run.  Returns (syncs, kernels)."""
    import torch

    from fast_lio_sam_qn_tpu_torch.models.lio import LIO
    from fast_lio_sam_qn_tpu_torch.run import initial_state, sim_scan_inputs
    from fast_lio_sam_qn_tpu_torch.tools import lio_scenarios as ls

    world, traj = ls.golden_world()
    lio = LIO(cfg, device=dev)
    state = initial_state(lio, traj)
    raw_n = 4 * cfg.max_points_per_scan
    for i in range(6):
        state, _ = lio.process_scan(
            state, *sim_scan_inputs(world, traj, i, 1.0 / GOLDEN_HZ, raw_n))
    inputs = sim_scan_inputs(world, traj, 6, 1.0 / GOLDEN_HZ, raw_n)
    a, _ = lio.process_scan(state, *inputs)
    b, _ = lio.process_scan(state, *inputs)
    torch.cuda.synchronize()
    fields = {k: (getattr(a.grid, k), getattr(b.grid, k))
              for k in a.grid._fields if k != "res"}
    fields["P"] = (a.P, b.P)
    fields.update({f"nav.{k}": (getattr(a.nav, k), getattr(b.nav, k))
                   for k in a.nav._fields})
    fields.update({f"ext.{k}": (getattr(a.ext, k), getattr(b.ext, k))
                   for k in a.ext._fields})
    differ = [k for k, (x, y) in fields.items() if not torch.equal(x, y)]
    if differ:
        raise AssertionError(f"{label}: {differ} differ")
    syncs, kernels, calls, sites = syncs_and_launches(
        lambda: lio.process_scan(state, *inputs))
    log(f"{label}: one scan at the sim width twice from one state: "
        f"{', '.join(fields)} bit-identical; per scan {syncs} host syncs "
        f"({', '.join(sites)}), {kernels} kernels on the card, {calls} "
        f"launch calls [{card}]")
    return syncs, kernels


def lio_repeat(dev, card):
    """``repeat_scan`` on the golden's config (the surfel map)."""
    repeat_scan(dev, golden_config().lio, "lio_repeat", card)


def lio_point(dev, card):
    """The point-map backend (``map_backend="point"``) at the sim width
    (4,096 points, 2^17 slots, 0.3 m): 5 scans on the card and on the CPU
    (``card_vs_cpu``, the maps may part), one scan repeated bit for bit,
    and the golden's stream for 60 scans, whose largest position error
    stays within 1.5x the JAX package's at the same size and seeds
    (``POINT_JAX_ERR``); ms per scan and stage spans (CUDA events), host
    syncs and kernels per scan, peak memory."""
    import torch

    from fast_lio_sam_qn_tpu_torch.tools import lio_scenarios as ls

    cfg = ls.point_config().lio
    # the two point maps part from the first scan on: 11 of 3,718 voxels
    # differ after it, their points rounded across a voxel face (PERF.md)
    card_vs_cpu(dev, cfg, "lio_point card vs CPU", maps_may_part=True)
    repeat_scan(dev, cfg, "lio_point repeat", card)
    spans = EventSpans()
    mem = PhaseMemory(dev)
    t0 = time.perf_counter()
    errs = ls.point_stream(dev, prof=spans)
    torch.cuda.synchronize()
    log(f"lio_point stream: {ls.POINT_SCANS} scans in "
        f"{time.perf_counter() - t0:.1f} s (simulation included), largest "
        f"position error {errs.max()!r} m, final {errs[-1]!r} m (the JAX "
        f"package's largest {POINT_JAX_ERR!r} m), {mem}")
    spans.report("lio_point (sim width, point map)", card, skip=1)
    if not errs.max() <= 1.5 * POINT_JAX_ERR:
        raise AssertionError(f"lio_point: error {errs.max()} m beyond 1.5x "
                             f"the JAX package's {POINT_JAX_ERR} m")


def lio_extrinsic(dev, card):
    """tests/test_extrinsic.py:108-212 on the card at its own size: a
    surfel map built from the truth, 4,096 points a scan, the excited loop,
    50 scans, the LiDAR mounted 3 / 2 / 2.5 deg and (8, -5, 3) cm off the
    configured identity; roll and pitch errors below 0.8 deg, yaw below 3,
    each lever arm below 2.5 cm, the last 10 scans' mean position error
    below 5 cm.  ms per scan and stage spans, syncs and kernels per scan,
    peak memory."""
    from fast_lio_sam_qn_tpu_torch.tools import lio_scenarios as ls

    spans = EventSpans()
    mem = PhaseMemory(dev)
    t0 = time.perf_counter()
    run = ls.extrinsic_convergence(dev, prof=spans)
    log(f"lio_extrinsic: {ls.EXT_SCANS} scans in "
        f"{time.perf_counter() - t0:.1f} s (map build and simulation "
        f"included), rotation error {run.rot_err} deg, lever-arm error "
        f"{run.lever_err} m, last 10 scans' mean position error "
        f"{run.pose_errs[-10:].mean()!r} m, {mem}")
    spans.report("lio_extrinsic (24-dim, surfel map)", card, skip=1)
    syncs, kernels, calls, sites = syncs_and_launches(run.rerun)
    log(f"lio_extrinsic per scan: {syncs} host syncs ({', '.join(sites)}), "
        f"{kernels} kernels on the card, {calls} launch calls [{card}]")
    rot, lever = run.rot_err, run.lever_err
    if not (abs(rot[0]) < 0.8 and abs(rot[1]) < 0.8 and abs(rot[2]) < 3.0
            and (np.abs(lever) < 0.025).all()
            and run.pose_errs[-10:].mean() < 0.05):
        raise AssertionError(f"lio_extrinsic: {rot} deg, {lever} m, "
                             f"{run.pose_errs[-10:]}")


def cli_run(args, spans=None):
    """``run.main(args)`` in-process, as a user starts the port: returns
    (the JSON report, wall seconds on the host clock, the pipeline it ran).
    With ``spans`` (EventSpans) the run's Profiler spans (``lio``, ``pgo``,
    ``io``) are also timed with CUDA events."""
    import io

    from fast_lio_sam_qn_tpu_torch import run
    from fast_lio_sam_qn_tpu_torch.utils.profiling import Profiler

    modes = ("run_sim", "run_kitti", "run_bag", "run_parity")
    saved = {k: getattr(run, k) for k in modes + ("Profiler",)}
    out, runs = io.StringIO(), []
    # main returns only its exit code: keep the pipeline it ran
    for k in modes:
        setattr(run, k, lambda a, f=saved[k]: runs.append(f(a)) or runs[-1])
    if spans is not None:
        class Both(Profiler):
            @contextlib.contextmanager
            def span(self, name):
                with Profiler.span(self, name), spans.span(name):
                    yield

        run.Profiler = Both
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = run.main(args)
    finally:
        for k, v in saved.items():
            setattr(run, k, v)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"run.main {args} exited {rc}")
    return json.loads(out.getvalue()), wall, runs[0][0]


EXPORTS = ("poses_kitti.txt", "poses_tum.txt", "sequence_map.pcd",
           "result.bag", "result_keyframes.npz")


def missing_exports(report):
    import os

    seq = report["exported_to"]
    return [f for f in EXPORTS + (os.path.join("scans", "000000.pcd"),)
            if not os.path.exists(os.path.join(seq, f))]


def brief(report):
    return {k: v for k, v in report.items() if k != "timing"}


def cli_sim(dev, card, errs):
    """``run.main`` in-process on the card, as a user starts the port:
    ``--sim --trajectory corridor --n-scans 40 --out DIR`` (the size of
    tests/test_run_cli.py:191-203): rc 0, at least 5 keyframes, ATE below
    1 m, the KITTI and TUM poses, the scans, the map and result.bag in
    DIR; then ``--sim --n-scans 170`` on the loop, whose ticks after 30 s
    of data find candidates: loop attempts > 0 and K1-K5 launched in that
    run; then every kernel against its plain version (``kernel_parity``)
    on the clouds that run's single-candidate tick builds, at its
    capacities, for its first and last loop attempt (keyframes under the
    run's final poses), into ``errs``.  Wall time of each run (host
    clock)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="cli_sim_")
    try:
        report, wall, _ = cli_run(["--sim", "--trajectory", "corridor",
                                   "--n-scans", "40", "--out", tmp])
        missing = missing_exports(report)
        log(f"cli_sim corridor: {wall:.1f} s wall, report {brief(report)}; "
            f"timing {report['timing']} [{card}]")
        if missing or report["keyframes"] < 5 or \
                not report["ate_rmse_m"] < 1.0:
            raise AssertionError(f"cli_sim corridor: missing {missing}, "
                                 f"{report}")
        reset_launches()
        report, wall, pipe = cli_run(["--sim", "--n-scans", "170",
                                      "--no-auto-save"])
        launched = launches_now()
        log(f"cli_sim loop: {wall:.1f} s wall, report {brief(report)}; "
            f"kernel launches {launched} [{card}]")
        if report["loop_attempts"] < 1 or not all(
                launched[k] > 0 for k in SINGLE):
            raise AssertionError(f"cli_sim loop: {report}, {launched}")
        tick_kernel_parity(pipe, errs, "cli_sim")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


SINGLE = ("knn", "knn_banded", "moments", "spfh", "agg")


def tick_kernel_parity(pipe, errs, phase):
    """K1-K5 against their plain versions (``kernel_parity``) on the clouds
    a run's single-candidate tick builds, at its capacities, for its first
    and last loop attempt (keyframes under the run's final poses)."""
    lc, loop = pipe.loop_closure, pipe.cfg.loop
    if (loop.enable_quatro, loop.enable_submap_matching, loop.voxel_res) != \
            (True, False, 0.3):
        raise AssertionError(f"{phase}: the tick's clouds are not the "
                             f"single frames kernel_parity builds: {loop}")
    events = pipe.loop_events
    for ev in {(e.query_idx, e.closest_idx): e for e in (
            events[0], events[-1])}.values():
        kernel_parity(pipe.store, lc.src_cap, lc.dst_cap, errs,
                      pair=(ev.query_idx, ev.closest_idx),
                      where=f" ({phase}'s tick {ev.query_idx}->"
                            f"{ev.closest_idx})")


# ---------------------------------------------------------------------------
# the dataset entry points: --kitti, --scans/--poses, --bag, checkpoints
# ---------------------------------------------------------------------------

# the kitti preset at full width: 131,072 rays a scan (4x its 32,768-point
# cap, an HDL-64 sweep's size), 10 Hz, the golden's room and a 7 m loop
# lapped every 30 s; 360 scans give loop attempts under the 30 s / 35 m
# gates
DATA_SCANS, DATA_RAW, DATA_WORKERS = 360, 131072, 8
RESUME_SCANS, BAG_SCANS = 60, 60
INGEST_SCANS, INGEST_POINTS, INGEST_CAP = 40, 65536, 32768
ODOM_MISSING = (40, 41, 120, 250, 251)


def native_runtime(card, tmp):
    """The native host runtime on the H100 host: the library loads, built
    from the port's runtime.cpp into build/runtime/; ``read_scan`` equals
    the Python readers on a velodyne .bin and a binary PCD of a full-width
    scan, the prefetching loader equals ``read_scan``, the ApproximateTime
    pairs of seeded streams equal the Python version's, an LZ4 frame
    decodes; then ``tools/profile_ingest`` at 65,536-point scans
    (PointCloud2 and Livox, none / bz2 / lz4 chunks) against the 10 Hz
    budget.  Returns the ingest rows."""
    import os

    from fast_lio_sam_qn_tpu_torch.runtime import native
    from fast_lio_sam_qn_tpu_torch.tools import datasets, profile_ingest

    if not native.available():
        raise AssertionError(f"native runtime: {native.build_error()}")
    lib = native.library_path()
    if lib.parent != native.BUILD_DIR or not lib.exists():
        raise AssertionError(f"native runtime: {lib} is not the port's build")
    s = datasets.simulate_scan(0, DATA_RAW)
    xyzi = np.column_stack([s.points, s.intensities]).astype(np.float32)
    paths = [os.path.join(tmp, "000000.bin"), os.path.join(tmp, "000001.pcd")]
    xyzi.tofile(paths[0])
    with open(paths[1], "wb") as f:
        f.write((f"VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n"
                 f"TYPE F F F F\nCOUNT 1 1 1 1\nWIDTH {len(xyzi)}\nHEIGHT 1\n"
                 f"POINTS {len(xyzi)}\nDATA binary\n").encode()
                + xyzi.tobytes())
    for p in paths:
        got = native.read_scan(p)
        if not (np.array_equal(got, native.read_scan_python(p))
                and np.array_equal(got, xyzi)):
            raise AssertionError(f"native read_scan differs on {p}")
    loader = native.ScanLoader(paths * 4, n_threads=4, lookahead=4)
    try:
        for i in (0, 3, 1, 7, 2):
            if not np.array_equal(loader.get(i), xyzi):
                raise AssertionError(f"ScanLoader differs at {i}")
    finally:
        loader.close()
    rng = np.random.default_rng(0)
    ts_a = np.sort(rng.uniform(0, 100, 1000))
    ts_b = np.sort(np.concatenate([ts_a[::2] + rng.normal(0, 0.02, 500),
                                   rng.uniform(0, 100, 200)]))
    pairs = []
    for use in (True, False):
        sync = native.ApproxTimeSync(0.05, native=use)
        for i, t in enumerate(ts_a):
            sync.push_a(float(t), i)
        for j, t in enumerate(ts_b):
            sync.push_b(float(t), j)
        pairs.append([])
        while (p := sync.pop()) is not None:
            pairs[-1].append(p)
        sync.close()
    if pairs[0] != pairs[1]:
        raise AssertionError("native ApproxTimeSync pairs differ from the "
                             "Python version's")
    payload = xyzi.tobytes()[:1 << 20] * 3
    if native.lz4_decompress(datasets.lz4_frame(payload), len(payload)) \
            != payload:
        raise AssertionError("native LZ4 decode differs")
    log(f"native_runtime: {lib.name} from {native.SRC.name}; read_scan == "
        f"the Python readers on a {len(xyzi)}-point .bin and binary PCD; "
        f"the loader equal; {len(pairs[0])} sync pairs equal the Python "
        f"version's of {len(ts_a)} / {len(ts_b)} stamps; LZ4 frame decoded")
    rows = []
    for fmt, comp in (("pointcloud2", "none"), ("pointcloud2", "bz2"),
                      ("pointcloud2", "lz4"), ("livox", "none"),
                      ("livox", "lz4")):
        r = profile_ingest.measure(fmt, comp, INGEST_SCANS, INGEST_POINTS,
                                   INGEST_CAP)
        rows.append(r)
        log(f"ingest {fmt} {comp}: {r['scans']} scans x {r['points']} points "
            f"({r['bytes'] / 1e6:.1f} MB) in {r['seconds']:.3f} s: "
            f"{r['scans_per_s']:.1f} scans/s, {r['mb_per_s']:.0f} MB/s, "
            f"{r['x_10hz']:.1f}x the 10 Hz budget (host clock) [{card}]")
    return rows


def keyframe_truth(pipe, truth, stamps, offset=0.0):
    """The true pose of each keyframe: the scan whose stamp (plus
    ``offset``, the odometry's lag in parity mode) is the keyframe's."""
    idx = [int(np.argmin(np.abs(stamps + offset - t)))
           for t in pipe.kf_timestamps]
    return truth[idx]


def write_dataset(tmp, card):
    """The KITTI-style directory of the dataset phases (``tools/datasets``),
    scans made in DATA_WORKERS processes: (dir, stamps, truth)."""
    import os

    from fast_lio_sam_qn_tpu_torch.configs.presets import LIO_PRESETS
    from fast_lio_sam_qn_tpu_torch.tools import datasets

    kit = LIO_PRESETS["kitti"]
    d = os.path.join(tmp, "kitti")
    t0 = time.perf_counter()
    stamps, truth = datasets.write_kitti(
        d, datasets.simulate_scans(DATA_SCANS, DATA_RAW, kit.extrinsic_R,
                                   kit.extrinsic_T, workers=DATA_WORKERS),
        datasets.simulate_imu_rows(DATA_SCANS / 10.0))
    size = sum(os.path.getsize(os.path.join(d, "scans", f))
               for f in os.listdir(os.path.join(d, "scans")))
    log(f"dataset: {DATA_SCANS} scans of {DATA_RAW} rays in the LiDAR frame "
        f"of the kitti preset's extrinsic {kit.extrinsic_T}, {size / 1e9:.2f} "
        f"GB of .bin, made in {time.perf_counter() - t0:.1f} s "
        f"({DATA_WORKERS} processes) [{card}]")
    return d, stamps, truth


def cli_kitti(dev, card, errs, d, stamps, truth, tmp):
    """``run.main(["--kitti", DIR, "--preset", "kitti", "--out", OUT])`` at
    full width: rc 0, every export present, ATE at the keyframes < 0.5 m,
    loop attempts >= 1 with K1-K5 launched, K1-K5 against their plain
    versions on the first and last tick's clouds; LIO ms per scan (CUDA
    events, span ``lio``), feed ms (span ``pgo``), scans/s of the run
    against the 10 Hz sensor, peak memory."""
    import os

    from fast_lio_sam_qn_tpu_torch.utils import evaluation

    reset_launches()
    spans = EventSpans()
    mem = PhaseMemory(dev)
    report, wall, pipe = cli_run(["--kitti", d, "--preset", "kitti", "--out",
                                  os.path.join(tmp, "out")], spans)
    launched = launches_now()
    gt = keyframe_truth(pipe, truth, stamps)
    _, corrected = pipe.get_trajectories()
    ate = evaluation.ate_rmse(corrected, gt)
    ate_raw = evaluation.ate_rmse(corrected, gt, align=False)
    log(f"cli_kitti: {wall:.1f} s wall for {report['scans']} scans, "
        f"{report['scans'] / wall:.2f} scans/s against the 10 Hz sensor, "
        f"report {brief(report)}, {len(pipe.loop_events)} loop attempts, "
        f"ATE at the keyframes {ate!r} m ({ate_raw!r} m unaligned), kernel "
        f"launches {launched}, {mem} [{card}]")
    spans.report("cli_kitti (kitti width, 131,072 rays)", card, skip=1)
    missing = missing_exports(report)
    if report["scans"] != DATA_SCANS or missing:
        raise AssertionError(f"cli_kitti: {report}, missing {missing}")
    if not ate < 0.5:
        raise AssertionError(f"cli_kitti: ATE {ate} m")
    if not pipe.loop_events or not all(launched[k] > 0 for k in SINGLE):
        raise AssertionError(f"cli_kitti: {len(pipe.loop_events)} attempts, "
                             f"launches {launched}")
    tick_kernel_parity(pipe, errs, "cli_kitti")
    return ate


def kitti_resume(d, card, tmp):
    """RESUME_SCANS scans straight against half of them with --checkpoint
    and a --resume for the rest: equal keyframe counts, poses within 1e-4 m
    (the JAX package's tolerance); whether they are bit-identical."""
    import os

    from fast_lio_sam_qn_tpu_torch.utils import io as pio

    ck = os.path.join(tmp, "state.npz")
    args = ["--kitti", d, "--preset", "kitti"]
    full, w_full, _ = cli_run(args + ["--n-scans", str(RESUME_SCANS),
                                      "--out", os.path.join(tmp, "full")])
    half, w_half, _ = cli_run(args + ["--n-scans", str(RESUME_SCANS // 2),
                                      "--checkpoint", ck, "--no-auto-save"])
    res, w_res, _ = cli_run(args + ["--n-scans", str(RESUME_SCANS),
                                    "--resume", ck, "--out",
                                    os.path.join(tmp, "resumed")])
    a, b = (pio.load_poses_kitti(os.path.join(r["exported_to"],
                                              "poses_kitti.txt"))
            for r in (full, res))
    gap = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
    log(f"kitti resume: {RESUME_SCANS} scans straight ({w_full:.1f} s) vs "
        f"{RESUME_SCANS // 2} + --checkpoint ({w_half:.1f} s, "
        f"{os.path.getsize(ck) / 1e6:.1f} MB) + --resume ({w_res:.1f} s): "
        f"{full['keyframes']} / {res['keyframes']} keyframes, resumed at "
        f"{res['resumed_at']}, poses within {gap:.3e} m, bit-identical "
        f"{bool(np.array_equal(a, b))} [{card}]")
    if res["keyframes"] != full["keyframes"] or not gap <= 1e-4 \
            or res["resumed_at"] != RESUME_SCANS // 2:
        raise AssertionError(f"kitti resume: {full} vs {res}")


def cli_parity(dev, card, errs, d, stamps, truth, tmp):
    """The same scans in the body frame with drifted odometry, ``--stamps``,
    ``--odom-times`` missing 5 stamps and ``--loop-batch 4``, ticks every 2
    s (the reference's config.yaml at loop_update_hz 0.5, read as JSON, so
    that ticks find two pending keyframes): scans N - 5, dropped_unmatched
    5, K1b-K5b launched, and held against their plain versions on one
    batched tick's lanes; the corrected ATE below the drifted odometry's."""
    import os

    from fast_lio_sam_qn_tpu_torch.configs.presets import LIO_PRESETS
    from fast_lio_sam_qn_tpu_torch.models.loop_closure import LoopClosure
    from fast_lio_sam_qn_tpu_torch.tools import datasets
    from fast_lio_sam_qn_tpu_torch.utils import evaluation
    from fast_lio_sam_qn_tpu_torch.utils import io as pio

    kit = LIO_PRESETS["kitti"]
    R = np.asarray(kit.extrinsic_R, np.float64).reshape(3, 3)
    body = os.path.join(tmp, "body")
    os.makedirs(body)
    for i in range(DATA_SCANS):
        xyzi = pio.read_velodyne_bin(os.path.join(d, "scans", f"{i:06d}.bin"))
        xyzi[:, :3] = (xyzi[:, :3].astype(np.float64) @ R.T
                       + kit.extrinsic_T).astype(np.float32)
        xyzi.tofile(os.path.join(body, f"{i:06d}.bin"))
    odom = datasets.drifted_odometry(truth, seed=3, sigma=0.004)
    keep = [i for i in range(DATA_SCANS) if i not in ODOM_MISSING]
    files = {k: os.path.join(tmp, f"{k}.txt") for k in ("poses", "stamps",
                                                        "odom_times")}
    pio.save_poses_kitti(files["poses"], odom[keep])
    np.savetxt(files["stamps"], stamps, fmt="%.9f")
    np.savetxt(files["odom_times"], stamps[keep] + 0.012, fmt="%.9f")
    cfg = os.path.join(tmp, "config.json")
    with open(cfg, "w") as f:
        json.dump(REFERENCE_CONFIG, f)
    ticks, batch_fn = [], LoopClosure.perform_loop_closure_batch

    def traced(self, store, q, c):
        ticks.append((list(q), list(c)))
        return batch_fn(self, store, q, c)

    reset_launches()
    LoopClosure.perform_loop_closure_batch = traced
    mem = PhaseMemory(dev)
    try:
        report, wall, pipe = cli_run([
            "--scans", body, "--poses", files["poses"], "--stamps",
            files["stamps"], "--odom-times", files["odom_times"],
            "--sync-slop", "0.05", "--loop-batch", "4", "--preset", "kitti",
            "--ref-config", cfg, "--no-strict-parity", "--no-auto-save"])
    finally:
        LoopClosure.perform_loop_closure_batch = batch_fn
    launched = launches_now()
    gt = keyframe_truth(pipe, truth, stamps, 0.012)
    odom_kf, corrected = pipe.get_trajectories()
    ate = evaluation.ate_rmse(corrected, gt, align=False)
    ate_odom = evaluation.ate_rmse(odom_kf, gt, align=False)
    multi = [t for t in ticks if sum(c >= 0 for c in t[1]) >= 2]
    log(f"cli_parity: {wall:.1f} s wall, report {brief(report)}, "
        f"{len(ticks)} batched ticks ({len(multi)} with 2+ candidate lanes), "
        f"{len(pipe.loop_events)} loop events, "
        f"{sum(e.accepted for e in pipe.loop_events)} accepted, "
        f"{len(pipe.loop_idx_pairs)} committed, ATE corrected {ate!r} m vs "
        f"drifted odometry {ate_odom!r} m, kernel launches {launched}, {mem} "
        f"[{card}]")
    if (report["scans"], report["dropped_unmatched"]) != (
            DATA_SCANS - len(ODOM_MISSING), len(ODOM_MISSING)):
        raise AssertionError(f"cli_parity: {report}")
    if not multi or not all(launched[k] > 0 for k in BATCHED):
        raise AssertionError(f"cli_parity: ticks {ticks}, launches "
                             f"{launched}")
    if not ate < ate_odom:
        raise AssertionError(f"cli_parity: ATE {ate} vs odometry {ate_odom}")
    lc = pipe.loop_closure
    batched_parity(pipe.store, lc.src_cap, lc.dst_cap, errs, tick=multi[-1])


# the reference's config/config.yaml (effective values: the port's defaults)
# with the loop timer at 0.5 Hz
REFERENCE_CONFIG = {
    "basic": {"map_frame": "map", "loop_update_hz": 0.5, "vis_hz": 1.0},
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


def cli_bag(dev, card, tmp):
    """A full-width bag of BAG_SCANS scans (PointCloud2 with a time field,
    Imu at 200 Hz, drifted Odometry with 3 messages skipped, lz4 chunks):
    ``--bag`` in LIO mode gives the keyframes of ``bag_convert`` followed
    by ``--kitti`` within 1e-3 m (tests/test_rosbag.py:449-479);
    ``--bag --odom-topic`` drops and counts the unmatched scans
    (tests/test_rosbag.py:500-550); a Livox CustomMsg bag of the same scans
    runs end to end."""
    import os

    from fast_lio_sam_qn_tpu_torch.configs.presets import LIO_PRESETS
    from fast_lio_sam_qn_tpu_torch.tools import bag_convert, datasets
    from fast_lio_sam_qn_tpu_torch.utils import evaluation
    from fast_lio_sam_qn_tpu_torch.utils import io as pio

    kit = LIO_PRESETS["kitti"]
    t0 = time.perf_counter()
    rec = datasets.record(BAG_SCANS, DATA_RAW, kit.extrinsic_R,
                          kit.extrinsic_T, imu_hz=200.0, workers=DATA_WORKERS)
    skip = (10, 11, BAG_SCANS // 2 + 3)
    odom = datasets.drifted_odometry(rec.truth, seed=4)
    bag = os.path.join(tmp, "pc2.bag")
    size = datasets.write_bag(bag, datasets.bag_messages(
        rec, odometry=odom, odom_skip=skip), "lz4")
    livox = os.path.join(tmp, "livox.bag")
    lsize = datasets.write_bag(livox, datasets.bag_messages(
        rec, fmt="livox"), "lz4")
    log(f"cli_bag: {BAG_SCANS} scans, bags of {size / 1e6:.1f} MB "
        f"(PointCloud2 + Imu 200 Hz + Odometry, lz4) and {lsize / 1e6:.1f} MB "
        f"(Livox CustomMsg + Imu, lz4) made in {time.perf_counter() - t0:.1f} "
        f"s [{card}]")
    out = {}
    for name, args in (
            ("bag", ["--bag", bag]),
            ("convert+kitti", None),
            ("bag --odom-topic", ["--bag", bag, "--odom-topic", "/Odometry"]),
            ("livox bag", ["--bag", livox])):
        if args is None:
            t0 = time.perf_counter()
            conv = bag_convert.convert(bag, os.path.join(tmp, "conv"))
            log(f"cli_bag bag_convert: {conv} in "
                f"{time.perf_counter() - t0:.1f} s")
            args = ["--kitti", os.path.join(tmp, "conv")]
        report, wall, pipe = cli_run(args + [
            "--preset", "kitti", "--out", os.path.join(tmp, name)])
        poses = pio.load_poses_kitti(os.path.join(report["exported_to"],
                                                  "poses_kitti.txt"))
        # bag stamps are T_BASE + the recording's; bag_convert's start at
        # the first message (the first IMU sample)
        ate = evaluation.ate_rmse(poses, keyframe_truth(
            pipe, rec.truth, rec.stamps, -rec.imu[0, 0]
            if name == "convert+kitti" else datasets.T_BASE))
        out[name] = (report, poses)
        log(f"cli_bag {name}: {wall:.1f} s wall, {report['scans'] / wall:.2f} "
            f"scans/s, report {brief(report)}, ATE at the keyframes "
            f"{ate!r} m [{card}]")
        if report["scans"] != BAG_SCANS - (len(skip) if "odom" in name
                                           else 0) or not ate < 0.5:
            raise AssertionError(f"cli_bag {name}: {report}, ATE {ate}")
    (a, pa), (b, pb) = out["bag"], out["convert+kitti"]
    gap = float(np.abs(pa - pb).max()) if pa.shape == pb.shape else \
        float("inf")
    log(f"cli_bag: --bag vs bag_convert + --kitti: {a['keyframes']} / "
        f"{b['keyframes']} keyframes, poses within {gap:.3e} m")
    if a["keyframes"] != b["keyframes"] or not gap <= 1e-3:
        raise AssertionError("cli_bag: --bag differs from bag_convert + "
                             "--kitti")
    if out["bag --odom-topic"][0]["dropped_unmatched"] != len(skip):
        raise AssertionError(f"cli_bag: {out['bag --odom-topic'][0]}")


def dataset_phases(dev, card, errs):
    """native_runtime, then the KITTI-style dataset and cli_kitti,
    kitti_resume and cli_parity over it, then cli_bag; the files are
    deleted at the end."""
    import os
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="dataset_phases_")
    try:
        t0 = time.perf_counter()
        native_runtime(card, tmp)
        log(f"native_runtime: {time.perf_counter() - t0:.1f} s")
        d, stamps, truth = write_dataset(tmp, card)
        for name, fn in (
                ("cli_kitti", lambda: cli_kitti(dev, card, errs, d, stamps,
                                                truth, tmp)),
                ("kitti_resume", lambda: kitti_resume(d, card, tmp)),
                ("cli_parity", lambda: cli_parity(dev, card, errs, d, stamps,
                                                  truth, tmp))):
            t0 = time.perf_counter()
            fn()
            log(f"{name}: {time.perf_counter() - t0:.1f} s")
        for sub in ("kitti", "body"):
            shutil.rmtree(os.path.join(tmp, sub))
        t0 = time.perf_counter()
        cli_bag(dev, card, tmp)
        log(f"cli_bag: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# the kNN FPFH backend, the grid covariances, the long run
# ---------------------------------------------------------------------------

# K1 at k > 32 (the kNN FPFH's shared search, k = max(k_feat, k_normal) by
# default 48, and the largest the kernel takes)
BIG_K = (48, 64)
KNN_LANES = 4       # the pipeline's loop_batch
LONGRUN_SCANS = 1600


def knn_topk_library(q, qm, db, dbm, k):
    """The library yardstick of a k > 1 kNN kernel: torch.cdist, the
    masked db rows set to +inf, then torch.topk (timed, never used by the
    port; fp32, TF32 off)."""
    import torch

    _strict_fp32()
    d = torch.cdist(q, db)
    d.masked_fill_(~dbm.unsqueeze(-2), torch.inf)
    v, i = torch.topk(d, k, dim=-1, largest=False)
    return (torch.where(qm[..., None], v * v, torch.inf),
            torch.where(qm[..., None], i, -1))


def k1_pair(args, k, batched):
    """(kernel, plain version) of K1 (``batched``: K1b) at k on args."""
    from fast_lio_sam_qn_tpu_torch.ops import knn, knn_cuda

    if batched:
        return (lambda: knn_cuda.knn_batched(*args, k),
                lambda: knn_cuda.knn_batched_plain(*args, k))
    return (lambda: knn_cuda.knn(*args, k),
            lambda: knn.brute_knn(*args, k))


def knn_backend_config(optimized):
    import dataclasses

    from fast_lio_sam_qn_tpu_torch.tools import bench_pair as bp

    cfg = bp.bench_config(optimized)
    cfg.quatro = dataclasses.replace(cfg.quatro, fpfh_backend="knn")
    return cfg


def knn_fpfh(dev, card, store, drift, errs):
    """The kNN FPFH backend on the card.

    1. K1 at k = 48 and 64, F = 3, on the self-search of the bench pair's
       voxelized clouds at the bench's and the pipeline's paddings, equal
       to its plain version (d2 bits, indices, flags); K1b at k = 15, 48,
       64 on KNN_LANES jittered lanes of the pipeline-padded target, equal
       to its plain version and each lane to K1.
    2. tests/test_quatro.py's four loop pairs through ``fpfh.fpfh``,
       Quatro and GICP on the card, at that file's tolerances.
    3. ``LoopClosure`` with ``fpfh_backend="knn"`` on the bench store at
       the pipeline's caps, both matching modes, single attempts with
       every launch counter reset just before and read just after (K1 at
       k = 48 and 15 must launch, K3-K5 must not), then a batched
       registration of KNN_LANES lanes (3 candidates and a pad lane;
       K1b at k = 48 and 15 must launch, no single-cloud kernel): each
       lane within 1 mm / 1e-3 rad of the single attempt with its
       decision.  The bench gate's error is printed, not gated (the
       stream backend is the gated one).
    Returns (single-attempt launches, batched launches, timing inputs)."""
    import torch

    from fast_lio_sam_qn_tpu_torch.models.loop_closure import (
        LoopClosure, _single_frame)
    from fast_lio_sam_qn_tpu_torch.ops import fpfh, knn, knn_cuda
    from fast_lio_sam_qn_tpu_torch.tools import bench_pair as bp
    from fast_lio_sam_qn_tpu_torch.tools import loop_pairs as lp

    t0 = time.perf_counter()
    clouds = {}
    for caps in ((bp.SRC_CAP, bp.DST_CAP), (bp.PIPE_SRC_CAP,
                                            bp.PIPE_DST_CAP)):
        for tag, idx, cap in (("src", 1, caps[0]), ("dst", 0, caps[1])):
            p, m = _single_frame(store, idx, cap, 0.3)
            for k in BIG_K:
                same(f"K1 k={k} F=3 {tag}@{cap}", knn_cuda.knn(p, m, p, m, k),
                     knn.brute_knn(p, m, p, m, k))
            clouds[(tag, cap)] = (p, m)
            log(f"K1 k={'/'.join(map(str, BIG_K))} F=3 on the {tag} cloud "
                f"({int(m.sum())} of {cap} rows valid): equal to the plain "
                f"version (d2 bits, indices, flags)")
    P, M = jittered_lanes(*clouds[("dst", bp.PIPE_DST_CAP)], KNN_LANES, 5)
    for k in (15,) + BIG_K:
        got = knn_cuda.knn_batched(P, M, P, M, k)
        same(f"K1b k={k} B={KNN_LANES}", got,
             knn_cuda.knn_batched_plain(P, M, P, M, k))
        same_lanes(f"K1b k={k} B={KNN_LANES}", got,
                   lambda i: knn_cuda.knn(P[i], M[i], P[i], M[i], k))
    log(f"K1b k=15/48/64 F=3 B={KNN_LANES} at {bp.PIPE_DST_CAP} rows: equal "
        f"to the plain version, each lane to K1 ({time.perf_counter() - t0:.1f}"
        f" s)")

    for name, (drift_xi, seed, _, fine) in lp.PAIRS.items():
        t0 = time.perf_counter()
        src, dst, T_want = lp.loop_pair(drift_xi, seed, device=dev)
        e = lp.errors(lp.register(src, dst, fine=fine is not None), T_want)
        missed = lp.check(name, e)
        log(f"loop pair {name} (kNN FPFH, Quatro"
            f"{', GICP' if fine else ''} on the card): "
            f"{ {k: round(v, 5) if isinstance(v, float) else v for k, v in e.items()} }"
            f"; {int(src[1].sum())} / {int(dst[1].sum())} points; "
            f"{time.perf_counter() - t0:.2f} s")
        if missed:
            raise AssertionError(f"loop pair {name}: misses {missed}: {e}")

    reset_launches()
    runs = {}
    for label, optimized in (("optimized", True), ("advanced", False)):
        lc = LoopClosure(knn_backend_config(optimized), bp.PIPE_SRC_CAP,
                         bp.PIPE_DST_CAP)
        reg, meas = lc.fetch_and_perform(store, 1)
        torch.cuda.synchronize()
        if int(reg.closest_idx) != 0 or not bool(torch.isfinite(
                reg.pose_between).all() and torch.isfinite(meas).all()):
            raise AssertionError(f"knn attempt {label}: {reg}")
        t_err, r_err = gate_error(reg.pose_between, drift)
        log(f"knn attempt {label}@{bp.PIPE_SRC_CAP}/{bp.PIPE_DST_CAP}: "
            f"valid={bool(reg.is_valid)}, converged="
            f"{bool(reg.is_converged)}, fitness {float(reg.score):.4f}, "
            f"bench gate error {t_err * 100:.2f} cm / {r_err:.5f} rad (not "
            f"gated: the stream backend is the gated one)")
        runs[label] = (lc, reg)
    single = launches_now()
    log(f"knn attempt launches over {len(runs)} attempts: {single}")
    if not all(single[k] > 0 for k in ("knn_k48", "knn_k15", "knn",
                                       "knn_banded")) or any(
            single[k] for k in ("moments", "spfh", "agg") + BATCHED):
        raise AssertionError(f"the knn attempt's launches: {single}")

    reset_launches()
    qs, cs = [1] * KNN_LANES, [0] * (KNN_LANES - 1) + [-1]
    for label, (lc, reg) in runs.items():
        breg = lc.perform_loop_closure_batch(store, qs, cs)
        torch.cuda.synchronize()
        worst = (0.0, 0.0)
        for i in range(KNN_LANES - 1):
            if bool(breg.is_valid[i]) != bool(reg.is_valid) or bool(
                    breg.is_converged[i]) != bool(reg.is_converged):
                raise AssertionError(f"knn batch {label} lane {i}: decision "
                                     f"differs from the single attempt")
            worst = tuple(max(a, b) for a, b in zip(worst, pose_gap(
                breg.pose_between[i], reg.pose_between)))
        if worst[0] >= 1e-3 or worst[1] >= 1e-3 or bool(breg.is_valid[-1]):
            raise AssertionError(f"knn batch {label}: lanes {worst} from "
                                 f"the single attempt, pad lane valid="
                                 f"{bool(breg.is_valid[-1])}")
        log(f"knn batch {label} B={KNN_LANES}: lanes within {worst[0]:.3e} "
            f"m / {worst[1]:.3e} rad of the single attempt, same decisions")
    batched = launches_now()
    log(f"knn batched launches over {len(runs)} registrations: {batched}")
    if not all(batched[k] > 0 for k in ("knn_b_k48", "knn_b_k15", "knn_b",
                                        "knn_banded_b")) or any(
            batched[k] for k in SINGLE + ("moments_b", "spfh_b", "agg_b")):
        raise AssertionError(f"the knn batch's launches: {batched}")

    p, m = clouds[("src", bp.PIPE_SRC_CAP)]
    dp, dm = clouds[("dst", bp.PIPE_DST_CAP)]
    vp = store.poses_corrected[:2, :3, 3]
    desc_s, val_s = fpfh.fpfh(p, m, 0.9, 1.5, viewpoint=vp[1])
    desc_d, val_d = fpfh.fpfh(dp, dm, 0.9, 1.5, viewpoint=vp[0])
    return single, batched, {
        "self": (dp, dm, dp, dm), "lanes": (P, M, P, M),
        "desc": (desc_s, val_s, desc_d, val_d)}


def big_k_timings(kin, card):
    """K1 / K1b at k = 15 and 48 on the inputs ``knn_fpfh`` returns (the
    pipeline-padded target's self-search, its jittered lanes), each against
    its plain version (``time_pairs``) and the cdist + topk yardstick, with
    its bound; and K1 at k = 64, F = 33 on the kNN FPFH descriptors, logged.
    Returns (ms, library_ms, bounds) keyed as BY_K."""
    import torch

    big = {key: ("lanes" if base == "knn_b" else "self", k)
           for key, (base, k) in BY_K.items()}
    # the plain versions sort 1,024 x 32,768 chunks (0.1-0.5 s a call):
    # medians of 3
    ms = time_pairs({key: k1_pair(kin[src], k, src == "lanes")
                     for key, (src, k) in big.items()}, card, plain_reps=3)
    library, bounds = {}, {}
    for key, (src, k) in big.items():
        library[key] = cuda_ms(lambda: knn_topk_library(*kin[src], k))
        bounds[key] = knn_bound(*kin[src], k)
        log(f"time {key} library yardstick (cdist, mask, topk): "
            f"{library[key]:.4f} ms against the kernel's {ms[key][0]:.4f} ms "
            f"(call) / {kernel_ms(ms[key]):.4f} ms (device); bound "
            f"{bounds[key][0]:.5f} ms by {bounds[key][1]}; shape "
            f"{tuple(kin[src][0].shape)} [{card}]")
        torch.cuda.empty_cache()
    t64 = next(iter(time_pairs({"knn k=64 F=33 (kNN FPFH descriptors)":
                                k1_pair(kin["desc"], 64, False)},
                               card, plain_reps=3).values()))
    b64 = knn_bound(*kin["desc"], 64)
    log(f"knn k=64 F=33 {tuple(kin['desc'][0].shape)} x "
        f"{tuple(kin['desc'][2].shape)}: library (cdist, mask, topk) "
        f"{cuda_ms(lambda: knn_topk_library(*kin['desc'], 64)):.4f} ms, "
        f"kernel {t64[0]:.4f} ms (call) / {kernel_ms(t64):.4f} ms (device), "
        f"bound {b64[0]:.5f} ms by {b64[1]} [{card}]")
    torch.cuda.empty_cache()
    return ms, library, bounds


def grid_cov(dev, card):
    """The grid plane covariances (``gicp.plane_covariances(backend=
    "grid")``) of test_quatro's fine-stage pair on the card against the
    CPU: the same neighbours, equal valid masks, covariances within 1e-5
    except where the neighbourhood's two smallest eigenvalues are within
    1e-3 of its largest (an ill-defined plane normal: at most 1 % of the
    valid rows, counted); then ``gicp.align(cov_backend="grid")`` after
    the kNN Quatro stage meets that pair's 2 cm / 0.15 rad."""
    import torch

    from fast_lio_sam_qn_tpu_torch.ops import gicp, hashgrid, se3
    from fast_lio_sam_qn_tpu_torch.tools import loop_pairs as lp

    drift_xi, seed, _, _ = lp.PAIRS["then_gicp_fine"]
    src, dst, T_want = lp.loop_pair(drift_xi, seed, device=dev)
    cpu = torch.device("cpu")
    for tag, (p, m, _) in (("src", src), ("dst", dst)):
        t = gicp.grid_table_size(p.shape[0])
        found = {}
        for d in (dev, cpu):
            grid = hashgrid.build(p.to(d), m.to(d), 0.3, t)
            found[d] = hashgrid.query_knn(grid, p.to(d), m.to(d), 15, 5)
        pts, _, ok = (x.cpu() for x in found[dev])
        if not (torch.equal(ok, found[cpu][2])
                and torch.equal(pts[ok], found[cpu][0][ok])):
            raise AssertionError(f"grid_cov {tag}: the neighbours differ")
        gc, gv = gicp.plane_covariances(p, m, backend="grid")
        cc, cv = gicp.plane_covariances(p.cpu(), m.cpu(), backend="grid")
        if not torch.equal(gv.cpu(), cv):
            raise AssertionError(f"grid_cov {tag}: valid masks differ")
        w = ok.double()
        cnt = w.sum(1).clamp(min=1)
        x = pts.double()
        dev_ = (x - (x * w[..., None]).sum(1)[:, None] / cnt[:, None, None]
                ) * w[..., None]
        ev = torch.linalg.eigvalsh(torch.einsum("nki,nkj->nij", dev_, dev_))
        loose = ev[:, 1] - ev[:, 0] < 1e-3 * ev[:, 2]
        err = torch.abs(gc.cpu() - cc).reshape(-1, 9).amax(1)
        beyond = err > 1e-5
        log(f"grid_cov {tag}: {int(cv.sum())} of {int(m.sum())} points "
            f"valid on both devices, the same neighbours; max |card - CPU| "
            f"{float(err.max()):.3e}, {int(beyond.sum())} rows beyond 1e-5 "
            f"(all with an ill-defined normal: "
            f"{bool(not (beyond & ~loose).any())}); grid "
            f"{cuda_ms(lambda: gicp.plane_covariances(p, m, backend='grid')):.3f}"
            f" ms, brute (K1 k=15) "
            f"{cuda_ms(lambda: gicp.plane_covariances(p, m)):.3f} ms "
            f"[{card}]")
        if bool((beyond & ~loose).any()) or int(beyond.sum()) > 0.01 * int(
                cv.sum()):
            raise AssertionError(f"grid_cov {tag}: covariances differ")
    res = lp.register(src, dst, fine=False).coarse
    fine = gicp.align(se3.transform_points(src[0], res.transform), src[1],
                      dst[0], dst[1], cov_backend="grid")
    e = lp.errors(lp.PairResult(res, fine.transform @ res.transform,
                                fine.fitness), T_want)
    log(f"grid_cov align(cov_backend='grid') after the kNN Quatro stage: "
        f"{e['fine_t'] * 100:.3f} cm / {e['fine_r']:.5f} rad, fitness "
        f"{e['fitness']:.4f}, {fine.num_iters} iterations")
    if not (e["fine_t"] < 0.02 and e["fine_r"] < 0.15):
        raise AssertionError(f"grid_cov align: {e}")


def longrun_phase(dev, card, scans=LONGRUN_SCANS):
    """tools/longrun.py on the card: the 1,600-scan course through
    ``sim_lio_stream`` and the pipeline, every pin of
    tests/test_golden_longrun.py asserted (``longrun.check_golden``); LIO
    and feed spans (CUDA events), ms per scan, peak memory, launches."""
    import torch

    from fast_lio_sam_qn_tpu_torch.tools import longrun as lr

    cfg = lr.longrun_config()
    spans = EventSpans()
    mem = PhaseMemory(dev)
    reset_launches()
    t0 = time.perf_counter()
    feed = lr.longrun_feed(cfg, scans, prof=spans, device=dev)
    if scans == lr.N_SCANS:
        summary = lr.replay(cfg, feed, prof=spans, device=dev)
    else:   # a cut run: the capacities need not grow
        pipe, _ = lr.run_pipeline(cfg, feed, prof=spans, device=dev)
        summary = {"n_keyframes": pipe.current_kf_idx,
                   "loop_attempts": len(pipe.loop_events)}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"longrun: {scans} scans in {wall:.1f} s ({wall / scans * 1e3:.2f} "
        f"ms a scan, the simulation included), {mem}; launches "
        f"{launches_now()} [{card}]")
    log(f"longrun summary: {summary}")
    spans.report("longrun", card, skip=1)
    if scans == lr.N_SCANS:
        missed = lr.check_golden(summary)
        if missed:
            raise AssertionError(f"longrun misses {missed}: {summary}")
        log("longrun: every pin of tests/test_golden_longrun.py holds")
    return summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from fast_lio_sam_qn_tpu_torch import kernels
    from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream as fs
    from fast_lio_sam_qn_tpu_torch.ops import knn, knn_cuda
    from fast_lio_sam_qn_tpu_torch.tools import bench_pair as bp

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    path, nvcc_s = kernels.build()
    kernels.load_library()
    log(f"kernels built in {nvcc_s:.1f} s (nvcc), ready in "
        f"{time.perf_counter() - t0:.1f} s: {path.name}")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    if "--trace-fpfh-order" in sys.argv[1:]:
        trace_fpfh_order(dev)
        return 0
    log(f"kNN edge cases: {knn_edge_cases(dev)} cases equal")
    store, drift = bp.build_store(dev)
    errs = {k: 0.0 for k in launches_now()}
    inputs, nn_args, sorted_nn, desc_args = kernel_parity(
        store, bp.SRC_CAP, bp.DST_CAP, errs)
    pdesc_args = kernel_parity(store, bp.PIPE_SRC_CAP, bp.PIPE_DST_CAP,
                               errs)[3]
    batched_parity(store, bp.SRC_CAP, bp.DST_CAP, errs)
    fpfh_edge_cases(store)
    # the lanes and shapes a batched tick of the pipeline gives the kernels;
    # the timings reuse them
    clouds, bsorted = batched_parity(store, bp.PIPE_SRC_CAP, bp.PIPE_DST_CAP,
                                     errs,
                                     lanes=pipeline_config().loop.loop_batch)

    counters = launch_counters()
    reset_launches()
    runs = main_path_runs(store, drift)
    launches = launches_now()
    n_attempts = 2 * len(runs)
    log(f"attempt-path launches over {n_attempts} attempts: {launches}; "
        f"per attempt: { {k: v / n_attempts for k, v in launches.items()} }")
    if not all(launches[k] > 0 for k in ("knn", "knn_banded", "moments",
                                         "spfh", "agg")):
        raise AssertionError(f"a kernel of the attempt never launched: "
                             f"{launches}")

    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pipe, gt_kf, ate_odom, ticks, feeds = pipeline_run(dev)
    torch.cuda.synchronize()
    pipe_launches = launches_now()
    log(f"pipeline run: {PIPE_SCANS} scans in "
        f"{time.perf_counter() - t0:.1f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; "
        f"launches {pipe_launches}")
    log(f"pipeline launches per batched tick ({len(ticks)} ticks): "
        f"{ {k: pipe_launches[k] / len(ticks) for k in BATCHED} }")
    for k in BATCHED:
        launches[k] = pipe_launches[k]
    if not all(launches[k] > 0 for k in BATCHED):
        raise AssertionError(f"a batched kernel of the pipeline never "
                             f"launched: {pipe_launches}")
    multi = check_pipeline(pipe, gt_kf, ate_odom, ticks)
    lane_vs_single(pipe, multi[-1])

    p, m, _, srt = inputs["src"]
    sp, sm_, sn, sv = (x[0] for x in srt[:4])
    spn = srt.spn[0]
    ms = time_pairs({
        "knn": (lambda: knn_cuda.knn(*desc_args, 1),
                lambda: knn.brute_knn(*desc_args, 1)),
        "knn_banded": (lambda: knn_cuda.knn_banded(*sorted_nn, 1),
                       lambda: knn_cuda.knn_banded_plain(*sorted_nn, 1)),
        "moments": (lambda: fs.moments(sp, sm_, 0.9, 0.6),
                    lambda: fs.moments_plain(sp, sm_, 0.9, 0.6)),
        "spfh": (lambda: fs.spfh(sp, sm_, sn, sv, 1.5),
                 lambda: fs.spfh_plain(sp, sm_, sn, sv, 1.5)),
        "agg": (lambda: fs.fpfh_agg(sp, sm_, sv, spn, 1.5),
                lambda: fs.fpfh_agg_plain(sp, sm_, sv, spn, 1.5)),
    }, card)
    extra = time_pairs({
        f"knn k=1 F=33 {bp.PIPE_SRC_CAP}x{bp.PIPE_DST_CAP}": (
            lambda: knn_cuda.knn(*pdesc_args, 1),
            lambda: knn.brute_knn(*pdesc_args, 1)),
        f"knn k=1 F=3 {bp.SRC_CAP}x{bp.DST_CAP} (GICP NN)": (
            lambda: knn_cuda.knn(*nn_args, 1),
            lambda: knn.brute_knn(*nn_args, 1)),
        "knn k=1 F=3 on K2's sorted GICP clouds": (
            lambda: knn_cuda.knn(*sorted_nn, 1),
            lambda: knn.brute_knn(*sorted_nn, 1)),
        "moments on the caller's rows": (
            lambda: fs.moments(p, m, 0.9, 0.6),
            lambda: fs.moments_plain(p, m, 0.9, 0.6))}, card)
    k33 = extra[f"knn k=1 F=33 {bp.PIPE_SRC_CAP}x{bp.PIPE_DST_CAP}"]
    log(f"time knn k=1 F=33 {bp.PIPE_SRC_CAP}x{bp.PIPE_DST_CAP} library "
        f"yardstick (cdist, mask, min): "
        f"{cuda_ms(lambda: knn_library(*pdesc_args)):.4f} ms against the "
        f"kernel's {k33[0]:.4f} ms (call) / {kernel_ms(k33):.4f} ms (device) "
        f"[{card}]")
    P, _, bsrt, bdesc, bval = clouds["src"]
    D, DM = clouds["dst"][:2]
    ddesc, dval = clouds["dst"][3:]
    bfp = tuple(bsrt[:4])
    ms.update(time_pairs({
        "knn_b": (lambda: knn_cuda.knn_batched(bdesc, bval, ddesc, dval, 1),
                  lambda: knn_cuda.knn_batched_plain(bdesc, bval, ddesc,
                                                     dval, 1)),
        "knn_banded_b": (
            lambda: knn_cuda.knn_banded_batched(*bsorted, 1),
            lambda: knn_cuda.knn_banded_batched_plain(*bsorted, 1)),
        "moments_b": (
            lambda: fs.moments_batched(bsrt.p, bsrt.m, 0.9, 0.6),
            lambda: fs.moments_batched_plain(bsrt.p, bsrt.m, 0.9, 0.6)),
        "spfh_b": (lambda: fs.spfh_batched(*bfp, 1.5),
                   lambda: fs.spfh_batched_plain(*bfp, 1.5)),
        "agg_b": (lambda: fs.fpfh_agg_batched(bsrt.p, bsrt.m, bsrt.v,
                                              bsrt.spn, 1.5),
                  lambda: fs.fpfh_agg_batched_plain(bsrt.p, bsrt.m, bsrt.v,
                                                    bsrt.spn, 1.5)),
    }, card))
    log(f"batched kernel shapes: B={P.shape[0]}; K1 F=33 "
        f"{P.shape[1]}x{D.shape[1]}; K2 F=3 sorted {P.shape[1]}x"
        f"{D.shape[1]}; K3-K5 {P.shape[1]} rows, Morton-sorted")

    knn_in = {"knn": desc_args, "knn_banded": sorted_nn,
              "knn_b": (bdesc, bval, ddesc, dval), "knn_banded_b": bsorted}
    library = {k: None for k in launches_now()}
    for key, args in knn_in.items():
        library[key] = cuda_ms(lambda: knn_library(*args))
        log(f"time {key} library yardstick (cdist, mask, min): "
            f"{library[key]:.4f} ms against the kernel's {ms[key][0]:.4f} ms "
            f"(call) / {kernel_ms(ms[key]):.4f} ms (device) [{card}]")
    fpfh_in = {
        "moments": (moments_library, (sp, sm_), "cdist, radius masks, W @ "
                    "features", lambda: fs.moments(sp, sm_, 0.9, 0.6), sm_),
        "agg": (agg_library, (sp, sm_, sv, spn), "cdist, masks, rsqrt(d2) @ "
                "SPFH", lambda: fs.fpfh_agg(sp, sm_, sv, spn, 1.5), sm_),
        "moments_b": (moments_library, (bsrt.p, bsrt.m), "cdist, radius "
                      "masks, W @ features", lambda: fs.moments_batched(
                          bsrt.p, bsrt.m, 0.9, 0.6), bsrt.m),
        "agg_b": (agg_library, (bsrt.p, bsrt.m, bsrt.v, bsrt.spn), "cdist, "
                  "masks, rsqrt(d2) @ SPFH", lambda: fs.fpfh_agg_batched(
                      bsrt.p, bsrt.m, bsrt.v, bsrt.spn, 1.5), bsrt.m)}
    for key, (fn, args, what, kern, qm) in fpfh_in.items():
        diff = torch.abs(fn(*args) - kern())[qm]
        library[key] = cuda_ms(lambda: fn(*args))
        log(f"time {key} library yardstick ({what}, fp32): "
            f"{library[key]:.4f} ms against the kernel's {ms[key][0]:.4f} ms "
            f"(call) / {kernel_ms(ms[key]):.4f} ms (device); largest "
            f"|yardstick - kernel| on valid rows {float(diff.max()):.3e} "
            f"[{card}]")
        del diff
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    bkeep = [knn_cuda.block_tile_keep(*(a[i] for a in bsorted), 1)
             for i in range(bsorted[0].shape[0])]
    keep = sm_ & sv
    bkeep_fp = bsrt.m & bsrt.v
    # K3-K5 skip the pairs the radius prune rules out: their bound counts
    # the in-radius pairs' math only (the all-pairs figure, with 9 flops of
    # distance test per valid pair, beside it in the log)
    all_pairs = {
        "moments": radius_bound(sp, sm_, sm_, (0.9, 0.6), 9, (16, 10), 13,
                                80),
        "moments_b": radius_bound(bsrt.p, bsrt.m, bsrt.m, (0.9, 0.6), 9,
                                  (16, 10), 13, 80),
        "spfh": radius_bound(sp, sm_, keep, (1.5,), 9, (75,), 26, 136),
        "agg": radius_bound(sp, sm_, keep, (1.5,), 9, (68,), 146, 136),
        "spfh_b": radius_bound(bsrt.p, bsrt.m, bkeep_fp, (1.5,), 9, (75,),
                               26, 136),
        "agg_b": radius_bound(bsrt.p, bsrt.m, bkeep_fp, (1.5,), 9, (68,),
                              146, 136)}
    bounds = {
        "knn": knn_bound(*desc_args, 1),
        "knn_banded": knn_bound(*sorted_nn, 1, keep=knn_cuda.block_tile_keep(
            *sorted_nn, 1)),
        "moments": radius_bound(sp, sm_, sm_, (0.9, 0.6), 0, (16, 10), 13,
                                80),
        "spfh": radius_bound(sp, sm_, keep, (1.5,), 0, (75,), 26, 136),
        "agg": radius_bound(sp, sm_, keep, (1.5,), 0, (68,), 146, 136),
        "knn_b": knn_bound(bdesc, bval, ddesc, dval, 1),
        "knn_banded_b": knn_bound(*bsorted, 1, keep=bkeep),
        "moments_b": radius_bound(bsrt.p, bsrt.m, bsrt.m, (0.9, 0.6), 0,
                                  (16, 10), 13, 80),
        "spfh_b": radius_bound(bsrt.p, bsrt.m, bkeep_fp, (1.5,), 0, (75,),
                               26, 136),
        "agg_b": radius_bound(bsrt.p, bsrt.m, bkeep_fp, (1.5,), 0, (68,),
                              146, 136),
    }
    for key, (b_ms, by) in bounds.items():
        old = (f"; all pairs {all_pairs[key][0]:.5f} ms by "
               f"{all_pairs[key][1]}" if key in all_pairs else "")
        log(f"bound {key}: {b_ms:.5f} ms by {by}{old}; kernel "
            f"{kernel_ms(ms[key]):.4f} ms (the bound is "
            f"{b_ms / kernel_ms(ms[key]):.3f} of it)")
    log(f"keep rule: of the (block, tile) pairs below the extents, K3 "
        f"(0.9 m over mask) keeps {srt.share3:.4f} on the bench source and "
        f"{bsrt.share3:.4f} on the B={P.shape[0]} lanes at the pipeline "
        f"padding; K4 / K5 (1.5 m over mask & n_valid) {srt.share:.4f} and "
        f"{bsrt.share:.4f}")
    for label, lc in runs.items():
        t = cuda_ms(lambda: lc.fetch_and_perform(store, 1))
        log(f"time attempt {label}: {t:.3f} ms per fetch_and_perform "
            f"[{card}]")
    pipeline_timings(pipe, multi, feeds, card)

    t0 = time.perf_counter()
    k_single, k_batched, kin = knn_fpfh(dev, card, store, drift, errs)
    for key, (base, _) in BY_K.items():
        launches[key] = (k_batched if base == "knn_b" else k_single)[key]
    big_ms, big_lib, big_bounds = big_k_timings(kin, card)
    ms.update(big_ms)
    library.update(big_lib)
    bounds.update(big_bounds)
    log(f"knn_fpfh: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    grid_cov(dev, card)
    log(f"grid_cov: {time.perf_counter() - t0:.1f} s")

    lio_golden(dev, card)
    lio_kitti(dev, card)
    lio_card_vs_cpu(dev)
    lio_repeat(dev, card)
    lio_point(dev, card)
    lio_extrinsic(dev, card)
    cli_sim(dev, card, errs)
    dataset_phases(dev, card, errs)
    t0 = time.perf_counter()
    longrun_phase(dev, card)
    log(f"longrun: {time.perf_counter() - t0:.1f} s")

    knn_src = "fast_lio_sam_qn_tpu/ops/pallas_knn.py"
    fs_src = "fast_lio_sam_qn_tpu/ops/fpfh_stream.py"
    table = [
        ("knn", "knn.cu", f"{knn_src}:67", "knn"),
        ("knn_banded", "knn_banded.cu", f"{knn_src}:293", "knn_banded"),
        ("fpfh_moments", "fpfh_moments.cu", f"{fs_src}:96", "moments"),
        ("fpfh_spfh", "fpfh_spfh.cu", f"{fs_src}:224", "spfh"),
        ("fpfh_agg", "fpfh_agg.cu", f"{fs_src}:260", "agg"),
        ("knn_batched", "knn.cu", f"{knn_src}:185 (vmapped)", "knn_b"),
        ("knn_k15", "knn.cu", f"{knn_src}:67 (k = 15)", "knn_k15"),
        ("knn_k48", "knn.cu", f"{knn_src}:67 (k = 48)", "knn_k48"),
        ("knn_batched_k15", "knn.cu", f"{knn_src}:185 (vmapped, k = 15)",
         "knn_b_k15"),
        ("knn_batched_k48", "knn.cu", f"{knn_src}:185 (vmapped, k = 48)",
         "knn_b_k48"),
        ("knn_banded_batched", "knn_banded.cu", f"{knn_src}:469",
         "knn_banded_b"),
        ("fpfh_moments_batched", "fpfh_moments.cu", f"{fs_src}:419",
         "moments_b"),
        ("fpfh_spfh_batched", "fpfh_spfh.cu", f"{fs_src}:419", "spfh_b"),
        ("fpfh_agg_batched", "fpfh_agg.cu", f"{fs_src}:419", "agg_b"),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"{REPO}/csrc/{src}",
         "replaces": rep, "launches": launches[key],
         "max_abs_err": errs[key], "ms": kernel_ms(ms[key]),
         "plain_ms": ms[key][1],
         "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
         "library_ms": library[key]}
        for name, src, rep, key in table]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
