"""Drive the PyTorch port's loop-closure attempt on one CUDA card.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card: a CUDA device is required (there is no CPU fallback); prints
   ``nvidia-smi``'s name and power limit;
2. builds the hand-written CUDA kernels from ``fast_lio_sam_qn_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the main path, on the benchmark's voxelized clouds at the
   benchmark's capacities and at the pipeline's; K2 must also equal K1 bit
   for bit on the Morton-sorted clouds;
4. drives the main path, ``LoopClosure(cfg, src_cap, dst_cap)
   .fetch_and_perform(store, 1)`` on a two-keyframe store, in both matching
   modes and at the pipeline's capacities, with every launch counter reset
   just before and read just after; each run must find keyframe 0, converge,
   pass the ground-truth gate (< 6 cm, < 0.01 rad) and repeat bit-identically;
5. times every kernel and its plain version, and one whole attempt per
   mode, with CUDA events (median of 10 calls);
6. prints the kernel table as one JSON line, then the result line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

GATE_T, GATE_R = 0.06, 0.01
REPO = "fast_lio_sam_qn_tpu_torch"


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


def kernel_parity(store, src_cap, dst_cap, errs):
    """Every kernel against its plain version on the voxelized clouds
    padded to (src_cap, dst_cap); K2 also against K1, bit for bit.
    Returns the inputs the timing phase reuses."""
    import torch

    from fast_lio_sam_qn_tpu_torch.models.loop_closure import _single_frame
    from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream as fs
    from fast_lio_sam_qn_tpu_torch.ops import knn, knn_cuda, se3
    from fast_lio_sam_qn_tpu_torch.parity import (radius_boundary_rows,
                                                  spfh_rows_explained)

    caps = f"@{src_cap}/{dst_cap}"
    src, sm = _single_frame(store, 1, src_cap, 0.3)
    dst, dm = _single_frame(store, 0, dst_cap, 0.3)
    inputs = {}
    for tag, p, m, vp in (("src", src, sm, store.poses_corrected[1][:3, 3]),
                          ("dst", dst, dm, store.poses_corrected[0][:3, 3])):
        mom_k = fs.moments(p, m, 0.9, 0.6)
        mom_p = fs.moments_plain(p, m, 0.9, 0.6)
        errs["moments"] = max(errs["moments"], check_rows(
            f"K3 moments {tag}{caps}", mom_k, mom_p, 1e-3, 1e-5,
            lambda r: radius_boundary_rows(p, m, r, (0.9, 0.6))))
        nrm, nv, _, _ = fs.moments_to_normals_covs(mom_p, p, m, vp)
        keep = m & nv
        sp_k = fs.spfh(p, m, nrm, nv, 1.5)
        sp_p = fs.spfh_plain(p, m, nrm, nv, 1.5)
        errs["spfh"] = max(errs["spfh"], check_rows(
            f"K4 spfh {tag}{caps}", sp_k, sp_p, 1e-3, 0.0,
            lambda r: spfh_rows_explained(sp_k, sp_p, p, nrm, keep, r, 1.5)))
        spfh_n = (sp_p[:, :33] / torch.clamp(sp_p[:, 33:], min=1.0)
                  ).contiguous()
        ag_k = fs.fpfh_agg(p, m, nv, spfh_n, 1.5)
        ag_p = fs.fpfh_agg_plain(p, m, nv, spfh_n, 1.5)
        errs["agg"] = max(errs["agg"], check_rows(
            f"K5 aggregation {tag}{caps}", ag_k, ag_p, 1e-2, 1e-4,
            lambda r: radius_boundary_rows(p, keep, r, (1.5,))))
        inputs[tag] = (p, m, nrm, nv, spfh_n, vp)

    desc_s, val_s, _ = fs.fpfh_radius(src, sm, 0.9, 1.5,
                                      viewpoint=inputs["src"][5])
    desc_d, val_d, _ = fs.fpfh_radius(dst, dm, 0.9, 1.5,
                                      viewpoint=inputs["dst"][5])
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


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def gate(reg, drift, label):
    import torch

    from fast_lio_sam_qn_tpu_torch.ops import se3

    T = reg.pose_between
    if T.shape != (4, 4) or not bool(torch.isfinite(T).all()):
        raise AssertionError(f"{label}: non-finite or misshapen transform")
    if int(reg.closest_idx) != 0:
        raise AssertionError(f"{label}: closest_idx {int(reg.closest_idx)}")
    if not bool(reg.is_converged):
        raise AssertionError(f"{label}: did not converge")
    err = se3.se3_log(T.double().cpu() @ torch.tensor(drift))
    t_err = float(torch.linalg.norm(err[3:]))
    r_err = float(torch.linalg.norm(err[:3]))
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

    store, drift = bp.build_store(dev)
    errs = {"knn": 0.0, "knn_banded": 0.0, "moments": 0.0, "spfh": 0.0,
            "agg": 0.0}
    inputs, nn_args, sorted_nn, desc_args = kernel_parity(
        store, bp.SRC_CAP, bp.DST_CAP, errs)
    kernel_parity(store, bp.PIPE_SRC_CAP, bp.PIPE_DST_CAP, errs)

    counters = {"knn": knn_cuda.knn, "knn_banded": knn_cuda.knn_banded,
                "moments": fs.moments, "spfh": fs.spfh, "agg": fs.fpfh_agg}
    for c in counters.values():
        c.launches = 0
    runs = main_path_runs(store, drift)
    launches = {k: c.launches for k, c in counters.items()}
    log(f"main-path launches: {launches}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")

    p, m, nrm, nv, spfh_n, _ = inputs["src"]
    timed = {
        "knn": (lambda: knn_cuda.knn(*nn_args, 1),
                lambda: knn.brute_knn(*nn_args, 1)),
        "knn_banded": (lambda: knn_cuda.knn_banded(*sorted_nn, 1),
                       lambda: knn_cuda.knn_banded_plain(*sorted_nn, 1)),
        "moments": (lambda: fs.moments(p, m, 0.9, 0.6),
                    lambda: fs.moments_plain(p, m, 0.9, 0.6)),
        "spfh": (lambda: fs.spfh(p, m, nrm, nv, 1.5),
                 lambda: fs.spfh_plain(p, m, nrm, nv, 1.5)),
        "agg": (lambda: fs.fpfh_agg(p, m, nv, spfh_n, 1.5),
                lambda: fs.fpfh_agg_plain(p, m, nv, spfh_n, 1.5)),
    }
    ms = {}
    for name, (kern, plain) in timed.items():
        # plain, kernel, kernel, plain: one card, one call, in turns
        a = cuda_ms(plain)
        b = cuda_ms(kern)
        c = cuda_ms(kern)
        d = cuda_ms(plain)
        ms[name] = (min(b, c), min(a, d))
        log(f"time {name}: kernel {b:.4f} / {c:.4f} ms, plain {a:.4f} / "
            f"{d:.4f} ms [{card}]")
    k1s = cuda_ms(lambda: knn_cuda.knn(*sorted_nn, 1))
    log(f"time knn (K1) on K2's sorted GICP clouds: {k1s:.4f} ms [{card}]")
    k33 = cuda_ms(lambda: knn_cuda.knn(*desc_args, 1))
    k33p = cuda_ms(lambda: knn.brute_knn(*desc_args, 1))
    log(f"time knn k=1 F=33 {bp.SRC_CAP}x{bp.DST_CAP}: kernel {k33:.4f} ms, "
        f"plain {k33p:.4f} ms [{card}]")
    for label, lc in runs.items():
        t = cuda_ms(lambda: lc.fetch_and_perform(store, 1))
        log(f"time attempt {label}: {t:.3f} ms per fetch_and_perform "
            f"[{card}]")

    table = [
        ("knn", "knn.cu", "fast_lio_sam_qn_tpu/ops/pallas_knn.py:67",
         "knn"),
        ("knn_banded", "knn_banded.cu",
         "fast_lio_sam_qn_tpu/ops/pallas_knn.py:293", "knn_banded"),
        ("fpfh_moments", "fpfh_moments.cu",
         "fast_lio_sam_qn_tpu/ops/fpfh_stream.py:96", "moments"),
        ("fpfh_spfh", "fpfh_spfh.cu",
         "fast_lio_sam_qn_tpu/ops/fpfh_stream.py:224", "spfh"),
        ("fpfh_agg", "fpfh_agg.cu",
         "fast_lio_sam_qn_tpu/ops/fpfh_stream.py:260", "agg"),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"{REPO}/csrc/{src}",
         "replaces": rep, "launches": launches[key],
         "max_abs_err": errs[key], "ms": ms[key][0], "plain_ms": ms[key][1]}
        for name, src, rep, key in table]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
