"""K1 / K1b at 1 < k <= 64 on the kNN FPFH backend's shapes, for the
package of one checkout, through that checkout's own ``chip_smoke.py``.

Usage (on a machine with a CUDA card):

    python3 fast_lio_sam_qn_tpu_torch/tools/profile_knn.py [--tree DIR] \\
        [--out FILE]

Puts the checkout ``DIR`` (default: the one that holds this script) first
on the import path, builds its kernels and runs its ``chip_smoke.py``'s
``knn_fpfh`` (the kNN backend's checks on the card, which also make the
inputs) and ``big_k_timings`` (K1 at k = 15 / 48 on the benchmark target
voxelized into the pipeline's 32,768 rows, its self-search; K1b at k = 15 /
48 on 4 jittered lanes of it; K1 at k = 64, F = 33 on the kNN FPFH
descriptors; call and device ms against the plain version, the bound and
``cdist`` + ``topk``).  Adds, for each case, a digest of the kernel's
outputs, so that two checkouts that compute the same bits print the same
digests, and the flushes a query that the k > 1 kernel's walk makes,
counted by its numpy model (``warp_select``) on up to FLUSH_SAMPLE queries.
Run it for the parent and the change in turns in one session to compare
them on one card.  Prints the card, then one JSON line (also appended to
FILE when given).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

FLUSH_SAMPLE = 128   # queries a case whose flushes the model counts


def _digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# The k > 1 kernel's selection as a numpy model, step for step csrc/knn.cu
# knnk_warp_kernel over csrc/knn_tile.cuh sel_*: one warp a query, lanes
# striding over db tiles, a queue of SEL_Q a lane, bitonic sort and merge
# with the same lane and register layout.  main() counts its flushes;
# tests/test_torch_knn.py holds the algorithm to brute_knn bit for bit.
# Nothing ties this copy to the CUDA source: chip_smoke.py's kNN edge
# cases are the kernel's own check
# ---------------------------------------------------------------------------

SEL_Q = 4                 # knn_tile.cuh kSelQ
SEL_IDLE = 2 ** 31 - 1    # knn_tile.cuh kSelIdle
LANE = np.arange(32)


def sel_rows(f: int) -> int:
    """db rows per tile, knn.cu sel_rows."""
    return 1024 if f == 3 else 256 if f == 33 else 128


def _lex_less(da, ia, db, ib):
    return (da < db) | ((da == db) & (ia < ib))


def _sel_steps(d, i, size, stride):
    """sel_steps: bitonic steps of stride .. 1 in blocks of ``size`` over
    (R, 32) registers x lanes, element e = 32 r + lane; a block whose first
    element has bit ``size`` set runs descending."""
    while stride >= 1:
        for r in range(d.shape[0]):
            if stride >= 32:
                p = r ^ (stride >> 5)
                if p > r:
                    swap = _lex_less(d[p], i[p], d[r], i[r]) != bool(
                        (r << 5) & size)
                    d[[r, p]] = np.where(swap, d[[p, r]], d[[r, p]])
                    i[[r, p]] = np.where(swap, i[[p, r]], i[[r, p]])
            else:
                od, oi = d[r][LANE ^ stride], i[r][LANE ^ stride]
                descending = (((r << 5) | LANE) & size) != 0
                keep_min = ((LANE & stride) == 0) != descending
                take = _lex_less(od, oi, d[r], i[r]) == keep_min
                d[r] = np.where(take, od, d[r])
                i[r] = np.where(take, oi, i[r])
        stride //= 2


def _sel_merge(ld, li, qd, qi):
    """sel_merge: sort the queue, take the list's minimum against the
    reversed queue, bitonic-merge the list."""
    kl = ld.shape[0]
    size = 2
    while size <= 32 * qd.shape[0]:
        _sel_steps(qd, qi, size, size // 2)
        size *= 2
    for r in range(kl):
        od, oi = qd[kl - 1 - r][31 - LANE], qi[kl - 1 - r][31 - LANE]
        take = _lex_less(od, oi, ld[r], li[r])
        ld[r] = np.where(take, od, ld[r])
        li[r] = np.where(take, oi, li[r])
    _sel_steps(ld, li, 32 * kl, 16 * kl)


def warp_select(d2, dend: int, k: int, rows: int):
    """One query's (d2 (k,), idx (k,)) from its float32 d2 against every db
    row (inf where masked), walked as knnk_warp_kernel walks it, and the
    number of flushes that walk makes."""
    kl = 1 if k <= 32 else 2
    ld = np.full((kl, 32), np.inf, np.float32)
    li = np.full((kl, 32), SEL_IDLE, np.int64)
    qd = np.full((SEL_Q, 32), np.inf, np.float32)
    qi = np.full((SEL_Q, 32), SEL_IDLE, np.int64)
    queued = np.zeros(32, np.int64)
    state = {"kd": np.float32(np.inf), "ki": SEL_IDLE, "flushes": 0}

    def flush():
        _sel_merge(ld, li, qd, qi)
        qd[:], qi[:], queued[:] = np.inf, SEL_IDLE, 0
        state["kd"], state["ki"] = ld[(k - 1) >> 5, (k - 1) & 31], li[
            (k - 1) >> 5, (k - 1) & 31]
        state["flushes"] += 1

    for base in range(0, dend, rows):
        for s in range(-(-min(rows, dend - base) // 32)):
            idx = base + 32 * s + LANE
            d = np.where(idx < dend, d2[np.minimum(idx, len(d2) - 1)],
                         np.float32(np.inf))
            ok = (d < np.inf) & _lex_less(d, idx, state["kd"], state["ki"])
            qd[1:, ok], qi[1:, ok] = qd[:-1, ok], qi[:-1, ok]
            qd[0, ok], qi[0, ok] = d[ok], idx[ok]
            queued += ok
            if (queued == SEL_Q).any():
                flush()
    if (queued > 0).any():
        flush()
    d_out = ld.reshape(-1)[:k]
    i_out = li.reshape(-1)[:k]
    ok = d_out < np.inf
    return (np.where(ok, d_out, np.float32(np.inf)), np.where(ok, i_out, -1),
            state["flushes"])


def model_flushes(q, qm, db, dm, k: int, dist2) -> float:
    """Mean flushes a query that ``warp_select`` makes over up to
    FLUSH_SAMPLE valid queries, evenly spread, of the first lane; ``dist2``
    gives the (m, n) squared distances (ops/knn.py _dist2_tile)."""
    import torch

    if q.dim() == 3:
        q, qm, db, dm = q[0], qm[0], db[0], dm[0]
    rows = torch.nonzero(qm).flatten()
    rows = rows[::max(1, -(-len(rows) // FLUSH_SAMPLE))]
    d2 = torch.where(dm[None, :], dist2(q[rows], db), torch.inf)
    d2 = d2.float().cpu().numpy()
    dend = int(torch.nonzero(dm).max()) + 1 if bool(dm.any()) else 0
    rows_per_tile = sel_rows(q.shape[-1])
    return float(np.mean([warp_select(r, dend, k, rows_per_tile)[2]
                          for r in d2]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    ap.add_argument("--out")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("profile_knn: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from fast_lio_sam_qn_tpu_torch import kernels
    from fast_lio_sam_qn_tpu_torch.ops import knn, knn_cuda
    from fast_lio_sam_qn_tpu_torch.tools import bench_pair as bp

    card = cs.card_line()
    _, nvcc_s = kernels.build()
    kernels.load_library()
    print(f"package {os.path.dirname(os.path.dirname(knn_cuda.__file__))}, "
          f"chip_smoke {cs.__file__}; kernels built in {nvcc_s:.1f} s",
          flush=True)
    dev = torch.device("cuda", 0)
    store, drift = bp.build_store(dev)
    errs = {k: 0.0 for k in cs.launches_now()}
    kin = cs.knn_fpfh(dev, card, store, drift, errs)[2]
    ms, library, bounds = cs.big_k_timings(kin, card)
    cases = {key: ("lanes" if base == "knn_b" else "self", k)
             for key, (base, k) in cs.BY_K.items()}
    cases["knn_k64_f33"] = ("desc", 64)
    result = {"card": card, "tree": tree, "cases": {}}
    for key, (src, k) in cases.items():
        a = kin[src]
        fn = knn_cuda.knn_batched if src == "lanes" else knn_cuda.knn
        row = {"shape": [list(a[0].shape), list(a[2].shape)], "k": k,
               "valid_queries": int(a[1].sum()),
               "digest": _digest(fn(*a, k)[:2]),
               "model_flushes": model_flushes(*a, k, knn._dist2_tile)}
        if key in ms:
            row.update(call_ms=ms[key][0], plain_ms=ms[key][1],
                       device_ms=ms[key][2], library_ms=library[key],
                       bound_ms=bounds[key][0])
        result["cases"][key] = row
        print(f"{key}: digest {row['digest']}, {row['model_flushes']:.2f} "
              f"flushes a query (model)", flush=True)
        torch.cuda.empty_cache()
    print(card)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
