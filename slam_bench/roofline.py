"""Least times of the work the per-layer roofline metrics read, on one
NVIDIA H100: copied from the port's ``tools/roofline.py`` so that later
changes to the program do not move the yardstick
(``tests/test_slam_bench_roofline.py`` holds the copy to the original).

A least time is the larger of two: the work's fp32 operations at the
published 67 TFLOP/s, and its bytes at 3.35 TB/s (H100 SXM; no tensor
cores, as the port keeps strict fp32).  The work is counted from the
inputs, whatever implements it: for the surfel insert
(``insert_budget``), the census of its table-scale gathers, scatters,
sorts and passes at a scan's static sizes.
"""
from __future__ import annotations

# the H100 SXM's published peaks: fp32 outside the tensor cores, and HBM3
FP32_FLOPS, HBM_BYTES_S = 67e12, 3.35e12

# the surfel insert's hash probes (ops/hashgrid.py NUM_PROBES), and the
# plane fit's traced ops and bytes a row with its eigensolve one K6 launch
# (tools/roofline.py _plane_fit_ops)
NUM_PROBES = 4
FIT_OPS, FIT_ROW_BYTES = 21, 504


def bound(flops, nbytes):
    """(ms, by): the larger of the operations over the fp32 peak and the
    bytes over the HBM rate."""
    t_ops = float(flops) / FP32_FLOPS * 1e3
    t_bytes = float(nbytes) / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# the surfel insert's census (tools/roofline.py insert_budget)
# ---------------------------------------------------------------------------

def _gather(rows, row_bytes):
    """Bytes of a gather (or scatter) of ``rows`` table rows: the rows
    read, their int64 indices, the rows written."""
    return rows * (2 * row_bytes + 8)


def _claim_rows(label, n, t, probes):
    """The rows of the insert's claim for a batch of n rows on a table of
    t slots: (stage, ops, rows, bytes)."""
    return [
        (f"{label} rounds", 8 * probes, probes * (5 * t + 3 * n),
         probes * (8 * t + _gather(n, 8) + 2 * t + 9 * t + 3 * t
                   + _gather(n, 8) + _gather(n, 1) + 3 * t)),
        (f"{label} winners and key", 8, 7 * t + n,
         16 * t + _gather(n, 8) + 9 * t + 17 * t + _gather(t, 12) + 37 * t
         + 5 * t + 32 * t),
        (f"{label} neighbour hints", 5, 6 * probes * n + 2 * t + 7 * n,
         _gather(6 * probes * n, 16) + 2 * 48 * t + _gather(n, 24)
         + _gather(6 * n, 4)),
        (f"{label} relocate", 1, probes * n, _gather(probes * n, 16)),
    ]


def insert_budget(n, t, hood_cap, halo_cap, window, probes=NUM_PROBES):
    """Census of one surfel insert at steady state: n points on a table of
    t slots, ``hood_cap`` hood refits over a ``window``-voxel hood,
    ``halo_cap`` halo sources.  Rows of (stage, ops, rows, bytes); returns
    {rows, table_ops, bytes, hbm_bound_ms}."""
    p, w = probes, window
    h, c = min(hood_cap, n), min(halo_cap, n)
    rows = [("locate", 1, n * p, _gather(n * p, 16))]
    rows += _claim_rows("claim", n, t, p)
    rows += [
        ("moment sums (ordered segments)", 7, 5 * n + 3 * t,
         _gather(n, 4) + 16 * n + 8 * t + _gather(n, 8) + _gather(n, 40)
         + 40 * n + 48 * t + 120 * t),
        ("refit own gathers and write", 5, 4 * n + t,
         _gather(n, 40) + _gather(n, 12) + _gather(n, 24) + 48 * t
         + _gather(n, 24)),
        ("refit own plane fit (Jacobi)", FIT_OPS, n, FIT_ROW_BYTES * n),
        ("refit hood compaction", 1, n, 12 * n),
        (f"refit hood{w} gathers", 4, 2 * h + h * w + h * w * p,
         _gather(h, 16) + _gather(h * w * p, 16) + _gather(h * w, 40)
         + _gather(h, 24)),
        ("refit hood plane fit (Jacobi)", FIT_OPS, h, FIT_ROW_BYTES * h),
        ("refit hood write", 2, t + h, 48 * t + _gather(h, 24)),
        ("halo sources", 5, 2 * n + 2 * c + t,
         _gather(n, 24) + 12 * n + _gather(c, 24) + 48 * t
         + _gather(c, 24)),
        ("halo fan hint lookup", 2, 7 * c,
         _gather(c, 24) + _gather(6 * c, 16)),
    ]
    rows += _claim_rows("halo claim", 6 * c, t, p)
    rows.append(("halo plane write", 9, 6 * 6 * c + 3 * t,
                 _gather(6 * c, 4) + 4 * t + _gather(6 * c, 4)
                 + _gather(6 * c, 4) + 8 * t + _gather(6 * c, 8)
                 + _gather(6 * c, 8) + 48 * t + _gather(6 * c, 24)))
    rows = [dict(stage=s, ops=o, rows=r, bytes=b) for s, o, r, b in rows]
    total = sum(r["bytes"] for r in rows)
    return dict(rows=rows, table_ops=sum(r["ops"] for r in rows),
                bytes=total, hbm_bound_ms=total / HBM_BYTES_S * 1e3)
