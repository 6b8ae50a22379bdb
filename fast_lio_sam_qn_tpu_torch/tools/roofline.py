"""Least times of the port's kernels on one NVIDIA H100: the counterpart
of the JAX package's ``tools/roofline.py``, with the H100's fp32 and HBM
peaks in place of the TPU v5e's rates (which this module does not carry).

A bound is the larger of two times for the same work: the operations the
kernel does on this run's data over the fp32 peak, and the bytes it must
move (each valid input row read once, each output row written once) over
the HBM rate.  Where the work depends on the data (K2's kept (block,
tile) pairs, the FPFH kernels' in-radius pairs) the count is this run's.
``chip_smoke.py`` computes its kernel table's ``bound_ms`` with these.
"""
from __future__ import annotations

import torch

from ..ops import knn_cuda

# the H100 SXM's published peaks: fp32 outside
# the tensor cores, and HBM3
FP32_FLOPS, HBM_BYTES_S = 67e12, 3.35e12


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of the operations over the fp32
    peak and the bytes over the HBM rate."""
    t_ops = float(flops) / FP32_FLOPS * 1e3
    t_bytes = float(nbytes) / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def per_run(mask, rows):
    """Valid rows in each run of ``rows`` consecutive rows (float64)."""
    pad = torch.nn.functional.pad(mask.double(), (0, -mask.shape[0] % rows))
    return pad.view(-1, rows).sum(-1)


def knn_bound(q, qm, db, dbm, k, keep=None):
    """A kNN kernel's bound over this run's data: 2F + 2 flops (the cross
    term's F products and the d2 expansion) for each (valid query, valid db
    row) pair, or for each pair of a kept (block, tile) for K2 (``keep``,
    one bitmap per lane); each valid row's F + 1 floats and mask byte read
    once, every output row written once."""
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
