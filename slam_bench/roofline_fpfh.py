"""The least time of the loop closure's FPFH kernels (K3-K5 and their
batched forms) on one NVIDIA H100: copied from the port's
``tools/roofline.py`` (``stage_pair_bound`` and what it needs), so that
later changes to the program do not move the yardstick
(``tests/test_torch_roofline_fpfh.py`` holds the copy to the original).

A stage's least time is the larger of its in-radius pairs' fp32
operations at the published 67 TFLOP/s and its bytes (each valid row read
once, every row written once) at 3.35 TB/s: the work any implementation
of the stage must do on this cloud, counted by exact float64 distances.
"""
from __future__ import annotations

import torch

# the H100 SXM's published peaks: fp32 outside the tensor cores, and HBM3
FP32_FLOPS, HBM_BYTES_S = 67e12, 3.35e12

STAGES = ("moments", "spfh", "agg")
# the loop closure's radii: K3 at the normal and the covariance radius, K4
# and K5 at the feature radius
STAGE_RADII = {"moments": (0.9, 0.6), "spfh": (1.5,), "agg": (1.5,)}
# the useful math of a pair within each radius (K3: 10 adds, the 6
# products shared with the smaller radius; K4: the pair's ~75 angle flops;
# K5: 33 FMAs and its weight), the bytes in of a valid row and out of
# every row
PAIR_WORK = {"moments": ((16, 10), 13, 80), "spfh": ((75,), 26, 136),
             "agg": ((68,), 146, 136)}


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of the operations over the fp32
    peak and the bytes over the HBM rate."""
    t_ops = float(flops) / FP32_FLOPS * 1e3
    t_bytes = float(nbytes) / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def radius_bound(p, qm, dbm, radii, pair_flops, hit_flops, row_in, row_out):
    """An FPFH kernel's bound over this run's data, per lane: pair_flops
    of distance test for each (valid query, valid db point) pair plus
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


def stage_pair_bound(stage, p, qm, dbm, pair_flops=0):
    """``radius_bound`` of one FPFH stage as the kernel table counts it:
    the in-radius pairs' math (``pair_flops = 0``), or with 9 flops of
    distance test per valid pair (the all-pairs figure)."""
    hit, row_in, row_out = PAIR_WORK[stage]
    return radius_bound(p, qm, dbm, STAGE_RADII[stage], pair_flops, hit,
                        row_in, row_out)


def fpfh_bound_ms(points, mask, n_valid) -> float:
    """The least time (ms) of K3, K4 and K5 on (B, N, 3) clouds: K3 over
    the masked points, K4 and K5 over those with a normal (``n_valid``)."""
    return sum(stage_pair_bound(stage, points, mask,
                                mask if stage == "moments" else mask & n_valid
                                )[0] for stage in STAGES)
