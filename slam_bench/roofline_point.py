"""The least time of the point map's plane search on one NVIDIA H100:
copied from the port's ``tools/roofline.py`` (``plane_assoc_budget`` and
what it needs), so that later changes to the program do not move the
yardstick (``tests/test_torch_point_tracing.py`` holds the copy to the
original).

One search (``ieskf._plane_correspondences``: the k nearest of a row's
window^3 voxels and a plane fitted to them) at a scan's static sizes,
whatever implements it: a fused kernel, a graph or separate operations.
Its least time is the larger of its bytes at 3.35 TB/s (each row's probe
slots, the table read at most once, the rows in and the planes out) and
its fp32 operations at 67 TFLOP/s (a squared distance a candidate slot,
one 3x3 eigensolve a row).
"""
from __future__ import annotations

# the H100 SXM's published peaks: fp32 outside the tensor cores, and HBM3
FP32_FLOPS, HBM_BYTES_S = 67e12, 3.35e12

# K6's operations a 3x3 matrix (tools/roofline.py EIGH3_FLOPS): 18 Jacobi
# rotations of 53 ops and 3 transcendentals, then the rank pick's 9
EIGH3_FLOPS = 18 * (53 + 3) + 9
# a table slot read (key, occupied flag, point); a row in (world point,
# mask) and out (normal, residual, flag); a squared distance
ASSOC_SLOT_BYTES = 12 + 1 + 12
ASSOC_ROW_BYTES = (12 + 1) + (12 + 4 + 1)
D2_FLOPS = 8


def bound(flops, nbytes):
    """(ms, by): the larger of the operations over the fp32 peak and the
    bytes over the HBM rate."""
    t_ops = float(flops) / FP32_FLOPS * 1e3
    t_bytes = float(nbytes) / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def plane_assoc_budget(n, t, window=3, probes=4):
    """One plane search on n padded rows and a table of t slots:
    {bytes, flops, bound_ms, bound_by}."""
    slots = n * window ** 3 * probes
    nbytes = min(slots, t) * ASSOC_SLOT_BYTES + n * ASSOC_ROW_BYTES
    flops = slots * D2_FLOPS + n * EIGH3_FLOPS
    ms, by = bound(flops, nbytes)
    return dict(bytes=nbytes, flops=flops, bound_ms=ms, bound_by=by)
