"""Which rows of a radius reduction may legitimately differ between two
fp32 implementations (a kernel and its plain version, or the port and the
JAX package).

A pair whose float64 distance lies within ``BOUNDARY_REL`` of a radius can
fall on either side of it once d2 is rounded, and a pair whose Darboux
angles lie within ``BIN_EDGE_BAND`` of a bin edge can land in either bin.
Such rows may differ by whole pairs; every other row must agree to the
stated tolerance.  Used by the tests and by chip_smoke.py.
"""
from __future__ import annotations

import torch

from .ops.fpfh_stream import _TH_COS, _TH_SIN, _angles

BOUNDARY_REL = 1e-4   # |d2 - r^2| <= 1e-4 r^2, in float64
BIN_EDGE_BAND = 1e-4  # |angle value - bin edge|, in float64
EXPANSION_REL = 2.0 ** -19  # fp32 d2 expansion error / (|q|^2 + |v|^2)


def radius_boundary_rows(points, keep, rows, radii, expansion=False):
    """Bool per row in ``rows``: holds a pair with a kept point whose
    float64 d2 lies within BOUNDARY_REL r^2 of r^2 for some radius r, or,
    with ``expansion``, within that plus EXPANSION_REL (|q|^2 + |v|^2):
    far from the origin two fp32 expansions of one pair's d2 may differ by
    that much (csrc/tile_prune.cuh)."""
    p = points.double()
    d2 = torch.cdist(p[rows], p) ** 2
    band = 0.0
    if expansion:
        pp = torch.sum(p * p, dim=1)
        band = EXPANSION_REL * (pp[rows][:, None] + pp[None, :])
    near = torch.zeros_like(d2, dtype=torch.bool)
    for r in radii:
        near |= torch.abs(d2 - r * r) <= BOUNDARY_REL * r * r + band
    return (near & keep[None, :]).any(dim=1)


def bin_edge_pairs(points, normals, keep, rows, radius):
    """Per row in ``rows``: the number of its in-radius, non-self pairs
    whose float64 (alpha, phi) lie within BIN_EDGE_BAND of an 11-bin edge
    or whose (tx, ty) lie within that band of a theta half-plane."""
    p, nr = points.double(), normals.double()
    q, u = p[rows], nr[rows]
    d2 = torch.cdist(q, p) ** 2
    alpha, phi, ty, tx = _angles(
        (q[:, 0:1], q[:, 1:2], q[:, 2:3]), (u[:, 0:1], u[:, 1:2], u[:, 2:3]),
        p.T, nr.T, d2)
    edges = torch.tensor([-1.0 + 2.0 * k / 11 for k in range(1, 11)],
                         dtype=torch.float64, device=p.device)
    near = torch.zeros_like(d2, dtype=torch.bool)
    for v in (alpha, phi):
        near |= (torch.abs(v[..., None] - edges).min(-1).values
                 <= BIN_EDGE_BAND)
    hyp = torch.hypot(tx, ty)
    for c, s in zip(_TH_COS, _TH_SIN):
        near |= torch.abs(ty * c - tx * s) <= BIN_EDGE_BAND * hyp
    near |= hyp <= BIN_EDGE_BAND
    in_r = (d2 <= radius * radius * (1 + BOUNDARY_REL)) & keep[None, :]
    in_r[torch.arange(len(rows), device=p.device), rows] = False
    return (near & in_r).sum(dim=1)


def spfh_rows_explained(got, want, points, normals, keep, rows, radius,
                        expansion=False):
    """Bool per row in ``rows``: the row's difference is whole pairs at a
    boundary — either a pair sits on the radius (membership, so counts may
    differ; ``expansion`` as in ``radius_boundary_rows``), or the neighbour
    count is equal and the L1 difference of the 33 bins is at most 2 per
    bin-edge pair (each moved pair leaves one bin and enters another)."""
    rad = radius_boundary_rows(points, keep, rows, (radius,), expansion)
    nb = bin_edge_pairs(points, normals, keep, rows, radius)
    same_cnt = got[rows, 33] == want[rows, 33]
    l1 = torch.abs(got[rows, :33] - want[rows, :33]).sum(dim=1)
    return rad | (same_cnt & (l1 <= 2 * nb))


def rows_beyond(got, want, atol: float, rtol: float):
    """Row indices where some |got - want| > atol + rtol |want|."""
    bad = (torch.abs(got - want) > atol + rtol * torch.abs(want)).any(dim=1)
    return torch.nonzero(bad).flatten()
