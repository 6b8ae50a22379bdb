"""Exact brute-force kNN in plain PyTorch — port of
fast_lio_sam_qn_tpu/ops/knn.py, and the plain version of kernel K1
(ops/knn_cuda.py).

d2 = max(|q|^2 - 2 q.v + |v|^2, 0) in fp32, the reference's expansion, so
this path tracks the JAX package on the CPU.  Ties go to the lowest db
index, as ``jax.lax.top_k`` breaks them: a stable ascending sort.
"""
from __future__ import annotations

import torch


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 per row — shared with the kernel wrappers, so a kernel sees
    exactly the norms its plain version computes."""
    return torch.sum(x * x, dim=-1)


def _dist2_tile(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(m, F), (n, F) -> (m, n) squared euclidean distances."""
    cross = q @ d.T
    return torch.clamp(sq_norms(q)[:, None] - 2.0 * cross + sq_norms(d)[None, :],
                       min=0.0)


def brute_knn(queries: torch.Tensor, qmask: torch.Tensor, db: torch.Tensor,
              dbmask: torch.Tensor, k: int, chunk: int = 1024, pair_ok=None):
    """Exact kNN of ``queries`` (M, F) in ``db`` (N, F), k <= N.

    ``pair_ok(start, stop)``, where given, returns the (stop - start, N)
    bool of the pairs the search may use for query rows [start, stop) (the
    banded kNN's tile prune, ops/knn_cuda.py).

    Returns (dist2 (M, k) — inf where invalid, idx (M, k) int32 — -1 where
    invalid, valid (M, k) bool)."""
    inf_row = torch.where(dbmask, 0.0, torch.inf)[None, :]
    d_out, i_out = [], []
    for s in range(0, queries.shape[0], chunk):
        d2 = _dist2_tile(queries[s:s + chunk], db) + inf_row
        ok = qmask[s:s + chunk, None]
        if pair_ok is not None:
            ok = ok & pair_ok(s, s + d2.shape[0])
        d2 = torch.where(ok, d2, torch.inf)
        if k == 1:
            # the first minimum, as a stable sort's head
            vals, idx = torch.min(d2, dim=1, keepdim=True)
        else:
            vals, idx = torch.sort(d2, dim=1, stable=True)
        d_out.append(vals[:, :k])
        i_out.append(idx[:, :k].to(torch.int32))
    d2 = torch.cat(d_out)
    idx = torch.cat(i_out)
    valid = torch.isfinite(d2)
    return d2, torch.where(valid, idx, -1), valid


def brute_nn(queries, qmask, db, dbmask, chunk: int = 2048):
    """Exact single nearest neighbour: (dist2 (M,), idx (M,), valid (M,))."""
    d2, idx, valid = brute_knn(queries, qmask, db, dbmask, k=1, chunk=chunk)
    return d2[:, 0], idx[:, 0], valid[:, 0]
