"""SPMD programs over a ``Mesh`` — port of
fast_lio_sam_qn_tpu/parallel/spmd.py.

Every rank calls a program with the same (replicated) inputs; each computes
its contiguous block of the sharded axis (``Mesh.shard_rows``), and the
collectives combine the blocks:

- ``sharded_gicp_align``: one registration with the source points sharded
  (dst replicated).  Each rank finds its shard's nearest neighbours (K1 at
  k = 1 on the card) and builds its 6x6 normal equations; (H, b) are
  all-reduced every Gauss-Newton iteration and the pose update is
  replicated.
- ``batched_gicp_align``: B independent registrations, lanes sharded
  (K1b at k = 15 for the covariances, K2b for every NN search); the
  results gathered in lane order.
- ``pgo_optimize_sharded`` / ``pgo_optimize_full``: the pose-graph solve
  with the factor rows sharded; b, the block-Jacobi blocks and every H x
  all-reduced, the rows summed by ``pgo.RowScatter``.
- ``loop_closure_batch``: B loop-closure registrations (the whole
  per-candidate pipeline), lanes sharded, every ``RegistrationOutput``
  field gathered in lane order.

The reference's ``lru_cache``d jit builders have no counterpart: PyTorch
runs eagerly.  Every loop's stop test reads a replicated value, so every
rank leaves it at the same iteration.
"""
from __future__ import annotations

import torch

from ..ops import gicp, knn_cuda, linalg3, pgo, se3
from .mesh import Mesh


# ---------------------------------------------------------------------------
# point-sharded single registration (spmd.py:34-110)
# ---------------------------------------------------------------------------

def sharded_gicp_align(mesh: Mesh, src, src_mask, src_cov, dst, dst_mask,
                       dst_cov, init_T, *, max_iter: int = 32,
                       max_corr_dist: float = 52.5, trans_eps: float = 0.01):
    """GICP Gauss-Newton with the source rows sharded: src (N, 3), src_mask
    (N,), src_cov (N, 3, 3) with N a multiple of the world size; dst
    (D, 3), dst_mask, dst_cov replicated; init_T (4, 4).  Returns
    (T (4, 4), iterations)."""
    sl = mesh.shard_rows(src.shape[0])
    src_l, smask_l, scov_l = src[sl], src_mask[sl], src_cov[sl][None]
    max_d2 = torch.tensor(max_corr_dist, dtype=torch.float32,
                          device=src.device) ** 2
    T, it = init_T, 0
    while it < max_iter:
        y = se3.transform_points(src_l, T).contiguous()
        d2, idx, ok = knn_cuda.nn(y, smask_l, dst, dst_mask)
        H, b = gicp.normal_equations(T[None, :3, :3], y[None], scov_l,
                                     dst[None], dst_cov[None], idx[None],
                                     (ok & (d2 < max_d2))[None])
        H = mesh.all_reduce_sum(H[0])
        b = mesh.all_reduce_sum(b[0])
        xi = linalg3.solve6(H, -b, damping=1e-6)
        T = se3.compose(se3.se3_exp(xi), T)
        it += 1
        if float(torch.linalg.norm(xi)) < trans_eps:
            break
    return T, it


# ---------------------------------------------------------------------------
# batch-of-pairs registration (spmd.py:117-144)
# ---------------------------------------------------------------------------

def align_lanes(src_b, smask_b, dst_b, dmask_b, init_T_b, *,
                max_iter: int = 32, max_corr_dist: float = 52.5, k: int = 15):
    """B registrations on one device, the reference's per-lane ``gicp.align(
    cov_backend="brute", banded=True)``: plane covariances from batched K1
    at k, then ``align_batched`` over batched K2.  Returns (transforms
    (B, 4, 4), fitness (B,), converged (B,))."""
    res = gicp.align_batched(
        src_b, smask_b, dst_b, dmask_b, init_T_b,
        src_cov=gicp.plane_covariances_batched(src_b, smask_b, k),
        dst_cov=gicp.plane_covariances_batched(dst_b, dmask_b, k),
        max_iter=max_iter, max_corr_dist=max_corr_dist)
    return res.transform, res.fitness, res.converged


def batched_gicp_align(mesh: Mesh, src_b, smask_b, dst_b, dmask_b, init_T_b,
                       *, max_iter: int = 32, max_corr_dist: float = 52.5):
    """``align_lanes`` with the B lanes sharded (B a multiple of the world
    size); the results gathered back in lane order."""
    sl = mesh.shard_rows(src_b.shape[0])
    out = align_lanes(src_b[sl], smask_b[sl], dst_b[sl], dmask_b[sl],
                      init_T_b[sl], max_iter=max_iter,
                      max_corr_dist=max_corr_dist)
    return tuple(mesh.all_gather_rows(o) for o in out)


# ---------------------------------------------------------------------------
# factor-sharded pose-graph solve (spmd.py:151-307)
# ---------------------------------------------------------------------------

def _solve(mesh: Mesh, si: pgo.RowScatter, sj: pgo.RowScatter, r, Ji, Jj,
           w6, valid, active, pcg_iters: int):
    """One linearized solve on this rank's factor rows (their scatters si /
    sj): b, the block-Jacobi blocks and every H x all-reduced, then the
    shared PCG (``pgo.pcg``).  Returns the replicated update (N, 6)."""
    wv = w6 * valid[:, None]
    wr = r * wv
    b = mesh.all_reduce_sum(si(torch.einsum("fba,fb->fa", Ji, wr))
                            + sj(torch.einsum("fba,fb->fa", Jj, wr)))
    P = mesh.all_reduce_sum(
        si(torch.einsum("fba,fbc->fac", Ji, Ji * wv[:, :, None]))
        + sj(torch.einsum("fba,fbc->fac", Jj, Jj * wv[:, :, None])))
    Pinv = torch.linalg.inv(P + 1e-6 * torch.eye(6, dtype=r.dtype,
                                                 device=r.device))

    def hx(v):
        u = (torch.einsum("fab,fb->fa", Ji, si.gather(v))
             + torch.einsum("fab,fb->fa", Jj, sj.gather(v)))
        wu = u * wv
        return mesh.all_reduce_sum(si(torch.einsum("fba,fb->fa", Ji, wu))
                                   + sj(torch.einsum("fba,fb->fa", Jj, wu))
                                   ) * active

    return pgo.pcg(b, Pinv, hx, active, pcg_iters)


def pgo_optimize_sharded(mesh: Mesh, poses, idx_i, idx_j, r, Ji, Jj, w6,
                         valid, active, *, pcg_iters: int = 64):
    """One linearized solve with the factor rows sharded: the per-row arrays
    of ``pgo._factor_data`` with their node indices (``pgo.
    factor_indices``; -1 drops a row), padded to a multiple of the world
    size; poses (N, 4, 4) and active (N, 1) replicated.  Returns the
    replicated tangent update (N, 6)."""
    sl = mesh.shard_rows(r.shape[0])
    n_cap = poses.shape[0]
    return _solve(mesh, pgo.RowScatter(idx_i[sl], n_cap, r.dtype),
                  pgo.RowScatter(idx_j[sl], n_cap, r.dtype), r[sl], Ji[sl],
                  Jj[sl], w6[sl], valid[sl], active.to(torch.bool),
                  pcg_iters)


def pgo_optimize_full(mesh: Mesh, graph: pgo.GraphState, prior_var, odom_var,
                      *, gn_iters: int = 3, pcg_iters: int = 64,
                      robust_delta: float = 1.0) -> pgo.GraphState:
    """``pgo.optimize`` (relinearized every step, Huber on the loop rows,
    right-perturbation retraction of the active nodes) with each linear
    solve factor-sharded: the rows (odometry, loops, prior) padded with
    zero rows to a multiple of the world size.  Returns the replicated
    graph."""
    dev = graph.poses.device
    prior_var = torch.as_tensor(prior_var, dtype=graph.poses.dtype,
                                device=dev)
    odom_var = torch.as_tensor(odom_var, dtype=graph.poses.dtype, device=dev)
    n_cap, l_cap = graph.capacity, graph.loop_i.shape[0]
    active = (torch.arange(n_cap, device=dev) < graph.num_nodes)[:, None]
    f_tot = n_cap + l_cap + 1
    f_pad = f_tot + (-f_tot) % mesh.size
    sl = mesh.shard_rows(f_pad)

    def rows(a, fill=0):
        """This rank's block of the rows a, padded with fill to f_pad."""
        extra = torch.full((f_pad - f_tot,) + a.shape[1:], fill,
                           dtype=a.dtype, device=dev)
        return torch.cat([a, extra])[sl]

    ii, jj = pgo.factor_indices(graph)
    dt = graph.poses.dtype
    si = pgo.RowScatter(rows(ii, -1), n_cap, dt)
    sj = pgo.RowScatter(rows(jj, -1), n_cap, dt)
    g = graph
    for _ in range(gn_iters):
        r, Ji, Jj, w6, valid = pgo._factor_data(g, prior_var, odom_var)
        if robust_delta > 0:
            w6 = pgo.huber_loop_weights(r, w6, n_cap, l_cap, robust_delta)
        x = _solve(mesh, si, sj, rows(r), rows(Ji), rows(Jj), rows(w6),
                   rows(valid, False), active, pcg_iters)
        g = pgo.gn_retract(g, x, active)
    return g


# ---------------------------------------------------------------------------
# the sharded loop-closure batch (spmd.py:314-331)
# ---------------------------------------------------------------------------

def loop_closure_batch(mesh: Mesh, lc, store, query_idxs, closest_idxs):
    """The batched registration of ``lc`` (a ``LoopClosure``) with the B
    lanes sharded (B a multiple of the world size; pad lanes carry
    closest_idx = -1) and the store replicated; every
    ``RegistrationOutput`` field gathered back in lane order."""
    qs = [int(i) for i in torch.as_tensor(query_idxs).tolist()]
    cs = [int(i) for i in torch.as_tensor(closest_idxs).tolist()]
    sl = mesh.shard_rows(len(qs))
    reg = lc._register(store, qs[sl], cs[sl], batched=True)
    return type(reg)(*(mesh.all_gather_rows(f) for f in reg))
