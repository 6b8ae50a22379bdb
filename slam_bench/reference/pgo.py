"""The keyframe pose graph's solve as the configurations define it (GTSAM's
batch Gauss-Newton in FAST-LIO-SAM-QN), written plainly: a prior on node
0, a between factor from each node to the next, loop factors with an
isotropic variance under a Huber weight, residual r = Log(Z^-1 Ti^-1 Tj)
whitened by the factor's variances; each step relinearizes every factor,
solves the dense normal equations over the active nodes exactly, and
retracts on the right, T <- T Exp(x), onto a rotation again.
"""
from __future__ import annotations

import torch

from . import geometry as G


def _between(Ti, Tj, Z):
    """Residual and Jacobians of between factors (first order in r)."""
    rel = G.inverse(Ti) @ Tj
    r = G.log_se3(G.inverse(Z) @ rel)
    Jj = torch.eye(6, dtype=r.dtype, device=r.device) \
        + 0.5 * G.small_adjoint(r)
    return r, -Jj @ G.adjoint(G.inverse(rel)), Jj


def optimize(poses, prior, odom, loops, prior_var, odom_var, iters: int,
             robust_delta: float):
    """``poses`` (n, 4, 4) the active nodes' estimates, ``prior`` (4, 4),
    ``odom`` (n, 4, 4) the between measurement into node k (k >= 1),
    ``loops`` (i, j, Z, variance) tensors.  Returns the solved poses."""
    n, dt, dev = poses.shape[0], poses.dtype, poses.device
    li, lj, lz, lvar = loops
    wp = 1 / prior_var.to(dt)
    wo = 1 / odom_var.to(dt)
    T = poses.clone()
    for _ in range(iters):
        H = torch.zeros(6 * n, 6 * n, dtype=dt, device=dev)
        g = torch.zeros(6 * n, dtype=dt, device=dev)

        def add(i, Ji, j, Jj, r, w):
            # i < 0: a unary factor on j
            for a, Ja in ((i, Ji), (j, Jj)):
                if a < 0:
                    continue
                g[6 * a:6 * a + 6] += Ja.T @ (w * r)
                for b, Jb in ((i, Ji), (j, Jj)):
                    if b >= 0:
                        H[6 * a:6 * a + 6, 6 * b:6 * b + 6] += \
                            Ja.T @ (w[:, None] * Jb)

        rp = G.log_se3(G.inverse(prior) @ T[0])
        add(-1, None, 0, torch.eye(6, dtype=dt, device=dev)
            + 0.5 * G.small_adjoint(rp), rp, wp)
        if n > 1:
            r, Ji, Jj = _between(T[:-1], T[1:], odom[1:])
            for k in range(n - 1):
                add(k, Ji[k], k + 1, Jj[k], r[k], wo)
        if li.numel():
            r, Ji, Jj = _between(T[li], T[lj], lz)
            for k in range(li.numel()):
                w = torch.full((6,), 1 / max(float(lvar[k]), 1e-8), dtype=dt,
                               device=dev)
                m = float(torch.sqrt((r[k] * r[k] * w).sum()))
                if robust_delta > 0 and m > robust_delta:
                    w = w * (robust_delta / m)
                add(int(li[k]), Ji[k], int(lj[k]), Jj[k], r[k], w)
        x = torch.linalg.solve(H, -g).reshape(n, 6)
        T = T @ G.exp_se3(x)
        T[:, :3, :3] = G.orthonormal(T[:, :3, :3])
    return T
