"""Trajectory evaluation (ATE / RPE), numpy — the same arithmetic as the JAX
package's ``utils/evaluation.py``."""
from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale=False):
    """Least-squares rigid alignment src -> dst for (N,3) point sets."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    c = (D * S.diagonal()).sum() / (xs ** 2).sum() * len(src) \
        if with_scale else 1.0
    t = mu_d - c * R @ mu_s
    return R, t, c


def ate_rmse(est: np.ndarray, gt: np.ndarray, align=True) -> float:
    """Absolute trajectory error (RMSE of translation) between pose arrays
    (N,4,4), optionally SE(3)-aligned first (evo-style)."""
    p_est = est[:, :3, 3]
    p_gt = gt[:, :3, 3]
    if align and len(est) >= 3:
        R, t, _ = umeyama_alignment(p_est, p_gt)
        p_est = p_est @ R.T + t
    err = np.linalg.norm(p_est - p_gt, axis=-1)
    return float(np.sqrt(np.mean(err ** 2)))


def rpe_rmse(est: np.ndarray, gt: np.ndarray, delta: int = 1):
    """Relative pose error over a fixed frame delta between pose arrays
    (N,4,4): (translation RMSE, rotation RMSE in rad)."""
    t_errs, r_errs = [], []
    for i in range(len(est) - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(e[:3, 3]))
        cos = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        r_errs.append(np.arccos(cos))
    return (float(np.sqrt(np.mean(np.square(t_errs)))),
            float(np.sqrt(np.mean(np.square(r_errs)))))
