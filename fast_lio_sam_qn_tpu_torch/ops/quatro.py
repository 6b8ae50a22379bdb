"""Quatro-equivalent robust global registration — port of
fast_lio_sam_qn_tpu/ops/quatro.py.

FPFH mutual-NN matching (through kernel K1; ``match_features_batched``
matches B cloud pairs through one batched K1 launch per direction, and
``solve`` then runs the rest per lane), approximate max-clique
inliers, GNC-TLS yaw, component-wise translation voting, optional TIM scale
voting and a reweighted 2D Procrustes refinement.  Scalar parameters become
0-d fp32 tensors so every derived threshold rounds as in the reference.

Where the reference relies on ``lax.top_k`` / ``argsort`` tie order (index
order among equal keys), the port sorts stably.  The reference's
data-dependent loops become fixed Python loops of small device ops that
read nothing on the host: the sequential greedy clique pass walks rows
gathered once in visiting order and writes each vertex's flag through a
one-element index tensor (indexing by a 0-d tensor reads it on the host:
three reads a vertex), and GNC runs all ``max_iter`` iterations under a
device flag that freezes its state once the reference's stopping rule
holds.  Constants are filled on the device, never copied from the host.

``solve`` runs one lane's coarse solve through the module's CUDA-graph
runner ``_SOLVE_GRAPHS``: on the card one replay a call, whose outputs are
the caller's own (clones); off the card the same function, eagerly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import cuda_graph
from . import knn_cuda, se3

# the coarse solve's graphs, one a key (the matches' shape and the settings)
_SOLVE_GRAPHS = cuda_graph.Runner()


class QuatroResult(NamedTuple):
    transform: torch.Tensor    # (4, 4) src -> dst ([s]R | t)
    converged: torch.Tensor    # bool
    num_corres: torch.Tensor   # int: matches fed to the solver
    num_inliers: torch.Tensor  # int: clique size
    scale: torch.Tensor        # f32: 1.0 unless estimate_scale


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d fp32 tensor on ``like``'s device, filled there (no
    copy from the host)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor ``i``, selected on the device."""
    return x.index_select(0, i.reshape(1))[0]


def _select_matches(src_pts, dst_pts, d2_sd, idx_sd, v_sd, idx_ds,
                    distance_threshold, max_corres: int,
                    optimized_matching: bool):
    """Mutual check, spatial gate and best-``max_corres`` selection over
    the last axis; any leading axes are a batch of clouds."""
    n_src = idx_sd.shape[-1]
    j_sd = torch.clamp(idx_sd, min=0).long()
    back = torch.gather(idx_ds, -1, j_sd)
    mutual = v_sd & (back == torch.arange(n_src, device=back.device))
    j3 = j_sd[..., None].expand(j_sd.shape + (3,))
    if optimized_matching:
        spat = torch.linalg.norm(src_pts - torch.gather(dst_pts, -2, j3),
                                 dim=-1)
        ok = mutual & (spat <= _f32(distance_threshold, spat))
    else:
        ok = mutual
    score = torch.where(ok, -d2_sd, -torch.inf)
    if max_corres > n_src:
        score = torch.cat([score, score.new_full(
            score.shape[:-1] + (max_corres - n_src,), -torch.inf)], dim=-1)
    top_score, top_i = torch.sort(score, dim=-1, descending=True,
                                  stable=True)
    top_score, top_i = top_score[..., :max_corres], top_i[..., :max_corres]
    valid = torch.isfinite(top_score)
    top_i = torch.clamp(top_i, 0, n_src - 1)
    top3 = top_i[..., None].expand(top_i.shape + (3,))
    d_idx = torch.gather(j_sd, -1, top_i)[..., None].expand(top3.shape)
    return (torch.gather(src_pts, -2, top3), torch.gather(dst_pts, -2, d_idx),
            valid)


def match_features(src_pts, src_desc, src_valid, dst_pts, dst_desc,
                   dst_valid, distance_threshold, max_corres: int = 200,
                   optimized_matching: bool = True):
    """Mutual-NN feature matching in the reference's two modes: optimized
    (spatially gated, best ``max_corres``) or advanced (all mutual matches
    up to the static cap).  Returns (s_pts (C, 3), d_pts (C, 3), valid)."""
    d2_sd, idx_sd, v_sd = knn_cuda.nn(src_desc, src_valid, dst_desc,
                                      dst_valid)
    _, idx_ds, _ = knn_cuda.nn(dst_desc, dst_valid, src_desc, src_valid)
    return _select_matches(src_pts, dst_pts, d2_sd, idx_sd, v_sd, idx_ds,
                           distance_threshold, max_corres, optimized_matching)


def match_features_batched(src_pts, src_desc, src_valid, dst_pts, dst_desc,
                           dst_valid, distance_threshold,
                           max_corres: int = 200,
                           optimized_matching: bool = True):
    """``match_features`` over B clouds ((B, N, ...) inputs), both nearest
    neighbour passes through one batched K1 launch each.  Returns
    (s_pts (B, C, 3), d_pts (B, C, 3), valid (B, C))."""
    d2_sd, idx_sd, v_sd = knn_cuda.nn_batched(src_desc, src_valid, dst_desc,
                                              dst_valid)
    _, idx_ds, _ = knn_cuda.nn_batched(dst_desc, dst_valid, src_desc,
                                       src_valid)
    return _select_matches(src_pts, dst_pts, d2_sd, idx_sd, v_sd, idx_ds,
                           distance_threshold, max_corres, optimized_matching)


def max_clique_inliers(s_pts, d_pts, valid, noise_bound, iters: int = 64,
                       greedy_cap: int = 256):
    """Approximate maximum clique of the compatibility graph
    | |s_i - s_j| - |d_i - d_j| | <= 2 noise_bound: replicator dynamics,
    then a greedy pass in descending support order over at most
    ``greedy_cap`` vertices that keeps a vertex only if it is compatible
    with every vertex kept before it: four device ops a vertex, on rows
    gathered in visiting order, the flag written through a one-element
    index (no host read; a vertex never visited is never kept).  Returns
    the inlier mask (C,)."""
    c = s_pts.shape[0]
    dev = s_pts.device
    nb = _f32(noise_bound, s_pts)
    ds = torch.linalg.norm(s_pts[:, None, :] - s_pts[None, :, :], dim=-1)
    dd = torch.linalg.norm(d_pts[:, None, :] - d_pts[None, :, :], dim=-1)
    compat = torch.abs(ds - dd) <= 2.0 * nb
    pair_ok = valid[:, None] & valid[None, :]
    eye = torch.eye(c, dtype=torch.bool, device=dev)
    A = (compat & pair_ok & ~eye).to(torch.float32)

    x = valid.to(torch.float32)
    x = x / torch.clamp(torch.sum(x), min=1.0)
    for _ in range(iters):
        num = x * (A @ x)
        x = num / torch.clamp(torch.sum(num), min=1e-12)

    # the walk: the first ``greedy_cap`` vertices in descending support
    # (stable), their rows and flags gathered once in visiting order
    order = torch.sort(-x, stable=True).indices[:greedy_cap]
    A_ord = (A > 0.5).index_select(0, order)
    valid_ord = valid.index_select(0, order)
    true = torch.ones((), dtype=torch.bool, device=dev)
    kept = torch.zeros(c, dtype=torch.bool, device=dev)
    for i in range(order.shape[0]):
        ok = valid_ord[i] & torch.all(torch.where(kept, A_ord[i], true))
        kept.index_put_((order[i:i + 1],), ok)
    return kept


def _ring_tims(s_pts, d_pts, inliers, strides):
    """Translation-invariant measurements over the compacted inlier set:
    inlier k pairs with inlier (k + r) mod c_inl for each stride r.
    Returns (v, w, m) stacked over strides."""
    c = s_pts.shape[0]
    ordi = torch.sort(torch.where(inliers, 0, 1).to(torch.int32),
                      stable=True).indices
    sp, dp = s_pts[ordi], d_pts[ordi]
    c_inl = torch.sum(inliers.to(torch.int32))
    kk = torch.arange(c, dtype=torch.int32, device=s_pts.device)
    vs, ws, ms = [], [], []
    for r in strides:
        nxt = torch.where(kk + r >= c_inl, kk + r - torch.clamp(c_inl, min=1),
                          kk + r)
        nxt = torch.clamp(nxt, 0, c - 1).long()
        vs.append(sp - sp[nxt])
        ws.append(dp - dp[nxt])
        ms.append((kk < c_inl) & (c_inl >= r + 1))
    return torch.cat(vs), torch.cat(ws), torch.cat(ms)


def gnc_rotation_yaw(s_pts, d_pts, inliers, noise_bound, gnc_factor,
                     cost_diff_thr, max_iter: int = 50):
    """GNC-TLS yaw from ring TIMs (strides 1 and 2) over the clique.
    The reference stops once the cost moves by less than ``cost_diff_thr``;
    here every one of the ``max_iter`` iterations runs, and a device flag
    ``live`` keeps the state (yaw, weights, mu, the previous cost) of the
    iteration that met the rule, so the result is the early stop's, bit for
    bit, with no host read.  Returns (yaw, inlier_weights, converged)."""
    v, w, m = _ring_tims(s_pts, d_pts, inliers, (1, 2))
    v, w = v[:, :2], w[:, :2]
    m = m & (torch.linalg.norm(v, dim=-1) > 1e-3)
    nb = _f32(noise_bound, s_pts)
    gnc_factor = _f32(gnc_factor, s_pts)
    cost_diff_thr = _f32(cost_diff_thr, s_pts)
    cbar2 = (2.0 * nb) ** 2

    # the weight-free products of the yaw's closed form, and the constants
    # of the loop, made once
    vw_dot = v[:, 0] * w[:, 0] + v[:, 1] * w[:, 1]
    vw_cross = v[:, 0] * w[:, 1] - v[:, 1] * w[:, 0]
    zero, one = _f32(0.0, s_pts), _f32(1.0, s_pts)

    def yaw_solve(wt):
        return torch.atan2(torch.sum(wt * vw_cross), torch.sum(wt * vw_dot))

    def residual2(yaw):
        cy, sy = torch.cos(yaw), torch.sin(yaw)
        rx = cy * v[:, 0] - sy * v[:, 1] - w[:, 0]
        ry = sy * v[:, 0] + cy * v[:, 1] - w[:, 1]
        return rx * rx + ry * ry

    mf = m.to(torch.float32)
    wt = mf
    yaw = yaw_solve(wt)
    # the residuals of the current yaw, carried from the cost that computed
    # them: an iteration's first residuals are its predecessor's last
    r2 = residual2(yaw)
    r2_max = torch.max(torch.where(m, r2, zero))
    mu = torch.clamp(cbar2 / torch.clamp(2.0 * r2_max - cbar2, min=1e-9),
                     min=1e-6)
    cost_prev = _f32(torch.inf, s_pts)
    live = torch.ones((), dtype=torch.bool, device=s_pts.device)
    for _ in range(max_iter):
        mu1 = mu + 1.0
        ub = mu1 / mu * cbar2
        lb = mu / mu1 * cbar2
        wt_new = torch.where(
            r2 >= ub, zero,
            torch.where(r2 <= lb, one,
                        torch.sqrt(cbar2 * mu * mu1
                                   / torch.clamp(r2, min=1e-12)) - mu))
        wt_new = torch.clamp(wt_new, 0.0, 1.0) * mf
        yaw_new = yaw_solve(wt_new)
        r2 = residual2(yaw_new)
        cost = torch.sum(wt_new * torch.minimum(r2, cbar2))
        done = torch.abs(cost - cost_prev) < cost_diff_thr
        # after the stop nothing moves: later iterations compute and discard
        wt = torch.where(live, wt_new, wt)
        yaw = torch.where(live, yaw_new, yaw)
        mu = torch.where(live, mu * gnc_factor, mu)
        cost_prev = torch.where(live, cost, cost_prev)
        live = live & ~done
    converged = torch.sum(wt > 0.5) >= 3
    return yaw, wt, converged


def _rotate_yaw(yaw, p):
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([cy * p[..., 0] - sy * p[..., 1],
                        sy * p[..., 0] + cy * p[..., 1], p[..., 2]], dim=-1)


def translation_voting(s_pts, d_pts, inliers, yaw, noise_bound):
    """Component-wise consensus translation: per axis, the candidate window
    [t_k - nb, t_k + nb] covering the most candidates, averaged.
    Returns (t (3,), min votes over the axes)."""
    cand = d_pts - _rotate_yaw(yaw, s_pts)
    nb = _f32(noise_bound, s_pts)
    m = inliers

    def per_axis(vals):
        within = torch.abs(vals[:, None] - vals[None, :]) <= nb
        within = within & m[None, :] & m[:, None]
        counts = torch.sum(within, dim=1)
        best = torch.argmax(counts)
        sel = _row(within, best)
        return (torch.sum(torch.where(sel, vals, 0.0))
                / torch.clamp(torch.sum(sel), min=1), _row(counts, best))

    tx, cx = per_axis(cand[:, 0])
    ty, cy = per_axis(cand[:, 1])
    tz, cz = per_axis(cand[:, 2])
    return (torch.stack([tx, ty, tz]),
            torch.minimum(cx, torch.minimum(cy, cz)))


def estimate_scale_tims(s_pts, d_pts, inliers, noise_bound):
    """TLS-style consensus scale over stride-1 ring TIMs: candidates
    |w_k| / |v_k| with windows 2 nb / |v_k|; the mean of the best
    pairwise-consensus window, clamped to [0.05, 20].
    Returns (scale, n_votes)."""
    v, w, m = _ring_tims(s_pts, d_pts, inliers, (1,))
    nb = _f32(noise_bound, s_pts)
    vn = torch.linalg.norm(v, dim=-1)
    wn = torch.linalg.norm(w, dim=-1)
    m = m & (vn > 1e-3)
    ratio = wn / torch.clamp(vn, min=1e-6)
    alpha = 2.0 * nb / torch.clamp(vn, min=1e-6)
    within = torch.abs(ratio[:, None] - ratio[None, :]) <= \
        (alpha[:, None] + alpha[None, :])
    within = within & m[:, None] & m[None, :]
    counts = torch.sum(within, dim=1)
    best = torch.argmax(counts)
    sel = _row(within, best)
    n_votes = _row(counts, best)
    scale = torch.sum(torch.where(sel, ratio, 0.0)) / torch.clamp(
        torch.sum(sel), min=1)
    scale = torch.clamp(scale, 0.05, 20.0)
    return torch.where(n_votes >= 2, scale, 1.0), n_votes


def refine_yaw_translation(s_pts, d_pts, inliers, yaw0, t0, noise_bound,
                           iters: int = 4):
    """Iterative reweighted 2D Procrustes over the clique pairs within
    2 noise_bound of the current estimate; keeps the previous estimate when
    fewer than 3 pairs qualify.  Returns (yaw, t)."""
    nb = _f32(noise_bound, s_pts)
    yaw, t = yaw0, t0
    for _ in range(iters):
        r = torch.linalg.norm(_rotate_yaw(yaw, s_pts) + t[None] - d_pts,
                              dim=-1)
        w = (inliers & (r < 2.0 * nb)).to(torch.float32)
        wsum = torch.sum(w)
        enough = wsum >= 3.0
        wsafe = torch.clamp(wsum, min=1e-6)
        ms = torch.sum(s_pts * w[:, None], 0) / wsafe
        md = torch.sum(d_pts * w[:, None], 0) / wsafe
        sc = s_pts - ms
        dc = d_pts - md
        a = torch.sum(w * (sc[:, 0] * dc[:, 0] + sc[:, 1] * dc[:, 1]))
        b = torch.sum(w * (sc[:, 0] * dc[:, 1] - sc[:, 1] * dc[:, 0]))
        yaw_new = torch.atan2(b, a)
        t_new = md - _rotate_yaw(yaw_new, ms)
        yaw = torch.where(enough, yaw_new, yaw)
        t = torch.where(enough, t_new, t)
    return yaw, t


def align(src_pts, src_desc, src_valid, dst_pts, dst_desc, dst_valid, *,
          noise_bound, gnc_factor, cost_diff_thr, distance_threshold,
          max_corres: int = 200, rot_max_iter: int = 50,
          optimized_matching: bool = True,
          estimate_scale: bool = False) -> QuatroResult:
    """Full Quatro pipeline on precomputed FPFH descriptors."""
    s, d, valid = match_features(
        src_pts, src_desc, src_valid, dst_pts, dst_desc, dst_valid,
        distance_threshold, max_corres=max_corres,
        optimized_matching=optimized_matching)
    return solve(s, d, valid, noise_bound=noise_bound, gnc_factor=gnc_factor,
                 cost_diff_thr=cost_diff_thr, rot_max_iter=rot_max_iter,
                 estimate_scale=estimate_scale)


def solve(s, d, valid, *, noise_bound, gnc_factor, cost_diff_thr,
          rot_max_iter: int = 50, estimate_scale: bool = False
          ) -> QuatroResult:
    """Quatro on one cloud pair's matches (s, d, valid): clique, GNC yaw,
    translation voting and refinement.  The batched registration runs this
    lane by lane after one batched matching pass.  On the card one replay
    of the key's CUDA graph (captured on its first load), whose outputs
    the caller owns."""
    return _load(s, d, valid, noise_bound=noise_bound, gnc_factor=gnc_factor,
                 cost_diff_thr=cost_diff_thr, rot_max_iter=rot_max_iter,
                 estimate_scale=estimate_scale)()


def load_solve(max_corres: int, device, *, noise_bound, gnc_factor,
               cost_diff_thr, rot_max_iter: int = 50,
               estimate_scale: bool = False) -> None:
    """Load ``solve``'s graph for ``max_corres`` matches on ``device`` with
    these settings, on zero matches: on the card the key's capture, so that
    the first solve replays."""
    z = torch.zeros(max_corres, 3, device=device)
    _load(z, z, torch.zeros(max_corres, dtype=torch.bool, device=device),
          noise_bound=noise_bound, gnc_factor=gnc_factor,
          cost_diff_thr=cost_diff_thr, rot_max_iter=rot_max_iter,
          estimate_scale=estimate_scale)


def _load(s, d, valid, *, noise_bound, gnc_factor, cost_diff_thr,
          rot_max_iter, estimate_scale) -> cuda_graph.Graph:
    return _SOLVE_GRAPHS.load(_solve, s, d, valid, noise_bound, gnc_factor,
                              cost_diff_thr, rot_max_iter, estimate_scale)


def _solve(s, d, valid, noise_bound, gnc_factor, cost_diff_thr,
           rot_max_iter, estimate_scale) -> QuatroResult:
    """``solve``'s work: no host read, every constant filled on the
    device."""
    if estimate_scale:
        # scale first, over all matches; the clique runs de-scaled
        scale, _ = estimate_scale_tims(s, d, valid, noise_bound)
        s_eff = s * scale
    else:
        scale = _f32(1.0, s)
        s_eff = s
    inl = max_clique_inliers(s_eff, d, valid, noise_bound)
    yaw, _, rot_ok = gnc_rotation_yaw(s_eff, d, inl, noise_bound, gnc_factor,
                                      cost_diff_thr, max_iter=rot_max_iter)
    t, t_votes = translation_voting(s_eff, d, inl, yaw, noise_bound)
    yaw, t = refine_yaw_translation(s_eff, d, inl, yaw, t, noise_bound)
    e_z = torch.zeros(3, device=s.device)
    e_z[2:].fill_(1.0)
    R = se3.so3_exp(e_z * yaw)
    T = se3.make_pose(R * scale, t)
    n_inl = torch.sum(inl)
    converged = rot_ok & (n_inl >= 3) & (t_votes >= 2)
    return QuatroResult(T, converged, torch.sum(valid),
                        n_inl.to(torch.int32), scale)
