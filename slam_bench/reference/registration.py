"""The loop closure's registration as its published steps define it, written
plainly over all pairwise distances (``torch.cdist``): radius features
(Rusu et al., ICRA 2009, as PCL computes FPFH), mutual nearest-neighbour
matching, Quatro's coarse solve (Lim et al., ICRA 2022) and GICP with plane
covariances (Segal et al., RSS 2009; Koide et al.'s Nano-GICP), in whatever
floating type the caller's tensors carry (float64 for the reference, where
TF32 does not apply; float32 with TF32 products for its control).

1. Surface: each point's neighbours within a radius (itself included);
   the normal is the covariance's smallest eigenvector, turned toward the
   viewpoint (kept where the count is at least 3); the plane covariance
   is V diag(1e-3, 1, 1) V^T of the covariance at the covariance radius.
   The covariance is formed from centred differences: no raw second
   moments.
2. SPFH: for each neighbour q != p within the feature radius, with
   d = (q - p) / |q - p|, u = n_p, v = d x u / |d x u|, w = u x v: alpha =
   v . n_q, phi = u . d, theta = atan2(w . n_q, u . n_q), each binned in 11
   equal bins over [-1, 1], [-1, 1], [-pi, pi], divided by the neighbour
   count.
3. FPFH: SPFH(p) + (1 / k) sum_q SPFH(q) / |p - q| over the same
   neighbours, each 11-bin block scaled to sum 100; a row counts with a
   normal and at least 3 feature neighbours.
4. Distinctiveness: a row is kept where the mean of its blocks' largest
   bins is below the planarity threshold.
5. Matching: each source row's nearest target row in descriptor space and
   back; mutual pairs within the spatial gate, the closest ``max_corres``
   in descriptor distance (index order among ties).
6. Quatro: the compatibility graph | |s_i - s_j| - |d_i - d_j| | <= 2
   noise_bound, its clique, GNC-TLS yaw over the clique's translation-
   invariant measurements, component-wise translation voting, a
   reweighted yaw and translation refinement.
7. GICP: from the identity, Gauss-Newton on sum r^T (C_d + R C_s R^T)^-1
   r over each source point's nearest target point within the
   correspondence distance, T <- Exp(xi) T, until a step is below the
   tolerance.

Departures, each the port's definition where the papers leave a choice
(the reference judges the same registration, not another): the clique is
Quatro's approximate one (replicator dynamics, then a greedy pass in
support order) and not PMC's exact maximum clique; the translation-
invariant measurements pair each clique member with the next one and the
one after (a ring), not every pair; the rotation is a yaw (Quatro's
quasi-SO(3)); GICP's normal equations are damped by 1e-6 of their
diagonal.  Nothing here imports the port.
"""
from __future__ import annotations

import math

import torch

from . import geometry as G

NBINS = 11
DIM = 3 * NBINS
PLANE_EPS = 1e-3
CHUNK = 256           # query rows a pass of the pairwise forms


def _pairs(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(Q, N) squared distances."""
    return torch.cdist(q, p) ** 2


def surface(points, mask, viewpoint, normal_radius: float,
            cov_radius: float):
    """(normals (N, 3), n_valid (N,), plane covariances (N, 3, 3),
    cov_valid (N,)) of one cloud; neighbours are the masked points."""
    n = points.shape[0]
    dt = points.dtype
    normals = torch.zeros_like(points)
    covs = torch.eye(3, dtype=dt, device=points.device).repeat(n, 1, 1)
    n_cnt = torch.zeros(n, dtype=dt, device=points.device)
    c_cnt = torch.zeros_like(n_cnt)
    db = points[mask]
    for s in range(0, n, CHUNK):
        q = points[s:s + CHUNK]
        d2 = _pairs(q, db)
        for r, which in ((normal_radius, 0), (cov_radius, 1)):
            w = (d2 <= r * r).to(dt)
            cnt = w.sum(1)
            mean = (w @ db) / cnt.clamp(min=1)[:, None]
            diff = db[None] - mean[:, None]
            cov = torch.einsum("qn,qni,qnj->qij", w, diff, diff) \
                / cnt.clamp(min=1)[:, None, None]
            _, vec = torch.linalg.eigh(cov)
            if which == 0:
                nrm = vec[..., 0]
                flip = ((viewpoint[None] - q) * nrm).sum(-1) < 0
                normals[s:s + CHUNK] = torch.where(flip[:, None], -nrm, nrm)
                n_cnt[s:s + CHUNK] = cnt
            else:
                reg = torch.tensor([PLANE_EPS, 1.0, 1.0], dtype=dt,
                                   device=points.device)
                covs[s:s + CHUNK] = torch.einsum("qij,j,qkj->qik", vec, reg,
                                                 vec)
                c_cnt[s:s + CHUNK] = cnt
    n_valid = mask & (n_cnt >= 3)
    normals = torch.where(n_valid[:, None], normals, 0.0)
    cov_valid = n_valid & (c_cnt >= 3)
    eye = torch.eye(3, dtype=dt, device=points.device)
    covs = torch.where(cov_valid[:, None, None], covs, eye)
    return normals, n_valid, covs, cov_valid


def _bins(vals, lo: float, hi: float):
    return ((vals - lo) / (hi - lo) * NBINS).floor().clamp(0, NBINS - 1) \
        .long()


def fpfh(points, mask, viewpoint, normal_radius: float,
         feature_radius: float, cov_radius: float):
    """(desc (N, 33), valid (N,), normals, n_valid, covs, cov_valid) of
    one cloud."""
    normals, n_valid, covs, cov_valid = surface(
        points, mask, viewpoint, normal_radius, cov_radius)
    n = points.shape[0]
    dt = points.dtype
    keep = torch.nonzero(mask & n_valid).flatten()
    db, dbn = points[keep], normals[keep]
    r2 = feature_radius * feature_radius
    spfh = torch.zeros(n, DIM, dtype=dt, device=points.device)
    cnt = torch.zeros(n, dtype=dt, device=points.device)
    tiny = torch.finfo(dt).tiny
    for s in range(0, n, CHUNK):
        q, u = points[s:s + CHUNK], normals[s:s + CHUNK]
        rows = torch.arange(s, s + q.shape[0], device=points.device)
        dvec = db[None] - q[:, None]
        d2 = _pairs(q, db)
        w = (d2 <= r2) & (rows[:, None] != keep[None])
        d = dvec / d2.clamp(min=tiny).sqrt()[..., None]
        uu = u[:, None].expand_as(d)
        v = torch.linalg.cross(d, uu, dim=-1)
        v = v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp(min=tiny)
        ww = torch.linalg.cross(uu, v, dim=-1)
        nq = dbn[None].expand_as(d)
        alpha = (v * nq).sum(-1)
        phi = (uu * d).sum(-1)
        theta = torch.atan2((ww * nq).sum(-1), (uu * nq).sum(-1))
        wf = w.to(dt)
        h = torch.zeros(q.shape[0], DIM, dtype=dt, device=points.device)
        for k, (vals, lo, hi) in enumerate(((alpha, -1.0, 1.0),
                                            (phi, -1.0, 1.0),
                                            (theta, -math.pi, math.pi))):
            # a pair that does not count (the point itself) bins at 0
            bins = torch.where(w, _bins(torch.nan_to_num(vals), lo, hi), 0)
            h.scatter_add_(1, bins + k * NBINS, wf)
        spfh[s:s + CHUNK] = h
        cnt[s:s + CHUNK] = wf.sum(1)
    spfh_n = spfh / cnt.clamp(min=1)[:, None]
    agg = torch.zeros_like(spfh)
    for s in range(0, n, CHUNK):
        q = points[s:s + CHUNK]
        rows = torch.arange(s, s + q.shape[0], device=points.device)
        d2 = _pairs(q, db)
        w = (d2 <= r2) & (rows[:, None] != keep[None])
        inv = torch.where(w, 1 / d2.clamp(min=1e-12).sqrt(), 0.0)
        agg[s:s + CHUNK] = (inv @ spfh_n[keep]) \
            / w.sum(1).clamp(min=1)[:, None].to(dt)
    fp = spfh_n + agg
    blocks = fp.reshape(n, 3, NBINS)
    desc = (100 * blocks / blocks.sum(-1, keepdim=True).clamp(min=1e-9)) \
        .reshape(n, DIM)
    valid = n_valid & (cnt >= 3)
    desc = torch.where(valid[:, None], desc, 0.0)
    return desc, valid, normals, n_valid, covs, cov_valid


def distinctive(desc, valid, planarity_threshold: float):
    """Rows whose blocks' largest bins average below the threshold."""
    top = desc.reshape(desc.shape[0], 3, NBINS).amax(-1).mean(-1)
    return valid & (top < planarity_threshold)


def _nearest(a, a_ok, b, b_ok):
    """Each row of a's nearest valid row of b: (squared distance, index)."""
    best = torch.full((a.shape[0],), math.inf, dtype=a.dtype,
                      device=a.device)
    idx = torch.full((a.shape[0],), -1, dtype=torch.long, device=a.device)
    cols = torch.nonzero(b_ok).flatten()
    if cols.numel() == 0:
        return best, idx
    for s in range(0, a.shape[0], CHUNK):
        d2 = _pairs(a[s:s + CHUNK], b[cols])
        m, j = d2.min(1)
        best[s:s + CHUNK] = m
        idx[s:s + CHUNK] = cols[j]
    best = torch.where(a_ok, best, math.inf)
    idx = torch.where(a_ok, idx, -1)
    return best, idx


def match(src, desc_s, ok_s, dst, desc_d, ok_d, distance_threshold: float,
          max_corres: int):
    """Mutual nearest neighbours in descriptor space within the spatial
    gate, the closest ``max_corres``: (s (C, 3), d (C, 3), valid (C,))."""
    d2, j = _nearest(desc_s, ok_s, desc_d, ok_d)
    _, back = _nearest(desc_d, ok_d, desc_s, ok_s)
    rows = torch.arange(src.shape[0], device=src.device)
    jj = j.clamp(min=0)
    ok = ok_s & (j >= 0) & (back[jj] == rows)
    ok &= torch.linalg.norm(src - dst[jj], dim=-1) <= distance_threshold
    score = torch.where(ok, d2, math.inf)
    order = torch.sort(score, stable=True).indices[:max_corres]
    valid = torch.isfinite(score[order])
    s, d = src[order], dst[jj[order]]
    pad = max_corres - order.numel()
    if pad > 0:
        s = torch.cat([s, s.new_zeros(pad, 3)])
        d = torch.cat([d, d.new_zeros(pad, 3)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return s, d, valid


def clique(s, d, valid, noise_bound: float, iters: int = 64,
           greedy_cap: int = 256):
    """The compatibility graph's clique: replicator dynamics from the
    uniform weight on the valid matches, then a greedy pass in descending
    weight over the ``greedy_cap`` heaviest, keeping a match compatible
    with every one kept before it."""
    c = s.shape[0]
    ds = torch.cdist(s, s)
    dd = torch.cdist(d, d)
    eye = torch.eye(c, dtype=torch.bool, device=s.device)
    A = ((ds - dd).abs() <= 2 * noise_bound) & valid[:, None] \
        & valid[None] & ~eye
    Af = A.to(s.dtype)
    x = valid.to(s.dtype)
    x = x / x.sum().clamp(min=1)
    for _ in range(iters):
        num = x * (Af @ x)
        x = num / num.sum().clamp(min=1e-12)
    order = torch.sort(-x, stable=True).indices[:greedy_cap]
    kept = torch.zeros(c, dtype=torch.bool, device=s.device)
    for v in order.tolist():
        if bool(valid[v]) and bool(A[v][kept].all()):
            kept[v] = True
    return kept


def _ring(s, d, inliers, strides):
    """Translation-invariant measurements: clique member k against member
    (k + r) mod m, for each stride r, over the m members in index order."""
    idx = torch.nonzero(inliers).flatten()
    m = idx.numel()
    vs, ws = [], []
    for r in strides:
        if m < r + 1:
            continue
        nxt = idx[(torch.arange(m, device=s.device) + r) % m]
        vs.append(s[idx] - s[nxt])
        ws.append(d[idx] - d[nxt])
    if not vs:
        return s.new_zeros(0, 3), s.new_zeros(0, 3)
    return torch.cat(vs), torch.cat(ws)


def gnc_yaw(s, d, inliers, noise_bound: float, gnc_factor: float,
            cost_diff_thr: float, max_iter: int):
    """GNC-TLS yaw over the ring measurements (strides 1 and 2): (yaw,
    converged)."""
    v, w = _ring(s, d, inliers, (1, 2))
    keep = torch.linalg.norm(v[:, :2], dim=-1) > 1e-3
    v, w = v[keep, :2], w[keep, :2]
    cbar2 = (2 * noise_bound) ** 2

    def solve(wt):
        a = (wt * (v[:, 0] * w[:, 0] + v[:, 1] * w[:, 1])).sum()
        b = (wt * (v[:, 0] * w[:, 1] - v[:, 1] * w[:, 0])).sum()
        return torch.atan2(b, a)

    def res2(yaw):
        c, sn = torch.cos(yaw), torch.sin(yaw)
        rx = c * v[:, 0] - sn * v[:, 1] - w[:, 0]
        ry = sn * v[:, 0] + c * v[:, 1] - w[:, 1]
        return rx * rx + ry * ry

    wt = torch.ones(v.shape[0], dtype=s.dtype, device=s.device)
    yaw = solve(wt)
    r2max = res2(yaw).max() if v.shape[0] else s.new_zeros(())
    mu = (cbar2 / (2 * r2max - cbar2).clamp(min=1e-9)).clamp(min=1e-6)
    prev = math.inf
    for _ in range(max_iter):
        r2 = res2(yaw)
        ub = (mu + 1) / mu * cbar2
        lb = mu / (mu + 1) * cbar2
        wt = torch.where(r2 >= ub, 0.0, torch.where(
            r2 <= lb, 1.0,
            torch.sqrt(cbar2 * mu * (mu + 1) / r2.clamp(min=1e-12)) - mu))
        wt = wt.clamp(0, 1)
        yaw = solve(wt)
        cost = float((wt * res2(yaw).clamp(max=cbar2)).sum())
        mu = mu * gnc_factor
        if abs(cost - prev) < cost_diff_thr:
            break
        prev = cost
    return yaw, int((wt > 0.5).sum()) >= 3


def _rot_yaw(yaw, p):
    c, sn = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([c * p[:, 0] - sn * p[:, 1],
                        sn * p[:, 0] + c * p[:, 1], p[:, 2]], -1)


def vote_translation(s, d, inliers, yaw, noise_bound: float):
    """Per axis, the window of half-width noise_bound around a candidate
    holding the most candidates, averaged: (t (3,), least votes)."""
    cand = (d - _rot_yaw(yaw, s))[inliers]
    t, votes = [], []
    for k in range(3):
        x = cand[:, k]
        within = (x[:, None] - x[None]).abs() <= noise_bound
        counts = within.sum(1)
        if counts.numel() == 0:
            t.append(s.new_zeros(()))
            votes.append(0)
            continue
        best = int(torch.argmax(counts))
        t.append(x[within[best]].mean())
        votes.append(int(counts[best]))
    return torch.stack(t), min(votes)


def refine(s, d, inliers, yaw, t, noise_bound: float, iters: int = 4):
    """Reweighted 2D Procrustes over the clique pairs within 2 noise_bound
    of the current estimate (kept where fewer than 3 qualify)."""
    for _ in range(iters):
        r = torch.linalg.norm(_rot_yaw(yaw, s) + t[None] - d, dim=-1)
        w = (inliers & (r < 2 * noise_bound)).to(s.dtype)
        if float(w.sum()) < 3:
            continue
        ms = (s * w[:, None]).sum(0) / w.sum()
        md = (d * w[:, None]).sum(0) / w.sum()
        sc, dc = s - ms, d - md
        a = (w * (sc[:, 0] * dc[:, 0] + sc[:, 1] * dc[:, 1])).sum()
        b = (w * (sc[:, 0] * dc[:, 1] - sc[:, 1] * dc[:, 0])).sum()
        yaw = torch.atan2(b, a)
        t = md - _rot_yaw(yaw[None], ms[None])[0]
    return yaw, t


def quatro(s, d, valid, noise_bound: float, gnc_factor: float,
           cost_diff_thr: float, max_iter: int):
    """Quatro on one pair's matches: (T (4, 4), converged)."""
    inl = clique(s, d, valid, noise_bound)
    yaw, rot_ok = gnc_yaw(s, d, inl, noise_bound, gnc_factor, cost_diff_thr,
                          max_iter)
    t, votes = vote_translation(s, d, inl, yaw, noise_bound)
    yaw, t = refine(s, d, inl, yaw, t, noise_bound)
    R = G.exp_so3(torch.stack([yaw * 0, yaw * 0, yaw]))
    return G.pose(R, t), rot_ok and int(inl.sum()) >= 3 and votes >= 2


def gicp(src, src_ok, src_cov, dst, dst_ok, dst_cov, max_iter: int,
         max_corr_dist: float, trans_eps: float, damping: float = 1e-6):
    """GICP from the identity over the source points ``src_ok`` and the
    target points ``dst_ok``: (T (4, 4), iterations)."""
    T = torch.eye(4, dtype=src.dtype, device=src.device)
    ys, Cs = src[src_ok], src_cov[src_ok]
    for it in range(1, max_iter + 1):
        R = T[:3, :3]
        y = ys @ R.T + T[:3, 3]
        d2, j = _nearest(y, torch.ones(y.shape[0], dtype=torch.bool,
                                       device=y.device), dst, dst_ok)
        corr = d2 < max_corr_dist ** 2
        jj = j.clamp(min=0)
        M = torch.linalg.inv(dst_cov[jj] + R @ Cs @ R.T)
        r = dst[jj] - y
        J = torch.cat([G.hat(y), -torch.eye(3, dtype=y.dtype,
                                            device=y.device).expand(
            y.shape[0], 3, 3)], -1)
        w = corr.to(y.dtype)
        H = torch.einsum("nai,nab,nbj,n->ij", J, M, J, w)
        b = torch.einsum("nai,nab,nb,n->i", J, M, r, w)
        H = H + damping * torch.diag(torch.diagonal(H).clamp(min=1e-6))
        xi = torch.linalg.solve(H, -b)
        T = G.exp_se3(xi) @ T
        if float(torch.linalg.norm(xi)) < trans_eps:
            break
    return T, it
