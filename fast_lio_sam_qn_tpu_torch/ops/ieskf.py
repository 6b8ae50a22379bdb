"""Iterated error-state Kalman filter — port of
fast_lio_sam_qn_tpu/ops/ieskf.py: IMU propagation of the 18-dim error state
(dtheta, dp, dv, dbg, dba, dg) with its covariance, backward per-point
motion compensation (deskew) to the scan-end frame, and the iterated
point-to-plane MAP update, against the surfel map's cached planes
(``update_surfel``) or against planes fitted to the k nearest points of the
point map (``update``).  With the LiDAR-IMU extrinsic co-estimated
(FAST-LIO2's ``extrinsic_est_en``) the error state has 24 dims, the
extrinsic's (dphi_li, dt_li) appended: ``propagate`` is shape-generic in P,
and ``update_surfel_ext`` / ``update_ext`` re-associate the planes at the
current pose and extrinsic in every iteration.

Every product is plain fp32 (TF32 is off package-wide), the reference's
``precision="highest"``.  ``propagate`` walks the IMU samples in a Python
loop, as the reference's ``lax.scan``; what does not depend on the state
(bias-corrected rates, step lengths, the per-step rotation increments and
the state-free blocks of the transition) is computed for every sample at
once, with the same arithmetic.  The 18x18 and 24x24 solves and
inverses use the ``_ex`` forms, which skip the host-side error check.  The
plane fits use the struct-of-arrays Jacobi solver (``linalg3.eigh3``), as
the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import hashgrid, linalg3, se3, surfel_map

# error-state layout
_TH, _P, _V, _BG, _BA, _G = 0, 3, 6, 9, 12, 15
STATE_DIM = 18
# the optional LiDAR-IMU extrinsic block, appended so every 18-dim index
# stays valid
_RLI, _TLI = 18, 21
STATE_DIM_EXT = 24


def _ptransform(pts, R, t=None):
    """points @ R^T (+ t)."""
    out = pts @ R.T
    return out if t is None else out + t


class NavState(NamedTuple):
    R: torch.Tensor      # (3, 3) world <- body
    p: torch.Tensor      # (3,)
    v: torch.Tensor      # (3,)
    bg: torch.Tensor     # (3,)
    ba: torch.Tensor     # (3,)
    grav: torch.Tensor   # (3,) world gravity vector


def identity_state(device: torch.device | str,
                   dtype: torch.dtype = torch.float32) -> NavState:
    z = torch.zeros(3, dtype=dtype, device=device)
    grav = torch.zeros(3, dtype=dtype, device=device)
    grav[2] = -9.81
    return NavState(R=torch.eye(3, dtype=dtype, device=device), p=z,
                    v=z.clone(), bg=z.clone(), ba=z.clone(), grav=grav)


def init_covariance(device: torch.device | str,
                    dtype: torch.dtype = torch.float32,
                    est_extrinsic: bool = False) -> torch.Tensor:
    """18x18 filter covariance, or 24x24 with the extrinsic co-estimated
    (its prior: ~1.8 deg rotation / ~3 cm translation std)."""
    var = (1e-4, 1e-4, 1e-2, 1e-4, 1e-3, 1e-3)
    if est_extrinsic:
        var += (1e-3, 1e-3)
    d = torch.cat([torch.full((3,), v, dtype=dtype, device=device)
                   for v in var])
    return torch.diag(d)


class Extrinsic(NamedTuple):
    """LiDAR -> IMU extrinsic: p_body = R @ p_lidar + t."""

    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)


def boxplus_ext(e: Extrinsic, dx6: torch.Tensor) -> Extrinsic:
    """Right-perturbation retraction of the extrinsic block."""
    return Extrinsic(R=se3.compose3(e.R, se3.so3_exp(dx6[:3])),
                     t=e.t + dx6[3:])


def boxplus(s: NavState, dx: torch.Tensor) -> NavState:
    """Right-perturbation state retraction."""
    return NavState(
        R=se3.compose3(s.R, se3.so3_exp(dx[_TH:_TH + 3])),
        p=s.p + dx[_P:_P + 3],
        v=s.v + dx[_V:_V + 3],
        bg=s.bg + dx[_BG:_BG + 3],
        ba=s.ba + dx[_BA:_BA + 3],
        grav=s.grav + dx[_G:_G + 3],
    )


class PropagationLog(NamedTuple):
    """Per-IMU-sample states during the sweep, for backward deskew."""

    t: torch.Tensor      # (K,) sample times
    R: torch.Tensor      # (K, 3, 3)
    p: torch.Tensor      # (K, 3)
    v: torch.Tensor      # (K, 3)
    w: torch.Tensor      # (K, 3) bias-corrected gyro at sample
    valid: torch.Tensor  # (K,)


def _free_blocks(w_c, dt, dim=STATE_DIM):
    """(..., dim, dim) transitions with their state-free blocks: identity,
    Exp(-w dt), -I dt (dtheta/dbg), I dt (dp/dv, dv/dg).  With dim =
    STATE_DIM_EXT the extrinsic block is identity with no coupling."""
    shape = dt.shape
    dev, dtype = dt.device, dt.dtype
    F = torch.eye(dim, dtype=dtype, device=dev).expand(
        shape + (dim, dim)).clone()
    eye_dt = torch.eye(3, dtype=dtype, device=dev) * dt[..., None, None]
    F[..., _TH:_TH + 3, _TH:_TH + 3] = se3.so3_exp(-w_c * dt[..., None])
    F[..., _TH:_TH + 3, _BG:_BG + 3] = -eye_dt
    F[..., _P:_P + 3, _V:_V + 3] = eye_dt
    F[..., _V:_V + 3, _G:_G + 3] = eye_dt
    return F


def _with_state_blocks(F, R, acc_c, dt):
    """Fill the two blocks of the transition that depend on the state's R:
    dv/dtheta = -R hat(a) dt and dv/dba = -R dt."""
    F = F.clone()
    F[_V:_V + 3, _TH:_TH + 3] = -(R @ se3.hat(acc_c)) * dt
    F[_V:_V + 3, _BA:_BA + 3] = -R * dt
    return F


def _step_jacobians(R, acc_c, w_c, dt, dim=STATE_DIM):
    """Error-state transition F (dim x dim) for one IMU step (right-
    perturbation local error; standard ESKF discrete forms)."""
    return _with_state_blocks(_free_blocks(w_c, dt, dim), R, acc_c, dt)


def _process_noise(noise, dt, dim=STATE_DIM):
    """(..., dim) diagonal of Q for steps of length dt; with dim =
    STATE_DIM_EXT noise entries 4 and 5 are the extrinsic's random walk
    (rotation rad^2/s, translation m^2/s)."""
    z = torch.zeros(dt.shape + (3,), dtype=dt.dtype, device=dt.device)
    n_blk = 6 if dim == STATE_DIM_EXT else 4
    blk = [noise[i] * dt[..., None].expand(dt.shape + (3,))
           for i in range(n_blk)]
    return torch.cat([blk[0], z, blk[1], blk[2], blk[3], z] + blk[4:],
                     dim=-1)


def propagate(state: NavState, P, imu_t, gyro, acc, imu_mask, t_start, t_end,
              noise):
    """Forward-propagate through the scan's IMU samples (padded, masked):
    returns the state at t_end, its covariance and the per-sample pose log
    for deskew.  noise (4,) = [gyr_cov, acc_cov, b_gyr_cov, b_acc_cov];
    with a 24x24 P (the extrinsic co-estimated), (6,) with the extrinsic's
    random walk (rotation, translation) appended.  Shape-generic in P: the
    extrinsic block and its cross-covariances ride through F P F^T."""
    k = imu_t.shape[0]
    dev = P.device
    dim = P.shape[0]
    # the state-free part of every step, for all samples at once: the
    # biases and gravity are constant during propagation, and each step's
    # previous time is the last valid sample's (t_start before any)
    w_c = gyro - state.bg
    a_c = acc - state.ba
    idx = torch.arange(k, device=dev)
    last = torch.cummax(torch.where(imu_mask, idx, -1), dim=0).values
    t_out = torch.where(last >= 0, imu_t[torch.clamp(last, min=0)], t_start)
    t_prev = torch.cat([t_start.reshape(1), t_out[:-1]])
    dt = torch.where(imu_mask, torch.clamp(imu_t - t_prev, min=0.0), 0.0)
    rot = se3.so3_exp(w_c * dt[:, None])
    F_free = _free_blocks(w_c, dt, dim)
    Qd = torch.diag_embed(_process_noise(noise, dt, dim))

    R, p, v, Pc = state.R, state.p, state.v, P
    lR, lp, lv = [], [], []
    for i in range(k):
        m_i, dt_i = imu_mask[i], dt[i]
        a_w = R @ a_c[i] + state.grav
        R_new = se3.compose3(R, rot[i])
        p_new = p + v * dt_i + 0.5 * a_w * dt_i * dt_i
        v_new = v + a_w * dt_i
        F = _with_state_blocks(F_free[i], R, a_c[i], dt_i)
        P_new = F @ Pc @ F.T + Qd[i]
        R = torch.where(m_i, R_new, R)
        p = torch.where(m_i, p_new, p)
        v = torch.where(m_i, v_new, v)
        Pc = torch.where(m_i, P_new, Pc)
        lR.append(R)
        lp.append(p)
        lv.append(v)
    t_last = t_out[-1]
    # tail: propagate from the last sample to t_end with the last
    # measurement; with no valid sample (IMU dropout) keep a constant
    # velocity and no rotation instead of integrating raw gravity
    any_imu = torch.any(imu_mask)
    last_i = torch.clamp(torch.sum(imu_mask.to(torch.int64)) - 1,
                         min=0).reshape(1)
    dt_tail = torch.clamp(t_end - t_last, min=0.0)
    wt = torch.where(any_imu, gyro.index_select(0, last_i)[0] - state.bg, 0.0)
    at = torch.where(any_imu, acc.index_select(0, last_i)[0] - state.ba, 0.0)
    a_w = torch.where(any_imu, R @ at + state.grav, 0.0)
    s_end = NavState(
        R=se3.compose3(R, se3.so3_exp(wt * dt_tail)),
        p=p + v * dt_tail + 0.5 * a_w * dt_tail * dt_tail,
        v=v + a_w * dt_tail,
        bg=state.bg, ba=state.ba, grav=state.grav,
    )
    F = _step_jacobians(R, at, wt, dt_tail, dim)
    P_end = F @ Pc @ F.T + torch.diag(_process_noise(noise, dt_tail, dim))
    log = PropagationLog(t=t_out, R=torch.stack(lR), p=torch.stack(lp),
                         v=torch.stack(lv), w=w_c, valid=imu_mask)
    return s_end, P_end, log


def deskew(points_l, rel_t, mask, log: PropagationLog, state_end: NavState,
           t_start, R_li, t_li):
    """Motion-compensate points to the scan-end body (IMU) frame:
    q_i = R_end^T (R(t_i) (R_li p_i + t_li) + p(t_i) - p_end), with R(t),
    p(t) from the propagation log (constant velocity and gyro within an
    IMU interval)."""
    t_abs = t_start + rel_t
    k = log.t.shape[0]
    ar = torch.arange(k, device=rel_t.device)
    # the latest valid sample at or before each point (-1: none)
    le = log.valid[None, :] & (log.t[None, :] <= t_abs[:, None])
    idx = torch.amax(torch.where(le, ar[None, :], -1), dim=1)
    has_prev = idx >= 0
    # points before the first valid sample take its pose with dt = 0
    first_valid = torch.argmax(log.valid.to(torch.int32))
    idx = torch.where(has_prev, torch.clamp(idx, min=0), first_valid)
    any_valid = torch.any(log.valid)
    t_i = torch.where(has_prev, log.t[idx], t_abs)
    dt = torch.clamp(t_abs - t_i, min=0.0)
    # rotate forward with the gyro of the interval the point falls in: the
    # next valid sample's (past the last sample, the last one's)
    gt = log.valid[None, :] & (log.t[None, :] > t_abs[:, None])
    nidx = torch.amin(torch.where(gt, ar[None, :], k), dim=1)
    has_next = nidx < k
    Rk, pk, vk = log.R[idx], log.p[idx], log.v[idx]
    wk = torch.where(has_next[:, None],
                     log.w[torch.clamp(nidx, max=k - 1)], log.w[idx])
    R_t = Rk @ se3.so3_exp(wk * dt[:, None])
    p_t = pk + vk * dt[:, None]
    p_b = _ptransform(points_l, R_li, t_li)
    p_w = (R_t @ p_b[:, :, None])[:, :, 0] + p_t
    q = (p_w - state_end.p) @ state_end.R                 # R^T x
    # no IMU in the scan: no deskew
    q = torch.where(any_valid, q, p_b)
    return torch.where(mask[:, None], q, 0.0)


def _pose_rows(pts_b, s: NavState, n):
    """Point-to-plane measurement rows, pose block only:
    [(q x (R^T n))^T | n^T] under a right perturbation on R."""
    Rtn = n @ s.R
    return torch.cat([torch.linalg.cross(pts_b, Rtn, dim=-1), n], dim=-1)


def _normal_blocks(h6, w):
    """18x18 A with H^T W H in its 6x6 pose block."""
    A6 = (h6 * w[:, None]).T @ h6
    A = torch.zeros((STATE_DIM, STATE_DIM), dtype=h6.dtype, device=h6.device)
    A[:6, :6] = A6
    return A


def _gn_step(s, dx_acc, pts_b, n, resid, w, Pinv):
    """One MAP Gauss-Newton step: A = H^T W H, b = H^T W r, plus the prior
    term minimizing ||dx_acc + dx||_Pinv."""
    h6 = _pose_rows(pts_b, s, n)
    A = _normal_blocks(h6, w)
    b = torch.zeros(STATE_DIM, dtype=h6.dtype, device=h6.device)
    b[:6] = (resid * w) @ h6
    rhs = -(b + Pinv @ dx_acc)
    dx = torch.linalg.solve_ex(A + Pinv, rhs[:, None])[0][:, 0]
    return boxplus(s, dx), dx_acc + dx


def _posterior_cov(s_fin, pts_b, n, w, Pinv):
    """Posterior covariance of the MAP estimate at the converged state."""
    A = _normal_blocks(_pose_rows(pts_b, s_fin, n), w)
    P_new = torch.linalg.inv_ex(A + Pinv)[0]
    return 0.5 * (P_new + P_new.T)


def update_surfel(state: NavState, P, smap: surfel_map.SurfelMap, pts_b,
                  mask, meas_var: float, max_iter: int = 3, window: int = 1):
    """Iterated point-to-plane MAP update against the cached surfel planes:
    the plane association is made once, at the propagated state (window 1:
    own voxel, halo-backed; 3: the 27-hood), and held across the
    Gauss-Newton steps, whose residuals n.p_w(x) + d are re-evaluated.
    Returns (state, P, num_matches)."""
    eye = torch.eye(STATE_DIM, dtype=P.dtype, device=P.device)
    Pinv = torch.linalg.inv_ex(P + 1e-9 * eye)[0]
    pts_w0 = _ptransform(pts_b, state.R, state.p)
    n, resid0, valid = surfel_map.query_planes(smap, pts_w0, mask,
                                               window=window)
    d_plane = resid0 - torch.sum(n * pts_w0, dim=-1)
    w = valid.to(P.dtype) / meas_var
    s = state
    dx_acc = torch.zeros(STATE_DIM, dtype=P.dtype, device=P.device)
    for _ in range(max_iter):
        pts_w = _ptransform(pts_b, s.R, s.p)
        resid = torch.sum(n * pts_w, dim=-1) + d_plane
        s, dx_acc = _gn_step(s, dx_acc, pts_b, n, resid, w, Pinv)
    P_new = _posterior_cov(s, pts_b, n, w, Pinv)
    return s, P_new, torch.sum(valid.to(torch.int32))


# ---------------------------------------------------------------------------
# the point-map backend: planes fitted to the k nearest map points
# ---------------------------------------------------------------------------

def _plane_correspondences(grid: hashgrid.HashGrid, pts_w, mask, plane_k: int,
                           plane_threshold: float, window: int = 3):
    """For each world point, a plane fitted to its plane_k nearest map
    points (the smallest-eigenvalue direction of their scatter).  Valid
    where all plane_k neighbours exist and lie within plane_threshold of
    the plane.  Returns (normal (N, 3), n.p + d (N,), valid (N,))."""
    nn_pts, _, nn_valid = hashgrid.query_knn(grid, pts_w, mask, k=plane_k,
                                             window=window)
    w = nn_valid.to(pts_w.dtype)
    cnt = torch.sum(w, dim=-1)
    mean = torch.sum(nn_pts * w[..., None], dim=-2) / torch.clamp(
        cnt, min=1.0)[..., None]
    d = (nn_pts - mean[..., None, :]) * w[..., None]
    _, vecs = linalg3.eigh3(d.transpose(-1, -2) @ d)
    n = vecs[..., :, 0]
    d0 = -torch.sum(n * mean, dim=-1)
    fit_res = torch.abs((nn_pts @ n[..., None])[..., 0] + d0[:, None])
    good_fit = torch.all(torch.where(nn_valid, fit_res < plane_threshold,
                                     True), dim=-1)
    valid = mask & (cnt >= plane_k) & good_fit
    return n, torch.sum(n * pts_w, dim=-1) + d0, valid


def update(state: NavState, P, grid: hashgrid.HashGrid, pts_b, mask,
           meas_var: float, plane_threshold: float, max_iter: int = 3,
           plane_k: int = 5, window: int = 3):
    """Iterated point-to-plane MAP update against the point map: the plane
    correspondences are searched again at every Gauss-Newton step, and once
    more at the converged state for the posterior covariance and the match
    count.  Returns (state, P, num_matches)."""
    eye = torch.eye(STATE_DIM, dtype=P.dtype, device=P.device)
    Pinv = torch.linalg.inv_ex(P + 1e-9 * eye)[0]

    def associate(s):
        return _plane_correspondences(grid, _ptransform(pts_b, s.R, s.p),
                                      mask, plane_k, plane_threshold, window)

    s = state
    dx_acc = torch.zeros(STATE_DIM, dtype=P.dtype, device=P.device)
    for _ in range(max_iter):
        n, resid, valid = associate(s)
        w = valid.to(P.dtype) / meas_var
        s, dx_acc = _gn_step(s, dx_acc, pts_b, n, resid, w, Pinv)
    n, _, valid = associate(s)
    w = valid.to(P.dtype) / meas_var
    P_new = _posterior_cov(s, pts_b, n, w, Pinv)
    return s, P_new, torch.sum(valid.to(torch.int32))


# ---------------------------------------------------------------------------
# online LiDAR-IMU extrinsic co-estimation: the 24-dim error state appends
# (dphi_li, dt_li), and the measurement model p_w = R (R_li p_l + t_li) + p
# runs over the deskewed scan in the scan-end LiDAR frame
# ---------------------------------------------------------------------------

def _pose_ext_rows(pts_l, p_b, s: NavState, ext: Extrinsic, n):
    """Point-to-plane rows over the [pose (6) | extrinsic (6)] columns of
    r = n . (R (R_li p_l + t_li) + p) + d under right perturbations:
    [(p_b x R^T n)^T | n^T | (p_l x R_li^T R^T n)^T | (R^T n)^T]."""
    Rtn = n @ s.R
    Rlitn = Rtn @ ext.R
    return torch.cat([torch.linalg.cross(p_b, Rtn, dim=-1), n,
                      torch.linalg.cross(pts_l, Rlitn, dim=-1), Rtn], dim=-1)


def _scatter_ext_blocks(A12, b12):
    """The dense 12x12 normal equations in the 24-dim layout: columns 0:6
    pose, 18:24 extrinsic; the velocity, bias and gravity rows are zero."""
    A = torch.zeros((STATE_DIM_EXT, STATE_DIM_EXT), dtype=A12.dtype,
                    device=A12.device)
    A[:6, :6] = A12[:6, :6]
    A[:6, _RLI:] = A12[:6, 6:]
    A[_RLI:, :6] = A12[6:, :6]
    A[_RLI:, _RLI:] = A12[6:, 6:]
    b = torch.zeros(STATE_DIM_EXT, dtype=A12.dtype, device=A12.device)
    b[:6] = b12[:6]
    b[_RLI:] = b12[6:]
    return A, b


def _gn_step_ext(s, ext, dx_acc, pts_l, p_b, n, resid, w, Pinv):
    """One MAP Gauss-Newton step of the 24-dim state (as ``_gn_step``)."""
    h12 = _pose_ext_rows(pts_l, p_b, s, ext, n)
    A, b = _scatter_ext_blocks((h12 * w[:, None]).T @ h12,
                               (resid * w) @ h12)
    rhs = -(b + Pinv @ dx_acc)
    dx = torch.linalg.solve_ex(A + Pinv, rhs[:, None])[0][:, 0]
    return (boxplus(s, dx[:STATE_DIM]), boxplus_ext(ext, dx[_RLI:]),
            dx_acc + dx)


def _posterior_cov_ext(s_fin, ext_fin, pts_l, n, w, Pinv):
    p_b = _ptransform(pts_l, ext_fin.R, ext_fin.t)
    h12 = _pose_ext_rows(pts_l, p_b, s_fin, ext_fin, n)
    A, _ = _scatter_ext_blocks((h12 * w[:, None]).T @ h12,
                               torch.zeros(12, dtype=w.dtype,
                                           device=w.device))
    P_new = torch.linalg.inv_ex(A + Pinv)[0]
    return 0.5 * (P_new + P_new.T)


def _update_ext(state, ext, P, pts_l, meas_var, max_iter, associate):
    """The iterated update of the 24-dim state; ``associate(p_w) -> (n,
    resid, valid)`` searches the planes at the current pose and extrinsic,
    every iteration and once more at the converged state."""
    eye = torch.eye(STATE_DIM_EXT, dtype=P.dtype, device=P.device)
    Pinv = torch.linalg.inv_ex(P + 1e-9 * eye)[0]

    def step(s, e):
        p_b = _ptransform(pts_l, e.R, e.t)
        return (p_b,) + associate(_ptransform(p_b, s.R, s.p))

    s, e = state, ext
    dx_acc = torch.zeros(STATE_DIM_EXT, dtype=P.dtype, device=P.device)
    for _ in range(max_iter):
        p_b, n, resid, valid = step(s, e)
        w = valid.to(P.dtype) / meas_var
        s, e, dx_acc = _gn_step_ext(s, e, dx_acc, pts_l, p_b, n, resid, w,
                                    Pinv)
    _, n, _, valid = step(s, e)
    w = valid.to(P.dtype) / meas_var
    P_new = _posterior_cov_ext(s, e, pts_l, n, w, Pinv)
    return s, e, P_new, torch.sum(valid.to(torch.int32))


def update_surfel_ext(state: NavState, ext: Extrinsic, P,
                      smap: surfel_map.SurfelMap, pts_l, mask,
                      meas_var: float, max_iter: int = 3, window: int = 1):
    """``update_surfel`` with the extrinsic co-estimated: (N, 3) ``pts_l``
    the deskewed scan in the scan-end LiDAR frame, P 24x24.  Unlike
    ``update_surfel`` the planes are associated again in every iteration:
    calibration transients move points by several voxels, and a fixed wrong
    association would collapse the extrinsic covariance onto a wrong
    estimate.  Returns (state, ext, P, num_matches)."""
    return _update_ext(
        state, ext, P, pts_l, meas_var, max_iter,
        lambda p_w: surfel_map.query_planes(smap, p_w, mask, window=window))


def update_ext(state: NavState, ext: Extrinsic, P, grid: hashgrid.HashGrid,
               pts_l, mask, meas_var: float, plane_threshold: float,
               max_iter: int = 3, plane_k: int = 5, window: int = 3):
    """``update`` (the point map) with the extrinsic co-estimated.
    Returns (state, ext, P, num_matches)."""
    return _update_ext(
        state, ext, P, pts_l, meas_var, max_iter,
        lambda p_w: _plane_correspondences(grid, p_w, mask, plane_k,
                                           plane_threshold, window))
