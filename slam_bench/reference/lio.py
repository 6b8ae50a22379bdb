"""One scan of the LiDAR-inertial filter as the configurations define it
(FAST-LIO's iterated error-state Kalman filter with a surfel map), written
plainly, in the floating type of the state it is given:

1. keep the points beyond the blind range, every ``point_filter_num``-th
   one, and of those the first of each ``filter_size_surf`` voxel;
2. propagate the 18-dim error state (rotation, position, velocity, gyro
   and accelerometer biases, gravity) through the IMU samples and on to
   the scan's end;
3. move every point to the scan-end body frame with the pose of its own
   time (constant velocity and rate between IMU samples);
4. three Gauss-Newton steps of the point-to-plane MAP problem against the
   planes the map caches for the points' voxels at the propagated pose;
   the posterior covariance at the result;
5. drop the map's voxels beyond 1.5 x ``det_range``, insert the scan.

A scan starts from a given state: the filter's and its map.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import geometry as G
from . import surfels

DIM = 18
MEAS_VAR = 0.0025        # the point-to-plane noise variance (m^2)


class State(NamedTuple):
    R: torch.Tensor      # world <- body
    p: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    grav: torch.Tensor
    P: torch.Tensor      # (18, 18), order (R, p, v, bg, ba, grav)
    map: surfels.Map


class Scan(NamedTuple):
    state: State
    body: torch.Tensor   # (N, 3) the kept points in the scan-end body frame
    mask: torch.Tensor   # (N,)


def preprocess(pts, mask, cfg: dict):
    """The kept points' rows, ordered by their voxel's hash: the order in
    which the map's caps take rows."""
    n = pts.shape[0]
    idx = torch.arange(n, device=pts.device)
    keep = mask & ((pts.double() ** 2).sum(-1) > cfg["blind"] ** 2)
    keep &= idx % cfg["point_filter_num"] == 0
    k = idx[keep]
    c = G.voxel_of(pts[k].double(), cfg["filter_size_surf"])
    u, inv = torch.unique(G.pack(c), return_inverse=True)
    first = torch.full((u.numel(),), n, dtype=torch.int64, device=pts.device)
    first = first.scatter_reduce(0, inv, k, "amin")
    first = first[G.hash_order(G.unpack(u))][:cfg["max_points_per_scan"]]
    return first


def propagate(s: State, imu_t, gyro, acc, imu_mask, t0: float, t1: float,
              noise):
    """The state at t1 and a log of (time, R, p, v, rate) at each valid
    IMU sample."""
    dt_ = s.P.dtype
    eye3 = torch.eye(3, dtype=dt_, device=s.P.device)
    R, p, v, P = s.R, s.p, s.v, s.P
    w_c, a_c = gyro.to(dt_) - s.bg, acc.to(dt_) - s.ba
    log = []
    t_prev, last = t0, None
    valid = imu_mask.tolist()
    times = imu_t.double().tolist()

    def step(R, p, v, P, w, a, dt):
        F = torch.eye(DIM, dtype=dt_, device=P.device)
        F[0:3, 0:3] = G.exp_so3(-w * dt)
        F[0:3, 9:12] = -eye3 * dt
        F[3:6, 6:9] = eye3 * dt
        F[6:9, 0:3] = -(R @ G.hat(a)) * dt
        F[6:9, 12:15] = -R * dt
        F[6:9, 15:18] = eye3 * dt
        q = torch.cat([noise[0] * dt * torch.ones(3), torch.zeros(3),
                       noise[1] * dt * torch.ones(3),
                       noise[2] * dt * torch.ones(3),
                       noise[3] * dt * torch.ones(3), torch.zeros(3)])
        a_w = R @ a + s.grav
        return (R @ G.exp_so3(w * dt), p + v * dt + 0.5 * a_w * dt * dt,
                v + a_w * dt, F @ P @ F.T + torch.diag(q.to(P)))

    for i, ok in enumerate(valid):
        if not ok:
            continue
        dt = max(times[i] - t_prev, 0.0)
        R, p, v, P = step(R, p, v, P, w_c[i], a_c[i], dt)
        t_prev, last = times[i], i
        log.append((times[i], R, p, v, w_c[i]))
    if last is None:
        raise ValueError("a scan without IMU samples")
    R, p, v, P = step(R, p, v, P, w_c[last], a_c[last], max(t1 - t_prev, 0.0))
    return s._replace(R=R, p=p, v=v, P=P), log


def deskew(pts_b, rel_t, t0: float, log, end: State):
    """Points (body frame at their own time) to the scan-end body frame."""
    lt = torch.tensor([e[0] for e in log], dtype=torch.float64,
                      device=pts_b.device)
    lR = torch.stack([e[1] for e in log])
    lp = torch.stack([e[2] for e in log])
    lv = torch.stack([e[3] for e in log])
    lw = torch.stack([e[4] for e in log])
    t = t0 + rel_t.double()
    i = torch.searchsorted(lt, t, right=True) - 1     # latest sample <= t
    before = i < 0
    i = i.clamp(min=0)
    dt = torch.where(before, 0.0, (t - lt[i]).clamp(min=0)).to(pts_b.dtype)
    nxt = (i + torch.where(before, 0, 1)).clamp(max=len(log) - 1)
    R_t = lR[i] @ G.exp_so3(lw[nxt] * dt[:, None])
    p_t = lp[i] + lv[i] * dt[:, None]
    p_w = (R_t @ pts_b[:, :, None])[:, :, 0] + p_t
    return (p_w - end.p) @ end.R


def boxplus(s: State, dx) -> State:
    return s._replace(R=s.R @ G.exp_so3(dx[0:3]), p=s.p + dx[3:6],
                      v=s.v + dx[6:9], bg=s.bg + dx[9:12],
                      ba=s.ba + dx[12:15], grav=s.grav + dx[15:18])


def update(s: State, body, iters: int) -> State:
    """The iterated MAP update against the planes cached for the points'
    voxels at the propagated pose, held over the steps."""
    eye = torch.eye(DIM, dtype=s.P.dtype, device=s.P.device)
    Pinv = torch.linalg.inv(s.P + 1e-9 * eye)
    n, d, valid = surfels.query(s.map, body @ s.R.T + s.p)
    w = valid.to(body.dtype) / MEAS_VAR

    def normal(s):
        J = torch.cat([torch.linalg.cross(body, n @ s.R, dim=-1), n], -1)
        A = torch.zeros_like(eye)
        A[:6, :6] = (J * w[:, None]).T @ J
        return J, A

    x = torch.zeros(DIM, dtype=s.P.dtype, device=s.P.device)
    for _ in range(iters):
        r = (n * (body @ s.R.T + s.p)).sum(-1) + d
        J, A = normal(s)
        b = torch.zeros_like(x)
        b[:6] = (r * w) @ J
        dx = torch.linalg.solve(A + Pinv, -(b + Pinv @ x))
        s, x = boxplus(s, dx), x + dx
    P = torch.linalg.inv(normal(s)[1] + Pinv)
    return s._replace(R=G.orthonormal(s.R), P=0.5 * (P + P.T))


def step(s: State, inputs, cfg: dict, ext_R, ext_t) -> Scan:
    """One scan from state ``s`` on the scan's raw ``inputs`` (points,
    their time offsets, mask, IMU times, gyro, accelerometer, IMU mask,
    start and end times)."""
    pts, rel_t, mask, imu_t, gyro, acc, imu_mask, t0, t1 = inputs
    dt_ = s.P.dtype
    rows = preprocess(pts, mask, cfg)
    noise = [cfg["gyr_cov"], cfg["acc_cov"], cfg["b_gyr_cov"],
             cfg["b_acc_cov"]]
    s1, log = propagate(s, imu_t, gyro, acc, imu_mask, float(t0), float(t1),
                        noise)
    pts_b = pts[rows].to(dt_) @ ext_R.to(dt_).T + ext_t.to(dt_)
    body = deskew(pts_b, rel_t[rows], float(t0), log, s1)
    s2 = update(s1, body, cfg["max_iteration"])
    # the rows padded to the scan's capacity, as the map's caps count them
    cap = cfg["max_points_per_scan"]
    body = torch.cat([body, body.new_zeros(cap - body.shape[0], 3)])
    keep = torch.arange(cap, device=body.device) < rows.numel()
    m = surfels.evict(s2.map, s2.p, 1.5 * cfg["det_range"])
    m = surfels.insert(m, body @ s2.R.T + s2.p, keep, cfg["plane_threshold"],
                       cfg["surfel_hood_cap"], cfg["surfel_halo_cap"])
    return Scan(s2._replace(map=m), body, keep)
