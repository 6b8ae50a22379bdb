"""Synthetic LiDAR/IMU simulator for the port's tests, smoke runs and tools:
worlds of axis-aligned rectangles (a room, a corridor), smooth analytic
trajectories, a spinning multi-ring LiDAR (static or swept during the scan)
and an IMU driven by the trajectory.  The same numpy arithmetic as the JAX
package's ``utils/sim.py`` (its scans and IMU samples are bit-identical).
Deterministic given a seed.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

N_RINGS = 32


@dataclass
class World:
    """A set of axis-aligned rectangles (point-sampleable surfaces)."""

    # each surface: (origin (3,), u (3,), v (3,)) — points = o + a*u + b*v
    surfaces: list = field(default_factory=list)

    @staticmethod
    def corridor(length=60.0, width=8.0, height=4.0) -> "World":
        """Floor, ceiling, side and end walls, and pillar pairs every 10 m
        on alternating sides: enough structure to constrain all 6 DoF."""
        o = np.array
        w = World()
        w.surfaces.append((o([0.0, -width / 2, 0.0]), o([length, 0, 0]),
                           o([0, width, 0])))
        w.surfaces.append((o([0.0, -width / 2, height]), o([length, 0, 0]),
                           o([0, width, 0])))
        w.surfaces.append((o([0.0, -width / 2, 0.0]), o([length, 0, 0]),
                           o([0, 0, height])))
        w.surfaces.append((o([0.0, width / 2, 0.0]), o([length, 0, 0]),
                           o([0, 0, height])))
        w.surfaces.append((o([0.0, -width / 2, 0.0]), o([0, width, 0]),
                           o([0, 0, height])))
        w.surfaces.append((o([length, -width / 2, 0.0]), o([0, width, 0]),
                           o([0, 0, height])))
        for i, x in enumerate(np.arange(5.0, length - 4.0, 10.0)):
            s = -1 if i % 2 == 0 else 1
            y = s * (width / 2 - 1.0)
            w.surfaces.append((o([x, y, 0.0]), o([0.5, 0, 0]),
                               o([0, 0, height])))
            w.surfaces.append((o([x, y - s * 0.5, 0.0]), o([0.5, 0, 0]),
                               o([0, 0, height])))
        return w

    @staticmethod
    def room(size=20.0, height=5.0, n_boxes=6, seed=0) -> "World":
        """Floor, four walls and ``n_boxes`` random boxes."""
        rng = np.random.default_rng(seed)
        o = np.array
        w = World()
        s = size / 2
        w.surfaces.append((o([-s, -s, 0.0]), o([size, 0, 0]), o([0, size, 0])))
        w.surfaces.append((o([-s, -s, 0.0]), o([size, 0, 0]), o([0, 0, height])))
        w.surfaces.append((o([-s, s, 0.0]), o([size, 0, 0]), o([0, 0, height])))
        w.surfaces.append((o([-s, -s, 0.0]), o([0, size, 0]), o([0, 0, height])))
        w.surfaces.append((o([s, -s, 0.0]), o([0, size, 0]), o([0, 0, height])))
        for _ in range(n_boxes):
            c = rng.uniform(-s + 3, s - 3, 2)
            bw, bd, bh = rng.uniform(0.8, 2.5, 3)
            x0, y0 = c[0] - bw / 2, c[1] - bd / 2
            w.surfaces.append((o([x0, y0, 0.0]), o([bw, 0, 0]), o([0, 0, bh])))
            w.surfaces.append((o([x0, y0 + bd, 0.0]), o([bw, 0, 0]),
                               o([0, 0, bh])))
            w.surfaces.append((o([x0, y0, 0.0]), o([0, bd, 0]), o([0, 0, bh])))
            w.surfaces.append((o([x0 + bw, y0, 0.0]), o([0, bd, 0]),
                               o([0, 0, bh])))
            w.surfaces.append((o([x0, y0, bh]), o([bw, 0, 0]), o([0, bd, 0])))
        return w

    def sample_points(self, n: int, seed: int = 0,
                      noise: float = 0.0) -> np.ndarray:
        """n points drawn uniformly over the total surface area."""
        rng = np.random.default_rng(seed)
        areas = np.array(
            [np.linalg.norm(np.cross(u, v)) for (_, u, v) in self.surfaces]
        )
        counts = rng.multinomial(n, areas / areas.sum())
        pts = []
        for (o, u, v), c in zip(self.surfaces, counts):
            a = rng.uniform(0, 1, (c, 1))
            b = rng.uniform(0, 1, (c, 1))
            pts.append(o[None] + a * u[None] + b * v[None])
        pts = np.concatenate(pts, axis=0).astype(np.float32)
        if noise:
            pts = pts + rng.normal(0, noise, pts.shape).astype(np.float32)
        return pts


def so3_exp_np(w):
    th = np.linalg.norm(w)
    if th < 1e-9:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def so3_log_np(R):
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-9:
        return np.zeros(3)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v * (th / (2.0 * np.sin(th)))


@dataclass
class Trajectory:
    """Smooth ground-truth trajectory: position, yaw and optional
    (roll, pitch) as functions of time; velocity, acceleration and body
    rates by finite differences (exact enough for IMU synthesis)."""

    pos_fn: object
    yaw_fn: object
    # optional (roll, pitch) for full-SO(3) excitation; None keeps the
    # planar yaw-only motion
    tilt_fn: object = None

    def _rot(self, t: float) -> np.ndarray:
        yaw = self.yaw_fn(t)
        R = so3_exp_np(np.array([0.0, 0.0, yaw]))
        if self.tilt_fn is None:
            return R
        roll, pitch = self.tilt_fn(t)
        return (R @ so3_exp_np(np.array([0.0, pitch, 0.0]))
                @ so3_exp_np(np.array([roll, 0.0, 0.0])))

    def pose(self, t: float) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = self._rot(t)
        T[:3, 3] = self.pos_fn(t)
        return T

    def derivatives(self, t: float, dt: float = 1e-4):
        """Finite-difference world velocity/acceleration and body gyro rate."""
        p0 = self.pos_fn(t - dt)
        p1 = self.pos_fn(t)
        p2 = self.pos_fn(t + dt)
        v = (p2 - p0) / (2 * dt)
        a = (p2 - 2 * p1 + p0) / (dt * dt)
        if self.tilt_fn is not None:
            w = so3_log_np(self._rot(t - dt).T @ self._rot(t + dt)) / (2 * dt)
            return v, a, w
        yaw_rate = (self.yaw_fn(t + dt) - self.yaw_fn(t - dt)) / (2 * dt)
        return v, a, np.array([0.0, 0.0, yaw_rate])

    @staticmethod
    def loop(radius=7.0, period=30.0, z=1.5) -> "Trajectory":
        """A closed circular loop (revisits its start)."""
        om = 2 * np.pi / period

        def pos(t):
            return np.array(
                [radius * np.cos(om * t) - radius, radius * np.sin(om * t), z]
            )

        def yaw(t):
            return om * t + np.pi / 2

        return Trajectory(pos, yaw)

    @staticmethod
    def figure8(radius=8.0, period=60.0, z=1.5) -> "Trajectory":
        """A lemniscate: revisits its center crossing from two headings."""
        om = 2 * np.pi / period

        def pos(t):
            s, c = np.sin(om * t), np.cos(om * t)
            denom = 1 + s * s
            return np.array([radius * c / denom * 2,
                             radius * s * c / denom * 2, z])

        def yaw(t):
            dt = 1e-4
            p0, p1 = pos(t - dt), pos(t + dt)
            v = p1 - p0
            return np.arctan2(v[1], v[0])

        return Trajectory(pos, yaw)

    @staticmethod
    def loop_excited(radius=7.0, period=40.0, z=1.5) -> "Trajectory":
        """The circular loop with modulated yaw rate and roll/pitch sway
        (incommensurate periods): excites every rotation axis."""
        om = 2 * np.pi / period

        def pos(t):
            return np.array([
                radius * np.cos(om * t) - radius,
                radius * np.sin(om * t),
                z + 0.15 * np.sin(2 * np.pi * t / 6.1),
            ])

        def yaw(t):
            return om * t + np.pi / 2 + 0.25 * np.sin(2 * np.pi * t / 7.3)

        def tilt(t):
            return (0.12 * np.sin(2 * np.pi * t / 4.1),
                    0.10 * np.cos(2 * np.pi * t / 5.3))

        return Trajectory(pos, yaw, tilt)

    @staticmethod
    def straight(speed=1.5, z=1.5) -> "Trajectory":
        def pos(t):
            return np.array([speed * t, 0.0, z])

        def yaw(t):
            return 0.0

        return Trajectory(pos, yaw)


def _packed_surfaces(world: World):
    """The world's surfaces stacked into (S, 3) arrays for the vectorized
    raycaster (cached on the World)."""
    cached = getattr(world, "_packed", None)
    if cached is None or cached[0] is not world.surfaces:
        o = np.stack([s[0] for s in world.surfaces]).astype(np.float32)
        u = np.stack([s[1] for s in world.surfaces]).astype(np.float32)
        v = np.stack([s[2] for s in world.surfaces]).astype(np.float32)
        nrm = np.cross(u, v)
        cached = (world.surfaces, o, u, v, nrm,
                  (o * nrm).sum(1), (o * u).sum(1), (o * v).sum(1),
                  (u * u).sum(1), (v * v).sum(1))
        world._packed = cached
    return cached[1:]


def _raycast(world: World, origins: np.ndarray, dirs_w: np.ndarray,
             min_range: float, max_range: float) -> np.ndarray:
    """First-hit distance along each ray over all surfaces at once (float32
    (N, 3) @ (3, S) products).  Returns (N,) float64, inf where nothing is
    hit."""
    if not world.surfaces:
        return np.full(len(origins), np.inf)
    o, u, v, nrm, onrm, ou, ov, uu, vv = _packed_surfaces(world)
    org = origins.astype(np.float32)
    d = dirs_w.astype(np.float32)
    denom = d @ nrm.T
    with np.errstate(divide="ignore", invalid="ignore"):
        t_hit = (onrm[None, :] - org @ nrm.T) / denom
        a = (org @ u.T + t_hit * (d @ u.T) - ou[None, :]) / uu[None, :]
        b = (org @ v.T + t_hit * (d @ v.T) - ov[None, :]) / vv[None, :]
    ok = ((np.abs(denom) > 1e-9)
          & (t_hit > min_range) & (t_hit < max_range)
          & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1))
    return np.where(ok, t_hit, np.float32(np.inf)).min(
        axis=1).astype(np.float64)


def _ring_pattern(n_points: int, scan_period: float):
    """Fixed multi-ring spinning-LiDAR pattern: all rings fire together at
    each azimuth step, time advances with azimuth.  Returns (az, el, rel_t),
    each (n_points,)."""
    n_az = max(n_points // N_RINGS, 1)
    az_steps = np.linspace(0, 2 * np.pi, n_az, endpoint=False)
    el_rings = np.linspace(-0.35, 0.15, N_RINGS)
    AZ, EL = np.meshgrid(az_steps, el_rings, indexing="ij")
    az = AZ.ravel()[:n_points]
    el = EL.ravel()[:n_points]
    rel_t = az / (2 * np.pi) * scan_period
    return az, el, rel_t


def simulate_scan(
    world: World,
    T_wl: np.ndarray,
    n_points: int = 4096,
    max_range: float = 60.0,
    min_range: float = 0.5,
    noise: float = 0.01,
    seed: int = 0,
    scan_period: float = 0.1,
) -> tuple[np.ndarray, np.ndarray]:
    """Spinning-LiDAR scan from pose T_wl (world <- lidar).  Returns
    (points_lidar (N, 3) f32 with NaN rows for no-hit, rel_time (N,) f32
    in [0, scan_period))."""
    az, el, rel_t = _ring_pattern(n_points, scan_period)
    dirs_l = np.stack(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1
    )
    R, p = T_wl[:3, :3], T_wl[:3, 3]
    origins = np.broadcast_to(p, dirs_l.shape)
    dirs_w = dirs_l @ R.T

    best_t = _raycast(world, origins, dirs_w, min_range, max_range)
    hit = np.isfinite(best_t)
    rng2 = np.random.default_rng(seed + 1)
    ranges = best_t + rng2.normal(0, noise, n_points)
    with np.errstate(invalid="ignore"):
        pts_l = dirs_l * ranges[:, None]
    pts_l[~hit] = np.nan
    return pts_l.astype(np.float32), rel_t.astype(np.float32)


def simulate_scan_swept(
    world: World,
    traj: Trajectory,
    t0: float,
    n_points: int = 4096,
    max_range: float = 60.0,
    min_range: float = 0.5,
    noise: float = 0.01,
    seed: int = 0,
    scan_period: float = 0.1,
) -> tuple[np.ndarray, np.ndarray]:
    """Like simulate_scan, but the sensor moves during the sweep: each ray
    is cast from traj.pose(t0 + rel_t) (in 32 time chunks).  Points are in
    the LiDAR frame at each point's own time, the skewed cloud a deskew
    stage must correct."""
    az, el, rel_t = _ring_pattern(n_points, scan_period)
    dirs_l = np.stack(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1
    )
    n_chunks = 32
    dirs_w = np.zeros_like(dirs_l)
    origins = np.zeros_like(dirs_l)
    for ci in range(n_chunks):
        sl = slice(ci * n_points // n_chunks, (ci + 1) * n_points // n_chunks)
        t_mid = t0 + float(np.mean(rel_t[sl]))
        T = traj.pose(t_mid)
        origins[sl] = T[:3, 3]
        dirs_w[sl] = dirs_l[sl] @ T[:3, :3].T
    best_t = _raycast(world, origins, dirs_w, min_range, max_range)
    hit = np.isfinite(best_t)
    ranges = best_t + np.random.default_rng(seed + 1).normal(0, noise, n_points)
    with np.errstate(invalid="ignore"):
        pts_l = dirs_l * ranges[:, None]
    pts_l[~hit] = np.nan
    return pts_l.astype(np.float32), rel_t.astype(np.float32)


def simulate_imu(
    traj: Trajectory,
    t0: float,
    t1: float,
    rate: float = 200.0,
    gravity: float = 9.81,
    gyro_noise: float = 0.0,
    acc_noise: float = 0.0,
    gyro_bias=(0.0, 0.0, 0.0),
    acc_bias=(0.0, 0.0, 0.0),
    seed: int = 0,
):
    """IMU samples on [t0, t1): gyro (body rad/s), acc (body m/s^2 incl. g).
    Returns (t (M,) float64, gyro (M, 3) float32, acc (M, 3) float32)."""
    rng = np.random.default_rng(seed)
    ts = np.arange(t0, t1, 1.0 / rate)
    gyro = np.zeros((len(ts), 3), np.float32)
    acc = np.zeros((len(ts), 3), np.float32)
    for i, t in enumerate(ts):
        T = traj.pose(t)
        R = T[:3, :3]
        v, a_w, w_body = traj.derivatives(t)
        gyro[i] = w_body + np.asarray(gyro_bias)
        # the accelerometer measures specific force in the body frame
        acc[i] = R.T @ (a_w + np.array([0, 0, gravity])) + np.asarray(acc_bias)
    if gyro_noise:
        gyro = gyro + rng.normal(0, gyro_noise, gyro.shape).astype(np.float32)
    if acc_noise:
        acc = acc + rng.normal(0, acc_noise, acc.shape).astype(np.float32)
    return ts, gyro, acc


def pad_cloud(pts: np.ndarray, cap: int):
    """(N, 3) possibly with NaNs -> ((cap, 3) f32, (cap,) bool mask)."""
    ok = np.isfinite(pts).all(axis=-1)
    pts = np.where(ok[:, None], pts, 0.0).astype(np.float32)
    n = min(len(pts), cap)
    out = np.zeros((cap, 3), np.float32)
    msk = np.zeros((cap,), bool)
    out[:n] = pts[:n]
    msk[:n] = ok[:n]
    return out, msk
