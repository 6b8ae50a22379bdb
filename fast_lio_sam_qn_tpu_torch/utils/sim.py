"""Synthetic LiDAR simulator for the port's smoke runs and tools: a room of
axis-aligned rectangles, a circular revisiting trajectory and a spinning
multi-ring LiDAR.  The same numpy arithmetic as the JAX package's
``utils/sim.py`` (its scans are bit-identical), restricted to the parts the
port drives: no IMU synthesis, no swept scans (the per-scan LIO is not
ported).  Deterministic given a seed.
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


def so3_exp_np(w):
    th = np.linalg.norm(w)
    if th < 1e-9:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


@dataclass
class Trajectory:
    """Smooth planar ground-truth trajectory: position and yaw as functions
    of time."""

    pos_fn: object
    yaw_fn: object

    def pose(self, t: float) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = so3_exp_np(np.array([0.0, 0.0, self.yaw_fn(t)]))
        T[:3, 3] = self.pos_fn(t)
        return T

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
