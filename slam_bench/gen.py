"""The benchmark's traffic generator: simulated LiDAR and IMU streams cast
on the card, from a seed.

A PyTorch rewrite of the port's ``utils/sim.py`` (which is numpy on the
host), kept here so that the yardstick does not move with the program.  It
keeps that simulator's arithmetic: rectangles as surfaces, a spinning
LiDAR whose rays are cast from the pose at their own time in 32 chunks of
the sweep, range noise of 0.01 m, and an IMU driven by the trajectory's
finite differences with the sim stream's noise.  It adds:

- the ring patterns of real sensors (``Sensor``: rings between two
  elevations, azimuth steps, rate), in an organized cloud's ring-major
  order or in firing order;
- procedural streets (``street``): a ground plane and axis-aligned boxes
  placed along a route in tiles, each tile from its own seed, so a route
  can be continued to any length; each scan is cast only against the boxes
  within the sensor's range;
- routes as functions of time on the device (``Route``): an S-curve street
  drive, a circular loop.

Every function takes the device it runs on; the CPU tests run it at small
widths.  Nothing here imports the port.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

N_CHUNKS = 32           # pose updates a sweep (utils/sim.py)
RANGE_NOISE = 0.01      # m
GYRO_NOISE, ACC_NOISE = 0.002, 0.02   # the sim stream's IMU noise
GRAVITY = 9.81


def generator(device, *keys: int) -> torch.Generator:
    """A torch.Generator on ``device`` seeded from integer ``keys`` (any
    size: the run's seed is up to a little over 2**31)."""
    h = 1469598103934665603
    for k in keys:
        h = ((h ^ (int(k) & 0xFFFFFFFFFFFFFFFF)) * 1099511628211) \
            & 0xFFFFFFFFFFFFFFFF
    g = torch.Generator(device=device)
    g.manual_seed(h & 0x7FFFFFFFFFFFFFFF)
    return g


class Sensor(NamedTuple):
    """A spinning LiDAR: ``rings`` elevations from ``el_top`` down to
    ``el_bottom`` (degrees), ``az_steps`` azimuth steps a sweep at ``hz``,
    ranges in [min_range, max_range], and its IMU's rate."""

    rings: int
    el_top: float
    el_bottom: float
    az_steps: int
    hz: float
    min_range: float
    max_range: float
    imu_hz: float

    @property
    def rays(self) -> int:
        return self.rings * self.az_steps

    @property
    def period(self) -> float:
        return 1.0 / self.hz


def ring_pattern(sensor: Sensor, device, ring_major=True, elevations=None):
    """(dirs (N, 3) float64, rel_t (N,) float32, chunk (N,) int64): the
    LiDAR-frame direction, the time from the sweep's start and the pose
    chunk of each ray.  All rings fire together at each azimuth step; the
    chunks split the firing order into N_CHUNKS parts.  ``ring_major``
    orders the rays ring after ring (an organized cloud's rows), else in
    firing order.  ``elevations`` (radians, low to high) overrides the
    sensor's evenly spaced rings."""
    n_az, n_r = sensor.az_steps, sensor.rings
    n = n_az * n_r
    az = torch.arange(n_az, dtype=torch.float64, device=device) \
        * (2 * math.pi / n_az)
    if elevations is None:
        el = torch.linspace(math.radians(sensor.el_bottom),
                            math.radians(sensor.el_top), n_r,
                            dtype=torch.float64, device=device)
    else:
        el = torch.as_tensor(elevations, dtype=torch.float64, device=device)
    AZ = az[:, None].expand(n_az, n_r).reshape(-1)
    EL = el[None, :].expand(n_az, n_r).reshape(-1)
    dirs = torch.stack([torch.cos(EL) * torch.cos(AZ),
                        torch.cos(EL) * torch.sin(AZ), torch.sin(EL)], -1)
    rel_t = (AZ / (2 * math.pi) * sensor.period)
    fire = torch.arange(n, device=device)
    chunk = fire * N_CHUNKS // n
    if ring_major:
        rows = fire.reshape(n_az, n_r).T.reshape(-1)
        dirs, rel_t, chunk = dirs[rows], rel_t[rows], chunk[rows]
    return dirs, rel_t.to(torch.float32), chunk


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

class Route(NamedTuple):
    """A planar route: ``kind`` "s_curve" (x = v t + b sin(2 pi t / tb),
    y = a sin(2 pi t / ts)) or "circle" (radius r lapped at speed v,
    starting at the origin heading +y, as utils/sim.py's loop), at height
    z.  ``pos`` and ``yaw`` take a float64 tensor of times."""

    kind: str
    speed: float
    z: float
    a: float = 0.0
    ts: float = 1.0
    b: float = 0.0
    tb: float = 1.0
    radius: float = 0.0

    def pos(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "circle":
            om = self.speed / self.radius
            return torch.stack([self.radius * torch.cos(om * t) - self.radius,
                                self.radius * torch.sin(om * t),
                                torch.full_like(t, self.z)], -1)
        x = self.speed * t + self.b * torch.sin(2 * math.pi * t / self.tb)
        y = self.a * torch.sin(2 * math.pi * t / self.ts)
        return torch.stack([x, y, torch.full_like(t, self.z)], -1)

    def yaw(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "circle":
            return self.speed / self.radius * t + math.pi / 2
        dx = self.speed + self.b * 2 * math.pi / self.tb * torch.cos(
            2 * math.pi * t / self.tb)
        dy = self.a * 2 * math.pi / self.ts * torch.cos(
            2 * math.pi * t / self.ts)
        return torch.atan2(dy, dx)

    def pose(self, t: torch.Tensor) -> torch.Tensor:
        """(M, 4, 4) float64 world <- body."""
        return pose_from(self.pos(t), self.yaw(t))

    @property
    def lap(self) -> float:
        """Seconds a lap of a closed route; inf for an open one."""
        if self.kind == "circle":
            return 2 * math.pi * self.radius / self.speed
        return math.inf


def rot_z(yaw: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def pose_from(pos: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(pos.shape[:-1] + (4, 4), dtype=pos.dtype,
                    device=pos.device)
    T[..., :3, :3] = rot_z(yaw)
    T[..., :3, 3] = pos
    T[..., 3, 3] = 1.0
    return T


def imu(route: Route, ts: torch.Tensor, gen=None, dt: float = 1e-4):
    """IMU samples at float64 times ``ts`` (M,): (gyro (M, 3), acc (M, 3))
    float32 in the body frame, by utils/sim.py's finite differences
    (specific force: R^T (a + g)); with ``gen`` the sim stream's noise."""
    p0, p1, p2 = route.pos(ts - dt), route.pos(ts), route.pos(ts + dt)
    a_w = (p2 - 2 * p1 + p0) / (dt * dt)
    dyaw = route.yaw(ts + dt) - route.yaw(ts - dt)
    dyaw = torch.remainder(dyaw + math.pi, 2 * math.pi) - math.pi
    gyro = torch.zeros_like(p1)
    gyro[:, 2] = dyaw / (2 * dt)
    R = rot_z(route.yaw(ts))
    g = torch.tensor([0.0, 0.0, GRAVITY], dtype=torch.float64,
                     device=ts.device)
    acc = torch.einsum("mji,mj->mi", R, a_w + g)
    gyro, acc = gyro.to(torch.float32), acc.to(torch.float32)
    if gen is not None:
        gyro = gyro + GYRO_NOISE * torch.randn(gyro.shape, generator=gen,
                                               device=gyro.device)
        acc = acc + ACC_NOISE * torch.randn(acc.shape, generator=gen,
                                            device=acc.device)
    return gyro, acc


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

class Scene(NamedTuple):
    """Rectangles o + a u + b v (a, b in [0, 1]), (S, 3) float32 each,
    with each one's centre and half-diagonal for culling, and whether an
    infinite ground plane z = 0 is there."""

    o: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    ground: bool

    @property
    def centre(self) -> torch.Tensor:
        return self.o + 0.5 * (self.u + self.v)

    @property
    def half_diag(self) -> torch.Tensor:
        return 0.5 * torch.linalg.norm(self.u + self.v, dim=-1)


def rectangles(surfaces, device, ground=False) -> Scene:
    """A Scene from utils/sim.py's ``World.surfaces`` list of (o, u, v)."""
    def stack(i):
        return torch.tensor([list(map(float, s[i])) for s in surfaces],
                            dtype=torch.float32, device=device)
    return Scene(stack(0), stack(1), stack(2), ground)


def box_faces(x0, y0, w, d, h):
    """The 4 walls and the roof of axis-aligned boxes (B,) each, as
    utils/sim.py's ``World.room`` builds its boxes: (o, u, v) (5B, 3)."""
    z = torch.zeros_like(x0)

    def vec(a, b, c):
        return torch.stack([a, b, c], -1)

    o = torch.stack([vec(x0, y0, z), vec(x0, y0 + d, z), vec(x0, y0, z),
                     vec(x0 + w, y0, z), vec(x0, y0, h)], 1)
    u = torch.stack([vec(w, z, z), vec(w, z, z), vec(z, d, z),
                     vec(z, d, z), vec(w, z, z)], 1)
    v = torch.stack([vec(z, z, h), vec(z, z, h), vec(z, z, h),
                     vec(z, z, h), vec(z, d, z)], 1)
    return o.reshape(-1, 3), u.reshape(-1, 3), v.reshape(-1, 3)


def street(route: Route, spec: dict, t_end: float, device) -> Scene:
    """Boxes along ``route`` up to time ``t_end`` (a lap of a closed
    route), over a ground plane.  The route is cut into tiles of
    ``tile_m`` metres of arc; tile k (modulo the lap) holds, on each side,
    ``buildings`` boxes of ``building_size`` footprint and
    ``building_height`` whose near face lies ``building_offset`` metres
    from the centreline, and ``objects`` small boxes (``object_size``,
    ``object_height``) ``object_offset`` metres from it, each drawn from
    the tile's own generator."""
    tile_t = spec["tile_m"] / route.speed
    n_tiles = max(1, math.ceil(min(t_end, route.lap) / tile_t))
    per_side = [("buildings", "building"), ("objects", "object")]
    parts = []
    for count_key, kind in per_side:
        n = spec[count_key]
        if not n:
            continue
        g = [generator(device, spec["seed"], 7, k) for k in range(n_tiles)]
        draws = torch.stack([torch.rand((2 * n, 6), generator=gk,
                                        dtype=torch.float64, device=device)
                             for gk in g])              # (tiles, 2n, 6)
        k = torch.arange(n_tiles, device=device, dtype=torch.float64)
        t = (k[:, None] + draws[..., 0]) * tile_t
        side = torch.where(torch.arange(2 * n, device=device) < n, 1.0,
                           -1.0).to(torch.float64)
        lo, hi = spec[f"{kind}_size"]
        w = lo + (hi - lo) * draws[..., 1]
        d = lo + (hi - lo) * draws[..., 2]
        hlo, hhi = spec[f"{kind}_height"]
        h = hlo + (hhi - hlo) * draws[..., 3]
        olo, ohi = spec[f"{kind}_offset"]
        off = olo + (ohi - olo) * draws[..., 4]
        p = route.pos(t.reshape(-1)).reshape(t.shape + (3,))
        yaw = route.yaw(t.reshape(-1)).reshape(t.shape)
        nrm = torch.stack([-torch.sin(yaw), torch.cos(yaw)], -1)
        # the box's centre beyond its near face, by half its extent
        # along the normal
        half = 0.5 * (w * nrm[..., 0].abs() + d * nrm[..., 1].abs())
        c = p[..., :2] + nrm * (side * (off + half))[..., None]
        parts.append((c[..., 0] - w / 2, c[..., 1] - d / 2, w, d, h))
    cols = [torch.cat([p[i].reshape(-1) for p in parts]).to(torch.float32)
            for i in range(5)]
    o, u, v = box_faces(*cols)
    return Scene(o, u, v, bool(spec.get("ground", True)))


# ---------------------------------------------------------------------------
# casting
# ---------------------------------------------------------------------------

def raycast(scene: Scene, org: torch.Tensor, d: torch.Tensor,
            min_range: float, max_range: float) -> torch.Tensor:
    """First-hit distance along each ray ((N, 3) float32 origins and
    directions), inf where nothing is hit: utils/sim.py's ``_raycast``
    over the scene's rectangles, plus the ground plane."""
    nrm = torch.cross(scene.u, scene.v, dim=-1)
    onrm = (scene.o * nrm).sum(1)
    ou, ov = (scene.o * scene.u).sum(1), (scene.o * scene.v).sum(1)
    uu, vv = (scene.u * scene.u).sum(1), (scene.v * scene.v).sum(1)
    denom = d @ nrm.T
    t_hit = (onrm[None] - org @ nrm.T) / denom
    a = (org @ scene.u.T + t_hit * (d @ scene.u.T) - ou[None]) / uu[None]
    b = (org @ scene.v.T + t_hit * (d @ scene.v.T) - ov[None]) / vv[None]
    ok = ((denom.abs() > 1e-9) & (t_hit > min_range) & (t_hit < max_range)
          & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1))
    best = torch.where(ok, t_hit, torch.inf).amin(1) if nrm.shape[0] \
        else torch.full((org.shape[0],), torch.inf, device=org.device)
    if scene.ground:
        tg = -org[:, 2] / d[:, 2]
        okg = (d[:, 2] < -1e-9) & (tg > min_range) & (tg < max_range)
        best = torch.minimum(best, torch.where(okg, tg, torch.inf))
    return best


def cull(scene: Scene, centre: torch.Tensor, reach: float) -> Scene:
    """The rectangles that can lie within ``reach`` of ``centre`` (3,)."""
    near = (torch.linalg.norm(scene.centre - centre.to(torch.float32), dim=1)
            <= reach + scene.half_diag)
    return Scene(scene.o[near], scene.u[near], scene.v[near], scene.ground)


def cast_sweep(scene: Scene, sensor: Sensor, pattern, poses_l: torch.Tensor,
               gen=None):
    """One sweep: rays of ``pattern`` (``ring_pattern``) cast from the
    LiDAR poses ``poses_l`` (N_CHUNKS, 4, 4) float64 world <- lidar, one a
    chunk, with range noise from ``gen``.  Returns (points (N, 3) float32
    in the LiDAR frame at each ray's time, zero where nothing is hit, mask
    (N,) bool)."""
    dirs, _, chunk = pattern
    R, p = poses_l[chunk, :3, :3], poses_l[chunk, :3, 3]
    d_w = torch.einsum("nij,nj->ni", R, dirs)
    near = cull(scene, poses_l[N_CHUNKS // 2, :3, 3], sensor.max_range + 5.0)
    best = raycast(near, p.to(torch.float32), d_w.to(torch.float32),
                   sensor.min_range, sensor.max_range).to(torch.float64)
    hit = torch.isfinite(best)
    if gen is not None:
        best = best + RANGE_NOISE * torch.randn(
            best.shape, generator=gen, dtype=torch.float64,
            device=best.device)
    pts = dirs * torch.where(hit, best, 0.0)[:, None]
    return pts.to(torch.float32), hit


def chunk_times(pattern, t0: float, period: float, device) -> torch.Tensor:
    """(N_CHUNKS,) float64 mid-times of the sweep's chunks: the mean of each
    chunk's ray times (utils/sim.py)."""
    _, rel_t, chunk = pattern
    sums = torch.zeros(N_CHUNKS, dtype=torch.float64, device=device)
    sums.index_add_(0, chunk, rel_t.to(torch.float64))
    counts = torch.bincount(chunk, minlength=N_CHUNKS).to(torch.float64)
    return t0 + sums / counts


def lidar_poses(route: Route, t: torch.Tensor, ext_R: torch.Tensor,
                ext_t: torch.Tensor) -> torch.Tensor:
    """World <- lidar at times ``t``: the body's pose composed with the
    extrinsic (p_body = R p_lidar + t)."""
    T_bl = torch.eye(4, dtype=torch.float64, device=t.device)
    T_bl[:3, :3] = ext_R
    T_bl[:3, 3] = ext_t
    return route.pose(t) @ T_bl


class Stream:
    """A drive's scans and IMU, cast on the device ahead of the run: for
    scan i, the sweep over [i / hz, (i + 1) / hz) from the LiDAR mounted
    at the extrinsic on the body moving along ``route``, with its IMU
    samples at ``imu_hz`` over the same interval (utils/sim.py's [t0, t1)),
    padded to ``imu_cap``, against the scene of ``scene_spec``.  Points are
    in the LiDAR frame, ring after ring; a scan's noise comes from the
    stream's generators, seeded from ``seed``, in scan order, so the same
    seed gives the same stream.  ``inputs(i)`` past the cast
    scans continues the route on the device, and logs that it did."""

    def __init__(self, sensor: Sensor, route: Route, scene_spec: dict,
                 ext_R, ext_t, seed: int, n_scans: int, device,
                 imu_cap: int = 64, log=None):
        self.sensor, self.route, self.scene_spec = sensor, route, scene_spec
        self.seed, self.device, self.imu_cap = seed, device, imu_cap
        self.log = log
        self.ext_R = torch.as_tensor(ext_R, dtype=torch.float64,
                                     device=device).reshape(3, 3)
        self.ext_t = torch.as_tensor(ext_t, dtype=torch.float64,
                                     device=device)
        self.pattern = ring_pattern(sensor, device)
        self.rel_t = self.pattern[1]
        self.inten = torch.zeros(sensor.rays, device=device)
        self.offsets = chunk_times(self.pattern, 0.0, sensor.period, device)
        self.n_imu = int(round(sensor.imu_hz / sensor.hz))
        self.scan_gen = generator(device, seed, 1)
        self.imu_gen = generator(device, seed, 2)
        self.points = torch.empty((0, sensor.rays, 3), device=device)
        self.masks = torch.empty((0, sensor.rays), dtype=torch.bool,
                                 device=device)
        self.imu = None
        self.scene = None
        self._extend(n_scans)

    def __len__(self) -> int:
        return self.points.shape[0]

    def _extend(self, n: int) -> None:
        s = self.sensor
        first = len(self)
        last = first + n
        ahead = (s.max_range + 20.0) / self.route.speed
        self.scene = street(self.route, self.scene_spec,
                            (last + 1) * s.period + ahead, self.device)
        pts = torch.empty((n, s.rays, 3), device=self.device)
        masks = torch.empty((n, s.rays), dtype=torch.bool, device=self.device)
        for j in range(n):
            t0 = (first + j) * s.period
            poses = lidar_poses(self.route, t0 + self.offsets, self.ext_R,
                                self.ext_t)
            pts[j], masks[j] = cast_sweep(self.scene, s, self.pattern, poses,
                                          self.scan_gen)
        self.points = torch.cat([self.points, pts])
        self.masks = torch.cat([self.masks, masks])
        k = torch.arange(self.n_imu, dtype=torch.float64, device=self.device)
        i = torch.arange(first, last, dtype=torch.float64, device=self.device)
        ts = (i[:, None] * s.period + k[None] / s.imu_hz).reshape(-1)
        gyro, acc = imu(self.route, ts, self.imu_gen)
        cap = self.imu_cap
        it = torch.zeros((n, cap), device=self.device)
        ig = torch.zeros((n, cap, 3), device=self.device)
        ia = torch.zeros((n, cap, 3), device=self.device)
        im = torch.zeros((n, cap), dtype=torch.bool, device=self.device)
        m = min(self.n_imu, cap)
        it[:, :m] = ts.reshape(n, -1)[:, :m].to(torch.float32)
        ig[:, :m] = gyro.reshape(n, -1, 3)[:, :m]
        ia[:, :m] = acc.reshape(n, -1, 3)[:, :m]
        im[:, :m] = True
        block = (it, ig, ia, im)
        self.imu = block if self.imu is None else tuple(
            torch.cat([a, b]) for a, b in zip(self.imu, block))

    def inputs(self, i: int):
        """``LIO.process_scan``'s inputs for scan i: (points, rel_t, mask,
        imu_t, gyro, acc, imu_mask, t_start, t_end), all but the two times
        tensors on the device."""
        if i >= len(self):
            n = max(len(self), 1)
            if self.log:
                self.log(f"stream: scan {i} is past the {len(self)} cast "
                         f"ahead; continuing the route by {n} scans on the "
                         f"device")
            self._extend(n)
        p = self.sensor.period
        it, ig, ia, im = (a[i] for a in self.imu)
        return (self.points[i], self.rel_t, self.masks[i], it, ig, ia, im,
                i * p, (i + 1) * p)

