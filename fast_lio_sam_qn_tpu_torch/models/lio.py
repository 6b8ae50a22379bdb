"""LiDAR-inertial odometry front end — port of
fast_lio_sam_qn_tpu/models/lio.py: the surfel map (``ieskf.update_surfel``,
the default) or the one-point-per-voxel map (``map_backend="point"``,
``ieskf.update``), with the LiDAR-IMU extrinsic fixed or co-estimated in a
24-dim error state (``extrinsic_est_en``, ``ieskf.update_surfel_ext`` /
``update_ext``).

``LIO.process_scan`` runs preprocess -> propagate -> deskew -> iterated
update -> evict -> map insert and returns the scan-end pose and the
deskewed body-frame scan, what the pose-graph pipeline consumes.  Scan
points and IMU samples are padded and masked to fixed capacities.

No host read decides anything inside a scan: the surfel map runs the full
form of the reference's data-dependent tiers, and the first-scan skip of the
update reads a scan counter that the state carries on the host
(``LioState.scans``) beside the device's ``num_scans``.  Inputs given as
numpy arrays reach the device in one transfer.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import hashgrid, ieskf, se3, surfel_map, voxel
from ..utils.config import LioConfig

_MEAS_VAR = 0.0025     # lidar point-to-plane noise variance (m^2)


def _f32(x: float) -> float:
    """x rounded to fp32: the constants the reference takes as float32."""
    return float(np.float32(x))


class LioState(NamedTuple):
    """The filter state (device tensors) and the host's scan counter."""

    nav: ieskf.NavState
    P: torch.Tensor              # (18, 18), or (24, 24) with the extrinsic
    grid: surfel_map.SurfelMap | hashgrid.HashGrid
    t: torch.Tensor              # filter time (scan end), float32 seconds
    num_scans: torch.Tensor      # int32
    num_matches: torch.Tensor    # int32: plane matches in the last update
    ext: ieskf.Extrinsic         # LiDAR -> IMU extrinsic (filter state
                                 # when cfg.extrinsic_est_en)
    scans: int = 0               # num_scans, on the host


class ScanResult(NamedTuple):
    pose: torch.Tensor           # (4, 4) world <- body at scan end
    cloud_body: torch.Tensor     # (N, 3) deskewed scan, body frame
    cloud_mask: torch.Tensor     # (N,)
    num_matches: torch.Tensor
    intensity: torch.Tensor      # (N,) per-point intensity (zeros if none)


class LIO:
    """Host-side handle owning the config, the device and the per-scan
    step.  ``profiler`` (optional, with a ``span(name)`` context manager)
    wraps each stage of ``process_scan``: preprocess, propagate, deskew,
    update, evict, insert."""

    def __init__(self, cfg: Optional[LioConfig] = None, imu_cap: int = 64,
                 device: torch.device | str = "cuda", profiler=None):
        self.cfg = cfg or LioConfig()
        c = self.cfg
        if c.map_backend not in ("surfel", "point"):
            raise ValueError(f"unknown map_backend {c.map_backend!r}")
        self.imu_cap = imu_cap
        self.device = torch.device(device)
        self.profiler = profiler
        self._R_li = torch.tensor(
            np.array(c.extrinsic_R, np.float32).reshape(3, 3),
            device=self.device)
        self._t_li = torch.tensor(np.array(c.extrinsic_T, np.float32),
                                  device=self.device)
        noise = [c.gyr_cov, c.acc_cov, c.b_gyr_cov, c.b_acc_cov]
        if c.extrinsic_est_en:
            noise += [c.extrinsic_rw_rot, c.extrinsic_rw_trans]
        self._noise = torch.tensor(np.array(noise, np.float32),
                                   device=self.device)

    def _span(self, name: str):
        if self.profiler is None:
            return contextlib.nullcontext()
        return self.profiler.span(name)

    # ------------------------------------------------------------------
    def init_state(self, gravity_dir=None, gyro_bias=None,
                   t0: float = 0.0) -> LioState:
        """Fresh filter state.  gravity_dir: mean accelerometer direction
        over an initial standstill; None assumes +z up."""
        dev = self.device
        nav = ieskf.identity_state(dev)
        if gravity_dir is not None:
            g = np.asarray(gravity_dir, np.float32)
            g = -9.81 * g / np.linalg.norm(g)
            nav = nav._replace(grav=torch.tensor(g.astype(np.float32),
                                                 device=dev))
        if gyro_bias is not None:
            nav = nav._replace(bg=torch.tensor(
                np.asarray(gyro_bias, np.float32), device=dev))
        c = self.cfg
        make = surfel_map.empty if c.map_backend == "surfel" \
            else hashgrid.empty
        return LioState(
            nav=nav,
            P=ieskf.init_covariance(dev, est_extrinsic=c.extrinsic_est_en),
            grid=make(c.filter_size_map, c.map_table_size, dev),
            t=torch.full((), _f32(t0), dtype=torch.float32, device=dev),
            num_scans=torch.zeros((), dtype=torch.int32, device=dev),
            num_matches=torch.zeros((), dtype=torch.int32, device=dev),
            ext=ieskf.Extrinsic(R=self._R_li, t=self._t_li),
            scans=0,
        )

    @staticmethod
    def init_from_imu(gyro: np.ndarray, acc: np.ndarray):
        """Standstill init: (gravity_dir, gyro_bias) from raw samples."""
        return np.mean(acc, axis=0), np.mean(gyro, axis=0)

    @staticmethod
    def get_map_points(state: LioState) -> np.ndarray:
        """The local map as an (N, 3) array: a point map's points, a surfel
        map's voxel centroids."""
        g = state.grid
        occ = g.occupied.cpu().numpy()
        if isinstance(g, hashgrid.HashGrid):
            return g.points.cpu().numpy()[occ]
        cnt = np.maximum(g.count.cpu().numpy(), 1.0)
        center = (g.coords.cpu().numpy().astype(np.float32) + 0.5) * g.res
        return (center + g.psum.cpu().numpy() / cnt[:, None])[occ]

    # ------------------------------------------------------------------
    def _device_inputs(self, *arrays):
        """Tensors on the LIO's device; numpy inputs travel in one packed
        float32 transfer (masks as 0/1)."""
        if all(isinstance(a, torch.Tensor) for a in arrays):
            return [a.to(self.device) for a in arrays]
        host = [np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
                for a in arrays]
        flat = torch.from_numpy(np.concatenate(
            [a.astype(np.float32).reshape(-1) for a in host])).to(self.device)
        out, at = [], 0
        for a in host:
            x = flat[at:at + a.size].reshape(a.shape)
            out.append(x > 0.5 if a.dtype == np.bool_ else x)
            at += a.size
        return out

    def preprocess(self, pts, rel_t, mask, inten=None):
        """Blind-range cull, decimation and surf downsample to the fixed
        output capacity.  Returns (pts, rel_t, inten, mask)."""
        if inten is None:
            inten = np.zeros(len(pts), np.float32)
        pts, rel_t, mask, inten = self._device_inputs(pts, rel_t, mask, inten)
        return _preprocess(pts, rel_t, inten, mask, self.cfg)

    def process_scan(self, state: LioState, pts_l, rel_t, mask, imu_t, gyro,
                     acc, imu_mask, t_start: float, t_end: float,
                     inten=None) -> tuple[LioState, ScanResult]:
        """One scan: (N, 3) raw lidar-frame points with per-point offsets
        from the scan start and a mask, (K,) IMU samples in (t_prev, t_end]
        with (K, 3) gyro / acc and a mask, the scan's start and end times.
        Returns the new state and the scan's result, on the LIO's device."""
        c = self.cfg
        if inten is None:
            inten = np.zeros(len(pts_l), np.float32)
        pts_l, rel_t, mask, imu_t, gyro, acc, imu_mask, inten = \
            self._device_inputs(pts_l, rel_t, mask, imu_t, gyro, acc,
                                imu_mask, inten)
        dev = self.device
        t0 = torch.full((), _f32(t_start), dtype=torch.float32, device=dev)
        t1 = torch.full((), _f32(t_end), dtype=torch.float32, device=dev)
        with self._span("preprocess"):
            pts_p, t_p, i_p, m_p = _preprocess(pts_l, rel_t, inten, mask, c)
        with self._span("propagate"):
            nav1, P1, log = ieskf.propagate(
                state.nav, state.P, imu_t, gyro, acc, imu_mask, t0, t1,
                self._noise)
        with self._span("deskew"):
            body = ieskf.deskew(pts_p, t_p, m_p, log, nav1, t0, state.ext.R,
                                state.ext.t)
        with self._span("update"):
            nav2, P2, matches, ext2, body = self._update(
                state, nav1, P1, body, m_p)
            # keep R on SO(3) once per scan (the per-sample compose chain
            # drifts off the manifold)
            nav2 = nav2._replace(R=se3.orthonormalize3(nav2.R))
        surfel = c.map_backend == "surfel"
        with self._span("evict"):
            evict = surfel_map.evict_beyond if surfel \
                else hashgrid.evict_beyond
            grid = evict(state.grid, nav2.p, _f32(c.det_range * 1.5))
        with self._span("insert"):
            pts_w = ieskf._ptransform(body, nav2.R, nav2.p)
            if surfel:
                grid = surfel_map.insert(
                    grid, pts_w, m_p, thickness=_f32(c.plane_threshold),
                    hood_cap=c.surfel_hood_cap or None,
                    halo_cap=c.surfel_halo_cap or None,
                    hood_window=c.surfel_hood_window)
            else:
                grid = hashgrid.insert(grid, pts_w, m_p)
        pose = torch.eye(4, dtype=torch.float32, device=dev)
        pose[:3, :3] = nav2.R
        pose[:3, 3] = nav2.p
        new_state = LioState(
            nav=nav2, P=P2, grid=grid, t=t1,
            num_scans=state.num_scans + 1, num_matches=matches,
            ext=ext2, scans=state.scans + 1)
        return new_state, ScanResult(pose, body, m_p, matches, i_p)

    def _update(self, state: LioState, nav1, P1, body, m_p):
        """The iterated update of the configured backend, skipped on the
        first scan (no map yet).  Returns (nav, P, matches, ext, body):
        with the extrinsic co-estimated, the scan goes back to the scan-end
        LiDAR frame, the update moves the extrinsic too, and the body cloud
        is derived again under the updated (re-orthonormalized) one."""
        c = self.cfg
        kw = dict(meas_var=_f32(_MEAS_VAR), max_iter=c.max_iteration)
        if c.map_backend == "point":
            kw.update(plane_threshold=_f32(c.plane_threshold),
                      plane_k=c.plane_k, window=3)
        else:
            kw.update(window=c.surfel_query_window)
        first = state.scans == 0
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        if not c.extrinsic_est_en:
            if first:
                return nav1, P1, zero, state.ext, body
            fn = ieskf.update if c.map_backend == "point" \
                else ieskf.update_surfel
            nav2, P2, matches = fn(nav1, P1, state.grid, body, m_p, **kw)
            return nav2, P2, matches, state.ext, body
        pts_l_end = (body - state.ext.t) @ state.ext.R
        if first:
            nav2, ext2, P2, matches = nav1, state.ext, P1, zero
        else:
            fn = ieskf.update_ext if c.map_backend == "point" \
                else ieskf.update_surfel_ext
            nav2, ext2, P2, matches = fn(nav1, state.ext, P1, state.grid,
                                         pts_l_end, m_p, **kw)
        ext2 = ieskf.Extrinsic(R=se3.orthonormalize3(ext2.R), t=ext2.t)
        body = ieskf._ptransform(pts_l_end, ext2.R, ext2.t)
        return nav2, P2, matches, ext2, body


def _preprocess(pts, rel_t, inten, mask, cfg: LioConfig):
    """Blind-range cull, every ``point_filter_num``-th point, then the
    first point (in index order) of each ``filter_size_surf`` voxel, so
    that its timestamp stays meaningful for deskew."""
    n = pts.shape[0]
    r2 = torch.sum(pts * pts, dim=-1)
    keep = mask & (r2 > _f32(cfg.blind * cfg.blind))
    if cfg.point_filter_num > 1:
        keep = keep & (torch.arange(n, device=pts.device)
                       % cfg.point_filter_num == 0)
    scalars = torch.stack([rel_t, inten], dim=-1)
    out_pts, out_s, out_mask = _first_per_voxel(
        pts, scalars, keep, cfg.filter_size_surf, cfg.max_points_per_scan)
    return out_pts, out_s[:, 0], out_s[:, 1], out_mask


def _first_per_voxel(pts, scalars, mask, res: float, out_cap: int):
    """One representative (first-in-index) point per voxel with its
    per-point scalars (N, S), compacted to ``out_cap`` rows.  Voxels are
    ordered by (hash, coords) lexicographically, as the reference's."""
    coords = voxel.voxel_coords(pts, res)
    h = voxel.spatial_hash(coords)
    key = torch.where(mask, h, torch.iinfo(torch.int32).max)
    order = voxel._lexsort((coords[:, 2], coords[:, 1], coords[:, 0], key))
    pts_s, sc_s, coords_s, key_s, mask_s = (
        pts[order], scalars[order], coords[order], key[order], mask[order])
    prev_key = torch.cat([key_s[:1] - 1, key_s[:-1]])
    prev_coords = torch.cat([coords_s[:1] + 1, coords_s[:-1]])
    is_head = ((key_s != prev_key)
               | torch.any(coords_s != prev_coords, dim=-1)) & mask_s
    compact = torch.argsort((~is_head).to(torch.int32), stable=True)
    out_pts, out_sc, out_m = pts_s[compact], sc_s[compact], is_head[compact]
    n = pts.shape[0]
    if out_cap <= n:
        return out_pts[:out_cap], out_sc[:out_cap], out_m[:out_cap]
    return tuple(torch.cat([x, x.new_zeros((out_cap - n,) + x.shape[1:])])
                 for x in (out_pts, out_sc, out_m))
