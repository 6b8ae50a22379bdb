"""Pose-graph pipeline fed with external odometry — port of
fast_lio_sam_qn_tpu/models/pipeline.py (``FastLioSamQnPipeline``).

- ``feed``: one (pose, body cloud, timestamp) triple, as the reference
  consumes them from FAST-LIO: the realtime pose from the accumulated
  odometry delta, the Euclidean keyframe gate on corrected poses, an
  odometry factor and a pose-graph solve per keyframe (2 Gauss-Newton
  steps, 5 after a loop), and the corrected-pose rewrite after a loop.
- the loop timer becomes a deterministic scheduler in data time: a tick at
  t fires before the first scan stamped after t.  With ``loop_batch == 0``
  a tick registers only the latest keyframe (the reference's lossy
  timer); with ``loop_batch > 0`` it registers up to that many pending
  keyframes, one batched registration for two or more
  (``LoopClosure.perform_loop_closure_batch``), the single-candidate tick
  for one.
- given a device mesh (``parallel.mesh.Mesh``) every rank runs the same
  pipeline on the same data: the batched tick's lanes are sharded over
  the mesh (even one pending keyframe goes through the batch), and from
  ``pgo_shard_min_factors`` factors on a mesh of more than one rank the
  keyframe solve is the factor-sharded ``spmd.pgo_optimize_full``.  Every
  decision reads replicated values, so every rank takes the same ones.
- the vis timer's products are getters.

One host pull per ``feed`` and per tick, as the reference: every scalar a
decision needs is packed into one tensor and read with one ``.cpu()``
(``_pull``).  State lives on the device given at construction; there is no
CPU fallback.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import pgo, se3, voxel
from ..utils import profiling
from ..utils.config import PipelineConfig
from . import keyframes as kf
from .loop_closure import LoopClosure, anchor_of


@dataclass
class LoopEvent:
    """Record of one loop-closure attempt."""

    tick_time: float
    query_idx: int
    closest_idx: int
    score: float
    accepted: bool


def _pull(*tensors):
    """Every tensor to the host in one transfer, as numpy arrays of their
    own shapes (values round-trip exactly through float64)."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    with profiling.sync("pull"):
        host = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(host[at:at + n].reshape(t.shape).astype(
            str(t.dtype).replace("torch.", "")))
        at += n
    return out


def _feed_step(odom_delta, last_odom_pose, last_corrected, last_kf_corrected,
               pose):
    """Delta compose, realtime pose and keyframe-gate distance
    (fast_lio_sam_qn.cpp:95-102, 498-501); the delta's rotation is
    re-projected onto SO(3) every step, as in the reference."""
    delta = se3.compose(odom_delta,
                        se3.compose(se3.pose_inverse(last_odom_pose), pose))
    delta[:3, :3] = se3.orthonormalize3(delta[:3, :3])
    corrected = se3.compose(last_corrected, delta)
    return delta, corrected, se3.pose_distance(corrected, last_kf_corrected)


class FastLioSamQnPipeline:
    def __init__(self, cfg: Optional[PipelineConfig] = None,
                 profiler: Optional[profiling.Profiler] = None,
                 device: torch.device | str = "cuda", mesh=None):
        """profiler (optional, as ``LIO``'s) gets the span 'feed' around
        each ``feed`` and inside it the reference's stage spans ('loop' per
        tick, with the registration's ``reg.*`` inside, 'real', 'key_add'
        and 'opt' per scan), and the counters ``reg_lanes`` and
        ``reg_valid`` on 'loop', ``loop_commits`` where a loop factor is
        added and ``gn_steps`` on 'opt'.  device holds every
        tensor of the pipeline's state; mesh, where given, is this rank's
        ``parallel.mesh.Mesh`` on that device."""
        self.cfg = cfg or PipelineConfig()
        self.device = torch.device(device)
        self.mesh = mesh
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the mesh's rank is on {mesh.device}, the "
                             f"pipeline on {self.device}")
        c = self.cfg
        self.loop_closure = LoopClosure(
            c.loop, src_cap=c.caps.src_points, dst_cap=c.caps.dst_points)
        self.profiler = profiler
        self.store = kf.empty_store(c.caps.max_keyframes,
                                    c.caps.keyframe_points, self.device)
        self.graph = pgo.empty_graph(c.caps.max_keyframes,
                                     c.caps.max_loop_factors, self.device)
        self._prior_var = self._t(c.prior_variances)
        self._odom_var = self._t(c.odom_variances)

        eye = torch.eye(4, device=self.device)
        self.initialized = False
        self.last_odom_pose = eye
        self.odom_delta = eye
        self.last_corrected_pose = eye
        self.last_kf_corrected = eye
        self.current_kf_idx = 0
        self.loop_added_flag = False
        self.latest_kf_processed = True
        self._kf_processed: List[bool] = []
        self._next_loop_tick: Optional[float] = None
        self._pending_loops: List[dict] = []
        # the keyframe solves on each branch, and the most loop factors in
        # the graph of a sharded one
        self.pgo_sharded_solves = 0
        self.pgo_single_solves = 0
        self.pgo_sharded_loop_factors_max = 0
        if c.loop.loop_batch > 1:
            self.loop_closure.warm_batch(
                self.store, self._batch_lanes(c.loop.loop_batch), self.mesh)

        self._last_cloud_body = None
        self._last_cloud_mask = None
        self._last_corrected = None

        self.realtime_poses: List[np.ndarray] = []
        self.odom_poses: List[torch.Tensor] = []
        self.loop_events: List[LoopEvent] = []
        self.loop_idx_pairs: List[Tuple[int, int]] = []
        self.kf_timestamps: List[float] = []

    @property
    def profiler(self) -> Optional[profiling.Profiler]:
        return self._profiler

    @profiler.setter
    def profiler(self, profiler) -> None:
        """The pipeline's profiler is its registrations' too."""
        self._profiler = profiler
        self.loop_closure.profiler = profiler

    def _t(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _span(self, name: str, scan=None):
        return profiling.span(self.profiler, name, scan)

    # ------------------------------------------------------------------
    def feed(self, pose, cloud_body, cloud_mask, timestamp: float,
             intensity=None):
        """One odometry + cloud pair: pose (4, 4) world <- body, cloud_body
        (P, 3) padded body-frame points with mask (P,), optional intensity
        (P,).  Returns the realtime corrected pose (4, 4) on the device."""
        with self._span("feed", scan=len(self.realtime_poses)):
            return self._feed(pose, cloud_body, cloud_mask, timestamp,
                              intensity)

    def _feed(self, pose, cloud_body, cloud_mask, timestamp, intensity):
        pose = self._t(pose)
        if self._next_loop_tick is None:
            self._next_loop_tick = timestamp  # timer armed at first data
        # loop-timer ticks due before this frame's data time
        period = 1.0 / self.cfg.loop_update_hz
        while self._next_loop_tick < timestamp:
            self._loop_tick(self._next_loop_tick)
            self._next_loop_tick += period

        with self._span("real"):
            self.odom_delta, corrected, dist = _feed_step(
                self.odom_delta, self.last_odom_pose,
                self.last_corrected_pose, self.last_kf_corrected, pose)
            self.last_odom_pose = pose
            corrected_np, dist_np = _pull(corrected, dist)
            self.realtime_poses.append(corrected_np)
            self._last_cloud_body = cloud_body
            self._last_cloud_mask = cloud_mask
            self._last_corrected = corrected

        if not self.initialized:
            self._add_keyframe(pose, pose, cloud_body, cloud_mask, timestamp,
                               first=True, intensity=intensity)
            self.initialized = True
        elif float(dist_np) > self.cfg.keyframe_threshold:
            with self._span("key_add"):
                self._add_keyframe(pose, corrected, cloud_body, cloud_mask,
                                   timestamp, first=False,
                                   intensity=intensity)
            with self._span("opt"):
                self._optimize_and_refresh()
        return corrected

    # ------------------------------------------------------------------
    def _add_keyframe(self, pose, corrected, cloud, mask, timestamp, first,
                      intensity=None):
        c = self.cfg
        if self.current_kf_idx >= self.store.capacity:
            # amortized growth: double both capacities
            new_cap = 2 * self.store.capacity
            self.store = kf.grow(self.store, new_cap)
            self.graph = pgo.grow(self.graph, max_nodes=new_cap)
            c.caps.max_keyframes = new_cap
        cloud = self._t(cloud)
        mask = self._t(mask, torch.bool)
        if intensity is None:
            vc, vm = voxel.voxel_downsample(cloud, mask, c.loop.voxel_res,
                                            out_cap=c.caps.keyframe_points)
            vi = None
        else:
            vc, vm, vf = voxel.voxel_downsample(
                cloud, mask, c.loop.voxel_res,
                out_cap=c.caps.keyframe_points,
                feats=self._t(intensity)[:, None])
            vi = vf[:, 0]
        self.store = kf.append(self.store, vc, vm, pose, corrected,
                               timestamp, intensity=vi)
        self.odom_poses.append(pose)
        self.kf_timestamps.append(float(timestamp))
        if first:
            self.graph = pgo.add_first_node(self.graph, pose)
        else:
            self.graph = pgo.add_odom_node(self.graph, self.last_kf_corrected,
                                           corrected)
        self.last_kf_corrected = corrected
        self.current_kf_idx += 1
        self.latest_kf_processed = False
        self._kf_processed.append(False)

    def _optimize_and_refresh(self):
        # reference: isam.update x2, x5 when a loop was added (:156-165)
        gn = 5 if self.loop_added_flag else 2
        profiling.add("gn_steps", gn)
        n_factors = self.current_kf_idx + len(self.loop_idx_pairs) + 1
        if (self.mesh is not None and self.mesh.size > 1
                and n_factors >= self.cfg.pgo_shard_min_factors):
            from ..parallel import spmd

            self.graph = spmd.pgo_optimize_full(
                self.mesh, self.graph, self._prior_var, self._odom_var,
                gn_iters=gn, pcg_iters=64, robust_delta=self.cfg.robust_delta)
            self.pgo_sharded_solves += 1
            self.pgo_sharded_loop_factors_max = max(
                self.pgo_sharded_loop_factors_max, len(self.loop_idx_pairs))
        else:
            self.graph = pgo.optimize(
                self.graph, self._prior_var, self._odom_var, gn_iters=gn,
                pcg_iters=64, robust_delta=self.cfg.robust_delta)
            self.pgo_single_solves += 1
        last = self.graph.poses[self.current_kf_idx - 1]
        self.last_corrected_pose = last
        # the next odometry factor is between(last_kf_corrected, ...): it
        # must be the post-solve estimate too (the reference's choice,
        # fast_lio_sam_qn.cpp:146-153,172-178)
        self.last_kf_corrected = last
        self.odom_delta = torch.eye(4, device=self.device)
        if self.loop_added_flag:
            self.store = kf.rewrite_corrected(self.store, self.graph.poses)
            self.loop_added_flag = False

    # ------------------------------------------------------------------
    def _loop_tick(self, tick_time: float):
        if not self.initialized or self.current_kf_idx == 0:
            return
        with self._span("loop"):
            batch = self.cfg.loop.loop_batch
            if batch > 0:
                self._loop_tick_batched(tick_time, batch)
            elif not self.latest_kf_processed:
                self.latest_kf_processed = True
                query_idx = self.current_kf_idx - 1
                self._kf_processed[query_idx] = True
                self._register_single_candidate(tick_time, query_idx)

    def _register_single_candidate(self, tick_time: float, query_idx: int):
        """Fetch, register and record one query keyframe through the
        single-candidate tick; its results come back in one pull."""
        reg, meas = self.loop_closure.fetch_and_perform(self.store,
                                                        query_idx)
        closest, valid, score, pose_b, meas_np, at = _pull(
            reg.closest_idx, reg.is_valid, reg.score, reg.pose_between, meas,
            anchor_of(self.store.poses_corrected[query_idx, :3, 3][None])[0])
        closest_i = int(closest)
        if closest_i < 0:
            return
        accepted = bool(valid)
        profiling.add("reg_lanes", 1)
        profiling.add("reg_valid", int(accepted))
        self.loop_events.append(LoopEvent(
            tick_time, query_idx, closest_i, float(score), accepted))
        if accepted:
            self._consensus_commit(query_idx, closest_i, pose_b, float(score),
                                   meas=meas_np, at=at)

    def _consensus_commit(self, query_idx, closest_i, pose_between, score,
                          meas=None, at=None):
        """Commit an accepted loop once its implied correction agrees with
        another recent accepted loop (``consensus_window``; 0 commits at
        once).  The measurement is frozen at registration time: pose_from =
        pose_between . query.corrected, meas = pose_from.between(
        closest.corrected).

        Two corrections agree where they move a point alike within
        ``consensus_tol``: the point ``at`` is ``loop_closure.anchor_of``
        the query's corrected position (the origin when None, and for every
        keyframe near it, where this is the translations' difference).  Far
        from the world origin a correction's translation alone carries its
        rotation times the lever arm to the origin."""
        if meas is None:
            pose_from = se3.compose(self._t(pose_between),
                                    self.store.poses_corrected[query_idx])
            meas = se3.pose_between(pose_from,
                                    self.store.poses_corrected[closest_i])
        w = self.cfg.loop.consensus_window
        if w <= 0:
            self._add_loop_factor(query_idx, closest_i, meas, score)
            return
        T = np.asarray(pose_between)
        corr, rot = T[:3, 3], T[:3, :3]
        x = np.zeros(3, T.dtype) if at is None else np.asarray(at, T.dtype)

        def moved(p):
            return p["rot"] @ x + p["corr"]
        entry = dict(query_idx=query_idx, closest_idx=closest_i, meas=meas,
                     score=score, corr=corr, rot=rot, committed=False)
        self._pending_loops = [p for p in self._pending_loops
                               if query_idx - p["query_idx"] <= w]
        tol = self.cfg.loop.consensus_tol
        agree = [p for p in self._pending_loops
                 if np.linalg.norm(moved(p) - moved(entry)) < tol]
        if agree:
            for p in agree:
                if not p["committed"]:
                    self._add_loop_factor(p["query_idx"], p["closest_idx"],
                                          p["meas"], p["score"])
                    p["committed"] = True
            self._add_loop_factor(query_idx, closest_i, meas, score)
            entry["committed"] = True
        self._pending_loops.append(entry)

    def _add_loop_factor(self, query_idx, closest_i, meas, score):
        if len(self.loop_idx_pairs) >= self.graph.loop_i.shape[0]:
            new_cap = 2 * self.graph.loop_i.shape[0]
            self.graph = pgo.grow(self.graph, max_loops=new_cap)
            self.cfg.caps.max_loop_factors = new_cap
        self.graph = pgo.add_loop_factor(self.graph, query_idx, closest_i,
                                         self._t(meas), score)
        profiling.add("loop_commits", 1)
        self.loop_idx_pairs.append((query_idx, closest_i))
        self.loop_added_flag = True

    def _batch_lanes(self, batch: int) -> int:
        """Lanes of a batched registration: with a mesh, ``batch`` rounded
        up to a multiple of its size (pad lanes carry closest_idx = -1)."""
        if self.mesh is not None:
            batch = -(-batch // self.mesh.size) * self.mesh.size
        return batch

    def _loop_tick_batched(self, tick_time: float, batch: int):
        pending = [i for i, p in enumerate(self._kf_processed) if not p]
        pending = pending[:batch]
        if not pending:
            return
        for i in pending:
            self._kf_processed[i] = True
        self.latest_kf_processed = self._kf_processed[-1]
        if self.mesh is None and len(pending) == 1:
            # one pending keyframe: the single-candidate tick, the same
            # per-candidate math as a batch lane
            self._register_single_candidate(tick_time, pending[0])
            return
        batch = self._batch_lanes(batch)
        qidx = np.zeros(batch, np.int64)
        qidx[:len(pending)] = pending
        q = torch.as_tensor(qidx, device=self.device)
        closest_np = _pull(self.loop_closure.fetch_closest_batch(
            self.store, self.store.poses_corrected[q],
            self.store.timestamps[q]))[0].copy()
        closest_np[len(pending):] = -1  # pad lanes: no candidate
        if (closest_np < 0).all():
            return
        reg = self.loop_closure.perform_loop_closure_batch(
            self.store, qidx.tolist(), closest_np.tolist(), mesh=self.mesh)
        valid, scores, poses_np, at = _pull(
            reg.is_valid, reg.score, reg.pose_between,
            anchor_of(self.store.poses_corrected[q, :3, 3]))
        has = closest_np[:len(pending)] >= 0
        profiling.add("reg_lanes", int(has.sum()))
        profiling.add("reg_valid", int(valid[:len(pending)][has].sum()))
        for b in range(len(pending)):
            ci = int(closest_np[b])
            if ci < 0:
                continue
            accepted = bool(valid[b])
            self.loop_events.append(LoopEvent(
                tick_time, int(qidx[b]), ci, float(scores[b]), accepted))
            if accepted:
                self._consensus_commit(int(qidx[b]), ci, poses_np[b],
                                       float(scores[b]), at=at[b])

    # ------------------------------------------------------------------
    # vis-timer products, pull-style
    def get_trajectories(self):
        """(odom_poses (N, 4, 4), corrected_poses (N, 4, 4)) as numpy."""
        n = self.current_kf_idx
        if not n:
            return np.zeros((0, 4, 4)), np.zeros((0, 4, 4))
        odom, corrected = _pull(torch.stack(self.odom_poses),
                                self.graph.poses[:n])
        return odom, corrected

    def get_corrected_current_scan(self):
        """World-frame valid points of the latest fed scan at its realtime
        corrected pose, (K, 3) numpy; empty before the first feed."""
        if self._last_cloud_body is None:
            return np.zeros((0, 3), np.float32)
        world = se3.transform_points(self._t(self._last_cloud_body),
                                     self._last_corrected)
        return world.cpu().numpy()[np.asarray(self._last_cloud_mask)]

    def get_corrected_keyframe_poses(self):
        return self.store.poses_corrected[:self.current_kf_idx].cpu().numpy()

    def get_global_map(self, voxel_res: Optional[float] = None):
        """All keyframe clouds at their corrected poses, voxelized; the
        output capacity starts at 2^21 voxels and doubles while it is
        full."""
        res = voxel_res or self.cfg.save_voxel_resolution
        n = self.current_kf_idx
        if n == 0:
            return np.zeros((0, 3), np.float32)
        world = se3.transform_points(self.store.clouds[:n],
                                     self.store.poses_corrected[:n])
        flat = world.reshape(-1, 3)
        fmask = self.store.cloud_masks[:n].reshape(-1)
        cap = min(flat.shape[0], 1 << 21)
        while True:
            pts, m = voxel.voxel_downsample(flat, fmask, res, out_cap=cap)
            if int(torch.sum(m)) < cap or cap >= flat.shape[0]:
                break
            cap = min(flat.shape[0], cap * 2)
        return pts[m].cpu().numpy()
