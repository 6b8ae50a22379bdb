"""Loop-closure module — candidate search + two-stage registration; port of
fast_lio_sam_qn_tpu/models/loop_closure.py (single-candidate path).

- ``fetch_closest_keyframe_idx``: masked argmin over keyframe positions
  (within the loop radius, older than the time gap, the query excluded).
- ``set_src_and_dst_cloud``: scan and submap modes, voxelized clouds.
- ``icp_alignment``: GICP, accepted iff converged, fitness below the
  threshold and (by default) not translation-degenerate.
- ``coarse_to_fine_alignment``: FPFH -> Quatro -> GICP on the
  coarse-aligned source, final = fine @ coarse.  The features come from
  the streaming radius FPFH (``quatro.fpfh_backend == "stream"``, whose
  radius moments also give GICP's plane covariances) or from the kNN FPFH
  (``"knn"``: one K1 search at k = 48 per cloud; GICP's covariances then
  come from their own K1 search at k = 15).
- ``fetch_and_perform``: one loop tick — candidate fetch, registration when
  there is a candidate, and the graph measurement.
- ``fetch_closest_batch`` / ``perform_loop_closure_batch``: B candidates in
  one registration, the counterpart of the reference's
  ``jax.vmap(_perform_impl)``; given a mesh of more than one rank, the
  lanes are sharded over it (``parallel.spmd.loop_closure_batch``).

The registration is written once, over a leading batch axis of lanes
(``_register``).  The batched tick runs it with the batched kernels: the
FPFH kernels, Quatro's matching and every GICP NN once for all lanes.  The
single-candidate attempt runs it at B = 1 with the single-cloud kernels.
The clouds are built, and Quatro's clique / GNC / voting steps run, lane by
lane.

The reference fuses a tick into one jitted program with ``lax.cond``; here
the tick reads the candidate index back once and branches in Python.

Each lane registers in a frame anchored at its clouds (``anchor_of``):
the src and dst clouds and both viewpoints lose one common anchor, the dst
keyframe's corrected position rounded to whole metres, before the
features, and the transform found is conjugated back to the world frame
(``unanchor``).  The float32 arithmetic of the features (the radius
kernels' d^2 = |q|^2 - 2 q.p + |p|^2 and the raw second moments) and of
GICP's linearization about the origin cancels hundreds of metres from it;
in the anchored frame every cloud sits within its sensor's range of the
origin wherever the drive has gone.  A keyframe within ``ANCHOR_NEAR`` of
the world origin has the anchor 0, and its registration keeps its bits.

Given a profiler (the pipeline's), a registration opens the spans
``reg.clouds``, ``reg.fpfh``, ``reg.match``, ``reg.quatro`` and
``reg.gicp``, and the GICP loop adds its passes to ``gicp_iters``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..ops import fpfh, fpfh_stream, gicp, knn_cuda, quatro, se3, voxel
from ..utils import profiling
from ..utils.config import LoopClosureConfig
from .keyframes import KeyframeStore

# a dst keyframe with every coordinate within ANCHOR_NEAR (m) of the world
# origin (the sim courses, the long run's 52 m) registers at the anchor 0
ANCHOR_NEAR = 64.0


class RegistrationOutput(NamedTuple):
    pose_between: torch.Tensor  # (4, 4) world-frame correction src -> dst
    score: torch.Tensor         # GICP fitness
    is_valid: torch.Tensor      # bool
    is_converged: torch.Tensor  # bool
    closest_idx: torch.Tensor   # int32 (-1 if none)


def anchor_of(positions: torch.Tensor) -> torch.Tensor:
    """The registration frames' origins (B, 3) for lanes whose dst
    keyframes lie at ``positions`` (B, 3): the position rounded to whole
    metres, or 0 for a lane within ``ANCHOR_NEAR`` of the world origin.
    A whole number of metres leaves a float32 coordinate's own bits: a
    point nearer the anchor than the origin loses it exactly (+0, never
    -0: x - 0 keeps every x's bits)."""
    near = (positions.abs() < ANCHOR_NEAR).all(-1, keepdim=True)
    return torch.where(near, torch.zeros_like(positions),
                       torch.round(positions)) + 0.0


def unanchor(T: torch.Tensor, anchor: torch.Tensor) -> torch.Tensor:
    """World-frame transforms A T A^-1 of anchored ones ``T`` (B, 4, 4),
    A the translation by ``anchor`` (B, 3): the rotation as it is, the
    translation t + a - R a formed in float64 (with a = 0, t bit for
    bit)."""
    a = anchor.double()
    t = T[:, :3, 3].double() + a - torch.einsum(
        "bij,bj->bi", T[:, :3, :3].double(), a)
    out = T.clone()
    out[:, :3, 3] = t.to(T.dtype)
    return out


def fetch_closest_keyframe_idx(store: KeyframeStore, query_pose, query_time,
                               radius: float, timediff: float):
    """Index (0-d int32) of the closest keyframe that is within ``radius``
    and older than ``timediff``, excluding the latest keyframe; -1 if
    none."""
    dev = store.clouds.device
    idx = torch.arange(store.capacity, device=dev)
    active = idx < (store.count - 1)
    d = torch.linalg.norm(
        store.poses_corrected[:, :3, 3] - query_pose[:3, 3][None], dim=-1)
    with profiling.sync("loop_fetch"):   # a copy from host memory
        radius = torch.tensor(radius, dtype=torch.float32, device=dev)
    old_enough = (query_time - store.timestamps) > timediff
    ok = active & old_enough & (d < radius)
    best = torch.argmin(torch.where(ok, d, radius * 3.0))
    with profiling.sync("loop_fetch"):   # a 0-d index is read
        hit = ok[best]
    return torch.where(hit, best, -1).to(torch.int32)


def _accumulate_submap(store: KeyframeStore, center_idx: int,
                       submap_range: int, out_cap: int, voxel_res: float):
    """+-submap_range keyframes around center in world frame (corrected
    poses), voxelized; bounds 0 <= i < count - 1 as in the reference."""
    dev = store.clouds.device
    idxs = center_idx + torch.arange(-submap_range, submap_range + 1,
                                     device=dev)
    ok = (idxs >= 0) & (idxs < store.count - 1)
    idxs_c = torch.clamp(idxs, 0, store.capacity - 1)
    masks = store.cloud_masks[idxs_c] & ok[:, None]
    world = se3.transform_points(store.clouds[idxs_c],
                                 store.poses_corrected[idxs_c])
    w, p, _ = world.shape
    return voxel.voxel_downsample(world.reshape(w * p, 3),
                                  masks.reshape(w * p), voxel_res,
                                  out_cap=out_cap)


def _single_frame(store: KeyframeStore, idx: int, out_cap: int,
                  voxel_res: float):
    world = se3.transform_points(store.clouds[idx],
                                 store.poses_corrected[idx])
    return voxel.voxel_downsample(world, store.cloud_masks[idx], voxel_res,
                                  out_cap=out_cap)


def set_src_and_dst_cloud(store: KeyframeStore, src_idx: int, dst_idx: int,
                          *, submap_range: int, src_cap: int, dst_cap: int,
                          voxel_res: float, enable_quatro: bool,
                          enable_submap_matching: bool):
    """The reference's four src/dst construction modes: submap/submap, or
    the query scan against a scan (Quatro on) or a submap (Quatro off)."""
    if enable_submap_matching:
        src = _accumulate_submap(store, src_idx, submap_range, src_cap,
                                 voxel_res)
        dst = _accumulate_submap(store, dst_idx, submap_range, dst_cap,
                                 voxel_res)
    else:
        src = _single_frame(store, src_idx, src_cap, voxel_res)
        if enable_quatro:
            dst = _single_frame(store, dst_idx, dst_cap, voxel_res)
        else:
            dst = _accumulate_submap(store, dst_idx, submap_range, dst_cap,
                                     voxel_res)
    return src, dst


class LoopClosure:
    """Config plus the registration steps of one loop-closure attempt."""

    def __init__(self, cfg: LoopClosureConfig, src_cap: int = 8192,
                 dst_cap: int = 16384, profiler=None):
        """``profiler``: where the registration's spans go (None: no
        spans, no cost)."""
        if cfg.quatro.fpfh_backend not in ("stream", "knn"):
            raise ValueError("unknown FPFH backend "
                             f"{cfg.quatro.fpfh_backend!r}")
        self.cfg = cfg
        self.src_cap = src_cap
        self.dst_cap = dst_cap
        self.profiler = profiler

    def _span(self, name: str):
        return profiling.span(self.profiler, name)

    def fetch_closest_keyframe_idx(self, store, query_pose, query_time):
        return fetch_closest_keyframe_idx(
            store, query_pose, query_time, self.cfg.loop_detection_radius,
            self.cfg.loop_detection_timediff_threshold)

    def fetch_closest_batch(self, store, query_poses, query_times):
        """The candidate fetch for B queries ((B, 4, 4) poses, (B,) times):
        (B,) int32, -1 where none."""
        return torch.stack([self.fetch_closest_keyframe_idx(store, p, t)
                            for p, t in zip(query_poses, query_times)])

    def warm_batch(self, store: KeyframeStore, batch: int | None = None,
                   mesh=None):
        """Load the kernel library (building it if missing) and Quatro's
        solve graph (``quatro.load_solve``: captured on the card) for a
        store on the card, so that the first batched tick pays no build and
        no capture, and check that a mesh of more than one rank divides the
        ``batch`` lanes.  The reference compiles its B-lane program here;
        every batch size runs the same kernels, and the solve one lane at a
        time."""
        if batch is not None and mesh is not None and mesh.size > 1:
            mesh.shard_rows(batch)
        if store.clouds.device.type == "cuda":
            kernels.load_library()
        if self.cfg.enable_quatro:
            quatro.load_solve(self._max_corres(self.src_cap),
                              store.clouds.device, **self._solve_settings())

    def icp_alignment(self, src, src_mask, dst, dst_mask, src_cov=None,
                      dst_cov=None, *, batched: bool):
        """GICP of B lanes ((B, N, 3) clouds); plane covariances from the
        exact k-NN where not given.  ``batched`` runs every kernel once for
        all lanes (the batched kernels); otherwise each lane calls the
        single-cloud kernels.  Returns (GicpResult, valid), batched."""
        gc = self.cfg.gicp
        k = gc.correspondences_number
        if batched:
            nn, covs = knn_cuda.nn_banded_batched, \
                lambda p, m: gicp.plane_covariances_batched(p, m, k)
        else:
            nn, covs = gicp.nn_lanes, lambda p, m: kernels.per_lane(
                lambda *a: gicp.plane_covariances(*a, k), p, m)
        if src_cov is None:
            src_cov = covs(src, src_mask)
        if dst_cov is None:
            dst_cov = covs(dst, dst_mask)
        res = gicp.align_batched(
            src, src_mask, dst, dst_mask, src_cov=src_cov, dst_cov=dst_cov,
            max_iter=gc.max_iter, max_corr_dist=gc.max_corr_dist,
            trans_eps=gc.transformation_epsilon, nn=nn)
        valid = res.converged & (res.fitness < gc.icp_score_thr)
        if self.cfg.degeneracy_gate:
            valid = valid & ~res.degenerate
        return res, valid

    def _max_corres(self, n_src: int) -> int:
        qc = self.cfg.quatro
        if qc.use_optimized_matching:
            return qc.max_num_corres
        return min(n_src, qc.advanced_max_corres)

    def _solve_settings(self) -> dict:
        """``quatro.solve``'s settings from the config."""
        qc = self.cfg.quatro
        return dict(noise_bound=qc.noise_bound, gnc_factor=qc.rot_gnc_factor,
                    cost_diff_thr=qc.rot_cost_diff_thr,
                    rot_max_iter=qc.rot_max_iter,
                    estimate_scale=qc.estimating_scale)

    def coarse_to_fine_alignment(self, src, src_mask, dst, dst_mask, src_vp,
                                 dst_vp, *, batched: bool):
        """Quatro coarse -> GICP fine over B lanes ((B, N, 3) clouds, (B, 3)
        viewpoints), the kernels chosen by ``batched`` as in
        ``icp_alignment``; Quatro's clique / GNC / voting steps run lane by
        lane.  On the stream backend the plane covariances come from the
        FPFH radius moments, the src ones rotated into the coarse-aligned
        frame, C' = R C R^T; on the kNN backend ``icp_alignment`` searches
        them.  Returns (final_T (B, 4, 4), fitness (B,), valid (B,), Quatro
        converged (B,), GICP converged (B,))."""
        qc = self.cfg.quatro
        radii = (qc.fpfh_normal_radius, qc.fpfh_radius)
        stream = qc.fpfh_backend == "stream"

        def features(p, m, vp):
            if not stream:
                caps = dict(k_feat=qc.fpfh_k_feat, k_normal=qc.fpfh_k_normal)
                if batched:
                    return fpfh.fpfh_batched(p, m, *radii, viewpoint=vp,
                                             **caps)
                return kernels.per_lane(lambda *a: fpfh.fpfh(
                    *a[:2], *radii, viewpoint=a[2], **caps), p, m, vp)
            if batched:
                return fpfh_stream.fpfh_radius_batched(
                    p, m, *radii, vp, cov_radius=qc.fpfh_cov_radius)
            return kernels.per_lane(lambda *a: fpfh_stream.fpfh_radius(
                *a[:2], *radii, a[2], cov_radius=qc.fpfh_cov_radius),
                p, m, vp)

        with self._span("reg.fpfh"):
            ds, fs, *geo_s = features(src, src_mask, src_vp)
            dd, fd, *geo_d = features(dst, dst_mask, dst_vp)
            fs = fpfh.distinctive(ds, fs, qc.planarity_threshold)
            fd = fpfh.distinctive(dd, fd, qc.planarity_threshold)
        match = dict(distance_threshold=qc.distance_threshold,
                     max_corres=self._max_corres(src.shape[1]),
                     optimized_matching=qc.use_optimized_matching)
        with self._span("reg.match"):
            if batched:
                s, d, ok = quatro.match_features_batched(
                    src, ds, fs, dst, dd, fd, **match)
            else:
                s, d, ok = kernels.per_lane(
                    lambda *a: quatro.match_features(*a, **match),
                    src, ds, fs, dst, dd, fd)
        with self._span("reg.quatro"):
            settings = self._solve_settings()
            q = kernels.per_lane(
                lambda *a: quatro.solve(*a, **settings), s, d, ok)
        with self._span("reg.gicp"):
            src_c = se3.transform_points(src, q.transform)
            # pure rotation for C' = R C R^T (the transform carries s R
            # when estimating scale)
            Rq = q.transform[:, :3, :3] / q.scale[:, None, None]
            src_covs = dst_covs = None
            if stream:
                (_, nvs, cs), (_, nvd, cd) = geo_s[0], geo_d[0]
                src_covs = (torch.einsum("zab,znbc,zdc->znad", Rq, cs, Rq),
                            nvs)
                dst_covs = (cd, nvd)
            fine, fine_valid = self.icp_alignment(
                src_c, src_mask, dst, dst_mask, src_cov=src_covs,
                dst_cov=dst_covs, batched=batched)
        # the committed measurement is the rigid projection of the coarse
        # transform (a no-op unless estimating scale)
        q_rigid = q.transform.clone()
        q_rigid[:, :3, :3] = Rq
        final_T = se3.compose(fine.transform, q_rigid)
        valid = q.converged & fine_valid
        if qc.estimating_scale:
            valid = valid & (torch.abs(q.scale - 1.0) <= qc.scale_gate)
        return final_T, fine.fitness, valid, q.converged, fine.converged

    def _register(self, store: KeyframeStore, qs, cs, batched: bool
                  ) -> RegistrationOutput:
        """Register query keyframes ``qs`` against candidates ``cs`` (host
        int lists) as B lanes, each in the frame of its ``anchor_of`` its
        candidate's position; a lane with closest_idx < 0 is computed
        against keyframe 0 and comes out invalid with closest_idx -1, as in
        the reference.  Every output has a leading batch axis, the
        transform in the world frame."""
        c = self.cfg
        safe = [max(ci, 0) for ci in cs]
        vp = store.poses_corrected[:, :3, 3]
        with self._span("reg.clouds"):
            (src, src_mask), (dst, dst_mask) = kernels.per_lane(
                lambda qi, ci: set_src_and_dst_cloud(
                    store, qi, ci, submap_range=c.num_submap_keyframes,
                    src_cap=self.src_cap, dst_cap=self.dst_cap,
                    voxel_res=c.voxel_res, enable_quatro=c.enable_quatro,
                    enable_submap_matching=c.enable_submap_matching),
                qs, safe)
            anchor = anchor_of(vp[safe])
            src = src - anchor[:, None, :]
            dst = dst - anchor[:, None, :]
        if c.enable_quatro:
            T, score, valid, converged, _ = self.coarse_to_fine_alignment(
                src, src_mask, dst, dst_mask, vp[qs] - anchor,
                vp[safe] - anchor, batched=batched)
        else:
            with self._span("reg.gicp"):
                res, valid = self.icp_alignment(src, src_mask, dst, dst_mask,
                                                batched=batched)
            T, score, converged = res.transform, res.fitness, res.converged
        T = unanchor(T, anchor)
        closest = torch.tensor(cs, dtype=torch.int32, device=T.device)
        has = closest >= 0
        return RegistrationOutput(
            pose_between=T, score=score, is_valid=valid & has,
            is_converged=converged,
            closest_idx=torch.where(has, closest, -1))

    def perform_loop_closure_batch(self, store: KeyframeStore, query_idxs,
                                   closest_idxs, mesh=None
                                   ) -> RegistrationOutput:
        """Register B query keyframes against their candidates in one
        batched registration (the batched kernels, one launch for all
        lanes).  The indices are host sequences (or tensors, read once);
        lanes with closest_idx < 0 are padding (see ``_register``).  With
        a mesh of more than one rank the lanes are sharded over it (B a
        multiple of its size) and gathered back."""
        if mesh is not None and mesh.size > 1:
            from ..parallel import spmd

            return spmd.loop_closure_batch(mesh, self, store, query_idxs,
                                           closest_idxs)
        return self._register(
            store, [int(i) for i in torch.as_tensor(query_idxs).tolist()],
            [int(i) for i in torch.as_tensor(closest_idxs).tolist()],
            batched=True)

    def perform_loop_closure(self, store: KeyframeStore, query_idx: int,
                             closest_idx: int) -> RegistrationOutput:
        """Register the query keyframe against the candidate, through the
        single-cloud kernels."""
        reg = self._register(store, [query_idx], [closest_idx],
                             batched=False)
        return RegistrationOutput(*(f[0] for f in reg))

    def fetch_and_perform(self, store: KeyframeStore, query_idx: int):
        """One loop-timer tick: candidate fetch, registration if there is a
        candidate (the reference returns early otherwise), and the graph
        measurement pose_from.between(pose_to) on the poses the clouds were
        built with.  Returns (RegistrationOutput, meas (4, 4))."""
        closest = fetch_closest_keyframe_idx(
            store, store.poses_corrected[query_idx],
            store.timestamps[query_idx], self.cfg.loop_detection_radius,
            self.cfg.loop_detection_timediff_threshold)
        with profiling.sync("loop_closest"):
            closest = int(closest)
        dev = store.clouds.device
        if closest >= 0:
            reg = self.perform_loop_closure(store, query_idx, closest)
        else:
            false = torch.zeros((), dtype=torch.bool, device=dev)
            with profiling.sync("loop_none"):  # a copy from host memory
                none = torch.tensor(-1, dtype=torch.int32, device=dev)
            reg = RegistrationOutput(
                pose_between=torch.eye(4, dtype=torch.float32, device=dev),
                score=torch.zeros((), dtype=torch.float32, device=dev),
                is_valid=false, is_converged=false, closest_idx=none)
        pose_from = se3.compose(reg.pose_between,
                                store.poses_corrected[query_idx])
        pose_to = store.poses_corrected[max(closest, 0)]
        return reg, se3.pose_between(pose_from, pose_to)
