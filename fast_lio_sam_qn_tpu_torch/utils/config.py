"""Configuration — the per-scan LIO front end, the loop closure, the
pose-graph pipeline and the CLI's exports, with the loaders of the
reference's YAML files.

The same fields and defaults as the JAX package's ``utils/config.py``
(the reference node's *effective* values).  The loaders reproduce the
reference node's parameter reads exactly: three keys are typo'd in its
source —
``/keyframe/nusubmap_keyframes`` (fast_lio_sam_qn.cpp:19),
``/quatro/max_nucorrespondences`` (:38) and ``/quatro/rotation/numax_iter``
(:45) — so the YAML's ``num_submap_keyframes`` / ``max_correspondences`` /
``num_max_iter`` are ignored and the code defaults (5 / 200 / 50) win; and
``gicp.max_corr_dist`` is derived, ``loop_detection_radius * 1.5`` (:24).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class GicpConfig:
    """Nano-GICP equivalent (reference defaults: fast_lio_sam_qn.cpp:26-33,
    effective values from config/config.yaml:19-28)."""

    thread_number: int = 0                    # informational (batched kernels)
    icp_score_thr: float = 1.5                # config.yaml:21 (code default 10.0)
    correspondences_number: int = 15          # k for covariance kNN
    max_iter: int = 32
    transformation_epsilon: float = 0.01
    # stored for parity, not applied: PCL's GICP never reads them on the
    # reference's align() path
    euclidean_fitness_epsilon: float = 0.01
    ransac_max_iter: int = 5
    ransac_outlier_rejection_threshold: float = 1.0
    max_corr_dist: float = 52.5               # derived: loop_detection_radius * 1.5


@dataclass
class QuatroConfig:
    """Quatro equivalent (reference defaults: fast_lio_sam_qn.cpp:36-45)."""

    # True = optimizedMatching (spatial gate + max_num_corres cap); False =
    # advanced matching (all mutual matches up to advanced_max_corres)
    use_optimized_matching: bool = True
    distance_threshold: float = 35.0          # config.yaml:33 (code default 30.0)
    max_num_corres: int = 200                 # typo'd key -> code default 200 wins
    advanced_max_corres: int = 2048           # static cap of advanced matching
    fpfh_normal_radius: float = 0.9           # config.yaml:35 (code default 0.3)
    fpfh_radius: float = 1.5                  # config.yaml:36 (code default 0.5)
    # "stream" = gather-free streaming radius FPFH (the plane covariances
    # come from the same pass); "knn" = the k-capped neighbour-list FPFH
    # (ops/fpfh.py), GICP's covariances then from their own k-NN search
    fpfh_backend: str = "stream"
    fpfh_cov_radius: float = 0.6              # plane-covariance neighbourhood
    planarity_threshold: float = 90.0         # fpfh.distinctive gate
    # neighbour caps of the "knn" backend (PCL's radius search is unbounded)
    fpfh_k_feat: int = 48
    fpfh_k_normal: int = 32
    # loop_closure.cpp:24: solve the similarity (sR, t) instead of (R, t)
    estimating_scale: bool = False
    scale_gate: float = 0.1                   # accept only |scale - 1| <= this
    noise_bound: float = 0.3
    rot_gnc_factor: float = 1.4
    rot_cost_diff_thr: float = 1e-4
    rot_max_iter: int = 50                    # typo'd key -> code default 50 wins


@dataclass
class LoopClosureConfig:
    """Loop-closure module config (reference: include/loop_closure.h:45-60)."""

    voxel_res: float = 0.3                    # quatro_nano_gicp_voxel_resolution
    num_submap_keyframes: int = 5             # typo'd key -> code default 5 wins
    enable_quatro: bool = True                # config.yaml:31 (code default false)
    enable_submap_matching: bool = False
    loop_detection_radius: float = 35.0       # config.yaml:13 (code default 15.0)
    loop_detection_timediff_threshold: float = 30.0  # config.yaml:14 (default 10.0)
    # 0 = the reference's lossy timer (latest keyframe only); N > 0 =
    # register up to N pending keyframes a tick, in one batched
    # registration when two or more are pending
    loop_batch: int = 0
    # commit an accepted loop only once another accepted loop within
    # consensus_window keyframes implies a correction within consensus_tol
    # metres (0 commits on fitness alone, as the reference)
    consensus_window: int = 10
    consensus_tol: float = 0.6
    # also reject translation-degenerate registrations (False = the
    # reference's fitness-only acceptance, loop_closure.cpp:129)
    degeneracy_gate: bool = True
    gicp: GicpConfig = field(default_factory=GicpConfig)
    quatro: QuatroConfig = field(default_factory=QuatroConfig)


@dataclass
class LioConfig:
    """LIO front end (replaces the FAST-LIO2 node; per-dataset values map
    from the FAST-LIO YAMLs, e.g. kitti.yaml:8-27 and kitti.launch:6-12).
    Every field of the reference's ``LioConfig`` with its default; the port
    runs the surfel backend with a fixed extrinsic (``models/lio.py``)."""

    # preprocess
    lidar_type: str = "velodyne"              # velodyne | ouster | livox
    scan_line: int = 64
    timestamp_unit: int = -1                  # 0 s, 1 ms, 2 us, 3 ns; -1 infer
    time_offset_lidar_to_imu: float = 0.0
    time_sync_en: bool = False
    blind: float = 2.0                        # drop points closer than this [m]
    point_filter_num: int = 4                 # keep every Nth point
    # mapping / filter
    acc_cov: float = 0.1
    gyr_cov: float = 0.1
    b_acc_cov: float = 1e-4
    b_gyr_cov: float = 1e-4
    det_range: float = 100.0
    max_iteration: int = 3                    # IESEKF iterations (kitti.launch:8)
    filter_size_surf: float = 0.5             # scan downsample leaf (kitti.launch:9)
    filter_size_map: float = 0.5              # map voxel resolution (kitti.launch:10)
    extrinsic_T: tuple = (0.0, 0.0, 0.0)      # LiDAR->IMU translation
    extrinsic_R: tuple = (1.0, 0.0, 0.0,
                          0.0, 1.0, 0.0,
                          0.0, 0.0, 1.0)      # LiDAR->IMU rotation, row-major
    # online LiDAR-IMU extrinsic refinement (kitti.yaml:22): a 24-dim error
    # state from extrinsic_R / extrinsic_T as the prior
    extrinsic_est_en: bool = False
    extrinsic_rw_rot: float = 1e-5
    extrinsic_rw_trans: float = 1e-5
    gravity: float = 9.81
    # "surfel" = per-voxel moments with cached planes; "point" = one point
    # per voxel, planes fitted to the plane_k nearest
    map_backend: str = "surfel"
    surfel_query_window: int = 1              # 1 = halo-backed lookup; 3 = 27-hood
    surfel_hood_cap: int = 8192               # hood refits per scan (0 = unbounded)
    surfel_hood_window: int = 7               # 7 = face hood; 27 = full 3^3
    surfel_halo_cap: int = 4096               # halo sources per scan (0 = all)
    # static capacities
    max_points_per_scan: int = 32768          # padded scan capacity post-filter
    map_table_size: int = 1 << 19             # voxel-hash slots of the local map
    plane_k: int = 5                          # neighbors of the point backend's fit
    plane_threshold: float = 0.1              # plane thickness gate [m]


@dataclass
class Capacities:
    """Static shapes replacing the reference's unbounded std::vector growth
    (the keyframe store and the graph double when full)."""

    max_keyframes: int = 4096                 # pose-graph nodes
    max_loop_factors: int = 512
    keyframe_points: int = 8192               # stored (voxelized) pts per keyframe
    src_points: int = 16384                   # loop-closure source cloud pad
    dst_points: int = 32768                   # loop-closure target cloud pad


@dataclass
class PipelineConfig:
    """Top-level config of the pipeline (reference: config/config.yaml +
    code defaults)."""

    map_frame: str = "map"
    loop_update_hz: float = 2.0               # config.yaml:3 (code default 1.0)
    vis_hz: float = 1.0                       # config.yaml:4 (code default 0.5)
    keyframe_threshold: float = 1.5           # config.yaml:7 (code default 1.0)
    save_voxel_resolution: float = 0.3
    # results (config.yaml:45-49)
    save_map_pcd: bool = True
    save_map_bag: bool = True
    save_in_kitti_format: bool = True
    seq_name: str = "sequence"
    loop: LoopClosureConfig = field(default_factory=LoopClosureConfig)
    lio: LioConfig = field(default_factory=LioConfig)
    caps: Capacities = field(default_factory=Capacities)
    # graph noise models (fast_lio_sam_qn.cpp:112,132): variances
    # diag(1e-4 rad^2 x3, 1e-2 m^2 x3) for the prior and odometry factors;
    # loop factors use isotropic variance = ICP fitness score (:226)
    prior_variances: tuple = (1e-4, 1e-4, 1e-4, 1e-2, 1e-2, 1e-2)
    odom_variances: tuple = (1e-4, 1e-4, 1e-4, 1e-2, 1e-2, 1e-2)
    # Huber threshold on loop factors in the pose-graph solve; <= 0
    # restores the reference's raw isotropic-variance weighting
    robust_delta: float = 1.0
    # with a device mesh of more than one rank, the keyframe solve is the
    # factor-sharded one (parallel/spmd.py pgo_optimize_full) from this
    # many factors (nodes + loops + prior); below it the single solve, the
    # same math, wins on latency (the collectives dominate a small graph)
    pgo_shard_min_factors: int = 512

    def apply_strict_parity(self) -> "PipelineConfig":
        """Turn off, in place, every gate the reference lacks, so that loop
        acceptance and weighting are the reference's: fitness-only
        acceptance (loop_closure.cpp:129), raw isotropic loop noise
        (fast_lio_sam_qn.cpp:226-233), the lossy latest-keyframe timer
        (:205-210).  Returns self."""
        self.loop.consensus_window = 0
        self.loop.degeneracy_gate = False
        self.loop.loop_batch = 0
        self.robust_delta = 0.0
        return self


# ---------------------------------------------------------------------------
# the reference's YAML files, with its effective-value semantics
# ---------------------------------------------------------------------------

def _lookup(tree: dict, dotted: str, default: Any) -> Any:
    """rosparam-style lookup of 'a/b/c' in a nested dict; the code default
    on a miss."""
    node: Any = tree
    for part in dotted.strip("/").split("/"):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node


def _tree(path_or_dict) -> dict:
    if isinstance(path_or_dict, dict):
        return path_or_dict
    with open(path_or_dict) as f:
        text = f.read()
    try:
        import yaml  # only a file needs it
    except ImportError:
        # JSON is YAML too: a JSON file reads without PyYAML
        import json

        return json.loads(text) or {}
    return yaml.safe_load(text) or {}


def load_reference_yaml(path_or_dict, strict_parity: bool = True
                        ) -> PipelineConfig:
    """A reference-format config.yaml (a dict or a path) read as the node
    reads it, the three typo'd keys included.  ``strict_parity`` (default)
    also applies ``apply_strict_parity``: a config from the reference's own
    YAML should behave as the reference; False keeps the robustness gates
    on top of the reference's parameter values."""
    tree = _tree(path_or_dict)
    cfg = PipelineConfig()
    cfg.map_frame = _lookup(tree, "basic/map_frame", "map")
    cfg.loop_update_hz = float(_lookup(tree, "basic/loop_update_hz", 1.0))
    cfg.vis_hz = float(_lookup(tree, "basic/vis_hz", 0.5))
    cfg.save_voxel_resolution = float(
        _lookup(tree, "save_voxel_resolution", 0.3))

    lc = cfg.loop
    lc.voxel_res = float(
        _lookup(tree, "quatro_nano_gicp_voxel_resolution", 0.3))
    cfg.keyframe_threshold = float(
        _lookup(tree, "keyframe/keyframe_threshold", 1.0))
    # the typo'd key of fast_lio_sam_qn.cpp:19
    lc.num_submap_keyframes = int(
        _lookup(tree, "keyframe/nusubmap_keyframes", 5))
    lc.enable_submap_matching = bool(
        _lookup(tree, "keyframe/enable_submap_matching", False))
    lc.loop_detection_radius = float(
        _lookup(tree, "loop/loop_detection_radius", 15.0))
    lc.loop_detection_timediff_threshold = float(
        _lookup(tree, "loop/loop_detection_timediff_threshold", 10.0))

    gc = lc.gicp
    gc.max_corr_dist = lc.loop_detection_radius * 1.5  # fast_lio_sam_qn.cpp:24
    gc.thread_number = int(_lookup(tree, "nano_gicp/thread_number", 0))
    gc.icp_score_thr = float(
        _lookup(tree, "nano_gicp/icp_score_threshold", 10.0))
    gc.correspondences_number = int(
        _lookup(tree, "nano_gicp/correspondences_number", 15))
    gc.max_iter = int(_lookup(tree, "nano_gicp/max_iter", 32))
    gc.transformation_epsilon = float(
        _lookup(tree, "nano_gicp/transformation_epsilon", 0.01))
    gc.euclidean_fitness_epsilon = float(
        _lookup(tree, "nano_gicp/euclidean_fitness_epsilon", 0.01))
    gc.ransac_max_iter = int(_lookup(tree, "nano_gicp/ransac/max_iter", 5))
    gc.ransac_outlier_rejection_threshold = float(
        _lookup(tree, "nano_gicp/ransac/outlier_rejection_threshold", 1.0))

    qc = lc.quatro
    lc.enable_quatro = bool(_lookup(tree, "quatro/enable", False))
    qc.use_optimized_matching = bool(
        _lookup(tree, "quatro/optimize_matching", True))
    qc.distance_threshold = float(
        _lookup(tree, "quatro/distance_threshold", 30.0))
    # the typo'd key of fast_lio_sam_qn.cpp:38
    qc.max_num_corres = int(
        _lookup(tree, "quatro/max_nucorrespondences", 200))
    qc.fpfh_normal_radius = float(
        _lookup(tree, "quatro/fpfh_normal_radius", 0.3))
    qc.fpfh_radius = float(_lookup(tree, "quatro/fpfh_radius", 0.5))
    qc.estimating_scale = bool(
        _lookup(tree, "quatro/estimating_scale", False))
    qc.noise_bound = float(_lookup(tree, "quatro/noise_bound", 0.3))
    qc.rot_gnc_factor = float(
        _lookup(tree, "quatro/rotation/gnc_factor", 1.4))
    qc.rot_cost_diff_thr = float(
        _lookup(tree, "quatro/rotation/rot_cost_diff_threshold", 1e-4))
    # the typo'd key of fast_lio_sam_qn.cpp:45
    qc.rot_max_iter = int(_lookup(tree, "quatro/rotation/numax_iter", 50))

    cfg.save_map_bag = bool(_lookup(tree, "result/save_map_bag", False))
    cfg.save_map_pcd = bool(_lookup(tree, "result/save_map_pcd", False))
    cfg.save_in_kitti_format = bool(
        _lookup(tree, "result/save_in_kitti_format", False))
    cfg.seq_name = str(_lookup(tree, "result/seq_name", ""))
    if strict_parity:
        cfg.apply_strict_parity()
    return cfg


def load_lio_yaml(path_or_dict, base: Optional[LioConfig] = None
                  ) -> LioConfig:
    """A FAST-LIO per-dataset YAML (a dict or a path, e.g.
    fastlio_config_launch/kitti.yaml) over ``base`` (default
    ``LioConfig()``).  The keys it does not read (scan_rate, fov_degree,
    the publish and pcd_save blocks) change nothing in this system."""
    tree = _tree(path_or_dict)
    lio = dataclasses.replace(base) if base else LioConfig()
    lidar_types = {1: "livox", 2: "velodyne", 3: "ouster"}
    lt = _lookup(tree, "preprocess/lidar_type", None)
    if lt is not None:
        lio.lidar_type = lidar_types.get(int(lt), "velodyne")
    lio.scan_line = int(_lookup(tree, "preprocess/scan_line", lio.scan_line))
    lio.timestamp_unit = int(
        _lookup(tree, "preprocess/timestamp_unit", lio.timestamp_unit))
    lio.time_offset_lidar_to_imu = float(
        _lookup(tree, "common/time_offset_lidar_to_imu",
                lio.time_offset_lidar_to_imu))
    lio.blind = float(_lookup(tree, "preprocess/blind", lio.blind))
    lio.acc_cov = float(_lookup(tree, "mapping/acc_cov", lio.acc_cov))
    lio.gyr_cov = float(_lookup(tree, "mapping/gyr_cov", lio.gyr_cov))
    lio.b_acc_cov = float(_lookup(tree, "mapping/b_acc_cov", lio.b_acc_cov))
    lio.b_gyr_cov = float(_lookup(tree, "mapping/b_gyr_cov", lio.b_gyr_cov))
    lio.det_range = float(_lookup(tree, "mapping/det_range", lio.det_range))
    ext_t = _lookup(tree, "mapping/extrinsic_T", None)
    if ext_t is not None:
        lio.extrinsic_T = tuple(float(v) for v in ext_t)
    ext_r = _lookup(tree, "mapping/extrinsic_R", None)
    if ext_r is not None:
        lio.extrinsic_R = tuple(float(v) for v in ext_r)
    lio.extrinsic_est_en = bool(
        _lookup(tree, "mapping/extrinsic_est_en", lio.extrinsic_est_en))
    lio.time_sync_en = bool(
        _lookup(tree, "common/time_sync_en", lio.time_sync_en))
    return lio
