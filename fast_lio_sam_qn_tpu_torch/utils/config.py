"""Configuration of the ported path — the loop closure and the pose-graph
pipeline fed with external odometry.

The same fields and defaults as the JAX package's ``utils/config.py``
(the reference node's *effective* values, typo'd-key defaults included)
for every field the port reads.  The LIO block, the YAML loaders and the
fields that only they or the unported backends read belong to entry points
not ported yet (the per-scan LIO and the CLI) and are left out.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class GicpConfig:
    """Nano-GICP equivalent (reference defaults: fast_lio_sam_qn.cpp:26-33,
    effective values from config/config.yaml:19-28)."""

    icp_score_thr: float = 1.5                # config.yaml:21 (code default 10.0)
    correspondences_number: int = 15          # k for covariance kNN
    max_iter: int = 32
    transformation_epsilon: float = 0.01
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
    # "stream" = gather-free streaming radius FPFH (the only ported
    # backend; the plane covariances come from the same pass)
    fpfh_backend: str = "stream"
    fpfh_cov_radius: float = 0.6              # plane-covariance neighbourhood
    planarity_threshold: float = 90.0         # fpfh.distinctive gate
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

    loop_update_hz: float = 2.0               # config.yaml:3 (code default 1.0)
    keyframe_threshold: float = 1.5           # config.yaml:7 (code default 1.0)
    save_voxel_resolution: float = 0.3
    loop: LoopClosureConfig = field(default_factory=LoopClosureConfig)
    caps: Capacities = field(default_factory=Capacities)
    # graph noise models (fast_lio_sam_qn.cpp:112,132): variances
    # diag(1e-4 rad^2 x3, 1e-2 m^2 x3) for the prior and odometry factors;
    # loop factors use isotropic variance = ICP fitness score (:226)
    prior_variances: tuple = (1e-4, 1e-4, 1e-4, 1e-2, 1e-2, 1e-2)
    odom_variances: tuple = (1e-4, 1e-4, 1e-4, 1e-2, 1e-2, 1e-2)
    # Huber threshold on loop factors in the pose-graph solve; <= 0
    # restores the reference's raw isotropic-variance weighting
    robust_delta: float = 1.0
