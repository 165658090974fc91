"""Declarative pipeline configuration.

Re-designs the reference's C++ option structs (SfM/src/basic_structs.h:147-258)
as frozen dataclasses, preserving every knob and default value tabulated in
SURVEY.md §2.1/§6.  Mode presets mirror the WEB / UAV / street driver setups
(SfM/test/test_sfm/test_sfm.cc:26-62, test_slam/test_slam.cc).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class DatabaseOptions:
    """Feature database config (ref: basic_structs.h:200-211)."""
    feature_type: str = "sift"          # "sift" (ops/sift.py) — replaces VLSIFT/CUDASIFT
    resize: bool = True
    size_image: int = 2000 * 1500       # target pixel count after resize (ref :155)
    max_keypoints: int = 8192           # fixed keypoint budget per image (ref cap 60000)
    # Vocabulary tree (fbow k=10 L=6 in ref; we use flat/hierarchical k-means)
    voc_branch: int = 10
    voc_level: int = 6
    num_image_voc: int = 500            # max training images for vocab
    extract_gist: bool = False
    min_keypoints_for_words: int = 300  # images with fewer kps skip BoW (ref database.cc:798)
    # Route feature records through the C++ raw-record store
    # (native/feature_store.cpp; ref binary per-image IO database.cc:490-541);
    # auto-falls back to .npz when the native toolchain is unavailable.
    use_native_store: bool = True


@dataclass(frozen=True)
class GraphOptions:
    """Match-graph construction config (ref: basic_structs.h:214-227)."""
    matching_type: str = "feature"      # "all" | "priori" (GPS) | "feature" (BoW)
    knn: int = 50                       # GPS mutual-kNN neighbourhood
    ellipsoid_id: int = 22              # WGS-84 (0-based index into ellipsoid table)
    utm_zone: str = "17N"
    # candidate pruning: min(max(200, n/10), 500) per image (ref initial_matching_graph.cc:168)
    min_candidates: int = 200
    max_candidates: int = 500
    word_seed_min_matches: int = 30     # word-intersection seeding gate
    geoverify_min_inliers: int = 20     # F-verification gate for initial graph
    # fine matching (ref fine_matching_graph.cc:42-43)
    ratio_good: float = 0.6             # ratio test for F-estimation subset
    ratio_all: float = 0.85             # ratio test for kept matches
    epipolar_px: float = 3.0            # epipolar re-filter distance
    stop_word_frac: float = 0.01        # words in >1% of vocab dropped (similarity_graph.cc:109)
    max_matches_per_pair: int = 4096    # fixed match budget per pair (masked)


@dataclass(frozen=True)
class BundleAdjustOptions:
    """LM bundle adjuster config (ref: basic_structs.h:230-235, optimizer.cc:44-47)."""
    max_iterations: int = 100
    huber_delta: float = 1.0
    # LM damping schedule
    init_lambda: float = 1e-3
    lambda_up: float = 4.0
    lambda_down: float = 2.0
    min_lambda: float = 1e-10
    max_lambda: float = 1e8
    # relative cost decrease for convergence; 1e-6 = the Ceres
    # function_tolerance default the reference solves with (optimizer.cc
    # leaves it unset) — tighter values just burn full-budget LM runs on
    # cost noise below f32 resolution
    rtol: float = 1e-6
    # seed-run preprocessing (ref optimizer.cc:155-232)
    normalize_scale: float = 100.0      # recentre + scale median abs deviation to this
    perturb_sigma_rot: float = 0.1
    perturb_sigma_t: float = 0.5
    perturb_sigma_pt: float = 0.5
    # matrix-free block-Jacobi PCG camera solve (ba/lm.py):
    #   -1 (default) = AUTO: the driver enables PCG (cap 100) whenever the
    #      problem reaches sfm.th_cg_cameras, dense Cholesky below;
    #    0 = always dense Cholesky (memory grows as points x cameras);
    #   >0 = PCG with that explicit iteration cap.
    cg_iterations: int = -1
    cg_auto_iterations: int = 100       # PCG cap used by the auto mode
    cg_tol: float = 1e-5
    # inexact-Newton forcing sequence (Agarwal et al., "Bundle Adjustment
    # in the Large"): start the PCG at a loose relative tolerance and
    # tighten it each accepted LM step down to cg_tol — early LM steps
    # don't deserve exact linear solves.
    cg_forcing: bool = True


@dataclass(frozen=True)
class SfMOptions:
    """Incremental SfM config (ref: basic_structs.h:147-197)."""
    use_same_camera: bool = False       # shared camera model across images (UAV)
    calibrated: bool = False            # focal known from EXIF
    th_seedpair_structures: int = 20    # seed acceptance (ref :174)
    th_step_full_bundle_adjustment: int = 5
    # Full-BA cadence.  "growth" (default): run a full BA when the model
    # grew >= full_ba_growth_ratio since the last one (plus the final one)
    # — O(log n) full BAs over a run.  "step": the reference-literal
    # schedule, every th_step_full_bundle_adjustment registrations
    # (sfm_incremental.cc:180-183) — n/5 solves of O(n)-sized problems,
    # quadratic in n.  The reference constant is behavioral surface, not a law.
    full_ba_schedule: str = "growth"    # "growth" | "step"
    full_ba_growth_ratio: float = 0.10
    # LM iteration cap for the PERIODIC full BAs (every
    # th_step_full_bundle_adjustment registrations); the final full BA
    # runs to ba.max_iterations.  The scene is re-optimized every few
    # steps, so late LM iterations of intermediate solves are wasted.
    th_step_full_ba_iterations: int = 30
    # Per-image PARTIAL BA budget: iteration cap + relative-cost-decrease
    # tolerance.  The reference submits <=100 Ceres iterations per partial
    # solve (basic_structs.h:181) but Ceres stops on its own
    # function_tolerance; here the local problem is re-solved after every
    # subsequent registration and swept by the periodic/final full BAs, so
    # a loose 1e-4 tolerance converges the step.  The same loose rtol applies
    # to the periodic (non-final) full BAs; the FINAL full BA always runs
    # at ba.rtol (Ceres-parity 1e-6).
    partial_ba_iterations: int = 15
    intermediate_ba_rtol: float = 1e-4
    th_max_failure_localization: int = 5
    th_mse_localization: float = 5.0    # avg reproj gate for accepting a localization (px)
    th_mse_reprojection: float = 3.0    # triangulation gate (px)
    th_mse_outliers: float = 1.0        # outlier cull sqrt-MSE (px)
    th_angle_small: float = 3.0         # min parallax deg
    th_angle_large: float = 5.0         # parallax deg when >500 matches
    min_2d3d_correspondences: int = 20
    max_new_points_per_step: int = 20000
    idx_max_per_image: int = 1_000_000  # global keypoint id = img_idx * this + kp_idx (ref :169)
    checkpoint_every: int = 10          # model checkpoint cadence (images)
    # Above this camera count, full BA switches to the hierarchical
    # submap solver (parallel/submap_ba.py) — the dense reduced camera
    # system stays per-submap (no reference counterpart, closest analogue
    # is CMVS clustering sfm_incremental.cc:1255-1256).
    th_hierarchical_cameras: int = 400
    submap_max_cams: int = 64
    submap_overlap: int = 8
    # Full BA switches from dense Schur to the matrix-free PCG camera
    # solve at this camera count (needs ba.cg_iterations > 0).  The dense
    # partial materializes O(P*C) per-point camera factors, while the CG
    # matvec stays O(P*V).
    th_cg_cameras: int = 128
    weight_multiview: float = 2.0       # ≥3-view track weight in partial BA
    # batched RANSAC budgets (ref §6 table)
    ransac_8pt_iters: int = 256
    ransac_5pt_iters: int = 128
    ransac_pnp_iters: int = 256
    epnpf_focal_samples: int = 352      # f in [0.5,4.0]*f_hyp step 0.01 => 350 (ref epnpf.cc:38)
    th_inlier_pnp_px: float = 10.0


@dataclass(frozen=True)
class SLAMGPSOptions:
    """GPS-aided street/video pipeline config (ref: slam_gps.h/slam_gps.cc)."""
    matching_window: int = 5            # windowed matching (ref slam_gps.cc:314)
    ratio_video: float = 0.8
    epipolar_px: float = 2.0
    min_track_views: int = 3            # keep tracks with ≥3 views (ref :655)
    resize_ratio: float = 0.5
    # windowed re-matching + re-triangulation stage — off by default, like
    # the reference's disabled FeatureMatching call (slam_gps.cc:103)
    rematch: bool = False
    use_slam_pt: bool = False           # append new tracks to SLAM points (ref :656-663)
    gps_weight_z_scale: float = 0.2     # z error down-weighted ×1/5 (gps_error_pose_absolute.h:41)
    ba_threads: int = 8                 # informational; the device path is data-parallel
    # GPS relative constraints over consecutive camera triples — off by
    # default, as in the reference (slam_gps.cc:718-720 enables only the
    # absolute term; the relative-angle/distance functors are
    # gps_error_pose_raletive_angle.h / gps_error_pose_raletive_dis.h)
    use_gps_relative: bool = False
    gps_relative_angle_weight: float = 1.0
    gps_relative_dist_weight: float = 1.0


@dataclass(frozen=True)
class DenseOptions:
    """Dense stereo config (ref: basic_structs.h:238-242, dense_reconstruction.cc:154)."""
    method: str = "sgm"                 # "sgm" (ref SGMDense) | "elas" (ref ELASDense)
    elas_setting: str = "robotics"      # ELAS preset (ref elas.h ROBOTICS, dense_reconstruction.cc:236-239)
    disp_size: int = 128
    p1: int = 10
    p2: int = 120
    uniqueness: float = 0.96
    census_h: int = 9                   # 9×7 census window
    census_w: int = 7
    num_paths: int = 8
    depth_scale: float = 20.0           # depth = scale*f*B/d (ref :259)
    depth_clamp: float = 600.0


@dataclass(frozen=True)
class MeshOptions:
    """Device-mesh / sharding config (no reference counterpart — SURVEY §2.11)."""
    data_axis: str = "data"             # images / pairs / tracks sharded here
    model_axis: str = "model"           # reduced-camera-system sharding for BA
    data_parallel: int = 1
    model_parallel: int = 1


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level config bundle; presets mirror the reference drivers."""
    mode: str = "web"                   # "web" | "uav" | "street"
    database: DatabaseOptions = field(default_factory=DatabaseOptions)
    graph: GraphOptions = field(default_factory=GraphOptions)
    ba: BundleAdjustOptions = field(default_factory=BundleAdjustOptions)
    sfm: SfMOptions = field(default_factory=SfMOptions)
    slam: SLAMGPSOptions = field(default_factory=SLAMGPSOptions)
    dense: DenseOptions = field(default_factory=DenseOptions)
    mesh: MeshOptions = field(default_factory=MeshOptions)


def web_preset() -> PipelineConfig:
    """Internet-photo preset (ref test_sfm.cc:27-48): per-image cameras, tight gates."""
    return PipelineConfig(
        mode="web",
        sfm=SfMOptions(
            use_same_camera=False,
            th_mse_localization=5.0,
            th_mse_reprojection=3.0,
            th_mse_outliers=1.0,
        ),
        graph=replace(GraphOptions(), matching_type="feature"),
    )


def uav_preset() -> PipelineConfig:
    """Aerial/UAV preset (ref test_sfm.cc:49-62): shared camera, exhaustive match, loose gates."""
    return PipelineConfig(
        mode="uav",
        database=replace(DatabaseOptions(), size_image=4000 * 3000),
        sfm=SfMOptions(
            use_same_camera=True,
            th_mse_localization=7.0,
            th_mse_reprojection=7.0,
            th_mse_outliers=3.0,
            max_new_points_per_step=20000,
        ),
        graph=replace(GraphOptions(), matching_type="all"),
    )


def street_preset() -> PipelineConfig:
    """GoPro/street preset (ref test_slam.cc + slam_gps.cc defaults)."""
    return PipelineConfig(mode="street")


PRESETS = {"web": web_preset, "uav": uav_preset, "street": street_preset}
