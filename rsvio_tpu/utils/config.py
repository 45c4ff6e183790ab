"""Configuration system (YAML files, parsed by utils.miniyaml).

Capability parity (SURVEY.md §2 #6 — ref src/datasets/config.rs): the same
YAML schema as the reference configs (camera / keyframe_management /
feature_detection / optimization sections, `%YAML:1.0` directive stripping,
unknown keys ignored), mapped onto typed dataclasses. The hardcoded constants
the reference buries in code (pyramid levels, Huber delta, detection
thresholds, bidirectional gate, LM tolerances — SURVEY.md §5) are surfaced
here with reference-matching defaults.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from . import miniyaml


@dataclasses.dataclass
class CameraConfig:
    """Mirrors ref config.rs CameraConfig (flattened 4x4 row-major extrinsics)."""
    image_width: int = 752
    image_height: int = 480
    left_intrinsics: List[float] = dataclasses.field(default_factory=list)
    left_distortion: List[float] = dataclasses.field(default_factory=list)
    right_intrinsics: List[float] = dataclasses.field(default_factory=list)
    right_distortion: List[float] = dataclasses.field(default_factory=list)
    left_model: str = "pinhole-radtan"
    right_model: str = "pinhole-radtan"
    T_B_Cl: List[float] = dataclasses.field(default_factory=lambda: list(np.eye(4).ravel()))
    T_B_Cr: List[float] = dataclasses.field(default_factory=lambda: list(np.eye(4).ravel()))

    def T_B_Cl_matrix(self) -> np.ndarray:
        return np.asarray(self.T_B_Cl, dtype=np.float64).reshape(4, 4)

    def T_B_Cr_matrix(self) -> np.ndarray:
        return np.asarray(self.T_B_Cr, dtype=np.float64).reshape(4, 4)


@dataclasses.dataclass
class KeyframeManagementConfig:
    keyframe_window_size: int = 10
    translation_threshold: float = 0.05
    rotation_threshold: float = 0.05
    # Track and optimize BEFORE the window fills (the reference holds the
    # pose at identity until then, ref sliding_window.rs:137-157). Set
    # false for reference-parity startup behavior.
    track_before_full: bool = True


@dataclasses.dataclass
class FeatureDetectionConfig:
    grid_size: int = 50
    max_features_per_grid: int = 1
    optical_flow_max_iterations: int = 20
    optical_flow_convergence_threshold: float = 0.01


@dataclasses.dataclass
class OptimizationConfig:
    pnp_max_iterations: int = 10
    bundle_adjustment_max_iterations: int = 20


@dataclasses.dataclass
class TrackerConfig:
    """Constants the reference hardcodes, surfaced as config (SURVEY.md §5)."""
    pyramid_levels: int = 6          # ref estimator.rs:27
    bidir_threshold_sq: float = 0.4  # ref feature_tracker.rs:280
    detect_margin: int = 19          # ref image_utilities.rs EDGE_THRESHOLD
    min_corner_score: float = 10.0   # floor of ref threshold cascade 40->10
    feature_capacity: int = 256
    # Starvation-adaptive detection floor: when live tracks drop below this,
    # per-cell winners are accepted down to `relaxed_min_score` (one step
    # beyond the ref 40->10 cascade, engaged only when starving).
    # -1 = auto (feature_capacity // 2); 0 = off (reference-parity).
    relax_floor_below: int = -1
    relaxed_min_score: float = 1.0
    # Spaced candidates accepted per cell in starvation mode (1 = the
    # reference's single-winner cell semantics even when relaxed).
    relax_max_per_cell: int = 3
    # Track in-plane patch rotation (3-dof SE2 like the reference's Affine2
    # track states, ref feature_tracker.rs:91-100; exact arbitrary-angle
    # warp).
    # Default off: the 2-dof translation solve is measurably MORE accurate
    # on weak/fine-grained texture (see ops.klt.KLTConfig.track_rotation).
    track_rotation: bool = False
    # Residual model: "lssd" (mean-normalized, brightness invariant — the
    # main tracker's Pattern52 behavior) or "ssd" (raw difference — the
    # experimental crate's alternative, ref feature_tracker/src/patch.rs:57-105).
    residual_mode: str = "lssd"
    # Fixed Levenberg damping on the KLT step (the experimental crate's
    # precomputed (lambda I + J^T J)^-1 LM-KLT, ref patch.rs:239-255);
    # 0 = pure Gauss-Newton.
    lm_lambda: float = 0.0
    # Patch sampling: "bilinear" (main tracker) or "bicubic" (Catmull-Rom
    # with analytic gradients — the experimental crate tracks with bicubic,
    # ref feature_tracker/src/feature_tracker/feature_tracking.rs:129-192,
    # image_operations.rs:140-229).
    interpolation: str = "bilinear"
    # Detection mode: "grid" = per-cell argmax with cell occupancy (main
    # crate, ref image_utilities.rs:108-175); "nms" = block NMS + min-dist
    # suppression vs live tracks (experimental crate,
    # ref feature_detection.rs:172-254, 62-69).
    detect_mode: str = "grid"
    nms_radius: int = 10
    nms_max_new: int = 128
    # Birth-score observation-weight curve (consumed when
    # solver.score_weighted_obs): w = clip((score/ref)^power, floor, 1).
    score_weight_floor: float = 0.05
    score_weight_power: float = 1.0
    score_weight_ref: float = 10.0
    # Coarse-to-fine failure policy: "tolerant" (default — failed coarse
    # levels are skipped so border features still track; measured 2-200x
    # ATE wins on the matrix) or "strict" (reference parity: any level
    # failure kills the track, ref feature_tracker.rs:305-331).
    coarse_level_policy: str = "tolerant"


@dataclasses.dataclass
class ImuConfig:
    """IMU noise model for VIO mode (greenfield — the reference has only
    IMU placeholders). Defaults are the EuRoC MAV datasheet values."""
    gyroscope_noise_density: float = 1.7e-4   # rad/s/sqrt(Hz)
    accelerometer_noise_density: float = 2.0e-3  # m/s^2/sqrt(Hz)
    gyroscope_random_walk: float = 1.9e-5
    accelerometer_random_walk: float = 3.0e-3


@dataclasses.dataclass
class SolverConfig:
    huber_delta: float = 2.0         # ref sliding_window.rs:295,540
    cost_tol: float = 1e-6           # ref sliding_window.rs:132
    param_tol: float = 1e-9          # ref sliding_window.rs:133
    # Post-BA landmark culling threshold (normalized camera units; 0 = off,
    # the reference-parity behavior — the ref relies on Huber alone). A
    # landmark whose worst windowed reprojection error exceeds this is
    # invalidated and re-triangulated at the next keyframe. Use a LOOSE
    # (gross-outlier) threshold: tight values cull drift-displaced good
    # landmarks and the retriangulation churn degrades long-run scale.
    cull_reproj_threshold: float = 0.0
    # Per-observation chi^2 gate inside the PnP and BA solves (normalized
    # residual norm; 0 = off = reference-parity Huber-only robustness).
    # After `chi2_gate_iter` accepted LM iterations, observations whose
    # residual still exceeds the gate are dropped from the remaining
    # iterations — the defense against moving occluders the reference lacks
    # (its only guards are Huber 2.0 + the bidirectional track gate,
    # ref sliding_window.rs:295, feature_tracker.rs:280). Use gross-outlier
    # scale, e.g. 5-10 px / fx.
    chi2_gate: float = 0.0
    chi2_gate_iter: int = 1
    # PnP motion-model prior: quadratic pull toward the constant-velocity
    # (VO) / IMU (VIO) pose prediction, sqrt-weight per tangent dim
    # (normalized units; 0 = off). With the chi^2 gate this defends against
    # coherent moving-occluder hijacking (measured: occlusion scene drift
    # 36% -> 9% at weight 20).
    pnp_motion_prior: float = 0.0
    # Landmark maturity gate: landmarks enter BA only once their
    # observations span this many keyframes (1 = off).
    min_lm_span: int = 1
    # PnP RANSAC consensus gate (0 = off = reference parity). When > 0,
    # this many pose hypotheses are solved in parallel from minimal
    # samples and the LM polish runs on the winning consensus set —
    # rejecting COHERENT outlier groups (moving rigid occluders) that
    # Huber/chi2 cannot separate from the static world. See
    # models.pnp.ransac_pnp_gate.
    ransac_hypotheses: int = 0
    ransac_threshold: float = 8e-3   # inlier residual norm (normalized)
    ransac_min_inliers: int = 12     # consensus floor; below -> disengage
    # Kill tracks voted outside the consensus (invalidate their landmark,
    # free the slot) so BA never ingests the occluder observations.
    ransac_kill_outliers: bool = True
    # Adaptive track-health defenses (round 5; both need ransac_hypotheses
    # > 0 as the consensus signal — see models.estimator.EstimatorConfig).
    # pnp_prior_adaptive scales pnp_motion_prior by (1 - health): zero lag
    # on clean scenes, full pull through contamination/deserts.
    # vision_weight_adaptive down-weights the window-solve observations of
    # low-consensus frames (needs score_weighted_obs).
    pnp_prior_adaptive: bool = False
    vision_weight_adaptive: bool = False
    health_floor: float = 0.1
    health_f_lo: float = 0.5
    health_f_hi: float = 0.9
    # Hysteresis: health drops instantly, recovers at most this much per
    # frame (1.0 = off). See models.estimator.EstimatorConfig.
    health_recover: float = 1.0
    # Stereo scene-flow dynamic-object gate (0 = off): accumulated
    # reprojection-flow threshold in normalized camera units (e.g. ~0.02 =
    # 4-9 px) above which a track is classified as a coherent mover and
    # killed. See models.estimator.scene_flow_gate — designed for the
    # IMU-anchored (--vio) estimators, where the flow measurement cannot
    # lock onto the mover; in pure VO it helps only while drift is small.
    dynamic_flow: float = 0.0
    dynamic_flow_decay: float = 0.7
    dynamic_flow_min_n: int = 2
    # Median-center the flow field: "auto" (on for VO, off for VIO — the
    # measured-correct pairing), "on", or "off".
    dynamic_flow_center: str = "auto"
    # Score-weighted observations: whiten each observation by its feature's
    # birth-score weight (w = clip((score/min_score)^power, floor, 1)) so
    # starvation-mode births on weak texture contribute information
    # proportional to their localization quality. Measured: easy_plane ATE
    # -24% at unchanged occupancy, depth_6dof slightly better, other scenes
    # neutral (docs/NOTES.md round 4). Off = reference-parity equal weights.
    score_weighted_obs: bool = False
    # Constant-velocity PnP initialization (extrapolate last frame's motion
    # to seed the PnP solve). OFF by default: the default init is the
    # current pose — the reference's init-from-last-optimized-pose
    # semantics (ref sliding_window.rs:506-515) and the long-run-stable
    # configuration. On a low-parallax scene the extrapolation can close a
    # vision-only feedback loop (see EstimatorConfig.pnp_cv_predict).
    pnp_cv_predict: bool = False
    # Schur-marginalize evicted keyframes into a dense prior instead of
    # plain FIFO forgetting (the capability the reference defers — ref
    # README.md:70,79 lists marginalization as future work). Default off =
    # reference-parity FIFO behavior. Applies to both VO and --vio modes.
    marginalization: bool = False
    # VIO bias random-walk link stiffness (sqrt-info per consecutive-KF
    # bias residual; --vio only). The default accel value is deliberately
    # loose; during visual information deserts (full occlusions) window
    # drag leaks into the accel-bias states through this channel — raising
    # it to ~1e4 pins the biases over the window horizon (physically sound
    # for consumer IMUs over a few seconds) and measured occlusion drift
    # 47.9% -> 17.9% at 320px (round-5 sweep, docs/NOTES.md).
    bias_gyro_weight: float = 1e3
    bias_accel_weight: float = 1e2
    # Health-gated DESERT stiffness (0 = off): when the RANSAC consensus
    # gate reports low track health at a keyframe, that window interval's
    # bias links are stiffened toward these weights (log-space interpolation
    # by 1-health) so the solver cannot walk the biases to absorb visual
    # drag; healthy intervals keep the base stiffness. Requires
    # ransac_hypotheses > 0. See models.vio_ba.bias_desert_scales.
    bias_gyro_weight_desert: float = 0.0
    bias_accel_weight_desert: float = 0.0


@dataclasses.dataclass
class Config:
    # Runtime analog of the reference's compile-time `use_f32` cargo feature
    # (ref src/types.rs:17-23). The reference defaults to f64 on CPU; on the
    # GPU f32 runs at many times the f64 rate, so it is the default here — set
    # `precision: f64` in the YAML to run the whole pipeline in double
    # (enables jax x64 at startup).
    precision: str = "f32"
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    keyframe_management: KeyframeManagementConfig = dataclasses.field(
        default_factory=KeyframeManagementConfig)
    feature_detection: FeatureDetectionConfig = dataclasses.field(
        default_factory=FeatureDetectionConfig)
    optimization: OptimizationConfig = dataclasses.field(
        default_factory=OptimizationConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    imu: ImuConfig = dataclasses.field(default_factory=ImuConfig)


def _fill(cls, data: Optional[dict]):
    """Build a dataclass from a dict, ignoring unknown keys (the reference's
    serde behavior: the `depth:` section in tum_vi.yaml parses away).

    Numeric fields are coerced to the dataclass default's type: YAML 1.1
    resolves `1e4` (no dot) as a STRING, so without coercion a user writing
    `bias_accel_weight: 1e4` would silently ship a str into jitted code."""
    if not isinstance(data, dict):
        return cls()
    defaults = {f.name: f.default for f in dataclasses.fields(cls)}
    out = {}
    for k, v in data.items():
        if k not in defaults:
            continue
        d = defaults[k]
        if type(d) is float and isinstance(v, (int, str)):
            v = float(v)
        elif type(d) is int and isinstance(v, str):
            v = int(v)
        out[k] = v
    return cls(**out)


def load_yaml_stripped(path: str) -> dict:
    """Parse a config file, skipping the OpenCV-style `%YAML:1.0` directive
    the reference configs carry (ref config.rs:71-88 strips those lines
    before handing the text to serde). See utils.miniyaml for the subset of
    YAML it reads."""
    with open(path) as f:
        return miniyaml.loads(f.read(), path)


def load_config(path: str) -> Config:
    """Load a reference-format YAML config."""
    data = load_yaml_stripped(path)
    precision = str(data.get("precision", "f32")).lower()
    if precision not in ("f32", "f64"):
        raise ValueError(f"precision must be f32 or f64, got {precision!r}")
    solver_data = data.get("solver")
    if isinstance(solver_data, dict) and "dynamic_flow_center" in solver_data:
        dfc = solver_data["dynamic_flow_center"]
        # YAML 1.1 parses bare on/off as booleans — map them back; then
        # validate eagerly (a typo like "of" would otherwise silently
        # resolve to centered mode via a != "off" comparison downstream).
        if isinstance(dfc, bool):
            dfc = "on" if dfc else "off"
        dfc = str(dfc).lower()
        if dfc not in ("auto", "on", "off"):
            raise ValueError(
                "solver.dynamic_flow_center must be one of auto/on/off, "
                f"got {solver_data['dynamic_flow_center']!r}")
        solver_data["dynamic_flow_center"] = dfc
    return Config(
        precision=precision,
        camera=_fill(CameraConfig, data.get("camera")),
        keyframe_management=_fill(KeyframeManagementConfig,
                                  data.get("keyframe_management")),
        feature_detection=_fill(FeatureDetectionConfig,
                                data.get("feature_detection")),
        optimization=_fill(OptimizationConfig, data.get("optimization")),
        tracker=_fill(TrackerConfig, data.get("tracker")),
        solver=_fill(SolverConfig, data.get("solver")),
        imu=_fill(ImuConfig, data.get("imu")),
    )


def make_estimator_config(cfg: Config, kind: str = "vo"):
    """Translate a Config into the static EstimatorConfig + device CameraRig.

    kind: "vo" or "vio" — resolves solver.dynamic_flow_center="auto" at this
    single construction point (VO centers: unanchored pose drift is
    common-mode; VIO measures raw flow against the IMU-anchored pose —
    centering would let a tight mover cluster capture the median)."""
    import jax.numpy as jnp

    from ..models import ba as ba_mod
    from ..models import estimator as est
    from ..models import pnp as pnp_mod
    from ..models.frontend import FrontendConfig
    from ..ops import cameras
    from ..ops.klt import KLTConfig

    dtype = jnp.float64 if cfg.precision == "f64" else jnp.float32
    kind_l = cfg.camera.left_model or "pinhole-radtan"
    kind_r = cfg.camera.right_model or "pinhole-radtan"
    params_l = cameras.pack_params(kind_l, cfg.camera.left_intrinsics,
                                   cfg.camera.left_distortion, dtype=dtype)
    params_r = cameras.pack_params(kind_r, cfg.camera.right_intrinsics,
                                   cfg.camera.right_distortion, dtype=dtype)
    rig = est.make_rig(params_l, params_r,
                       jnp.asarray(cfg.camera.T_B_Cl_matrix(), dtype=dtype),
                       jnp.asarray(cfg.camera.T_B_Cr_matrix(), dtype=dtype))

    klt_cfg = KLTConfig(
        max_iterations=cfg.feature_detection.optical_flow_max_iterations,
        convergence_threshold=cfg.feature_detection.optical_flow_convergence_threshold,
        levels=cfg.tracker.pyramid_levels,
        bidir_threshold_sq=cfg.tracker.bidir_threshold_sq,
        track_rotation=cfg.tracker.track_rotation,
        residual_mode=cfg.tracker.residual_mode,
        lm_lambda=cfg.tracker.lm_lambda,
        interpolation=cfg.tracker.interpolation,
        coarse_level_policy=cfg.tracker.coarse_level_policy,
    )
    fe_cfg = FrontendConfig(
        capacity=cfg.tracker.feature_capacity,
        cell_size=cfg.feature_detection.grid_size,
        detect_margin=cfg.tracker.detect_margin,
        min_score=cfg.tracker.min_corner_score,
        max_per_cell=cfg.feature_detection.max_features_per_grid,
        relax_floor_below=(cfg.tracker.feature_capacity // 2
                           if cfg.tracker.relax_floor_below < 0
                           else cfg.tracker.relax_floor_below),
        relaxed_min_score=cfg.tracker.relaxed_min_score,
        relax_max_per_cell=cfg.tracker.relax_max_per_cell,
        klt=klt_cfg,
        detect_mode=cfg.tracker.detect_mode,
        nms_radius=cfg.tracker.nms_radius,
        nms_max_new=cfg.tracker.nms_max_new,
        score_weight_floor=cfg.tracker.score_weight_floor,
        score_weight_power=cfg.tracker.score_weight_power,
        score_weight_ref=cfg.tracker.score_weight_ref,
    )
    ecfg = est.EstimatorConfig(
        frontend=fe_cfg,
        window_size=cfg.keyframe_management.keyframe_window_size,
        translation_threshold=cfg.keyframe_management.translation_threshold,
        rotation_threshold=cfg.keyframe_management.rotation_threshold,
        cam_kind_l=kind_l.lower() if kind_l.lower() == "eucm" else kind_l,
        cam_kind_r=kind_r.lower() if kind_r.lower() == "eucm" else kind_r,
        pnp=pnp_mod.PnPConfig(
            max_iterations=cfg.optimization.pnp_max_iterations,
            huber_delta=cfg.solver.huber_delta,
            cost_tol=cfg.solver.cost_tol, param_tol=cfg.solver.param_tol,
            chi2_gate=cfg.solver.chi2_gate,
            chi2_gate_iter=cfg.solver.chi2_gate_iter,
            motion_prior_weight=cfg.solver.pnp_motion_prior,
            ransac_hypotheses=cfg.solver.ransac_hypotheses,
            ransac_threshold=cfg.solver.ransac_threshold,
            ransac_min_inliers=cfg.solver.ransac_min_inliers),
        ba=ba_mod.BAConfig(
            max_iterations=cfg.optimization.bundle_adjustment_max_iterations,
            huber_delta=cfg.solver.huber_delta,
            cost_tol=cfg.solver.cost_tol, param_tol=cfg.solver.param_tol,
            chi2_gate=cfg.solver.chi2_gate,
            chi2_gate_iter=cfg.solver.chi2_gate_iter,
            min_lm_span=cfg.solver.min_lm_span),
        image_shape=(cfg.camera.image_height, cfg.camera.image_width),
        cull_reproj_threshold=cfg.solver.cull_reproj_threshold,
        use_marginalization=cfg.solver.marginalization,
        track_before_full=cfg.keyframe_management.track_before_full,
        pnp_cv_predict=cfg.solver.pnp_cv_predict,
        use_obs_weights=cfg.solver.score_weighted_obs,
        pnp_ransac_kill=cfg.solver.ransac_kill_outliers,
        pnp_prior_adaptive=cfg.solver.pnp_prior_adaptive,
        vision_weight_adaptive=cfg.solver.vision_weight_adaptive,
        health_floor=cfg.solver.health_floor,
        health_f_lo=cfg.solver.health_f_lo,
        health_f_hi=cfg.solver.health_f_hi,
        health_recover=cfg.solver.health_recover,
        dynamic_flow_thresh=cfg.solver.dynamic_flow,
        dynamic_flow_decay=cfg.solver.dynamic_flow_decay,
        dynamic_flow_min_n=cfg.solver.dynamic_flow_min_n,
        # "auto" resolves per estimator kind (validated at load_config).
        dynamic_flow_center=(
            kind != "vio" if cfg.solver.dynamic_flow_center == "auto"
            else cfg.solver.dynamic_flow_center == "on"),
    )
    return ecfg, rig


def make_imu_params(cfg: Config):
    """Translate the imu: YAML section into models.imu.ImuParams."""
    from ..models.imu import ImuParams
    return ImuParams(
        gyro_noise=cfg.imu.gyroscope_noise_density,
        accel_noise=cfg.imu.accelerometer_noise_density,
        gyro_bias_walk=cfg.imu.gyroscope_random_walk,
        accel_bias_walk=cfg.imu.accelerometer_random_walk,
    )


def make_vio_estimator_config(cfg: Config):
    """Translate a Config into the static VIOEstimatorConfig + CameraRig
    (the estimator config resolved for the "vio" kind)."""
    from ..models import estimator_vio as ev
    from ..models.vio_ba import VIOBAConfig

    ecfg, rig = make_estimator_config(cfg, kind="vio")
    s = cfg.solver
    vcfg = ev.VIOEstimatorConfig(
        base=ecfg, imu_params=make_imu_params(cfg),
        vio=VIOBAConfig(huber_delta=s.huber_delta, cost_tol=s.cost_tol,
                        param_tol=s.param_tol, chi2_gate=s.chi2_gate,
                        chi2_gate_iter=s.chi2_gate_iter,
                        bias_gyro_weight=s.bias_gyro_weight,
                        bias_accel_weight=s.bias_accel_weight,
                        bias_gyro_weight_desert=s.bias_gyro_weight_desert,
                        bias_accel_weight_desert=s.bias_accel_weight_desert,
                        min_lm_span=s.min_lm_span))
    return vcfg, rig
