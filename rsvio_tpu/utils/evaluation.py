"""Run the estimator over a generated synthetic sequence and score it.

The evidence harness behind the accuracy matrix (VERDICT round-1 item 1):
drives the VO or VIO per-frame step over a data.synthetic sequence and
reports SE3-aligned ATE RMSE plus displacement drift — the same metrics the
real-dataset BASELINE rows call for, measured on the adversarial scene
classes (6-DoF motion, depth structure, photometric drift, occlusion).

No reference counterpart: the reference ships neither benchmarks nor
fixtures (SURVEY.md §6) — this module GENERATES the baseline numbers.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np

from ..data import synthetic as syn
from .trajectory import ate_rmse


@dataclasses.dataclass
class RunResult:
    positions: np.ndarray       # (n, 3) estimated world positions
    gt_positions: np.ndarray    # (n, 3)
    ate_rmse: float             # SE3-aligned, post-fill segment
    drift_pct: float            # |est - gt| displacement error, % of path
    n_tracked_mean: float
    ba_success_rate: float
    fps: float                  # wall-clock estimator throughput
    skip: int                   # frames excluded from ATE (window fill)


def static_init_imu(traj: syn.Trajectory, seconds: float = 0.5,
                    rate: float = 200.0, rng: Optional[np.random.Generator] = None,
                    gyro_bias=None, accel_bias=None,
                    gyro_noise: float = 0.0, accel_noise: float = 0.0):
    """IMU samples of a body holding still at the trajectory's START pose —
    the standard hold-still-before-run initialization protocol. Feeds
    estimator_vio.initialize_vio_state."""
    hover = syn.Trajectory(pos_fn=lambda t: traj.pos_fn(0.0),
                           ang_fn=lambda t: traj.ang_fn(0.0), R0=traj.R0)
    _, gyro, accel, _ = hover.sample_imu(
        -seconds, 0.0, rate=rate, gyro_bias=gyro_bias,
        accel_bias=accel_bias, noise_rng=rng,
        gyro_noise=gyro_noise, accel_noise=accel_noise)
    return gyro, accel


def score_positions(positions: np.ndarray, gt: np.ndarray, skip: int):
    """(ATE RMSE in m, drift in %) of the segment from frame `skip` on. ATE
    is SE3-aligned; drift compares the segment's displacement length with
    the ground truth's, over the ground-truth path length."""
    rmse, _ = ate_rmse(positions[skip:], gt[skip:])
    d_est = np.linalg.norm(positions[-1] - positions[skip])
    d_gt = np.linalg.norm(gt[-1] - gt[skip])
    path = np.sum(np.linalg.norm(np.diff(gt[skip:], axis=0), axis=1))
    return rmse, 100.0 * abs(d_est - d_gt) / max(path, 1e-9)


def run_synthetic_sequence(seq: dict, scene: syn.SceneConfig, *,
                           use_vio: bool = False,
                           use_marginalization: bool = False,
                           capacity: int = 256, window: int = 10,
                           levels: int = 4, max_iterations: int = 20,
                           translation_threshold: float = 0.04,
                           rotation_threshold: float = 0.04,
                           cell_size: int = 50, detect_margin: int = 19,
                           imu_buf: int = 64,
                           init_gyro=None, init_accel=None,
                           motion_prior: float = 0.0,
                           ransac: int = 0,
                           adaptive: bool = False,
                           dynamic_flow: float = 0.0,
                           pnp_cv_predict: bool = False,
                           bias_gyro_weight: float = None,
                           bias_accel_weight: float = None,
                           bias_gyro_weight_desert: float = 0.0,
                           bias_accel_weight_desert: float = 0.0,
                           use_obs_weights: bool = True,
                           coarse_level_policy: str = None) -> RunResult:
    """Drive the (V)IO estimator over a generate_sequence() output.

    For VIO, pass init_gyro/init_accel (e.g. static_init_imu) to engage the
    gravity-aligned bootstrap; otherwise the state starts at identity.
    """
    import jax
    import jax.numpy as jnp

    from ..models import estimator as est
    from ..ops import cameras
    from ..models.frontend import FrontendConfig
    from ..ops.klt import KLTConfig

    params = cameras.pack_params(
        cameras.PINHOLE_RADTAN, [scene.fx, scene.fy, scene.cx, scene.cy],
        [0, 0, 0, 0])
    rig = est.make_rig(
        params, params, jnp.eye(4, dtype=jnp.float32),
        jnp.eye(4, dtype=jnp.float32).at[0, 3].set(scene.baseline))
    from ..models import ba as ba_mod
    from ..models import pnp as pnp_mod

    # Per-observation chi^2 outlier gate at gross-outlier scale (~6 px in
    # normalized units) — the defense against moving occluders the
    # reference lacks (Huber 2.0 + bidirectional gate only).
    # RSVIO_CHI2_PX overrides for sensitivity studies.
    chi2 = float(os.environ.get("RSVIO_CHI2_PX", "6.0")) / float(scene.fx)
    base = est.EstimatorConfig(
        frontend=FrontendConfig(
            capacity=capacity, cell_size=cell_size,
            detect_margin=detect_margin,
            # Starvation-adaptive detection floor: keeps weak-texture scenes
            # (e.g. easy_plane) from idling at a handful of tracks.
            # RSVIO_RELAX_SCORE overrides the relaxed floor for sensitivity
            # studies (default 1.0 = FrontendConfig default).
            relax_floor_below=capacity // 2,
            relaxed_min_score=float(
                os.environ.get("RSVIO_RELAX_SCORE", "1.0")),
            klt=KLTConfig(levels=levels, max_iterations=max_iterations,
                          **({} if coarse_level_policy is None else
                             dict(coarse_level_policy=coarse_level_policy)))),
        window_size=window,
        translation_threshold=translation_threshold,
        rotation_threshold=rotation_threshold,
        image_shape=(scene.H, scene.W),
        use_marginalization=use_marginalization,
        # Opt-in CV seeding (ablation evidence; the round-3 regression made
        # this unconditional — see NOTES round-4 findings).
        pnp_cv_predict=pnp_cv_predict,
        # Score-weighted observations (round 4): measured better-or-equal on
        # every matrix scene (easy_plane -24%, photometric -84% ATE on the
        # CPU sweep). RSVIO_OBS_WEIGHTS=0 disables for ablations.
        use_obs_weights=(use_obs_weights
                         and os.environ.get("RSVIO_OBS_WEIGHTS", "1") != "0"),
        # Scene-flow dynamic-object gate (round 4): accumulated reprojection
        # flow threshold in normalized camera units, 0 = off.
        dynamic_flow_thresh=float(
            os.environ.get("RSVIO_DYNFLOW", str(dynamic_flow))),
        dynamic_flow_decay=float(os.environ.get("RSVIO_DYNFLOW_DECAY", "0.7")),
        dynamic_flow_min_n=int(os.environ.get("RSVIO_DYNFLOW_MINN", "2")),
        # Median-centering default: on for VO (unanchored pose drift is
        # common-mode), off for VIO (IMU-anchored pose; centering lets a
        # tight mover cluster capture the median) — overridable.
        dynamic_flow_center=(os.environ.get(
            "RSVIO_DYNFLOW_CENTER", "0" if use_vio else "1") == "1"),
        # Round-5 adaptive defenses: consensus-driven motion prior and
        # vision down-weighting (requires ransac > 0 and motion_prior > 0).
        pnp_prior_adaptive=adaptive,
        vision_weight_adaptive=adaptive,
        health_floor=float(os.environ.get("RSVIO_HEALTH_FLOOR", "0.1")),
        health_f_lo=float(os.environ.get("RSVIO_HEALTH_LO", "0.5")),
        health_f_hi=float(os.environ.get("RSVIO_HEALTH_HI", "0.9")),
        health_recover=float(os.environ.get("RSVIO_HEALTH_RECOVER", "1.0")),
        pnp=pnp_mod.PnPConfig(
            chi2_gate=chi2,
            motion_prior_weight=float(
                os.environ.get("RSVIO_PNP_PRIOR", str(motion_prior))),
            # PnP RANSAC consensus gate (round 4): hypotheses count, 0=off.
            # Inlier threshold mirrors the chi2 gate's pixel->normalized
            # mapping (RSVIO_RANSAC_PX, default 4 px).
            ransac_hypotheses=int(
                os.environ.get("RSVIO_RANSAC", str(ransac))),
            ransac_threshold=float(
                os.environ.get("RSVIO_RANSAC_PX", "4.0")) / float(scene.fx),
            # Age-weighted voting horizon: a long occluder transit
            # (40-80 frames) out-ages the default cap, so the mover's
            # tracks regain full vote weight mid-transit.
            ransac_age_cap=int(
                os.environ.get("RSVIO_RANSAC_AGECAP", "10"))),
        ba=ba_mod.BAConfig(
            chi2_gate=chi2,
            min_lm_span=int(os.environ.get("RSVIO_LM_SPAN", "1"))),
    )

    frames = seq["frames"]
    ts = seq["ts"]
    n = len(frames)

    if use_vio:
        from ..models import estimator_vio as ev
        from ..models import vio_ba
        # Bias random-walk link stiffness: the desert-drag defense (visual
        # drag leaks into the IMU chain through the bias states — NOTES
        # round-4 late / round-5 sweep). kwargs from the profile, RSVIO_BIAS_GW
        # / RSVIO_BIAS_AW env overrides for sensitivity studies.
        _vio_defaults = vio_ba.VIOBAConfig()
        _gw = (bias_gyro_weight if bias_gyro_weight is not None
               else _vio_defaults.bias_gyro_weight)
        _aw = (bias_accel_weight if bias_accel_weight is not None
               else _vio_defaults.bias_accel_weight)
        cfg = ev.VIOEstimatorConfig(
            base=base, imu_buf=imu_buf,
            vio=vio_ba.VIOBAConfig(
                chi2_gate=chi2,
                bias_gyro_weight=float(os.environ.get("RSVIO_BIAS_GW", _gw)),
                bias_accel_weight=float(os.environ.get("RSVIO_BIAS_AW", _aw)),
                bias_gyro_weight_desert=float(os.environ.get(
                    "RSVIO_BIAS_GW_DESERT", bias_gyro_weight_desert)),
                bias_accel_weight_desert=float(os.environ.get(
                    "RSVIO_BIAS_AW_DESERT", bias_accel_weight_desert)),
                min_lm_span=int(os.environ.get("RSVIO_LM_SPAN", "1"))))
        step = ev.make_vio_estimator_step(cfg)
        if init_gyro is not None:
            state = ev.initialize_vio_state(cfg, init_gyro, init_accel)
        else:
            state = ev.init_vio_state(cfg)

        imu_ts = seq["imu_ts"]

        def frame_imu(k):
            lo = ts[k - 1] if k > 0 else ts[0] - (ts[1] - ts[0])
            sel = np.nonzero((imu_ts > lo) & (imu_ts <= ts[k]))[0][:imu_buf]
            gy = np.zeros((imu_buf, 3), np.float32)
            ac = np.zeros((imu_buf, 3), np.float32)
            dt = np.zeros(imu_buf, np.float32)
            mk = np.zeros(imu_buf, bool)
            gy[:len(sel)] = seq["gyro"][sel]
            ac[:len(sel)] = seq["accel"][sel]
            dt[:len(sel)] = seq["imu_dts"][sel]
            mk[:len(sel)] = True
            return (jnp.asarray(gy), jnp.asarray(ac), jnp.asarray(dt),
                    jnp.asarray(mk))
    else:
        step = est.make_estimator_step(base)
        state = est.init_state(base)

    positions = np.zeros((n, 3))
    tracked = np.zeros(n)
    ba_ok = np.zeros(n, bool)
    is_kf = np.zeros(n, bool)
    t0 = time.time()
    for k in range(n):
        left, right = frames[k]
        args = (state, rig, jnp.asarray(left), jnp.asarray(right))
        if use_vio:
            args = args + frame_imu(k)
        state, out = step(*args)
        positions[k] = np.asarray(out.T_W_B[:3, 3])
        tracked[k] = int(out.n_tracked)
        ba_ok[k] = bool(out.ba_success)
        is_kf[k] = bool(out.is_keyframe)
    jax.block_until_ready(state)
    wall = time.time() - t0

    gt = seq["gt_T_W_B"][:, :3, 3]
    # Score the post-fill segment: the first `window` keyframes bootstrap
    # the map (every frame is a keyframe until the window fills).
    fill = int(np.nonzero(np.cumsum(is_kf) >= window)[0][0]) + 1 \
        if is_kf.sum() >= window else n // 3
    skip = min(fill, n - 5)
    rmse, drift = score_positions(positions, gt, skip)
    kf_frames = is_kf[skip:]
    return RunResult(
        positions=positions, gt_positions=gt, ate_rmse=rmse,
        drift_pct=drift, n_tracked_mean=float(tracked[skip:].mean()),
        ba_success_rate=float(ba_ok[skip:][kf_frames].mean())
        if kf_frames.any() else 0.0,
        fps=n / wall, skip=skip)
