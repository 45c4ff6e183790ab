"""Estimator: jit-compiled per-frame VO step — frontend tracking, PnP motion
tracking, keyframe policy, sliding-window roll, triangulation, and BA.

Capability parity (SURVEY.md §2 #10 Estimator::process_frame — ref
src/estimator/estimator.rs:101-259 and #15 SlidingWindow):
  * every frame is a keyframe until the window fills
    (ref frame.rs:96 is_keyframe default + sliding_window.rs:137-157 BA gate)
  * once full: PnP motion tracking from the map, then keyframe test
    ||t_rel|| > translation_threshold OR rot_angle > rotation_threshold vs the
    last keyframe (ref estimator.rs:203-225)
  * keyframes: FIFO window roll (ref sliding_window.rs:73-79), landmark
    triangulation for new tracks (upgrading the fixed-depth-2.0 init of ref
    sliding_window.rs:258), bundle adjustment, rollback on failure
  * PnP failure tolerated: pose left unchanged (ref estimator.rs:228-234)

Design: the whole step is ONE jitted function over fixed-shape
arrays. The keyframe branch runs under lax.cond so BA cost is only paid on
keyframes. Landmarks are slot-aligned with the feature table; feature-id tags
guard against slot recycling inside the window.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import cameras, lie, pyramid
from ..ops.projection import triangulate_stereo
from . import ba as ba_mod
from . import pnp as pnp_mod
from .marginalization import MargPrior, empty_prior
from .frontend import FeatureTable, FrontendConfig, frontend_step, init_table


class EstimatorConfig(NamedTuple):
    """Static configuration (hashable; jit static argument)."""
    frontend: FrontendConfig = FrontendConfig()
    window_size: int = 10             # ref config keyframe_window_size
    translation_threshold: float = 0.05  # ref config (meters)
    rotation_threshold: float = 0.05     # ref config (radians)
    cam_kind_l: str = cameras.PINHOLE_RADTAN
    cam_kind_r: str = cameras.PINHOLE_RADTAN
    pnp: pnp_mod.PnPConfig = pnp_mod.PnPConfig()
    ba: ba_mod.BAConfig = ba_mod.BAConfig()
    image_shape: tuple = (480, 752)   # (H, W)
    # Marginalize evicted keyframes into a dense pose prior instead of
    # dropping their constraints (the accuracy upgrade the reference defers,
    # ref README.md:79). Off by default for reference-parity comparisons.
    use_marginalization: bool = False
    # Track and optimize BEFORE the window fills (the reference holds the
    # pose at identity until then, ref sliding_window.rs:137-157 — frame 0
    # anchors the world frame either way, so early tracking is strictly
    # better; disable for behavior-parity comparisons).
    track_before_full: bool = True
    # Post-BA landmark culling: after a successful window solve, invalidate
    # any landmark whose worst reprojection error across the window exceeds
    # this threshold (normalized camera units; 0 = off). The slot
    # re-triangulates on the next keyframe. Greenfield robustness upgrade —
    # the reference relies on the Huber loss alone. CAUTION: set this loose
    # (gross-outlier scale). A tight threshold culls good landmarks whose
    # window error reflects accumulated pose drift; the resulting
    # retriangulation churn erases the map's scale memory and DEGRADES
    # long-run accuracy (measured: -40% vs +3% displacement error on the
    # 186-frame synthetic bench scene at 0.005).
    cull_reproj_threshold: float = 0.0
    # Polish freshly triangulated landmarks with an N-view point-only GN
    # (poses fixed) over all their window observations before BA — the
    # reference's PinholeProjectionFactor (ref factors.rs:27-133) as a
    # birth-quality upgrade. Off by default (BA refines landmarks anyway;
    # measured neutral on the synthetic matrix).
    refine_births: bool = False
    # Constant-velocity PnP initialization: extrapolate the previous frame's
    # motion to seed (and, with pnp.motion_prior_weight, anchor) the PnP
    # solve. OFF by default — the default init is the current pose, matching
    # the reference's init-from-last-optimized-pose semantics (ref
    # sliding_window.rs:506-515). Measured: on the low-parallax planar bench
    # scene the extrapolation closes a vision-only positive feedback loop
    # (PnP converges slightly scale-inflated, new landmarks triangulate from
    # the inflated pose, BA accepts, the error compounds -> divergence by
    # frame ~30; round-3 regression, commit 7320b34). Use only with an
    # external anchor (IMU) or a strong motion prior at the MEASURED pose.
    pnp_cv_predict: bool = False
    # Score-weighted observations: scale each observation's whitened
    # residual/Jacobian by the feature's birth-score weight (FeatureTable.w,
    # sqrt(score/min_score) clipped to [floor, 1]). Starvation-mode births
    # on weak texture then contribute information proportional to their
    # localization quality instead of pulling BA/PnP with full force.
    # Measured (easy_plane 752x480, 160 frames): ATE 0.14 -> see NOTES
    # round-4. Off = reference-parity equal weighting.
    use_obs_weights: bool = False
    # When the PnP RANSAC gate is on (pnp.ransac_hypotheses > 0), kill the
    # tracks whose map observation lands OUTSIDE the winning consensus set:
    # their landmark is invalidated and the slot frees for re-detection.
    # This is the feedback path that excises a moving occluder's features
    # from the window — without it the gate protects PnP but BA still
    # ingests the occluder observations.
    pnp_ransac_kill: bool = True
    # Stereo scene-flow dynamic-object gate (0 = off). Per keyframe, every
    # alive track is re-triangulated INSTANTANEOUSLY (stereo pair at one
    # timestamp — correct even for a moving point, and pre-BA: BA refits a
    # mover's landmark every keyframe, erasing the evidence); the previous
    # keyframe's triangulation is reprojected into the current left camera
    # and compared to the current observation. That 2D residual flow,
    # median-centered (removes common-mode pose drift) and accumulated
    # with decay dynamic_flow_decay, grows linearly for a coherent mover
    # and cancels for static noise; a track whose accumulated norm exceeds
    # this threshold (NORMALIZED camera units, e.g. ~0.02 = 4-9 px) is
    # killed and its landmark invalidated. This catches what per-frame
    # residual tests (Huber, chi2, RANSAC consensus) structurally CANNOT
    # (measured: on the occlusion matrix scene the consensus gate alone
    # kills ~0 occluder tracks/frame while the pose is dragged 0.03
    # m/frame — the refit landmarks chase the quad).
    dynamic_flow_thresh: float = 0.0
    dynamic_flow_decay: float = 0.7
    # Consecutive keyframe observations required before a kill (guards
    # against a single triangulation glitch exceeding the threshold).
    dynamic_flow_min_n: int = 2
    # Median-center the flow field before accumulating. True removes the
    # common-mode flow a drifting UNANCHORED (VO) pose induces — but a
    # tight mover cluster can capture the component-wise median once it
    # nears majority (static flows spread with 1/depth; the mover's are
    # coherent). With an EXTERNALLY ANCHORED pose (IMU/VIO, strong motion
    # prior) set False: flows are measured against a trustworthy pose and
    # raw accumulation cannot be median-captured.
    dynamic_flow_center: bool = True
    # --- Adaptive track-health defenses (round 5; both require the RANSAC
    # gate, pnp.ransac_hypotheses > 0, which measures per-frame consensus).
    # Health h in [0,1] = ramp of the winning-consensus inlier fraction
    # between health_f_lo and health_f_hi; h=1 when the gate is off/not yet
    # ready; h=health_floor when the gate ran but found no consensus (an
    # information desert).
    #
    # pnp_prior_adaptive: scale the PnP motion prior by (1 - h) — a clean
    # scene (h=1) pays ZERO prior lag while a contaminated/starved frame
    # gets the full pnp.motion_prior_weight pull toward the anchor
    # (VO: measured previous pose; VIO: the IMU prediction). This replaces
    # the fixed-weight vo_dyn tradeoff (88x easy_plane penalty) with a
    # measured-consensus dial.
    pnp_prior_adaptive: bool = False
    # vision_weight_adaptive: multiply the observation weights captured at
    # keyframe insertion by max(h, health_floor), so the window solve
    # down-weights ALL visual information gathered during low-consensus
    # frames — the IMU factors + priors then hold the pose through the
    # desert instead of being dragged by refit survivors (the round-4
    # accel-bias leak). Requires use_obs_weights (the solvers consume the
    # weights) — enforced in make_estimator_step via config validation.
    vision_weight_adaptive: bool = False
    health_f_lo: float = 0.5
    health_f_hi: float = 0.9
    health_floor: float = 0.1
    # Health hysteresis: the effective health DROPS instantly but RECOVERS
    # at most this much per frame (1.0 = no hysteresis). During an occluder
    # transit the raw consensus signal flaps — the mover intermittently
    # wins the (age-weighted) vote and reads healthy — and every flap
    # releases the prior for a frame of drag. With hysteresis one dip keeps
    # the defenses engaged through the transit; clean scenes hold health
    # 1.0 continuously and pay nothing.
    health_recover: float = 1.0
    # Age ramp on the birth discount: recover the effective weight as
    #   w_eff = 1 - (1 - w_birth) * exp(-age_ramp * age)
    # (a surviving track "earns back" trust). MEASURED HARMFUL on the
    # weak-texture matrix scene (easy_plane ATE 0.132 -> 0.165-0.168 at
    # ramps 0.05/0.15): survival of the bidirectional gate does not make a
    # low-texture patch's localization any more precise — the discount
    # must be permanent. 0 = off (default). Only read when use_obs_weights,
    # and only by the VO estimator (the VIO estimators use the permanent
    # birth weight directly — by measurement the ramp should stay off).
    obs_weight_age_ramp: float = 0.0


class CameraRig(NamedTuple):
    """Device arrays describing the stereo rig."""
    params: jnp.ndarray   # (2, 10) packed intrinsics (cameras.pack_params)
    T_C_B: jnp.ndarray    # (2, 4, 4) camera-from-body extrinsics
    T_B_C: jnp.ndarray    # (2, 4, 4) body-from-camera (inverse, precomputed)


def make_rig(params_l, params_r, T_B_Cl, T_B_Cr) -> CameraRig:
    T_B_C = jnp.stack([T_B_Cl, T_B_Cr])
    T_C_B = jnp.stack([lie.se3_inverse(T_B_Cl), lie.se3_inverse(T_B_Cr)])
    return CameraRig(params=jnp.stack([params_l, params_r]),
                     T_C_B=T_C_B, T_B_C=T_B_C)


class EstimatorState(NamedTuple):
    table: FeatureTable
    pyr0: tuple           # previous-frame pyramids (tuples of arrays)
    pyr1: tuple
    # Sliding window (oldest -> newest in the first kf_count entries)
    kf_T_W_B: jnp.ndarray    # (W,4,4)
    kf_count: jnp.ndarray    # () int32
    obs: jnp.ndarray         # (W,2,N,2) normalized observations
    obs_mask: jnp.ndarray    # (W,2,N)
    obs_fid: jnp.ndarray     # (W,N) feature id tags
    # Per-row observation weights captured at keyframe insertion
    # (FeatureTable.w at that time; consumed when use_obs_weights)
    obs_w: jnp.ndarray       # (W,N)
    # Landmarks, slot-aligned with the feature table
    lm: jnp.ndarray          # (N,3)
    lm_fid: jnp.ndarray      # (N,) id tag; valid iff == table.fid and >= 0
    # Marginalization prior over window poses (used when the config enables
    # marginalization; otherwise stays empty)
    marg_prior: MargPrior
    # Current state
    T_W_B: jnp.ndarray       # (4,4) current pose
    last_kf_T_W_B: jnp.ndarray  # (4,4)
    frame_id: jnp.ndarray    # () int32
    # Previous-frame pose: drives the constant-velocity motion model that
    # initializes (and, with pnp.motion_prior_weight, anchors) the PnP
    # solve. The reference initializes PnP from the LAST KEYFRAME pose
    # (ref sliding_window.rs:506-515) — strictly staler.
    T_W_B_prev: jnp.ndarray  # (4,4)
    # Scene-flow gate memory (allocated only when
    # cfg.dynamic_flow_thresh > 0; None otherwise — absent from the pytree)
    tri_prev: jnp.ndarray = None      # (N,3) last-KF instantaneous triang.
    tri_prev_fid: jnp.ndarray = None  # (N,) fid tag at capture
    flow_acc: jnp.ndarray = None      # (N,2) decayed residual-flow sum
    flow_n: jnp.ndarray = None        # (N,) consecutive measurements
    # Frozen birth-time landmark copy for RANSAC verification (allocated
    # only when the consensus gate is on). NEVER refit by BA: a moving
    # object's landmarks chase it under BA refitting, making its
    # observations self-consistent per frame. Against frozen birth anchors
    # the mover DECOHERES with age — its tracks were born at staggered
    # times, so no single rigid pose explains their anchors — while the
    # static world stays consistent regardless of birth time.
    lm_birth: jnp.ndarray = None      # (N,3)
    # Smoothed track-health memory (see EstimatorConfig.health_recover);
    # allocated only when the consensus gate is on.
    health_ema: jnp.ndarray = None    # ()


def init_state(cfg: EstimatorConfig, dtype=jnp.float32) -> EstimatorState:
    N = cfg.frontend.capacity
    W = cfg.window_size
    H, Wd = cfg.image_shape
    shapes = pyramid.pyramid_shapes((H, Wd), cfg.frontend.klt.levels)
    pyr = tuple(jnp.zeros(s, dtype=dtype) for s in shapes)
    eye = jnp.eye(4, dtype=dtype)
    return EstimatorState(
        table=init_table(N, dtype),
        pyr0=pyr, pyr1=pyr,
        kf_T_W_B=jnp.broadcast_to(eye, (W, 4, 4)),
        kf_count=jnp.asarray(0, jnp.int32),
        obs=jnp.zeros((W, 2, N, 2), dtype=dtype),
        obs_mask=jnp.zeros((W, 2, N), dtype=bool),
        obs_fid=jnp.full((W, N), -1, jnp.int32),
        obs_w=jnp.ones((W, N), dtype=dtype),
        lm=jnp.zeros((N, 3), dtype=dtype),
        lm_fid=jnp.full((N,), -1, jnp.int32),
        marg_prior=empty_prior(W, 6, dtype),
        T_W_B=eye, last_kf_T_W_B=eye,
        frame_id=jnp.asarray(0, jnp.int32),
        T_W_B_prev=eye,
        **(dict(tri_prev=jnp.zeros((N, 3), dtype=dtype),
                tri_prev_fid=jnp.full((N,), -1, jnp.int32),
                flow_acc=jnp.zeros((N, 2), dtype=dtype),
                flow_n=jnp.zeros((N,), jnp.int32))
           if cfg.dynamic_flow_thresh > 0 else {}),
        **(dict(lm_birth=jnp.zeros((N, 3), dtype=dtype),
                health_ema=jnp.asarray(1.0, dtype))
           if cfg.pnp.ransac_hypotheses > 0 else {}),
    )


class FrameOutput(NamedTuple):
    T_W_B: jnp.ndarray
    is_keyframe: jnp.ndarray
    pnp_success: jnp.ndarray
    ba_success: jnp.ndarray
    ba_iterations: jnp.ndarray
    ba_final_cost: jnp.ndarray
    n_tracked: jnp.ndarray    # tracks surviving this frame's temporal pass
    n_landmarks: jnp.ndarray
    n_alive: jnp.ndarray      # table occupancy after births (kill-rate calc)
    # Numerical health (round-3 postmortem — a NaN pose shipped silently):
    # False when the motion stage had to recover a non-finite pose to the
    # last keyframe. The OUTPUT pose is finite either way; this flags that
    # recovery fired so logs/bench can surface it.
    pose_ok: jnp.ndarray = True
    # Tracks killed by the scene-flow dynamic-object gate this frame.
    n_dyn_killed: jnp.ndarray = 0
    # Winning RANSAC consensus size (0 when the gate is off/idle) and the
    # number of PnP candidate observations — together the per-frame
    # track-health signal (inlier fraction) that drives the adaptive
    # defenses and surfaces in logs/bench.
    n_ransac_inliers: jnp.ndarray = 0
    n_pnp_candidates: jnp.ndarray = 0
    # Consensus track-health signal (MotionOut.health; 1.0 = healthy/off).
    health: jnp.ndarray = 1.0


def effective_weights(cfg: EstimatorConfig, table: FeatureTable):
    """Per-slot observation weights: birth score discount, optionally
    forgiven with age (see EstimatorConfig.obs_weight_age_ramp)."""
    w = table.w
    if cfg.obs_weight_age_ramp > 0.0:
        w = 1.0 - (1.0 - w) * jnp.exp(
            -cfg.obs_weight_age_ramp * table.age.astype(w.dtype))
    return w


def _undistort_table(cfg: EstimatorConfig, rig: CameraRig, table: FeatureTable):
    """Normalized coords for all table slots in both cams: (2,N,2), (2,N)."""
    un_l = jax.vmap(lambda uv: cameras.unproject(cfg.cam_kind_l, rig.params[0], uv))
    un_r = jax.vmap(lambda uv: cameras.unproject(cfg.cam_kind_r, rig.params[1], uv))
    xy0 = un_l(table.pos0)
    xy1 = un_r(table.pos1)
    obs = jnp.stack([xy0, xy1])                     # (2,N,2)
    mask = jnp.stack([table.alive, table.alive])    # (2,N)
    return obs, mask


def _triangulate_new(rig: CameraRig, T_W_B, obs_cur, table: FeatureTable,
                     lm, lm_fid):
    """Triangulate landmarks for alive slots without a valid landmark.

    Returns (lm, lm_fid, born, tri_all, tri_ok) — born marks slots
    triangulated THIS call (used by the optional N-view birth refinement);
    tri_all/tri_ok are the instantaneous stereo triangulations of EVERY
    slot (consumed by the scene-flow dynamic-object gate)."""
    T_W_C = jnp.einsum("ij,cjk->cik", T_W_B, rig.T_B_C)  # (2,4,4)
    tri = jax.vmap(lambda xl, xr: triangulate_stereo(T_W_C[0], T_W_C[1], xl, xr))
    p, tri_ok = tri(obs_cur[0], obs_cur[1])
    has_lm = (lm_fid == table.fid) & (lm_fid >= 0)
    want = table.alive & (~has_lm) & tri_ok
    lm = jnp.where(want[:, None], p, lm)
    lm_fid = jnp.where(want, table.fid, lm_fid)
    # Invalidate landmarks whose slot was recycled or died.
    stale = (lm_fid != table.fid) | (~table.alive)
    lm_fid = jnp.where(stale & ~want, -1, lm_fid)
    return lm, lm_fid, want, p, tri_ok


def reprojection_outliers(T_C_B, kf_T_W_B, lm, obs, eff_mask, lm_valid,
                          thr_sq):
    """Landmarks whose WORST squared reprojection error over the window
    exceeds thr_sq (or that fall behind a camera). Returns (N,) bool."""
    T_B_W = jax.vmap(lie.se3_inverse)(kf_T_W_B)

    def err_one(T_bw, Tcb, p, o):
        p_C = Tcb[:3, :3] @ (T_bw[:3, :3] @ p + T_bw[:3, 3]) + Tcb[:3, 3]
        z = jnp.maximum(p_C[2], 1e-6)
        proj = p_C[:2] / z
        e = jnp.sum((proj - o) ** 2)
        return jnp.where(p_C[2] > 1e-6, e, jnp.inf)

    f = jax.vmap(jax.vmap(jax.vmap(
        err_one, in_axes=(None, None, 0, 0)), in_axes=(None, 0, None, 0)),
        in_axes=(0, None, None, 0))
    err = f(T_B_W, T_C_B, lm, obs)          # (W,2,N)
    err = jnp.where(eff_mask, err, 0.0)
    worst = jnp.max(err, axis=(0, 1))       # (N,)
    return lm_valid & (worst > thr_sq)


def scene_flow_gate(cfg: EstimatorConfig, rig: CameraRig, T_cur, obs_cur,
                    obs_cur_mask, table: FeatureTable, tri_all, tri_ok,
                    tri_prev, tri_prev_fid, flow_acc, flow_n):
    """Stereo scene-flow dynamic-object gate (shared by the VO and VIO
    estimators; see EstimatorConfig.dynamic_flow_thresh for the design).

    Args: tri_all/tri_ok = this keyframe's instantaneous triangulation of
    every slot; tri_prev/tri_prev_fid/flow_acc/flow_n = gate memory from
    the previous keyframe.

    Returns (kill_dyn (N,), tri_mem, n_dyn) where tri_mem is the updated
    (tri_prev, tri_prev_fid, flow_acc, flow_n) tuple.
    """
    tri_valid = tri_ok & table.alive
    T_C_W = rig.T_C_B[0] @ lie.se3_inverse(T_cur)
    pC = (tri_prev @ T_C_W[:3, :3].T) + T_C_W[:3, 3]
    in_front = pC[:, 2] > 1e-6
    proj = pC[:, :2] / jnp.maximum(pC[:, 2:3], 1e-6)
    have_flow = (tri_valid & in_front & obs_cur_mask[0]
                 & (tri_prev_fid == table.fid) & (tri_prev_fid >= 0))
    flow = obs_cur[0] - proj                     # (N,2)
    if cfg.dynamic_flow_center:
        med = jnp.nanmedian(
            jnp.where(have_flow[:, None], flow, jnp.nan), axis=0)
        med = jnp.where(jnp.isfinite(med), med, 0.0)
        flow = flow - med
    acc = jnp.where(have_flow[:, None],
                    cfg.dynamic_flow_decay * flow_acc + flow, 0.0)
    n_fl = jnp.where(have_flow, flow_n + 1, 0)
    kill_dyn = (have_flow & (n_fl >= cfg.dynamic_flow_min_n)
                & (jnp.linalg.norm(acc, axis=1) > cfg.dynamic_flow_thresh))
    acc = jnp.where(kill_dyn[:, None], 0.0, acc)
    n_fl = jnp.where(kill_dyn, 0, n_fl)
    tri_mem = (tri_all,
               jnp.where(tri_valid & ~kill_dyn, table.fid, -1), acc, n_fl)
    return kill_dyn, tri_mem, jnp.sum(kill_dyn.astype(jnp.int32))


class MotionOut(NamedTuple):
    """Motion-stage outputs, bound BY NAME so adding a field cannot silently
    break a consumer that unpacks positionally (the round-4 failure mode:
    stage_motion grew a 5th return and the distributed estimator crashed)."""
    T_cur: jnp.ndarray        # (4,4) current pose after PnP + health gate
    pnp_success: jnp.ndarray  # () bool (includes pose_ok)
    is_kf: jnp.ndarray        # () bool keyframe decision
    pose_ok: jnp.ndarray      # () bool numerical-health flag
    kill: jnp.ndarray         # (N,) RANSAC outlier excision set
    ransac_ok: jnp.ndarray    # () bool consensus gate engaged + won
    n_inliers: jnp.ndarray    # () int32 winning consensus size (0 when off)
    n_pnp: jnp.ndarray        # () int32 PnP candidate observations
    # Track health in [0,1] from the consensus inlier fraction (1.0 when
    # the gate is off or not yet engaged) — drives the adaptive prior and
    # adaptive vision weighting (EstimatorConfig.pnp_prior_adaptive /
    # vision_weight_adaptive).
    health: jnp.ndarray = 1.0


class KFPrep(NamedTuple):
    """Keyframe prologue outputs (triangulation, scene-flow gate, window
    roll, birth refinement) — everything the window solve and the epilogue
    need. Produced by stage_kf_pre and consumed IDENTICALLY by the fused
    single-device step and the host-orchestrated distributed step, so the
    two cannot drift apart numerically."""
    table: FeatureTable       # after dynamic-object excision
    kf_T: jnp.ndarray         # (W,4,4) rolled window incl. this keyframe
    kf_count: jnp.ndarray     # () int32 NEW count
    obs_w: jnp.ndarray        # (W,2,N,2)
    obs_m: jnp.ndarray        # (W,2,N)
    obs_f: jnp.ndarray        # (W,N)
    obs_wt: jnp.ndarray       # (W,N)
    lm: jnp.ndarray           # (N,3) incl. fresh triangulations
    lm_fid: jnp.ndarray       # (N,)
    eff_mask: jnp.ndarray     # (W,2,N) BA observation validity
    lm_valid: jnp.ndarray     # (N,)
    tri_mem: tuple            # scene-flow gate memory (4-tuple, may be Nones)
    n_dyn: jnp.ndarray        # () int32 tracks killed by the flow gate
    lm_birth: jnp.ndarray     # (N,3) frozen birth map (None when gate off)
    full_now: jnp.ndarray     # () bool — run BA this keyframe
    will_evict: jnp.ndarray   # () bool — next insert rolls the window


class Stages(NamedTuple):
    """The per-frame step as named stage functions mirroring the reference's
    [Timing] breakdown (ref estimator.rs:252-259):

      frame_creation   -> frames   (pyramid construction)
      patch_tracking   -> track    (KLT frontend + undistortion)
      motion_tracking  -> motion   (RANSAC gate + PnP + keyframe policy)
      optimization     -> opt      (excise + kf_pre + BA + kf_post, fused)

    plus the sub-stages of `opt` (excise / kf_pre / kf_post) exposed so the
    distributed estimator can compose the SAME functions around its sharded
    window solve (parallel.dist_estimator) instead of re-implementing the
    prologue — the round-4 unpack crash came from exactly that duplication.
    """
    frames: callable
    track: callable
    motion: callable
    opt: callable
    excise: callable
    kf_pre: callable
    kf_post: callable
    ba_solve: callable   # single-device window solve (dist swaps this)


def validate_adaptive_knobs(cfg: EstimatorConfig) -> None:
    """Knob-coherence validation (the silently-inert-knob rule): the
    adaptive defenses need the consensus signal and the weight channel.
    Called by both the VO and VIO stage builders."""
    if ((cfg.pnp_prior_adaptive or cfg.vision_weight_adaptive)
            and cfg.pnp.ransac_hypotheses <= 0):
        raise ValueError(
            "pnp_prior_adaptive / vision_weight_adaptive require the RANSAC "
            "consensus gate (pnp.ransac_hypotheses > 0) as the health signal")
    if cfg.pnp_prior_adaptive and cfg.pnp.motion_prior_weight <= 0.0:
        raise ValueError(
            "pnp_prior_adaptive scales pnp.motion_prior_weight — set a "
            "positive base weight")
    if cfg.vision_weight_adaptive and not cfg.use_obs_weights:
        raise ValueError(
            "vision_weight_adaptive modulates the observation weights — "
            "enable use_obs_weights so the solvers consume them")


def excise_outliers(table: FeatureTable, obs_cur_mask, lm_fid, kill):
    """Apply RANSAC outlier excision BEFORE the window insert: the killed
    slot's landmark invalidates, its current-frame observation never enters
    the window, and the slot frees for re-detection next frame.
    (Past-window observations die with the landmark: eff_mask in
    stage_kf_pre requires a VALID landmark via lm_valid.) Shared by the VO
    and VIO estimators, fused and distributed."""
    return (table._replace(alive=table.alive & ~kill),
            obs_cur_mask & ~kill[None, :],
            jnp.where(kill, -1, lm_fid))


def run_motion(cfg: EstimatorConfig, rig: CameraRig, table, obs_cur,
               obs_cur_mask, lm, lm_fid, lm_birth, kf_count, last_kf_T_W_B,
               frame_id, T_pred, T_gate_seed, T_prior, T_fallback,
               obs_w_slots=None, cv_bound_check=False,
               health_prev=None) -> MotionOut:
    """PnP motion tracking + keyframe policy, shared by the VO and VIO
    estimators (single-device and distributed): optional RANSAC consensus
    pre-gate, LM PnP polish with optional motion prior and score weights,
    numerical-health recovery, the keyframe test, and the outlier-kill set.

    Args beyond the obvious:
      T_pred: pose initializing the PnP solve (VO: current / CV-extrapolated
        pose, ref sliding_window.rs:506-515; VIO: the IMU prediction).
      T_gate_seed: pose seeding the RANSAC hypothesis solves.
      T_prior: anchor of the optional motion prior — MUST be a measured pose
        or an EXTERNAL (IMU) prediction, never a vision extrapolation (see
        pnp.solve_pnp: feedback runaway).
      T_fallback: pose kept when PnP fails (ref estimator.rs:228-234).
      obs_w_slots: optional (N,) per-slot observation weights.
      cv_bound_check: apply the keyframe-relative motion bound (the CV
        extrapolation runaway guard; VO with pnp_cv_predict only).
    """
    W = cfg.window_size
    window_full = kf_count >= W
    # PnP engages once any landmarks exist (frame 0 anchors the gauge); with
    # track_before_full=False it waits for a full window like the reference.
    pnp_ready = window_full if not cfg.track_before_full else (kf_count >= 1)

    lm_ok = (lm_fid == table.fid) & (lm_fid >= 0) & table.alive
    pnp_mask = obs_cur_mask & lm_ok[None, :]
    n_pnp = jnp.sum(pnp_mask.astype(jnp.int32))

    use_ransac = cfg.pnp.ransac_hypotheses > 0
    if use_ransac:
        # Consensus pre-gate: PnP sees only the winning rigid-motion
        # group (see pnp.ransac_pnp_gate). Key is derived from the frame
        # id — deterministic replay, no host RNG in the jitted step.
        key = jax.random.fold_in(jax.random.PRNGKey(0x5A11AC), frame_id)

        def run_gate(_):
            # Verify against the FROZEN birth-time landmarks (see
            # EstimatorState.lm_birth) — the BA-refit map chases a
            # moving object, hiding it from any per-frame test.
            return pnp_mod.ransac_pnp_gate(
                T_gate_seed, rig.T_C_B, lm_birth, obs_cur,
                pnp_mask, key, cfg.pnp, age=table.age)

        def skip_gate(_):
            return pnp_mask, jnp.asarray(False), jnp.asarray(0, jnp.int32)

        inl_mask, ransac_ok, n_inl = jax.lax.cond(
            pnp_ready, run_gate, skip_gate, None)
    else:
        inl_mask, ransac_ok = pnp_mask, jnp.asarray(False)
        n_inl = jnp.asarray(0, jnp.int32)

    dtype = T_pred.dtype
    if use_ransac:
        # Track health: consensus inlier fraction ramped between
        # [health_f_lo, health_f_hi]; a gate that RAN but found no
        # consensus is an information desert (health_floor); a gate not
        # yet engaged reads healthy.
        f_inl = n_inl.astype(dtype) / jnp.maximum(n_pnp.astype(dtype), 1.0)
        ramp = jnp.clip((f_inl - cfg.health_f_lo)
                        / max(cfg.health_f_hi - cfg.health_f_lo, 1e-6),
                        0.0, 1.0)
        health = jnp.where(ransac_ok, ramp,
                           jnp.asarray(cfg.health_floor, dtype))
        health = jnp.where(pnp_ready, health, jnp.asarray(1.0, dtype))
        if cfg.health_recover < 1.0 and health_prev is not None:
            # Hysteresis: drop instantly, recover at most health_recover
            # per frame (see EstimatorConfig.health_recover).
            health = jnp.minimum(
                health, health_prev + jnp.asarray(cfg.health_recover, dtype))
    else:
        health = jnp.asarray(1.0, dtype)

    # NOTE (measured, round 5): do NOT scale the PnP observations by
    # health here. The adaptive prior already arbitrates prediction-vs-
    # vision in the polish; additionally shrinking the visual normal
    # equations suppresses the per-frame correction of IMU bias drift on
    # every mildly-degraded frame and COMPOUNDS (occlusion vio drift
    # 14.4% -> 41.9% on the 320px/160f transit). Health-weighting belongs
    # in the WINDOW solve (stage_kf_pre), where IMU factors can arbitrate.

    def run_pnp(_):
        res = pnp_mod.solve_pnp(T_pred, rig.T_C_B, lm,
                                obs_cur, inl_mask, cfg.pnp,
                                T_W_B_prior=T_prior,
                                obs_weight=obs_w_slots,
                                prior_scale=(1.0 - health
                                             if cfg.pnp_prior_adaptive
                                             else None))
        return res.T_W_B, res.success

    def skip_pnp(_):
        return T_fallback, jnp.asarray(False)

    T_pnp, pnp_success = jax.lax.cond(pnp_ready, run_pnp, skip_pnp, None)
    if cv_bound_check:
        # Keyframe-relative motion bound (CV path only): legitimate
        # motion since the last keyframe is ~threshold + a few frames
        # (exceeding the threshold CREATES a keyframe), so a result far
        # beyond it is the feedback loop, not the camera. Fail PnP
        # (pose unchanged) instead of accepting the runaway.
        rel = lie.se3_inverse(last_kf_T_W_B) @ T_pnp
        bound_ok = ((jnp.linalg.norm(rel[:3, 3])
                     <= 10.0 * cfg.translation_threshold + 0.5)
                    & (lie.rotation_angle(rel[:3, :3])
                       <= 10.0 * cfg.rotation_threshold + 0.5))
        pnp_success = pnp_success & bound_ok
    T_cur = jnp.where(pnp_success, T_pnp, T_fallback)

    # Numerical-health gate (round-3 postmortem: a non-finite pose froze
    # the keyframe policy forever — NaN comparisons are False — and the
    # landmark table bled out while every artifact said "success"). A
    # non-finite current pose recovers to the last keyframe pose, which
    # is finite by induction (gated downstream before entering the window).
    pose_ok = jnp.all(jnp.isfinite(T_cur))
    T_cur = jnp.where(pose_ok, T_cur, last_kf_T_W_B)

    # --- keyframe policy (ref estimator.rs:203-225)
    T_rel = lie.se3_inverse(last_kf_T_W_B) @ T_cur
    t_norm = jnp.linalg.norm(T_rel[:3, 3])
    r_norm = lie.rotation_angle(T_rel[:3, :3])
    is_kf = jnp.where(
        window_full,
        (t_norm > cfg.translation_threshold) | (r_norm > cfg.rotation_threshold),
        True)  # every frame is a keyframe until the window fills

    # RANSAC outlier excision (see EstimatorConfig.pnp_ransac_kill):
    # tracks whose map observation fell outside the winning consensus
    # set are killed — only when the gate engaged AND the polish solve
    # succeeded (a failed solve says nothing about the observations).
    if use_ransac and cfg.pnp_ransac_kill:
        kill = (jnp.any(pnp_mask & ~inl_mask, axis=0)
                & ransac_ok & pnp_success & pose_ok)
    else:
        kill = jnp.zeros(table.alive.shape, dtype=bool)
    return MotionOut(T_cur=T_cur, pnp_success=pnp_success & pose_ok,
                     is_kf=is_kf, pose_ok=pose_ok, kill=kill,
                     ransac_ok=ransac_ok, n_inliers=n_inl, n_pnp=n_pnp,
                     health=health)


def _build_stages(cfg: EstimatorConfig) -> Stages:
    """Build the named per-frame stage functions (see Stages).

    make_estimator_step composes them into ONE jitted step (production);
    make_estimator_split_step jits each separately and times the boundaries
    (debug parity mode — the fused step cannot observe stage times);
    parallel.dist_estimator composes the same sub-stages around the
    landmark-sharded window solve."""

    W = cfg.window_size
    levels = cfg.frontend.klt.levels

    validate_adaptive_knobs(cfg)

    def stage_frames(img0, img1):
        return pyramid.build_pyramid(img0, levels), \
            pyramid.build_pyramid(img1, levels)

    def stage_track(state: EstimatorState, rig: CameraRig, pyr0, pyr1):
        # Frontend tracking (single trace: first frame has no prev pyramids;
        # we fold it into data: prev pyramids start as zeros and survivors
        # are masked by frame_id > 0).
        table_in = state.table._replace(
            alive=state.table.alive & (state.frame_id > 0))
        table, fstats = frontend_step(
            table_in, state.pyr0, state.pyr1, pyr0, pyr1, cfg.frontend)
        obs_cur, obs_cur_mask = _undistort_table(cfg, rig, table)
        return table, fstats, obs_cur, obs_cur_mask

    def stage_motion(state: EstimatorState, rig: CameraRig, table,
                     obs_cur, obs_cur_mask) -> MotionOut:
        if cfg.pnp_cv_predict:
            # OPT-IN constant-velocity prediction: T_pred = T * (T_prev^-1 T).
            # Guarded: a BA jump or bootstrap transient in the per-frame
            # delta would be DOUBLED by extrapolation; implausible deltas
            # fall back to the last KEYFRAME pose (a measured anchor — the
            # current pose could itself be the divergent one).
            delta_cv = lie.se3_inverse(state.T_W_B_prev) @ state.T_W_B
            cv_ok = (jnp.all(jnp.isfinite(delta_cv))
                     & (jnp.linalg.norm(delta_cv[:3, 3]) < 0.5)
                     & (lie.rotation_angle(delta_cv[:3, :3]) < 0.5))
            T_pred = jnp.where(cv_ok, state.T_W_B @ delta_cv,
                               state.last_kf_T_W_B)
        else:
            # Default: init from the current (last-optimized) pose — the
            # reference's semantics (ref sliding_window.rs:506-515) and the
            # long-run-stable configuration (see pnp_cv_predict docstring).
            T_pred = state.T_W_B
        # Motion prior anchored at the MEASURED previous pose — anchoring at
        # an extrapolated prediction closes a vision-only feedback loop
        # (measured runaway; see solve_pnp docstring).
        return run_motion(
            cfg, rig, table, obs_cur, obs_cur_mask,
            state.lm, state.lm_fid, state.lm_birth,
            state.kf_count, state.last_kf_T_W_B, state.frame_id,
            T_pred=T_pred, T_gate_seed=state.T_W_B, T_prior=state.T_W_B,
            T_fallback=state.T_W_B,
            obs_w_slots=(effective_weights(cfg, table)
                         if cfg.use_obs_weights else None),
            cv_bound_check=cfg.pnp_cv_predict,
            health_prev=state.health_ema)

    stage_excise = excise_outliers

    def stage_kf_pre(state: EstimatorState, rig: CameraRig, table, obs_cur,
                     obs_cur_mask, T_cur, health=1.0) -> KFPrep:
        """Keyframe prologue: triangulate new landmarks, run the scene-flow
        dynamic-object gate, FIFO-roll the window, insert the frame, build
        the BA masks, optionally polish fresh births. `state` must already
        carry the excised lm_fid (stage_excise)."""
        window_full = state.kf_count >= W
        lm, lm_fid, born, tri_all, tri_ok = _triangulate_new(
            rig, T_cur, obs_cur, table, state.lm, state.lm_fid)

        if cfg.dynamic_flow_thresh > 0:
            kill_dyn, tri_mem, n_dyn = scene_flow_gate(
                cfg, rig, T_cur, obs_cur, obs_cur_mask, table,
                tri_all, tri_ok, state.tri_prev, state.tri_prev_fid,
                state.flow_acc, state.flow_n)
            table = table._replace(alive=table.alive & ~kill_dyn)
            lm_fid = jnp.where(kill_dyn, -1, lm_fid)
        else:
            tri_mem = (state.tri_prev, state.tri_prev_fid,
                       state.flow_acc, state.flow_n)
            n_dyn = jnp.asarray(0, jnp.int32)
        obs_cur_mask_eff = obs_cur_mask & table.alive[None, :]
        # Frozen verification map: capture births, never refit.
        lm_birth = (jnp.where(born[:, None], tri_all, state.lm_birth)
                    if state.lm_birth is not None else None)

        # FIFO roll: if full, shift left; insert at min(kf_count, W-1).
        ins = jnp.minimum(state.kf_count, W - 1)

        def roll_if_full(arr):
            rolled = jnp.roll(arr, -1, axis=0)
            return jnp.where(window_full, rolled, arr)

        kf_T = roll_if_full(state.kf_T_W_B).at[ins].set(T_cur)
        obs_w = roll_if_full(state.obs).at[ins].set(obs_cur)
        obs_m = roll_if_full(state.obs_mask).at[ins].set(obs_cur_mask_eff)
        obs_f = roll_if_full(state.obs_fid).at[ins].set(table.fid)
        w_ins = effective_weights(cfg, table)
        if cfg.vision_weight_adaptive:
            # Low-consensus frames contribute proportionally less visual
            # information to the window solve (see EstimatorConfig).
            w_ins = w_ins * jnp.maximum(jnp.asarray(health, w_ins.dtype),
                                        cfg.health_floor)
        obs_wt = roll_if_full(state.obs_w).at[ins].set(w_ins)
        kf_count = jnp.minimum(state.kf_count + 1, W)

        # BA once >= 2 keyframes exist (or, for reference parity, only
        # when the window is full — ref sliding_window.rs:137-157).
        full_now = (kf_count >= W if not cfg.track_before_full
                    else kf_count >= 2)
        # Observation valid only if slot not recycled since that KF.
        eff_mask = obs_m & (obs_f == table.fid[None, :])[:, None, :]
        # Zero out rows for not-yet-filled KF slots.
        kf_valid = jnp.arange(W) < kf_count
        eff_mask = eff_mask & kf_valid[:, None, None]
        lm_valid = (lm_fid == table.fid) & (lm_fid >= 0)

        if cfg.refine_births:
            # Polish freshly triangulated landmarks against EVERY window
            # observation of their feature (poses fixed) before they
            # enter BA — the reference's PinholeProjectionFactor as a
            # birth-quality upgrade (ref factors.rs:27-133).
            from ..ops.projection import refine_landmarks
            T_B_W_w = jax.vmap(lie.se3_inverse)(kf_T)
            mask_b = eff_mask & born[None, None, :]
            lm_ref, ok_ref = refine_landmarks(rig.T_C_B, T_B_W_w, lm,
                                              obs_w, mask_b)
            lm = jnp.where((born & ok_ref)[:, None], lm_ref, lm)

        return KFPrep(table=table, kf_T=kf_T, kf_count=kf_count,
                      obs_w=obs_w, obs_m=obs_m, obs_f=obs_f, obs_wt=obs_wt,
                      lm=lm, lm_fid=lm_fid, eff_mask=eff_mask,
                      lm_valid=lm_valid, tri_mem=tri_mem, n_dyn=n_dyn,
                      lm_birth=lm_birth, full_now=full_now,
                      # will_evict: the NEXT keyframe insert rolls the window
                      # only once it is at capacity — producing a rolled
                      # prior any earlier (e.g. at full_now with
                      # track_before_full) would misalign the prior slots
                      # with the un-rolled window.
                      will_evict=kf_count >= W)

    def ba_solve(prep: KFPrep, rig: CameraRig, marg_prior):
        """Single-device window solve; the distributed step swaps this for
        parallel.dist_ba with identical argument semantics."""
        ba_w = prep.obs_wt if cfg.use_obs_weights else None
        if cfg.use_marginalization:
            res, new_prior = ba_mod.solve_ba_marginalized(
                prep.kf_T, rig.T_C_B, prep.lm, prep.obs_w, prep.eff_mask,
                prep.lm_valid, marg_prior, prep.will_evict, cfg.ba,
                obs_weight=ba_w)
        else:
            res = ba_mod.solve_ba(prep.kf_T, rig.T_C_B, prep.lm, prep.obs_w,
                                  prep.eff_mask, prep.lm_valid, cfg.ba,
                                  obs_weight=ba_w)
            new_prior = marg_prior
        return (res.T_W_B, res.landmarks, res.success, res.iterations,
                res.final_cost, new_prior)

    def stage_kf_post(prep: KFPrep, rig: CameraRig, res_T, res_lm, ba_ok):
        """Keyframe epilogue: accept/reject the solve (the single-device
        solvers also roll back internally, so the `where` is a no-op there;
        the distributed solvers rely on it), optional reprojection culling,
        and the new current pose."""
        kf_T = jnp.where(ba_ok, res_T, prep.kf_T)
        lm = jnp.where(ba_ok, res_lm, prep.lm)
        lm_fid = prep.lm_fid
        if cfg.cull_reproj_threshold > 0.0:
            bad = reprojection_outliers(
                rig.T_C_B, kf_T, lm, prep.obs_w, prep.eff_mask,
                prep.lm_valid, cfg.cull_reproj_threshold ** 2) & ba_ok
            lm_fid = jnp.where(bad, -1, lm_fid)
        T_new = kf_T[jnp.minimum(prep.kf_count, W) - 1]
        return kf_T, lm, lm_fid, T_new

    def stage_opt(state: EstimatorState, rig: CameraRig, pyr0, pyr1, table,
                  fstats, obs_cur, obs_cur_mask, mo: MotionOut):
        table, obs_cur_mask, lm_fid0 = stage_excise(
            table, obs_cur_mask, state.lm_fid, mo.kill)
        state = state._replace(lm_fid=lm_fid0)
        T_cur = mo.T_cur
        is_kf, pnp_success, pose_ok = mo.is_kf, mo.pnp_success, mo.pose_ok

        # --- keyframe branch: triangulate, roll window, BA
        def kf_branch(_):
            prep = stage_kf_pre(state, rig, table, obs_cur, obs_cur_mask,
                                T_cur, mo.health)

            def run_ba(_):
                return ba_solve(prep, rig, state.marg_prior)

            def skip_ba(_):
                return (prep.kf_T, prep.lm, jnp.asarray(False),
                        jnp.asarray(0, jnp.int32),
                        jnp.asarray(0.0, prep.kf_T.dtype), state.marg_prior)

            res_T, res_lm, ba_ok, ba_it, ba_cost, new_prior = jax.lax.cond(
                prep.full_now, run_ba, skip_ba, None)
            kf_T, lm, lm_fid, T_new = stage_kf_post(prep, rig, res_T,
                                                    res_lm, ba_ok)
            return (kf_T, prep.kf_count, prep.obs_w, prep.obs_m, prep.obs_f,
                    prep.obs_wt, lm, lm_fid,
                    T_new, T_new, ba_ok, ba_it, ba_cost, new_prior,
                    prep.table.alive, prep.tri_mem, prep.n_dyn,
                    prep.lm_birth)

        def no_kf_branch(_):
            return (state.kf_T_W_B, state.kf_count, state.obs, state.obs_mask,
                    state.obs_fid, state.obs_w, state.lm, state.lm_fid, T_cur,
                    state.last_kf_T_W_B,
                    jnp.asarray(False), jnp.asarray(0, jnp.int32),
                    jnp.asarray(0.0, T_cur.dtype), state.marg_prior,
                    table.alive,
                    (state.tri_prev, state.tri_prev_fid,
                     state.flow_acc, state.flow_n),
                    jnp.asarray(0, jnp.int32), state.lm_birth)

        (kf_T, kf_count, obs_w, obs_m, obs_f, obs_wt, lm, lm_fid, T_out,
         last_kf, ba_ok, ba_it, ba_cost, marg_prior, alive_out, tri_mem,
         n_dyn, lm_birth_out) = jax.lax.cond(
            is_kf, kf_branch, no_kf_branch, None)
        table = table._replace(alive=alive_out)

        new_state = EstimatorState(
            table=table, pyr0=pyr0, pyr1=pyr1,
            kf_T_W_B=kf_T, kf_count=kf_count,
            obs=obs_w, obs_mask=obs_m, obs_fid=obs_f, obs_w=obs_wt,
            lm=lm, lm_fid=lm_fid, marg_prior=marg_prior,
            T_W_B=T_out, last_kf_T_W_B=last_kf,
            frame_id=state.frame_id + 1,
            # Motion-model memory: the incoming state.T_W_B is frame k-1's
            # OUTPUT pose, so the CV delta at frame k+1 pairs two
            # consecutive post-update poses — a BA correction on a keyframe
            # therefore DOES enter the velocity estimate for one frame; the
            # cv_ok implausibility guard bounds it (and pnp_cv_predict is
            # off by default).
            T_W_B_prev=state.T_W_B,
            tri_prev=tri_mem[0], tri_prev_fid=tri_mem[1],
            flow_acc=tri_mem[2], flow_n=tri_mem[3],
            lm_birth=lm_birth_out,
            health_ema=(mo.health if state.health_ema is not None else None),
        )
        out = FrameOutput(
            T_W_B=T_out, is_keyframe=is_kf, pnp_success=pnp_success,
            ba_success=ba_ok, ba_iterations=ba_it, ba_final_cost=ba_cost,
            n_tracked=fstats["tracked"], n_landmarks=jnp.sum(
                ((lm_fid == table.fid) & (lm_fid >= 0)).astype(jnp.int32)),
            n_alive=fstats["alive"], pose_ok=pose_ok, n_dyn_killed=n_dyn,
            n_ransac_inliers=mo.n_inliers, n_pnp_candidates=mo.n_pnp,
            health=mo.health,
        )
        return new_state, out

    return Stages(frames=stage_frames, track=stage_track,
                  motion=stage_motion, opt=stage_opt, excise=stage_excise,
                  kf_pre=stage_kf_pre, kf_post=stage_kf_post,
                  ba_solve=ba_solve)


def make_estimator_step(cfg: EstimatorConfig):
    """Build the jitted per-frame step: (state, rig, img0, img1) -> (state, out)."""
    st = _build_stages(cfg)

    def step(state: EstimatorState, rig: CameraRig, img0, img1):
        pyr0, pyr1 = st.frames(img0, img1)
        table, fstats, obs_cur, obs_cur_mask = st.track(
            state, rig, pyr0, pyr1)
        mo = st.motion(state, rig, table, obs_cur, obs_cur_mask)
        return st.opt(state, rig, pyr0, pyr1, table, fstats, obs_cur,
                      obs_cur_mask, mo)

    return jax.jit(step)


STAGE_NAMES = ("frame_creation", "patch_tracking", "motion_tracking",
               "optimization")


def make_estimator_split_step(cfg: EstimatorConfig):
    """Debug/profiling variant with the reference's per-frame stage split
    (ref estimator.rs:252-259): each stage is jitted separately and timed
    with a device sync at every boundary.

    Returns step(state, rig, img0, img1) -> (state, out, times_ms) where
    times_ms is a dict over STAGE_NAMES (host floats, milliseconds).
    Numerically identical to make_estimator_step (same stage functions,
    composed instead of fused); slower due to sync barriers and lost
    cross-stage fusion — use for diagnosis, not production.
    """
    import time

    st = _build_stages(cfg)
    j_frames = jax.jit(st.frames)
    j_track = jax.jit(st.track)
    j_motion = jax.jit(st.motion)
    j_opt = jax.jit(st.opt)

    def step(state: EstimatorState, rig: CameraRig, img0, img1):
        times = {}
        t0 = time.perf_counter()
        pyrs = jax.block_until_ready(j_frames(img0, img1))
        t1 = time.perf_counter()
        times["frame_creation"] = (t1 - t0) * 1e3
        tr = jax.block_until_ready(j_track(state, rig, *pyrs))
        t2 = time.perf_counter()
        times["patch_tracking"] = (t2 - t1) * 1e3
        mo = jax.block_until_ready(j_motion(state, rig, tr[0], tr[2], tr[3]))
        t3 = time.perf_counter()
        times["motion_tracking"] = (t3 - t2) * 1e3
        new_state, out = jax.block_until_ready(
            j_opt(state, rig, *pyrs, *tr, mo))
        times["optimization"] = (time.perf_counter() - t3) * 1e3
        return new_state, out, times

    return step
