"""PnP motion tracking: device-resident Levenberg-Marquardt over one SE(3) pose.

Capability parity (SURVEY.md §2 #15 track_motion — ref
src/estimator/sliding_window.rs:490-587): optimize a single body-from-world
pose against the fixed map points observed in the current frame, Huber δ=2.0,
≤10 LM iterations, returning the optimized pose and a success flag (the caller
leaves the pose unchanged on failure, ref estimator.rs:228-234).

Design: the reference builds an apex-solver Problem with one factor
per observation and a sparse Cholesky; here the entire solve is one jitted
function — residuals/Jacobians for ALL (camera × landmark) observations are
one vmapped linearization, the 6x6 normal equations are formed with two small
matmuls, and the LM accept/reject loop is a lax.while_loop with branchless
state. No factor graph, no sparsity machinery — the problem IS dense-small.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie
from ..ops.projection import linearize_projection
from . import ba as ba_mod
from .ba import lm_status as ba_lm_status

# Convergence-status codes (parity with the reference's success statuses,
# ref sliding_window.rs:383-462: any of Converged/CostTol/ParamTol/
# TrustRegionTooSmall/MaxIterations counts as success).
STATUS_MAX_ITERATIONS = 0
STATUS_COST_TOL = 1
STATUS_PARAM_TOL = 2
STATUS_FAILED = 3
STATUS_TRUST_REGION = 5


class PnPConfig(NamedTuple):
    max_iterations: int = 10      # ref config optimization.pnp_max_iterations
    huber_delta: float = 2.0      # ref sliding_window.rs:540
    cost_tol: float = 1e-6        # ref LM cost tolerance (sliding_window.rs:132)
    param_tol: float = 1e-9       # ref LM param tolerance (sliding_window.rs:133)
    lambda_init: float = 1e-4
    lambda_max: float = 1e8
    min_observations: int = 6     # under-constrained refusal (ref :309-319)
    # Per-observation chi^2 gate (normalized residual NORM; 0 = off, the
    # reference-parity behavior): after `chi2_gate_iter` accepted iterations,
    # observations whose residual norm exceeds the gate are dropped from the
    # remaining iterations (see ba.BAConfig.chi2_gate).
    chi2_gate: float = 0.0
    chi2_gate_iter: int = 1
    # Motion-model prior: quadratic pull toward the INITIAL pose (the
    # caller's motion prediction — IMU or constant-velocity) with this
    # sqrt-weight per tangent dim (normalized-residual units; 0 = off).
    # Against a coherent secondary rigid motion (moving occluder) the
    # observations alone cannot identify the static world; the prior makes
    # the occluder group fight the prediction so the chi^2 gate can excise
    # it after the first iteration.
    motion_prior_weight: float = 0.0
    # RANSAC consensus pre-gate (0 = off, reference-parity: the reference's
    # only PnP defenses are Huber 2.0 + the bidirectional track gate,
    # ref sliding_window.rs:540, feature_tracker.rs:280). When > 0, this
    # many pose hypotheses are solved in parallel (vmap) from minimal
    # observation samples, every observation votes for every hypothesis,
    # and the LM solve runs on the best hypothesis's consensus set —
    # rejecting COHERENT outlier groups (moving rigid occluders) that
    # per-residual defenses (Huber, chi2) cannot separate from the static
    # world. See ransac_pnp_gate.
    ransac_hypotheses: int = 0
    ransac_sample: int = 4          # observations per minimal solve
    ransac_gn_iters: int = 4        # GN iterations per hypothesis
    ransac_threshold: float = 8e-3  # inlier residual norm (normalized units)
    ransac_min_inliers: int = 12    # consensus floor; below -> gate disengages
    # Age-weighted consensus: votes (and minimal-sample draws) are weighted
    # by clip(track_age / age_cap, age_floor, 1). A moving occluder's
    # tracks are perpetually YOUNG (born as it sweeps across the view), so
    # age weighting keeps the static world in control of the vote even in
    # frames where the occluder's tracks OUTNUMBER it — the failure mode of
    # plain counting (measured: full occluder transit flips the consensus
    # and plain RANSAC stops helping). 0 = unweighted voting.
    ransac_age_cap: int = 10
    ransac_age_floor: float = 0.1


class PnPResult(NamedTuple):
    T_W_B: jnp.ndarray   # (4,4) optimized world-from-body pose
    success: jnp.ndarray  # () bool
    status: jnp.ndarray   # () int32
    final_cost: jnp.ndarray  # ()
    iterations: jnp.ndarray  # () int32
    # Per-iteration [cost, gradient_norm, lambda, step_norm, step_quality,
    # accepted] rows (observer parity, ref src/optimization/observer.rs:
    # 40-68) — see utils.observer.format_metrics.
    metrics: jnp.ndarray = None  # (max_iterations, N_METRIC_COLS)


@partial(jax.jit, static_argnames=("cfg",))
def solve_pnp(T_W_B_init, T_C_B, landmarks, obs, mask,
              cfg: PnPConfig = PnPConfig(), T_W_B_prior=None,
              obs_weight=None, prior_scale=None):
    """Levenberg-Marquardt pose-only solve.

    Args:
      T_W_B_init: (4,4) initial world-from-body pose (last keyframe pose,
        ref sliding_window.rs:506-515; this build passes the motion-model /
        IMU prediction).
      T_C_B: (2,4,4) camera-from-body extrinsics [left, right].
      landmarks: (L,3) fixed world points (map points by slot).
      obs: (2,L,2) normalized observations per camera.
      mask: (2,L) bool observation validity (feature alive + landmark valid).
      T_W_B_prior: anchor pose of the motion prior when
        cfg.motion_prior_weight > 0 (defaults to the init). MUST derive from
        an EXTERNAL prediction (IMU) or a measured past pose — anchoring at
        a vision-extrapolated prediction closes a positive feedback loop
        (measured runaway on the VO matrix).
    Returns PnPResult; on failure T_W_B is returned unchanged.
    """
    dtype = T_W_B_init.dtype
    T_B_W0 = lie.se3_inverse(T_W_B_init)
    T_B_W_prior = (T_B_W0 if T_W_B_prior is None
                   else lie.se3_inverse(T_W_B_prior))
    n_obs = jnp.sum(mask)
    enough = n_obs >= cfg.min_observations

    def linearize(T_B_W, m):
        # vmap over cams (2) x landmarks (L); T_B_W closed over per call
        f = jax.vmap(jax.vmap(
            lambda Tcb, p, o, mm: linearize_projection(
                Tcb, T_B_W, p, o, mm, cfg.huber_delta),
            in_axes=(None, 0, 0, 0)), in_axes=(0, None, 0, 0))
        lin = f(T_C_B, landmarks, obs, m)
        if obs_weight is not None:
            # Per-slot sqrt-weights (L,) scale the whitened system (see
            # ba.apply_obs_weights; same semantics, pose-only problem).
            sw = obs_weight[None, :, None]
            lin = lin._replace(r=lin.r * sw,
                               J_pose=lin.J_pose * sw[..., None],
                               cost=lin.cost * (obs_weight[None, :] ** 2))
        J = lin.J_pose.reshape(-1, 6)          # (2L*2, 6)
        r = lin.r.reshape(-1)                  # (2L*2,)
        H = J.T @ J                            # (6,6)
        g = J.T @ r                            # (6,)
        cost = jnp.sum(lin.cost)
        if cfg.motion_prior_weight > 0.0:
            # Quadratic prior toward the anchor pose in the T_B_W
            # split-retraction tangent: r_p = w * (T boxminus T_prior).
            # prior_scale (traced, optional) modulates the weight at
            # runtime — the adaptive-prior path scales by (1 - health) so
            # clean frames pay no prior lag (EstimatorConfig.
            # pnp_prior_adaptive).
            w = cfg.motion_prior_weight
            if prior_scale is not None:
                w = w * prior_scale
            dt_p = T_B_W[:3, 3] - T_B_W_prior[:3, 3]
            dw_p = lie.so3_log(T_B_W_prior[:3, :3].T @ T_B_W[:3, :3])
            d = jnp.concatenate([dt_p, dw_p])
            H = H + (w * w) * jnp.eye(6, dtype=dtype)
            g = g + (w * w) * d
            cost = cost + 0.5 * (w * w) * jnp.dot(d, d)
        r_sq = jnp.sum(lin.r ** 2, axis=-1)    # (2, L)
        return H, g, cost, r_sq

    H0, g0, cost0, _ = linearize(T_B_W0, mask)

    def cond(state):
        return (~state[6]) & (state[5] < cfg.max_iterations)

    def body(state):
        T, H, g, cost, lam, it, done, status, metrics, m, n_acc = state
        D = jnp.diag(jnp.maximum(jnp.diag(H), 1e-8))
        delta = -jnp.linalg.solve(H + lam * D, g)
        # A non-finite step is treated as a rejected iteration (damping gets
        # boosted and we retry) rather than a hard failure — the same
        # recovery the BA solver uses in place of the reference's
        # Schur -> Cholesky fallback.
        ok_step = jnp.all(jnp.isfinite(delta))
        delta = jnp.where(ok_step, delta, 0.0)
        T_new = lie.se3_retract_split(T, delta)
        # ONE pass over observations per iteration: the linearization at the
        # candidate yields the acceptance cost AND (if accepted) the next
        # iteration's normal equations; a reject keeps the carried system.
        H_new, g_new, new_cost, r_sq_new = linearize(T_new, m)
        accept = ok_step & jnp.isfinite(new_cost) & (new_cost < cost)

        if cfg.chi2_gate > 0.0:
            # Outlier gate: drop observations whose residual norm still
            # exceeds the gate after chi2_gate_iter accepted iterations
            # (guarding min_observations so the solve stays constrained).
            def regate(_):
                m_g = m & (r_sq_new <= cfg.chi2_gate ** 2)
                keep_enough = jnp.sum(m_g) >= cfg.min_observations
                m_g = jnp.where(keep_enough, m_g, m)
                H_g, g_g, cost_g, _ = linearize(T_new, m_g)
                return m_g, H_g, g_g, cost_g

            do_gate = accept & (n_acc + 1 == max(1, cfg.chi2_gate_iter))
            m, H_new, g_new, new_cost = jax.lax.cond(
                do_gate, regate,
                lambda _: (m, H_new, g_new, new_cost), None)
        n_acc = n_acc + accept.astype(jnp.int32)

        # Convergence checks on the accepted step
        cost_conv = accept & (jnp.abs(cost - new_cost) <= cfg.cost_tol * jnp.maximum(cost, 1e-12))
        param_conv = accept & (jnp.linalg.norm(delta) <= cfg.param_tol)
        T = jnp.where(accept, T_new, T)
        # Observer columns (ref observer.rs:40-68).
        pred = 0.5 * (lam * jnp.sum(jnp.maximum(jnp.diag(H), 1e-8)
                                    * delta ** 2) - jnp.dot(g, delta))
        rho = ba_mod.step_quality(cost, new_cost, pred)
        metrics = metrics.at[it].set(ba_mod.metrics_row(
            new_cost, jnp.linalg.norm(g), lam, jnp.linalg.norm(delta), rho,
            accept))
        lam = jnp.where(accept, jnp.maximum(lam * 0.33, 1e-12), lam * 3.0)
        hard_fail = lam > cfg.lambda_max
        H = jnp.where(accept, H_new, H)
        g = jnp.where(accept, g_new, g)
        cost = jnp.where(accept, new_cost, cost)
        done = cost_conv | param_conv | hard_fail
        status = ba_lm_status(cost_conv, param_conv, hard_fail)
        return T, H, g, cost, lam, it + 1, done, status, metrics, m, n_acc

    init = (T_B_W0, H0, g0, cost0,
            jnp.asarray(cfg.lambda_init, dtype), jnp.asarray(0, jnp.int32),
            ~enough, jnp.asarray(STATUS_MAX_ITERATIONS, jnp.int32),
            jnp.zeros((cfg.max_iterations, ba_mod.N_METRIC_COLS), dtype),
            mask, jnp.asarray(0, jnp.int32))
    (T_B_W, _, _, cost, _, it, _, status, metrics, _m,
     _n) = jax.lax.while_loop(cond, body, init)

    # MaxIterations counts as success (ref sliding_window.rs:383-395);
    # only a hard numeric failure or an under-constrained problem fails.
    # Numerical-health gate (round-3 postmortem: a NaN init propagated to a
    # NaN "successful" result): a non-finite final pose is a failure and the
    # caller keeps its pose (which may itself be non-finite — the estimator
    # recovers that case to the last keyframe pose).
    success = enough & (status != STATUS_FAILED) & jnp.all(jnp.isfinite(T_B_W))
    T_W_B = jnp.where(success, lie.se3_inverse(T_B_W), T_W_B_init)
    return PnPResult(T_W_B=T_W_B, success=success, status=status,
                     final_cost=cost, iterations=it, metrics=metrics)


@partial(jax.jit, static_argnames=("cfg",))
def ransac_pnp_gate(T_W_B_init, T_C_B, landmarks, obs, mask, key,
                    cfg: PnPConfig, age=None):
    """Batched RANSAC consensus gate for pose-only tracking.

    Why: per-residual robustness (Huber δ=2.0, ref sliding_window.rs:540;
    the chi² gate) cannot reject a COHERENT outlier group — features born on
    a moving rigid occluder agree with each other, so an M-estimator settles
    on a compromise pose between the static world and the occluder. A
    consensus vote over pose hypotheses separates the groups: only one rigid
    motion can win, and with the static set in the majority it is the world.

    Design: the classic sequential hypothesize-and-verify loop
    becomes one batched computation — K minimal samples drawn in parallel
    (Gumbel-top-S over the valid-observation mask gives S distinct valid
    indices per hypothesis without host RNG), K damped-GN pose solves as one
    vmap (each is a 6x6 dense solve), and the K x (2L)
    verification residuals as one vmapped projection sweep. argmax picks the
    winner; the caller runs the full LM polish on its consensus set
    (LO-RANSAC structure). No dynamic shapes, no data-dependent trip counts.

    Args:
      T_W_B_init: (4,4) pose prediction seeding every hypothesis solve.
      T_C_B: (2,4,4) stereo extrinsics.
      landmarks: (L,3) map points by slot.
      obs: (2,L,2) normalized observations.
      mask: (2,L) observation validity (alive track with a valid landmark).
      key: jax PRNG key (callers fold in the frame id for determinism).
      cfg: PnPConfig with ransac_* fields (ransac_hypotheses must be > 0).
      age: optional (L,) int32 track ages for age-weighted voting (see
        PnPConfig.ransac_age_cap); None = unweighted.

    Returns (inlier_mask (2,L), ok (), best_count ()): when ok, inlier_mask
    is the winning consensus set (a subset of mask); when the consensus
    floor is not met the gate disengages and returns mask unchanged.
    """
    K = cfg.ransac_hypotheses
    S = cfg.ransac_sample
    L = landmarks.shape[0]
    dtype = T_W_B_init.dtype
    T_B_W0 = lie.se3_inverse(T_W_B_init)
    flat_mask = mask.reshape(-1)                     # (2L,)
    n_valid = jnp.sum(flat_mask)

    if age is not None and cfg.ransac_age_cap > 0:
        vote_w = jnp.clip(age.astype(dtype) / cfg.ransac_age_cap,
                          cfg.ransac_age_floor, 1.0)        # (L,)
    else:
        vote_w = jnp.ones((L,), dtype)
    flat_w = jnp.tile(vote_w, 2)                            # (2L,)

    # Gumbel-top-S: S distinct valid observation indices per hypothesis,
    # age-weighted over the valid set (Gumbel + log w samples index i with
    # probability proportional to w_i), fully vectorized.
    g = jax.random.gumbel(key, (K, 2 * L), dtype=dtype) + jnp.log(flat_w)
    scores = jnp.where(flat_mask[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(scores, S)                # (K,S)
    cam_i = idx // L
    lm_i = idx % L

    def solve_hypothesis(ci, li):
        Tcb = T_C_B[ci]                              # (S,4,4)
        p = landmarks[li]                            # (S,3)
        o = obs[ci, li]                              # (S,2)
        m = mask[ci, li]                             # (S,)

        def body(_, T):
            lin = jax.vmap(lambda a, b, c, d: linearize_projection(
                a, T, b, c, d, cfg.huber_delta))(Tcb, p, o, m)
            J = lin.J_pose.reshape(-1, 6)
            r = lin.r.reshape(-1)
            H = J.T @ J + 1e-4 * jnp.eye(6, dtype=dtype)
            delta = -jnp.linalg.solve(H, J.T @ r)
            ok_step = jnp.all(jnp.isfinite(delta))
            return lie.se3_retract_split(T, jnp.where(ok_step, delta, 0.0))

        return jax.lax.fori_loop(0, cfg.ransac_gn_iters, body, T_B_W0)

    T_hyp = jax.vmap(solve_hypothesis)(cam_i, lm_i)  # (K,4,4)

    def verify(T_B_W):
        def res_sq(Tcb, p, o):
            p_C = Tcb[:3, :3] @ (T_B_W[:3, :3] @ p + T_B_W[:3, 3]) + Tcb[:3, 3]
            in_front = p_C[2] > 1e-6
            proj = p_C[:2] / jnp.where(in_front, p_C[2], 1.0)
            e = jnp.sum((proj - o) ** 2)
            return jnp.where(in_front, e, jnp.inf)

        f = jax.vmap(jax.vmap(res_sq, in_axes=(None, 0, 0)),
                     in_axes=(0, None, 0))
        r2 = f(T_C_B, landmarks, obs)                # (2,L)
        finite = jnp.all(jnp.isfinite(T_B_W))
        return mask & (r2 < cfg.ransac_threshold ** 2) & finite

    inliers = jax.vmap(verify)(T_hyp)                # (K,2,L)
    # Winner by age-WEIGHTED vote (robust to a numerically-superior young
    # occluder group); the consensus floor stays an unweighted count.
    wcounts = jnp.sum(inliers * vote_w[None, None, :], axis=(1, 2))  # (K,)
    best = jnp.argmax(wcounts)
    best_count = jnp.sum(inliers[best])
    ok = (best_count >= cfg.ransac_min_inliers) & \
        (n_valid >= cfg.ransac_min_inliers)
    inlier_mask = jnp.where(ok, inliers[best], mask)
    return inlier_mask, ok, best_count
