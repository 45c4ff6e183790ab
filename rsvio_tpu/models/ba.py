"""Sliding-window bundle adjustment: device-resident Levenberg-Marquardt with
Schur-complement reduction over landmark blocks.

Capability parity (SURVEY.md §2 #15 optimize / §3.3 — ref
src/estimator/sliding_window.rs:137-486): optimize W keyframe poses (first
pose gauge-fixed) and L landmarks against stereo reprojection observations,
Huber δ=2.0, ≤20 LM iterations, stereo-observability gating (a landmark must
be seen at least once in BOTH cameras across the window), under-constrained
refusal, rollback-on-failure semantics, and a Schur → plain-solve fallback.

Design (a re-design, not a translation of apex-solver):
  * No factor graph. The observation set is a dense masked tensor
    obs[(W, 2, L, 2)] + mask[(W, 2, L)]; linearization of every observation is
    ONE vmapped call producing whitened residuals and Jacobians.
  * Normal-equation blocks are einsums:
      H_pp (W,6,6) block-diagonal, H_ll (L,3,3), H_pl (W,L,6,3), gradients.
  * Schur: 3x3 landmark blocks inverted in closed form (batched), reduced
    camera system S ((W·6) x (W·6)) assembled with one einsum and solved by
    Cholesky; landmark updates back-substituted. The whole reduction mirrors
    the reference's SparseSchurComplement + BlockDiagonal preconditioner
    configuration (ref sliding_window.rs:126-135) but as dense blocked ops
    — at W=10, L≤1024 the "sparse" problem is a small dense one.
  * LM accept/reject + rollback is branchless lax.while_loop state; the
    reference's Cholesky fallback on a singular Schur solve (ref :328-354)
    maps to detecting a non-finite step and retrying with boosted damping,
    which is what the fallback accomplishes numerically.
  * Gauge fixing: pose 0's rows/cols of S are replaced by the identity and its
    rhs zeroed, so δ_pose0 = 0 exactly (ref :281-292 excludes the first pose
    from the variable set).

Solver variables are body-from-world transforms T_B_W like the reference
(ref :217-226); the public API speaks world-from-body (T_W_B) like the
estimator state.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie
from ..ops.projection import linearize_projection

STATUS_MAX_ITERATIONS = 0
STATUS_COST_TOL = 1
STATUS_PARAM_TOL = 2
STATUS_FAILED = 3
STATUS_SKIPPED = 4  # under-constrained -> not attempted (ref :309-319)
# Damping grew past lambda_max with every step rejected: no improving step
# exists at this linearization — the current (best-found) state stands. The
# reference counts the analogous TrustRegionTooSmall as SUCCESS
# (ref sliding_window.rs:383-395), NOT a failure/rollback.
STATUS_TRUST_REGION = 5


class BAConfig(NamedTuple):
    max_iterations: int = 20     # ref config bundle_adjustment_max_iterations
    huber_delta: float = 2.0     # ref sliding_window.rs:295
    cost_tol: float = 1e-6       # ref :132
    param_tol: float = 1e-9      # ref :133
    lambda_init: float = 1e-4
    lambda_max: float = 1e8
    min_residual_blocks: int = 6  # ref :309-319
    # Freeze keyframe rotations and update translations only — the
    # development variant the reference ships as
    # BundleAdjustmentFactorTranslationOnly (ref factors.rs:147-271).
    translation_only: bool = False
    # Per-observation chi^2 gate (0 = off, the reference-parity behavior).
    # After `chi2_gate_iter` accepted LM iterations, observations whose
    # residual norm exceeds the gate are dropped from the remaining
    # iterations (branchless mask update inside the solve) and landmark
    # stereo-observability is re-derived from the surviving set. UNITS: the
    # gate compares against the sqrt-Huber-WHITENED residual norm (see
    # projection.linearize_projection) — below huber_delta that equals the
    # raw normalized-coordinate norm; past it the whitened norm grows like
    # sqrt(delta * r), so a gate g > huber_delta cuts raw residuals at
    # g^2 / huber_delta, not at g. Keep chi2_gate <= huber_delta for the
    # raw-units reading (all shipped configs do). Robustness upgrade over
    # the reference's Huber-only defense (ref sliding_window.rs:295): moving
    # occluders put gross outliers in the window that Huber down-weights but
    # never removes.
    chi2_gate: float = 0.0
    chi2_gate_iter: int = 1
    # Landmark maturity gate: a landmark enters BA only once its
    # observations span >= min_lm_span window rows (keyframes). Transient
    # tracks on MOVING objects die and re-triangulate at the object's new
    # position, so each window sees small residuals against a wrong,
    # moving anchor that neither Huber nor the chi^2 gate can flag;
    # requiring multi-keyframe persistence excludes them until they prove
    # stationary. 1 = off (reference-parity).
    min_lm_span: int = 1


class BAResult(NamedTuple):
    T_W_B: jnp.ndarray      # (W,4,4) optimized poses
    landmarks: jnp.ndarray  # (L,3) optimized landmarks
    success: jnp.ndarray    # () bool — on failure inputs are returned (rollback)
    status: jnp.ndarray     # () int32
    initial_cost: jnp.ndarray
    final_cost: jnp.ndarray
    iterations: jnp.ndarray
    # Per-iteration metrics [cost, gradient_norm, lambda, step_norm,
    # step_quality, accepted] — the device-side equivalent of the
    # reference's TerminalObserver rows (ref src/optimization/observer.rs:
    # 40-68). Rows beyond `iterations` are zero. Render with
    # utils.observer.format_metrics.
    metrics: jnp.ndarray = None  # (max_iterations, N_METRIC_COLS)


# Metrics columns recorded per LM iteration by every solver (local AND
# distributed): full TerminalObserver parity with the reference's
# IterationMetrics{cost, gradient_norm, damping, step_norm, step_quality}
# (ref src/optimization/observer.rs:40-68) plus the accept flag.
N_METRIC_COLS = 6
METRIC_NAMES = ("cost", "gradient_norm", "lambda", "step_norm",
                "step_quality", "accepted")


def metrics_row(new_cost, g_norm, lam, step_norm, rho, accept):
    dtype = new_cost.dtype
    return jnp.stack([new_cost, g_norm, lam, step_norm, rho,
                      accept.astype(dtype)])


def step_quality(cost, new_cost, pred_red):
    """Trust-region gain ratio rho = actual / predicted cost reduction.

    pred_red comes from the damped-normal-equation identity: with
    (H + lam*D) delta = -g the quadratic model predicts
    pred = 0.5 * (lam * delta^T D delta - g^T delta) >= 0."""
    return (cost - new_cost) / jnp.maximum(pred_red, 1e-20)


def lm_status(cost_conv, param_conv, lam_overflow):
    """Shared LM convergence-status selection (same status codes in every
    solver: PnP, BA, marginalized BA, VIO BA, distributed BA).

    lam_overflow (damping past lambda_max, all steps rejected) is a SUCCESS
    terminus: steps are only ever accepted on a cost decrease, so the carried
    state is the best found — matching the reference, which counts
    TrustRegionTooSmall among the convergence statuses
    (ref sliding_window.rs:383-395). STATUS_FAILED is reserved for genuinely
    corrupt outcomes (non-finite state), which the accept gates prevent."""
    return jnp.where(
        cost_conv, STATUS_COST_TOL,
        jnp.where(param_conv, STATUS_PARAM_TOL,
                  jnp.where(lam_overflow, STATUS_TRUST_REGION,
                            STATUS_MAX_ITERATIONS))).astype(jnp.int32)


def lm_span_gate(lm_active, obs_mask, min_lm_span: int):
    """Landmark maturity gate (BAConfig.min_lm_span): keep a landmark only
    once its observations span >= min_lm_span window rows (keyframes).
    Shard-safe (per-landmark columns only) — used by EVERY solver (local,
    marginalized, VIO, distributed) so the knob is never silently inert."""
    if min_lm_span > 1:
        span = jnp.sum(jnp.any(obs_mask, axis=1), axis=0)   # (L,)
        lm_active = lm_active & (span >= min_lm_span)
    return lm_active


def apply_obs_weights(lin, w):
    """Scale a (W,2,L) Linearization by per-slot sqrt-weights w (W,L).

    w multiplies the whitened residual/Jacobians (equivalent to scaling the
    measurement sigma by 1/w AFTER robustification — the Huber threshold
    still applies to the unweighted residual) and the robust cost by w^2.
    Used for birth-score observation weighting (FeatureTable.w): weak-
    texture starvation births carry less information than strict-floor
    corners and should not pull BA with equal force."""
    sw = w[:, None, :, None]                    # (W,1,L,1)
    return lin._replace(
        r=lin.r * sw,
        J_pose=lin.J_pose * sw[..., None],
        J_lm=lin.J_lm * sw[..., None],
        cost=lin.cost * (w[:, None, :] ** 2))


def stereo_observability_mask(obs_mask, lm_valid):
    """Landmark eligibility: valid slot AND observed >=1 time in BOTH cameras
    across the window (ref sliding_window.rs:243-246).

    obs_mask: (W, 2, L) bool; lm_valid: (L,) bool. Returns (L,) bool.
    """
    seen_left = jnp.any(obs_mask[:, 0, :], axis=0)
    seen_right = jnp.any(obs_mask[:, 1, :], axis=0)
    return lm_valid & seen_left & seen_right


def _linearize_all(T_B_W, T_C_B, landmarks, obs, mask, delta):
    """Batched linearization over (W, 2, L). Returns Linearization pytree with
    leading dims (W, 2, L)."""
    f = jax.vmap(  # over W
        jax.vmap(  # over cameras
            jax.vmap(  # over landmarks
                lambda T, Tcb, p, o, m: linearize_projection(Tcb, T, p, o, m, delta),
                in_axes=(None, None, 0, 0, 0)),
            in_axes=(None, 0, None, 0, 0)),
        in_axes=(0, None, None, 0, 0))
    return f(T_B_W, T_C_B, landmarks, obs, mask)


def build_normal_equations(lin):
    """Accumulate block normal equations from a (W,2,L) Linearization.

    Returns H_pp (W,6,6), H_ll (L,3,3), H_pl (W,L,6,3), g_p (W,6), g_l (L,3).
    """
    Jp = lin.J_pose  # (W,2,L,2,6)
    Jl = lin.J_lm    # (W,2,L,2,3)
    r = lin.r        # (W,2,L,2)
    H_pp = jnp.einsum("wclri,wclrj->wij", Jp, Jp)
    H_ll = jnp.einsum("wclri,wclrj->lij", Jl, Jl)
    H_pl = jnp.einsum("wclri,wclrj->wlij", Jp, Jl)
    g_p = jnp.einsum("wclri,wclr->wi", Jp, r)
    g_l = jnp.einsum("wclri,wclr->li", Jl, r)
    return H_pp, H_ll, H_pl, g_p, g_l


def _inv3x3(M):
    """Closed-form batched 3x3 inverse via adjugate (L,3,3) -> (L,3,3)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det_safe = jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
    adj = jnp.stack([
        jnp.stack([A, -(b * i - c * h), (b * f - c * e)], axis=-1),
        jnp.stack([B, (a * i - c * g), -(a * f - c * d)], axis=-1),
        jnp.stack([C, -(a * h - b * g), (a * e - b * d)], axis=-1),
    ], axis=-2)
    inv = adj / det_safe[..., None, None]
    ok = jnp.abs(det) > 1e-12
    return inv, ok


def schur_solve(H_pp, H_ll, H_pl, g_p, g_l, lam, lm_active, fix_first: bool = True):
    """Damped Schur-complement solve of the BA normal equations.

    Solves (H + lam*D) [dp; dl] = -[g_p; g_l] by eliminating landmark blocks.
    Inactive landmarks get identity blocks -> zero update. Returns
    (delta_pose (W,6), delta_lm (L,3), ok).
    """
    W = H_pp.shape[0]
    L = H_ll.shape[0]
    dtype = H_pp.dtype

    # Marquardt damping on block diagonals.
    dp = jnp.maximum(jax.vmap(jnp.diag)(H_pp), 1e-8)       # (W,6)
    H_pp_d = H_pp + lam * jax.vmap(jnp.diag)(dp)
    dl = jnp.maximum(jax.vmap(jnp.diag)(H_ll), 1e-8)       # (L,3)
    H_ll_d = H_ll + lam * jax.vmap(jnp.diag)(dl)
    # Inactive landmark -> identity block, zero gradient (no update).
    eye3 = jnp.eye(3, dtype=dtype)
    H_ll_d = jnp.where(lm_active[:, None, None], H_ll_d, eye3[None])
    g_l = jnp.where(lm_active[:, None], g_l, 0.0)
    H_pl = jnp.where(lm_active[None, :, None, None], H_pl, 0.0)

    H_ll_inv, inv_ok = _inv3x3(H_ll_d)

    # A[w,l] = H_pl[w,l] @ H_ll_inv[l]
    A = jnp.einsum("wlij,ljk->wlik", H_pl, H_ll_inv)
    # S[w,v] = delta_wv H_pp_d[w] - sum_l A[w,l] @ H_pl[v,l]^T
    S_blocks = -jnp.einsum("wlik,vljk->wvij", A, H_pl)
    S_blocks = S_blocks.at[jnp.arange(W), jnp.arange(W)].add(H_pp_d)
    b_red = -(g_p - jnp.einsum("wlik,lk->wi", A, g_l))      # (W,6)

    S = S_blocks.transpose(0, 2, 1, 3).reshape(W * 6, W * 6)
    b = b_red.reshape(W * 6)

    if fix_first:
        # Gauge fix: identity rows/cols for pose 0, zero rhs -> delta0 = 0.
        mask = jnp.concatenate([jnp.zeros(6, dtype=dtype),
                                jnp.ones((W - 1) * 6, dtype=dtype)])
        S = S * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
        b = b * mask

    # Cholesky solve of the reduced camera system.
    cho = jax.scipy.linalg.cho_factor(S, lower=True)
    delta_p = jax.scipy.linalg.cho_solve(cho, b).reshape(W, 6)
    # Back-substitute landmarks: dl = H_ll_inv (-g_l - H_lp dp)
    rhs_l = -g_l - jnp.einsum("wlij,wi->lj", H_pl, delta_p)
    delta_l = jnp.einsum("lij,lj->li", H_ll_inv, rhs_l)
    delta_l = jnp.where(lm_active[:, None], delta_l, 0.0)

    ok = jnp.all(jnp.isfinite(delta_p)) & jnp.all(jnp.isfinite(delta_l)) & jnp.all(
        inv_ok | (~lm_active))
    return delta_p, delta_l, ok


@partial(jax.jit, static_argnames=("cfg", "fix_first"))
def solve_ba(T_W_B, T_C_B, landmarks, obs, obs_mask, lm_valid,
             cfg: BAConfig = BAConfig(), fix_first: bool = True,
             obs_weight=None):
    """Sliding-window bundle adjustment.

    Args:
      T_W_B: (W,4,4) keyframe world-from-body poses.
      T_C_B: (2,4,4) stereo extrinsics (camera-from-body, left/right).
      landmarks: (L,3) world points (slot-aligned with the feature table).
      obs: (W,2,L,2) normalized observations.
      obs_mask: (W,2,L) bool validity.
      lm_valid: (L,) bool landmark slot validity.
    Returns BAResult. On failure the input poses/landmarks are returned
    unchanged (rollback semantics, ref sliding_window.rs:397-416).
    """
    dtype = T_W_B.dtype
    W = T_W_B.shape[0]

    lm_active0 = lm_span_gate(stereo_observability_mask(obs_mask, lm_valid),
                              obs_mask, cfg.min_lm_span)
    mask0 = obs_mask & lm_active0[None, None, :]
    n_blocks = jnp.sum(mask0)
    # Validation: enough residual blocks vs variables (ref :309-319).
    n_vars = (W - 1) * 6 + 3 * jnp.sum(lm_active0)
    attempt = (n_blocks >= cfg.min_residual_blocks) & (n_blocks * 2 >= n_vars)

    T_B_W0 = jax.vmap(lie.se3_inverse)(T_W_B)

    def lin_sys(T_B_W, lms, mask):
        """ONE pass over observations: normal-equation blocks AND the robust
        cost at the same point (the separate cost pass is fused away; the LM
        loop carries the blocks and relinearizes only at accepted points).
        Also returns the per-observation whitened squared residual norms
        (W,2,L) for the chi^2 gate."""
        lin = _linearize_all(T_B_W, T_C_B, lms, obs, mask, cfg.huber_delta)
        if obs_weight is not None:
            lin = apply_obs_weights(lin, obs_weight)
        # (chi^2 gate note: r is weight-scaled here, so low-weight
        # observations are gated proportionally LESS aggressively.)
        r_sq = jnp.sum(lin.r ** 2, axis=-1)
        return build_normal_equations(lin), jnp.sum(lin.cost), r_sq

    sys0, cost0, _ = lin_sys(T_B_W0, landmarks, mask0)

    def cond(state):
        return (~state[6]) & (state[5] < cfg.max_iterations)

    def body(state):
        (T_B_W, lms, sys, cost, lam, it, done, status, metrics, mask,
         lm_active, n_acc) = state
        H_pp, H_ll, H_pl, g_p, g_l = sys
        delta_p, delta_l, ok_step = schur_solve(
            H_pp, H_ll, H_pl, g_p, g_l, lam, lm_active, fix_first)
        if cfg.translation_only:
            delta_p = delta_p.at[:, 3:].set(0.0)
        delta_p = jnp.where(ok_step, delta_p, 0.0)
        delta_l = jnp.where(ok_step, delta_l, 0.0)
        T_new = jax.vmap(lie.se3_retract_split)(T_B_W, delta_p)
        lms_new = lms + delta_l
        sys_new, new_cost, r_sq_new = lin_sys(T_new, lms_new, mask)
        accept = ok_step & jnp.isfinite(new_cost) & (new_cost < cost)

        if cfg.chi2_gate > 0.0:
            # Outlier gate: after chi2_gate_iter ACCEPTED iterations, drop
            # observations whose whitened residual norm still exceeds the
            # gate, re-derive stereo observability, and rebuild the system
            # at the accepted point so later iterations never see them.
            # (chi2_gate_iter is clamped to >= 1 — n_acc+1 could otherwise
            # never match and the gate would silently disable.)
            do_gate = accept & (n_acc + 1 == max(1, cfg.chi2_gate_iter))

            def regate(_):
                m = mask & (r_sq_new <= cfg.chi2_gate ** 2)
                act = stereo_observability_mask(m, lm_valid)
                m = m & act[None, None, :]
                # Under-constraint guard (mirrors the pre-solve refusal): a
                # gate that guts the system must revert, or LM would keep
                # "succeeding" on an under-determined problem.
                n_b = jnp.sum(m)
                guard = ((n_b >= cfg.min_residual_blocks)
                         & (2 * n_b >= (W - 1) * 6 + 3 * jnp.sum(act)))
                m = jnp.where(guard, m, mask)
                act = jnp.where(guard, act, lm_active)
                sys_g, cost_g, _ = lin_sys(T_new, lms_new, m)
                return m, act, sys_g, cost_g

            def keep(_):
                return mask, lm_active, sys_new, new_cost

            mask, lm_active, sys_new, new_cost = jax.lax.cond(
                do_gate, regate, keep, None)
        n_acc = n_acc + accept.astype(jnp.int32)

        cost_conv = accept & (jnp.abs(cost - new_cost)
                              <= cfg.cost_tol * jnp.maximum(cost, 1e-12))
        step_norm = jnp.sqrt(jnp.sum(delta_p ** 2) + jnp.sum(delta_l ** 2))
        param_conv = accept & (step_norm <= cfg.param_tol)
        # Observer columns (ref observer.rs:40-68): gradient norm of the
        # current system and trust-region gain ratio rho from the damped
        # normal-equation prediction (see step_quality).
        g_l_m = jnp.where(lm_active[:, None], g_l, 0.0)
        g_norm = jnp.sqrt(jnp.sum(g_p ** 2) + jnp.sum(g_l_m ** 2))
        d_p = jnp.maximum(jax.vmap(jnp.diag)(H_pp), 1e-8)
        d_l = jnp.maximum(jax.vmap(jnp.diag)(H_ll), 1e-8)
        pred = 0.5 * (lam * (jnp.sum(d_p * delta_p ** 2)
                             + jnp.sum(d_l * delta_l ** 2))
                      - (jnp.sum(g_p * delta_p) + jnp.sum(g_l_m * delta_l)))
        rho = step_quality(cost, new_cost, pred)
        T_B_W = jnp.where(accept, T_new, T_B_W)
        lms = jnp.where(accept, lms_new, lms)
        sys = jax.tree.map(lambda new, old: jnp.where(accept, new, old),
                           sys_new, sys)
        metrics = metrics.at[it].set(metrics_row(
            new_cost, g_norm, lam, step_norm, rho, accept))
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.where(accept, jnp.maximum(lam * 0.33, 1e-12), lam * 4.0)
        hard_fail = lam > cfg.lambda_max
        done = cost_conv | param_conv | hard_fail
        status = lm_status(cost_conv, param_conv, hard_fail)
        return (T_B_W, lms, sys, cost, lam, it + 1, done, status, metrics,
                mask, lm_active, n_acc)

    init = (T_B_W0, landmarks, sys0, cost0,
            jnp.asarray(cfg.lambda_init, dtype),
            jnp.asarray(0, jnp.int32), ~attempt,
            jnp.asarray(STATUS_MAX_ITERATIONS, jnp.int32),
            jnp.zeros((cfg.max_iterations, N_METRIC_COLS), dtype),
            mask0, lm_active0, jnp.asarray(0, jnp.int32))
    (T_B_W, lms, _, cost, lam, it, _, status, metrics,
     _mask, _act, _n) = jax.lax.while_loop(cond, body, init)

    status = jnp.where(attempt, status, STATUS_SKIPPED)
    # Every LM terminus (MaxIterations, CostTol, ParamTol, TrustRegion)
    # counts as success (ref :383-395); rollback only on refusal — plus the
    # numerical-health gate (round-3 postmortem): non-finite poses or active
    # landmarks roll the inputs back instead of shipping NaNs as "success".
    finite = (jnp.all(jnp.isfinite(T_B_W))
              & jnp.all(jnp.isfinite(jnp.where(_act[:, None], lms, 0.0))))
    success = attempt & (status != STATUS_FAILED) & finite
    T_W_B_out = jnp.where(success, jax.vmap(lie.se3_inverse)(T_B_W), T_W_B)
    lms_out = jnp.where(success, lms, landmarks)
    return BAResult(T_W_B=T_W_B_out, landmarks=lms_out, success=success,
                    status=status, initial_cost=cost0, final_cost=cost,
                    iterations=it, metrics=metrics)


# ---------------------------------------------------------------------------
# Marginalization-aware BA: the window solve with a Gaussian prior over poses
# (produced by Schur-marginalizing evicted keyframes) and production of the
# next prior. Greenfield capability (BASELINE.json config 4): the reference
# evicts FIFO with no marginalization (ref README.md:79 caveat).
# ---------------------------------------------------------------------------

from .marginalization import MargPrior, marginalize_oldest, prior_terms  # noqa: E402


@partial(jax.jit, static_argnames=("cfg",))
def solve_ba_marginalized(T_W_B, T_C_B, landmarks, obs, obs_mask, lm_valid,
                          prior: MargPrior, will_evict,
                          cfg: BAConfig = BAConfig(), obs_weight=None):
    """solve_ba with a pose prior + production of the rolled next prior.

    Args (beyond solve_ba):
      prior: MargPrior over the W poses (6-dim blocks, T_B_W split-retraction
        tangent convention). When prior.valid is False the first pose is
        gauge-fixed instead.
      will_evict: () bool — when True the returned new_prior marginalizes
        pose 0 of the final linearized (landmark-eliminated) system and is
        rolled one slot (matching the caller's upcoming window roll);
        otherwise the input prior is passed through unchanged.

    Returns (BAResult, new_prior).
    """
    dtype = T_W_B.dtype
    W = T_W_B.shape[0]

    lm_active0 = lm_span_gate(stereo_observability_mask(obs_mask, lm_valid),
                              obs_mask, cfg.min_lm_span)
    mask0 = obs_mask & lm_active0[None, None, :]
    n_blocks = jnp.sum(mask0)
    n_vars = (W - 1) * 6 + 3 * jnp.sum(lm_active0)
    attempt = (n_blocks >= cfg.min_residual_blocks) & (n_blocks * 2 >= n_vars)
    # With a valid prior the gauge is anchored by it; otherwise fix pose 0.
    fix_first = ~prior.valid

    no_extra = jnp.zeros((W, 0), dtype=dtype)

    def lin_sys(T_B_W, lms, mask, lm_active):
        """ONE pass over observations per point: masked normal-equation
        blocks + prior terms AND the total (visual + prior) cost. The LM loop
        carries this system and re-damps it on rejected steps instead of
        relinearizing. Also returns per-observation whitened squared
        residual norms for the chi^2 gate."""
        lin = _linearize_all(T_B_W, T_C_B, lms, obs, mask, cfg.huber_delta)
        if obs_weight is not None:
            lin = apply_obs_weights(lin, obs_weight)
        H_pp, H_ll, H_pl, g_p, g_l = build_normal_equations(lin)
        T_W_B_cur = jax.vmap(lie.se3_inverse)(T_B_W)
        H_add, g_add, pcost = prior_terms(prior, T_W_B_cur, no_extra)
        g_l_m = jnp.where(lm_active[:, None], g_l, 0.0)
        H_pl_m = jnp.where(lm_active[None, :, None, None], H_pl, 0.0)
        sys = (H_pp, H_ll, H_pl_m, g_p, g_l_m, H_add, g_add)
        r_sq = jnp.sum(lin.r ** 2, axis=-1)
        return sys, jnp.sum(lin.cost) + pcost, r_sq

    def damp_reduce(sys, lam, lm_active):
        """Damped, prior-augmented reduced camera system + landmark pieces
        (cheap relative to lin_sys — safe to redo per lambda retry)."""
        H_pp, H_ll, H_pl_m, g_p, g_l_m, H_add, g_add = sys
        dp = jnp.maximum(jax.vmap(jnp.diag)(H_pp), 1e-8)
        H_pp_d = H_pp + lam * jax.vmap(jnp.diag)(dp)
        dl = jnp.maximum(jax.vmap(jnp.diag)(H_ll), 1e-8)
        H_ll_d = H_ll + lam * jax.vmap(jnp.diag)(dl)
        eye3 = jnp.eye(3, dtype=dtype)
        H_ll_d = jnp.where(lm_active[:, None, None], H_ll_d, eye3[None])

        H_ll_inv, inv_ok = _inv3x3(H_ll_d)
        A = jnp.einsum("wlij,ljk->wlik", H_pl_m, H_ll_inv)
        S_blocks = -jnp.einsum("wlik,vljk->wvij", A, H_pl_m)
        S_blocks = S_blocks.at[jnp.arange(W), jnp.arange(W)].add(H_pp_d)
        S = S_blocks.transpose(0, 2, 1, 3).reshape(W * 6, W * 6) + H_add
        b = (-(g_p - jnp.einsum("wlik,lk->wi", A, g_l_m))).reshape(W * 6) \
            - g_add
        return S, b, H_ll_inv, H_pl_m, g_l_m, A, inv_ok

    def solve_from_system(S, b):
        Sg = S
        bg = b

        def fixed(args):
            S_, b_ = args
            m = jnp.concatenate([jnp.zeros(6, dtype=dtype),
                                 jnp.ones((W - 1) * 6, dtype=dtype)])
            S2 = S_ * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
            return S2, b_ * m

        S2, b2 = jax.lax.cond(fix_first, fixed, lambda a: a, (Sg, bg))
        cho = jax.scipy.linalg.cho_factor(S2, lower=True)
        return jax.scipy.linalg.cho_solve(cho, b2).reshape(W, 6)

    T_B_W0 = jax.vmap(lie.se3_inverse)(T_W_B)
    sys0, cost0, _ = lin_sys(T_B_W0, landmarks, mask0, lm_active0)

    def cond(state):
        return (~state[6]) & (state[5] < cfg.max_iterations)

    def body(state):
        (T_B_W, lms, sys, cost, lam, it, done, status, metrics, mask,
         lm_active, n_acc) = state
        S, b, H_ll_inv, H_pl_m, g_l_m, A, inv_ok = damp_reduce(
            sys, lam, lm_active)
        delta_p = solve_from_system(S, b)
        rhs_l = -g_l_m - jnp.einsum("wlij,wi->lj", H_pl_m, delta_p)
        delta_l = jnp.einsum("lij,lj->li", H_ll_inv, rhs_l)
        delta_l = jnp.where(lm_active[:, None], delta_l, 0.0)
        ok_step = (jnp.all(jnp.isfinite(delta_p))
                   & jnp.all(jnp.isfinite(delta_l))
                   & jnp.all(inv_ok | (~lm_active)))
        delta_p = jnp.where(ok_step, delta_p, 0.0)
        delta_l = jnp.where(ok_step, delta_l, 0.0)
        T_new = jax.vmap(lie.se3_retract_split)(T_B_W, delta_p)
        lms_new = lms + delta_l
        sys_new, new_cost, r_sq_new = lin_sys(T_new, lms_new, mask, lm_active)
        accept = ok_step & jnp.isfinite(new_cost) & (new_cost < cost)

        if cfg.chi2_gate > 0.0:
            # Outlier gate (see solve_ba): excise gross outliers after the
            # first accepted iterations; the final prior is then built from
            # the gated system, so outliers never enter the marginal.
            do_gate = accept & (n_acc + 1 == max(1, cfg.chi2_gate_iter))

            def regate(_):
                m = mask & (r_sq_new <= cfg.chi2_gate ** 2)
                act = stereo_observability_mask(m, lm_valid)
                m = m & act[None, None, :]
                n_b = jnp.sum(m)
                guard = ((n_b >= cfg.min_residual_blocks)
                         & (2 * n_b >= (W - 1) * 6 + 3 * jnp.sum(act)))
                m = jnp.where(guard, m, mask)
                act = jnp.where(guard, act, lm_active)
                sys_g, cost_g, _ = lin_sys(T_new, lms_new, m, act)
                return m, act, sys_g, cost_g

            mask, lm_active, sys_new, new_cost = jax.lax.cond(
                do_gate, regate,
                lambda _: (mask, lm_active, sys_new, new_cost), None)
        n_acc = n_acc + accept.astype(jnp.int32)

        cost_conv = accept & (jnp.abs(cost - new_cost)
                              <= cfg.cost_tol * jnp.maximum(cost, 1e-12))
        step_norm = jnp.sqrt(jnp.sum(delta_p ** 2) + jnp.sum(delta_l ** 2))
        param_conv = accept & (step_norm <= cfg.param_tol)
        # Observer columns: the prior-augmented gradient and gain ratio.
        H_pp, _H_ll, _H_pl, g_p, g_l_m, _H_add, g_add = sys
        g_full = g_p.reshape(-1) + g_add
        g_norm = jnp.sqrt(jnp.sum(g_full ** 2) + jnp.sum(g_l_m ** 2))
        d_p = jnp.maximum(jax.vmap(jnp.diag)(H_pp), 1e-8)
        d_l = jnp.maximum(jax.vmap(jnp.diag)(sys[1]), 1e-8)
        pred = 0.5 * (lam * (jnp.sum(d_p * delta_p ** 2)
                             + jnp.sum(d_l * delta_l ** 2))
                      - (jnp.sum(g_full * delta_p.reshape(-1))
                         + jnp.sum(g_l_m * delta_l)))
        rho = step_quality(cost, new_cost, pred)
        metrics = metrics.at[it].set(metrics_row(
            new_cost, g_norm, lam, step_norm, rho, accept))
        T_B_W = jnp.where(accept, T_new, T_B_W)
        lms = jnp.where(accept, lms_new, lms)
        sys = jax.tree.map(lambda new, old: jnp.where(accept, new, old),
                           sys_new, sys)
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.where(accept, jnp.maximum(lam * 0.33, 1e-12), lam * 4.0)
        hard_fail = lam > cfg.lambda_max
        done = cost_conv | param_conv | hard_fail
        status = lm_status(cost_conv, param_conv, hard_fail)
        return (T_B_W, lms, sys, cost, lam, it + 1, done, status, metrics,
                mask, lm_active, n_acc)

    init = (T_B_W0, landmarks, sys0, cost0,
            jnp.asarray(cfg.lambda_init, dtype),
            jnp.asarray(0, jnp.int32), ~attempt,
            jnp.asarray(STATUS_MAX_ITERATIONS, jnp.int32),
            jnp.zeros((cfg.max_iterations, N_METRIC_COLS), dtype),
            mask0, lm_active0, jnp.asarray(0, jnp.int32))
    (T_B_W, lms, _, cost, lam, it, _, status, metrics, mask_f, lm_active_f,
     _n) = jax.lax.while_loop(cond, body, init)

    status = jnp.where(attempt, status, STATUS_SKIPPED)
    # Success statuses as solve_ba, incl. the numerical-health gate.
    finite = (jnp.all(jnp.isfinite(T_B_W))
              & jnp.all(jnp.isfinite(jnp.where(lm_active_f[:, None], lms,
                                               0.0))))
    success = attempt & (status != STATUS_FAILED) & finite
    T_W_B_out = jnp.where(success, jax.vmap(lie.se3_inverse)(T_B_W), T_W_B)
    lms_out = jnp.where(success, lms, landmarks)

    # ---- next prior: marginalize pose 0 of the final linearized system ----
    # (small damping keeps weakly-observed landmark blocks invertible; built
    # from the chi^2-gated observation set when the gate is on)
    sys_f, _, _ = lin_sys(jax.vmap(lie.se3_inverse)(T_W_B_out), lms_out,
                          mask_f, lm_active_f)
    S_f, b_f, *_ = damp_reduce(sys_f, jnp.asarray(1e-5, dtype), lm_active_f)
    # reduced_system returns b = -(gradient); marginalize expects +gradient.
    new_prior = marginalize_oldest(S_f, -b_f, T_W_B_out, no_extra, prior, 6)
    do_new = will_evict & success
    out_prior = jax.tree.map(
        lambda new, old: jnp.where(do_new, new, old), new_prior, prior)
    out_prior = out_prior._replace(
        valid=jnp.where(do_new, True, prior.valid))

    result = BAResult(T_W_B=T_W_B_out, landmarks=lms_out, success=success,
                      status=status, initial_cost=cost0, final_cost=cost,
                      iterations=it, metrics=metrics)
    return result, out_prior
