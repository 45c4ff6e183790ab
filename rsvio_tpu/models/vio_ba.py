"""Visual-inertial sliding-window BA: 15-dim keyframe states
[pose(6) | velocity(3) | gyro bias(3) | accel bias(3)] with IMU
preintegration factors chaining consecutive keyframes, joined to the stereo
reprojection system, solved by the same damped Schur-complement LM.

Greenfield capability (SURVEY.md §7 step 8, BASELINE.json config 4): the
reference only carries IMU placeholders (ref src/estimator/state.rs:12-19,
src/datasets/mod.rs:21-26) and lists preintegration as future work
(ref README.md:70).

Design:
  * Reprojection factors touch only the pose sub-block (first 6 dims) of one
    state; their Jacobians are the analytic ones from ops.projection.
  * IMU factors touch two consecutive 15-dim states; their Jacobians come
    from jax.jacfwd of the preintegration residual — exact, batched, and
    immune to hand-derivation bugs (15x30 per interval, negligible cost).
  * Landmarks are Schur-eliminated exactly as in models.ba; the reduced state
    system is (W·15)^2 (W=10 -> 150x150 Cholesky).
  * Gauge: first pose (6 dims) fixed; its velocity/biases stay free.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie
from ..ops.projection import linearize_projection
from . import ba as ba_mod
from .imu import Preintegrated, imu_residual

D = 15  # state dim per keyframe


class VIOBAConfig(NamedTuple):
    max_iterations: int = 20
    huber_delta: float = 2.0
    cost_tol: float = 1e-6
    param_tol: float = 1e-9
    lambda_init: float = 1e-4
    lambda_max: float = 1e8
    min_residual_blocks: int = 6
    # Per-observation chi^2 gate on the VISUAL blocks (normalized residual
    # norm; 0 = off — see ba.BAConfig.chi2_gate). IMU factors are never
    # gated.
    chi2_gate: float = 0.0
    chi2_gate_iter: int = 1
    # Landmark maturity gate (see ba.BAConfig.min_lm_span): landmarks enter
    # the solve only once their observations span >= this many keyframes.
    # 1 = off. Applied identically in local and distributed VIO solvers so
    # the YAML knob is never silently inert.
    min_lm_span: int = 1
    # Exponential information decay applied to the marginalization prior at
    # each eviction (marginalized solvers only). Without it the prior's
    # information grows WITHOUT BOUND (measured: |H|max 12 -> 3760 over 90
    # evictions) while its first-order (FEJ) linearization points go stale —
    # an early wrong bias estimate gets pinned with ever-growing weight and
    # the trajectory collapses (the round-2 vio_marg accuracy bug). Decay
    # bounds the steady-state prior at ~1/(1-decay) eviction-steps of
    # information: recent inertial continuity is kept, stale certainty
    # fades. 1.0 = no forgetting (the broken round-2 behavior).
    prior_decay: float = 0.7
    # Drop the BIAS rows/cols (dims 9:15 of every block) from the
    # marginalization prior. Solver-only sliding-window bisection (24 KFs,
    # per-block ablation at identical noise): the bias block alone degrades
    # position 8x (it accretes an absolute bias anchor pinned at stale FEJ
    # estimates; slightly-wrong-but-locked biases poison every IMU factor),
    # while the pose+velocity blocks HELP (pos_end 0.017-0.020 vs fifo
    # 0.019-0.081 across seeds; velocity error 4x better). Biases remain
    # estimated per-window, tied across it by the in-window random-walk
    # factors — exactly the fifo behavior that measures well.
    prior_drop_bias: bool = True
    # Ablation knob (measured HARMFUL — pose cross-correlations are what
    # make the velocity info meaningful): keep ONLY velocity/bias blocks.
    prior_velocity_bias_only: bool = False
    # Include the evicted frame's VISUAL factors (observations of window
    # landmarks from state 0, landmarks held fixed) in the eviction system.
    # This is what anchors the marginal in absolute pose — the standard
    # marginalization recipe (cf. VINS/OKVIS) folds the evicted frame's
    # visual information; without it the prior is a pure relative-inertial
    # chain whose pose block is spurious re-linearization certainty and
    # whose velocity block lacks the cross-correlations that make it
    # meaningful (both variants measured to collapse the trajectory).
    # Holding the landmarks fixed (instead of co-marginalizing them) keeps
    # actively-tracked landmarks out of the prior; the mild overconfidence
    # is bounded by prior_decay.
    prior_visual_anchor: bool = True
    bias_gyro_weight: float = 1e3    # sqrt-info for bias random-walk residuals
    bias_accel_weight: float = 1e2
    # Health-gated DESERT stiffness for the bias random-walk links (0 = off).
    # During a visual information desert (full occlusion) the window drag
    # leaks into the IMU chain through BOTH bias states: the solver absorbs
    # dragged-pose inconsistency by walking the biases. Per-interval desert
    # factor alpha in [0,1] (1 - track health at the closing keyframe, see
    # estimator_vio.stage_kf_pre) interpolates each link's stiffness in LOG
    # space between the base weight (alpha=0: clean scene, biases free to
    # refine) and this desert weight (alpha=1: biases pinned over the window
    # horizon — physically sound for consumer IMUs over a few seconds).
    # Round-5 320px occlusion sweep (static equivalents): drift 47.9%
    # (1e3/1e2) -> 17.9% (accel 1e6 only) -> 8.0% (gyro 1e5 + accel 1e6),
    # while clean scenes saw a 1.7-1.8x ATE cost from the STATIC boost that
    # this health gating avoids (alpha ~= 0 when consensus is healthy).
    bias_gyro_weight_desert: float = 0.0
    bias_accel_weight_desert: float = 0.0
    # Cap on the preintegration sqrt-information scale. Mixing 1e4-weighted
    # IMU blocks (squared -> 1e8) with O(1e2) visual blocks in an f32 Hessian
    # drowns the visual information (7 significant digits); ~3e2 keeps a
    # strong inertial prior while preserving visual conditioning.
    imu_weight_cap: float = 3e2


class VIOState(NamedTuple):
    """Per-window VIO variables (W leading dim)."""
    T_W_B: jnp.ndarray   # (W,4,4)
    vel: jnp.ndarray     # (W,3)
    bg: jnp.ndarray      # (W,3)
    ba: jnp.ndarray      # (W,3)


class VIOBAResult(NamedTuple):
    state: VIOState
    landmarks: jnp.ndarray
    success: jnp.ndarray
    status: jnp.ndarray
    initial_cost: jnp.ndarray
    final_cost: jnp.ndarray
    iterations: jnp.ndarray
    # Per-iteration [cost, lambda, step_norm, accepted] (TerminalObserver
    # parity, ref src/optimization/observer.rs; utils.observer renders it).
    # [cost, gradient_norm, lambda, step_norm, step_quality, accepted] rows
    # (observer parity, ref src/optimization/observer.rs:40-68).
    metrics: jnp.ndarray = None  # (max_iterations, ba.N_METRIC_COLS)


def _retract_state(st: VIOState, delta):
    """delta: (W, 15) -> retracted VIOState. Pose uses the split retraction on
    T_B_W to stay consistent with the reprojection Jacobians."""
    T_B_W = jax.vmap(lie.se3_inverse)(st.T_W_B)
    T_B_W = jax.vmap(lie.se3_retract_split)(T_B_W, delta[:, :6])
    return VIOState(
        T_W_B=jax.vmap(lie.se3_inverse)(T_B_W),
        vel=st.vel + delta[:, 6:9],
        bg=st.bg + delta[:, 9:12],
        ba=st.ba + delta[:, 12:15],
    )


def _imu_sqrt_info(pre: Preintegrated, cfg: VIOBAConfig):
    """Scaled sqrt-information (9,9) of the [dR, dv, dp] residual block.

    Computed once per interval OUTSIDE the autodiff'd residual (a Cholesky +
    inverse inside jacfwd would be differentiated 30 times for nothing).
    """
    dtype = pre.cov.dtype
    cov = pre.cov + jnp.eye(9, dtype=dtype) * 1e-10
    Linfo = jnp.linalg.cholesky(jnp.linalg.inv(cov))
    # Uniform rescale (NOT elementwise clip — that would distort the
    # whitening direction) so the largest sqrt-info entry is <= the cap.
    scale = jnp.minimum(1.0, cfg.imu_weight_cap / jnp.maximum(
        jnp.max(jnp.abs(Linfo)), 1e-12))
    return jax.lax.stop_gradient(Linfo.T * scale)


def _imu_whitened_residual(pre: Preintegrated, st_i, st_j, cfg: VIOBAConfig,
                           sqrt_info=None, bias_scale=None):
    """Whitened 15-dim IMU residual between state tuples (T_W_B, v, bg, ba).

    bias_scale: optional (gyro_scale, accel_scale) multipliers on the bias
    random-walk rows — the health-gated desert stiffness (see
    VIOBAConfig.bias_gyro_weight_desert / bias_desert_scales)."""
    r = imu_residual(pre, st_i[0], st_i[1], st_i[2], st_i[3],
                     st_j[0], st_j[1], st_j[2], st_j[3])
    if sqrt_info is None:
        sqrt_info = _imu_sqrt_info(pre, cfg)
    r9 = sqrt_info @ r[:9]
    r_bg = r[9:12] * cfg.bias_gyro_weight
    r_ba = r[12:15] * cfg.bias_accel_weight
    if bias_scale is not None:
        r_bg = r_bg * bias_scale[0]
        r_ba = r_ba * bias_scale[1]
    return jnp.concatenate([r9, r_bg, r_ba])


def bias_desert_scales(cfg: VIOBAConfig, bias_alpha, dtype):
    """Per-interval (gyro, accel) bias-link multipliers from desert factors.

    bias_alpha: (W-1,) in [0,1] — 0 = healthy interval (base stiffness),
    1 = full information desert (desert stiffness). Interpolation is in LOG
    space (stiffness ratios span 2-4 decades). Returns (W-1, 2) scales or
    None when the feature is off."""
    if bias_alpha is None or cfg.bias_gyro_weight_desert <= 0.0 \
            or cfg.bias_accel_weight_desert <= 0.0:
        return None
    a = jnp.clip(bias_alpha.astype(dtype), 0.0, 1.0)
    gs = (cfg.bias_gyro_weight_desert / cfg.bias_gyro_weight) ** a
    as_ = (cfg.bias_accel_weight_desert / cfg.bias_accel_weight) ** a
    return jnp.stack([gs, as_], axis=1)


def _imu_linearize_one(pre: Preintegrated, st: VIOState, i, cfg: VIOBAConfig,
                       sqrt_info=None, bias_scale=None):
    """Residual + Jacobians of the IMU factor between KF i and i+1.

    Returns (r (15,), J_i (15,15), J_j (15,15)) where the Jacobians are taken
    w.r.t. the same [pose(6 on T_B_W), v, bg, ba] increments used by
    _retract_state. sqrt_info: optional precomputed (9,9) whitening (it only
    depends on the fixed preintegration, so callers hoist it per solve).
    """
    Ti = st.T_W_B[i]
    Tj = st.T_W_B[i + 1]
    vi, vj = st.vel[i], st.vel[i + 1]
    bgi, bgj = st.bg[i], st.bg[i + 1]
    bai, baj = st.ba[i], st.ba[i + 1]

    if sqrt_info is None:
        sqrt_info = _imu_sqrt_info(pre, cfg)

    def res(di, dj):
        T_B_Wi = lie.se3_retract_split(lie.se3_inverse(Ti), di[:6])
        T_B_Wj = lie.se3_retract_split(lie.se3_inverse(Tj), dj[:6])
        si = (lie.se3_inverse(T_B_Wi), vi + di[6:9], bgi + di[9:12], bai + di[12:15])
        sj = (lie.se3_inverse(T_B_Wj), vj + dj[6:9], bgj + dj[9:12], baj + dj[12:15])
        return _imu_whitened_residual(pre, si, sj, cfg, sqrt_info, bias_scale)

    z = jnp.zeros(D, dtype=Ti.dtype)
    r = res(z, z)
    J_i = jax.jacfwd(res, argnums=0)(z, z)
    J_j = jax.jacfwd(res, argnums=1)(z, z)
    return r, J_i, J_j


def _visual_linearize(T_B_W, T_C_B, landmarks, obs, mask, delta):
    lin = ba_mod._linearize_all(T_B_W, T_C_B, landmarks, obs, mask, delta)
    return lin


@partial(jax.jit, static_argnames=("cfg", "fix_first"))
def solve_vio_ba(state: VIOState, T_C_B, landmarks, obs, obs_mask, lm_valid,
                 preint: Preintegrated, preint_valid,
                 cfg: VIOBAConfig = VIOBAConfig(), fix_first: bool = True,
                 obs_weight=None, bias_alpha=None):
    """Joint visual-inertial window optimization.

    Args:
      state: VIOState over W keyframes.
      T_C_B, landmarks, obs, obs_mask, lm_valid: as in models.ba.solve_ba.
      preint: Preintegrated pytree with leading dim (W-1) — interval i joins
        KF i and i+1.
      preint_valid: (W-1,) bool — missing IMU intervals contribute nothing.
      bias_alpha: optional (W-1,) desert factors for the health-gated bias
        random-walk stiffness (see bias_desert_scales).
    """
    W = state.T_W_B.shape[0]
    dtype = state.T_W_B.dtype
    b_scales = bias_desert_scales(cfg, bias_alpha, dtype)

    lm_active0 = ba_mod.lm_span_gate(
        ba_mod.stereo_observability_mask(obs_mask, lm_valid),
        obs_mask, cfg.min_lm_span)
    mask0 = obs_mask & lm_active0[None, None, :]
    n_blocks = jnp.sum(mask0) + jnp.sum(preint_valid)
    # Under-constrained refusal (ref sliding_window.rs:309-319): residual
    # rows (2 per visual block, 15 per IMU interval) must cover the free
    # variables (15 per state minus the fixed first pose, 3 per landmark).
    n_rows = 2 * jnp.sum(mask0) + 15 * jnp.sum(preint_valid)
    n_vars = W * D - 6 + 3 * jnp.sum(lm_active0)
    attempt = (n_blocks >= cfg.min_residual_blocks) & (n_rows >= n_vars)

    # Whitening of each IMU interval depends only on the (fixed)
    # preintegration — compute once per solve, not per LM iteration.
    sqrt_infos = jax.vmap(
        lambda i: _imu_sqrt_info(jax.tree.map(lambda x: x[i], preint), cfg))(
        jnp.arange(W - 1))

    def lin_sys(st: VIOState, lms, mask, lm_active):
        """ONE pass over observations + IMU intervals per point: undamped
        normal-equation blocks AND the total robust cost. The LM loop carries
        this system and re-damps it on rejected steps. Also returns the
        per-observation whitened squared residual norms for the chi^2 gate.

        Visual factors never touch velocity/bias, so the state-landmark
        coupling H_pl6 stays in 6-dim pose space: rows 6:15 of the (D,3)
        coupling blocks are structurally zero and the whole landmark
        elimination runs in the pose subspace (6.25x fewer FLOPs than
        materializing (W,L,15,3) blocks)."""
        T_B_W = jax.vmap(lie.se3_inverse)(st.T_W_B)
        lin = _visual_linearize(T_B_W, T_C_B, lms, obs, mask, cfg.huber_delta)
        if obs_weight is not None:
            # Birth-score observation weighting (see ba.apply_obs_weights);
            # IMU factors are never weighted.
            lin = ba_mod.apply_obs_weights(lin, obs_weight)
        H_pp6, H_ll, H_pl6, g_p6, g_l = ba_mod.build_normal_equations(lin)

        H_ss = jnp.zeros((W, W, D, D), dtype=dtype)
        H_ss = H_ss.at[jnp.arange(W), jnp.arange(W), :6, :6].add(H_pp6)
        g_s = jnp.zeros((W, D), dtype=dtype)
        g_s = g_s.at[:, :6].add(g_p6)

        # IMU factors (residual also yields the IMU cost contribution).
        def imu_blocks(i):
            r, J_i, J_j = _imu_linearize_one(
                jax.tree.map(lambda x: x[i], preint), st, i, cfg,
                sqrt_infos[i],
                None if b_scales is None else b_scales[i])
            w = preint_valid[i].astype(dtype)
            return (w * (J_i.T @ J_i), w * (J_j.T @ J_j), w * (J_i.T @ J_j),
                    w * (J_i.T @ r), w * (J_j.T @ r),
                    0.5 * w * jnp.dot(r, r))

        Hii, Hjj, Hij, gi, gj, imu_costs = jax.vmap(imu_blocks)(
            jnp.arange(W - 1))
        idx = jnp.arange(W - 1)
        H_ss = H_ss.at[idx, idx].add(Hii)
        H_ss = H_ss.at[idx + 1, idx + 1].add(Hjj)
        H_ss = H_ss.at[idx, idx + 1].add(Hij)
        H_ss = H_ss.at[idx + 1, idx].add(jnp.swapaxes(Hij, -1, -2))
        g_s = g_s.at[idx].add(gi)
        g_s = g_s.at[idx + 1].add(gj)

        g_l_m = jnp.where(lm_active[:, None], g_l, 0.0)
        H_pl6_m = jnp.where(lm_active[None, :, None, None], H_pl6, 0.0)
        sys = (H_ss, H_ll, H_pl6_m, g_s, g_l_m)
        r_sq = jnp.sum(lin.r ** 2, axis=-1)
        return sys, jnp.sum(lin.cost) + jnp.sum(imu_costs), r_sq

    def damp(sys, lam, lm_active):
        """Marquardt damping on the state/landmark diagonal blocks (cheap —
        redone per lambda retry without relinearizing)."""
        H_ss, H_ll, H_pl6_m, g_s, g_l_m = sys
        diag_ss = jnp.maximum(
            jax.vmap(jnp.diag)(H_ss[jnp.arange(W), jnp.arange(W)]), 1e-8)
        H_ss_d = H_ss.at[jnp.arange(W), jnp.arange(W)].add(
            lam * jax.vmap(jnp.diag)(diag_ss))
        dl = jnp.maximum(jax.vmap(jnp.diag)(H_ll), 1e-8)
        H_ll_d = H_ll + lam * jax.vmap(jnp.diag)(dl)
        eye3 = jnp.eye(3, dtype=dtype)
        H_ll_d = jnp.where(lm_active[:, None, None], H_ll_d, eye3[None])
        return H_ss_d, H_ll_d, H_pl6_m, g_s, g_l_m

    def schur_step(H_ss, H_ll_d, H_pl6, g_s, g_l, lm_active):
        H_ll_inv, inv_ok = ba_mod._inv3x3(H_ll_d)
        A6 = jnp.einsum("wlij,ljk->wlik", H_pl6, H_ll_inv)   # (W,L,6,3)
        S6 = jnp.einsum("wlik,vljk->wvij", A6, H_pl6)        # (W,W,6,6)
        S_blocks = H_ss.at[:, :, :6, :6].add(-S6)
        b_red = (-g_s).at[:, :6].add(jnp.einsum("wlik,lk->wi", A6, g_l))
        S = S_blocks.transpose(0, 2, 1, 3).reshape(W * D, W * D)
        b = b_red.reshape(W * D)
        if fix_first:
            # Fix only the first pose's 6 dims; velocity/bias stay free.
            m = jnp.ones(W * D, dtype=dtype).at[:6].set(0.0)
            S = S * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
            b = b * m
        cho = jax.scipy.linalg.cho_factor(S, lower=True)
        delta_s = jax.scipy.linalg.cho_solve(cho, b).reshape(W, D)
        rhs_l = -g_l - jnp.einsum("wlij,wi->lj", H_pl6, delta_s[:, :6])
        delta_l = jnp.einsum("lij,lj->li", H_ll_inv, rhs_l)
        delta_l = jnp.where(lm_active[:, None], delta_l, 0.0)
        ok = (jnp.all(jnp.isfinite(delta_s)) & jnp.all(jnp.isfinite(delta_l))
              & jnp.all(inv_ok | (~lm_active)))
        return delta_s, delta_l, ok

    sys0, cost0, _ = lin_sys(state, landmarks, mask0, lm_active0)

    def cond(c):
        return (~c[6]) & (c[5] < cfg.max_iterations)

    def body(c):
        (st, lms, sys, cost, lam, it, done, status, metrics, mask,
         lm_active, n_acc) = c
        H_ss, H_ll_d, H_pl6, g_s, g_l_m = damp(sys, lam, lm_active)
        delta_s, delta_l, ok_step = schur_step(H_ss, H_ll_d, H_pl6, g_s,
                                               g_l_m, lm_active)
        delta_s = jnp.where(ok_step, delta_s, 0.0)
        delta_l = jnp.where(ok_step, delta_l, 0.0)
        st_new = _retract_state(st, delta_s)
        lms_new = lms + delta_l
        sys_new, new_cost, r_sq_new = lin_sys(st_new, lms_new, mask,
                                              lm_active)
        accept = ok_step & jnp.isfinite(new_cost) & (new_cost < cost)

        if cfg.chi2_gate > 0.0:
            # Visual outlier gate (see ba.solve_ba); IMU factors untouched.
            do_gate = accept & (n_acc + 1 == max(1, cfg.chi2_gate_iter))

            def regate(_):
                m = mask & (r_sq_new <= cfg.chi2_gate ** 2)
                act = ba_mod.stereo_observability_mask(m, lm_valid)
                m = m & act[None, None, :]
                n_b = jnp.sum(m)
                n_imu = jnp.sum(preint_valid)
                guard = ((n_b + n_imu >= cfg.min_residual_blocks)
                         & (2 * n_b + 15 * n_imu
                            >= W * D - 6 + 3 * jnp.sum(act)))
                m = jnp.where(guard, m, mask)
                act = jnp.where(guard, act, lm_active)
                sys_g, cost_g, _ = lin_sys(st_new, lms_new, m, act)
                return m, act, sys_g, cost_g

            mask, lm_active, sys_new, new_cost = jax.lax.cond(
                do_gate, regate,
                lambda _: (mask, lm_active, sys_new, new_cost), None)
        n_acc = n_acc + accept.astype(jnp.int32)

        cost_conv = accept & (jnp.abs(cost - new_cost)
                              <= cfg.cost_tol * jnp.maximum(cost, 1e-12))
        step_norm = jnp.sqrt(jnp.sum(delta_s ** 2) + jnp.sum(delta_l ** 2))
        param_conv = accept & (step_norm <= cfg.param_tol)
        # Observer columns (ref observer.rs:40-68): gradient norm + gain
        # ratio via the damped-normal-equation prediction.
        g_s_u, g_l_u = sys[3], sys[4]
        g_norm = jnp.sqrt(jnp.sum(g_s_u ** 2) + jnp.sum(g_l_u ** 2))
        d_s = jnp.maximum(
            jax.vmap(jnp.diag)(sys[0][jnp.arange(W), jnp.arange(W)]), 1e-8)
        d_l = jnp.maximum(jax.vmap(jnp.diag)(sys[1]), 1e-8)
        pred = 0.5 * (lam * (jnp.sum(d_s * delta_s ** 2)
                             + jnp.sum(d_l * delta_l ** 2))
                      - (jnp.sum(g_s_u * delta_s)
                         + jnp.sum(g_l_u * delta_l)))
        rho = ba_mod.step_quality(cost, new_cost, pred)
        metrics = metrics.at[it].set(ba_mod.metrics_row(
            new_cost, g_norm, lam, step_norm, rho, accept))
        st = jax.tree.map(lambda a, b: jnp.where(accept, b, a), st, st_new)
        lms = jnp.where(accept, lms_new, lms)
        sys = jax.tree.map(lambda new, old: jnp.where(accept, new, old),
                           sys_new, sys)
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.where(accept, jnp.maximum(lam * 0.33, 1e-12), lam * 4.0)
        hard_fail = lam > cfg.lambda_max
        done = cost_conv | param_conv | hard_fail
        status = ba_mod.lm_status(cost_conv, param_conv, hard_fail)
        return (st, lms, sys, cost, lam, it + 1, done, status, metrics,
                mask, lm_active, n_acc)

    init = (state, landmarks, sys0, cost0,
            jnp.asarray(cfg.lambda_init, dtype),
            jnp.asarray(0, jnp.int32), ~attempt,
            jnp.asarray(ba_mod.STATUS_MAX_ITERATIONS, jnp.int32),
            jnp.zeros((cfg.max_iterations, ba_mod.N_METRIC_COLS), dtype),
            mask0, lm_active0, jnp.asarray(0, jnp.int32))
    (st, lms, _, cost, lam, it, _, status, metrics,
     _mask, _act, _n) = jax.lax.while_loop(cond, body, init)

    status = jnp.where(attempt, status, ba_mod.STATUS_SKIPPED)
    # Numerical-health gate (see ba.solve_ba): non-finite results roll back.
    finite = (jnp.all(jnp.isfinite(st.T_W_B)) & jnp.all(jnp.isfinite(st.vel))
              & jnp.all(jnp.isfinite(st.bg)) & jnp.all(jnp.isfinite(st.ba))
              & jnp.all(jnp.isfinite(jnp.where(_act[:, None], lms, 0.0))))
    success = attempt & (status != ba_mod.STATUS_FAILED) & finite
    st_out = jax.tree.map(lambda a, b: jnp.where(success, b, a), state, st)
    lms_out = jnp.where(success, lms, landmarks)
    return VIOBAResult(state=st_out, landmarks=lms_out, success=success,
                       status=status, initial_cost=cost0, final_cost=cost,
                       iterations=it,
                       metrics=metrics)

# ---------------------------------------------------------------------------
# Prior-augmented (marginalized) visual-inertial window solve. Greenfield
# capability: the reference evicts FIFO with no marginalization
# (ref README.md:79, src/estimator/sliding_window.rs:73-79) and has no IMU.
# The prior spans the FULL 15-dim states (pose + velocity + biases), so
# evicted keyframes keep constraining the window's velocity/bias estimates.
# ---------------------------------------------------------------------------

from .marginalization import MargPrior, marginalize_oldest, prior_terms  # noqa: E402


def build_eviction_prior(st_out: VIOState, lms_out, T_C_B, obs0, mask0,
                         preint0, preint_valid0, sqrt_info0,
                         prior: MargPrior, cfg: VIOBAConfig,
                         obs_w0=None) -> MargPrior:
    """Next-prior construction from the EVICTION system — shared VERBATIM by
    the single-device and distributed marginalized VIO solvers (any drift
    between the two breaks distributed parity).

    The eviction system holds only the information that actually LEAVES the
    active window: the current prior (which involves state 0), the IMU
    factor joining states 0-1 (its preintegrated interval rolls out with the
    evicted keyframe), and — as the absolute-pose anchor — the evicted
    frame's visual factors with landmarks held fixed. Folding the FULL final
    window system instead re-counts every surviving factor at every eviction
    (the round-2 accuracy bug). After marginalizing state 0 the prior decays
    by cfg.prior_decay and its bias (or pose, per config) rows are dropped —
    see the VIOBAConfig field docstrings for the measured rationale.

    Args:
      st_out, lms_out: the solved window states/landmarks.
      obs0, mask0: state 0's observations (2,L,2) and FINAL (chi^2-gated)
        mask (2,L).
      preint0, preint_valid0, sqrt_info0: interval 0-1 preintegration,
        validity, and hoisted whitening.
      prior: the incoming prior (consumed by the eviction system).
    Returns the rolled MargPrior (validity NOT set — callers gate on
    will_evict & success).
    """
    W = st_out.T_W_B.shape[0]
    dtype = st_out.T_W_B.dtype
    extra = jnp.concatenate([st_out.vel, st_out.bg, st_out.ba], axis=1)

    H_add_f, g_add_f, _ = prior_terms(prior, st_out.T_W_B, extra)
    r0, J0_i, J0_j = _imu_linearize_one(preint0, st_out, 0, cfg, sqrt_info0)
    w0 = preint_valid0.astype(dtype)
    H_ev = H_add_f
    H_ev = H_ev.at[:D, :D].add(w0 * (J0_i.T @ J0_i))
    H_ev = H_ev.at[D:2 * D, D:2 * D].add(w0 * (J0_j.T @ J0_j))
    H_ev = H_ev.at[:D, D:2 * D].add(w0 * (J0_i.T @ J0_j))
    H_ev = H_ev.at[D:2 * D, :D].add(w0 * (J0_j.T @ J0_i))
    g_ev = g_add_f
    g_ev = g_ev.at[:D].add(w0 * (J0_i.T @ r0))
    g_ev = g_ev.at[D:2 * D].add(w0 * (J0_j.T @ r0))
    if cfg.prior_visual_anchor:
        T_B_W0 = lie.se3_inverse(st_out.T_W_B[0])
        lin0 = jax.vmap(jax.vmap(
            lambda Tcb, p, o, m: linearize_projection(
                Tcb, T_B_W0, p, o, m, cfg.huber_delta),
            in_axes=(None, 0, 0, 0)), in_axes=(0, None, 0, 0))(
            T_C_B, lms_out, obs0, mask0)
        if obs_w0 is not None:
            # Same birth-score weighting as the window solve, so the
            # marginal never counts weak observations at full strength.
            sw = obs_w0[None, :, None]
            lin0 = lin0._replace(r=lin0.r * sw,
                                 J_pose=lin0.J_pose * sw[..., None])
        Jv = lin0.J_pose.reshape(-1, 6)
        rv = lin0.r.reshape(-1)
        H_ev = H_ev.at[:6, :6].add(Jv.T @ Jv)
        g_ev = g_ev.at[:6].add(Jv.T @ rv)
    new_prior = marginalize_oldest(H_ev, g_ev, st_out.T_W_B, extra, prior, D)
    # Information forgetting + subspace restriction.
    H_new = new_prior.H * cfg.prior_decay
    g_new = new_prior.g * cfg.prior_decay
    keep = None
    if cfg.prior_velocity_bias_only:
        keep = jnp.tile(jnp.concatenate(
            [jnp.zeros(6, dtype), jnp.ones(D - 6, dtype)]), W)
    elif cfg.prior_drop_bias:
        keep = jnp.tile(jnp.concatenate(
            [jnp.ones(9, dtype), jnp.zeros(D - 9, dtype)]), W)
    if keep is not None:
        H_new = H_new * keep[:, None] * keep[None, :]
        g_new = g_new * keep
    return new_prior._replace(H=H_new, g=g_new)


@partial(jax.jit, static_argnames=("cfg",))
def solve_vio_ba_marginalized(state: VIOState, T_C_B, landmarks, obs,
                              obs_mask, lm_valid,
                              preint: Preintegrated, preint_valid,
                              prior: MargPrior, will_evict,
                              cfg: VIOBAConfig = VIOBAConfig(),
                              obs_weight=None, bias_alpha=None):
    """solve_vio_ba with a 15-dim-state pose/velocity/bias prior + rollout of
    the next prior.

    Args (beyond solve_vio_ba):
      prior: MargPrior over the W states with block size B=15 (tangent
        convention matches _retract_state: split retraction on T_B_W for the
        pose, additive velocity/bias).
      will_evict: () bool — when True the returned prior marginalizes state 0
        of the final linearized, landmark-eliminated system and is rolled one
        slot; otherwise the input prior passes through.

    Returns (VIOBAResult, new MargPrior).
    """
    W = state.T_W_B.shape[0]
    dtype = state.T_W_B.dtype
    b_scales = bias_desert_scales(cfg, bias_alpha, dtype)

    lm_active0 = ba_mod.lm_span_gate(
        ba_mod.stereo_observability_mask(obs_mask, lm_valid),
        obs_mask, cfg.min_lm_span)
    mask0 = obs_mask & lm_active0[None, None, :]
    n_blocks = jnp.sum(mask0) + jnp.sum(preint_valid)
    n_rows = 2 * jnp.sum(mask0) + 15 * jnp.sum(preint_valid)
    n_vars = W * D - 6 + 3 * jnp.sum(lm_active0)
    attempt = (n_blocks >= cfg.min_residual_blocks) & (n_rows >= n_vars)
    # ALWAYS hard-fix the first pose. The VIO prior is built from the
    # EVICTION system only (current prior + one relative IMU factor — see the
    # next-prior comment below), so it carries almost no absolute pose
    # information; treating it as the gauge anchor (fix_first = ~prior.valid,
    # the round-2 behavior) leaves the window anchored by a near-zero
    # quadratic and the trajectory free to wander — measured on the device
    # accuracy matrix as the vio_marg collapse (0.33-1.9 m ATE vs
    # 0.01-1.1 m vio_fifo on every scene). With the gauge fixed like the
    # FIFO solve, the prior contributes exactly what eviction preserved:
    # velocity/bias/gravity continuity. (The VO-marg solver keeps the
    # prior-anchored gauge: its prior folds the full visual system and DOES
    # carry absolute pose info, ref models/ba.py.)
    fix_first = jnp.asarray(True)

    def _extra(st: VIOState):
        return jnp.concatenate([st.vel, st.bg, st.ba], axis=1)  # (W,9)

    # Whitening of each IMU interval depends only on the (fixed)
    # preintegration — compute once per solve, not per LM iteration.
    sqrt_infos = jax.vmap(
        lambda i: _imu_sqrt_info(jax.tree.map(lambda x: x[i], preint), cfg))(
        jnp.arange(W - 1))

    def lin_sys(st: VIOState, lms, mask, lm_active):
        """ONE pass per point: undamped prior-augmented state system AND the
        total (visual + IMU + prior) cost (mirrors solve_vio_ba.lin_sys with
        the prior injected on the (W·15) state block)."""
        T_B_W = jax.vmap(lie.se3_inverse)(st.T_W_B)
        lin = _visual_linearize(T_B_W, T_C_B, lms, obs, mask, cfg.huber_delta)
        if obs_weight is not None:
            # Birth-score observation weighting (see ba.apply_obs_weights);
            # IMU factors are never weighted.
            lin = ba_mod.apply_obs_weights(lin, obs_weight)
        H_pp6, H_ll, H_pl6, g_p6, g_l = ba_mod.build_normal_equations(lin)

        # Visual pose blocks embedded in the 15-dim layout; the landmark
        # coupling stays 6-dim (see solve_vio_ba.lin_sys).
        H_ss = jnp.zeros((W, W, D, D), dtype=dtype)
        H_ss = H_ss.at[jnp.arange(W), jnp.arange(W), :6, :6].add(H_pp6)
        g_s = jnp.zeros((W, D), dtype=dtype)
        g_s = g_s.at[:, :6].add(g_p6)

        def imu_blocks(i):
            r, J_i, J_j = _imu_linearize_one(
                jax.tree.map(lambda x: x[i], preint), st, i, cfg,
                sqrt_infos[i],
                None if b_scales is None else b_scales[i])
            w = preint_valid[i].astype(dtype)
            return (w * (J_i.T @ J_i), w * (J_j.T @ J_j), w * (J_i.T @ J_j),
                    w * (J_i.T @ r), w * (J_j.T @ r),
                    0.5 * w * jnp.dot(r, r))

        Hii, Hjj, Hij, gi, gj, imu_costs = jax.vmap(imu_blocks)(
            jnp.arange(W - 1))
        idx = jnp.arange(W - 1)
        H_ss = H_ss.at[idx, idx].add(Hii)
        H_ss = H_ss.at[idx + 1, idx + 1].add(Hjj)
        H_ss = H_ss.at[idx, idx + 1].add(Hij)
        H_ss = H_ss.at[idx + 1, idx].add(jnp.swapaxes(Hij, -1, -2))
        g_s = g_s.at[idx].add(gi)
        g_s = g_s.at[idx + 1].add(gj)

        # Prior over the flattened (W·15) state vector.
        H_add, g_add, pcost = prior_terms(prior, st.T_W_B, _extra(st))
        H_ss = (H_ss.transpose(0, 2, 1, 3).reshape(W * D, W * D) + H_add) \
            .reshape(W, D, W, D).transpose(0, 2, 1, 3)
        g_s = (g_s.reshape(W * D) + g_add).reshape(W, D)

        g_l_m = jnp.where(lm_active[:, None], g_l, 0.0)
        H_pl6_m = jnp.where(lm_active[None, :, None, None], H_pl6, 0.0)
        sys = (H_ss, H_ll, H_pl6_m, g_s, g_l_m)
        r_sq = jnp.sum(lin.r ** 2, axis=-1)
        return sys, jnp.sum(lin.cost) + jnp.sum(imu_costs) + pcost, r_sq

    def damp(sys, lam, lm_active):
        H_ss, H_ll, H_pl6_m, g_s, g_l_m = sys
        diag_ss = jnp.maximum(
            jax.vmap(jnp.diag)(H_ss[jnp.arange(W), jnp.arange(W)]), 1e-8)
        H_ss_d = H_ss.at[jnp.arange(W), jnp.arange(W)].add(
            lam * jax.vmap(jnp.diag)(diag_ss))
        dl = jnp.maximum(jax.vmap(jnp.diag)(H_ll), 1e-8)
        H_ll_d = H_ll + lam * jax.vmap(jnp.diag)(dl)
        eye3 = jnp.eye(3, dtype=dtype)
        H_ll_d = jnp.where(lm_active[:, None, None], H_ll_d, eye3[None])
        return H_ss_d, H_ll_d, H_pl6_m, g_s, g_l_m

    def schur_step(H_ss, H_ll_d, H_pl6, g_s, g_l, lm_active):
        H_ll_inv, inv_ok = ba_mod._inv3x3(H_ll_d)
        A6 = jnp.einsum("wlij,ljk->wlik", H_pl6, H_ll_inv)
        S6 = jnp.einsum("wlik,vljk->wvij", A6, H_pl6)
        S_blocks = H_ss.at[:, :, :6, :6].add(-S6)
        b_red = (-g_s).at[:, :6].add(jnp.einsum("wlik,lk->wi", A6, g_l))
        S = S_blocks.transpose(0, 2, 1, 3).reshape(W * D, W * D)
        b = b_red.reshape(W * D)

        def fixed(args):
            S_, b_ = args
            m = jnp.ones(W * D, dtype=dtype).at[:6].set(0.0)
            return S_ * m[:, None] * m[None, :] + jnp.diag(1.0 - m), b_ * m

        S2, b2 = jax.lax.cond(fix_first, fixed, lambda a: a, (S, b))
        cho = jax.scipy.linalg.cho_factor(S2, lower=True)
        delta_s = jax.scipy.linalg.cho_solve(cho, b2).reshape(W, D)
        rhs_l = -g_l - jnp.einsum("wlij,wi->lj", H_pl6, delta_s[:, :6])
        delta_l = jnp.einsum("lij,lj->li", H_ll_inv, rhs_l)
        delta_l = jnp.where(lm_active[:, None], delta_l, 0.0)
        ok = (jnp.all(jnp.isfinite(delta_s)) & jnp.all(jnp.isfinite(delta_l))
              & jnp.all(inv_ok | (~lm_active)))
        return delta_s, delta_l, ok

    sys0, cost0, _ = lin_sys(state, landmarks, mask0, lm_active0)

    def cond(c):
        return (~c[6]) & (c[5] < cfg.max_iterations)

    def body(c):
        (st, lms, sys, cost, lam, it, done, status, metrics, mask,
         lm_active, n_acc) = c
        H_ss, H_ll_d, H_pl6, g_s, g_l_m = damp(sys, lam, lm_active)
        delta_s, delta_l, ok_step = schur_step(H_ss, H_ll_d, H_pl6, g_s,
                                               g_l_m, lm_active)
        delta_s = jnp.where(ok_step, delta_s, 0.0)
        delta_l = jnp.where(ok_step, delta_l, 0.0)
        st_new = _retract_state(st, delta_s)
        lms_new = lms + delta_l
        sys_new, new_cost, r_sq_new = lin_sys(st_new, lms_new, mask,
                                              lm_active)
        accept = ok_step & jnp.isfinite(new_cost) & (new_cost < cost)

        if cfg.chi2_gate > 0.0:
            # Visual outlier gate (see ba.solve_ba); IMU + prior untouched.
            do_gate = accept & (n_acc + 1 == max(1, cfg.chi2_gate_iter))

            def regate(_):
                m = mask & (r_sq_new <= cfg.chi2_gate ** 2)
                act = ba_mod.stereo_observability_mask(m, lm_valid)
                m = m & act[None, None, :]
                n_b = jnp.sum(m)
                n_imu = jnp.sum(preint_valid)
                guard = ((n_b + n_imu >= cfg.min_residual_blocks)
                         & (2 * n_b + 15 * n_imu
                            >= W * D - 6 + 3 * jnp.sum(act)))
                m = jnp.where(guard, m, mask)
                act = jnp.where(guard, act, lm_active)
                sys_g, cost_g, _ = lin_sys(st_new, lms_new, m, act)
                return m, act, sys_g, cost_g

            mask, lm_active, sys_new, new_cost = jax.lax.cond(
                do_gate, regate,
                lambda _: (mask, lm_active, sys_new, new_cost), None)
        n_acc = n_acc + accept.astype(jnp.int32)

        cost_conv = accept & (jnp.abs(cost - new_cost)
                              <= cfg.cost_tol * jnp.maximum(cost, 1e-12))
        step_norm = jnp.sqrt(jnp.sum(delta_s ** 2) + jnp.sum(delta_l ** 2))
        param_conv = accept & (step_norm <= cfg.param_tol)
        g_s_u, g_l_u = sys[3], sys[4]
        g_norm = jnp.sqrt(jnp.sum(g_s_u ** 2) + jnp.sum(g_l_u ** 2))
        d_s = jnp.maximum(
            jax.vmap(jnp.diag)(sys[0][jnp.arange(W), jnp.arange(W)]), 1e-8)
        d_l = jnp.maximum(jax.vmap(jnp.diag)(sys[1]), 1e-8)
        pred = 0.5 * (lam * (jnp.sum(d_s * delta_s ** 2)
                             + jnp.sum(d_l * delta_l ** 2))
                      - (jnp.sum(g_s_u * delta_s)
                         + jnp.sum(g_l_u * delta_l)))
        rho = ba_mod.step_quality(cost, new_cost, pred)
        metrics = metrics.at[it].set(ba_mod.metrics_row(
            new_cost, g_norm, lam, step_norm, rho, accept))
        st = jax.tree.map(lambda a, b: jnp.where(accept, b, a), st, st_new)
        lms = jnp.where(accept, lms_new, lms)
        sys = jax.tree.map(lambda new, old: jnp.where(accept, new, old),
                           sys_new, sys)
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.where(accept, jnp.maximum(lam * 0.33, 1e-12), lam * 4.0)
        hard_fail = lam > cfg.lambda_max
        done = cost_conv | param_conv | hard_fail
        status = ba_mod.lm_status(cost_conv, param_conv, hard_fail)
        return (st, lms, sys, cost, lam, it + 1, done, status, metrics,
                mask, lm_active, n_acc)

    init = (state, landmarks, sys0, cost0,
            jnp.asarray(cfg.lambda_init, dtype),
            jnp.asarray(0, jnp.int32), ~attempt,
            jnp.asarray(ba_mod.STATUS_MAX_ITERATIONS, jnp.int32),
            jnp.zeros((cfg.max_iterations, ba_mod.N_METRIC_COLS), dtype),
            mask0, lm_active0, jnp.asarray(0, jnp.int32))
    (st, lms, _, cost, lam, it, _, status, metrics,
     mask_f, _act, _n) = jax.lax.while_loop(cond, body, init)

    status = jnp.where(attempt, status, ba_mod.STATUS_SKIPPED)
    # Numerical-health gate (see ba.solve_ba): non-finite results roll back.
    finite = (jnp.all(jnp.isfinite(st.T_W_B)) & jnp.all(jnp.isfinite(st.vel))
              & jnp.all(jnp.isfinite(st.bg)) & jnp.all(jnp.isfinite(st.ba))
              & jnp.all(jnp.isfinite(jnp.where(_act[:, None], lms, 0.0))))
    success = attempt & (status != ba_mod.STATUS_FAILED) & finite
    st_out = jax.tree.map(lambda a, b: jnp.where(success, b, a), state, st)
    lms_out = jnp.where(success, lms, landmarks)

    # ---- next prior: the EVICTION system (see build_eviction_prior) built
    # from the chi^2-gated final observation mask so excised outliers never
    # enter the marginal.
    new_prior = build_eviction_prior(
        st_out, lms_out, T_C_B, obs[0], mask_f[0],
        jax.tree.map(lambda x: x[0], preint), preint_valid[0],
        sqrt_infos[0], prior, cfg,
        obs_w0=None if obs_weight is None else obs_weight[0])
    do_new = will_evict & success
    out_prior = jax.tree.map(
        lambda new, old: jnp.where(do_new, new, old), new_prior, prior)
    out_prior = out_prior._replace(valid=jnp.where(do_new, True, prior.valid))

    result = VIOBAResult(state=st_out, landmarks=lms_out, success=success,
                         status=status, initial_cost=cost0, final_cost=cost,
                         iterations=it,
                         metrics=metrics)
    return result, out_prior
