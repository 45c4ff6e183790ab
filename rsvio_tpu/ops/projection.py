"""Reprojection residuals + analytic Jacobians shared by PnP and BA.

Capability parity (SURVEY.md §2 #16 — ref src/optimization/factors.rs):
  * residual r = proj_normalized(T_C_B · T_B_W · p_W) − obs  (2-vector,
    observations in undistorted normalized camera coordinates)
  * analytic Jacobians w.r.t. the landmark (2x3) and the pose (2x6, split
    parameterization: additive translation, right-multiplied rotation
    perturbation) matching ref factors.rs:412-445
  * cheirality guard: a point behind the camera contributes a constant large
    residual with zero Jacobian (ref factors.rs:391-403)
  * Huber robust loss δ=2.0 on every block (ref sliding_window.rs:295-296)

All functions are per-observation; callers vmap over (window × camera ×
landmark) so the whole linearization is one batched XLA computation.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .lie import so3_hat

CHEIRALITY_RESIDUAL = 1e3  # bounded stand-in for the reference's 1e6 sentinel


class Linearization(NamedTuple):
    r: jnp.ndarray        # (2,) whitened residual (sqrt-Huber applied)
    J_pose: jnp.ndarray   # (2, 6) whitened d r / d [dt, dw] of T_B_W
    J_lm: jnp.ndarray     # (2, 3) whitened d r / d p_W
    valid: jnp.ndarray    # () bool — in front of camera and mask passed
    cost: jnp.ndarray     # () robust cost contribution rho(||r||^2)


def proj_jacobian(p_cam):
    """d(x/z, y/z)/d p_cam — the 2x3 pinhole Jacobian (ref factors.rs:136-139)."""
    x, y, z = p_cam[0], p_cam[1], p_cam[2]
    z_safe = jnp.where(jnp.abs(z) > 1e-9, z, 1e-9)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    zero = jnp.zeros_like(x)
    return jnp.stack([
        jnp.stack([iz, zero, -x * iz2]),
        jnp.stack([zero, iz, -y * iz2]),
    ])


def huber_weight(r_sq, delta: float):
    """IRLS weight for the Huber loss: 1 inside delta, delta/||r|| outside."""
    r_norm = jnp.sqrt(jnp.maximum(r_sq, 1e-18))
    return jnp.where(r_norm <= delta, jnp.ones_like(r_norm), delta / r_norm)


def huber_cost(r_sq, delta: float):
    """Huber rho(||r||): 0.5||r||^2 inside, delta(||r|| - 0.5 delta) outside."""
    r_norm = jnp.sqrt(jnp.maximum(r_sq, 1e-18))
    return jnp.where(r_norm <= delta, 0.5 * r_sq, delta * (r_norm - 0.5 * delta))


def linearize_projection(T_C_B, T_B_W, p_W, obs, mask, huber_delta: float = 2.0):
    """Linearize one reprojection observation.

    Args:
      T_C_B: (4,4) camera-from-body extrinsic.
      T_B_W: (4,4) body-from-world pose (the solver variable).
      p_W: (3,) world landmark.
      obs: (2,) observed normalized coords.
      mask: () bool observation validity.
      huber_delta: Huber threshold in normalized units.

    Returns Linearization with sqrt-Huber-whitened residual and Jacobians.
    """
    R_B_W = T_B_W[:3, :3]
    p_B = R_B_W @ p_W + T_B_W[:3, 3]
    R_C_B = T_C_B[:3, :3]
    p_C = R_C_B @ p_B + T_C_B[:3, 3]

    in_front = p_C[2] > 1e-6
    valid = mask & in_front
    z_safe = jnp.where(in_front, p_C[2], 1.0)
    proj = jnp.stack([p_C[0] / z_safe, p_C[1] / z_safe])
    r = proj - obs
    # Cheirality: behind-camera observation -> constant penalty, zero Jacobian
    # (ref factors.rs:391-403). Masked-out observations contribute nothing.
    r = jnp.where(in_front, r, jnp.full_like(r, CHEIRALITY_RESIDUAL))
    r = jnp.where(mask, r, jnp.zeros_like(r))

    Jpi = proj_jacobian(p_C)                       # (2,3)
    J_t = Jpi @ R_C_B                              # (2,3) d r / d t_B_W
    J_w = Jpi @ (R_C_B @ R_B_W @ (-so3_hat(p_W)))  # (2,3) d r / d omega
    J_pose = jnp.concatenate([J_t, J_w], axis=1)   # (2,6)
    J_lm = Jpi @ (R_C_B @ R_B_W)                   # (2,3)

    validf = valid.astype(r.dtype)
    r_sq = jnp.dot(r, r) * jnp.where(mask, 1.0, 0.0)
    w = huber_weight(r_sq, huber_delta)
    sw = jnp.sqrt(w) * validf
    cost = huber_cost(r_sq, huber_delta) * mask.astype(r.dtype)

    return Linearization(
        r=r * sw,
        J_pose=J_pose * sw,
        J_lm=J_lm * sw,
        valid=valid,
        cost=cost,
    )


def projection_cost(T_C_B, T_B_W, p_W, obs, mask, huber_delta: float = 2.0):
    """Robust cost of one observation (for LM accept/reject) — must agree with
    the cost field of linearize_projection."""
    p_B = T_B_W[:3, :3] @ p_W + T_B_W[:3, 3]
    p_C = T_C_B[:3, :3] @ p_B + T_C_B[:3, 3]
    in_front = p_C[2] > 1e-6
    z_safe = jnp.where(in_front, p_C[2], 1.0)
    proj = jnp.stack([p_C[0] / z_safe, p_C[1] / z_safe])
    r = proj - obs
    r = jnp.where(in_front, r, jnp.full_like(r, CHEIRALITY_RESIDUAL))
    r_sq = jnp.dot(r, r)
    return huber_cost(r_sq, huber_delta) * mask.astype(r.dtype)


def triangulate_stereo(T_W_Cl, T_W_Cr, xy_l, xy_r):
    """Midpoint triangulation of one landmark from a stereo pair of
    normalized-coordinate observations. Returns (p_W, valid).

    This upgrades the reference's fixed-depth-2.0 landmark initialization
    (ref src/estimator/sliding_window.rs:248-271, marked TODO: triangulate).
    Least-squares midpoint of the two viewing rays; valid requires the rays to
    be non-parallel and the point to be in front of both cameras.
    """
    o1, o2 = T_W_Cl[:3, 3], T_W_Cr[:3, 3]
    d1 = T_W_Cl[:3, :3] @ jnp.concatenate([xy_l, jnp.ones_like(xy_l[:1])])
    d2 = T_W_Cr[:3, :3] @ jnp.concatenate([xy_r, jnp.ones_like(xy_r[:1])])
    d1 = d1 / jnp.maximum(jnp.linalg.norm(d1), 1e-9)
    d2 = d2 / jnp.maximum(jnp.linalg.norm(d2), 1e-9)
    # Solve [d1 -d2][s; t] = o2 - o1 in least squares (2x2 normal equations).
    a = jnp.dot(d1, d1)
    b = jnp.dot(d1, d2)
    c = jnp.dot(d2, d2)
    rhs = o2 - o1
    det = a * c - b * b
    det_safe = jnp.where(jnp.abs(det) > 1e-9, det, 1e-9)
    s = (c * jnp.dot(d1, rhs) - b * jnp.dot(d2, rhs)) / det_safe
    t = (b * jnp.dot(d1, rhs) - a * jnp.dot(d2, rhs)) / det_safe
    p = 0.5 * ((o1 + s * d1) + (o2 + t * d2))
    valid = (jnp.abs(det) > 1e-6) & (s > 1e-3) & (t > 1e-3)
    return p, valid


def refine_landmarks(T_C_B, T_B_W, landmarks, obs, mask,
                     iterations: int = 5, huber_delta: float = 2.0,
                     lm_lambda: float = 1e-6):
    """N-view point-only refinement: Gauss-Newton over each landmark with all
    camera poses FIXED.

    Capability of the reference's PinholeProjectionFactor — a landmark
    optimized against >=2 fixed cameras (ref src/optimization/factors.rs:
    27-133, exercised in tests.rs:16-127 as triangulation-style recovery).
    Design: each landmark's normal equations are a closed-form damped 3x3
    solve; the whole table refines as ONE vmapped fori_loop (no factor
    graph, no per-landmark host loop). Typical use: polish triangulated
    births with every window observation before they enter BA.

    Args:
      T_C_B: (2,4,4) stereo extrinsics (camera-from-body).
      T_B_W: (W,4,4) body-from-world poses (FIXED).
      landmarks: (L,3) initial world points.
      obs: (W,2,L,2) normalized observations.
      mask: (W,2,L) bool observation validity.
      iterations: GN iterations (static).
      huber_delta: robust whitening threshold (normalized units).
      lm_lambda: fixed Levenberg damping on the 3x3 system.

    Returns (landmarks (L,3), ok (L,)) — ok requires >=2 observations and a
    well-conditioned final system; landmarks with ok=False are returned
    unchanged.
    """
    from ..models.ba import _inv3x3

    L = landmarks.shape[0]
    dtype = landmarks.dtype
    n_obs = jnp.sum(mask, axis=(0, 1))                     # (L,)

    def lin_one(p, o_wc, m_wc):
        """All (W,2) observations of one landmark -> (H (3,3), g (3,), cost)."""
        f = jax.vmap(jax.vmap(
            lambda T, Tcb, o, mm: linearize_projection(
                Tcb, T, p, o, mm, huber_delta),
            in_axes=(None, 0, 0, 0)), in_axes=(0, None, 0, 0))
        lin = f(T_B_W, T_C_B, o_wc, m_wc)
        J = lin.J_lm.reshape(-1, 3)
        r = lin.r.reshape(-1)
        return J.T @ J, J.T @ r, jnp.sum(lin.cost)

    def refine_one(p0, o_wc, m_wc, n):
        def body(_, carry):
            p, cost = carry
            H, g, _ = lin_one(p, o_wc, m_wc)
            H = H + lm_lambda * jnp.eye(3, dtype=dtype)
            H_inv, inv_ok = _inv3x3(H)
            step = -(H_inv @ g)
            p_new = p + step
            _, _, new_cost = lin_one(p_new, o_wc, m_wc)
            ok = inv_ok & jnp.all(jnp.isfinite(p_new)) & (new_cost <= cost)
            return jnp.where(ok, p_new, p), jnp.where(ok, new_cost, cost)

        _, _, cost0 = lin_one(p0, o_wc, m_wc)
        p, cost = jax.lax.fori_loop(0, iterations, body, (p0, cost0))
        H_f, _, _ = lin_one(p, o_wc, m_wc)
        _, cond_ok = _inv3x3(H_f + lm_lambda * jnp.eye(3, dtype=dtype))
        ok = (n >= 2) & cond_ok & jnp.all(jnp.isfinite(p))
        return jnp.where(ok, p, p0), ok

    obs_l = jnp.moveaxis(obs, 2, 0)    # (L,W,2,2)
    mask_l = jnp.moveaxis(mask, 2, 0)  # (L,W,2)
    return jax.vmap(refine_one)(landmarks, obs_l, mask_l, n_obs)
