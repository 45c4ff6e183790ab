"""Lie-group math: SO(3), SE(3), SE(2) — pure jax.numpy, vmap/jit friendly.

Capability parity targets (reference, see SURVEY.md §2):
  - SE2 exp with small-angle Taylor branch (ref src/feature_tracker/image_utilities.rs:82-106)
  - SE3 pose packing/retraction used by the solver (ref src/estimator/sliding_window.rs:217-226)
  - quaternion <-> rotation-matrix conversion (ref src/viewers/rerun.rs:414-445)

Design notes:
  * Every function is shape-polymorphic over leading batch dims only via vmap —
    bodies are written for single elements with fixed small shapes so XLA sees
    static shapes and fuses everything.
  * Small-angle branches are implemented branchlessly with jnp.where on safe
    operands (no lax.cond), so vmap/batching never serializes.
  * dtype follows the inputs (f32 by default; tests may use f64 on CPU).
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def _where_small(theta_sq, taylor, exact):
    """Branchless select of a Taylor expansion for small angles."""
    return jnp.where(theta_sq < _EPS, taylor, exact)


def _safe(theta_sq):
    """Denominator-safe theta_sq: 1.0 inside the Taylor region so the unused
    exact branch never divides by ~0 (which would poison gradients through
    jnp.where — both branches are differentiated)."""
    return jnp.where(theta_sq < _EPS, jnp.ones_like(theta_sq), theta_sq)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def so3_hat(w):
    """3-vector -> skew-symmetric matrix [w]x (so3 hat operator)."""
    wx, wy, wz = w[0], w[1], w[2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy]),
        jnp.stack([wz, z, -wx]),
        jnp.stack([-wy, wx, z]),
    ])


def so3_vee(W):
    """Inverse of so3_hat."""
    return jnp.stack([W[2, 1], W[0, 2], W[1, 0]])


def so3_exp(w):
    """Rodrigues formula: axis-angle 3-vector -> rotation matrix.

    Uses 2nd-order Taylor coefficients below _EPS so gradients stay finite at 0.
    """
    theta_sq = jnp.dot(w, w)
    ts = _safe(theta_sq)
    theta = jnp.sqrt(ts)
    W = so3_hat(w)
    a = _where_small(theta_sq, 1.0 - theta_sq / 6.0, jnp.sin(theta) / theta)
    b = _where_small(theta_sq, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / ts)
    I = jnp.eye(3, dtype=w.dtype)
    return I + a * W + b * (W @ W)


def so3_log(R):
    """Rotation matrix -> axis-angle 3-vector.

    Safe near theta=0 (Taylor) and usable up to just below pi. Exact pi is a
    measure-zero set the VIO pipeline never hits between consecutive frames.
    """
    trace = R[0, 0] + R[1, 1] + R[2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(cos_theta)
    theta_sq = theta * theta
    # w = theta / (2 sin theta) * vee(R - R^T); small-angle: 0.5 * vee(R - R^T)
    sin_safe = jnp.where(theta_sq < _EPS, jnp.ones_like(theta), jnp.sin(theta))
    factor = _where_small(
        theta_sq,
        0.5 + theta_sq / 12.0,
        theta / (2.0 * sin_safe),
    )
    return factor * jnp.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])


def so3_left_jacobian(w):
    """Left Jacobian J_l of SO(3): integral of exp along the geodesic.

    se3_exp translation block: t = J_l(w) @ v.
    """
    theta_sq = jnp.dot(w, w)
    ts = _safe(theta_sq)
    theta = jnp.sqrt(ts)
    W = so3_hat(w)
    b = _where_small(theta_sq, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / ts)
    c = _where_small(theta_sq, 1.0 / 6.0 - theta_sq / 120.0,
                     (theta - jnp.sin(theta)) / (ts * theta))
    I = jnp.eye(3, dtype=w.dtype)
    return I + b * W + c * (W @ W)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z) convention
# ---------------------------------------------------------------------------

def quat_normalize(q):
    return q / jnp.maximum(jnp.linalg.norm(q), _EPS)


def quat_mul(q1, q2):
    w1, x1, y1, z1 = q1[0], q1[1], q1[2], q1[3]
    w2, x2, y2, z2 = q2[0], q2[1], q2[2], q2[3]
    return jnp.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def quat_to_rot(q):
    """Unit quaternion (w,x,y,z) -> 3x3 rotation matrix."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])


def rot_to_quat(R):
    """3x3 rotation matrix -> unit quaternion (w,x,y,z), branchless.

    Uses the four-hypothesis construction (one per largest diagonal candidate)
    combined with jnp.where so it is vmap-safe — the reference viewer uses the
    classic branching Shepperd method (ref src/viewers/rerun.rs:414-445).
    """
    d = R.dtype
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    # Four candidate quaternions, each numerically good in one regime.
    qw = jnp.sqrt(jnp.maximum(1.0 + tr, _EPS)) * 0.5
    q0 = jnp.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw), (m10 - m01) / (4 * qw)])
    qx = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, _EPS)) * 0.5
    q1 = jnp.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx), (m02 + m20) / (4 * qx)])
    qy = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, _EPS)) * 0.5
    q2 = jnp.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy, (m12 + m21) / (4 * qy)])
    qz = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, _EPS)) * 0.5
    q3 = jnp.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz), (m12 + m21) / (4 * qz), qz])
    # Pick by regime.
    cond_tr = tr > 0
    cond_x = jnp.logical_and(m00 > m11, m00 > m22)
    cond_y = m11 > m22
    q = jnp.where(cond_tr, q0, jnp.where(cond_x, q1, jnp.where(cond_y, q2, q3)))
    q = quat_normalize(q)
    # Canonicalize sign (w >= 0) for stable packing.
    return jnp.where(q[0] < 0, -q, q).astype(d)


# ---------------------------------------------------------------------------
# SE(3) — 4x4 homogeneous matrices; tangent ordering [v (trans), w (rot)]
# ---------------------------------------------------------------------------

def se3_from_rt(R, t):
    T = jnp.eye(4, dtype=R.dtype)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(t)
    return T


def se3_inverse(T):
    R = T[:3, :3]
    t = T[:3, 3]
    return se3_from_rt(R.T, -R.T @ t)


def se3_exp(xi):
    """Tangent [v, w] -> 4x4 transform. t = J_l(w) v."""
    v, w = xi[:3], xi[3:]
    R = so3_exp(w)
    t = so3_left_jacobian(w) @ v
    return se3_from_rt(R, t)


def se3_log(T):
    """4x4 transform -> tangent [v, w]."""
    w = so3_log(T[:3, :3])
    # Invert left Jacobian: solve J_l v = t (3x3, well-conditioned away from 2pi)
    Jl = so3_left_jacobian(w)
    v = jnp.linalg.solve(Jl, T[:3, 3])
    return jnp.concatenate([v, w])


def se3_mul(Ta, Tb):
    return Ta @ Tb


def se3_apply(T, p):
    """Apply transform to 3-point."""
    return T[:3, :3] @ p + T[:3, 3]


def se3_retract_split(T, delta):
    """Split retraction used by the solver: t += dt; R <- R @ exp(dw).

    delta = [dt (3), dw (3)]. Matches the parameterization implied by the
    reference's analytic BA jacobians (ref src/optimization/factors.rs:412-445:
    d p_B / d w = R_B_W * (-[p_W]x) -> right-multiplied rotation perturbation,
    additive translation).
    """
    R = T[:3, :3] @ so3_exp(delta[3:])
    t = T[:3, 3] + delta[:3]
    return se3_from_rt(R, t)


def se3_to_packed(T):
    """Pack as [tx ty tz qw qx qy qz] — the reference solver's 7-vector layout
    (ref src/estimator/sliding_window.rs:222-224)."""
    return jnp.concatenate([T[:3, 3], rot_to_quat(T[:3, :3])])


def se3_from_packed(p7):
    return se3_from_rt(quat_to_rot(quat_normalize(p7[3:])), p7[:3])


def rotation_angle(R):
    """Geodesic rotation angle in radians (used by the keyframe policy —
    the reference uses euler-angle norm, ref src/estimator/estimator.rs:203-225;
    geodesic angle is the cleaner equivalent and agrees to first order)."""
    cos_theta = jnp.clip((jnp.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    return jnp.arccos(cos_theta)


# ---------------------------------------------------------------------------
# SE(2) — for KLT patch warps. Tangent [tx, ty, theta] -> 3x3 affine matrix
# ---------------------------------------------------------------------------

def se2_exp(xi):
    """SE(2) exponential with small-angle Taylor branch
    (capability of ref src/feature_tracker/image_utilities.rs:82-106)."""
    tx, ty, theta = xi[0], xi[1], xi[2]
    theta_sq = theta * theta
    sin_t = jnp.sin(theta)
    cos_t = jnp.cos(theta)
    # V matrix entries: a = sin(t)/t, b = (1-cos(t))/t
    a = _where_small(theta_sq, 1.0 - theta_sq / 6.0, sin_t / jnp.where(theta_sq < _EPS, 1.0, theta))
    b = _where_small(theta_sq, theta / 2.0 - theta_sq * theta / 24.0,
                     (1.0 - cos_t) / jnp.where(theta_sq < _EPS, 1.0, theta))
    x = a * tx - b * ty
    y = b * tx + a * ty
    one = jnp.ones_like(tx)
    zero = jnp.zeros_like(tx)
    return jnp.stack([
        jnp.stack([cos_t, -sin_t, x]),
        jnp.stack([sin_t, cos_t, y]),
        jnp.stack([zero, zero, one]),
    ])


def se2_log(M):
    """SE(2) logarithm: 3x3 affine -> [tx, ty, theta]."""
    theta = jnp.arctan2(M[1, 0], M[0, 0])
    theta_sq = theta * theta
    sin_t = jnp.sin(theta)
    cos_t = jnp.cos(theta)
    a = _where_small(theta_sq, 1.0 - theta_sq / 6.0, sin_t / jnp.where(theta_sq < _EPS, 1.0, theta))
    b = _where_small(theta_sq, theta / 2.0, (1.0 - cos_t) / jnp.where(theta_sq < _EPS, 1.0, theta))
    det = a * a + b * b
    x, y = M[0, 2], M[1, 2]
    tx = (a * x + b * y) / det
    ty = (-b * x + a * y) / det
    return jnp.stack([tx, ty, theta])
