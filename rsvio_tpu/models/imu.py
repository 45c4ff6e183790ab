"""IMU preintegration: on-device batched preintegration of gyro/accel samples
between keyframes, with bias Jacobians, plus the 15-dim residual joining
consecutive VIO states.

Greenfield capability (SURVEY.md §7 step 8): the reference only has
placeholder structures — ImuData (ref src/datasets/mod.rs:21-26), per-frame
IMU vectors (ref src/estimator/frame.rs:33-37) and velocity/bias slots in
State (ref src/estimator/state.rs:12-19) that nothing consumes. This module
implements the standard preintegration theory (Forster et al., on-manifold
preintegration) in an accelerator-friendly form:

  * fixed-capacity sample buffers with validity masks (static shapes),
  * lax.scan over samples — the only inherently sequential axis — while
    everything else (multiple intervals, the factor residuals) vmaps,
  * first-order bias correction so re-preintegration is not needed when the
    bias estimate moves during optimization.

Conventions: gravity in world frame g = (0, 0, -9.81); states are
(T_W_B, v_W, b_g, b_a).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie

GRAVITY = 9.81


class ImuParams(NamedTuple):
    gyro_noise: float = 1.7e-4     # rad/s/sqrt(Hz)  (EuRoC MAV defaults)
    accel_noise: float = 2.0e-3    # m/s^2/sqrt(Hz)
    gyro_bias_walk: float = 1.9e-5
    accel_bias_walk: float = 3.0e-3


class Preintegrated(NamedTuple):
    """Preintegrated IMU measurement over one keyframe interval."""
    dR: jnp.ndarray        # (3,3) rotation delta (body_i -> body_j, bias-corrected at linearization point)
    dv: jnp.ndarray        # (3,) velocity delta in body_i frame
    dp: jnp.ndarray        # (3,) position delta in body_i frame
    dt: jnp.ndarray        # () total integration time
    # First-order bias Jacobians
    dR_dbg: jnp.ndarray    # (3,3)
    dv_dbg: jnp.ndarray    # (3,3)
    dv_dba: jnp.ndarray    # (3,3)
    dp_dbg: jnp.ndarray    # (3,3)
    dp_dba: jnp.ndarray    # (3,3)
    cov: jnp.ndarray       # (9,9) covariance of [dR, dv, dp] errors
    bias_gyro: jnp.ndarray  # (3,) linearization-point gyro bias
    bias_accel: jnp.ndarray  # (3,) linearization-point accel bias


def preintegrate(gyro, accel, dts, mask, bias_gyro, bias_accel,
                 params: ImuParams = ImuParams()) -> Preintegrated:
    """Preintegrate a masked sample buffer.

    Args:
      gyro, accel: (S, 3) raw samples.
      dts: (S,) per-sample integration intervals (seconds).
      mask: (S,) bool — padding samples contribute nothing.
      bias_gyro, bias_accel: (3,) biases at the linearization point.
    """
    dtype = gyro.dtype
    I3 = jnp.eye(3, dtype=dtype)

    def scan_fn(carry, inp):
        dR, dv, dp, dR_dbg, dv_dbg, dv_dba, dp_dbg, dp_dba, cov, t = carry
        w, a, dt, m = inp
        dt = jnp.where(m, dt, 0.0)
        w_c = w - bias_gyro
        a_c = a - bias_accel
        dRk = lie.so3_exp(w_c * dt)
        a_rot = dR @ a_c

        # Midpoint-free Euler update (standard discrete preintegration)
        dp_new = dp + dv * dt + 0.5 * a_rot * dt * dt
        dv_new = dv + a_rot * dt
        dR_new = dR @ dRk

        # Bias Jacobians (Forster et al. eqs., right-Jacobian approximated by
        # I for the small per-sample angles of a 200 Hz IMU)
        a_hat = lie.so3_hat(a_c)
        dp_dbg_new = dp_dbg + dv_dbg * dt - 0.5 * dR @ a_hat @ dR_dbg * dt * dt
        dp_dba_new = dp_dba + dv_dba * dt - 0.5 * dR * dt * dt
        dv_dbg_new = dv_dbg - dR @ a_hat @ dR_dbg * dt
        dv_dba_new = dv_dba - dR * dt
        dR_dbg_new = dRk.T @ dR_dbg - jnp.eye(3, dtype=dtype) * dt

        # Covariance propagation (block form, [theta, v, p])
        A = jnp.zeros((9, 9), dtype=dtype)
        A = A.at[0:3, 0:3].set(dRk.T)
        A = A.at[3:6, 0:3].set(-dR @ a_hat * dt)
        A = A.at[3:6, 3:6].set(I3)
        A = A.at[6:9, 0:3].set(-0.5 * dR @ a_hat * dt * dt)
        A = A.at[6:9, 3:6].set(I3 * dt)
        A = A.at[6:9, 6:9].set(I3)
        sg = params.gyro_noise ** 2
        sa = params.accel_noise ** 2
        Q = jnp.zeros((9, 9), dtype=dtype)
        Q = Q.at[0:3, 0:3].set(I3 * sg * dt)
        Q = Q.at[3:6, 3:6].set(I3 * sa * dt)
        Q = Q.at[6:9, 6:9].set(I3 * sa * dt * dt * dt / 3.0)
        cov_new = A @ cov @ A.T + Q

        keep = m
        new = (jnp.where(keep, dR_new, dR), jnp.where(keep, dv_new, dv),
               jnp.where(keep, dp_new, dp),
               jnp.where(keep, dR_dbg_new, dR_dbg),
               jnp.where(keep, dv_dbg_new, dv_dbg),
               jnp.where(keep, dv_dba_new, dv_dba),
               jnp.where(keep, dp_dbg_new, dp_dbg),
               jnp.where(keep, dp_dba_new, dp_dba),
               jnp.where(keep, cov_new, cov), t + dt)
        return new, None

    Z3 = jnp.zeros((3, 3), dtype=dtype)
    init = (I3, jnp.zeros(3, dtype=dtype), jnp.zeros(3, dtype=dtype),
            Z3, Z3, Z3, Z3, Z3, jnp.zeros((9, 9), dtype=dtype),
            jnp.zeros((), dtype=dtype))
    (dR, dv, dp, dR_dbg, dv_dbg, dv_dba, dp_dbg, dp_dba, cov, t), _ = \
        jax.lax.scan(scan_fn, init, (gyro, accel, dts, mask))
    return Preintegrated(dR=dR, dv=dv, dp=dp, dt=t,
                         dR_dbg=dR_dbg, dv_dbg=dv_dbg, dv_dba=dv_dba,
                         dp_dbg=dp_dbg, dp_dba=dp_dba, cov=cov,
                         bias_gyro=bias_gyro, bias_accel=bias_accel)


def imu_residual(pre: Preintegrated, T_W_Bi, v_i, bg_i, ba_i,
                 T_W_Bj, v_j, bg_j, ba_j):
    """15-dim whitened-later residual between consecutive VIO states.

    r = [r_dR (3), r_dv (3), r_dp (3), r_bg (3), r_ba (3)]
    using first-order bias correction around the preintegration point.
    """
    dtype = pre.dR.dtype
    g = jnp.asarray([0.0, 0.0, -GRAVITY], dtype=dtype)
    R_i = T_W_Bi[:3, :3]
    p_i = T_W_Bi[:3, 3]
    R_j = T_W_Bj[:3, :3]
    p_j = T_W_Bj[:3, 3]
    dt = pre.dt

    dbg = bg_i - pre.bias_gyro
    dba = ba_i - pre.bias_accel
    dR_corr = pre.dR @ lie.so3_exp(pre.dR_dbg @ dbg)
    dv_corr = pre.dv + pre.dv_dbg @ dbg + pre.dv_dba @ dba
    dp_corr = pre.dp + pre.dp_dbg @ dbg + pre.dp_dba @ dba

    r_dR = lie.so3_log(dR_corr.T @ (R_i.T @ R_j))
    r_dv = R_i.T @ (v_j - v_i - g * dt) - dv_corr
    r_dp = R_i.T @ (p_j - p_i - v_i * dt - 0.5 * g * dt * dt) - dp_corr
    r_bg = bg_j - bg_i
    r_ba = ba_j - ba_i
    return jnp.concatenate([r_dR, r_dv, r_dp, r_bg, r_ba])


def attitude_from_gravity(accel_mean):
    """Initial attitude R_W_B from the mean measured specific force.

    A static (or quasi-static) body measures a_body = R_W_B^T (0, 0, +g)
    (see imu_residual's convention with g_W = (0, 0, -9.81)), so the minimal
    rotation taking the measured unit direction u = a/|a| onto world +z is
    the gravity-aligned initial attitude. Yaw is unobservable from gravity
    and left at zero (it only rotates the world gauge).

    Returns (3,3) R_W_B with R @ u == (0, 0, 1).
    """
    dtype = accel_mean.dtype
    u = accel_mean / jnp.maximum(jnp.linalg.norm(accel_mean), 1e-9)
    z = jnp.asarray([0.0, 0.0, 1.0], dtype)
    v = jnp.cross(u, z)
    s = jnp.linalg.norm(v)
    c = jnp.dot(u, z)
    # Degenerate u ~ -z (upside down): rotate pi about x.
    axis = jnp.where(s > 1e-8, v / jnp.maximum(s, 1e-12),
                     jnp.asarray([1.0, 0.0, 0.0], dtype))
    angle = jnp.arctan2(s, c)
    return lie.so3_exp(axis * angle)


def split_samples_by_keyframes(imu_ts_ns, kf_ts_ns, max_per_interval: int):
    """Host-side: bucket IMU samples into per-keyframe-interval fixed buffers.

    Returns index/mask arrays shaped (n_intervals, max_per_interval) for
    gathering (gyro, accel, dt) buffers; pure numpy, runs in the data layer.
    """
    import numpy as np
    imu_ts = np.asarray(imu_ts_ns)
    kf_ts = np.asarray(kf_ts_ns)
    n_int = len(kf_ts) - 1
    idx = np.zeros((n_int, max_per_interval), dtype=np.int64)
    mask = np.zeros((n_int, max_per_interval), dtype=bool)
    for i in range(n_int):
        lo, hi = kf_ts[i], kf_ts[i + 1]
        sel = np.nonzero((imu_ts >= lo) & (imu_ts < hi))[0][:max_per_interval]
        idx[i, :len(sel)] = sel
        mask[i, :len(sel)] = True
    return idx, mask
