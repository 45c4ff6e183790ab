"""Distributed per-frame estimator (landmark-sharded window BA inside the
full VO pipeline) must reproduce the single-device estimator's trajectory
on a rendered synthetic sequence."""

import jax.numpy as jnp
import numpy as np
import pytest

from rsvio_tpu.models import estimator as est
from rsvio_tpu.models.frontend import FrontendConfig
from rsvio_tpu.ops import cameras
from rsvio_tpu.ops.klt import KLTConfig
from rsvio_tpu.parallel import mesh as mesh_mod
from rsvio_tpu.parallel.dist_estimator import make_distributed_estimator_step

from test_estimator import (BASELINE, CX, CY, FX, FY, H, STEP_M, W,
                            sequence)  # noqa: F401  (fixture)


@pytest.fixture(scope="module")
def mesh8():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return mesh_mod.make_mesh(8)


def _cfg(use_marg: bool) -> est.EstimatorConfig:
    return est.EstimatorConfig(
        frontend=FrontendConfig(capacity=96, cell_size=28, detect_margin=10,
                                min_score=5.0,
                                klt=KLTConfig(levels=3, max_iterations=12)),
        window_size=4, translation_threshold=0.012,
        rotation_threshold=0.05, image_shape=(H, W),
        use_marginalization=use_marg)


def _rig():
    params = cameras.pack_params(cameras.PINHOLE_RADTAN,
                                 [FX, FY, CX, CY], [0, 0, 0, 0])
    return est.make_rig(params, params,
                        jnp.eye(4, dtype=jnp.float32),
                        jnp.eye(4, dtype=jnp.float32).at[0, 3].set(BASELINE))


@pytest.mark.parametrize("use_marg", [False, True],
                         ids=["fifo", "marginalized"])
def test_matches_single_device_trajectory(sequence, mesh8, use_marg):  # noqa: F811
    cfg = _cfg(use_marg)
    rig = _rig()
    local = est.make_estimator_step(cfg)
    dist = make_distributed_estimator_step(cfg, mesh8)
    s_l, s_d = est.init_state(cfg), est.init_state(cfg)
    xs_l, xs_d = [], []
    for l, r in sequence:
        l, r = jnp.asarray(l), jnp.asarray(r)
        s_l, o_l = local(s_l, rig, l, r)
        s_d, o_d = dist(s_d, rig, l, r)
        assert bool(o_d.is_keyframe) == bool(o_l.is_keyframe)
        xs_l.append(float(o_l.T_W_B[0, 3]))
        xs_d.append(float(o_d.T_W_B[0, 3]))
    xs_l, xs_d = np.asarray(xs_l), np.asarray(xs_d)
    # Same trajectory up to solver-ordering noise (dist BA matches local to
    # ~1e-3; per-frame compounding stays within a few mm on this scene).
    np.testing.assert_allclose(xs_d, xs_l, atol=5e-3)
    # And it actually tracks the motion.
    d_gt = STEP_M * (len(xs_l) - 1 - 6)
    assert abs((xs_d[-1] - xs_d[6]) - d_gt) < 0.3 * d_gt


def test_matches_single_device_with_gates(sequence, mesh8):  # noqa: F811
    """Round-5 unification: the distributed step consumes the SAME stage
    functions as the fused step, so the capability knobs it previously
    refused (RANSAC consensus gate, scene-flow gate, score weights) must
    now produce an IDENTICAL trajectory to the single-device estimator."""
    base = _cfg(False)
    cfg = base._replace(
        pnp=base.pnp._replace(ransac_hypotheses=16, ransac_min_inliers=8),
        dynamic_flow_thresh=0.05,
        use_obs_weights=True)
    rig = _rig()
    local = est.make_estimator_step(cfg)
    dist = make_distributed_estimator_step(cfg, mesh8)
    s_l, s_d = est.init_state(cfg), est.init_state(cfg)
    # Gate memory must be allocated for both paths.
    assert s_l.lm_birth is not None and s_l.tri_prev is not None
    xs_l, xs_d = [], []
    for l, r in sequence[:14]:
        l, r = jnp.asarray(l), jnp.asarray(r)
        s_l, o_l = local(s_l, rig, l, r)
        s_d, o_d = dist(s_d, rig, l, r)
        assert bool(o_d.is_keyframe) == bool(o_l.is_keyframe)
        assert int(o_d.n_ransac_inliers) == int(o_l.n_ransac_inliers)
        xs_l.append(float(o_l.T_W_B[0, 3]))
        xs_d.append(float(o_d.T_W_B[0, 3]))
    np.testing.assert_allclose(np.asarray(xs_d), np.asarray(xs_l), atol=5e-3)


def test_capacity_must_divide_mesh(mesh8):
    cfg = _cfg(False)
    bad = cfg._replace(frontend=cfg.frontend._replace(capacity=100))
    with pytest.raises(ValueError):
        make_distributed_estimator_step(bad, mesh8)


@pytest.mark.parametrize("use_marg", [False, True],
                         ids=["fifo", "marginalized"])
def test_vio_matches_single_device(sequence, mesh8, use_marg):  # noqa: F811
    """Distributed VIO estimator (15-dim states + IMU factors, landmark-
    sharded window solve) reproduces the fused single-device VIO step."""
    from rsvio_tpu.models import estimator_vio as ev
    from rsvio_tpu.models import imu as imu_mod
    from rsvio_tpu.parallel.dist_estimator import (
        make_distributed_vio_estimator_step)

    cfg = ev.VIOEstimatorConfig(base=_cfg(use_marg))
    rig = _rig()
    local = ev.make_vio_estimator_step(cfg)
    dist = make_distributed_vio_estimator_step(cfg, mesh8)
    s_l = ev.init_vio_state(cfg)
    s_d = ev.init_vio_state(cfg)

    S = 10
    gyro = jnp.zeros((S, 3))
    accel = jnp.zeros((S, 3)).at[:, 2].set(imu_mod.GRAVITY)
    dts = jnp.full((S,), 0.005)
    msk = jnp.ones((S,), dtype=bool)

    xs_l, xs_d = [], []
    for l, r in sequence[:10]:
        l, r = jnp.asarray(l), jnp.asarray(r)
        s_l, o_l = local(s_l, rig, l, r, gyro, accel, dts, msk)
        s_d, o_d = dist(s_d, rig, l, r, gyro, accel, dts, msk)
        assert bool(o_d.is_keyframe) == bool(o_l.is_keyframe)
        xs_l.append(float(o_l.T_W_B[0, 3]))
        xs_d.append(float(o_d.T_W_B[0, 3]))
    np.testing.assert_allclose(np.asarray(xs_d), np.asarray(xs_l), atol=1e-2)
    np.testing.assert_allclose(np.asarray(s_d.vel), np.asarray(s_l.vel),
                               atol=1e-2)


def test_vio_matches_single_device_with_gates(sequence, mesh8):  # noqa: F811
    """Distributed VIO with the RANSAC gate + scene-flow gate + score
    weights enabled (previously refused) matches the fused VIO step —
    the stages are shared, so this pins the structural parity."""
    from rsvio_tpu.models import estimator_vio as ev
    from rsvio_tpu.models import imu as imu_mod
    from rsvio_tpu.parallel.dist_estimator import (
        make_distributed_vio_estimator_step)

    from rsvio_tpu.models import vio_ba as vio_ba_mod
    base = _cfg(False)
    cfg = ev.VIOEstimatorConfig(base=base._replace(
        pnp=base.pnp._replace(ransac_hypotheses=16, ransac_min_inliers=8),
        dynamic_flow_thresh=0.05, dynamic_flow_center=False,
        use_obs_weights=True),
        # Health-gated desert bias stiffness rides the shared kf_pre stage
        # and the solver's bias_alpha arg — parity must hold with it on.
        vio=vio_ba_mod.VIOBAConfig(bias_gyro_weight_desert=1e5,
                                   bias_accel_weight_desert=1e6))
    rig = _rig()
    local = ev.make_vio_estimator_step(cfg)
    dist = make_distributed_vio_estimator_step(cfg, mesh8)
    s_l = ev.init_vio_state(cfg)
    s_d = ev.init_vio_state(cfg)
    assert s_l.lm_birth is not None and s_l.tri_prev is not None
    assert s_l.kf_bias_alpha is not None

    S = 10
    gyro = jnp.zeros((S, 3))
    accel = jnp.zeros((S, 3)).at[:, 2].set(imu_mod.GRAVITY)
    dts = jnp.full((S,), 0.005)
    msk = jnp.ones((S,), dtype=bool)

    xs_l, xs_d = [], []
    for l, r in sequence[:10]:
        l, r = jnp.asarray(l), jnp.asarray(r)
        s_l, o_l = local(s_l, rig, l, r, gyro, accel, dts, msk)
        s_d, o_d = dist(s_d, rig, l, r, gyro, accel, dts, msk)
        assert bool(o_d.is_keyframe) == bool(o_l.is_keyframe)
        xs_l.append(float(o_l.T_W_B[0, 3]))
        xs_d.append(float(o_d.T_W_B[0, 3]))
    np.testing.assert_allclose(np.asarray(xs_d), np.asarray(xs_l), atol=1e-2)
