"""Tests of the adversarial synthetic scene generator: projective geometry
(stereo disparity, z-buffer occlusion), trajectory conventions, photometric
drift, and — critically — that generated IMU is CONSISTENT with the
generated ground-truth poses under models.imu.preintegrate (the forward
model the whole VIO accuracy matrix rests on)."""

import numpy as np
import jax.numpy as jnp
import pytest

from rsvio_tpu.data import synthetic as syn
from rsvio_tpu.models import imu as imu_mod


class TestRenderer:
    def test_level_camera_projects_forward_point_to_center(self):
        T = syn.traj_forward().pose(0.0)
        Xw = np.array([0.0, 5.0, 0.0])   # 5 m ahead in world +y
        Xc = T[:3, :3].T @ (Xw - T[:3, 3])
        np.testing.assert_allclose(Xc, [0.0, 0.0, 5.0], atol=1e-12)

    def test_stereo_disparity_of_frontal_plane(self):
        """For a fronto-parallel plane at depth Z the right image equals the
        left shifted by fx*B/Z pixels."""
        scene = syn.scene_easy_plane(H=120, W=188)
        T = syn.traj_forward().pose(0.0)
        left, right = syn.render_stereo(scene, T)
        disp = scene.fx * scene.baseline / 5.0
        import cv2
        M = np.float32([[1, 0, -disp], [0, 1, 0]])
        shifted = cv2.warpAffine(left, M, (left.shape[1], left.shape[0]),
                                 flags=cv2.INTER_LINEAR)
        inner = (slice(10, -10), slice(20, -20))
        err = np.abs(shifted[inner] - right[inner])
        assert np.median(err) < 1.0, np.median(err)

    def test_zbuffer_is_order_independent(self):
        scene = syn.scene_depth_structured(H=96, W=144)
        T = syn.traj_6dof().pose(0.7)
        img_a = syn.render_camera(scene, T, 0.7)
        import dataclasses
        scene_b = dataclasses.replace(scene,
                                      planes=list(reversed(scene.planes)))
        img_b = syn.render_camera(scene_b, T, 0.7)
        np.testing.assert_allclose(img_a, img_b, atol=1e-4)

    def test_depth_structure_present(self):
        """The near facade must actually occlude the backdrop: rendering
        without it changes the left part of the image."""
        scene = syn.scene_depth_structured(H=96, W=144)
        T = syn.traj_forward().pose(0.0)
        full = syn.render_camera(scene, T)
        import dataclasses
        wo = dataclasses.replace(scene, planes=list(scene.planes[:1]))
        bare = syn.render_camera(wo, T)
        assert np.abs(full - bare).max() > 10.0

    def test_photometric_drift_changes_brightness(self):
        scene = syn.scene_photometric(H=96, W=144)
        T = syn.traj_forward().pose(0.0)
        img0 = syn.render_camera(scene, T, 0.0)
        img1 = syn.render_camera(scene, T, 0.75)  # gain peak
        assert img1.mean() > img0.mean() * 1.1

    def test_occluder_moves(self):
        scene = syn.scene_occlusion(H=96, W=144)
        T = syn.traj_forward().pose(0.0)
        img0 = syn.render_camera(scene, T, 0.0)
        img1 = syn.render_camera(scene, T, 1.0)
        assert np.abs(img0 - img1).max() > 10.0


class TestImuGeneration:
    def test_static_imu_reads_gravity(self):
        traj = syn.Trajectory(pos_fn=lambda t: np.zeros(3),
                              ang_fn=lambda t: np.zeros(3))
        _, gyro, accel, _ = traj.sample_imu(0.0, 0.5)
        assert np.abs(gyro).max() < 1e-6
        g_body = traj.pose(0.0)[:3, :3].T @ (-syn.GRAVITY_W)
        np.testing.assert_allclose(accel.mean(axis=0), g_body, atol=1e-5)

    def test_tilted_static_reads_rotated_gravity(self):
        traj = syn.tilted(syn.traj_forward(speed=0.0), roll_deg=15.0,
                          pitch_deg=-10.0)
        _, _, accel, _ = traj.sample_imu(0.0, 0.3)
        g_body = traj.pose(0.0)[:3, :3].T @ (-syn.GRAVITY_W)
        np.testing.assert_allclose(accel.mean(axis=0), g_body, atol=1e-5)
        assert np.linalg.norm(g_body - [0, 0, 9.81]) > 1.0  # genuinely tilted

    def test_preintegration_matches_ground_truth_poses(self):
        """models.imu.preintegrate over generated samples must reproduce the
        ground-truth relative motion (the standard preintegration identities
        dR = R_i^T R_j etc.) — validates every sign/frame convention in the
        generator against the estimator's."""
        traj = syn.traj_6dof()
        t_i, t_j = 0.4, 0.9
        ts, gyro, accel, dts = traj.sample_imu(t_i, t_j, rate=200.0)
        mask = jnp.ones(len(ts), dtype=bool)
        pre = imu_mod.preintegrate(
            jnp.asarray(gyro, jnp.float32), jnp.asarray(accel, jnp.float32),
            jnp.asarray(dts, jnp.float32), mask,
            jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32))

        h = 1e-4
        Ti, Tj = traj.pose(t_i), traj.pose(t_j)
        Ri, Rj = Ti[:3, :3], Tj[:3, :3]
        pi, pj = Ti[:3, 3], Tj[:3, 3]
        vi = (traj.pos_fn(t_i + h) - traj.pos_fn(t_i - h)) / (2 * h)
        vj = (traj.pos_fn(t_j + h) - traj.pos_fn(t_j - h)) / (2 * h)
        dt = t_j - t_i
        g = syn.GRAVITY_W

        dR_gt = Ri.T @ Rj
        dv_gt = Ri.T @ (vj - vi - g * dt)
        dp_gt = Ri.T @ (pj - pi - vi * dt - 0.5 * g * dt * dt)

        dR_err = np.rad2deg(np.arccos(np.clip(
            (np.trace(np.asarray(pre.dR).T @ dR_gt) - 1) / 2, -1, 1)))
        assert dR_err < 0.1, dR_err
        np.testing.assert_allclose(np.asarray(pre.dv), dv_gt, atol=5e-3)
        np.testing.assert_allclose(np.asarray(pre.dp), dp_gt, atol=5e-3)

    def test_bias_and_noise_injection(self):
        traj = syn.traj_forward(speed=0.0)
        rng = np.random.default_rng(0)
        _, gyro, accel, _ = traj.sample_imu(
            0.0, 1.0, gyro_bias=[0.01, -0.02, 0.005],
            accel_bias=[0.1, 0.0, -0.05], noise_rng=rng,
            gyro_noise=1.7e-4, accel_noise=2.0e-3)
        np.testing.assert_allclose(gyro.mean(axis=0), [0.01, -0.02, 0.005],
                                   atol=5e-3)
        g_body = traj.pose(0.0)[:3, :3].T @ (-syn.GRAVITY_W)
        np.testing.assert_allclose(accel.mean(axis=0),
                                   g_body + [0.1, 0.0, -0.05], atol=2e-2)


class TestSequence:
    def test_generate_sequence_shapes(self):
        scene = syn.scene_easy_plane(H=96, W=144)
        seq = syn.generate_sequence(scene, syn.traj_forward(), 5, fps=20.0,
                                    imu_rate=200.0)
        assert len(seq["frames"]) == 5
        assert seq["gt_T_W_B"].shape == (5, 4, 4)
        assert seq["frames"][0][0].shape == (96, 144)
        # 5 frames at 20 Hz starting one interval early: ~50 samples at 200 Hz
        assert 45 <= len(seq["imu_ts"]) <= 55
        assert (seq["imu_dts"] > 0).all()


class TestNumpyImageOps:
    """The scene generator's numpy resize/remap reproduce OpenCV's
    INTER_CUBIC resize and INTER_LINEAR remap (within 1e-4 on 0-255
    images), so the scenes the tests use keep their class without cv2."""

    @pytest.mark.parametrize("src,dst", [((24, 24), (1024, 1024)),
                                         ((40, 50), (160, 96))])
    def test_resize_cubic_matches_cv2(self, src, dst):
        cv2 = pytest.importorskip("cv2")
        img = np.random.default_rng(0).uniform(0, 255, src).astype(np.float32)
        ref = cv2.resize(img, dst, interpolation=cv2.INTER_CUBIC)
        got = syn.resize_cubic(img, *dst)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() < 1e-4

    @pytest.mark.parametrize("border", ["replicate", "reflect"])
    def test_remap_linear_matches_cv2(self, border):
        cv2 = pytest.importorskip("cv2")
        rng = np.random.default_rng(1)
        tex = syn.make_texture(256, seed=2)
        mx = rng.uniform(-20, 275, (60, 80)).astype(np.float32)
        my = rng.uniform(-20, 275, (60, 80)).astype(np.float32)
        mode = {"replicate": cv2.BORDER_REPLICATE,
                "reflect": cv2.BORDER_REFLECT}[border]
        ref = cv2.remap(tex, mx, my, cv2.INTER_LINEAR, borderMode=mode)
        assert np.abs(syn.remap_linear(tex, mx, my, border) - ref).max() < 1e-4
