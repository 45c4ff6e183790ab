"""Auxiliary subsystem tests: checkpoint/resume, solver observer metrics,
mono tracker, TartanAir player."""

import os

import jax.numpy as jnp
import numpy as np

from rsvio_tpu.models import estimator as est
from rsvio_tpu.models.frontend import FrontendConfig
from rsvio_tpu.ops import cameras, klt, pyramid
from rsvio_tpu.utils import checkpoint, observer


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        cfg = est.EstimatorConfig(
            frontend=FrontendConfig(capacity=16, klt=klt.KLTConfig(levels=2)),
            window_size=3, image_shape=(32, 48))
        state = est.init_state(cfg)
        state = state._replace(
            T_W_B=state.T_W_B.at[0, 3].set(7.5),
            frame_id=jnp.asarray(42, jnp.int32))
        p = str(tmp_path / "ckpt.npz")
        checkpoint.save_state(p, state)
        restored = checkpoint.load_state(p, est.init_state(cfg))
        assert float(restored.T_W_B[0, 3]) == 7.5
        assert int(restored.frame_id) == 42
        for a, b in zip(__import__("jax").tree.leaves(state),
                        __import__("jax").tree.leaves(restored)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_shape_mismatch_rejected(self, tmp_path):
        cfg1 = est.EstimatorConfig(
            frontend=FrontendConfig(capacity=16, klt=klt.KLTConfig(levels=2)),
            window_size=3, image_shape=(32, 48))
        cfg2 = cfg1._replace(window_size=4)
        p = str(tmp_path / "ckpt.npz")
        checkpoint.save_state(p, est.init_state(cfg1))
        try:
            checkpoint.load_state(p, est.init_state(cfg2))
            assert False, "expected ValueError"
        except ValueError:
            pass


class TestObserver:
    def test_metrics_recorded_and_formatted(self):
        from rsvio_tpu.models import pnp
        import sys
        sys.path.insert(0, os.path.dirname(__file__))
        from test_pnp import make_problem
        T_init, T_C_B, p_W, obs, mask, T_gt = make_problem(seed=3)
        res = pnp.solve_pnp(T_init, T_C_B, p_W, obs, mask)
        m = np.asarray(res.metrics)
        n = int(res.iterations)
        assert n >= 1
        assert m.shape[1] == 6            # full observer.rs:40-68 columns
        assert (m[:n, 0] > 0).all()       # costs recorded
        assert (m[:n, 1] > 0).all()       # gradient norms recorded
        assert (m[:n, 2] > 0).all()       # lambdas recorded
        assert m[:n, 5].max() == 1.0      # at least one accepted step
        # Accepted steps carry a positive trust-region gain ratio.
        acc = m[:n, 5] > 0
        assert (m[:n, 4][acc] > 0).all()
        text = observer.format_metrics(res.metrics, res.iterations)
        assert "iter" in text and "yes" in text
        assert "grad_norm" in text and "step_quality" in text
        assert len(text.splitlines()) == n + 1


class TestMonoTracker:
    def test_track_and_birth(self):
        import cv2
        from rsvio_tpu.models import mono_tracker as mt
        rng = np.random.default_rng(0)
        base = rng.uniform(0, 255, (30, 40)).astype(np.float32)
        img0 = cv2.GaussianBlur(
            cv2.resize(base, (160, 120), interpolation=cv2.INTER_CUBIC),
            (5, 5), 1.0)
        M = np.float32([[1, 0, 2.0], [0, 1, 1.0]])
        img1 = cv2.warpAffine(img0, M, (160, 120), flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_REFLECT)
        cfg = mt.MonoTrackerConfig(
            capacity=64, cell_size=24, detect_margin=10,
            klt=klt.KLTConfig(levels=3))
        p0 = pyramid.build_pyramid(jnp.asarray(img0), 3)
        p1 = pyramid.build_pyramid(jnp.asarray(img1), 3)
        table = mt.init_mono_table(64)
        table, s0 = mt.mono_tracker_step(table, p0, p0, cfg, first_frame=True)
        assert int(s0["alive"]) > 8
        pos_before = np.asarray(table.pos).copy()
        alive_before = np.asarray(table.alive).copy()
        table, s1 = mt.mono_tracker_step(table, p0, p1, cfg)
        assert int(s1["tracked"]) > 0.5 * alive_before.sum()
        surv = np.asarray(table.alive) & alive_before
        d = np.asarray(table.pos)[surv] - pos_before[surv]
        assert abs(np.median(d[:, 0]) - 2.0) < 0.4
        assert abs(np.median(d[:, 1]) - 1.0) < 0.4


class TestTartanAirPlayer:
    def test_loads_sequence(self, tmp_path):
        import cv2
        from rsvio_tpu.data.players import TartanAirPlayer
        d = tmp_path / "seq" / "image_left"
        d.mkdir(parents=True)
        for i in range(5):
            cv2.imwrite(str(d / f"{i:06d}_left.png"),
                        np.full((24, 32), i * 10, np.uint8))
        p = TartanAirPlayer(str(tmp_path / "seq"))
        assert len(p) == 5
        f = p.load_frame(2)
        assert f.left.shape == (24, 32)
        assert float(f.left[0, 0]) == 20.0


class TestGnssToTum:
    """4Seasons GNSSPoses.txt -> TUM ground-truth conversion (SURVEY.md §6:
    needed for the ATE metric; neither trajectory export nor evaluation
    exists in the reference)."""

    GNSS = (
        "# frame_ts_ns, tx, ty, tz, qx, qy, qz, qw, scale, flag\n"
        "1000000000,1.0,2.0,3.0,0.0,0.0,0.0,1.0,2.0,1\n"
        "2000000000, 4.0, 5.0, 6.0, 0.0, 0.0, 0.0, 1.0, 2.0, 1\n"
        "3000000000,7.0,8.0,9.0,0.0,0.0,0.0,1.0\n"   # no scale column
        "bad line that should be skipped\n"
    )

    def test_parse_applies_scale(self, tmp_path):
        from rsvio_tpu.utils.trajectory import load_gnss_poses
        src = tmp_path / "GNSSPoses.txt"
        src.write_text(self.GNSS)
        ts, pos, quat = load_gnss_poses(str(src))
        assert list(ts) == [1000000000, 2000000000, 3000000000]
        np.testing.assert_allclose(pos[0], [2.0, 4.0, 6.0])   # scaled x2
        np.testing.assert_allclose(pos[2], [7.0, 8.0, 9.0])   # no scale
        np.testing.assert_allclose(quat[1], [0, 0, 0, 1])

    def test_convert_roundtrips_through_tum_loader(self, tmp_path):
        from rsvio_tpu.utils.trajectory import gnss_to_tum, load_tum
        src = tmp_path / "GNSSPoses.txt"
        src.write_text(self.GNSS)
        dst = tmp_path / "gt.tum"
        n = gnss_to_tum(str(src), str(dst))
        assert n == 3
        ts, pos, quat = load_tum(str(dst))
        np.testing.assert_allclose(ts, [1.0, 2.0, 3.0])
        np.testing.assert_allclose(pos[1], [8.0, 10.0, 12.0])

    def test_cli_tool(self, tmp_path):
        import subprocess, sys
        src = tmp_path / "GNSSPoses.txt"
        src.write_text(self.GNSS)
        dst = tmp_path / "out.tum"
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        res = subprocess.run(
            [sys.executable, os.path.join(repo, "tools", "gnss_to_tum.py"),
             str(src), str(dst)], capture_output=True, text=True)
        assert res.returncode == 0, res.stderr
        assert dst.exists()


class TestEvaluateATETool:
    def test_cli_computes_rmse(self, tmp_path):
        import subprocess, sys
        from rsvio_tpu.utils.trajectory import save_tum
        rng = np.random.default_rng(0)
        n = 40
        ts = (np.arange(n) * 5e7 + 1e18).astype(np.int64)
        pos = np.cumsum(rng.normal(0, 0.1, (n, 3)), axis=0)
        poses = []
        for p in pos:
            T = np.eye(4)
            T[:3, 3] = p
            poses.append(T)
        gt = tmp_path / "gt.tum"
        est = tmp_path / "est.tum"
        save_tum(str(gt), ts, poses)
        # estimate = GT under a rigid transform + small noise -> tiny ATE
        R = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
        poses_e = []
        for p in pos:
            T = np.eye(4)
            T[:3, 3] = R @ p + [5, -2, 1] + rng.normal(0, 1e-3, 3)
            poses_e.append(T)
        save_tum(str(est), ts, poses_e)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        res = subprocess.run(
            [sys.executable, os.path.join(repo, "tools", "evaluate_ate.py"),
             str(est), str(gt)], capture_output=True, text=True)
        assert res.returncode == 0, res.stderr
        rmse = float([ln for ln in res.stdout.splitlines()
                      if ln.startswith("ate_rmse_m")][0].split()[-1])
        assert rmse < 0.01, res.stdout
