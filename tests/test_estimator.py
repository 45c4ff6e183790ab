"""VO estimator integration tests on a synthetic rendered sequence,
including the marginalization-enabled mode."""

import jax.numpy as jnp
import numpy as np
import pytest

from rsvio_tpu.models import estimator as est
from rsvio_tpu.models.frontend import FrontendConfig
from rsvio_tpu.ops import cameras
from rsvio_tpu.ops.klt import KLTConfig

H, W = 120, 160
FX = FY = 120.0
CX, CY = W / 2, H / 2
BASELINE = 0.11
PLANE_Z = 4.0
STEP_M = 0.02


@pytest.fixture(scope="module")
def sequence():
    import cv2
    rng = np.random.default_rng(1)
    tex = sum(w * cv2.resize(rng.uniform(0, 1, (n, n)).astype(np.float32),
                             (1024, 1024), interpolation=cv2.INTER_CUBIC)
              for w, n in [(120.0, 48), (60.0, 192)]) + 40.0

    def render(cam_t):
        u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                           np.arange(H, dtype=np.float32))
        mx = (((u - CX) / FX * PLANE_Z + cam_t[0]) * 90.0 + 350.0).astype(np.float32)
        my = (((v - CY) / FY * PLANE_Z + cam_t[1]) * 90.0 + 350.0).astype(np.float32)
        return cv2.remap(tex, mx, my, cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REFLECT)

    return [(render(np.array([STEP_M * k, 0, 0])),
             render(np.array([STEP_M * k + BASELINE, 0, 0])))
            for k in range(14)]


def run_sequence(sequence, use_marg: bool, cull: float = 0.0,
                 ransac: bool = False):
    from rsvio_tpu.models.pnp import PnPConfig
    params = cameras.pack_params(cameras.PINHOLE_RADTAN,
                                 [FX, FY, CX, CY], [0, 0, 0, 0])
    rig = est.make_rig(params, params,
                       jnp.eye(4, dtype=jnp.float32),
                       jnp.eye(4, dtype=jnp.float32).at[0, 3].set(BASELINE))
    cfg = est.EstimatorConfig(
        frontend=FrontendConfig(capacity=96, cell_size=28, detect_margin=10,
                                min_score=5.0,
                                klt=KLTConfig(levels=3, max_iterations=12)),
        window_size=4,
        translation_threshold=0.012,
        rotation_threshold=0.05,
        image_shape=(H, W),
        use_marginalization=use_marg,
        cull_reproj_threshold=cull,
        pnp=(PnPConfig(ransac_hypotheses=16, ransac_min_inliers=10)
             if ransac else PnPConfig()))
    step = est.make_estimator_step(cfg)
    state = est.init_state(cfg)
    xs, kf_flags = [], []
    for l, r in sequence:
        state, out = step(state, rig, jnp.asarray(l), jnp.asarray(r))
        xs.append(float(out.T_W_B[0, 3]))
        kf_flags.append(bool(out.is_keyframe))
    return np.asarray(xs), kf_flags, state


class TestEstimatorVO:
    def test_vo_tracks_motion(self, sequence):
        xs, kfs, state = run_sequence(sequence, use_marg=False)
        half = len(xs) // 2
        d_est = xs[-1] - xs[half]
        d_gt = STEP_M * (len(xs) - 1 - half)
        assert abs(d_est - d_gt) < 0.3 * d_gt, f"{xs}"
        assert any(kfs[5:])  # keyframes keep coming after the window fills

    def test_marginalization_mode_tracks_motion(self, sequence):
        xs, kfs, state = run_sequence(sequence, use_marg=True)
        assert np.all(np.isfinite(xs))
        half = len(xs) // 2
        d_est = xs[-1] - xs[half]
        d_gt = STEP_M * (len(xs) - 1 - half)
        assert abs(d_est - d_gt) < 0.3 * d_gt, f"{xs}"
        # the prior must be live once evictions started
        assert bool(state.marg_prior.valid)


    def test_ransac_mode_tracks_motion(self, sequence):
        """With the PnP RANSAC consensus gate on, a clean static scene must
        track exactly like the plain pipeline (near-full consensus, no
        spurious kills starving the window)."""
        xs, kfs, state = run_sequence(sequence, use_marg=False, ransac=True)
        assert np.all(np.isfinite(xs))
        half = len(xs) // 2
        d_est = xs[-1] - xs[half]
        d_gt = STEP_M * (len(xs) - 1 - half)
        assert abs(d_est - d_gt) < 0.3 * d_gt, f"{xs}"
        # table must not be starved by false kills (the plain pipeline
        # holds ~30 alive on this low-capacity scene)
        assert int(jnp.sum(state.table.alive)) > 20

    def test_culling_mode_tracks_motion(self, sequence):
        """With post-BA landmark culling enabled the pipeline must still
        track (the synthetic scene is clean, so culling should fire rarely
        and never break the solve)."""
        xs, kfs, state = run_sequence(sequence, use_marg=False, cull=0.02)
        half = len(xs) // 2
        d_est = xs[-1] - xs[half]
        d_gt = STEP_M * (len(xs) - 1 - half)
        assert abs(d_est - d_gt) < 0.3 * d_gt, f"{xs}"


class TestReprojectionOutliers:
    def test_flags_corrupt_landmark_only(self):
        rng = np.random.default_rng(0)
        Wk, N = 3, 12
        lm = np.stack([rng.uniform(-1, 1, N), rng.uniform(-1, 1, N),
                       rng.uniform(3, 6, N)], 1).astype(np.float32)
        T_C_B = jnp.stack([jnp.eye(4, dtype=jnp.float32),
                           jnp.eye(4, dtype=jnp.float32).at[0, 3].set(-0.1)])
        kf_T = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (Wk, 4, 4))
        obs = np.zeros((Wk, 2, N, 2), np.float32)
        for c in range(2):
            pC = lm + np.asarray(T_C_B[c][:3, 3])
            obs[:, c] = pC[:, :2] / pC[:, 2:3]
        mask = jnp.ones((Wk, 2, N), dtype=bool)
        lm_valid = jnp.ones(N, dtype=bool)
        # Corrupt landmark 4: move it so its reprojection is way off.
        lm_bad = lm.copy()
        lm_bad[4] += np.array([1.0, 0.0, 0.0], np.float32)
        bad = est.reprojection_outliers(
            T_C_B, kf_T, jnp.asarray(lm_bad), jnp.asarray(obs), mask,
            lm_valid, 0.01 ** 2)
        bad = np.asarray(bad)
        assert bad[4]
        assert not bad[np.arange(N) != 4].any()

    def test_behind_camera_always_flagged(self):
        Wk, N = 2, 3
        lm = jnp.asarray([[0, 0, 5.0], [0, 0, -2.0], [0.5, 0, 4.0]],
                         dtype=jnp.float32)
        T_C_B = jnp.stack([jnp.eye(4, dtype=jnp.float32)] * 2)
        kf_T = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (Wk, 4, 4))
        obs = jnp.stack([lm[:, :2] / lm[:, 2:3]] * 2)[None].repeat(Wk, 0)
        mask = jnp.ones((Wk, 2, N), dtype=bool)
        bad = est.reprojection_outliers(
            T_C_B, kf_T, lm, obs, mask, jnp.ones(N, dtype=bool), 1e6)
        assert bool(bad[1]) and not bool(bad[0]) and not bool(bad[2])


class TestSplitStepParity:
    """The stage-split debug step (ref estimator.rs:252-259 [Timing] parity)
    must be numerically identical to the fused production step and report
    all four stage times."""

    def test_split_matches_fused(self, sequence):
        params = cameras.pack_params(cameras.PINHOLE_RADTAN,
                                     [FX, FY, CX, CY], [0, 0, 0, 0])
        rig = est.make_rig(params, params,
                           jnp.eye(4, dtype=jnp.float32),
                           jnp.eye(4, dtype=jnp.float32).at[0, 3].set(BASELINE))
        cfg = est.EstimatorConfig(
            frontend=FrontendConfig(capacity=96, cell_size=28,
                                    detect_margin=10, min_score=5.0,
                                    klt=KLTConfig(levels=3, max_iterations=12)),
            window_size=4, translation_threshold=0.012,
            rotation_threshold=0.05, image_shape=(H, W))
        fused = est.make_estimator_step(cfg)
        split = est.make_estimator_split_step(cfg)
        s_f, s_s = est.init_state(cfg), est.init_state(cfg)
        for l, r in sequence[:8]:
            l, r = jnp.asarray(l), jnp.asarray(r)
            s_f, o_f = fused(s_f, rig, l, r)
            s_s, o_s, ms = split(s_s, rig, l, r)
            np.testing.assert_allclose(np.asarray(o_s.T_W_B),
                                       np.asarray(o_f.T_W_B),
                                       rtol=1e-5, atol=1e-5)
            assert set(ms) == set(est.STAGE_NAMES)
            assert all(v >= 0.0 for v in ms.values())
        assert int(o_s.n_tracked) == int(o_f.n_tracked)


def test_refine_births_runs_and_stays_accurate(sequence):
    """refine_births polishes triangulated births with the N-view point
    solver (ref PinholeProjectionFactor, factors.rs:27-133); the pipeline
    must stay functional and as accurate with it enabled."""
    params = cameras.pack_params(cameras.PINHOLE_RADTAN,
                                 [FX, FY, CX, CY], [0, 0, 0, 0])
    rig = est.make_rig(params, params,
                       jnp.eye(4, dtype=jnp.float32),
                       jnp.eye(4, dtype=jnp.float32).at[0, 3].set(BASELINE))
    outs = {}
    for name, refine in (("off", False), ("on", True)):
        cfg = est.EstimatorConfig(
            frontend=FrontendConfig(capacity=96, cell_size=28,
                                    detect_margin=10, min_score=5.0,
                                    klt=KLTConfig(levels=3, max_iterations=12)),
            window_size=4, translation_threshold=0.012,
            rotation_threshold=0.05, image_shape=(H, W),
            refine_births=refine)
        step = est.make_estimator_step(cfg)
        state = est.init_state(cfg)
        xs = []
        for left, right in sequence:
            state, out = step(state, rig, jnp.asarray(left),
                              jnp.asarray(right))
            xs.append(float(out.T_W_B[0, 3]))
        outs[name] = np.asarray(xs)
    gt = STEP_M * np.arange(len(outs["on"]))
    # Accurate vs GT and close to the unrefined pipeline.
    assert np.abs(outs["on"] - gt)[-1] < 0.01, outs["on"][-5:]
    assert np.abs(outs["on"] - outs["off"]).max() < 5e-3, (
        outs["on"][-5:], outs["off"][-5:])


class TestSceneFlowGate:
    """Stereo scene-flow dynamic-object gate (est.scene_flow_gate): a track
    whose instantaneous triangulation flows coherently relative to the
    static world accumulates residual flow and is killed; static tracks
    (noise-level flow) survive."""

    N = 32

    def _setup(self):
        from rsvio_tpu.models.frontend import init_table
        params = cameras.pack_params(cameras.PINHOLE_RADTAN,
                                     [FX, FY, CX, CY], [0, 0, 0, 0])
        rig = est.make_rig(params, params,
                           jnp.eye(4, dtype=jnp.float32),
                           jnp.eye(4, dtype=jnp.float32).at[0, 3].set(0.11))
        rng = np.random.default_rng(3)
        pts = np.stack([rng.uniform(-1, 1, self.N),
                        rng.uniform(-0.6, 0.6, self.N),
                        rng.uniform(2.0, 6.0, self.N)], axis=1).astype(np.float32)
        table = init_table(self.N)
        table = table._replace(alive=jnp.ones(self.N, bool),
                               fid=jnp.arange(self.N, dtype=jnp.int32))
        cfg = est.EstimatorConfig(dynamic_flow_thresh=0.02,
                                  dynamic_flow_decay=0.7,
                                  dynamic_flow_min_n=2)
        return rig, table, jnp.asarray(pts), cfg

    def _run_gate(self, cfg, rig, table, pts, mover, steps=4,
                  flow_per_step=0.03):
        """Simulate `steps` keyframes: movers displace laterally by
        flow_per_step*z (normalized flow = flow_per_step) each step."""
        T_cur = jnp.eye(4, dtype=jnp.float32)
        N = self.N
        tri_prev = pts
        tri_fid = table.fid
        acc = jnp.zeros((N, 2), jnp.float32)
        n = jnp.zeros((N,), jnp.int32)
        killed = np.zeros(N, bool)
        pts_k = np.asarray(pts).copy()
        for k in range(steps):
            # movers displace in world x; static points stay
            pts_k[mover, 0] += flow_per_step * pts_k[mover, 2]
            obs = jnp.asarray(
                np.stack([pts_k[:, :2] / pts_k[:, 2:3],
                          (pts_k[:, :2] - np.array([0.11, 0.0])[None])
                          / pts_k[:, 2:3]]), jnp.float32)
            mask = jnp.ones((2, N), bool)
            kill, tri_mem, n_dyn = est.scene_flow_gate(
                cfg, rig, T_cur, obs, mask, table,
                jnp.asarray(pts_k), jnp.ones(N, bool),
                tri_prev, tri_fid, acc, n)
            tri_prev, tri_fid, acc, n = tri_mem
            killed |= np.asarray(kill)
        return killed

    def test_kills_coherent_mover_not_static(self):
        rig, table, pts, cfg = self._setup()
        mover = np.zeros(self.N, bool)
        mover[:8] = True
        killed = self._run_gate(cfg, rig, table, pts, mover)
        assert killed[:8].all(), killed[:8]
        assert not killed[8:].any(), np.nonzero(killed[8:])

    def test_uncentered_variant(self):
        # dynamic_flow_center=False (the VIO pairing): same separation.
        rig, table, pts, cfg = self._setup()
        cfg = cfg._replace(dynamic_flow_center=False)
        mover = np.zeros(self.N, bool)
        mover[:6] = True
        killed = self._run_gate(cfg, rig, table, pts, mover)
        assert killed[:6].all()
        assert not killed[6:].any()

    def test_noise_does_not_kill(self):
        rig, table, pts, cfg = self._setup()
        rng = np.random.default_rng(11)
        T_cur = jnp.eye(4, dtype=jnp.float32)
        N = self.N
        tri_prev, tri_fid = pts, table.fid
        acc = jnp.zeros((N, 2), jnp.float32)
        n = jnp.zeros((N,), jnp.int32)
        for k in range(6):
            # static world, ~0.5 px observation noise
            noisy = np.asarray(pts) + rng.normal(0, 0.004, (N, 3))
            obs = jnp.asarray(
                np.stack([noisy[:, :2] / noisy[:, 2:3],
                          (noisy[:, :2] - np.array([0.11, 0.0])[None])
                          / noisy[:, 2:3]]), jnp.float32)
            kill, tri_mem, n_dyn = est.scene_flow_gate(
                cfg, rig, T_cur, obs, jnp.ones((2, N), bool), table,
                jnp.asarray(noisy.astype(np.float32)), jnp.ones(N, bool),
                tri_prev, tri_fid, acc, n)
            tri_prev, tri_fid, acc, n = tri_mem
            assert int(n_dyn) == 0, f"step {k}: {int(n_dyn)} false kills"

    def test_estimator_runs_with_flow_gate(self, sequence):
        """Full VO pipeline with the gate on, clean static scene: must
        track like the plain pipeline with no mass kills."""
        from rsvio_tpu.models.pnp import PnPConfig
        params = cameras.pack_params(cameras.PINHOLE_RADTAN,
                                     [FX, FY, CX, CY], [0, 0, 0, 0])
        rig = est.make_rig(params, params,
                           jnp.eye(4, dtype=jnp.float32),
                           jnp.eye(4, dtype=jnp.float32).at[0, 3].set(BASELINE))
        cfg = est.EstimatorConfig(
            frontend=FrontendConfig(capacity=96, cell_size=28,
                                    detect_margin=10, min_score=5.0,
                                    klt=KLTConfig(levels=3, max_iterations=12)),
            window_size=4, translation_threshold=0.012,
            rotation_threshold=0.05, image_shape=(H, W),
            dynamic_flow_thresh=0.02)
        step = est.make_estimator_step(cfg)
        state = est.init_state(cfg)
        xs = []
        for l, r in sequence:
            state, out = step(state, rig, jnp.asarray(l), jnp.asarray(r))
            xs.append(float(out.T_W_B[0, 3]))
        xs = np.asarray(xs)
        assert np.all(np.isfinite(xs))
        half = len(xs) // 2
        d_est = xs[-1] - xs[half]
        d_gt = STEP_M * (len(xs) - 1 - half)
        assert abs(d_est - d_gt) < 0.3 * d_gt, f"{xs}"
        assert int(jnp.sum(state.table.alive)) > 20


class TestAdaptiveKnobValidation:
    """Round-5 adaptive defenses refuse incoherent knob combinations
    (the silently-inert-knob rule)."""

    def _base(self, **kw):
        return est.EstimatorConfig(image_shape=(64, 64))._replace(**kw)

    def test_adaptive_needs_ransac(self):
        import pytest
        from rsvio_tpu.models import pnp as pnp_mod
        with pytest.raises(ValueError, match="ransac"):
            est._build_stages(self._base(
                pnp_prior_adaptive=True,
                pnp=pnp_mod.PnPConfig(motion_prior_weight=10.0)))

    def test_adaptive_prior_needs_base_weight(self):
        import pytest
        from rsvio_tpu.models import pnp as pnp_mod
        with pytest.raises(ValueError, match="motion_prior_weight"):
            est._build_stages(self._base(
                pnp_prior_adaptive=True,
                pnp=pnp_mod.PnPConfig(ransac_hypotheses=8)))

    def test_vision_weight_needs_obs_weights(self):
        import pytest
        from rsvio_tpu.models import pnp as pnp_mod
        with pytest.raises(ValueError, match="use_obs_weights"):
            est._build_stages(self._base(
                vision_weight_adaptive=True,
                pnp=pnp_mod.PnPConfig(ransac_hypotheses=8)))

    def test_vio_stages_validate_too(self):
        import pytest
        from rsvio_tpu.models import estimator_vio as ev
        from rsvio_tpu.models import pnp as pnp_mod
        with pytest.raises(ValueError, match="ransac"):
            ev._build_vio_stages(ev.VIOEstimatorConfig(base=self._base(
                pnp_prior_adaptive=True,
                pnp=pnp_mod.PnPConfig(motion_prior_weight=10.0))))
