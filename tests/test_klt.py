"""KLT tracker tests on synthetic images: known translations must be recovered
sub-pixel; bidirectional gate must kill tracks that leave the image or land on
textureless regions (mirrors the runtime self-checks of the reference,
ref src/feature_tracker/feature_tracker.rs:252-291)."""

import jax.numpy as jnp
import numpy as np
import pytest

from rsvio_tpu.ops import klt, pyramid

RNG = np.random.default_rng(3)


def textured_image(H=120, W=160, seed=0):
    """Smooth random texture with enough gradient everywhere."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, size=(H // 4, W // 4)).astype(np.float32)
    import cv2
    img = cv2.resize(base, (W, H), interpolation=cv2.INTER_CUBIC)
    img = cv2.GaussianBlur(img, (5, 5), 1.0)
    return img.astype(np.float32)


def shift_image(img, dx, dy):
    """Subpixel shift via cv2 warpAffine (linear)."""
    import cv2
    M = np.float32([[1, 0, dx], [0, 1, dy]])
    return cv2.warpAffine(img, M, (img.shape[1], img.shape[0]),
                          flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)


CFG = klt.KLTConfig(max_iterations=20, convergence_threshold=0.005, levels=3)


def make_points(n=16, H=120, W=160):
    pts = RNG.uniform([30, 30], [W - 30, H - 30], size=(n, 2)).astype(np.float32)
    return jnp.asarray(pts)


class TestTrackTranslation:
    def test_recovers_integer_shift(self):
        img0 = textured_image()
        dx, dy = 3.0, -2.0
        img1 = shift_image(img0, dx, dy)
        pyr0 = pyramid.build_pyramid(jnp.asarray(img0), CFG.levels)
        pyr1 = pyramid.build_pyramid(jnp.asarray(img1), CFG.levels)
        pts = make_points()
        alive = jnp.ones(pts.shape[0], dtype=bool)
        pos, _, ok = klt.track_points_bidirectional(pyr0, pyr1, pts, alive, CFG)
        ok = np.asarray(ok)
        assert ok.sum() >= pts.shape[0] * 0.75, f"only {ok.sum()} tracks survived"
        flow = np.asarray(pos) - np.asarray(pts)
        err = np.abs(flow[ok] - np.array([dx, dy]))
        assert np.median(err) < 0.25, f"median err {np.median(err)}"

    def test_recovers_subpixel_shift(self):
        img0 = textured_image(seed=1)
        dx, dy = 1.3, 0.7
        img1 = shift_image(img0, dx, dy)
        pyr0 = pyramid.build_pyramid(jnp.asarray(img0), CFG.levels)
        pyr1 = pyramid.build_pyramid(jnp.asarray(img1), CFG.levels)
        pts = make_points()
        alive = jnp.ones(pts.shape[0], dtype=bool)
        pos, _, ok = klt.track_points_bidirectional(pyr0, pyr1, pts, alive, CFG)
        ok = np.asarray(ok)
        assert ok.sum() >= pts.shape[0] * 0.75
        flow = np.asarray(pos) - np.asarray(pts)
        err = np.abs(flow[ok] - np.array([dx, dy]))
        assert np.median(err) < 0.3

    def test_brightness_invariance(self):
        # Mean-normalized patches should tolerate a global gain change.
        img0 = textured_image(seed=2)
        img1 = shift_image(img0, 2.0, 1.0) * 1.3
        pyr0 = pyramid.build_pyramid(jnp.asarray(img0), CFG.levels)
        pyr1 = pyramid.build_pyramid(jnp.asarray(img1), CFG.levels)
        pts = make_points()
        alive = jnp.ones(pts.shape[0], dtype=bool)
        pos, _, ok = klt.track_points_bidirectional(pyr0, pyr1, pts, alive, CFG)
        ok = np.asarray(ok)
        assert ok.sum() >= pts.shape[0] * 0.6
        flow = np.asarray(pos) - np.asarray(pts)
        err = np.abs(flow[ok] - np.array([2.0, 1.0]))
        assert np.median(err) < 0.3


class TestFailureModes:
    def test_textureless_region_dies(self):
        img0 = np.full((120, 160), 100.0, dtype=np.float32)
        img1 = img0.copy()
        pyr0 = pyramid.build_pyramid(jnp.asarray(img0), CFG.levels)
        pyr1 = pyramid.build_pyramid(jnp.asarray(img1), CFG.levels)
        pts = make_points(8)
        alive = jnp.ones(8, dtype=bool)
        _, _, ok = klt.track_points_bidirectional(pyr0, pyr1, pts, alive, CFG)
        # Flat image -> degenerate Hessian -> all tracks should die or at
        # minimum not diverge (positions finite).
        assert np.asarray(ok).sum() <= 2

    def test_dead_slots_stay_dead(self):
        img0 = textured_image(seed=4)
        pyr0 = pyramid.build_pyramid(jnp.asarray(img0), CFG.levels)
        pts = make_points(8)
        alive = jnp.zeros(8, dtype=bool)
        _, _, ok = klt.track_points_bidirectional(pyr0, pyr0, pts, alive, CFG)
        assert not np.asarray(ok).any()

    def test_identity_track_is_fixed_point(self):
        img0 = textured_image(seed=5)
        pyr0 = pyramid.build_pyramid(jnp.asarray(img0), CFG.levels)
        pts = make_points(16)
        alive = jnp.ones(16, dtype=bool)
        pos, _, ok = klt.track_points_bidirectional(pyr0, pyr0, pts, alive, CFG)
        ok = np.asarray(ok)
        assert ok.sum() >= 12
        drift = np.abs(np.asarray(pos)[ok] - np.asarray(pts)[ok])
        assert drift.max() < 0.1


def test_build_patch_flat_invalid():
    img = jnp.full((64, 64), 50.0)
    p = klt.build_patch(img, jnp.asarray([32.0, 32.0]))
    # A flat patch has zero gradients -> near-singular H; data should still be
    # finite and ok=False is acceptable (mean is fine but H is singular).
    assert bool(jnp.all(jnp.isfinite(p.data)))


def test_pattern_layout():
    assert klt.PATTERN.shape == (64, 2)
    assert float(jnp.max(jnp.abs(klt.PATTERN))) == 7.0
    # zero-mean symmetric pattern
    assert float(jnp.abs(jnp.sum(klt.PATTERN))) < 1e-5


class TestResidualModes:
    """SSD vs LSSD residual options + fixed-lambda LM damping (parity with
    the reference experimental crate's Patch residual variants and its
    precomputed (lambda I + J^T J)^-1 LM step, ref
    feature_tracker/src/patch.rs:57-105,239-255)."""

    def _track(self, img0, img1, cfg):
        pyr0 = pyramid.build_pyramid(jnp.asarray(img0), cfg.levels)
        pyr1 = pyramid.build_pyramid(jnp.asarray(img1), cfg.levels)
        pts = make_points()
        alive = jnp.ones(pts.shape[0], dtype=bool)
        pos, _, ok = klt.track_points_bidirectional(pyr0, pyr1, pts, alive, cfg)
        return np.asarray(pos), np.asarray(ok), np.asarray(pts)

    def test_ssd_recovers_shift(self):
        img0 = textured_image(seed=5)
        dx, dy = 2.0, -1.5
        img1 = shift_image(img0, dx, dy)
        cfg = CFG._replace(residual_mode="ssd")
        pos, ok, pts = self._track(img0, img1, cfg)
        assert ok.sum() >= pts.shape[0] * 0.75
        err = np.abs((pos - pts)[ok] - np.array([dx, dy]))
        assert np.median(err) < 0.25

    def test_lm_damped_recovers_shift(self):
        img0 = textured_image(seed=6)
        dx, dy = -2.5, 1.0
        img1 = shift_image(img0, dx, dy)
        cfg = CFG._replace(lm_lambda=1.0)
        pos, ok, pts = self._track(img0, img1, cfg)
        assert ok.sum() >= pts.shape[0] * 0.75
        err = np.abs((pos - pts)[ok] - np.array([dx, dy]))
        assert np.median(err) < 0.25

    def test_lssd_is_gain_invariant_ssd_is_not(self):
        """A global gain change: the mean-normalized residual tracks through
        it; plain SSD sees a large residual everywhere (documented behavioral
        difference between the two modes)."""
        img0 = textured_image(seed=7)
        dx, dy = 1.5, -1.0
        img1 = np.clip(shift_image(img0, dx, dy) * 1.6, 0, 255)
        pos_l, ok_l, pts = self._track(
            img0, img1, CFG._replace(residual_mode="lssd"))
        err_l = np.abs((pos_l - pts)[ok_l] - np.array([dx, dy]))
        assert ok_l.sum() >= pts.shape[0] * 0.6
        assert np.median(err_l) < 0.3
        # SSD under a 1.6x gain: tracking quality must degrade measurably
        # (fewer survivors or worse flow) relative to LSSD.
        pos_s, ok_s, _ = self._track(
            img0, img1, CFG._replace(residual_mode="ssd"))
        flow_err_s = np.abs((pos_s - pts)[ok_s] - np.array([dx, dy]))
        degraded = (ok_s.sum() < ok_l.sum()) or (
            ok_s.sum() == 0) or (np.median(flow_err_s) > np.median(err_l))
        assert degraded


class TestRatioPyramid:
    def test_arbitrary_ratio_recovers_shift(self):
        """Tracking over a non-power-of-two pyramid (experimental-crate
        capability: arbitrary-ratio pyramids with per-level position scaling,
        ref feature_tracker/src/image_operations.rs:47-78 +
        feature_tracking.rs:88-122)."""
        img0 = textured_image(seed=9)
        dx, dy = 4.0, -3.0
        img1 = shift_image(img0, dx, dy)
        ratio = 1.0 / 1.6
        cfg = CFG._replace(levels=4, pyramid_ratio=ratio)
        pyr0 = pyramid.build_pyramid_ratio(jnp.asarray(img0), 4, ratio,
                                           blur=True)
        pyr1 = pyramid.build_pyramid_ratio(jnp.asarray(img1), 4, ratio,
                                           blur=True)
        pts = make_points()
        alive = jnp.ones(pts.shape[0], dtype=bool)
        pos, _, ok = klt.track_points_bidirectional(pyr0, pyr1, pts, alive,
                                                    cfg)
        ok = np.asarray(ok)
        assert ok.sum() >= pts.shape[0] * 0.7, f"only {ok.sum()} survived"
        err = np.abs((np.asarray(pos) - np.asarray(pts))[ok]
                     - np.array([dx, dy]))
        assert np.median(err) < 0.3, f"median err {np.median(err)}"


class TestStereoBatchedTemporal:
    def test_matches_two_separate_calls(self):
        """track_points_bidirectional_stereo must agree with two independent
        track_points_bidirectional runs."""
        img0 = textured_image(seed=12)
        img1 = textured_image(seed=13)
        dst0 = shift_image(img0, 2.0, -1.5)
        dst1 = shift_image(img1, -1.0, 0.5)
        p0 = pyramid.build_pyramid(jnp.asarray(img0), 3)
        p1 = pyramid.build_pyramid(jnp.asarray(img1), 3)
        d0 = pyramid.build_pyramid(jnp.asarray(dst0), 3)
        d1 = pyramid.build_pyramid(jnp.asarray(dst1), 3)
        pts0 = make_points(12)
        pts1 = make_points(12)
        alive = jnp.ones(12, dtype=bool)
        a0, _, k0 = klt.track_points_bidirectional(p0, d0, pts0, alive, CFG)
        a1, _, k1 = klt.track_points_bidirectional(p1, d1, pts1, alive, CFG)
        b0, _, s0, b1, _, s1 = klt.track_points_bidirectional_stereo(
            p0, p1, d0, d1, pts0, pts1, alive, CFG)
        assert np.asarray(k0).sum() >= 9 and np.asarray(k1).sum() >= 9
        np.testing.assert_array_equal(np.asarray(s0), np.asarray(k0))
        np.testing.assert_array_equal(np.asarray(s1), np.asarray(k1))
        np.testing.assert_allclose(np.asarray(b0), np.asarray(a0), atol=1e-5)
        np.testing.assert_allclose(np.asarray(b1), np.asarray(a1), atol=1e-5)


def rotate_image(img, deg, center):
    """Rotate the image CONTENT by +deg (ccw in image coords, cv2 convention)
    about `center`; returns the image and the point map src -> dst."""
    import cv2
    M = cv2.getRotationMatrix2D(center, deg, 1.0)
    out = cv2.warpAffine(img, M, (img.shape[1], img.shape[0]),
                         flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)
    return out, lambda p: p @ M[:, :2].T + M[:, 2]


def angle_of(A):
    return np.arctan2(np.asarray(A)[:, 1, 0], np.asarray(A)[:, 0, 0])


class TestTrackerBehaviour:
    """Behaviour cases of the one tracker: bounds, batch sizes that are no
    multiple of any block, the SE2 warp, and the residual/damping stack."""

    def test_out_of_image_rejected(self):
        img = textured_image(H=96, W=144, seed=3)
        pyr = pyramid.build_pyramid(jnp.asarray(img), CFG.levels)
        pts = jnp.asarray([[1.0, 50.0], [143.5, 50.0], [50.0, 0.5]],
                          jnp.float32)
        _, _, ok = klt.track_points_bidirectional(
            pyr, pyr, pts, jnp.ones(3, bool), CFG)
        assert not np.asarray(ok).any()

    @pytest.mark.parametrize("n", [1, 63, 65, 257])
    def test_feature_count_needs_no_padding(self, n):
        """Any table size tracks: shapes follow N and every slot keeps its
        own result (identity track is a fixed point)."""
        img = textured_image(seed=6)
        pyr = pyramid.build_pyramid(jnp.asarray(img), CFG.levels)
        pts = np.random.default_rng(n).uniform(
            [15, 15], [145, 105], size=(n, 2)).astype(np.float32)
        pos, A, ok = klt.track_points_bidirectional(
            pyr, pyr, jnp.asarray(pts), jnp.ones(n, bool), CFG)
        assert pos.shape == (n, 2) and A.shape == (n, 2, 2)
        assert ok.shape == (n,)
        okn = np.asarray(ok)
        assert okn.sum() >= max(1, int(0.8 * n))
        np.testing.assert_allclose(np.asarray(pos)[okn], pts[okn], atol=1e-2)

    def test_rotation_identity_keeps_A_identity(self):
        img = textured_image(seed=3)
        pyr = pyramid.build_pyramid(jnp.asarray(img), CFG.levels)
        pts = make_points(8)
        pos, A, ok = klt.track_points_bidirectional(
            pyr, pyr, pts, jnp.ones(8, bool),
            CFG._replace(track_rotation=True))
        ok = np.asarray(ok)
        assert ok.sum() >= 7
        np.testing.assert_allclose(np.asarray(A)[ok],
                                   np.broadcast_to(np.eye(2), (ok.sum(), 2, 2)),
                                   atol=5e-3)
        assert np.abs(np.asarray(pos)[ok] - np.asarray(pts)[ok]).max() < 1e-2

    @pytest.mark.parametrize("deg", [8.0, 14.0])
    def test_recovers_known_rotation(self, deg):
        """Image content rotated by +deg about its centre: each feature lands
        on its rotated position and the warp angle reads -deg (the warp maps
        template to target in y-down image coordinates)."""
        img = textured_image(H=160, W=224, seed=7)
        img2, to_dst = rotate_image(img, deg, (112.0, 80.0))
        pts = np.random.default_rng(int(deg)).uniform(
            [70, 45], [155, 115], size=(16, 2)).astype(np.float32)
        cfg = CFG._replace(track_rotation=True, max_iterations=40)
        pyr0 = pyramid.build_pyramid(jnp.asarray(img), cfg.levels)
        pyr1 = pyramid.build_pyramid(jnp.asarray(img2), cfg.levels)
        pos, A, ok = klt.track_points_bidirectional(
            pyr0, pyr1, jnp.asarray(pts), jnp.ones(16, bool), cfg)
        ok = np.asarray(ok)
        assert ok.sum() >= 10, ok.sum()
        perr = np.linalg.norm(np.asarray(pos)[ok] - to_dst(pts)[ok], axis=1)
        assert np.median(perr) < 0.35, perr
        th = angle_of(A)[ok]
        assert np.abs(np.median(th) + np.deg2rad(deg)) < np.deg2rad(1.5), (
            np.rad2deg(th))

    def test_ssd_rotation_lm_combined(self):
        """The full variant stack at once (ssd + damping + SE2 rotation)."""
        img0 = textured_image(seed=23)
        img1 = shift_image(img0, 1.0, 1.0)
        cfg = CFG._replace(residual_mode="ssd", lm_lambda=0.5,
                           track_rotation=True)
        pyr0 = pyramid.build_pyramid(jnp.asarray(img0), cfg.levels)
        pyr1 = pyramid.build_pyramid(jnp.asarray(img1), cfg.levels)
        pts = make_points(16)
        pos, _, ok = klt.track_points_bidirectional(
            pyr0, pyr1, pts, jnp.ones(16, bool), cfg)
        ok = np.asarray(ok)
        assert ok.sum() >= 10, ok.sum()
        err = np.abs((np.asarray(pos) - np.asarray(pts))[ok] - [1.0, 1.0])
        assert np.median(err) < 0.35, np.median(err)


class TestBicubicInterpolation:
    """Bicubic-sampled tracking (ref experimental crate tracks WITH bicubic:
    feature_tracker/src/feature_tracker/feature_tracking.rs:129-192 via
    d_interpolate_bicubic, image_operations.rs:140-229)."""

    def test_bicubic_recovers_subpixel_shift(self):
        img0 = textured_image(seed=7)
        dx, dy = 1.6, -0.9
        img1 = shift_image(img0, dx, dy)
        cfg = CFG._replace(interpolation="bicubic")
        pyr0 = pyramid.build_pyramid(jnp.asarray(img0), cfg.levels)
        pyr1 = pyramid.build_pyramid(jnp.asarray(img1), cfg.levels)
        pts = make_points()
        alive = jnp.ones(pts.shape[0], dtype=bool)
        pos, _, ok = klt.track_points_bidirectional(pyr0, pyr1, pts, alive,
                                                    cfg)
        ok = np.asarray(ok)
        assert ok.sum() >= pts.shape[0] * 0.75, f"only {ok.sum()} survived"
        flow = np.asarray(pos) - np.asarray(pts)
        err = np.abs(flow[ok] - np.array([dx, dy]))
        assert np.median(err) < 0.3, f"median err {np.median(err)}"

    def test_bicubic_close_to_bilinear_on_same_scene(self):
        # Same scene through both samplers: results agree to a fraction of a
        # pixel on converged tracks (they solve the same alignment).
        img0 = textured_image(seed=8)
        img1 = shift_image(img0, 0.8, 1.1)
        pts = make_points()
        alive = jnp.ones(pts.shape[0], dtype=bool)
        out = {}
        for mode in ("bilinear", "bicubic"):
            cfg = CFG._replace(interpolation=mode)
            pyr0 = pyramid.build_pyramid(jnp.asarray(img0), cfg.levels)
            pyr1 = pyramid.build_pyramid(jnp.asarray(img1), cfg.levels)
            pos, _, ok = klt.track_points_bidirectional(
                pyr0, pyr1, pts, alive, cfg)
            out[mode] = (np.asarray(pos), np.asarray(ok))
        both = out["bilinear"][1] & out["bicubic"][1]
        assert both.sum() >= pts.shape[0] * 0.6
        d = np.abs(out["bilinear"][0][both] - out["bicubic"][0][both])
        assert d.max() < 0.5, f"max sampler disagreement {d.max()}"


class TestCoarseLevelPolicy:
    """Round-4 border-tolerant coarse-to-fine (KLTConfig.coarse_level_policy):
    a feature near the image border is unusable at coarse pyramid levels
    (its coordinates shrink below the patch footprint) — strict mode kills
    the whole track (reference parity, ref feature_tracker.rs:305-331);
    tolerant mode skips the failed coarse levels and tracks it at the fine
    levels, with the bidirectional gate still arbitrating."""

    def _border_setup(self):
        img0 = textured_image(seed=4)
        img1 = shift_image(img0, 2.0, 1.0)
        pyr0 = pyramid.build_pyramid(jnp.asarray(img0), 5)
        pyr1 = pyramid.build_pyramid(jnp.asarray(img1), 5)
        # x ~ 14 px: level 4 coordinate 0.9 px -> patch out of bounds there.
        pts = jnp.asarray([[14.0, 60.0], [15.0, 40.0], [80.0, 60.0]],
                          jnp.float32)
        alive = jnp.ones(3, bool)
        return pyr0, pyr1, pts, alive

    def test_border_feature_tracks_in_tolerant_mode(self):
        pyr0, pyr1, pts, alive = self._border_setup()
        strict = CFG._replace(levels=5, coarse_level_policy="strict")
        tol = strict._replace(coarse_level_policy="tolerant")
        _, _, ok_s = klt.track_points_bidirectional(pyr0, pyr1, pts, alive,
                                                    strict)
        pos_t, _, ok_t = klt.track_points_bidirectional(pyr0, pyr1, pts,
                                                        alive, tol)
        # Strict kills the border features; tolerant tracks them accurately.
        assert not bool(ok_s[0]) and not bool(ok_s[1])
        assert bool(ok_t[0]) and bool(ok_t[1])
        err = np.abs(np.asarray(pos_t[:2]) - (np.asarray(pts[:2])
                                              + np.array([2.0, 1.0])))
        assert err.max() < 0.35, err
        # The interior feature behaves identically in both modes.
        assert bool(ok_s[2]) and bool(ok_t[2])

    def test_interior_features_unchanged(self):
        """Tolerant mode must be a no-op for interior features (all levels
        in bounds -> identical mask and positions)."""
        img0 = textured_image(seed=5)
        img1 = shift_image(img0, 1.5, -0.5)
        pyr0 = pyramid.build_pyramid(jnp.asarray(img0), CFG.levels)
        pyr1 = pyramid.build_pyramid(jnp.asarray(img1), CFG.levels)
        pts = make_points()
        alive = jnp.ones(pts.shape[0], bool)
        strict = CFG._replace(coarse_level_policy="strict")
        tol = CFG._replace(coarse_level_policy="tolerant")
        p_s, _, ok_s = klt.track_points_bidirectional(pyr0, pyr1, pts, alive,
                                                      strict)
        p_t, _, ok_t = klt.track_points_bidirectional(pyr0, pyr1, pts, alive,
                                                      tol)
        interior = np.asarray(ok_s)
        np.testing.assert_array_equal(np.asarray(ok_t)[interior],
                                      interior[interior])
        np.testing.assert_allclose(np.asarray(p_t)[interior],
                                   np.asarray(p_s)[interior], atol=1e-5)
