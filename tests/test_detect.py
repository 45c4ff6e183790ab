"""Detection tests: FAST-9 and Shi-Tomasi scores must fire on synthetic
corners and stay silent on flat/edge regions; grid selection must respect
occupancy and borders (ref src/feature_tracker/image_utilities.rs:108-175)."""

import jax.numpy as jnp
import numpy as np

from rsvio_tpu.ops import detect

RNG = np.random.default_rng(11)


def corner_image(H=96, W=96):
    """Dark image with a bright rectangle -> 4 strong corners."""
    img = np.full((H, W), 20.0, dtype=np.float32)
    img[30:60, 40:80] = 220.0
    return jnp.asarray(img)


class TestFastScore:
    def test_fires_on_rectangle_corners(self):
        img = corner_image()
        score = np.asarray(detect.fast_score(img))
        # Strongest responses should be near the 4 rectangle corners.
        top = np.unravel_index(np.argsort(score.ravel())[-8:], score.shape)
        corners = np.array([[30, 40], [30, 79], [59, 40], [59, 79]])
        tops = np.stack(top, axis=1)
        for t in tops:
            d = np.abs(corners - t).sum(axis=1).min()
            assert d <= 4, f"top response {t} not near a corner"

    def test_silent_on_flat(self):
        img = jnp.full((64, 64), 100.0)
        score = np.asarray(detect.fast_score(img))
        assert score.max() <= 0.0

    def test_silent_on_straight_edge(self):
        # A long straight edge has at most ~8 contiguous ring points on one
        # side -> no 9-run -> much weaker than a corner.
        img = np.full((64, 64), 20.0, dtype=np.float32)
        img[:, 32:] = 220.0
        edge = float(np.asarray(detect.fast_score(jnp.asarray(img)))[16:48, 16:48].max())
        corner = float(np.asarray(detect.fast_score(corner_image())).max())
        assert edge < corner * 0.2 or edge <= 0.0


class TestShiTomasi:
    def test_corner_beats_edge_beats_flat(self):
        img = corner_image()
        s = np.asarray(detect.shi_tomasi_score(img))
        corner_s = s[28:33, 38:43].max()
        edge_s = s[43:47, 38:43].max()   # vertical edge midpoint
        flat_s = s[5:15, 5:15].max()
        assert corner_s > 5 * max(edge_s, 1e-6)
        assert flat_s < 1e-3


class TestGridSelect:
    def test_selects_in_empty_cells_only(self):
        img = corner_image()
        score = detect.fast_score(img)
        # Occupy the cell containing corner (40, 30) [x, y]
        occ_xy = jnp.asarray([[40.0, 30.0]])
        occ_mask = jnp.asarray([True])
        cand_xy, cand_ok = detect.select_grid_features(
            score, occ_xy, occ_mask, cell_size=32, margin=8, min_score=10.0)
        cand_xy, cand_ok = np.asarray(cand_xy), np.asarray(cand_ok)
        assert cand_ok.any()
        # no candidate in the occupied cell (cell row 0, col 1 for 32px cells)
        for xy, ok in zip(cand_xy, cand_ok):
            if ok:
                cell = (int(xy[1]) // 32, int(xy[0]) // 32)
                assert cell != (0, 1)

    def test_border_margin(self):
        img = np.zeros((96, 96), dtype=np.float32)
        img[2, 2] = 255.0  # corner-like blip in the border zone
        score = detect.fast_score(jnp.asarray(img))
        cand_xy, cand_ok = detect.select_grid_features(
            score, jnp.zeros((1, 2)), jnp.zeros(1, dtype=bool),
            cell_size=32, margin=19, min_score=10.0)
        cand_xy, cand_ok = np.asarray(cand_xy), np.asarray(cand_ok)
        for xy, ok in zip(cand_xy, cand_ok):
            if ok:
                assert 19 <= xy[0] < 96 - 19 and 19 <= xy[1] < 96 - 19

    def test_flat_image_no_candidates(self):
        img = jnp.full((96, 96), 77.0)
        score = detect.fast_score(img)
        _, cand_ok = detect.select_grid_features(
            score, jnp.zeros((1, 2)), jnp.zeros(1, dtype=bool),
            cell_size=32, margin=8, min_score=10.0)
        assert not np.asarray(cand_ok).any()


class TestNMSSelect:
    """Block NMS + min-dist suppression (ref experimental crate
    feature_detection.rs:172-254 block NMS, :62-69 live-track injection)."""

    @staticmethod
    def _score(H=128, W=128, peaks=((40, 40, 100.0), (40, 46, 80.0),
                                    (90, 100, 60.0))):
        s = np.zeros((H, W), np.float32)
        for y, x, v in peaks:
            s[y, x] = v
        return jnp.asarray(s)

    def test_min_dist_and_score_order(self):
        score = self._score()
        xy, ok = detect.nms_select(
            score, jnp.zeros((1, 2)), jnp.zeros(1, bool),
            radius=8, margin=4, min_score=1.0, max_new=8)
        xy, ok = np.asarray(xy), np.asarray(ok)
        got = [tuple(p) for p, o in zip(xy, ok) if o]
        # (40,46) is within radius 8 of the stronger (40,40): suppressed.
        assert got == [(40.0, 40.0), (100.0, 90.0)]

    def test_separated_peaks_both_survive_at_small_radius(self):
        score = self._score()
        xy, ok = detect.nms_select(
            score, jnp.zeros((1, 2)), jnp.zeros(1, bool),
            radius=3, margin=4, min_score=1.0, max_new=8)
        got = {tuple(p) for p, o in zip(np.asarray(xy), np.asarray(ok)) if o}
        assert got == {(40.0, 40.0), (46.0, 40.0), (100.0, 90.0)}

    def test_equal_score_ties_respect_min_dist(self):
        # Two EXACTLY equal peaks closer than the radius: `score >= pooled`
        # passes both; the deterministic tie-break must emit only one
        # (lowest linear index), preserving the min-distance guarantee.
        score = self._score(peaks=((40, 40, 100.0), (40, 46, 100.0),
                                   (44, 43, 100.0), (90, 100, 60.0)))
        xy, ok = detect.nms_select(
            score, jnp.zeros((1, 2)), jnp.zeros(1, bool),
            radius=8, margin=4, min_score=1.0, max_new=8)
        got = [tuple(p) for p, o in zip(np.asarray(xy), np.asarray(ok)) if o]
        assert got == [(40.0, 40.0), (100.0, 90.0)]

    def test_live_track_suppresses_neighborhood(self):
        score = self._score()
        # Live track right next to the strongest peak.
        xy, ok = detect.nms_select(
            score, jnp.asarray([[38.0, 41.0]]), jnp.ones(1, bool),
            radius=8, margin=4, min_score=1.0, max_new=8)
        got = {tuple(p) for p, o in zip(np.asarray(xy), np.asarray(ok)) if o}
        assert (40.0, 40.0) not in got and (46.0, 40.0) not in got
        assert (100.0, 90.0) in got

    def test_dead_track_does_not_suppress(self):
        score = self._score()
        xy, ok = detect.nms_select(
            score, jnp.asarray([[38.0, 41.0]]), jnp.zeros(1, bool),
            radius=8, margin=4, min_score=1.0, max_new=8)
        got = {tuple(p) for p, o in zip(np.asarray(xy), np.asarray(ok)) if o}
        assert (40.0, 40.0) in got

    def test_margin_and_threshold(self):
        score = self._score(peaks=((2, 2, 500.0), (64, 64, 0.5)))
        _, ok = detect.nms_select(
            score, jnp.zeros((1, 2)), jnp.zeros(1, bool),
            radius=5, margin=10, min_score=1.0, max_new=8)
        assert not np.asarray(ok).any()

    def test_frontend_runs_in_nms_mode(self):
        from rsvio_tpu.models.frontend import (FrontendConfig, frontend_step,
                                               init_table)
        from rsvio_tpu.ops import pyramid
        from rsvio_tpu.ops.klt import KLTConfig
        rng = np.random.default_rng(3)
        img = jnp.asarray(rng.uniform(0, 255, (96, 128)).astype(np.float32))
        cfg = FrontendConfig(capacity=64, detect_mode="nms", nms_radius=6,
                             nms_max_new=32, detect_margin=8, min_score=5.0,
                             klt=KLTConfig(levels=2))
        pyr = pyramid.build_pyramid(img, 2)
        table = init_table(64)
        table, stats = frontend_step(table, pyr, pyr, pyr, pyr, cfg)
        assert int(stats["alive"]) > 0
        # births respect min-dist: pairwise distance >= radius
        pos = np.asarray(table.pos0)[np.asarray(table.alive)]
        d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
        np.fill_diagonal(d, 1e9)
        assert d.min() > 6.0 - 1e-3


class TestMultiCandidateCells:
    """Starvation multi-candidate picks: sparse scenes concentrate texture in
    few cells; extra spaced per-cell candidates fill the table (VERDICT r2
    item 6 — the easy_plane scene has corners in 32 of 112 cells)."""

    def test_multi_picks_are_spaced(self):
        s = np.zeros((100, 100), np.float32)
        # three peaks in one cell (cell_size 50), two of them adjacent
        s[20, 20] = 100.0
        s[20, 22] = 90.0   # within min_dist of the winner -> suppressed
        s[40, 40] = 80.0
        xy, ok = detect.select_grid_features(
            jnp.asarray(s), jnp.zeros((1, 2)), jnp.zeros(1, bool),
            cell_size=50, margin=4, min_score=1.0, max_per_cell=3,
            min_dist=5)
        got = [tuple(p) for p, o in zip(np.asarray(xy), np.asarray(ok)) if o]
        assert (20.0, 20.0) in got and (40.0, 40.0) in got
        assert (22.0, 20.0) not in got
        assert len(got) == 2  # third pick falls below spacing/score

    def test_frontend_starvation_extra_candidates(self):
        from rsvio_tpu.models import frontend
        from rsvio_tpu.ops import pyramid as pyr_mod
        from rsvio_tpu.ops.klt import KLTConfig
        import cv2
        rng = np.random.default_rng(5)
        # Texture concentrated in one quadrant; rest flat (sparse scene).
        H, W = 120, 160
        img = np.full((H, W), 100.0, np.float32)
        patch = cv2.resize(rng.uniform(0, 255, (16, 16)).astype(np.float32),
                           (64, 48), interpolation=cv2.INTER_CUBIC)
        img[12:60, 12:76] = patch
        img1 = np.roll(img, -6, axis=1)
        p0 = pyr_mod.build_pyramid(jnp.asarray(img), 3)
        p1 = pyr_mod.build_pyramid(jnp.asarray(img1), 3)
        base = frontend.FrontendConfig(
            capacity=64, cell_size=24, detect_margin=6, min_score=5.0,
            klt=KLTConfig(levels=3))
        counts = {}
        for name, cfg in (("strict", base),
                          ("relaxed", base._replace(relax_floor_below=32,
                                                    relax_max_per_cell=4))):
            table = frontend.init_table(cfg.capacity)
            table, stats = frontend.frontend_step(table, p0, p1, p0, p1, cfg)
            counts[name] = int(stats["born"])
        assert counts["relaxed"] > counts["strict"] * 1.5, counts
