"""TartanAir mono feature-tracking entry point.

Capability parity (SURVEY.md §2 #27 — ref
feature_tracker/src/bin/play_tartanair.rs + players/tartanair_player.rs):
drives the mono tracker (temporal bidirectional KLT + Shi-Tomasi births,
the experimental-crate capability set) over a TartanAir `image_left`
sequence, capped at 800 frames like the reference, with viewer hooks.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .run import setup_logging

import logging

log = logging.getLogger("rsvio")


def _load_tracker_yaml(path):
    """Parse the experimental-crate tracker config schema (ref
    feature_tracker/config/config.yaml: nlevels / ratio / preprocessing_blur /
    detection_* / optical_flow_*), loaded by play_tartanair.rs. Unknown keys
    are ignored, like the reference's serde."""
    from ..utils.config import load_yaml_stripped
    return load_yaml_stripped(path)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Run TartanAir mono tracking")
    ap.add_argument("dataset_path", help="sequence dir containing image_left/")
    ap.add_argument("--config", default=None,
                    help="tracker YAML (experimental-crate schema: nlevels, "
                         "ratio, preprocessing_blur, detection_min_dist, "
                         "detection_threshold, optical_flow_max_iter, "
                         "optical_flow_lm_lambda)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--viewer", action="store_true")
    ap.add_argument("--viewer-dir", default=None)
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    setup_logging(verbose=not args.quiet)
    np.random.seed(42)
    from ..utils.cache import compilation_cache
    with compilation_cache():
        return _track(args)


def _track(args) -> int:
    from ..utils.precision import ensure_matmul_precision
    ensure_matmul_precision()
    import jax
    import jax.numpy as jnp

    from ..data.players import TartanAirPlayer, prefetch_frames
    from ..models import mono_tracker as mt
    from ..ops import detect, pyramid
    from ..ops.klt import KLTConfig
    from ..viewers import create_viewer

    player = TartanAirPlayer(args.dataset_path)
    n = len(player) if args.max_frames is None else min(args.max_frames,
                                                        len(player))
    log.info("TartanAir: %d frames (processing %d)", len(player), n)
    viewer = create_viewer(args.viewer, args.viewer_dir)
    viewer_on = args.viewer or bool(args.viewer_dir)

    # Defaults = ref mono PatchTracker (30 it / 0.005 / grid 30); a --config
    # file overrides them with the experimental-crate schema.
    levels, down, blur, blur_sigma = args.levels, 2.0, False, 0.7
    max_iter, lm_lambda = 30, 0.0
    cell_size, min_score = 30, 1.0
    detect_mode, nms_radius = "grid", 10
    if args.config:
        y = _load_tracker_yaml(args.config)
        levels = int(y.get("nlevels", levels))
        down = float(y.get("ratio", down))       # per-level downscale factor
        blur = bool(y.get("preprocessing_blur", blur))
        blur_sigma = float(y.get("preprocessing_blur_sigma", blur_sigma))
        max_iter = int(y.get("optical_flow_max_iter", max_iter))
        lm_lambda = float(y.get("optical_flow_lm_lambda", lm_lambda))
        cell_size = int(y.get("detection_min_dist", cell_size))
        if "detection_min_dist" in y:
            # True min-dist semantics: block NMS with live-track suppression
            # (ref feature_detection.rs:172-254, 62-69) instead of the
            # grid-cell approximation.
            detect_mode, nms_radius = "nms", int(y["detection_min_dist"])
        # Approximate threshold mapping to reference units: the ref score
        # carries a x500 factor on (tr - disc) = x1000 on the min eigenvalue,
        # and its unnormalized [-1,0,1] gradient kernel yields a ~4x larger
        # structure tensor than our 0.5-scaled central differences, so divide
        # by 4000. Still approximate (ref smooths with a sigma=detection_blur
        # Gaussian vs our 3x3 box).
        if "detection_threshold" in y:
            min_score = float(y["detection_threshold"]) / 4000.0

    cfg = mt.MonoTrackerConfig(
        capacity=args.capacity, cell_size=cell_size, min_score=min_score,
        detect_mode=detect_mode, nms_radius=nms_radius,
        klt=KLTConfig(levels=levels, max_iterations=max_iter,
                      convergence_threshold=0.005, lm_lambda=lm_lambda,
                      pyramid_ratio=1.0 / down))
    table = mt.init_mono_table(args.capacity)

    def make_pyramid(img):
        if down == 2.0 and not blur:
            return pyramid.build_pyramid(img, levels)
        return pyramid.build_pyramid_ratio(img, levels, 1.0 / down, blur=blur,
                                           blur_sigma=blur_sigma)

    pyr_prev = None
    times = []
    for k, frame in enumerate(prefetch_frames(player, 0, n)):
        t0 = time.time()
        pyr = make_pyramid(jnp.asarray(frame.left))
        table, stats = mt.mono_tracker_step(
            table, pyr_prev if pyr_prev is not None else pyr, pyr, cfg,
            first_frame=(pyr_prev is None))
        jax.block_until_ready(table.pos)
        pyr_prev = pyr
        times.append((time.time() - t0) * 1000.0)
        log.debug("[Timing] frame %d: %.1f ms | tracked=%d alive=%d",
                  k, times[-1], int(stats["tracked"]), int(stats["alive"]))
        if viewer_on:
            viewer.set_frame(k, frame.timestamp_ns)
            alive = np.asarray(table.alive)
            pos = np.asarray(table.pos)[alive]
            fids = np.asarray(table.fid)[alive]
            viewer.log_image_with_features_colored(
                "tartanair/left", frame.left, pos, fids)
            # FT debug surface (ref feature_tracker/src/viewer.rs:6-97):
            # id-labeled points at pixel centers, pyramid levels with draw
            # order, and the corner-score float map as a colormapped image.
            viewer.log_labeled_points("tartanair/labels", pos,
                                      [str(int(f)) for f in fids])
            viewer.log_pyramid("tartanair/pyramid",
                               [np.asarray(lv) for lv in pyr])
            viewer.log_float_map(
                "tartanair/shi_tomasi",
                np.asarray(detect.shi_tomasi_score(pyr[0])))
    if times:
        avg = float(np.mean(times))
        log.info("%d frames, avg %.2f ms (%.1f fps)", len(times), avg,
                 1000.0 / avg)
        return 0
    return -1


if __name__ == "__main__":
    raise SystemExit(main())
