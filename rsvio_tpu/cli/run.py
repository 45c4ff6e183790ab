"""Shared player loop: drives the estimator over a dataset with real-time
pacing, per-stage timing, viewer logging, statistics and trajectory export.

Capability parity (SURVEY.md §2 #7 EurocPlayer::run — ref
src/datasets/euroc_player.rs:20-176):
  * real-time pacing: sleep frame_interval − processing_time (ref :124-133)
  * per-frame wall-time accumulation + end-of-run statistics banner and
    `statistics.txt` (frames, avg ms, fps; ref :147-171, :325-346)
  * per-stage timing log line per frame (ref estimator.rs:252-259)
  * trajectory saving — a stub in the reference (ref :316-323), real
    TUM-format export here (required for the ATE north-star metric)
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

log = logging.getLogger("rsvio")


@dataclass
class PlayerConfig:
    """(ref src/datasets/mod.rs:64-71)"""
    enable_statistics: bool = True
    enable_console_statistics: bool = True
    step_mode: bool = False
    realtime: bool = False
    max_frames: Optional[int] = None
    enable_viewer: bool = False
    viewer_dir: Optional[str] = None    # write visualization artifacts here
    trajectory_out: Optional[str] = None
    use_vio: bool = False       # visual-inertial mode (IMU preintegration)
    checkpoint_out: Optional[str] = None
    checkpoint_in: Optional[str] = None
    checkpoint_every: Optional[int] = None  # periodic snapshot every N frames
    profile_dir: Optional[str] = None   # jax.profiler trace output directory
    evaluate_ate: bool = False  # compute ATE vs dataset ground truth at end
    # Tri-state override of the YAML solver.marginalization key (None =
    # respect the config file): Schur-marginalize evicted keyframes into a
    # dense prior instead of plain FIFO forgetting.
    marginalization: Optional[bool] = None
    # Per-frame stage-split [Timing] log (ref estimator.rs:252-259): runs the
    # estimator as four separately-jitted stages with device syncs between
    # them. Diagnosis mode — slower than the fused step. VO only.
    stage_timing: bool = False


@dataclass
class PlayerResult:
    """(ref src/datasets/mod.rs:55-62)"""
    success: bool = False
    frame_processing_times_ms: List[float] = field(default_factory=list)
    avg_processing_time_ms: float = 0.0
    # Per-frame estimator outputs, for the statistics below.
    n_tracked: List[int] = field(default_factory=list)
    ba_success: List[bool] = field(default_factory=list)
    is_keyframe: List[bool] = field(default_factory=list)


def imu_buffer_for_frame(imu_data, prev_ts, cur_ts, buf: int = 64,
                         np_dtype=np.float32):
    """Fixed-capacity masked IMU buffer for the interval (prev_ts, cur_ts]."""
    import jax.numpy as jnp

    gyro = np.zeros((buf, 3), np_dtype)
    accel = np.zeros((buf, 3), np_dtype)
    dts = np.zeros((buf,), np_dtype)
    mask = np.zeros((buf,), bool)
    if prev_ts is not None:
        ts = imu_data["ts"]
        sel = np.nonzero((ts > prev_ts) & (ts <= cur_ts))[0][:buf]
        n = len(sel)
        if n:
            gyro[:n] = imu_data["gyro"][sel]
            accel[:n] = imu_data["accel"][sel]
            t = ts[sel].astype(np.float64)
            prev = np.concatenate([[prev_ts], t[:-1]])
            dts[:n] = ((t - prev) * 1e-9).astype(np_dtype)
            mask[:n] = True
    return (jnp.asarray(gyro), jnp.asarray(accel), jnp.asarray(dts),
            jnp.asarray(mask))


def setup_logging(verbose: bool = True):
    """ANSI-colored ms-timestamped log format (ref run_euroc.rs:14-35)."""
    level = logging.DEBUG if verbose else logging.INFO
    logging.basicConfig(
        level=level,
        format="\x1b[90m%(asctime)s.%(msecs)03d\x1b[0m "
               "\x1b[36m%(levelname).1s\x1b[0m %(name)s: %(message)s",
        datefmt="%H:%M:%S")


def run_player(player, config_path: str, pcfg: PlayerConfig) -> PlayerResult:
    """Run the full pipeline over `player`'s frames."""
    import jax
    import jax.numpy as jnp

    from ..models import estimator as est
    from ..utils.config import load_config, make_estimator_config
    from ..utils.trajectory import save_tum
    from ..viewers import create_viewer
    from .. import profiling

    from ..utils.precision import ensure_matmul_precision
    ensure_matmul_precision()

    cfg = load_config(config_path)
    if pcfg.marginalization is not None:
        cfg.solver.marginalization = pcfg.marginalization
    if cfg.solver.marginalization:
        log.info("marginalization: evicted keyframes fold into a dense prior")
    if cfg.precision == "f64":
        # Runtime analog of the reference's `use_f32` feature flag (ref
        # src/types.rs:17-23, default f64 there). Must precede array
        # creation below so the rig/state come out in double.
        jax.config.update("jax_enable_x64", True)
        log.info("precision: f64 (jax x64 enabled)")
    dtype = jnp.float64 if cfg.precision == "f64" else jnp.float32
    ecfg, rig = make_estimator_config(cfg)

    imu_data = None
    if pcfg.use_vio:
        from ..models import estimator_vio as ev
        samples = player.load_imu() if hasattr(player, "load_imu") else []
        if samples:
            imu_data = {
                "ts": np.asarray([s.timestamp_ns for s in samples]),
                "gyro": np.asarray([s.gyro for s in samples], np.float32),
                "accel": np.asarray([s.accel for s in samples], np.float32),
            }
            from ..utils.config import make_vio_estimator_config
            vcfg, rig = make_vio_estimator_config(cfg)
            step = ev.make_vio_estimator_step(vcfg)
            # Gravity-aligned bootstrap from the quasi-static head of the
            # IMU stream (first ~0.5 s): initial attitude + gyro bias.
            ts0 = imu_data["ts"][0]
            init_sel = imu_data["ts"] <= ts0 + int(0.5e9)
            static_ok = False
            if init_sel.sum() >= 5:
                # Stillness gate: on a dataset that starts in motion the
                # sample means are wrong bias/gravity seeds and the bootstrap
                # would tilt the attitude — fall back to identity init.
                static_ok, info = ev.quasi_static_check(
                    imu_data["gyro"][init_sel], imu_data["accel"][init_sel])
                if not static_ok:
                    log.warning(
                        "VIO init: first 0.5 s of IMU not quasi-static "
                        "(gyro_std=%.4f accel_std=%.3f |accel|=%.3f) — "
                        "using identity init", info["gyro_std"],
                        info["accel_std"], info["accel_norm"])
            if static_ok:
                state = ev.initialize_vio_state(
                    vcfg, imu_data["gyro"][init_sel],
                    imu_data["accel"][init_sel], dtype=dtype)
                log.info("VIO init: gravity-aligned attitude + gyro bias "
                         "from %d static samples", int(init_sel.sum()))
            else:
                state = ev.init_vio_state(vcfg, dtype=dtype)
            log.info("VIO mode: %d IMU samples loaded", len(samples))
        else:
            log.warning("VIO requested but no IMU data found; running VO")
    stage_step = None
    if imu_data is None:
        if pcfg.stage_timing:
            stage_step = est.make_estimator_split_step(ecfg)
            log.info("stage-timing mode: separately-jitted estimator stages "
                     "(%s)", "/".join(est.STAGE_NAMES))
        step = est.make_estimator_step(ecfg)
        state = est.init_state(ecfg, dtype=dtype)
    elif pcfg.stage_timing:
        log.warning("--stage-timing is VO-only; ignored in VIO mode")

    if pcfg.checkpoint_in:
        from ..utils.checkpoint import load_state
        state = load_state(pcfg.checkpoint_in, state)
        log.info("resumed state from %s", pcfg.checkpoint_in)

    viewer = create_viewer(pcfg.enable_viewer, pcfg.viewer_dir)
    viewer_on = pcfg.enable_viewer or bool(pcfg.viewer_dir)

    n_frames = len(player)
    if pcfg.max_frames:
        n_frames = min(n_frames, pcfg.max_frames)
    log.info("dataset: %d frames (processing %d)", len(player), n_frames)

    result = PlayerResult()
    timestamps: List[int] = []
    poses: List[np.ndarray] = []
    kf_trajectory: List[tuple] = []   # (timestamp_ns, pose) per keyframe
    prev_ts = None

    # Prefer the native (C++) threaded PNG loader; fall back to the Python
    # prefetcher for players without path lists or missing toolchains.
    from ..data.players import prefetch_frames
    from .. import native
    H_img, W_img = ecfg.image_shape
    frame_iter = native.native_prefetch_frames(player, H_img, W_img,
                                               0, n_frames)
    if frame_iter is None:
        frame_iter = prefetch_frames(player, 0, n_frames)
        log.info("frame loader: Python PNG decoder")
    else:
        log.info("frame loader: native C++ (libpng)")
    profile_ctx = None
    if pcfg.profile_dir:
        from .. import profiling as _prof
        profile_ctx = _prof.jax_trace(pcfg.profile_dir)
        profile_ctx.__enter__()
        log.info("jax.profiler trace -> %s", pcfg.profile_dir)

    from .playback import PlaybackController
    playback = PlaybackController(pcfg.step_mode, log=log)
    if pcfg.step_mode:
        log.info("step mode: <enter> = next frame, a<enter> = toggle "
                 "auto-play, q<enter> = quit")

    frame_it = iter(frame_iter)
    k = -1
    while True:
        # Pull frames defensively: a decode failure mid-sequence must not
        # discard the results of the frames already processed (trajectory /
        # statistics / checkpoint still get written below).
        try:
            frame = next(frame_it)
        except StopIteration:
            break
        except Exception as e:
            log.error("frame loading failed after frame %d: %s — stopping "
                      "early, keeping results so far", k, e)
            break
        k += 1
        t_start = time.time()
        try:
            with profiling.span("frame_creation"):
                img_l = jnp.asarray(frame.left, dtype)
                img_r = jnp.asarray(frame.right, dtype)
            with profiling.span("process_frame"):
                if imu_data is not None:
                    gy, ac, dt_s, msk = imu_buffer_for_frame(
                        imu_data, prev_ts, frame.timestamp_ns, buf=64,
                        np_dtype=np.float64 if cfg.precision == "f64"
                        else np.float32)
                    state, out = step(state, rig, img_l, img_r,
                                      gy, ac, dt_s, msk)
                elif stage_step is not None:
                    state, out, stage_ms = stage_step(state, rig,
                                                      img_l, img_r)
                    log.debug(
                        "[Timing] frame %d stages: %s", k,
                        ", ".join(f"{n}: {stage_ms[n]:.2f} ms"
                                  for n in est.STAGE_NAMES))
                else:
                    state, out = step(state, rig, img_l, img_r)
                jax.block_until_ready(out.T_W_B)
        except Exception as e:  # per-frame errors logged and skipped (ref :110-114)
            log.error("frame %d failed: %s", k, e)
            continue
        elapsed_ms = (time.time() - t_start) * 1000.0
        result.frame_processing_times_ms.append(elapsed_ms)

        T = np.asarray(out.T_W_B)
        timestamps.append(frame.timestamp_ns)
        poses.append(T)
        result.n_tracked.append(int(out.n_tracked))
        result.ba_success.append(bool(out.ba_success))
        result.is_keyframe.append(bool(out.is_keyframe))
        if bool(out.is_keyframe):
            # Reference appends the OLDEST window pose per BA
            # (ref estimator.rs:355-361); we record the current KF pose.
            kf_trajectory.append((frame.timestamp_ns, T))

        # Per-frame numerical-health column (round-3 postmortem: a diverging
        # run must be visible in the first artifact lines, not discovered
        # post-hoc). step_m = translation since the previous frame — a
        # runaway shows as a growing step long before any NaN.
        pose_ok = bool(out.pose_ok)
        step_m = (float(np.linalg.norm(T[:3, 3] - poses[-2][:3, 3]))
                  if len(poses) > 1 else 0.0)
        if not pose_ok:
            log.warning("frame %d: non-finite pose RECOVERED to last "
                        "keyframe (health gate)", k)
        log.debug(
            "[Timing] frame %d: %.1f ms | kf=%d pnp=%d ba=%d(it=%d) "
            "tracked=%d lm=%d | health ok=%d h=%.2f inl=%d/%d step=%.3fm "
            "| %s", k, elapsed_ms,
            int(out.is_keyframe), int(out.pnp_success), int(out.ba_success),
            int(out.ba_iterations), int(out.n_tracked), int(out.n_landmarks),
            int(pose_ok), float(out.health), int(out.n_ransac_inliers),
            int(out.n_pnp_candidates), step_m, profiling.report())

        if viewer_on:
            # Entity schema parity with ref estimator.rs:272-364:
            # stereo/{left,right} images with colored tracked features,
            # pose_current, pose_<i> keyframe frustums, map/points,
            # trajectory/path.
            viewer.set_frame(k, frame.timestamp_ns)
            alive = np.asarray(state.table.alive)
            fids = np.asarray(state.table.fid)[alive]
            viewer.log_image_with_features_colored(
                "stereo/left", frame.left,
                np.asarray(state.table.pos0)[alive], fids)
            viewer.log_image_with_features_colored(
                "stereo/right", frame.right,
                np.asarray(state.table.pos1)[alive], fids)
            viewer.log_pose("pose_current", T)
            lm_valid = (np.asarray(state.lm_fid) == np.asarray(state.table.fid)) \
                & (np.asarray(state.lm_fid) >= 0)
            if lm_valid.any():
                viewer.log_points_colored("map/points",
                                          np.asarray(state.lm)[lm_valid],
                                          np.asarray(state.lm_fid)[lm_valid])
            n_kf = int(state.kf_count)
            intr = np.asarray(rig.params[0][:4])
            for i in range(n_kf):
                viewer.log_camera_frustum(
                    f"pose_{i}", np.asarray(state.kf_T_W_B[i]), intr,
                    (ecfg.image_shape[1], ecfg.image_shape[0]))
            if len(poses) > 1:
                viewer.log_trajectory(
                    "trajectory/path", np.asarray([p[:3, 3] for p in poses]))

        # Periodic crash-safe checkpoint (greenfield; ref has none).
        if (pcfg.checkpoint_every and pcfg.checkpoint_out
                and (k + 1) % pcfg.checkpoint_every == 0):
            from ..utils.checkpoint import save_state
            save_state(pcfg.checkpoint_out, state)
            log.debug("periodic checkpoint at frame %d -> %s", k,
                      pcfg.checkpoint_out)

        # Real-time pacing (ref euroc_player.rs:124-133)
        if pcfg.realtime and prev_ts is not None:
            interval = (frame.timestamp_ns - prev_ts) * 1e-9
            remaining = interval - (time.time() - t_start)
            if remaining > 0:
                time.sleep(remaining)
        prev_ts = frame.timestamp_ns

        # Interactive playback gate (ref FrameContext step_mode/auto_play/
        # advance_frame semantics, src/datasets/mod.rs:30-50) — non-blocking
        # in auto-play, polling single keys when stepping.
        if not playback.wait_for_advance():
            log.info("playback quit at frame %d", k)
            break

    if profile_ctx is not None:
        profile_ctx.__exit__(None, None, None)

    times = result.frame_processing_times_ms
    if times:
        result.avg_processing_time_ms = float(np.mean(times))
        result.success = True

    # Trajectory export (TUM format) — per-frame plus keyframe-only (the
    # reference records a keyframe trajectory, ref estimator.rs:355-361).
    if pcfg.trajectory_out and poses:
        save_tum(pcfg.trajectory_out, timestamps, poses)
        log.info("trajectory (%d poses) -> %s", len(poses), pcfg.trajectory_out)
        if kf_trajectory:
            root_name, ext = os.path.splitext(pcfg.trajectory_out)
            kf_path = f"{root_name}_keyframes{ext or '.txt'}"
            save_tum(kf_path, [t for t, _ in kf_trajectory],
                     [p_ for _, p_ in kf_trajectory])
            log.info("keyframe trajectory (%d poses) -> %s",
                     len(kf_trajectory), kf_path)

    if pcfg.checkpoint_out:
        from ..utils.checkpoint import save_state
        save_state(pcfg.checkpoint_out, state)
        log.info("state checkpoint -> %s", pcfg.checkpoint_out)

    # ATE against the dataset's ground truth (the north-star metric,
    # SURVEY.md §6 — entirely absent from the reference).
    ate = None
    if pcfg.evaluate_ate and poses:
        gt = (player.ground_truth_file()
              if hasattr(player, "ground_truth_file") else None)
        if gt:
            from ..utils.trajectory import (associate, ate_rmse,
                                            load_gnss_poses, load_tum)
            if os.path.basename(gt).startswith("GNSSPoses"):
                ts_g_ns, pos_g, _ = load_gnss_poses(gt)
                ts_g = ts_g_ns.astype(np.float64) * 1e-9
            else:
                ts_g, pos_g, _ = load_tum(gt)
                if len(ts_g) and ts_g.max() > 1e14:   # ns-stamped CSV (EuRoC)
                    ts_g = ts_g * 1e-9
            ts_e = np.asarray(timestamps, dtype=np.float64) * 1e-9
            pos_e = np.asarray([p[:3, 3] for p in poses])
            ia, ib = associate(ts_e, ts_g)
            if len(ia) >= 3:
                ate, _ = ate_rmse(pos_e[ia], pos_g[ib])
                log.info("ATE RMSE vs ground truth: %.4f m "
                         "(%d associations)", ate, len(ia))
            else:
                log.warning("ATE: only %d timestamp associations; skipped",
                            len(ia))
        else:
            log.warning("ATE requested but the dataset has no ground truth")

    # Statistics (ref euroc_player.rs:147-171, :325-346)
    if pcfg.enable_console_statistics and times:
        fps = 1000.0 / result.avg_processing_time_ms
        log.info("=" * 50)
        log.info("Processing complete: %d frames", len(times))
        log.info("Average processing time: %.2f ms (%.1f fps)",
                 result.avg_processing_time_ms, fps)
        log.info("=" * 50)
    if pcfg.enable_statistics and times:
        stats_path = os.path.join(getattr(player, "root", "."), "statistics.txt")
        try:
            with open(stats_path, "w") as f:
                f.write(f"frames_processed: {len(times)}\n")
                f.write(f"avg_processing_time_ms: {result.avg_processing_time_ms:.3f}\n")
                f.write(f"fps: {1000.0 / result.avg_processing_time_ms:.3f}\n")
                # The first frame compiles the step; the rest are warm.
                f.write(f"first_frame_ms: {times[0]:.3f}\n")
                if len(times) > 1:
                    f.write(f"warm_median_ms: {np.median(times[1:]):.3f}\n")
                tracked = result.n_tracked[1:] or [0]
                f.write(f"tracked_mean: {np.mean(tracked):.3f}\n")
                f.write(f"ba_fires: {sum(result.ba_success)}\n")
                f.write(f"keyframes: {sum(result.is_keyframe)}\n")
                if ate is not None:
                    f.write(f"ate_rmse_m: {ate:.6f}\n")
            log.info("statistics -> %s", stats_path)
        except OSError as e:
            log.warning("could not write statistics: %s", e)

    return result


def make_cli(player_cls, name: str):
    """Build a main() for one dataset (ref src/bin/run_euroc.rs:9-73:
    two positional args, config then dataset path)."""

    def main(argv=None):
        ap = argparse.ArgumentParser(description=f"Run {name} stereo VO")
        ap.add_argument("config_file")
        ap.add_argument("dataset_path")
        ap.add_argument("--max-frames", type=int, default=None)
        ap.add_argument("--realtime", action="store_true")
        ap.add_argument("--step-mode", action="store_true")
        ap.add_argument("--viewer", action="store_true")
        ap.add_argument("--viewer-dir", default=None,
                        help="write visualization artifacts (PNG overlays, "
                             "PLY map, SVG trajectory) to this directory")
        ap.add_argument("--trajectory-out", default=None)
        ap.add_argument("--vio", action="store_true",
                        help="visual-inertial mode (IMU preintegration)")
        ap.add_argument("--marginalization",
                        action=argparse.BooleanOptionalAction, default=None,
                        help="Schur-marginalize evicted keyframes into a "
                             "dense prior (--no-marginalization forces "
                             "FIFO; default: respect the YAML key)")
        ap.add_argument("--checkpoint-out", default=None)
        ap.add_argument("--checkpoint-in", default=None)
        ap.add_argument("--checkpoint-every", type=int, default=None,
                        help="periodic snapshot every N frames "
                             "(needs --checkpoint-out)")
        ap.add_argument("--eval-ate", action="store_true",
                        help="compute ATE vs the dataset ground truth")
        ap.add_argument("--profile-dir", default=None,
                        help="write a jax.profiler trace here")
        ap.add_argument("--stage-timing", action="store_true",
                        help="per-frame 4-stage [Timing] split (separately-"
                        "jitted stages with device syncs; VO only)")
        ap.add_argument("--quiet", action="store_true")
        args = ap.parse_args(argv)
        setup_logging(verbose=not args.quiet)
        np.random.seed(42)  # ref run_euroc.rs seed
        player = player_cls(args.dataset_path)
        pcfg = PlayerConfig(
            step_mode=args.step_mode, realtime=args.realtime,
            max_frames=args.max_frames, enable_viewer=args.viewer,
            viewer_dir=args.viewer_dir,
            trajectory_out=args.trajectory_out, use_vio=args.vio,
            checkpoint_out=args.checkpoint_out,
            checkpoint_in=args.checkpoint_in,
            checkpoint_every=args.checkpoint_every,
            profile_dir=args.profile_dir,
            evaluate_ate=args.eval_ate,
            marginalization=args.marginalization,
            stage_timing=args.stage_timing)
        from ..utils.cache import compilation_cache
        with compilation_cache():
            res = run_player(player, args.config_file, pcfg)
        return 0 if res.success else -1

    return main
