"""Smoke test of the stereo VO/VIO main path on an NVIDIA GPU.

Run from the repository root:

    python chip_smoke.py              # one GPU: device, cli, parity, tracker
    python chip_smoke.py --four-gpus  # four GPUs: the landmark-sharded path

Phases, in one process, each failing the run with a non-zero exit:

  device   require a GPU (no CPU fallback); print its kind, the device count,
           the card's name and power limit; run float32 matmuls at
           precision "highest" (no TF32).
  cli      write a synthetic EuRoC-format sequence (752x480 at 20 Hz, a 200 Hz
           IMU, ground truth) and a config beside it (config/euroc_vio.yaml
           with the synthetic rig), then run rsvio_tpu.cli.run_euroc in this
           process, VO and then --vio. Each run must give a finite
           trajectory, fire BA, track >= 80 features on average and drift
           <= 2 % against the ground truth.
  parity   the same inputs on the card and on JAX's CPU backend: the stereo
           tracker pass, solve_ba and solve_vio_ba at W=10 x 256, and the
           first 15 VO frames, within rsvio_tpu.parity's tolerances.
  tracker  time one stereo tracker pass (both cameras, 256 slots, 6 levels,
           20 iterations) and the VO frame step on the card.

--four-gpus runs only the sharded phase: the four landmark-sharded window
solvers at W=10 x 4*256 against their single-device solvers, and a few
full-width frames of the distributed VO and VIO steps against the
single-device steps.

The last line of stdout is {"ok": true, "device": {...}}; everything else
comes before it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

H, W, FPS, IMU_HZ = 480, 752, 20.0, 200.0
FX = FY = 458.0
BASELINE_M = 0.11
T0_NS = 1_403_636_580_000_000_000      # EuRoC-style nanosecond stamps
HOLD_S = 0.6                            # IMU hold-still head before frame 0
TIMED_CALLS = 30
WARMUP = 5
N_FRAMES = 80                           # the CLI runs' sequence length
N_FRAMES_SHARDED = 8                    # frames of the distributed steps
WORKDIR = os.path.join(ROOT, ".smoke")  # sequence + config, removed at exit

# Quality floors of the CLI runs (bench.py's floors).
MIN_TRACKED_MEAN = 80.0
MAX_DRIFT_PCT = 2.0


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def fail(phase: str, msg: str) -> None:
    print(f"[{phase}] FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(phase: str, cond: bool, msg: str) -> None:
    if not cond:
        fail(phase, msg)


# ---------------------------------------------------------------- device ---

def phase_device(n_gpus: int):
    import jax

    devs = jax.devices()
    check("device", devs[0].platform == "gpu",
          f"no GPU: JAX's default devices are {devs}")
    check("device", len(devs) >= n_gpus,
          f"{n_gpus} GPUs needed, JAX sees {len(devs)}")
    from rsvio_tpu.utils.precision import ensure_matmul_precision
    ensure_matmul_precision()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log("device", kind=repr(devs[0].device_kind), count=len(devs),
        matmul_precision=jax.config.jax_default_matmul_precision)
    print(f"nvidia-smi: {smi}", flush=True)
    check("device", jax.config.jax_default_matmul_precision == "highest",
          "matmul precision is not 'highest'")
    return devs


# ------------------------------------------------------------- sequence ----

def smoke_trajectory():
    """traj_6dof's amplitudes and periods, phased to start at rest: the
    IMU's hold-still head then joins the motion without a velocity jump."""
    import numpy as np

    from rsvio_tpu.data import synthetic as syn

    la = np.array([0.9, 0.35, 0.25])
    lp = np.array([7.0, 5.3, 4.3])
    aa = np.deg2rad([8.0, 5.0, 4.0])
    ap = np.array([6.1, 4.7, 5.9])
    return syn.Trajectory(
        pos_fn=lambda t: la * (1.0 - np.cos(2 * np.pi * t / lp)),
        ang_fn=lambda t: aa * (1.0 - np.cos(2 * np.pi * t / ap)))


def make_sequence(seed: int, n_frames: int):
    """Render the stereo sequence (uint8 frames), its ground truth and the
    IMU stream: HOLD_S of hold-still at the start pose, then the motion."""
    import numpy as np

    from rsvio_tpu.data import synthetic as syn
    from rsvio_tpu.utils.evaluation import static_init_imu

    scene = syn.scene_depth_structured(H, W, seed=seed)
    traj = smoke_trajectory()
    ts = np.arange(n_frames) / FPS
    frames, gt = [], np.zeros((n_frames, 4, 4))
    for k, t in enumerate(ts):
        gt[k] = traj.pose(t)
        frames.append(tuple(
            np.clip(np.rint(im), 0, 255).astype(np.uint8)
            for im in syn.render_stereo(scene, gt[k], t)))
    hold_g, hold_a = static_init_imu(traj, HOLD_S, IMU_HZ)
    hold_t = -HOLD_S + (np.arange(len(hold_g)) + 1) / IMU_HZ
    imu_t, gyro, accel, _ = traj.sample_imu(0.0, ts[-1], rate=IMU_HZ)
    return {"ts": ts, "frames": frames, "gt": gt,
            "imu_t": np.concatenate([hold_t, imu_t]),
            "gyro": np.concatenate([hold_g, gyro]),
            "accel": np.concatenate([hold_a, accel])}


def _ns(t):
    import numpy as np
    return T0_NS + np.rint(np.asarray(t) * 1e9).astype(np.int64)


def write_euroc(root: str, seq) -> None:
    """EuRoC MAV layout: cam0/cam1 PNGs + data.csv, imu0, ground truth."""
    from rsvio_tpu.data.png import write_png
    from rsvio_tpu.utils.trajectory import rot_to_quat_np

    stamps = _ns(seq["ts"])
    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(root, "mav0", cam, "data"), exist_ok=True)
    rows = ["#timestamp [ns],filename"]
    for k, st in enumerate(stamps):
        for c, cam in enumerate(("cam0", "cam1")):
            write_png(os.path.join(root, "mav0", cam, "data", f"{st}.png"),
                      seq["frames"][k][c])
        rows.append(f"{st},{st}.png")
    for cam in ("cam0", "cam1"):
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    os.makedirs(os.path.join(root, "mav0", "imu0"), exist_ok=True)
    with open(os.path.join(root, "mav0", "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for st, g, a in zip(_ns(seq["imu_t"]), seq["gyro"], seq["accel"]):
            f.write(f"{st}," + ",".join(f"{v:.9g}" for v in (*g, *a)) + "\n")
    gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    os.makedirs(gt_dir, exist_ok=True)
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_x,q_y,q_z,q_w\n")
        for st, T in zip(stamps, seq["gt"]):
            vals = (*T[:3, 3], *rot_to_quat_np(T[:3, :3]))
            f.write(f"{st}," + ",".join(f"{v:.9f}" for v in vals) + "\n")


def write_config(path: str) -> None:
    """config/euroc_vio.yaml with the synthetic rig: its intrinsics, zero
    distortion, left camera = body, right camera BASELINE_M along +x."""
    with open(os.path.join(ROOT, "config", "euroc_vio.yaml")) as f:
        text = f.read()
    eye = [1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0,
           0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]
    right = list(eye)
    right[3] = BASELINE_M
    values = {
        "left_intrinsics": [FX, FY, W / 2, H / 2],
        "right_intrinsics": [FX, FY, W / 2, H / 2],
        "left_distortion": [0.0] * 4, "right_distortion": [0.0] * 4,
        "T_B_Cl": eye, "T_B_Cr": right}
    for key, vals in values.items():
        text, n = re.subn(rf"({key}:\s*)\[[^\]]*\]",
                          lambda m: m.group(1) + repr(vals), text)
        check("cli", n == 1, f"{key} not found once in euroc_vio.yaml")
    with open(path, "w") as f:
        f.write(text)


# ------------------------------------------------------------------ cli ----

def _read_stats(path: str) -> dict:
    with open(path) as f:
        return {k.strip(): float(v) for k, v in
                (line.split(":", 1) for line in f if ":" in line)}


def phase_cli(seq, root: str, cfg_path: str, devs) -> None:
    import numpy as np

    from rsvio_tpu.cli.run_euroc import main as run_euroc
    from rsvio_tpu.utils.config import load_config
    from rsvio_tpu.utils.evaluation import score_positions
    from rsvio_tpu.utils.trajectory import load_tum

    gt = seq["gt"][:, :3, 3]
    window = load_config(cfg_path).keyframe_management.keyframe_window_size
    for mode in ("vo", "vio"):
        traj_path = os.path.join(root, f"traj_{mode}.txt")
        argv = [cfg_path, root, "--quiet", "--eval-ate",
                "--trajectory-out", traj_path] + (["--vio"] if mode == "vio"
                                                  else [])
        t0 = time.perf_counter()
        rc = run_euroc(argv)
        wall = time.perf_counter() - t0
        check("cli", rc == 0, f"{mode}: run_euroc returned {rc}")
        stats = _read_stats(os.path.join(root, "statistics.txt"))
        _, pos, _ = load_tum(traj_path)
        kf_t, _, _ = load_tum(traj_path.replace(".txt", "_keyframes.txt"))
        check("cli", len(pos) == len(gt),
              f"{mode}: {len(pos)} poses for {len(gt)} frames")
        # Score after the window fills (evaluation.run_synthetic_sequence).
        fill = (int(np.argmin(np.abs(_ns(seq["ts"]) * 1e-9
                                     - kf_t[window - 1]))) + 1
                if len(kf_t) >= window else len(gt) // 3)
        ate, drift = score_positions(pos, gt, min(fill, len(gt) - 5))
        peak = (devs[0].memory_stats() or {}).get("peak_bytes_in_use")
        log("cli", mode=mode, frames=int(stats["frames_processed"]),
            main_wall_s=f"{wall:.2f}",
            first_frame_s=f"{stats['first_frame_ms'] / 1e3:.2f}",
            warm_median_ms=f"{stats['warm_median_ms']:.3f}",
            warm_fps=f"{1e3 / stats['warm_median_ms']:.1f}",
            peak_bytes_in_use=peak, ba_fires=int(stats["ba_fires"]),
            keyframes=int(stats["keyframes"]),
            tracked_mean=f"{stats['tracked_mean']:.1f}",
            ate_m=f"{ate:.4f}", drift_pct=f"{drift:.3f}",
            cli_ate_m=f"{stats.get('ate_rmse_m', float('nan')):.4f}")
        check("cli", bool(np.isfinite(pos).all()),
              f"{mode}: non-finite trajectory")
        check("cli", stats["ba_fires"] >= 1, f"{mode}: BA never fired")
        check("cli", stats["tracked_mean"] >= MIN_TRACKED_MEAN,
              f"{mode}: tracked mean {stats['tracked_mean']:.1f} < "
              f"{MIN_TRACKED_MEAN}")
        check("cli", drift <= MAX_DRIFT_PCT,
              f"{mode}: drift {drift:.3f}% > {MAX_DRIFT_PCT}%")


# --------------------------------------------------------------- parity ----

def _frames_f32(seq, n):
    import numpy as np
    return [(np.float32(l), np.float32(r)) for l, r in seq["frames"][:n]]


def phase_parity(seq, cfg_path: str, devs) -> None:
    import jax

    from rsvio_tpu import parity
    from rsvio_tpu.utils.config import load_config, make_estimator_config

    gpu, cpu = devs[0], jax.devices("cpu")[0]
    ecfg, rig = make_estimator_config(load_config(cfg_path))
    frames = _frames_f32(seq, parity.VO_FRAMES)
    checks = {
        "tracker": lambda: parity.tracker_parity(
            gpu, cpu, frames[:2], ecfg.frontend.klt,
            n=ecfg.frontend.capacity),
        "solve_ba": lambda: parity.solve_ba_parity(gpu, cpu),
        "solve_vio_ba": lambda: parity.solve_vio_ba_parity(gpu, cpu),
        "vo_frames": lambda: parity.vo_parity(gpu, cpu, frames, ecfg, rig),
    }
    for name, run in checks.items():
        d = run()
        log("parity", check=name, **d)
        check("parity", d["ok"], f"{name} outside tolerance: {d}")


# -------------------------------------------------------------- tracker ----

def _median_ms(fn, calls: int) -> float:
    import jax
    import numpy as np

    for _ in range(WARMUP):
        jax.block_until_ready(fn())
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_tracker(seq, cfg_path: str) -> None:
    import jax
    import numpy as np

    from rsvio_tpu import parity
    from rsvio_tpu.models import estimator as est
    from rsvio_tpu.ops import klt, pyramid
    from rsvio_tpu.utils.config import load_config, make_estimator_config

    ecfg, rig = make_estimator_config(load_config(cfg_path))
    kcfg = ecfg.frontend.klt
    n = ecfg.frontend.capacity
    l0, r0, l1, r1, p0, p1, alive = jax.device_put(parity.tracker_inputs(
        _frames_f32(seq, 2), n))
    pyrs = [pyramid.build_pyramid(im, kcfg.levels) for im in (l0, r0, l1, r1)]
    track_ms = _median_ms(lambda: klt.track_points_bidirectional_stereo(
        *pyrs, p0, p1, alive, kcfg), TIMED_CALLS)

    # The step over consecutive frames 0..WARMUP+TIMED_CALLS of the
    # sequence, blocked each frame; the first WARMUP frames compile/warm.
    step = est.make_estimator_step(ecfg)
    state, times = est.init_state(ecfg), []
    for k, f in enumerate(_frames_f32(seq, WARMUP + TIMED_CALLS)):
        f = jax.device_put(f)
        t0 = time.perf_counter()
        state, out = step(state, rig, *f)
        jax.block_until_ready(out)
        if k >= WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(times))
    log("tracker", stereo_pass_ms=f"{track_ms:.3f}",
        frame_step_ms=f"{step_ms:.3f}",
        tracker_share=f"{track_ms / step_ms:.3f}", slots=n,
        levels=kcfg.levels, iterations=kcfg.max_iterations,
        width=W, height=H, calls=TIMED_CALLS)


# --------------------------------------------------------------- sharded ---

def phase_sharded(seq, cfg_path: str) -> None:
    from rsvio_tpu import parity
    from rsvio_tpu.cli.run import imu_buffer_for_frame
    from rsvio_tpu.parallel.mesh import make_mesh
    from rsvio_tpu.utils.config import (load_config, make_estimator_config,
                                        make_vio_estimator_config)

    mesh = make_mesh(4)
    d = parity.sharded_solver_parity(mesh, n_lm=4 * 256)
    for name in ("ba", "ba_marg", "vio_ba", "vio_ba_marg"):
        log("sharded", solver=name, **d[name])
    check("sharded", d["ok"], f"sharded solvers outside tolerance: {d}")

    cfg = load_config(cfg_path)
    ecfg, rig = make_estimator_config(cfg)
    vcfg, _ = make_vio_estimator_config(cfg)
    # Per-frame IMU buffers exactly as the CLI player builds them.
    imu_data = {"ts": _ns(seq["imu_t"]), "gyro": seq["gyro"],
                "accel": seq["accel"]}
    stamps = [int(t) for t in _ns(seq["ts"])]
    imu = [imu_buffer_for_frame(imu_data, stamps[k - 1] if k else None,
                                stamps[k], vcfg.imu_buf)
           for k in range(len(stamps))]
    d = parity.sharded_step_parity(mesh, _frames_f32(seq, len(stamps)),
                                   ecfg, rig, vcfg, imu)
    for name in ("vo", "vio"):
        log("sharded", step=name, **d[name])
    check("sharded", d["ok"], f"distributed steps outside tolerance: {d}")


# ----------------------------------------------------------------- main ----

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1,
                    help="scene seed (textures and geometry)")
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the landmark-sharded path on four GPUs")
    args = ap.parse_args(argv)

    # The parity phase needs JAX's CPU backend beside the GPU.
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    devs = phase_device(4 if args.four_gpus else 1)
    from rsvio_tpu.utils.cache import compilation_cache

    t0 = time.perf_counter()
    with compilation_cache() as cache_dir:
        log("device", compilation_cache=cache_dir)
        seq = make_sequence(args.seed, N_FRAMES_SHARDED if args.four_gpus
                            else N_FRAMES)
        cfg_path = os.path.join(WORKDIR, "euroc_vio_synthetic.yaml")
        shutil.rmtree(WORKDIR, ignore_errors=True)
        os.makedirs(WORKDIR)
        write_config(cfg_path)
        log("sequence", frames=len(seq["frames"]), width=W, height=H,
            imu_samples=len(seq["imu_t"]),
            seconds=f"{time.perf_counter() - t0:.1f}")
        if args.four_gpus:
            phase_sharded(seq, cfg_path)
        else:
            root = os.path.join(WORKDIR, "MH_synthetic")
            write_euroc(root, seq)
            phase_cli(seq, root, cfg_path, devs)
            phase_parity(seq, cfg_path, devs)
            phase_tracker(seq, cfg_path)
        shutil.rmtree(WORKDIR, ignore_errors=True)
    log("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
