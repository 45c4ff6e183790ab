"""On-device accuracy matrix: {VO, VO+marg, VIO, VIO+marg} x adversarial
synthetic scenes (6-DoF motion, depth structure, photometric drift, moving
occluder) -> ATE RMSE + drift table (VERDICT round-1 item 1).

Real datasets are not mountable in this environment (zero egress); this is
the honest substitute for the BASELINE real-dataset rows. The scenes come
from rsvio_tpu.data.synthetic (exact ground truth), the metrics from
rsvio_tpu.utils.evaluation.

Usage:
  python tools/accuracy_matrix.py                      # default device, full res
  JAX_PLATFORMS=cpu python tools/accuracy_matrix.py --frames 40 --width 320
  python tools/accuracy_matrix.py --scenes depth_6dof occlusion_6dof

Writes a markdown table to stdout and a JSON blob to --json (default
accuracy_matrix.json).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = [
    ("vo_fifo", dict(use_vio=False, use_marginalization=False)),
    ("vo_marg", dict(use_vio=False, use_marginalization=True)),
    ("vio_fifo", dict(use_vio=True, use_marginalization=False)),
    ("vio_marg", dict(use_vio=True, use_marginalization=True)),
    # Dynamic-scene profile: heavy PnP motion prior (anchored at the
    # measured previous pose) rides through coherent moving occluders.
    # Round-4 full-res matrix evidence:
    # occlusion_6dof drift 46.8% (vo_fifo) -> 7.50% / ATE 1.06 -> 0.43 m;
    # cost on clean scenes is real lag (depth_6dof ATE 0.017 -> 0.545 m,
    # photometric 0.022 -> 0.38 m) — a deliberate robustness/accuracy
    # tradeoff. Shipped as config/euroc_vo_dynamic.yaml.
    # NOTE the strict coarse-level policy: border-tolerant tracking (the
    # round-4 default) floods dynamic scenes with weakly-verified tracks on
    # the OCCLUDER that overwhelm the motion-prior defense (measured:
    # occlusion drift 7.5% strict -> 52% tolerant for this profile); the
    # dynamic profile keeps the conservative reference track set.
    ("vo_dyn", dict(use_vio=False, use_marginalization=False,
                    motion_prior=20.0, coarse_level_policy="strict")),
    # Round-5 ADAPTIVE profiles: the RANSAC consensus inlier fraction
    # drives (a) the motion-prior weight — zero lag on clean scenes, full
    # pull through contamination/deserts — and (b) the window-solve vision
    # weights, so low-consensus frames contribute ~h^2 information. The
    # goal: retire the static/dynamic config split (vo_dyn's 88x easy_plane
    # penalty) and let VIO coast the occlusion information desert on the
    # IMU.
    ("vo_adapt", dict(use_vio=False, use_marginalization=False,
                      motion_prior=20.0, ransac=16, adaptive=True)),
    # vio_adapt adds the scene-flow gate (uncentered — IMU-anchored pose):
    # multi-seed 320px/160f occlusion evidence: drift 54% (vio_fifo) ->
    # 15.8/11.0/11.8% across IMU-noise seeds 7/11/23; without the flow gate
    # the transit outcome is noise-sensitive (44/25/13%). A marginalized
    # variant measured WORSE (24-36%) and an age-cap-40 vote horizon
    # measured worse (34/28/10) — redetected static tracks are young too.
    # Physical bias random-walk stiffness 1e5/1e3 (round 5): window drag
    # leaks into the gyro AND accel bias states during occlusion deserts.
    # The loose defaults (1e3/1e2) model a far noisier walk than the IMU
    # spec implies (1/(sigma_walk*sqrt(dt)) at the EuRoC ADIS16448 numbers
    # and ~0.25 s KF intervals: gyro ~1e5, accel ~7e2). Full-res ladder
    # (occlusion ATE/drift): defaults 0.744/14.9 -> accel 1e4 0.192/1.45
    # -> accel 1e3 0.155/3.35 with depth_6dof BEST-ever (0.0045 m vs
    # 0.0097 committed; accel 1e4 cost 0.038 there). Over-stiff accel
    # (1e6) measured worse everywhere (320px occl 8%, clean 1.7x); the
    # health-gated desert variant (solver.bias_*_weight_desert) never
    # beat the static pair because the consensus signal reads healthy
    # while a coherent mover holds the vote (docs/NOTES.md round 5).
    ("vio_adapt", dict(use_vio=True, use_marginalization=False,
                       motion_prior=20.0, ransac=16, adaptive=True,
                       dynamic_flow=0.02,
                       bias_gyro_weight=1e5, bias_accel_weight=1e3)),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--fps", type=float, default=20.0)
    ap.add_argument("--width", type=int, default=752)
    ap.add_argument("--height", type=int, default=0,
                    help="0 = width * 480/752")
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--configs", nargs="*", default=None)
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--levels", type=int, default=0,
                    help="0 = auto from width (6 at 752, >=3)")
    ap.add_argument("--cell", type=int, default=0,
                    help="detector grid cell px; 0 = auto from width")
    ap.add_argument("--margin", type=int, default=0,
                    help="detector border margin px; 0 = auto from width")
    ap.add_argument("--imu-noise", action=argparse.BooleanOptionalAction, default=True,
                    help="inject IMU noise/bias (disable: --no-imu-noise)")
    ap.add_argument("--seed", type=int, default=7,
                    help="IMU-noise seed (per-scene rng = seed + scene hash)")
    ap.add_argument("--json", default="accuracy_matrix.json")
    args = ap.parse_args()

    import jax
    from rsvio_tpu.utils.precision import ensure_matmul_precision
    ensure_matmul_precision()

    import numpy as np
    from rsvio_tpu.data import synthetic as syn
    from rsvio_tpu.utils import evaluation as ev_util

    H = args.height or int(args.width * 480 / 752)
    W = args.width
    # Tracker geometry scales with resolution (reference tunings are for
    # 752x480; a reduced-width CPU smoke needs proportional cell/margin and
    # fewer pyramid levels to keep the top level bigger than a patch).
    scale = W / 752.0
    levels = args.levels or max(3, min(6, int(round(np.log2(W / 12)))))
    cell = args.cell or max(16, int(round(50 * scale)))
    margin = args.margin or max(6, int(round(19 * scale)))
    scene_names = args.scenes or list(syn.MATRIX_SCENES)
    config_names = [c for c, _ in CONFIGS]
    if args.configs:
        config_names = [c for c in config_names if c in args.configs]

    import zlib

    def scene_rng(sname):
        # Per-scene deterministic rng: a scene's IMU-noise realization must
        # not depend on WHICH OTHER scenes ran in the same invocation
        # (round-5 finding: a shared generator made occlusion results vary
        # 14-38% drift purely with the --scenes list).
        return np.random.default_rng(args.seed + zlib.crc32(sname.encode()))

    def make_imu_kwargs(rng):
        if not args.imu_noise:
            return {}
        return dict(gyro_bias=[0.003, -0.002, 0.004],
                    accel_bias=[0.02, -0.015, 0.01],
                    noise_rng=rng, gyro_noise=1.7e-4,
                    accel_noise=2.0e-3)

    print(f"device={jax.devices()[0].platform} {W}x{H} "
          f"frames={args.frames} window={args.window} levels={levels} "
          f"cell={cell} margin={margin}", file=sys.stderr)

    rows = []
    for sname in scene_names:
        scene_fn, traj_fn = syn.MATRIX_SCENES[sname]
        scene = scene_fn(H=H, W=W)
        traj = traj_fn()
        rng = scene_rng(sname)
        imu_kwargs = make_imu_kwargs(rng)
        need_imu = any(c.startswith("vio") for c in config_names)
        print(f"[{sname}] rendering {args.frames} frames...",
              file=sys.stderr)
        seq = syn.generate_sequence(
            scene, traj, args.frames, fps=args.fps,
            imu_rate=200.0 if need_imu else 0.0,
            imu_kwargs=imu_kwargs if need_imu else None)
        init_gyro = init_accel = None
        if need_imu:
            init_gyro, init_accel = ev_util.static_init_imu(
                traj, rng=rng,
                gyro_bias=imu_kwargs.get("gyro_bias"),
                accel_bias=imu_kwargs.get("accel_bias"),
                gyro_noise=imu_kwargs.get("gyro_noise", 0.0),
                accel_noise=imu_kwargs.get("accel_noise", 0.0))
        for cname, ckw in CONFIGS:
            if cname not in config_names:
                continue
            res = ev_util.run_synthetic_sequence(
                seq, scene, capacity=args.capacity, window=args.window,
                levels=levels, cell_size=cell, detect_margin=margin,
                init_gyro=init_gyro if ckw["use_vio"] else None,
                init_accel=init_accel if ckw["use_vio"] else None,
                **ckw)
            row = dict(scene=sname, config=cname,
                       ate_rmse_m=round(res.ate_rmse, 4),
                       drift_pct=round(res.drift_pct, 3),
                       tracked=round(res.n_tracked_mean, 1),
                       ba_success=round(res.ba_success_rate, 3),
                       fps=round(res.fps, 1), skip=res.skip,
                       frames=args.frames)
            rows.append(row)
            print(f"[{sname}] {cname}: ATE {row['ate_rmse_m']:.4f} m  "
                  f"drift {row['drift_pct']:.2f}%  "
                  f"tracked {row['tracked']}  ba {row['ba_success']}  "
                  f"{row['fps']:.0f} fps", file=sys.stderr)

    # Markdown table
    print("\n| Scene | Config | ATE RMSE (m) | drift % | tracked | "
          "BA success | fps |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['scene']} | {r['config']} | {r['ate_rmse_m']:.4f} | "
              f"{r['drift_pct']:.2f} | {r['tracked']:.0f} | "
              f"{r['ba_success']:.2f} | {r['fps']:.0f} |")

    meta = dict(width=W, height=H, frames=args.frames, fps=args.fps,
                window=args.window, capacity=args.capacity,
                levels=levels, cell=cell, margin=margin,
                device=jax.devices()[0].platform, rows=rows)
    with open(args.json, "w") as f:
        json.dump(meta, f, indent=1)
    print(f"\nwrote {args.json}", file=sys.stderr)


if __name__ == "__main__":
    from rsvio_tpu.utils.cache import compilation_cache

    with compilation_cache():
        main()
