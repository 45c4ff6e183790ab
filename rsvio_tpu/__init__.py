"""rsvio_tpu — a stereo visual(-inertial) odometry engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
RS-VIO system (see SURVEY.md): multi-scale patch-based KLT feature tracking,
stereo matching, PnP motion tracking, keyframe selection, sliding-window bundle
adjustment with Schur-complement reduction, IMU preintegration, and a
distributed multi-chip BA mode — all expressed as pure functions over
fixed-shape device arrays so the whole per-frame step jit-compiles once.

Layout:
  ops/       device math: Lie groups, camera models, image sampling, pyramids,
             KLT patch tracking, feature detection
  models/    estimator logic: frontend tracker state machine, PnP, sliding
             window BA, IMU preintegration, per-frame estimator step
  parallel/  device meshes + sharded (multi-GPU) bundle adjustment
  data/      dataset players (EuRoC / TUM-VI / 4Seasons), async prefetch
  utils/     config, timing, trajectory export + ATE evaluation
  viewers/   visualization (rerun SDK when available, no-op otherwise)
  cli/       command-line entry points per dataset
"""

__version__ = "0.1.0"

# NOTE: importing this package is side-effect-free. GPU runs need full fp32
# matmuls, not TF32 (see utils/precision.py); every entry point (CLI, bench,
# examples, tools) calls utils.precision.ensure_matmul_precision()
# explicitly instead of this __init__ mutating process-global JAX config on
# import.
