"""End-to-end demo: stereo VO on a synthetic textured-plane sequence.

Renders a stereo camera translating sideways in front of a textured plane at
known depth, runs the full estimator (tracking -> triangulation -> PnP -> BA),
and compares the recovered trajectory to ground truth.

Usage: python examples/synthetic_vo.py [--frames N]
(JAX_PLATFORMS=cpu to force the CPU when a GPU is present)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--step", type=float, default=0.02, help="m per frame in x")
    args = ap.parse_args()

    from rsvio_tpu.utils.precision import ensure_matmul_precision
    ensure_matmul_precision()
    import jax.numpy as jnp
    import numpy as np

    from rsvio_tpu.models import estimator as est
    from rsvio_tpu.models.frontend import FrontendConfig
    from rsvio_tpu.ops import cameras
    from rsvio_tpu.ops.klt import KLTConfig

    H, W = 240, 320
    FX = FY = 200.0
    CX, CY = W / 2, H / 2
    BASELINE = 0.11
    PLANE_Z = 5.0

    from rsvio_tpu.data.synthetic import remap_linear, resize_cubic

    # Big smooth random texture indexed by world (x, y) on the plane.
    rng = np.random.default_rng(0)
    tex = resize_cubic(rng.uniform(40, 220, (96, 96)).astype(np.float32),
                       1536, 1536)
    TEX_SCALE = 100.0  # pixels per meter on the plane
    TEX_OFF = 600.0

    def render(cam_t):
        """Render the plane from a camera at world position cam_t (no rot)."""
        u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                           np.arange(H, dtype=np.float32))
        x = (u - CX) / FX
        y = (v - CY) / FY
        Xw = x * (PLANE_Z - cam_t[2]) + cam_t[0]
        Yw = y * (PLANE_Z - cam_t[2]) + cam_t[1]
        mx = (Xw * TEX_SCALE + TEX_OFF).astype(np.float32)
        my = (Yw * TEX_SCALE + TEX_OFF).astype(np.float32)
        return remap_linear(tex, mx, my, border="reflect")

    params = cameras.pack_params(cameras.PINHOLE_RADTAN,
                                 [FX, FY, CX, CY], [0, 0, 0, 0])
    T_B_Cl = jnp.eye(4, dtype=jnp.float32)
    T_B_Cr = jnp.eye(4, dtype=jnp.float32).at[0, 3].set(BASELINE)
    rig = est.make_rig(params, params, T_B_Cl, T_B_Cr)

    cfg = est.EstimatorConfig(
        frontend=FrontendConfig(capacity=128, cell_size=40, detect_margin=12,
                                klt=KLTConfig(levels=4)),
        window_size=6,
        translation_threshold=0.03,
        rotation_threshold=0.05,
        image_shape=(H, W),
    )
    step = est.make_estimator_step(cfg)
    state = est.init_state(cfg)

    print("compiling + running...")
    gt, rec = [], []
    t0 = time.time()
    for k in range(args.frames):
        cam = np.array([args.step * k, 0.0, 0.0])
        img_l = render(cam)
        img_r = render(cam + np.array([BASELINE, 0, 0]))
        state, out = step(state, rig, jnp.asarray(img_l), jnp.asarray(img_r))
        p = np.asarray(out.T_W_B[:3, 3])
        gt.append(cam.copy())
        rec.append(p)
        print(f"frame {k:3d} kf={int(out.is_keyframe)} "
              f"pnp={int(out.pnp_success)} ba={int(out.ba_success)} "
              f"tracked={int(out.n_tracked)} lm={int(out.n_landmarks)} "
              f"pos=[{p[0]:+.3f} {p[1]:+.3f} {p[2]:+.3f}] gt_x={cam[0]:+.3f}")
    dt = time.time() - t0
    gt = np.array(gt)
    rec = np.array(rec)

    # Evaluate on the second half (after the window fills and BA engages),
    # aligning start positions.
    half = args.frames // 2
    d_gt = gt[-1] - gt[half]
    d_rec = rec[-1] - rec[half]
    err = np.linalg.norm(d_rec - d_gt)
    rel = err / max(np.linalg.norm(d_gt), 1e-9)
    print(f"\n{args.frames} frames in {dt:.1f}s "
          f"({args.frames / dt:.2f} fps incl. compile)")
    print(f"GT displacement (2nd half):  {d_gt}")
    print(f"Est displacement (2nd half): {d_rec}")
    print(f"error {err:.4f} m ({rel * 100:.1f}% of GT displacement)")
    ok = rel < 0.2
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    from rsvio_tpu.utils.cache import compilation_cache

    with compilation_cache():
        sys.exit(main())
