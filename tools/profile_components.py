"""Per-component timing on the current device: dispatch latency, pyramid,
KLT tracking, detection, PnP, BA — to find where the frame budget goes.

Run on the GPU: python tools/profile_components.py
Run on the CPU: JAX_PLATFORMS=cpu python tools/profile_components.py
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(fn, *args, n=10, warmup=2):
    import jax
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.time()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / n * 1000.0


def main():
    argparse.ArgumentParser(description=__doc__).parse_args()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rsvio_tpu.models import ba, pnp
    from rsvio_tpu.ops import detect, klt, lie, pyramid

    print("devices:", jax.devices())
    rng = np.random.default_rng(0)
    H, W = 480, 752
    img = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))

    # 0. dispatch latency
    f_add = jax.jit(lambda x: x + 1.0)
    print(f"dispatch (trivial add): {timeit(f_add, img, n=20):8.2f} ms")

    # 1. pyramid
    f_pyr = jax.jit(lambda im: pyramid.build_pyramid(im, 6))
    print(f"pyramid 6 levels:       {timeit(f_pyr, img):8.2f} ms")
    pyr = f_pyr(img)

    # 2. detection
    f_det = jax.jit(detect.fast_score)
    print(f"fast_score:             {timeit(f_det, img):8.2f} ms")
    f_st = jax.jit(detect.shi_tomasi_score)
    print(f"shi_tomasi_score:       {timeit(f_st, img):8.2f} ms")

    # 3. KLT tracking (256 features, 6 levels, 20 iters, bidirectional)
    N = 256
    pts = jnp.asarray(rng.uniform([30, 30], [W - 30, H - 30],
                                  size=(N, 2)).astype(np.float32))
    alive = jnp.ones(N, dtype=bool)
    cfg = klt.KLTConfig(levels=6, max_iterations=20)
    t = timeit(lambda: klt.track_points_bidirectional(pyr, pyr, pts, alive, cfg),
               n=5)
    print(f"KLT bidir 256 feats:    {t:8.2f} ms")
    cfg8 = klt.KLTConfig(levels=6, max_iterations=8)
    t = timeit(lambda: klt.track_points_bidirectional(pyr, pyr, pts, alive, cfg8),
               n=5)
    print(f"KLT bidir (8 iters):    {t:8.2f} ms")

    # 4. PnP
    L = 256
    lms = jnp.asarray(np.stack([rng.uniform(-2, 2, L), rng.uniform(-2, 2, L),
                                rng.uniform(3, 8, L)], 1).astype(np.float32))
    obs = lms[:, :2] / lms[:, 2:3]
    obs2 = jnp.stack([obs, obs])
    mask = jnp.ones((2, L), dtype=bool)
    T_C_B = jnp.stack([jnp.eye(4, dtype=jnp.float32),
                       jnp.eye(4, dtype=jnp.float32).at[0, 3].set(-0.11)])
    T0 = jnp.eye(4, dtype=jnp.float32)
    t = timeit(lambda: pnp.solve_pnp(T0, T_C_B, lms, obs2, mask), n=5)
    print(f"PnP 256 lms:            {t:8.2f} ms")

    # 5. BA (10 KF x 256 lms)
    WKF = 10
    poses = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (WKF, 4, 4))
    obs_w = jnp.broadcast_to(obs2[None], (WKF, 2, L, 2))
    mask_w = jnp.ones((WKF, 2, L), dtype=bool)
    lm_valid = jnp.ones(L, dtype=bool)
    t = timeit(lambda: ba.solve_ba(poses, T_C_B, lms, obs_w, mask_w, lm_valid),
               n=3)
    print(f"BA 10x256:              {t:8.2f} ms")


if __name__ == "__main__":
    main()
