"""Window-solver timing on the current device: plain BA, marginalized BA,
VIO BA, marginalized VIO BA at production shapes (W=10, L=256).

Each solver is forced to run its full LM iteration budget (cost/param tols
set to 0) so the numbers are iteration-cost, not convergence-speed. Timing is
PIPELINED (submit n, block once), so host dispatch overlaps device work.
The problem is rsvio_tpu.parity.window_problem.

Run on the GPU: python tools/bench_solvers.py
Run on the CPU: JAX_PLATFORMS=cpu python tools/bench_solvers.py
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

W_KF = 10
N_LM = 256


def timeit_pipelined(fn, n=20, warmup=3):
    import jax
    for _ in range(warmup):
        out = fn()
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.time() - t0) / n * 1000.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=20)
    ap.add_argument("--lm", type=int, default=None, help="landmark slots")
    ap.add_argument("--window", type=int, default=None, help="keyframe window")
    args = ap.parse_args()
    global N_LM, W_KF
    if args.lm:
        N_LM = args.lm
    if args.window:
        W_KF = args.window
    from rsvio_tpu.utils.precision import ensure_matmul_precision
    ensure_matmul_precision()
    import jax
    import jax.numpy as jnp

    from rsvio_tpu.models import ba, vio_ba
    from rsvio_tpu.models.marginalization import empty_prior
    from rsvio_tpu.parity import window_problem

    print("devices:", jax.devices())
    (state0, T_C_B, lms0, obs, mask, lm_valid, pre, pre_valid) = window_problem(0, W_KF, N_LM)
    W = W_KF

    # Full-trip LM (no early convergence exit) -> per-iteration cost numbers.
    cfg_ba = ba.BAConfig(cost_tol=0.0, param_tol=0.0)
    cfg_vio = vio_ba.VIOBAConfig(cost_tol=0.0, param_tol=0.0)

    t = timeit_pipelined(lambda: ba.solve_ba(
        state0.T_W_B, T_C_B, lms0, obs, mask, lm_valid, cfg_ba), n=args.n)
    print(f"BA {W_KF}x{N_LM} (20 it):            {t:8.2f} ms")

    prior6 = empty_prior(W, 6)
    t = timeit_pipelined(lambda: ba.solve_ba_marginalized(
        state0.T_W_B, T_C_B, lms0, obs, mask, lm_valid, prior6,
        jnp.asarray(True), cfg_ba), n=args.n)
    print(f"BA+marg {W_KF}x{N_LM} (20 it):       {t:8.2f} ms")

    t = timeit_pipelined(lambda: vio_ba.solve_vio_ba(
        state0, T_C_B, lms0, obs, mask, lm_valid, pre, pre_valid, cfg_vio),
        n=args.n)
    print(f"VIO BA {W_KF}x{N_LM} (20 it):        {t:8.2f} ms")

    prior15 = empty_prior(W, 15)
    t = timeit_pipelined(lambda: vio_ba.solve_vio_ba_marginalized(
        state0, T_C_B, lms0, obs, mask, lm_valid, pre, pre_valid, prior15,
        jnp.asarray(True), cfg_vio), n=args.n)
    print(f"VIO BA+marg {W_KF}x{N_LM} (20 it):   {t:8.2f} ms")


if __name__ == "__main__":
    from rsvio_tpu.utils.cache import compilation_cache

    with compilation_cache():
        main()
