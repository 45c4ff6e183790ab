"""Cross-device parity: the same inputs through the same jitted code on two
devices, compared against stated tolerances.

chip_smoke.py runs these checks with the GPU against JAX's CPU backend at
the EuRoC widths; the tests run them CPU against CPU at small sizes. Every
check returns a dict of measured differences plus `ok`.

Tolerances (float32 on both sides; the GPU runs matmuls at precision
"highest", so no TF32). What differs between the devices is the order of
summation in XLA's reductions and the fused arithmetic of gathers, a few
ulps per operation. Those differences compound through iterative solves:

  * tracker: a track whose Gauss-Newton step sits at the convergence
    threshold may stop one iteration earlier or later, moving it by less
    than the threshold (0.01 px), so positions of tracks alive on both
    devices agree to TRACK_POS_PX = 0.02 px. A track at the edge of the
    bidirectional gate or the bounds test may live on one device only: at
    most TRACK_MASK_FLIPS slots per camera.
  * window solves: LM converges to the same minimum of a well-posed
    problem; poses agree to SOLVE_POSE (rotation entries and metres),
    landmarks to SOLVE_LM metres, final costs to SOLVE_COST of the initial
    cost (a noise-free problem converges to a cost at float32 noise, so a
    ratio of final costs would compare noise).
  * VO frames: a flipped track changes the landmark set, so the estimated
    positions over VO_FRAMES frames agree to VO_POS metres.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

TRACK_POS_PX = 0.02
TRACK_MASK_FLIPS = 4
SOLVE_POSE = 1e-3
SOLVE_LM = 5e-3
SOLVE_COST = 1e-2
VO_POS = 1e-2
VO_FRAMES = 15
SHARDED_POSE = 1e-3
SHARDED_PRIOR = 5e-3

KF_DT = 0.25
IMU_HZ = 200.0


def on_device(fn: Callable, args, device):
    """fn(*args) with every input placed on `device`; numpy outputs."""
    import jax

    with jax.default_device(device):
        out = fn(*jax.device_put(args, device))
        return jax.tree_util.tree_map(np.asarray, jax.block_until_ready(out))


def window_problem(seed: int = 0, n_kf: int = 10, n_lm: int = 256):
    """A synthetic sliding-window solve: n_kf keyframes moving at constant
    velocity, n_lm landmarks seen by a stereo rig, IMU preintegrated
    between keyframes, poses/velocities/landmarks perturbed from the truth.

    Returns (state0, T_C_B, lms0, obs, mask, lm_valid, pre, pre_valid)."""
    import jax
    import jax.numpy as jnp

    from .models import imu, vio_ba
    from .ops import lie

    rng = np.random.default_rng(seed)
    g = np.array([0.0, 0.0, -imu.GRAVITY])
    v_const = np.array([0.4, 0.1, 0.0])
    T_C_B = jnp.stack([
        jnp.eye(4, dtype=jnp.float32),
        jnp.eye(4, dtype=jnp.float32).at[0, 3].set(-0.11),
    ])
    T_gt = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    T_gt[:, :3, 3] = v_const * KF_DT * np.arange(n_kf)[:, None]
    v_gt = np.tile(v_const.astype(np.float32), (n_kf, 1))

    n_s = int(KF_DT * IMU_HZ)
    gyro = np.zeros((n_kf - 1, n_s, 3), np.float32)
    accel = np.tile((-g).astype(np.float32), (n_kf - 1, n_s, 1))
    dts = np.full((n_kf - 1, n_s), 1.0 / IMU_HZ, np.float32)
    zb = jnp.zeros(3)
    pre = jax.vmap(
        lambda gy, ac, d, m: imu.preintegrate(gy, ac, d, m, zb, zb))(
        jnp.asarray(gyro), jnp.asarray(accel), jnp.asarray(dts),
        jnp.ones((n_kf - 1, n_s), bool))

    p_gt = np.stack([rng.uniform(-2, 3, n_lm), rng.uniform(-2, 2, n_lm),
                     rng.uniform(3, 8, n_lm)], axis=1).astype(np.float32)
    obs = np.zeros((n_kf, 2, n_lm, 2), np.float32)
    mask = np.zeros((n_kf, 2, n_lm), bool)
    for i in range(n_kf):
        R_B_W = T_gt[i, :3, :3].T
        p_B = (R_B_W @ (p_gt - T_gt[i, :3, 3]).T)
        for c in range(2):
            Tcb = np.asarray(T_C_B[c])
            pC = (Tcb[:3, :3] @ p_B + Tcb[:3, 3:4]).T
            ok = pC[:, 2] > 0.5
            obs[i, c, ok] = pC[ok, :2] / pC[ok, 2:3]
            mask[i, c] = ok

    poses = T_gt.copy()
    for i in range(1, n_kf):
        dR = np.asarray(lie.so3_exp(jnp.asarray(
            rng.normal(size=3) * 0.01, dtype=jnp.float32)))
        poses[i, :3, :3] = poses[i, :3, :3] @ dR
        poses[i, :3, 3] += rng.normal(size=3) * 0.02
    state0 = vio_ba.VIOState(
        T_W_B=jnp.asarray(poses),
        vel=jnp.asarray(v_gt + rng.normal(size=(n_kf, 3)) * 0.05,
                        dtype=jnp.float32),
        bg=jnp.zeros((n_kf, 3), jnp.float32),
        ba=jnp.zeros((n_kf, 3), jnp.float32))
    lms0 = jnp.asarray(p_gt + rng.normal(size=p_gt.shape) * 0.05,
                       dtype=jnp.float32)
    return (state0, T_C_B, lms0, jnp.asarray(obs), jnp.asarray(mask),
            jnp.ones(n_lm, bool), pre, jnp.ones(n_kf - 1, bool))


def _solve_diffs(a_T, b_T, a_lm, b_lm, a_res, b_res) -> Dict:
    cost = abs(float(a_res.final_cost) - float(b_res.final_cost)) / max(
        abs(float(a_res.initial_cost)), 1e-12)
    d = {"pose": float(np.abs(a_T - b_T).max()),
         "landmark": float(np.abs(a_lm - b_lm).max()),
         "cost_vs_initial": cost,
         "iterations": (int(a_res.iterations), int(b_res.iterations)),
         "success": (bool(a_res.success), bool(b_res.success))}
    d["ok"] = bool(all(d["success"]) and d["pose"] <= SOLVE_POSE
                   and d["landmark"] <= SOLVE_LM and cost <= SOLVE_COST)
    return d


def solve_ba_parity(dev_a, dev_b, seed: int = 0, n_kf: int = 10,
                    n_lm: int = 256) -> Dict:
    from .models import ba

    st, T_C_B, lms, obs, mask, valid, _, _ = window_problem(seed, n_kf, n_lm)
    args = (st.T_W_B, T_C_B, lms, obs, mask, valid)
    a = on_device(ba.solve_ba, args, dev_a)
    b = on_device(ba.solve_ba, args, dev_b)
    return _solve_diffs(a.T_W_B, b.T_W_B, a.landmarks, b.landmarks, a, b)


def solve_vio_ba_parity(dev_a, dev_b, seed: int = 0, n_kf: int = 10,
                        n_lm: int = 256) -> Dict:
    from .models import vio_ba

    args = window_problem(seed, n_kf, n_lm)
    a = on_device(vio_ba.solve_vio_ba, args, dev_a)
    b = on_device(vio_ba.solve_vio_ba, args, dev_b)
    return _solve_diffs(a.state.T_W_B, b.state.T_W_B, a.landmarks,
                        b.landmarks, a, b)


def corners(img, n: int, cell: int = 25, margin: int = 19,
            min_score: float = 10.0):
    """The n strongest FAST corners, one per grid cell, as the frontend
    detects them (computed on the CPU backend). Returns (pos (n,2), alive
    (n,)); slots beyond the corners found are dead."""
    import jax
    import jax.numpy as jnp

    from .ops import detect

    with jax.default_device(jax.devices("cpu")[0]):
        score = detect.fast_score(jnp.asarray(img, jnp.float32))
        xy, ok = detect.select_grid_features(
            score, jnp.zeros((1, 2)), jnp.zeros(1, bool), cell,
            margin=margin, min_score=min_score)
        xy, ok, score = np.asarray(xy), np.asarray(ok), np.asarray(score)
    s = np.where(ok, score[xy[:, 1].astype(int), xy[:, 0].astype(int)],
                 -np.inf)
    best = np.argsort(-s, kind="stable")[:n]
    pos = np.zeros((n, 2), np.float32)
    alive = np.zeros(n, bool)
    pos[:len(best)] = xy[best]
    alive[:len(best)] = ok[best]
    return pos, alive


def tracker_inputs(frames, n: int):
    """Stereo frames (prev, cur) -> arguments of the stereo tracker pass:
    n feature slots per camera on the previous frame's FAST corners."""
    (l0, r0), (l1, r1) = frames
    pos0, alive0 = corners(l0, n)
    pos1, alive1 = corners(r0, n)
    return (l0, r0, l1, r1, pos0, pos1, alive0 & alive1)


def tracker_pass(klt_cfg):
    """Jitted stereo pass on images: pyramids, then both cameras' temporal
    bidirectional tracks (what the frontend runs once per frame)."""
    import jax

    from .ops import klt, pyramid

    def run(l0, r0, l1, r1, pos0, pos1, alive):
        pyr = [pyramid.build_pyramid(im, klt_cfg.levels)
               for im in (l0, r0, l1, r1)]
        return klt.track_points_bidirectional_stereo(
            pyr[0], pyr[1], pyr[2], pyr[3], pos0, pos1, alive, klt_cfg)

    return jax.jit(run)


def tracker_parity(dev_a, dev_b, frames, klt_cfg, n: int = 256) -> Dict:
    args = tracker_inputs(frames, n)
    fn = tracker_pass(klt_cfg)
    a = on_device(fn, args, dev_a)
    b = on_device(fn, args, dev_b)
    d = {}
    for cam, (ip, iok) in (("cam0", (0, 2)), ("cam1", (3, 5))):
        both = a[iok] & b[iok]
        d[f"{cam}_alive"] = (int(a[iok].sum()), int(b[iok].sum()))
        d[f"{cam}_mask_flips"] = int((a[iok] != b[iok]).sum())
        d[f"{cam}_pos_px"] = (float(np.abs(a[ip][both] - b[ip][both]).max())
                              if both.any() else 0.0)
    d["ok"] = bool(
        all(d[f"{c}_mask_flips"] <= TRACK_MASK_FLIPS
            and d[f"{c}_pos_px"] <= TRACK_POS_PX for c in ("cam0", "cam1"))
        and min(d["cam0_alive"] + d["cam1_alive"]) >= n // 2)
    return d


def vo_parity(dev_a, dev_b, frames, ecfg, rig) -> Dict:
    """The VO step over `frames` on both devices: per-frame positions."""
    import jax

    from .models import estimator as est

    step = est.make_estimator_step(ecfg)

    def run(device):
        with jax.default_device(device):
            state = est.init_state(ecfg)
            r = jax.device_put(rig, device)
            pos, tracked = [], []
            for left, right in frames:
                state, out = step(state, r, jax.device_put(left, device),
                                  jax.device_put(right, device))
                pos.append(np.asarray(out.T_W_B[:3, 3]))
                tracked.append(int(out.n_tracked))
            return np.asarray(pos), np.asarray(tracked)

    pa, ta = run(dev_a)
    pb, tb = run(dev_b)
    d = {"frames": len(frames),
         "pos_m": float(np.abs(pa - pb).max()),
         "final_pos_m": float(np.abs(pa[-1] - pb[-1]).max()),
         "tracked_last": (int(ta[-1]), int(tb[-1])),
         "tracked_max_diff": int(np.abs(ta - tb).max())}
    d["ok"] = bool(np.isfinite(pa).all() and np.isfinite(pb).all()
                   and d["pos_m"] <= VO_POS)
    return d


def sharded_solver_parity(mesh, seed: int = 0, n_kf: int = 10,
                          n_lm: int = 1024) -> Dict:
    """The four landmark-sharded window solvers over `mesh` against their
    single-device solvers on the mesh's first device."""
    import jax
    import jax.numpy as jnp

    from .models import ba, vio_ba
    from .models.marginalization import empty_prior
    from .parallel import dist_ba, dist_vio_ba

    st, T_C_B, lms, obs, mask, valid, pre, pre_valid = window_problem(
        seed, n_kf, n_lm)
    evict = jnp.asarray(True)
    vis = (T_C_B, lms, obs, mask, valid)
    vio = vis + (pre, pre_valid)
    # name -> (sharded solve, local solve, returns a marginalization prior)
    cases = {
        "ba": (lambda: dist_ba.solve_ba_distributed(mesh, st.T_W_B, *vis),
               lambda: ba.solve_ba(st.T_W_B, *vis), False),
        "ba_marg": (lambda: dist_ba.solve_ba_marginalized_distributed(
                        mesh, st.T_W_B, *vis, empty_prior(n_kf, 6), evict),
                    lambda: ba.solve_ba_marginalized(
                        st.T_W_B, *vis, empty_prior(n_kf, 6), evict), True),
        "vio_ba": (lambda: dist_vio_ba.solve_vio_ba_distributed(
                       mesh, st, *vio),
                   lambda: vio_ba.solve_vio_ba(st, *vio), False),
        "vio_ba_marg": (
            lambda: dist_vio_ba.solve_vio_ba_marginalized_distributed(
                mesh, st, *vio, empty_prior(n_kf, 15), evict),
            lambda: vio_ba.solve_vio_ba_marginalized(
                st, *vio, empty_prior(n_kf, 15), evict), True),
    }
    dev0 = mesh.devices.flat[0]
    out: Dict = {}
    for name, (sharded, local, with_prior) in cases.items():
        a = jax.tree_util.tree_map(np.asarray, sharded())
        with jax.default_device(dev0):
            b = jax.tree_util.tree_map(np.asarray, local())
        if with_prior:
            (a, prior_a), (b, prior_b) = a, b
        poses = [r.T_W_B if hasattr(r, "T_W_B") else r.state.T_W_B
                 for r in (a, b)]
        d = {"pose": float(np.abs(poses[0] - poses[1]).max()),
             "success": (bool(a.success), bool(b.success)),
             "iterations": (int(a.iterations), int(b.iterations))}
        ok = all(d["success"]) and d["pose"] <= SHARDED_POSE
        if with_prior:
            scale = max(1.0, float(np.abs(prior_b.H).max()))
            d["prior_H_rel"] = float(
                np.abs(prior_a.H - prior_b.H).max()) / scale
            ok = (ok and bool(prior_a.valid)
                  and d["prior_H_rel"] <= SHARDED_PRIOR)
        d["ok"] = bool(ok)
        out[name] = d
    out["ok"] = all(v["ok"] for v in out.values())
    return out


def sharded_step_parity(mesh, frames, ecfg, rig, vcfg=None,
                        imu_frames=None) -> Dict:
    """A few frames of the distributed VO (and, given vcfg and per-frame
    IMU buffers, VIO) estimator step against the single-device step on the
    mesh's first device: final positions and the number of sharded solves."""
    import jax

    from .models import estimator as est
    from .models import estimator_vio as ev
    from .parallel.dist_estimator import (make_distributed_estimator_step,
                                          make_distributed_vio_estimator_step)

    runs = {"vo": (make_distributed_estimator_step(ecfg, mesh),
                   est.make_estimator_step(ecfg),
                   lambda: est.init_state(ecfg), lambda k: ())}
    if vcfg is not None:
        runs["vio"] = (make_distributed_vio_estimator_step(vcfg, mesh),
                       ev.make_vio_estimator_step(vcfg),
                       lambda: ev.init_vio_state(vcfg),
                       lambda k: imu_frames[k])
    dev0 = mesh.devices.flat[0]
    out: Dict = {}
    for name, (dstep, lstep, init, extra) in runs.items():
        res = []
        for step in (dstep, lstep):
            with jax.default_device(dev0):
                state, n_ba, pos = init(), 0, []
                for k, (left, right) in enumerate(frames):
                    state, o = step(state, rig, left, right, *extra(k))
                    n_ba += int(o.ba_success)
                    pos.append(np.asarray(o.T_W_B[:3, 3]))
            res.append((np.asarray(pos), n_ba))
        (pa, ba_a), (pb, ba_b) = res
        d = {"frames": len(frames), "ba_fires": (ba_a, ba_b),
             "pos_m": float(np.abs(pa - pb).max())}
        d["ok"] = bool(ba_a >= 1 and np.isfinite(pa).all()
                       and d["pos_m"] <= VO_POS)
        out[name] = d
    out["ok"] = all(v["ok"] for v in out.values())
    return out
