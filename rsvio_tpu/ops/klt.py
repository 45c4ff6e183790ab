"""Batched inverse-compositional KLT patch tracking — the front-end hot loop.

Capability parity (SURVEY.md §2 #12-13): the reference tracks each feature
with an SE2 inverse-compositional Gauss-Newton solve over a mean-normalized
(brightness-invariant) sparse 52-point patch, coarse-to-fine over a 6-level
pyramid, with a bidirectional consistency gate
(ref src/feature_tracker/feature_tracker.rs:252-395, src/feature_tracker/patch.rs).

Design (a re-design, not a translation):
  * The patch is a dense 8x8 grid (64 points, spacing 2 px → ±7 px footprint,
    same coverage class as the reference's 52-point circular pattern) — a
    fixed power-of-two layout that vectorizes cleanly, in the spirit of the
    reference's own DensePatch experiment
    (ref feature_tracker/src/patch.rs:219-229 row-span layout).
  * The reference parallelizes with rayon par_iter over points; here the WHOLE
    feature table is one batched computation: vmap over N features, lax.fori_loop
    over GN iterations with masked convergence, Python-unrolled loop over the 6
    static pyramid levels. One jit-compiled call tracks every feature.
  * All failure modes (out-of-bounds, degenerate patch, non-finite step,
    too-few valid residuals) fold into a per-feature alive mask instead of
    early returns.

State per tracked point: target position (2,) in full-res pixels + 2x2 linear
part (rotation/affine) of the patch warp, as in the reference tracker
(ref src/feature_tracker/feature_tracker.rs:91-100 Affine2 track states).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import interp
from .lie import se2_exp

# Dense 8x8 pattern, spacing 2 px: offsets in {-7,-5,-3,-1,1,3,5,7}^2.
_coords = jnp.arange(8, dtype=jnp.float32) * 2.0 - 7.0
PATTERN = jnp.stack(
    [jnp.tile(_coords, 8), jnp.repeat(_coords, 8)], axis=1
)  # (64, 2) as (x, y)
PATTERN_SIZE = PATTERN.shape[0]

# Minimum fraction of TEMPLATE-valid points that must also be valid in the
# target for a trustworthy update. The reference requires >26 of 52 shared
# points (ref src/feature_tracker/patch.rs:224-228) — >50% of the full
# pattern, which its templates nearly always are; making the count relative
# to the template's own valid points generalizes that rule to the partial
# patches the reference explicitly supports (out-of-bounds pattern points get
# data = -1 and a zero Jacobian row, ref patch.rs:96-121). Without partial
# patches, coarse pyramid levels (e.g. level 5 of 752x480 = 23x15 px) would
# invalidate nearly every feature — the patch footprint (+-7 px) barely fits.
_MIN_SHARED_FRAC = 0.5
# Absolute floor of template-valid points: enough to condition the 3-dof
# IC-GN system with margin.
_MIN_TEMPLATE_PTS = 8


class KLTConfig(NamedTuple):
    """Static tracking configuration (hashable -> usable as jit static arg)."""
    max_iterations: int = 20          # ref config optical_flow_max_iterations
    convergence_threshold: float = 0.01  # ref optical_flow_convergence_threshold
    levels: int = 6                   # ref estimator.rs:27 StereoPatchTracker<6>
    bidir_threshold_sq: float = 0.4   # px^2, ref feature_tracker.rs:280
    bounds_margin: float = 2.0        # ref feature_tracker.rs:389
    # Warp model. False (default) = 2-dof translation; True = 3-dof SE2
    # with an exact bilinear rotation warp like the reference's Pattern52
    # (arbitrary angle).
    # The 2-dof default is an accuracy decision, not just a speed one: on
    # fine-grained/weak texture the SE2 Hessian's rotation column is poorly
    # conditioned and the 3x3 IC solve smears error into translation
    # (measured: 0.24-0.6 px median flow error and ~50% bidirectional-gate
    # kill rate vs 0.017 px / ~0% for the 2-dof solve on the same scene;
    # per-frame patch rotation is sub-degree on the target datasets).
    track_rotation: bool = False
    # Residual model (parity with the reference experimental
    # crate's Patch SSD / locally-scaled-SSD options, ref
    # feature_tracker/src/patch.rs:57-105):
    #   "lssd": mean-normalized intensities (brightness/gain invariant —
    #           the main tracker's Pattern52 behavior and the default),
    #   "ssd":  raw intensity difference (plain SSD).
    residual_mode: str = "lssd"
    # Fixed Levenberg damping added to the precomputed IC-GN Hessian:
    # inc = -(J^T J + lm_lambda I)^-1 J^T r (parity with the
    # experimental crate's precomputed (lambda I + J^T J)^-1 LM-KLT,
    # ref feature_tracker/src/patch.rs:239-255). 0 = pure Gauss-Newton.
    lm_lambda: float = 0.0
    # Patch sampling during BOTH template construction and tracking:
    # "bilinear" (the main tracker's Pattern52 behavior) or "bicubic"
    # (Catmull-Rom with analytic gradients — the experimental crate tracks
    # WITH bicubic sampling, ref
    # feature_tracker/src/feature_tracker/feature_tracking.rs:129-192 calling
    # d_interpolate_bicubic, image_operations.rs:140-229).
    interpolation: str = "bilinear"
    # Coarse-level failure policy. "strict" (reference parity): any level
    # failing — including a BORDER feature whose coordinates shrink below
    # the patch footprint at coarse levels (x=40 px at level 5 of a 6-level
    # pyramid is 1.25 px: unusable) — kills the whole track, exactly the
    # reference's early return (ref feature_tracker.rs:305-331).
    # "tolerant": a failed coarse level is SKIPPED (position carried to the
    # next-finer level); only the finest level must succeed, and the
    # bidirectional gate still arbitrates. Recovers tracking in border
    # regions the reference structurally cannot track — when the only
    # texture left is near the image edge (measured: the easy_plane
    # tracking desert), strict mode drops to zero tracks. DEFAULT: tolerant
    # — measured on the full-res matrix (CPU sweep, with score weighting):
    # easy_plane ATE 0.132 -> 0.0006, depth 0.026 -> 0.0095, photometric
    # 0.026 -> 0.0115, occlusion within noise; track occupancy +30%. Set
    # "strict" for reference-behavior comparisons.
    coarse_level_policy: str = "tolerant"
    # Per-level downscale of the pyramid the tracker is fed (parity with the
    # experimental crate's arbitrary-ratio pyramids, ref
    # feature_tracker/src/image_operations.rs:47-78 + the per-level
    # center-point scaling at feature_tracking.rs:88-122). Level l positions
    # are full-res positions times pyramid_ratio^l. Must match the pyramid
    # builder (ops.pyramid.build_pyramid -> 0.5; build_pyramid_ratio -> its
    # ratio argument).
    pyramid_ratio: float = 0.5


class PatchData(NamedTuple):
    data: jnp.ndarray      # (P,) mean-normalized template intensities
    hinv_jt: jnp.ndarray   # (3, P) precomputed H^-1 J^T
    valid_pts: jnp.ndarray  # (P,) bool per-point validity
    ok: jnp.ndarray        # () bool patch usable


def build_patch(img, center, residual_mode: str = "lssd",
                lm_lambda: float = 0.0, n_dof: int = 3,
                interpolation: str = "bilinear"):
    """Extract a patch template + precomputed IC step operator at `center`.

    Equivalent capability to Pattern52::new (ref src/feature_tracker/patch.rs:75-161):
    sample intensity+gradient per pattern point, build the warp jacobian, and
    precompute (J^T J + lm_lambda I)^-1 J^T.

    residual_mode "lssd" mean-normalizes intensities for brightness/gain
    invariance (the main tracker's behavior) with the jacobian corrected for
    the normalization; "ssd" keeps raw intensities (plain SSD, the
    experimental crate's alternative residual, ref
    feature_tracker/src/patch.rs:57-105). lm_lambda > 0 is the experimental
    crate's precomputed fixed-damping LM step (ref patch.rs:239-255).

    n_dof: 2 = translation-only (a pure 2x2 solve; the returned operator's
    rotation row is zero), 3 = full SE2 like the reference's Pattern52. The
    2-dof operator is NOT just the SE2 one with the angle discarded — see
    KLTConfig.track_rotation for why that distinction matters on weak
    texture.
    """
    pts = center[None, :] + PATTERN  # (P, 2)
    sample_grad = (interp.bicubic_with_grad if interpolation == "bicubic"
                   else interp.bilinear_with_grad)
    vals, grads, valid = jax.vmap(sample_grad, in_axes=(None, 0))(img, pts)
    validf = valid.astype(img.dtype)
    n_valid = jnp.sum(validf)
    n_safe = jnp.maximum(n_valid, 1.0)
    mean = jnp.sum(vals * validf) / n_safe
    mean_safe = jnp.maximum(mean, 1e-6)

    # Warp jacobian at offset (x, y): dW/d[tx,ty,theta] = [[1,0,-y],[0,1,x]]
    gx, gy = grads[:, 0], grads[:, 1]
    if n_dof == 2:
        j_raw = jnp.stack([gx, gy], axis=1)                         # (P, 2)
    else:
        ox, oy = PATTERN[:, 0], PATTERN[:, 1]
        j_raw = jnp.stack([gx, gy, gx * (-oy) + gy * ox], axis=1)   # (P, 3)
    j_raw = j_raw * validf[:, None]

    if residual_mode == "ssd":
        data = jnp.where(valid, vals, 0.0)
        jac = j_raw
        mean_ok = jnp.asarray(True)
    else:  # lssd
        data = jnp.where(valid, vals / mean_safe, 0.0)
        # Correct for mean normalization: Jn_i = (1/mu)(J_i - data_i * mean_J)
        mean_j = jnp.sum(j_raw, axis=0) / n_safe
        jac = (j_raw - data[:, None] * mean_j[None, :]) / mean_safe
        jac = jac * validf[:, None]
        mean_ok = mean > 1e-3

    H = jac.T @ jac
    # The reference declares a patch invalid when Cholesky of J^T J fails
    # (ref patch.rs:124-161); the branchless equivalent is a minimum
    # gradient-energy gate before adding numerical damping. SSD intensities
    # are ~255x the normalized ones, so the energy floor scales accordingly.
    energy = jnp.trace(H)
    energy_floor = 1e-4 if residual_mode != "ssd" else 1e-4 * 255.0**2
    H = H + (1e-8 + lm_lambda) * jnp.eye(n_dof, dtype=img.dtype)
    hinv_jt = jnp.linalg.solve(H, jac.T)  # (n_dof, P)
    if n_dof == 2:
        hinv_jt = jnp.concatenate(
            [hinv_jt, jnp.zeros((1, PATTERN_SIZE), img.dtype)])
    # Validity: center in-bounds (margin 2, the reference's inbound check —
    # ref image_utilities.rs:68-80) + enough valid points to condition the
    # 3-dof system; partial border patches are allowed like the reference's
    # (ref patch.rs:96-121 tolerates out-of-bounds pattern points).
    ok = (
        interp.in_bounds(center, img.shape, 2.0)
        & (n_valid >= _MIN_TEMPLATE_PTS)
        & mean_ok
        & (energy > energy_floor)
        & jnp.all(jnp.isfinite(hinv_jt))
    )
    return PatchData(data=data, hinv_jt=jnp.where(ok, hinv_jt, 0.0),
                     valid_pts=valid, ok=ok)


def _patch_residual(img, patch: PatchData, M, residual_mode: str = "lssd",
                    interpolation: str = "bilinear"):
    """Residual of target samples vs template ("lssd": mean-normalized;
    "ssd": raw difference).

    Capability of Pattern52::residual (ref src/feature_tracker/patch.rs:163-232).
    M is the 3x3 SE2 warp whose translation IS the target position.
    """
    pts = PATTERN @ M[:2, :2].T + M[:2, 2][None, :]  # (P, 2)
    sample = interp.bicubic if interpolation == "bicubic" else interp.bilinear
    vals, valid = jax.vmap(sample, in_axes=(None, 0))(img, pts)
    valid = valid & patch.valid_pts
    validf = valid.astype(img.dtype)
    n_valid = jnp.sum(validf)
    if residual_mode == "ssd":
        r = jnp.where(valid, vals - patch.data, 0.0)
    else:
        n_safe = jnp.maximum(n_valid, 1.0)
        mean = jnp.maximum(jnp.sum(vals * validf) / n_safe, 1e-6)
        r = jnp.where(valid, vals / mean - patch.data, 0.0)
    # Shared-valid count must cover >50% of the TEMPLATE's valid points (the
    # reference's >26-of-52 rule generalized to partial border patches).
    n_template = jnp.sum(patch.valid_pts.astype(img.dtype))
    ok = n_valid > _MIN_SHARED_FRAC * n_template
    return r, ok


def _track_at_level(img_target, patch: PatchData, M0, cfg: KLTConfig):
    """Masked Gauss-Newton loop at one level (ref feature_tracker.rs:344-395)."""

    def body(_, carry):
        M, active, ok = carry
        r, r_ok = _patch_residual(img_target, patch, M, cfg.residual_mode,
                                  cfg.interpolation)
        inc = -(patch.hinv_jt @ r)  # (3,)
        inc_norm_sq = jnp.dot(inc, inc)
        finite = jnp.all(jnp.isfinite(inc)) & (inc_norm_sq < 1e12)
        step_ok = r_ok & finite
        M_new = M @ se2_exp(inc)
        converged = inc_norm_sq < cfg.convergence_threshold**2
        do_step = active & step_ok
        M = jnp.where(do_step, M_new, M)
        ok = ok & jnp.where(active, step_ok, True)
        active = active & step_ok & (~converged)
        return M, active, ok

    active0 = patch.ok
    M, _, ok = jax.lax.fori_loop(
        0, cfg.max_iterations, body, (M0, active0, patch.ok))
    # Final in-bounds check with margin (ref feature_tracker.rs:386-391)
    ok = ok & interp.in_bounds(M[:2, 2], img_target.shape, cfg.bounds_margin)
    return M, ok


def _track_one_point(pyr_src, pyr_dst, pos_src, pos_dst0, A0, cfg: KLTConfig):
    """Coarse-to-fine track of one point (ref feature_tracker.rs:292-342).

    pos_src: source full-res position; pos_dst0/A0: initial guess of target
    position and 2x2 linear warp. Returns (pos_dst, A, ok).
    """
    dtype = pos_src.dtype
    levels = len(pyr_src)
    pos = pos_dst0
    A = A0
    ok = jnp.asarray(True)
    n_dof = 3 if cfg.track_rotation else 2
    for lvl in reversed(range(levels)):
        scale = jnp.asarray((1.0 / cfg.pyramid_ratio)**lvl, dtype=dtype)
        patch = build_patch(pyr_src[lvl], pos_src / scale,
                            cfg.residual_mode, cfg.lm_lambda, n_dof,
                            cfg.interpolation)
        M0 = jnp.eye(3, dtype=dtype)
        M0 = M0.at[:2, :2].set(A)
        M0 = M0.at[:2, 2].set(pos / scale)
        M, lvl_ok = _track_at_level(pyr_dst[lvl], patch, M0, cfg)
        # Keep the update only if this level succeeded (coarser estimate kept
        # otherwise). Strict policy: a failed level invalidates the track
        # like the reference's early return. Tolerant policy: only the
        # finest level is load-bearing (see KLTConfig.coarse_level_policy).
        pos = jnp.where(lvl_ok, M[:2, 2] * scale, pos)
        A = jnp.where(lvl_ok, M[:2, :2], A)
        if cfg.coarse_level_policy == "tolerant":
            ok = ok & (lvl_ok | (lvl > 0))
        else:
            ok = ok & lvl_ok
    return pos, A, ok


@partial(jax.jit, static_argnames=("cfg",))
def track_points(pyr_src, pyr_dst, pos_src, pos_dst0, A0, alive, cfg: KLTConfig):
    """Track all features pyr_src -> pyr_dst. Batched over the feature table.

    Args:
      pyr_src, pyr_dst: tuples of (H/2^l, W/2^l) images.
      pos_src: (N, 2) source positions (full-res px).
      pos_dst0: (N, 2) initial target positions.
      A0: (N, 2, 2) initial linear warp parts.
      alive: (N,) bool — dead slots are skipped (stay dead).
    Returns: (pos_dst (N,2), A (N,2,2), ok (N,)).
    """
    f = jax.vmap(_track_one_point, in_axes=(None, None, 0, 0, 0, None))
    pos, A, ok = f(pyr_src, pyr_dst, pos_src, pos_dst0, A0, cfg)
    ok = ok & alive
    pos = jnp.where(ok[:, None], pos, pos_src)
    return pos, A, ok


@partial(jax.jit, static_argnames=("cfg",))
def track_points_bidirectional(pyr_src, pyr_dst, pos_src, alive, cfg: KLTConfig):
    """Forward + backward track with return-distance gate.

    Capability of ref src/feature_tracker/feature_tracker.rs:252-291: accept a
    track only if the backward track returns within sqrt(0.4) px of the start.
    Returns (pos_dst (N,2), A (N,2,2), ok (N,)).
    """
    N = pos_src.shape[0]
    eye = jnp.broadcast_to(jnp.eye(2, dtype=pos_src.dtype), (N, 2, 2))
    pos_fwd, A_fwd, ok_fwd = track_points(
        pyr_src, pyr_dst, pos_src, pos_src, eye, alive, cfg)
    # Backward: start from the forward result aiming back at the source,
    # warp initialized at the INVERSE of the forward rotation (transpose —
    # the forward warps are rotation-only by construction).
    A_inv = jnp.swapaxes(A_fwd, -1, -2)
    pos_back, _, ok_back = track_points(
        pyr_dst, pyr_src, pos_fwd, pos_src, A_inv, ok_fwd, cfg)
    dist_sq = jnp.sum((pos_back - pos_src) ** 2, axis=1)
    ok = ok_fwd & ok_back & (dist_sq < cfg.bidir_threshold_sq)
    return pos_fwd, A_fwd, ok


@partial(jax.jit, static_argnames=("cfg",))
def track_points_bidirectional_stereo(pyr0_src, pyr1_src, pyr0_dst, pyr1_dst,
                                      pos0, pos1, alive, cfg: KLTConfig):
    """Temporal bidirectional tracking of BOTH cameras of a stereo rig.

    Exactly two track_points_bidirectional calls: cam0 prev->cur on pos0
    and cam1 prev->cur on pos1 (the reference's two temporal passes, ref
    feature_tracker.rs:125-138), kept as one entry point so the frontend
    has a single place where both cameras' temporal passes could be batched.

    Returns (pos0, A0, ok0, pos1, A1, ok1).
    """
    pos0o, A0o, ok0 = track_points_bidirectional(
        pyr0_src, pyr0_dst, pos0, alive, cfg)
    pos1o, A1o, ok1 = track_points_bidirectional(
        pyr1_src, pyr1_dst, pos1, alive, cfg)
    return pos0o, A0o, ok0, pos1o, A1o, ok1
