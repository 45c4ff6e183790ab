"""Feature detection: whole-image FAST-9 and Shi-Tomasi scoring + grid-cell
selection — fully vectorized XLA ops, no per-corner loops.

Capability parity (SURVEY.md §2 #14, #23):
  * grid-based FAST-9 detection keeping at most `max_per_cell` corners per cell
    with an occupancy grid of existing tracks and an image-border margin
    (ref src/feature_tracker/image_utilities.rs:108-175, EDGE_THRESHOLD=19,
    thresholds stepping 40 -> 10)
  * Shi-Tomasi min-eigenvalue scoring with smoothed structure tensor and
    min-distance suppression against existing features
    (ref feature_tracker/src/feature_tracker/feature_detection.rs:83-254)

Design: the reference runs imageproc's per-cell FAST with a
threshold cascade; here the FAST margin-score of EVERY pixel is computed in
one shot (16 circularly-shifted comparisons + unrolled run-of-9 min/max — all
elementwise (H, W) ops), then each grid cell picks its argmax. The threshold
cascade collapses into a single continuous score: score > t_min replaces the
40->10 re-detection ladder with identical selection semantics (the cell winner
is the strongest corner either way).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3 used by FAST (16 ring offsets, (dy, dx)),
# clockwise from the top.
_FAST_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _shift2(img, dy: int, dx: int):
    """img shifted so out[y, x] = img[y + dy, x + dx], zero-padded."""
    H, W = img.shape
    out = jnp.zeros_like(img)
    ys = slice(max(0, dy), H + min(0, dy))
    yd = slice(max(0, -dy), H + min(0, -dy))
    xs = slice(max(0, dx), W + min(0, dx))
    xd = slice(max(0, -dx), W + min(0, -dx))
    return out.at[yd, xd].set(img[ys, xs])


def fast_score(img):
    """FAST-9 margin score per pixel.

    score[y, x] = max over the 16 arc starts of the min margin over a 9-long
    contiguous ring arc, where margin is (ring - center) for bright arcs and
    (center - ring) for dark arcs; max of the two polarities. score > t means
    the pixel is a FAST-9 corner at threshold t — so one score map subsumes the
    reference's threshold cascade (ref image_utilities.rs:151-160).
    """
    diffs = jnp.stack([_shift2(img, dy, dx) - img for (dy, dx) in _FAST_RING])  # (16, H, W)
    bright = diffs          # ring brighter than center by margin
    dark = -diffs           # ring darker
    # min over each 9-long circular run, then max over the 16 starts
    def run_score(m):
        ext = jnp.concatenate([m, m[:8]], axis=0)  # (24, H, W)
        best = jnp.full_like(m[0], -jnp.inf)
        for s in range(16):
            run = ext[s]
            for k in range(1, 9):
                run = jnp.minimum(run, ext[s + k])
            best = jnp.maximum(best, run)
        return best
    score = jnp.maximum(run_score(bright), run_score(dark))
    # The ring is undefined within 3 px of the border (zero padding would fake
    # dark arcs there) — zero it out.
    H, W = img.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    interior = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    return jnp.where(interior, score, 0.0)


def _box3(img):
    """3x3 box filter (edge-padded)."""
    up = jnp.pad(img[:-1, :], ((1, 0), (0, 0)), mode="edge")
    dn = jnp.pad(img[1:, :], ((0, 1), (0, 0)), mode="edge")
    v = up + img + dn
    lf = jnp.pad(v[:, :-1], ((0, 0), (1, 0)), mode="edge")
    rt = jnp.pad(v[:, 1:], ((0, 0), (0, 1)), mode="edge")
    return (lf + v + rt) / 9.0


def shi_tomasi_score(img):
    """Min-eigenvalue (Shi-Tomasi) corner score per pixel.

    Capability of ref feature_tracker/src/feature_tracker/feature_detection.rs:83-165
    (central-difference gradients, smoothed structure tensor,
    score ∝ trace - sqrt(trace^2 - 4 det) — the smaller eigenvalue).
    """
    gx = (_shift2(img, 0, 1) - _shift2(img, 0, -1)) * 0.5
    gy = (_shift2(img, 1, 0) - _shift2(img, -1, 0)) * 0.5
    ixx = _box3(gx * gx)
    iyy = _box3(gy * gy)
    ixy = _box3(gx * gy)
    tr = ixx + iyy
    det = ixx * iyy - ixy * ixy
    disc = jnp.sqrt(jnp.maximum(tr * tr - 4.0 * det, 0.0))
    return 0.5 * (tr - disc)


@partial(jax.jit, static_argnames=("cell_size", "margin", "max_per_cell",
                                   "min_dist", "cell_occupancy"))
def select_grid_features(score, occupied_xy, occupied_mask, cell_size: int,
                         margin: int = 19, min_score: float = 10.0,
                         max_per_cell: int = 1, min_dist: int = 5,
                         cell_occupancy: bool = True):
    """Pick the top-k scoring pixels in each unoccupied grid cell.

    Capability of ref src/feature_tracker/image_utilities.rs:108-175: cells
    already containing a tracked feature are skipped; a border margin excludes
    edge pixels; at most max_per_cell new corners per cell (ref config
    feature_detection.max_features_per_grid).

    Args:
      score: (H, W) corner score map.
      occupied_xy: (N, 2) existing feature positions (x, y) full-res px.
      occupied_mask: (N,) bool alive mask for those positions.
      cell_size: grid cell edge in px (ref config feature_detection.grid_size).
      margin: border exclusion in px (ref EDGE_THRESHOLD = 19).
      min_score: minimum corner score (floor of the reference's 40->10 cascade).
      max_per_cell: corners per cell (static).
      min_dist: in-cell suppression radius between multi-candidates (px) —
        without it the 2nd pick would be the 1st winner's neighboring pixel.
      cell_occupancy: True = the reference's cell-level gate (any live track
        claims its whole cell). False = DISTANCE-based occupancy: live
        tracks suppress only a min_dist neighborhood of the score map, so
        multi-candidate cells can keep filling around existing tracks
        (the starvation-mode behavior; sparse scenes concentrate texture in
        few cells and the cell gate caps them at one track each).

    Returns:
      cand_xy: (C * max_per_cell, 2) float candidate positions, grouped by
        pick round (first all cells' 1st picks, then all 2nd picks, ...).
      cand_ok: (C * max_per_cell,) bool validity.
    """
    H, W = score.shape
    gh, gw = H // cell_size, W // cell_size
    # Mask out borders and everything below threshold.
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    in_border = ((yy >= margin) & (yy < H - margin) &
                 (xx >= margin) & (xx < W - margin))
    s = jnp.where(in_border, score, -jnp.inf)
    if not cell_occupancy:
        # Suppress a (2*min_dist+1)^2 neighborhood around every live track
        # (same mechanism as nms_select's live-track injection).
        occ_x = jnp.clip(jnp.round(occupied_xy[:, 0]).astype(jnp.int32),
                         0, W - 1)
        occ_y = jnp.clip(jnp.round(occupied_xy[:, 1]).astype(jnp.int32),
                         0, H - 1)
        hit = jnp.zeros((H, W), score.dtype).at[occ_y, occ_x].max(
            occupied_mask.astype(score.dtype))
        k2 = 2 * min_dist + 1
        near = jax.lax.reduce_window(hit, -jnp.inf, jax.lax.max,
                                     (k2, k2), (1, 1), "SAME") > 0
        s = jnp.where(near, -jnp.inf, s)
    s = s[: gh * cell_size, : gw * cell_size]
    cells = s.reshape(gh, cell_size, gw, cell_size).transpose(0, 2, 1, 3)
    cells = cells.reshape(gh * gw, cell_size, cell_size)

    if cell_occupancy:
        # Occupancy: scatter existing features into the cell grid.
        occ_col = jnp.clip((occupied_xy[:, 0] // cell_size).astype(jnp.int32),
                           0, gw - 1)
        occ_row = jnp.clip((occupied_xy[:, 1] // cell_size).astype(jnp.int32),
                           0, gh - 1)
        occ_idx = occ_row * gw + occ_col
        occ = jnp.zeros((gh * gw,), dtype=bool).at[occ_idx].max(occupied_mask)
    else:
        occ = jnp.zeros((gh * gw,), dtype=bool)

    cell_row = jnp.arange(gh * gw, dtype=jnp.int32) // gw
    cell_col = jnp.arange(gh * gw, dtype=jnp.int32) % gw
    iy = jax.lax.broadcasted_iota(jnp.int32, (cell_size, cell_size), 0)
    ix = jax.lax.broadcasted_iota(jnp.int32, (cell_size, cell_size), 1)
    xy_all, ok_all = [], []
    for _k in range(max_per_cell):
        flat = cells.reshape(gh * gw, cell_size * cell_size)
        best = jnp.argmax(flat, axis=1)
        best_score = jnp.take_along_axis(flat, best[:, None], axis=1)[:, 0]
        cy = best // cell_size
        cx = best % cell_size
        cand_y = cell_row * cell_size + cy
        cand_x = cell_col * cell_size + cx
        xy_all.append(jnp.stack([cand_x, cand_y], axis=1).astype(score.dtype))
        ok_all.append((best_score > min_score) & (~occ))
        if max_per_cell > 1:
            # Suppress a min_dist neighborhood around the winner before the
            # next pick (in-cell spacing between multi-candidates).
            near = ((jnp.abs(iy[None] - cy[:, None, None]) <= min_dist)
                    & (jnp.abs(ix[None] - cx[:, None, None]) <= min_dist))
            cells = jnp.where(near, -jnp.inf, cells)
    return jnp.concatenate(xy_all, axis=0), jnp.concatenate(ok_all, axis=0)


@partial(jax.jit,
         static_argnames=("radius", "margin", "max_new"))
def nms_select(score, occupied_xy, occupied_mask, radius: int,
               margin: int = 19, min_score: float = 10.0,
               max_new: int = 128):
    """Block non-max-suppression corner selection with min-distance
    suppression against existing tracks.

    Capability of ref feature_tracker/src/feature_tracker/feature_detection.rs:
      * :172-254 — block-based NMS (imageproc-style): a pixel survives only
        if it is the maximum within `radius` and above threshold
      * :62-69 — existing tracked features are injected as maximum-score
        corners, so every new detection keeps at least `radius` px distance
        from every live track

    Design: the per-block scan of the reference becomes ONE
    lax.reduce_window max-pool over a (2r+1)² window; peaks are pixels equal
    to their pooled max. Injected +inf scores at live track positions
    suppress any candidate within the radius. Survivors are ranked by score
    with one top_k (the reference sorts candidates by score too).

    Returns:
      cand_xy: (max_new, 2) float (x, y) positions, score-descending.
      cand_ok: (max_new,) bool validity.
    """
    H, W = score.shape
    dtype = score.dtype
    big = jnp.asarray(jnp.finfo(dtype).max, dtype)

    # Inject live tracks as untouchable maxima (ref :62-69).
    occ_x = jnp.clip(jnp.round(occupied_xy[:, 0]).astype(jnp.int32), 0, W - 1)
    occ_y = jnp.clip(jnp.round(occupied_xy[:, 1]).astype(jnp.int32), 0, H - 1)
    inject = jnp.zeros((H, W), dtype).at[occ_y, occ_x].max(
        jnp.where(occupied_mask, big, jnp.asarray(0, dtype)))
    s_inj = jnp.maximum(score, inject)

    k = 2 * radius + 1
    pooled = jax.lax.reduce_window(
        s_inj, -jnp.inf, jax.lax.max, (k, k), (1, 1), "SAME")

    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    in_border = ((yy >= margin) & (yy < H - margin) &
                 (xx >= margin) & (xx < W - margin))
    pre_peak = ((score >= pooled) & (score > min_score) & in_border
                & (inject <= 0))
    # Deterministic tie-break: `score >= pooled` passes EVERY pixel tied for
    # the window maximum (score plateaus, saturated FAST margins), which
    # would emit two corners closer than `radius`. Two pre-peaks inside one
    # window necessarily have equal scores (otherwise the smaller one fails
    # its own pooled test), so resolving ties = keeping, per window, only
    # the pre-peak with the lowest linear index: one more reduce_window max
    # over -index restricted to pre-peaks.
    lin = yy * W + xx
    neg_idx = jnp.where(pre_peak, (-lin).astype(score.dtype), -jnp.inf)
    pooled_neg_idx = jax.lax.reduce_window(
        neg_idx, -jnp.inf, jax.lax.max, (k, k), (1, 1), "SAME")
    is_peak = pre_peak & (neg_idx >= pooled_neg_idx)

    flat = jnp.where(is_peak, score, -jnp.inf).reshape(-1)
    vals, idx = jax.lax.top_k(flat, max_new)
    cand_xy = jnp.stack([(idx % W).astype(dtype),
                         (idx // W).astype(dtype)], axis=1)
    return cand_xy, vals > -jnp.inf
