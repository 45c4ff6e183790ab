"""Stereo feature-tracking frontend: fixed-capacity masked feature table +
jit-compiled per-frame update.

Capability parity (SURVEY.md §2 #12 StereoPatchTracker::process_frame — ref
src/feature_tracker/feature_tracker.rs:116-207):
  (a) build stereo pyramids
  (b) temporally track existing features cam0 prev->cur and cam1 prev->cur
      (bidirectional KLT with return gate)
  (c) detect new corners in grid cells not already occupied (cam0)
  (d) stereo-match the new corners cam0->cur cam1 by the same KLT
  (e) keep only stereo-matched births, assign shared incremental feature ids

Design: the reference's per-camera HashMap<feature_id, Affine2>
track states become a fixed-capacity struct-of-arrays FeatureTable with an
alive mask; births compact into free slots with a cumsum ranking — no dynamic
shapes, so the whole frame step compiles once. Landmark storage elsewhere is
slot-aligned with this table (ids are never reused while a slot is alive, and
an id check guards against slot recycling inside the sliding window).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import detect, klt


class FrontendConfig(NamedTuple):
    capacity: int = 256           # feature table slots
    cell_size: int = 50           # ref config feature_detection.grid_size
    detect_margin: int = 19       # ref EDGE_THRESHOLD image_utilities.rs:118
    min_score: float = 10.0       # floor of ref threshold cascade 40->10
    max_per_cell: int = 1         # ref config max_features_per_grid
    klt: klt.KLTConfig = klt.KLTConfig()
    # Detection mode: "grid" = per-cell argmax with occupancy (main-crate
    # semantics, ref image_utilities.rs:108-175); "nms" = block NMS with
    # min-distance suppression against live tracks (experimental-crate
    # semantics, ref feature_detection.rs:172-254, 62-69).
    detect_mode: str = "grid"
    nms_radius: int = 10          # min distance between features (px)
    nms_max_new: int = 128        # static candidate capacity in nms mode
    # Adaptive corner-score floor on weak texture: when the live-track count
    # after temporal tracking falls below `relax_floor_below`, detection
    # accepts per-cell winners down to `relaxed_min_score` instead of
    # `min_score`, AND takes up to `relax_max_per_cell` spaced candidates
    # per cell (sparse scenes often have most cells featureless — e.g. the
    # easy_plane matrix scene has corners in only 32 of 112 cells, so a
    # lower floor alone cannot fill the table). Generalizes the reference's
    # 40->10 re-detection cascade (ref image_utilities.rs:151-160) — only
    # when the tracker is actually starving, so well-textured scenes keep
    # the strict single-winner floor. 0 = off (reference-parity).
    relax_floor_below: int = 0
    relaxed_min_score: float = 1.0
    relax_max_per_cell: int = 3
    # Floor of the birth-score observation weight (FeatureTable.w).
    score_weight_floor: float = 0.05
    # Score at-or-above which a birth carries full weight; weaker births
    # scale as sqrt(score / ref). Uses the FAST margin score (the detection
    # score itself): measured BETTER on the weak-texture matrix scene than a
    # Shi-Tomasi min-eigenvalue weight (0.161 vs 0.167 ATE) — the min-eig
    # variant also down-weights strict-floor corners whose margin is high,
    # diluting good information. Default = FrontendConfig.min_score so
    # strict births keep w = 1 and only starvation-floor births discount.
    score_weight_ref: float = 10.0
    # Exponent of the weight curve w = clip((score/ref)^power, floor, 1).
    # 0.5 = sigma ~ 1/sqrt(score) (information-proportional); 1.0 discounts
    # weak births quadratically in the squared cost — harsher on the
    # near-textureless starvation births that dominate tracking deserts.
    # Measured on the weak-texture matrix scene (easy_plane 752x480, CPU):
    # power 1.0 + floor 0.05 ATE 0.132 vs 0.5/0.3 0.161 vs unweighted 0.174.
    score_weight_power: float = 1.0


class FeatureTable(NamedTuple):
    """Struct-of-arrays track state. N = capacity."""
    pos0: jnp.ndarray    # (N,2) cam0 positions (full-res px)
    pos1: jnp.ndarray    # (N,2) cam1 positions
    A0: jnp.ndarray      # (N,2,2) cam0 warp linear part
    A1: jnp.ndarray      # (N,2,2) cam1 warp linear part
    fid: jnp.ndarray     # (N,) int32 feature ids (unique, never reused)
    alive: jnp.ndarray   # (N,) bool
    age: jnp.ndarray     # (N,) int32 frames tracked
    # Birth-score observation weight in (0, 1]: sqrt(detection_score /
    # min_score) clipped to [score_weight_floor, 1]. Corner score is (to
    # first order) the Fisher information of the patch localization, so a
    # starvation-mode birth at score 1 carries ~sqrt(1/10) of a strict
    # birth's weight. Consumed by the solvers when
    # EstimatorConfig.use_obs_weights is on; all-ones otherwise.
    w: jnp.ndarray       # (N,)
    next_id: jnp.ndarray  # () int32


def init_table(capacity: int, dtype=jnp.float32) -> FeatureTable:
    N = capacity
    eye = jnp.broadcast_to(jnp.eye(2, dtype=dtype), (N, 2, 2))
    return FeatureTable(
        pos0=jnp.zeros((N, 2), dtype=dtype),
        pos1=jnp.zeros((N, 2), dtype=dtype),
        A0=eye, A1=eye,
        fid=jnp.full((N,), -1, jnp.int32),
        alive=jnp.zeros((N,), dtype=bool),
        age=jnp.zeros((N,), jnp.int32),
        w=jnp.ones((N,), dtype=dtype),
        next_id=jnp.asarray(0, jnp.int32),
    )


def birth_slots(alive, cand_ok):
    """Assign accepted candidates to free table slots.

    Returns (slot (C,), ok (C,), rank (C,)): `slot` is the target row for
    each candidate (N, i.e. out of range, when rejected or the table is
    full), `ok` marks candidates that actually land, `rank` numbers accepted
    candidates 0..n_born-1 (for id assignment). Fully static shapes
    (nonzero-with-size + cumsum). Shared by the stereo frontend and the mono
    tracker.
    """
    N = alive.shape[0]
    C = cand_ok.shape[0]
    free_slots = jnp.nonzero(~alive, size=C, fill_value=N)[0]  # (C,)
    rank = jnp.cumsum(cand_ok.astype(jnp.int32)) - 1           # (C,)
    slot = jnp.where(cand_ok, free_slots[jnp.clip(rank, 0, C - 1)], N)
    ok = cand_ok & (slot < N)
    return slot, ok, rank


def masked_row_scatter(arr, slot, ok, upd):
    """arr[slot[i]] <- upd[i] where ok[i]; rejected rows land on a dummy
    padding row instead of a clipped real index.

    (Scattering rejected candidates' stale values at a CLIPPED index would
    duplicate-write the last real row, and JAX leaves duplicate-index
    .at[].set ordering unspecified — a birth into slot N-1 could be silently
    reverted. The dummy row absorbs all rejected writes.)
    """
    N = arr.shape[0]
    idx = jnp.where(ok, slot, N)
    padded = jnp.concatenate([arr, arr[-1:]], axis=0)
    return padded.at[idx].set(upd)[:N]


def _insert_births(table: FeatureTable, cand0, cand1, cand_A1, cand_ok,
                   cand_w=None):
    """Compact accepted candidates into free table slots.

    cand0/cand1: (C,2) candidate positions in cam0/cam1; cand_ok: (C,) bool;
    cand_w: (C,) optional birth-score weights (1.0 when omitted).
    """
    slot, ok, rank = birth_slots(table.alive, cand_ok)
    C = cand_ok.shape[0]
    new_ids = table.next_id + rank
    eye = jnp.eye(2, dtype=table.A0.dtype)
    pos0 = masked_row_scatter(table.pos0, slot, ok, cand0)
    pos1 = masked_row_scatter(table.pos1, slot, ok, cand1)
    A0 = masked_row_scatter(table.A0, slot, ok,
                            jnp.broadcast_to(eye, (C, 2, 2)))
    A1 = masked_row_scatter(table.A1, slot, ok, cand_A1)
    fid = masked_row_scatter(table.fid, slot, ok, new_ids)
    alive = masked_row_scatter(table.alive, slot, ok,
                               jnp.ones((C,), dtype=bool))
    age = masked_row_scatter(table.age, slot, ok,
                             jnp.zeros((C,), jnp.int32))
    if cand_w is None:
        cand_w = jnp.ones((C,), dtype=table.w.dtype)
    w = masked_row_scatter(table.w, slot, ok, cand_w.astype(table.w.dtype))
    n_born = jnp.sum(ok.astype(jnp.int32))
    return table._replace(pos0=pos0, pos1=pos1, A0=A0, A1=A1, fid=fid,
                          alive=alive, age=age, w=w,
                          next_id=table.next_id + n_born)


@partial(jax.jit, static_argnames=("cfg", "first_frame"))
def frontend_step(table: FeatureTable, pyr0_prev, pyr1_prev, pyr0, pyr1,
                  cfg: FrontendConfig, first_frame: bool = False):
    """One frame of stereo feature tracking.

    Args:
      table: current FeatureTable (tracks valid for the PREVIOUS frame).
      pyr0_prev/pyr1_prev: previous stereo pyramids (ignored when first_frame).
      pyr0/pyr1: current stereo pyramids.
    Returns (new_table, stats dict).
    """
    kcfg = cfg.klt

    # (b) temporal tracking in both cameras; a feature survives only if both
    # temporal tracks pass the bidirectional gate (shared stereo id semantics).
    if first_frame:
        survived = jnp.zeros_like(table.alive)
        pos0, A0 = table.pos0, table.A0
        pos1, A1 = table.pos1, table.A1
    else:
        # Both cameras' temporal passes through one tracker entry point.
        pos0, A0, ok0, pos1, A1, ok1 = klt.track_points_bidirectional_stereo(
            pyr0_prev, pyr1_prev, pyr0, pyr1, table.pos0, table.pos1,
            table.alive, kcfg)
        survived = table.alive & ok0 & ok1

    table = table._replace(pos0=pos0, pos1=pos1, A0=A0, A1=A1,
                           alive=survived,
                           age=jnp.where(survived, table.age + 1, 0))

    # (c) detect new corners in unoccupied cells of cam0 level 0.
    score = detect.fast_score(pyr0[0])
    if cfg.relax_floor_below > 0:
        # Starvation-adaptive floor (see FrontendConfig.relax_floor_below).
        starving = jnp.sum(table.alive) < cfg.relax_floor_below
        floor = jnp.where(starving,
                          jnp.asarray(cfg.relaxed_min_score, score.dtype),
                          jnp.asarray(cfg.min_score, score.dtype))
    else:
        starving = None
        floor = cfg.min_score
    if cfg.detect_mode == "nms":
        cand_xy, cand_ok = detect.nms_select(
            score, table.pos0, table.alive, cfg.nms_radius,
            margin=cfg.detect_margin, min_score=floor,
            max_new=cfg.nms_max_new)
    else:
        if starving is None:
            cand_xy, cand_ok = detect.select_grid_features(
                score, table.pos0, table.alive, cfg.cell_size,
                margin=cfg.detect_margin, min_score=floor,
                max_per_cell=cfg.max_per_cell)
        else:
            # Starvation mode computes BOTH selections (cheap relative to
            # the score map) and picks dynamically: strict = reference
            # cell-occupancy semantics; relaxed = distance-based occupancy
            # with multi-candidate cells and the lowered floor.
            k = max(cfg.max_per_cell, cfg.relax_max_per_cell)
            xy_s, ok_s = detect.select_grid_features(
                score, table.pos0, table.alive, cfg.cell_size,
                margin=cfg.detect_margin, min_score=cfg.min_score,
                max_per_cell=k, cell_occupancy=True)
            n_cells = ok_s.shape[0] // k
            rnd = jnp.arange(ok_s.shape[0]) // n_cells
            ok_s = ok_s & (rnd < cfg.max_per_cell)
            xy_r, ok_r = detect.select_grid_features(
                score, table.pos0, table.alive, cfg.cell_size,
                margin=cfg.detect_margin,
                min_score=cfg.relaxed_min_score,
                max_per_cell=k, cell_occupancy=False)
            cand_xy = jnp.where(starving, xy_r, xy_s)
            cand_ok = jnp.where(starving, ok_r, ok_s)

    # (d) stereo-match candidates cam0 -> cam1 (bidirectional KLT).
    cand_pos1, cand_A1, stereo_ok = klt.track_points_bidirectional(
        pyr0, pyr1, cand_xy, cand_ok, kcfg)

    # (e) births: only stereo-matched candidates enter the table. Each
    # birth carries an observation weight from its detection score (see
    # FrontendConfig.score_weight_ref).
    births_ok = cand_ok & stereo_ok
    H0, W0 = score.shape
    iy = jnp.clip(jnp.round(cand_xy[:, 1]).astype(jnp.int32), 0, H0 - 1)
    ix = jnp.clip(jnp.round(cand_xy[:, 0]).astype(jnp.int32), 0, W0 - 1)
    cand_w = jnp.clip(
        jnp.power(jnp.maximum(score[iy, ix], 1e-6) / cfg.score_weight_ref,
                  cfg.score_weight_power),
        cfg.score_weight_floor, 1.0)
    table = _insert_births(table, cand_xy, cand_pos1, cand_A1, births_ok,
                           cand_w)

    stats = {
        "tracked": jnp.sum(survived.astype(jnp.int32)),
        "born": jnp.sum(births_ok.astype(jnp.int32)),
        "alive": jnp.sum(table.alive.astype(jnp.int32)),
    }
    return table, stats
