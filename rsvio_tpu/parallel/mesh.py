"""Device mesh construction for multi-device/multi-host runs.

Greenfield capability (SURVEY.md §2.4): the reference is single-process with
no distributed backend; this build adds a landmark-sharded BA over a 1-D
device mesh with XLA collectives (NCCL over NVLink between GPUs;
BASELINE.json configs item 5).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


LANDMARK_AXIS = "lm"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the landmark axis. Landmark blocks are the natural shard
    dimension of BA: each landmark's 3x3 block and its observations touch all
    poses but no other landmark, so linearization + landmark elimination are
    embarrassingly parallel and only the small reduced camera system needs a
    psum (SURVEY.md §7 step 9)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (LANDMARK_AXIS,))
