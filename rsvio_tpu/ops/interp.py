"""Image sampling: bilinear / bicubic interpolation and image gradients.

Capability parity (SURVEY.md §2): bilinear sample + central-difference gradient
(ref src/feature_tracker/image_utilities.rs:5-66, raw-index bilinear at
src/feature_tracker/patch.rs:163-232) and Catmull-Rom bicubic with analytic
derivatives (ref feature_tracker/src/image_operations.rs:140-282).

Design: images are (H, W) float arrays in device memory; sampling N points is a
batched gather expressed with plain advanced indexing so XLA lowers it to a
single gather op — callers vmap over points, never loop. All samplers return an
in-bounds validity mask instead of clamping silently.
"""

from __future__ import annotations

import jax.numpy as jnp


def _gather2(img, yi, xi):
    """Gather img[yi, xi] with clamped indices (validity handled by caller)."""
    H, W = img.shape
    yi = jnp.clip(yi, 0, H - 1)
    xi = jnp.clip(xi, 0, W - 1)
    return img[yi, xi]


def bilinear(img, xy):
    """Bilinear sample at (x, y). Returns (value, valid).

    Convention: integer coordinates are pixel centers (matches the reference's
    raw-buffer bilinear, ref src/feature_tracker/patch.rs:188-205).
    """
    H, W = img.shape
    x, y = xy[0], xy[1]
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    v00 = _gather2(img, y0, x0)
    v01 = _gather2(img, y0, x0 + 1)
    v10 = _gather2(img, y0 + 1, x0)
    v11 = _gather2(img, y0 + 1, x0 + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    val = top * (1 - fy) + bot * fy
    valid = (x >= 0) & (y >= 0) & (x <= W - 1.001) & (y <= H - 1.001)
    return val, valid


def bilinear_with_grad(img, xy):
    """Bilinear sample + central-difference image gradient at (x, y).

    Returns (value, grad[2], valid) — the [val, gx, gy] triple of the
    reference's image_grad (ref src/feature_tracker/image_utilities.rs:5-66).
    Gradient uses half-pixel central differences of bilinear samples, which on
    the bilinear surface equals the analytic derivative away from cell edges.
    """
    v, ok0 = bilinear(img, xy)
    vxp, ok1 = bilinear(img, jnp.stack([xy[0] + 0.5, xy[1]]))
    vxm, ok2 = bilinear(img, jnp.stack([xy[0] - 0.5, xy[1]]))
    vyp, ok3 = bilinear(img, jnp.stack([xy[0], xy[1] + 0.5]))
    vym, ok4 = bilinear(img, jnp.stack([xy[0], xy[1] - 0.5]))
    gx = vxp - vxm
    gy = vyp - vym
    valid = ok0 & ok1 & ok2 & ok3 & ok4
    return v, jnp.stack([gx, gy]), valid


def _cubic_weights(t):
    """Catmull-Rom cubic weights for the 4 taps at offsets [-1, 0, 1, 2]."""
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return jnp.stack([w0, w1, w2, w3])


def _cubic_weights_d(t):
    """Derivative of Catmull-Rom weights w.r.t. t."""
    t2 = t * t
    w0 = -1.5 * t2 + 2.0 * t - 0.5
    w1 = 4.5 * t2 - 5.0 * t
    w2 = -4.5 * t2 + 4.0 * t + 0.5
    w3 = 1.5 * t2 - t
    return jnp.stack([w0, w1, w2, w3])


def bicubic(img, xy):
    """Catmull-Rom bicubic sample at (x, y). Returns (value, valid).

    Capability of ref feature_tracker/src/image_operations.rs:232-282.
    """
    H, W = img.shape
    x, y = xy[0], xy[1]
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    tx = x - x0
    ty = y - y0
    wx = _cubic_weights(tx)
    wy = _cubic_weights(ty)
    # 4x4 tap grid
    acc = jnp.zeros((), dtype=img.dtype)
    for j in range(4):
        row = jnp.zeros((), dtype=img.dtype)
        for i in range(4):
            row = row + wx[i] * _gather2(img, y0 + j - 1, x0 + i - 1)
        acc = acc + wy[j] * row
    valid = (x >= 1) & (y >= 1) & (x <= W - 2.001) & (y <= H - 2.001)
    return acc, valid


def bicubic_with_grad(img, xy):
    """Bicubic sample + analytic gradient (d/dx, d/dy).

    Capability of ref feature_tracker/src/image_operations.rs:140-229
    (d_interpolate_bicubic returning the image-gradient row vector).
    """
    H, W = img.shape
    x, y = xy[0], xy[1]
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    tx = x - x0
    ty = y - y0
    wx, dwx = _cubic_weights(tx), _cubic_weights_d(tx)
    wy, dwy = _cubic_weights(ty), _cubic_weights_d(ty)
    val = jnp.zeros((), dtype=img.dtype)
    gx = jnp.zeros((), dtype=img.dtype)
    gy = jnp.zeros((), dtype=img.dtype)
    for j in range(4):
        row = jnp.zeros((), dtype=img.dtype)
        for i in range(4):
            row = row + wx[i] * _gather2(img, y0 + j - 1, x0 + i - 1)
        drow = jnp.zeros((), dtype=img.dtype)
        for i in range(4):
            drow = drow + dwx[i] * _gather2(img, y0 + j - 1, x0 + i - 1)
        val = val + wy[j] * row
        gx = gx + wy[j] * drow
        gy = gy + dwy[j] * row
    valid = (x >= 1) & (y >= 1) & (x <= W - 2.001) & (y <= H - 2.001)
    return val, jnp.stack([gx, gy]), valid


def in_bounds(xy, shape, margin: float = 0.0):
    """Point-in-image test with margin (ref src/feature_tracker/image_utilities.rs:68-80)."""
    H, W = shape
    x, y = xy[0], xy[1]
    return (x >= margin) & (y >= margin) & (x <= W - 1 - margin) & (y <= H - 1 - margin)
