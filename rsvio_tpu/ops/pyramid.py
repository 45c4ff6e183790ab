"""Image pyramid construction — whole-image XLA ops.

Capability parity: the reference builds a 6-level power-of-2 pyramid with a
Triangle (bilinear) filter, levels computed in parallel with rayon
(ref src/feature_tracker/feature_tracker.rs:209-220); the experimental crate
supports arbitrary-ratio pyramids with optional pre-blur
(ref feature_tracker/src/image_operations.rs:47-78).

Design: each /2 level is one fused XLA expression — a [1,2,1]⊗[1,2,1]
separable triangle filter followed by stride-2 subsampling, implemented with
pad+add (no conv needed). Levels are returned as a tuple of
static-shaped arrays; callers treat the tuple as a pytree so the whole pyramid
lives on device.

Shapes: levels are exact halves (floor). The estimator only samples within the
validity margins, so odd trailing rows/cols are simply dropped, matching the
reference's floor-div level sizes.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp


def downsample2(img):
    """One /2 pyramid level via separable [1,2,1]/4 triangle filter + stride 2.

    Equivalent to bilinear ("Triangle") resampling at exactly half resolution
    (the reference's image::resize Triangle filter at /2).
    """
    H, W = img.shape
    H2, W2 = H // 2, W // 2
    img = img[: H2 * 2, : W2 * 2]
    # Horizontal [1,2,1]/4 at even columns: out[j] = (in[2j-1] + 2 in[2j] + in[2j+1])/4
    left = jnp.pad(img[:, :-1], ((0, 0), (1, 0)), mode="edge")
    right = jnp.pad(img[:, 1:], ((0, 0), (0, 1)), mode="edge")
    h = (left + 2.0 * img + right)[:, ::2] * 0.25
    # Vertical
    up = jnp.pad(h[:-1, :], ((1, 0), (0, 0)), mode="edge")
    down = jnp.pad(h[1:, :], ((0, 1), (0, 0)), mode="edge")
    return (up + 2.0 * h + down)[::2, :] * 0.25


def build_pyramid(img, levels: int):
    """Build `levels` pyramid levels (level 0 = full resolution).

    Returns a tuple of arrays with shapes (H/2^i, W/2^i).
    """
    out = [img]
    for _ in range(levels - 1):
        out.append(downsample2(out[-1]))
    return tuple(out)


def gaussian_blur3(img):
    """Separable [1,2,1]/4 blur (the optional pre-blur of the reference's
    experimental pyramid, ref feature_tracker/src/image_operations.rs:47-78)."""
    left = jnp.pad(img[:, :-1], ((0, 0), (1, 0)), mode="edge")
    right = jnp.pad(img[:, 1:], ((0, 0), (0, 1)), mode="edge")
    h = (left + 2.0 * img + right) * 0.25
    up = jnp.pad(h[:-1, :], ((1, 0), (0, 0)), mode="edge")
    down = jnp.pad(h[1:, :], ((0, 1), (0, 0)), mode="edge")
    return (up + 2.0 * h + down) * 0.25


def build_pyramid_ratio(img, levels: int, ratio: float, blur: bool = False,
                        blur_sigma: float = 0.7):
    """Arbitrary-ratio pyramid (capability of the reference's experimental
    crate, ref feature_tracker/src/image_operations.rs:47-78: configurable
    downscale ratio with optional pre-blur of configurable sigma).

    Level i has shape floor(shape * ratio^i); resampling via
    jax.image.resize (linear), which XLA fuses well. ratio=0.5 without blur
    reproduces the main build_pyramid semantics (use that for the hot path —
    its pad+add form is cheaper than a general resize).

    blur_sigma: Gaussian sigma of the pre-blur, realized as repeated
    [1,2,1]/4 passes (each pass has variance 0.5, so n = round(2*sigma^2)
    passes; sigma <= 0.7 is a single pass).
    """
    import jax

    n_pass = max(1, int(round(2.0 * blur_sigma * blur_sigma)))

    def pre_blur(im):
        for _ in range(n_pass):
            im = gaussian_blur3(im)
        return im

    out = [img]
    H, W = img.shape
    for i in range(1, levels):
        # Round like the reference (ref feature_tracker/src/image_operations.rs:69-70)
        # so level sizes match the exact ratio**lvl coordinate scaling the
        # tracker applies; flooring gives off-by-one sizes for some ratios.
        h = max(int(round(H * ratio**i)), 1)
        w = max(int(round(W * ratio**i)), 1)
        src = pre_blur(out[-1]) if blur else out[-1]
        out.append(jax.image.resize(src, (h, w), method="linear"))
    return tuple(out)


def pyramid_shapes(shape, levels: int) -> Sequence[tuple]:
    """Static level shapes for a given base shape (for preallocating tables)."""
    H, W = shape
    shapes = []
    for _ in range(levels):
        shapes.append((H, W))
        H, W = H // 2, W // 2
    return shapes
