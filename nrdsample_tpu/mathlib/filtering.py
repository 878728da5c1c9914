"""Sampling filters: bilinear, 5-tap bicubic, Catmull-Rom weights.

ml.hlsli ``Filtering::GetBilinearFilter`` + Shared.hlsli BicubicFilterNoCorners
(:349-387). Gathers are the denoisers' reprojection primitive.

Two bilinear forms: ``sample_bilinear`` (four single-texel gathers, used
inline by every denoiser) and ``sample_bilinear_block`` (one (2,2,C)
footprint gather, used by the staged gather pass, denoise/gatherpass.py).
Both clamp to the edge and agree exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _gather2d(img: jnp.ndarray, ix: jnp.ndarray, iy: jnp.ndarray) -> jnp.ndarray:
    h, w = img.shape[0], img.shape[1]
    ix = jnp.clip(ix, 0, w - 1)
    iy = jnp.clip(iy, 0, h - 1)
    return img[iy, ix]


def sample_bilinear(img: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample via four single-texel gathers.

    pos [..., 2] = (x, y) in pixel units; clamp-to-edge.
    """
    p = pos - 0.5
    i0 = jnp.floor(p).astype(jnp.int32)
    f = p - i0
    x0, y0 = i0[..., 0], i0[..., 1]
    fx, fy = f[..., 0:1], f[..., 1:2]
    if img.ndim == 2:
        fx, fy = fx[..., 0], fy[..., 0]
    c00 = _gather2d(img, x0, y0)
    c10 = _gather2d(img, x0 + 1, y0)
    c01 = _gather2d(img, x0, y0 + 1)
    c11 = _gather2d(img, x0 + 1, y0 + 1)
    return (
        c00 * (1 - fx) * (1 - fy)
        + c10 * fx * (1 - fy)
        + c01 * (1 - fx) * fy
        + c11 * fx * fy
    )


def sample_bilinear_block(img: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample as ONE footprint gather (slice_sizes (2, 2, C)).

    Edge behavior matches
    per-tap clamping exactly: the start index is clipped to [0, size-2] and
    the fractional weight saturates to 0/1.
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    p = pos - 0.5
    i0 = jnp.floor(p).astype(jnp.int32)
    ix = jnp.clip(i0[..., 0], 0, max(w - 2, 0))
    iy = jnp.clip(i0[..., 1], 0, max(h - 2, 0))
    batch = ix.shape
    m = 1
    for d in batch:
        m *= d
    # the whole blend stays in the FLAT (M, 2, 2, C) index space (no
    # (H, W, 2, 2, C) intermediate with tiny trailing dims)
    fx = jnp.clip(p[..., 0] - ix.astype(img.dtype), 0.0, 1.0).reshape(m, 1)
    fy = jnp.clip(p[..., 1] - iy.astype(img.dtype), 0.0, 1.0).reshape(m, 1)
    idx = jnp.stack([iy.reshape(-1), ix.reshape(-1)], axis=-1)
    blk = jax.lax.gather(
        img, idx,
        jax.lax.GatherDimensionNumbers(
            offset_dims=(1, 2, 3), collapsed_slice_dims=(),
            start_index_map=(0, 1)),
        slice_sizes=(min(2, h), min(2, w), c),
        mode=jax.lax.GatherScatterMode.CLIP,
    )
    if h < 2:
        blk = jnp.concatenate([blk, blk], axis=1)
    if w < 2:
        blk = jnp.concatenate([blk, blk], axis=2)
    out = (
        blk[:, 0, 0] * (1 - fx) * (1 - fy)
        + blk[:, 0, 1] * fx * (1 - fy)
        + blk[:, 1, 0] * (1 - fx) * fy
        + blk[:, 1, 1] * fx * fy
    )
    out = out.reshape(batch + (c,))
    return out[..., 0] if squeeze else out


def sample_bicubic_no_corners(img: jnp.ndarray, pos: jnp.ndarray,
                              sharpness: float = 0.66,
                              bilinear_fn=sample_bilinear) -> jnp.ndarray:
    """5-tap bicubic (corners dropped) — BicubicFilterNoCorners (Shared.hlsli:349-387).

    Used for TAA history resampling (Taa.cs.hlsl:122-123) with
    TAA_HISTORY_SHARPNESS. ``bilinear_fn`` selects the tap primitive (pass
    sample_bilinear_block from gather-pass programs).
    """
    center = jnp.floor(pos - 0.5) + 0.5
    f = jnp.clip(pos - center, 0.0, 1.0)
    f2 = f * f
    f3 = f * f2
    s = sharpness
    w0 = -s * f3 + 2.0 * s * f2 - s * f
    w1 = (2.0 - s) * f3 - (3.0 - s) * f2 + 1.0
    w2 = -(2.0 - s) * f3 + (3.0 - 2.0 * s) * f2 + s * f
    w3 = s * f3 - s * f2
    wl2 = w1 + w2
    tc2 = center + w2 / jnp.maximum(wl2, 1e-15)
    tc0 = center - 1.0
    tc3 = center + 2.0

    def tap(px, py):
        return bilinear_fn(img, jnp.stack([px, py], axis=-1))

    w = wl2[..., 0] * w0[..., 1]
    color = tap(tc2[..., 0], tc0[..., 1]) * w[..., None]
    total = w
    w = w0[..., 0] * wl2[..., 1]
    color += tap(tc0[..., 0], tc2[..., 1]) * w[..., None]
    total += w
    w = wl2[..., 0] * wl2[..., 1]
    color += tap(tc2[..., 0], tc2[..., 1]) * w[..., None]
    total += w
    w = w3[..., 0] * wl2[..., 1]
    color += tap(tc3[..., 0], tc2[..., 1]) * w[..., None]
    total += w
    w = wl2[..., 0] * w3[..., 1]
    color += tap(tc2[..., 0], tc3[..., 1]) * w[..., None]
    total += w
    return color / jnp.maximum(total, 1e-15)[..., None]


def catmull_rom_weights(f: jnp.ndarray):
    """Catmull-Rom weights for 1-D fraction f: returns (w-1, w0, w1, w2)."""
    f2 = f * f
    f3 = f2 * f
    return (
        -0.5 * f3 + f2 - 0.5 * f,
        1.5 * f3 - 2.5 * f2 + 1.0,
        -1.5 * f3 + 2.0 * f2 + 0.5 * f,
        0.5 * f3 - 0.5 * f2,
    )
