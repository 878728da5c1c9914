"""Stateless hash-based RNG + low-discrepancy sequences.

Array-native replacement for the reference's ``Rng::Hash`` (PCG-style per-pixel hash,
seeded in ``TraceOpaque.cs.hlsl:539`` from (pixelPos, frameIndex)) and the
``Sequence::{Bayer4x4, Weyl, Halton, CheckerBoard}`` helpers of ml.hlsli.

Design: no mutable state. Every random number is a pure function of
(pixel_index, frame, dimension) through a PCG4D hash — this keeps the whole frame
function replayable from (frame index, seed, settings), which is the failure-
recovery story (SURVEY.md §5.3), and maps perfectly onto the VPU: all lanes hash
in parallel with no sequential dependence.
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32


def pcg4d(v: jnp.ndarray) -> jnp.ndarray:
    """PCG4D hash (Jarzynski & Olano, JCGT 2020). v: uint32 [..., 4] -> uint32 [..., 4]."""
    v = v.astype(_U32)
    v = v * _U32(1664525) + _U32(1013904223)
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return jnp.stack([x, y, z, w], axis=-1)


def hash_u32(pixel: jnp.ndarray, frame, dim) -> jnp.ndarray:
    """4 independent uint32 random words per element.

    pixel: int array [...] (flat pixel/ray index); frame, dim: scalars or arrays
    broadcastable to pixel's shape. Dimension `dim` separates streams (bounce,
    purpose, sample index) — bump it for every independent draw.
    """
    pixel = jnp.asarray(pixel)
    frame = jnp.broadcast_to(jnp.asarray(frame), pixel.shape)
    dim = jnp.broadcast_to(jnp.asarray(dim), pixel.shape)
    v = jnp.stack(
        [
            pixel.astype(_U32),
            frame.astype(_U32),
            dim.astype(_U32),
            jnp.full(pixel.shape, 0x9E3779B9, dtype=_U32),
        ],
        axis=-1,
    )
    return pcg4d(v)


def _to_unit_float(u: jnp.ndarray) -> jnp.ndarray:
    # take the top 24 bits -> [0, 1) exactly representable in f32
    return (u >> 8).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


def uniform4(pixel, frame, dim) -> jnp.ndarray:
    """4 uniform floats in [0,1) per element: [..., 4]."""
    return _to_unit_float(hash_u32(pixel, frame, dim))


def uniform2(pixel, frame, dim) -> jnp.ndarray:
    return uniform4(pixel, frame, dim)[..., :2]


def uniform1(pixel, frame, dim) -> jnp.ndarray:
    return uniform4(pixel, frame, dim)[..., 0]


# ---------------------------------------------------------------------------
# Low-discrepancy sequences (ml.hlsli Sequence::*)
# ---------------------------------------------------------------------------

# Bayer 4x4 ordered-dither matrix, normalized to [0,1). Sequence::Bayer4x4.
_BAYER4 = (
    jnp.array(
        [[0, 8, 2, 10], [12, 4, 14, 6], [3, 11, 1, 9], [15, 7, 13, 5]],
        dtype=jnp.float32,
    )
    / 16.0
)


def bayer4x4(px: jnp.ndarray, py: jnp.ndarray, frame=0) -> jnp.ndarray:
    """Ordered-dither value in [0,1) for integer pixel coords, rotating with frame.

    The reference uses Bayer4x4 to decorrelate the first-bounce lobe choice
    (TraceOpaque.cs.hlsl:189-197) and for output dithering (Final.cs.hlsl:31-35).
    """
    idx = (px.astype(jnp.int32) & 3), (py.astype(jnp.int32) & 3)
    base = _BAYER4[idx[1], idx[0]]
    # Weyl rotation over frames keeps the 16-frame cycle low-discrepancy.
    rot = jnp.asarray(frame, jnp.float32) * jnp.float32(0.618034)
    return jnp.mod(base + rot, 1.0)


def weyl1d(n, seed: int = 0) -> jnp.ndarray:
    """1-D Weyl (additive-recurrence) sequence."""
    n = jnp.asarray(n, jnp.float32)
    return jnp.mod(jnp.float32(seed) + n * jnp.float32(0.618034), 1.0)


def weyl2d(n) -> jnp.ndarray:
    """2-D Weyl sequence with the plastic-number basis (R2 sequence)."""
    n = jnp.asarray(n, jnp.float32)[..., None]
    alphas = jnp.array([0.7548776662, 0.5698402910], jnp.float32)
    return jnp.mod(n * alphas, 1.0)


def halton(n, base: int) -> jnp.ndarray:
    """Radical inverse of n in the given base (static unroll, 32-bit range)."""
    n = jnp.asarray(n, jnp.int32)
    result = jnp.zeros(n.shape, jnp.float32)
    f = jnp.float32(1.0)
    inv_b = jnp.float32(1.0 / base)
    for _ in range(_halton_iters(base)):
        f = f * inv_b
        result = result + f * (n % base).astype(jnp.float32)
        n = n // base
    return result


def _halton_iters(base: int) -> int:
    import math

    return max(1, int(math.ceil(32 * math.log(2) / math.log(base))))


def halton23(n) -> jnp.ndarray:
    """The standard (2,3) Halton point used for camera jitter [..., 2].

    Reference: camera jitter comes from NRIFramework's Camera via gJitter; the
    canonical sequence is Halton(2,3) centered to [-0.5, 0.5].
    """
    return jnp.stack([halton(n, 2), halton(n, 3)], axis=-1)


def checkerboard(px, py, frame) -> jnp.ndarray:
    """2x2 checkerboard selector alternating per frame (Sequence::CheckerBoard).

    Returns int32 0/1; the reference uses this for RESOLUTION_HALF diff/spec
    interleave (TraceOpaque.cs.hlsl:485-518).
    """
    return ((px.astype(jnp.int32) ^ py.astype(jnp.int32) ^ jnp.asarray(frame, jnp.int32)) & 1)
