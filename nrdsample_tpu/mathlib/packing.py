"""Unit-vector / value packing — ml.hlsli ``Packing::*`` equivalents.

We prefer separate float planes over bit-packing (SURVEY.md §7.1), but the
octahedral encoding is still used for compact G-buffer normal storage and for
parity with the reference's fp16 octahedral normals in PrimitiveData
(Shared.hlsli:179-181).
"""

from __future__ import annotations

import jax.numpy as jnp


def _sign_not_zero(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(v >= 0.0, 1.0, -1.0)


def encode_oct(n: jnp.ndarray) -> jnp.ndarray:
    """Octahedral-encode unit vectors [..., 3] -> [..., 2] in [-1, 1]."""
    l1 = jnp.sum(jnp.abs(n), axis=-1, keepdims=True)
    p = n[..., :2] / jnp.maximum(l1, 1e-15)
    fold = (1.0 - jnp.abs(p[..., ::-1])) * _sign_not_zero(p)
    return jnp.where(n[..., 2:3] <= 0.0, fold, p)


def decode_oct(e: jnp.ndarray) -> jnp.ndarray:
    """Decode octahedral [..., 2] -> unit vectors [..., 3]."""
    z = 1.0 - jnp.sum(jnp.abs(e), axis=-1, keepdims=True)
    fold = (1.0 - jnp.abs(e[..., ::-1])) * _sign_not_zero(e)
    xy = jnp.where(z < 0.0, fold, e)
    v = jnp.concatenate([xy, z], axis=-1)
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def pack_normal_roughness(n: jnp.ndarray, roughness: jnp.ndarray, material_id: jnp.ndarray) -> jnp.ndarray:
    """G-buffer normal+roughness+materialID plane: [..., 4].

    The reference packs via NRD_FrontEnd_PackNormalAndRoughness into RGBA8/R10G10B10A2
    (TraceOpaque.cs.hlsl:636-657); we keep an f32/bf16 plane: oct.x, oct.y,
    roughness, materialID.
    """
    e = encode_oct(n)
    return jnp.concatenate(
        [e, roughness[..., None], material_id[..., None]], axis=-1
    )


def unpack_normal_roughness(p: jnp.ndarray):
    return decode_oct(p[..., :2]), p[..., 2], p[..., 3]
