"""Spatiotemporal blue-noise sampler for shadow rays.

Reference: GetBlueNoise (RaytracingShared.hlsli:699-723) — NVIDIA's
scrambling/ranking + Sobol spatiotemporal blue-noise textures, used for the
sun-shadow disc sample when USE_BLUE_NOISE_FOR_SHADOWS (Shared.hlsli:25,
"a must have for SIGMA"). Blue noise pushes the per-frame sampling error into
high spatial frequencies that SIGMA's penumbra blur (and the eye) average
away, so soft shadows converge visibly faster at 1 spp.

In-repo stand-in: a shipped 128x128 void-and-cluster ranking texture
(tools/gen_bluenoise.py, Ulichney's algorithm — no NVIDIA assets) with
golden-ratio temporal rotation (Cranley-Patterson) and an R2-lattice spatial
shift per dimension. Each dimension's field keeps the blue spectrum exactly
(rotation/translation don't change it); frames decorrelate via the rotation.
"""

from __future__ import annotations

import os

import numpy as np
import jax.numpy as jnp

BN_SIZE = 128
_PHI1 = 0.6180339887498949          # 1/phi, golden-ratio sequence
_R2 = (0.7548776662466927, 0.5698402909980532)  # plastic-constant R2 lattice

_TEXTURE_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", f"bluenoise_{BN_SIZE}.npy")
_texture_np: np.ndarray | None = None


def _texture() -> np.ndarray:
    global _texture_np
    if _texture_np is None:
        _texture_np = np.load(_TEXTURE_PATH)
    return _texture_np


def _sample(px, py, frame, dim: int, channel: int):
    """One blue field: texture at an R2-shifted position + golden temporal
    rotation. (dim, channel) are STATIC ints — each (dim, channel) pair gets
    its own decorrelated field."""
    tex = jnp.asarray(_texture())
    k = dim * 2 + channel
    ox = int(_R2[0] * k * 997) % BN_SIZE
    oy = int(_R2[1] * k * 1499) % BN_SIZE
    v = tex[(py + oy) % BN_SIZE, (px + ox) % BN_SIZE]
    # temporal Cranley-Patterson rotation; fold frame first to keep f32 exact
    f = jnp.mod((frame + k * 61) % 4096, 4096).astype(v.dtype)
    return jnp.mod(v + f * _PHI1, 1.0)


def blue2(pixel_idx, width: int, frame, dim: int):
    """(n, 2) blue-noise sample in [0,1)^2 — drop-in for rng.uniform2 at
    shadow-disc dims. width is the render width (pixel_idx = y*width + x)."""
    px = pixel_idx % width
    py = pixel_idx // width
    u = _sample(px, py, frame, dim, 0)
    v = _sample(px, py, frame, dim, 1)
    return jnp.stack([u, v], axis=-1)


def blue1(pixel_idx, width: int, frame, dim: int):
    """(n,) blue-noise sample in [0,1)."""
    px = pixel_idx % width
    py = pixel_idx // width
    return _sample(px, py, frame, dim, 0)
