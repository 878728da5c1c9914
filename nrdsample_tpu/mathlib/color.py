"""Color transforms — ml.hlsli ``Color::*`` + tonemapping (Shared.hlsli:337-347).

Includes CIELAB used by the TAA disocclusion JND test (Taa.cs.hlsl:44-54).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST  # full f32 products (no TF32 on GPUs)

_LUMA = jnp.array([0.2126, 0.7152, 0.0722], jnp.float32)


def luminance(c: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(c * _LUMA, axis=-1)


def from_gamma(c, gamma: float = 2.2):
    return jnp.power(jnp.clip(c, 0.0, 1.0), gamma)


def to_gamma(c, gamma: float = 2.2):
    return jnp.power(jnp.clip(c, 0.0, 1.0), 1.0 / gamma)


def linear_to_srgb(c: jnp.ndarray) -> jnp.ndarray:
    c = jnp.clip(c, 0.0, 1.0)
    # safe-where: pow is evaluated for ALL lanes, and d/dc c^(1/2.4) -> inf at
    # c=0 poisons autodiff through the untaken branch (0 * inf = NaN)
    c_safe = jnp.maximum(c, 0.0031308)
    return jnp.where(
        c <= 0.0031308, 12.92 * c, 1.055 * jnp.power(c_safe, 1.0 / 2.4) - 0.055
    )


def srgb_to_linear(c: jnp.ndarray) -> jnp.ndarray:
    c = jnp.clip(c, 0.0, 1.0)
    return jnp.where(c <= 0.04045, c / 12.92, jnp.power((c + 0.055) / 1.055, 2.4))


# --- Uncharted 2 filmic tonemap (Color::HdrToLinear_Uncharted, used in
# ApplyTonemap Shared.hlsli:337 and DlssAfter.cs.hlsl:7-22) ---

_UA, _UB, _UC, _UD, _UE, _UF, _UW = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30, 11.2


def _uncharted_curve(x):
    return ((x * (_UA * x + _UC * _UB) + _UD * _UE) / (x * (_UA * x + _UB) + _UD * _UF)) - _UE / _UF


def tonemap_uncharted(c: jnp.ndarray, exposure_bias: float = 2.0) -> jnp.ndarray:
    white = _uncharted_curve(jnp.float32(_UW))
    return _uncharted_curve(c * exposure_bias) / white


def inverse_tonemap_lum(y):
    """Approximate inverse of the luminance tonemap curve, used by the confidence
    mapping in ConfidenceBlur.cs.hlsl:91-103 (gradient -> confidence)."""
    y = jnp.clip(y, 0.0, 0.99)
    return y / jnp.maximum(1.0 - y, 1e-3)


# --- CIELAB (Taa.cs.hlsl XyzToLab, 44-54) ---

_RGB2XYZ = jnp.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ],
    jnp.float32,
)
_WHITE = jnp.array([0.950489, 1.0, 1.088840], jnp.float32)


def rgb_to_lab(rgb: jnp.ndarray) -> jnp.ndarray:
    xyz = jnp.einsum("ij,...j->...i", _RGB2XYZ, jnp.maximum(rgb, 0.0), precision=_HI) / _WHITE
    f = jnp.where(xyz > 0.008856, jnp.cbrt(jnp.maximum(xyz, 1e-9)), 7.787 * xyz + 16.0 / 116.0)
    l = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return jnp.stack([l, a, b], axis=-1)
