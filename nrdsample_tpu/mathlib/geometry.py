"""Geometry helpers — ml.hlsli ``Geometry::*`` equivalents + ray offsets.

Conventions: row vectors, matrices are [..., 4, 4] applied as ``(M @ [x, 1])``;
view space is right-handed looking down -Z? No — we match the reference's
MathLib: view space looks down +Z with ``viewZ > 0`` for visible geometry in LH
projection; here we simply define view space as camera-local with +Z forward so
``viewZ`` is positive depth, which is what every denoiser pass consumes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST  # full f32 products (no TF32 on GPUs)


def dot3(a, b):
    return jnp.sum(a * b, axis=-1)


def length(v, eps: float = 1e-15):
    """Gradient-safe |v|: sqrt is evaluated on a clamped argument so the
    zero-vector case has a finite (zero) gradient instead of NaN."""
    return jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1), eps * eps))


def normalize(v, eps: float = 1e-15):
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    return v * jax.lax.rsqrt(jnp.maximum(n2, eps * eps))


def cross(a, b):
    return jnp.cross(a, b)


def affine_transform(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply [..., 4, 4] (or [4,4]) affine matrix to points [..., 3]."""
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], p, precision=_HI) + m[..., :3, 3]


def rotate_vector(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate (no translate) vectors by the upper 3x3 of a 4x4 matrix."""
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], v, precision=_HI)


def project(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Full projective transform -> NDC [..., 3]."""
    h = jnp.einsum("...ij,...j->...i", m[..., :4, :3], p, precision=_HI) + m[..., :4, 3]
    return h[..., :3] / jnp.where(jnp.abs(h[..., 3:4]) < 1e-15, 1e-15, h[..., 3:4])


def get_screen_uv(world_to_clip: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """World position -> screen UV in [0,1] (y down), Geometry::GetScreenUv."""
    ndc = project(world_to_clip, p)
    return jnp.stack([ndc[..., 0] * 0.5 + 0.5, 0.5 - ndc[..., 1] * 0.5], axis=-1)


def orthonormal_basis(n: jnp.ndarray):
    """Build a right-handed TBN around unit normal n (Frisvad / Pixar revised).

    ml.hlsli Geometry::GetBasis equivalent. Returns (t, b) with n = t x b.
    """
    s = _sign_copy(n[..., 2])
    a = -1.0 / (s + n[..., 2])
    bv = n[..., 0] * n[..., 1] * a
    t = jnp.stack(
        [1.0 + s * n[..., 0] * n[..., 0] * a, s * bv, -s * n[..., 0]], axis=-1
    )
    b = jnp.stack([bv, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return t, b


def _sign_copy(v):
    return jnp.where(v >= 0.0, 1.0, -1.0)


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    return v - 2.0 * dot3(v, n)[..., None] * n


def refract(v: jnp.ndarray, n: jnp.ndarray, eta) -> jnp.ndarray:
    """Refract incident v (pointing into surface) about n; returns 0 on TIR.

    eta = n_i / n_t, scalar or per-element array broadcastable to v[..., 0]."""
    eta = jnp.asarray(eta)
    cos_i = -dot3(v, n)
    sin2_t = (eta**2) * jnp.maximum(0.0, 1.0 - cos_i**2)
    tir = sin2_t > 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t) + 1e-12)
    r = eta[..., None] * v + (eta * cos_i - cos_t)[..., None] * n
    return jnp.where(tir[..., None], jnp.zeros_like(r), r)


def offset_ray(p: jnp.ndarray, n: jnp.ndarray, view_z, unproject, offset_pixels: float):
    """Self-intersection-avoidance offset along the normal.

    The reference offsets ray origins by a fixed number of *pixels* of world size
    (`_GetConeBaseOffset`/ray offsets, RaytracingShared.hlsli:121-132, with
    PT_*_RAY_OFFSET in Shared.hlsli:114-116): world offset = pixels * unproject *
    viewZ, clamped to a small minimum.
    """
    w = jnp.abs(jnp.asarray(view_z)) * unproject * offset_pixels
    w = jnp.maximum(w, 1e-5)
    return p + n * w[..., None]


def solid_angle_to_cos(tan_angular_radius):
    """cos of the apex half-angle from its tangent."""
    t = jnp.asarray(tan_angular_radius)
    return 1.0 / jnp.sqrt(1.0 + t * t)


def smoothstep(a, b, x):
    """Hermite smoothstep supporting DECREASING edges (a > b), matching
    STL::Math::SmoothStep — e.g. SmoothStep(0.2, 0.0, x) is 1 at x=0 and
    falls to 0 at x=0.2 (used by the NRD hit-distance accumulation,
    TraceOpaque.cs.hlsl:390)."""
    d = b - a
    d = jnp.where(jnp.abs(d) < 1e-15, jnp.where(d >= 0, 1e-15, -1e-15), d)
    t = jnp.clip((x - a) / d, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def pow01(x, e):
    """x^e on [0,1], gradient-safe at 0 (d/dx x^e -> inf for e<1 would poison
    autodiff through 0*inf=NaN; the where-guard zeroes that branch)."""
    xc = jnp.clip(x, 0.0, 1.0)
    safe = jnp.power(jnp.maximum(xc, 1e-9), e)
    return jnp.where(xc <= 0.0, 0.0, safe)


def sqrt01(x):
    """sqrt on [0,1], gradient-safe at 0 (same rationale as pow01)."""
    xc = jnp.clip(x, 0.0, 1.0)
    return jnp.where(xc <= 0.0, 0.0, jnp.sqrt(jnp.maximum(xc, 1e-12)))


def positive_rcp(x, eps: float = 1e-15):
    return 1.0 / jnp.maximum(x, eps)
