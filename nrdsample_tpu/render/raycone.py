"""Ray cones — texture LOD + curvature-aware spread tracking.

Reference: RaytracingShared.hlsli keeps a per-path cone: primary spread set
from the pixel angle (``gUnproject``), width grown by distance at each hit,
spread widened by surface curvature on reflection (:121-152); the hit's mip
level comes from the cone footprint vs. the triangle's UV-to-world density
(:154-189, consumed in CastRay :389-397). This is the Ray Tracing Gems ch.20
scheme, which ports to batched arrays unchanged (SURVEY.md §7.1: "ray cones
port as-is").

State is two floats per ray (width, spread) threaded through the path loop.
"""

from __future__ import annotations

import jax.numpy as jnp


def pixel_spread_angle(fov_y_deg: float, height: int) -> float:
    """Primary cone spread = vertical pixel angle (gUnproject analogue)."""
    import math

    return 2.0 * math.tan(math.radians(fov_y_deg) * 0.5) / height


def init_cone(n: int, spread: float, dtype=jnp.float32):
    """(width, angle) at the camera: zero width, per-pixel angle."""
    return {
        "width": jnp.zeros((n,), dtype),
        "spread": jnp.full((n,), spread, dtype),
    }


def propagate(cone: dict, t: jnp.ndarray) -> dict:
    """Grow the cone over a segment of length t (hlsli: w += t * spread)."""
    return {
        "width": cone["width"] + t * cone["spread"],
        "spread": cone["spread"],
    }


def reflect(cone: dict, curvature: jnp.ndarray, roughness: jnp.ndarray | None = None) -> dict:
    """Widen the spread at a bounce: surface curvature adds 2|k| per unit
    width (RT Gems eq. 20.31); rough reflections add a GGX-lobe-driven term so
    secondary hits fetch blurrier mips (the reference folds this into
    ``GetSpecMagicCurve``-scaled cone growth)."""
    spread = cone["spread"] + 2.0 * jnp.abs(curvature)
    if roughness is not None:
        spread = spread + roughness * roughness * 0.25
    return {"width": cone["width"], "spread": spread}


def texture_mip(cone_width: jnp.ndarray, world_area: jnp.ndarray,
                uv_area: jnp.ndarray, n_dot_v: jnp.ndarray,
                tex_res: int, max_mip: float | None = None) -> jnp.ndarray:
    """Continuous mip level for a cone hitting a triangle.

    RT Gems ch.20 / RaytracingShared.hlsli:154-189: project the cone footprint
    onto the surface (divide by |n.v|), convert world area to texel area via
    the triangle's uv/world density, take 0.5*log2.
    """
    n_dot_v = jnp.clip(jnp.abs(n_dot_v), 0.05, 1.0)
    texel_density = uv_area * (tex_res * tex_res) / jnp.maximum(world_area, 1e-12)
    footprint = (cone_width / n_dot_v) ** 2
    mip = 0.5 * jnp.log2(jnp.maximum(footprint * texel_density, 1e-20))
    mip = jnp.maximum(mip, 0.0)
    if max_mip is not None:
        mip = jnp.minimum(mip, max_mip)
    return mip


def uv_area(uv0: jnp.ndarray, uv1: jnp.ndarray, uv2: jnp.ndarray) -> jnp.ndarray:
    """Triangle area in UV space, (T,) given (T, 2) corners."""
    d1 = uv1 - uv0
    d2 = uv2 - uv0
    return 0.5 * jnp.abs(d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0])
