"""OCCLUSION / DIRECTIONAL_OCCLUSION NRD modes.

Reference (SURVEY.md §5.6 tier 1): ``NRD_MODE == OCCLUSION`` switches the whole
stack to hit-distance-only signals — the tracer packs normalized hit distance
instead of radiance (TraceOpaque.cs.hlsl:730-759 ``OCCLUSION`` branch of the
front-end pack), the denoiser runs the *_OCCLUSION variants
(NRDSample.cpp:888-899), and Composition reconstructs an AO-modulated image
(Composition.cs.hlsl:127-168). DIRECTIONAL_OCCLUSION additionally packs the
first-bounce direction and resolves a bent-normal AO (SH variant).

Layout: occlusion is a 1-channel image-plane; the REBLUR/RELAX stencil
machinery is reused by expanding to the stencil's channel layout.
"""

from __future__ import annotations

import jax.numpy as jnp

from nrdsample_tpu.mathlib import geometry as geo


def norm_hitdist(hitdist: jnp.ndarray, view_z: jnp.ndarray,
                 a: float = 3.0, b: float = 0.1) -> jnp.ndarray:
    """REBLUR-style hit-distance normalization ``hitT / (A + B*|viewZ|)``
    (the gHitDistSettings defaults the sample leaves untouched)."""
    return hitdist / (a + b * jnp.abs(view_z))


def occlusion_from_hitdist(norm_hitdist: jnp.ndarray) -> jnp.ndarray:
    """Normalized hit distance -> [0,1] ambient occlusion term.

    The REBLUR hit-distance normalization already maps distance into [0,1]
    (longer = more open); clamping is all that remains.
    """
    return jnp.clip(norm_hitdist, 0.0, 1.0)


def directional_occlusion(norm_hitdist: jnp.ndarray, bounce_dir: jnp.ndarray,
                          normal: jnp.ndarray) -> jnp.ndarray:
    """Bent-normal AO: weight openness by how well the unoccluded direction
    aligns with the surface normal (SH/DIRECTIONAL_OCCLUSION resolve)."""
    occ = occlusion_from_hitdist(norm_hitdist)
    cos = jnp.clip(geo.dot3(bounce_dir, normal), 0.0, 1.0)
    return occ * (0.25 + 0.75 * cos)


def compose_occlusion(gb: dict, diff_occ: jnp.ndarray, spec_occ: jnp.ndarray,
                      shadow: jnp.ndarray) -> jnp.ndarray:
    """Composition for occlusion modes (Composition.cs.hlsl:127-168): direct
    light + AO-modulated albedo ambient instead of traced radiance."""
    direct = gb["direct_lighting"] * shadow[..., None] + gb["emission"]
    ambient_diff = gb["diff_factor"] * diff_occ[..., None]
    ambient_spec = gb["spec_factor"] * spec_occ[..., None]
    return direct + ambient_diff + ambient_spec
