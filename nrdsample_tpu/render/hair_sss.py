"""Hair BCSDF + subsurface scattering — the RTXCR material-library slot.

Reference (SURVEY.md §2.3 "RTXCR Material Library" row, optional CMake
integration `RTXCR_INTEGRATION`): a far-field hair BCSDF evaluated/sampled in
the path loop for FLAG_HAIR geometry (RaytracingShared.hlsli:35-74, eval/sample
at :593,775,861) and Burley diffusion-profile SSS applied to the sun lighting
of FLAG_SKIN geometry (:635-660).

Implementation (behavioral, not a port):
  * hair: the classic 3-lobe far-field model (R / TT / TRT) with longitudinal
    Gaussians M_p(theta_h) at cuticle-shifted angles and cosine-power azimuthal
    lobes — the standard real-time approximation of Marschner;
  * SSS: Burley normalized-diffusion profile; at shading time the sample uses
    it as a wrap-diffuse transmittance term (no screen-space blur pass), which
    is what the reference's direct-lighting SSS term amounts to.

Everything is pure elementwise math -> differentiable and VPU-friendly.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from nrdsample_tpu.mathlib import color, geometry as geo

# cuticle tilt (deg) and per-lobe longitudinal roughness scale — RTXCR defaults
HAIR_CUTICLE_TILT_DEG = 3.0
HAIR_LOBE_SHIFTS = (-1.0, 0.5, 1.5)     # R, TT, TRT in units of tilt
HAIR_LOBE_WIDTHS = (1.0, 0.5, 2.0)      # relative Gaussian widths
HAIR_LOBE_GAINS = (1.0, 1.0, 0.8)


def _gaussian(x, stddev):
    return jnp.exp(-0.5 * (x / stddev) ** 2) / (stddev * math.sqrt(2.0 * math.pi))


def hair_bcsdf_eval(wi: jnp.ndarray, wo: jnp.ndarray, tangent: jnp.ndarray,
                    base_color: jnp.ndarray, roughness: jnp.ndarray) -> jnp.ndarray:
    """Far-field hair BCSDF value (RGB) for light dir wi and view dir wo.

    wi/wo point AWAY from the surface; tangent is the hair fiber direction.
    """
    sin_ti = jnp.clip(geo.dot3(wi, tangent), -1.0, 1.0)
    sin_to = jnp.clip(geo.dot3(wo, tangent), -1.0, 1.0)
    theta_i = jnp.arcsin(sin_ti)
    theta_o = jnp.arcsin(sin_to)
    theta_h = 0.5 * (theta_i + theta_o)

    # azimuthal setup: project onto the normal plane
    wi_p = geo.normalize(wi - sin_ti[..., None] * tangent)
    wo_p = geo.normalize(wo - sin_to[..., None] * tangent)
    cos_phi = jnp.clip(geo.dot3(wi_p, wo_p), -1.0, 1.0)

    tilt = math.radians(HAIR_CUTICLE_TILT_DEG)
    beta = jnp.clip(roughness, 0.05, 1.0) * 0.3 + 0.05  # longitudinal stddev

    # absorption-driven lobe tints: R is white-ish specular, TT/TRT carry the
    # pigment (one / two transmissions)
    tint_r = jnp.ones_like(base_color) * 0.25
    tint_tt = base_color
    tint_trt = base_color * base_color

    out = jnp.zeros_like(base_color)
    az = (
        0.25 * (1.0 + cos_phi),               # R: front-scattering cosine lobe
        0.25 * (1.0 - cos_phi) + 0.05,        # TT: forward (through) scattering
        0.20 * (1.0 + cos_phi) + 0.05,        # TRT: glints near reflection
    )
    for shift, width, gain, tint, n_az in zip(
        HAIR_LOBE_SHIFTS, HAIR_LOBE_WIDTHS, HAIR_LOBE_GAINS,
        (tint_r, tint_tt, tint_trt), az,
    ):
        m = _gaussian(theta_h - shift * tilt, beta * width)
        out = out + gain * (m * n_az)[..., None] * tint

    cos_theta_o = jnp.sqrt(jnp.clip(1.0 - sin_to * sin_to, 1e-4, 1.0))
    return out / cos_theta_o[..., None]


def hair_sample(rnd: jnp.ndarray, wo: jnp.ndarray, tangent: jnp.ndarray,
                roughness: jnp.ndarray):
    """Sample a scattered direction: longitudinal Gaussian around the
    reflected inclination + uniform azimuth in the normal plane.

    rnd: (..., 2) uniforms. Returns (direction, pdf-ish weight ~1)."""
    sin_to = jnp.clip(geo.dot3(wo, tangent), -1.0, 1.0)
    theta_o = jnp.arcsin(sin_to)
    beta = jnp.clip(roughness, 0.05, 1.0) * 0.3 + 0.05
    # Box-Muller for the longitudinal Gaussian
    r1 = jnp.clip(rnd[..., 0], 1e-6, 1.0 - 1e-6)
    r2 = rnd[..., 1]
    g = jnp.sqrt(-2.0 * jnp.log(r1)) * jnp.cos(2.0 * math.pi * r2)
    theta_i = -theta_o + math.radians(HAIR_CUTICLE_TILT_DEG) + g * beta
    theta_i = jnp.clip(theta_i, -0.49 * math.pi, 0.49 * math.pi)

    phi = 2.0 * math.pi * rnd[..., 1]
    # build the normal-plane basis around the tangent
    b1, b2 = geo.orthonormal_basis(tangent)
    sin_ti = jnp.sin(theta_i)
    cos_ti = jnp.cos(theta_i)
    d = (
        tangent * sin_ti[..., None]
        + b1 * (cos_ti * jnp.cos(phi))[..., None]
        + b2 * (cos_ti * jnp.sin(phi))[..., None]
    )
    return geo.normalize(d), jnp.ones_like(theta_i)


def burley_profile(r: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Burley normalized-diffusion R(r): integrates to 1 over the plane."""
    r = jnp.maximum(r, 1e-5)
    return (jnp.exp(-r / d) + jnp.exp(-r / (3.0 * d))) / (
        8.0 * math.pi * d * r
    )


def sss_wrap_diffuse(n_dot_l: jnp.ndarray, base_color: jnp.ndarray,
                     scatter_distance: jnp.ndarray | float = 0.3) -> jnp.ndarray:
    """Subsurface wrap term replacing the hard cosine for FLAG_SKIN
    (the direct-lighting SSS application of RaytracingShared.hlsli:635-660):
    light wraps around the terminator proportionally to the mean free path,
    tinted by the albedo (deeper transport = more saturated)."""
    w = jnp.clip(jnp.asarray(scatter_distance), 0.0, 1.0)
    wrap = jnp.clip((n_dot_l + w) / (1.0 + w), 0.0, 1.0)
    hard = jnp.clip(n_dot_l, 0.0, 1.0)
    scatter_tint = base_color * base_color  # two-pass pigment absorption
    return (
        hard[..., None] * jnp.ones_like(base_color)
        + (wrap - hard)[..., None] * scatter_tint
    )
