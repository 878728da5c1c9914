"""Stress-test fault injection + sanitization — SURVEY.md §4.4 / §5.2 parity.

Reference compile-time fault injectors (Shared.hlsli:28-45):
  * ``USE_DRS_STRESS_TEST``  — write GARBAGE (sqrt(-1)) outside the dynamic-
    resolution rect (Shared.hlsli:150, TraceOpaque.cs.hlsl:531-533) to prove
    the denoisers never read out-of-rect texels;
  * ``USE_INF_STRESS_TEST``  — garbage outside the denoising z-range
    (TraceOpaque.cs.hlsl:628-630);
  * ``USE_SIMULATED_FIREFLY_TEST`` — 10^4x random fireflies
    (TraceOpaque.cs.hlsl:720-728) to exercise anti-firefly filters;
  * ``USE_SIMULATED_MATERIAL_ID_TEST`` — material-ID stripes;
  * ``USE_SANITIZATION`` + NRD_IsValidRadiance — NAN/INF gating (:424).

The DRS rect is the reference's ``gRectSize`` cropping
(NRDSample.cpp:2104-2109): render into a padded max-size buffer, use only the
top-left ``resolution_scale`` fraction. Here the rect mask doubles as the
denoiser validity mask.
"""

from __future__ import annotations

import jax.numpy as jnp

from nrdsample_tpu import config
from nrdsample_tpu.config import RenderConfig, Settings
from nrdsample_tpu.mathlib import rng

GARBAGE = float("nan")  # sqrt(-1) in the reference, Shared.hlsli:150

#: view-z beyond this is outside the "denoising range" (NRD's default
#: denoisingRange is 500000; the sample uses it through gDenoisingRange)
DENOISING_RANGE = 1.0e4


def rect_mask(cfg: RenderConfig, settings: Settings, pixel_idx: jnp.ndarray) -> jnp.ndarray:
    """True for pixels inside the DRS rect (gRectSize semantics)."""
    px = pixel_idx % cfg.width
    py = pixel_idx // cfg.width
    rw = jnp.ceil(cfg.width * settings.resolution_scale).astype(jnp.int32)
    rh = jnp.ceil(cfg.height * settings.resolution_scale).astype(jnp.int32)
    return (px < rw) & (py < rh)


def apply_stress_tests(gb: dict, cfg: RenderConfig, settings: Settings,
                       pixel_idx: jnp.ndarray, frame) -> dict:
    """Inject faults into the traced G-buffer per the enabled cfg switches."""
    out = dict(gb)

    def poison(a, bad_mask):
        m = bad_mask
        while m.ndim < a.ndim:
            m = m[..., None]
        return jnp.where(m, GARBAGE, a)

    radiance_keys = ("diff_radiance", "spec_radiance", "direct_lighting",
                     "emission", "view_z")

    if cfg.use_drs_stress_test:
        outside = jnp.logical_not(rect_mask(cfg, settings, pixel_idx))
        for k in radiance_keys:
            out[k] = poison(out[k], outside)

    if cfg.use_inf_stress_test:
        far = jnp.abs(gb["view_z"]) > DENOISING_RANGE
        for k in ("diff_radiance", "spec_radiance"):
            out[k] = poison(out[k], far)

    if cfg.use_firefly_test:
        # TraceOpaque.cs.hlsl:720-728: rare huge spikes on the indirect signal
        u = rng.uniform1(pixel_idx, frame, 555)
        spike = (u < 0.004).astype(out["diff_radiance"].dtype) * 9999.0 + 1.0
        out["diff_radiance"] = out["diff_radiance"] * spike[..., None]
        out["spec_radiance"] = out["spec_radiance"] * spike[..., None]

    if cfg.use_material_id_test:
        py = pixel_idx // cfg.width
        stripe = ((py // 8) % 2).astype(out["material_id"].dtype)
        out["material_id"] = stripe

    return out


def is_valid_radiance(c: jnp.ndarray) -> jnp.ndarray:
    """NRD_IsValidRadiance: finite and non-negative (reduced over channels)."""
    ok = jnp.isfinite(c) & (c >= 0.0)
    return jnp.all(ok, axis=-1) if c.ndim > 1 else ok


def sanitize_gbuffer(gb: dict, cfg: RenderConfig, settings: Settings,
                     pixel_idx: jnp.ndarray) -> dict:
    """USE_SANITIZATION: zero out NAN/INF/negative radiance and clamp aux
    channels so downstream passes never consume garbage. Out-of-rect pixels
    (DRS) are also neutralized — the equivalent of "the denoiser
    only dispatches over gRectSize"."""
    out = dict(gb)
    inside = rect_mask(cfg, settings, pixel_idx)

    def clean_radiance(a):
        valid = is_valid_radiance(a) & inside
        return jnp.where(valid[..., None] if a.ndim > 1 else valid, a, 0.0)

    for k in ("diff_radiance", "spec_radiance", "direct_lighting", "emission"):
        if k in out:
            out[k] = clean_radiance(out[k])
    for k in ("diff_hitdist", "spec_hitdist", "shadow", "shadow_hit_dist"):
        if k in out:
            v = out[k]
            out[k] = jnp.where(jnp.isfinite(v) & inside, v, 0.0)
    vz = out["view_z"]
    out["view_z"] = jnp.where(jnp.isfinite(vz) & inside, vz, config.INF)
    return out
