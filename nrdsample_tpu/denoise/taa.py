"""TAA — custom temporal anti-aliasing.

Reference: Shaders/Taa.cs.hlsl (159 LoC): 3x3/5x5 variance clamp
(sigma * TAA_SIGMA_SCALE), closest-velocity dilation over 3x3, bicubic history
sampling with TAA_HISTORY_SHARPNESS, CIELAB-JND-based disocclusion boost of the
mix rate. The SMEM preload (17-39) is unnecessary here — XLA manages locality.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from nrdsample_tpu import config as cfgmod
from nrdsample_tpu.denoise import common
from nrdsample_tpu.mathlib import color


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TaaHistory:
    color: jnp.ndarray   # (H, W, 3)
    valid: jnp.ndarray   # () int32: 0 on first frame

    @staticmethod
    def create(h: int, w: int, dtype=jnp.float32) -> "TaaHistory":
        return TaaHistory(color=jnp.zeros((h, w, 3), dtype), valid=jnp.int32(0))


def closest_velocity_dilation(mv_xy: jnp.ndarray, view_z: jnp.ndarray) -> jnp.ndarray:
    """Use the motion of the closest (min viewZ) pixel in the 3x3 neighborhood
    (Taa.cs.hlsl:97-101) — keeps edges stable under motion."""
    best_z = view_z
    best_mv = mv_xy
    for dy, dx in common.stencil_taps(1):
        zn = common.shifted(view_z, dy, dx)
        mn = common.shifted(mv_xy, dy, dx)
        closer = zn < best_z
        best_mv = jnp.where(closer[..., None], mn, best_mv)
        best_z = jnp.minimum(best_z, zn)
    return best_mv


def requests(hist: TaaHistory, mv: jnp.ndarray, view_z: jnp.ndarray):
    """Gather-pass plan: bicubic history sample at the dilated velocity
    (Taa.cs.hlsl:97-123). Returns (plane, pos); mode = bicubic."""
    h, w = view_z.shape
    mv_d = closest_velocity_dilation(mv[..., :2], view_z)
    return hist.color, common.pixel_positions(h, w) + mv_d


def resolve_tail(cur, prev, mv_d, wide_mask, reset_mix,
                 sigma_scale: float, base_mix: float):
    """Post-gather TAA stage: neighborhood moments, variance clamp,
    CIELAB-JND mix (Taa.cs.hlsl:56-147). wide_mask: (H, W)
    float (>0.5 = wide) or None; reset_mix: (H, W) float in {0, 1}."""
    h, w = cur.shape[:2]
    mu = jnp.zeros_like(cur)
    mu2 = jnp.zeros_like(cur)
    for dy, dx in common.stencil_taps(1):
        cn = common.shifted(cur, dy, dx)
        mu += cn
        mu2 += cn * cn
    mu /= 9.0
    sigma = jnp.sqrt(jnp.maximum(mu2 / 9.0 - mu * mu, 0.0) + 1e-12)
    if wide_mask is not None:
        mu5 = jnp.zeros_like(cur)
        mu52 = jnp.zeros_like(cur)
        for dy, dx in common.stencil_taps(2):
            cn = common.shifted(cur, dy, dx)
            mu5 += cn
            mu52 += cn * cn
        mu5 /= 25.0
        sigma5 = jnp.sqrt(jnp.maximum(mu52 / 25.0 - mu5 * mu5, 0.0) + 1e-12)
        wm = (wide_mask > 0.5)[..., None]
        mu = jnp.where(wm, mu5, mu)
        sigma = jnp.where(wm, sigma5, sigma)

    lo = mu - sigma * sigma_scale
    hi = mu + sigma * sigma_scale
    clamped = jnp.clip(prev, lo, hi)

    # disocclusion-driven mix-rate boost via CIELAB just-noticeable-difference
    lab_p = color.rgb_to_lab(jnp.clip(prev, 0.0, 1.0))
    lab_c = color.rgb_to_lab(jnp.clip(clamped, 0.0, 1.0))
    de = jnp.linalg.norm(lab_p - lab_c, axis=-1)
    jnd = jnp.clip(de / 23.0, 0.0, 1.0)
    mix = jnp.clip(base_mix + jnd * 0.5, 0.0, 1.0)

    offscreen = jnp.logical_not(common.in_screen(mv_d, h, w))
    mix = jnp.where(offscreen, 1.0, mix)
    mix = jnp.maximum(mix, reset_mix)
    return clamped + (cur - clamped) * mix[..., None]


def debug_weight(hist: TaaHistory, cur, mv, view_z, wide_mask=None,
                 base_mix: float = 0.1):
    """(H, W) effective TAA mix rate — the USE_TAA_DEBUG plane
    (Final.cs.hlsl:54-56). Recomputes the XLA resolve's mix factor from the
    same inputs (debug-only path; perf irrelevant)."""
    h, w = view_z.shape
    mv_d = closest_velocity_dilation(mv[..., :2], view_z)
    prev = common.reproject(hist.color, mv_d, bicubic=True)
    mu = jnp.zeros_like(cur)
    mu2 = jnp.zeros_like(cur)
    for dy, dx in common.stencil_taps(1):
        cn = common.shifted(cur, dy, dx)
        mu += cn
        mu2 += cn * cn
    mu /= 9.0
    sigma = jnp.sqrt(jnp.maximum(mu2 / 9.0 - mu * mu, 0.0) + 1e-12)
    clamped = jnp.clip(prev, mu - sigma * cfgmod.TAA_SIGMA_SCALE,
                       mu + sigma * cfgmod.TAA_SIGMA_SCALE)
    lab_p = color.rgb_to_lab(jnp.clip(prev, 0.0, 1.0))
    lab_c = color.rgb_to_lab(jnp.clip(clamped, 0.0, 1.0))
    de = jnp.linalg.norm(lab_p - lab_c, axis=-1)
    mix = jnp.clip(base_mix + jnp.clip(de / 23.0, 0.0, 1.0) * 0.5, 0.0, 1.0)
    mix = jnp.where(jnp.logical_not(common.in_screen(mv_d, h, w)), 1.0, mix)
    if wide_mask is not None:
        mix = jnp.maximum(mix, wide_mask.astype(mix.dtype) * base_mix)
    return jnp.where(hist.valid == 0, 1.0, mix)


@jax.named_scope("taa")
def apply(hist: TaaHistory, cur: jnp.ndarray, mv: jnp.ndarray, view_z: jnp.ndarray,
          wide_mask: jnp.ndarray | None = None, reset=False,
          base_mix: float = 0.1, pre=None):
    """One TAA step. cur: (H, W, 3) current-frame color (post-composition HDR or
    tonemapped — the reference runs TAA on tonemap-ish output). Returns
    (antialiased, new history). pre: optional pre-gathered history sample
    (requests() via the staged gather pass)."""
    h, w = view_z.shape
    mv_d = closest_velocity_dilation(mv[..., :2], view_z)

    # bicubic history (Taa.cs.hlsl:122-123)
    prev = pre if pre is not None else common.reproject(hist.color, mv_d, bicubic=True)
    reset_mix = jnp.broadcast_to(
        jnp.where(jnp.logical_or(reset, hist.valid == 0), 1.0, 0.0), (h, w)
    ).astype(cur.dtype)
    wide_f = None if wide_mask is None else wide_mask.astype(cur.dtype)
    out = resolve_tail(cur, prev, mv_d, wide_f, reset_mix,
                       cfgmod.TAA_SIGMA_SCALE, base_mix)
    return out, TaaHistory(color=out, valid=jnp.int32(1))
