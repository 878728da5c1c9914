"""SIGMA — sun-shadow denoiser (penumbra-aware blur + temporal stabilization).

Reference: NRD's SIGMA (external submodule; sample integration: penumbra pack in
TraceOpaque.cs.hlsl:767-804 where the shadow ray's hit distance encodes penumbra
size, SIGMA_TRANSLUCENCY glass tint, back-end unpack Composition.cs.hlsl:58-64).

Reimplementation: the penumbra half-width at a receiver is
  w ≈ hitT * tanSunAngularRadius / pixelSize(viewZ)
(blocker distance x sun angular size). The denoiser blurs the binary visibility
with a spatial kernel of that radius (depth/normal edge-stopped), then applies a
short temporal accumulation. Output: scalar shadow in [0,1] (+ translucency
channel when glass is involved).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from nrdsample_tpu.denoise import common


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SigmaHistory:
    shadow: jnp.ndarray   # (H, W)
    frames: jnp.ndarray   # (H, W)
    view_z: jnp.ndarray   # (H, W) — for the temporal disocclusion test

    @staticmethod
    def create(h: int, w: int, dtype=jnp.float32) -> "SigmaHistory":
        return SigmaHistory(
            shadow=jnp.ones((h, w), dtype),
            frames=jnp.zeros((h, w), dtype),
            view_z=jnp.full((h, w), 1e6, dtype),
        )


@dataclasses.dataclass(frozen=True)
class SigmaSettings:
    max_accumulated_frames: int = 5   # SIGMA keeps history short (shadows move)
    max_radius_px: float = 14.0   # penumbra blur radius cap (pixels)
    phi_depth: float = 1.0
    disocclusion_threshold: float = 0.02


_GAUSS_3 = [0.25, 0.5, 0.25]
_BLUR_STEPS = (1, 2, 4, 8)


def _blur_radius(shadow_hit_dist, view_z, tan_sun_angular_radius,
                 unproject: float, s: SigmaSettings):
    """(H, W) penumbra radius in pixels, spread so lit pixels bordering a
    shadow blur too (3x3 max-filter, twice)."""
    pixel_size = jnp.maximum(jnp.abs(view_z) * unproject, 1e-6)
    radius = shadow_hit_dist * tan_sun_angular_radius / pixel_size
    for _ in range(2):
        r = radius
        for dy, dx in common.stencil_taps(1):
            r = jnp.maximum(r, common.shifted(radius, dy, dx))
        radius = r
    return jnp.clip(radius, 0.0, s.max_radius_px)


def _penumbra_blur(shadow, radius, view_z, s: SigmaSettings):
    """Reach-budgeted dilated 3x3 chain — the penumbra-width blur as STATIC
    shifts only (a fused stencil pipeline, no gathers). The per-pixel radius
    is a kernel-reach BUDGET consumed across passes: each pass's neighbor gate is clip(remaining/step, 0, 1) and the
    remaining budget shrinks by gate*step, so the cumulative kernel half-width
    never exceeds the local penumbra half-width. (The previous independent
    per-step gates let four dilated passes compose unconditionally wherever
    the max-filtered radius was large, eroding the umbra entirely for far
    occluders — round-4 regression, tests/test_wiring_r2.py.)"""
    out = shadow
    z_plane = view_z[..., None]
    # half-pixel deadzone: sub-pixel penumbrae (contact shadows) stay sharp
    remaining = jnp.maximum(radius - 0.5, 0.0)
    for step in _BLUR_STEPS:
        gate = jnp.clip(remaining / step, 0.0, 1.0)
        remaining = jnp.maximum(remaining - gate * step, 0.0)
        packed = jnp.concatenate([out[..., None], z_plane], axis=-1)
        acc = jnp.zeros_like(out)
        acc_w = jnp.zeros_like(out)
        for iy, ky in enumerate(_GAUSS_3):
            for ix, kx in enumerate(_GAUSS_3):
                dy, dx = (iy - 1) * step, (ix - 1) * step
                tap = common.shifted(packed, dy, dx)
                s_n, z_n = tap[..., 0], tap[..., 1]
                wz = jnp.exp(-jnp.abs(z_n - view_z)
                             / (s.phi_depth
                                * jnp.maximum(jnp.abs(view_z), 1e-3)))
                wgt = ky * kx * wz * (gate if (dy or dx) else 1.0)
                acc = acc + s_n * wgt
                acc_w = acc_w + wgt
        out = acc / jnp.maximum(acc_w, 1e-6)
    return out


def requests(hist: SigmaHistory, shadow, shadow_hit_dist, view_z, mv,
             tan_sun_angular_radius, unproject: float, frame_idx,
             s: SigmaSettings = SigmaSettings()):
    """Gather-pass plan: 'temporal' = [hist.shadow, hist.frames, hist.view_z]
    at cur + mv (the penumbra blur itself is a static-shift stencil chain — no
    gathers)."""
    h, w = view_z.shape
    t_pos = common.pixel_positions(h, w) + mv[..., :2]
    t_plane = jnp.stack([hist.shadow, hist.frames, hist.view_z], axis=-1)
    return {"temporal": (t_plane, t_pos)}


@jax.named_scope("sigma")
def denoise(hist: SigmaHistory, shadow, shadow_hit_dist, view_z, mv,
            tan_sun_angular_radius, unproject: float, frame_idx,
            s: SigmaSettings = SigmaSettings(), reset=False, pre=None):
    """shadow: (H, W) visibility; shadow_hit_dist: (H, W) occluder distance
    (0 where unshadowed). Returns (denoised shadow, new history).

    pre: optional pre-gathered {'temporal': (H,W,2)} from the staged gather
    pass; when None the temporal gather runs in-program."""
    h, w = view_z.shape
    if pre is None:
        from nrdsample_tpu.mathlib import filtering

        t_plane, t_pos = requests(
            hist, shadow, shadow_hit_dist, view_z, mv,
            tan_sun_angular_radius, unproject, frame_idx, s)["temporal"]
        pre = {"temporal": filtering.sample_bilinear(t_plane, t_pos)}

    radius = _blur_radius(
        shadow_hit_dist, view_z, tan_sun_angular_radius, unproject, s
    )
    blurred = _penumbra_blur(shadow, radius, view_z, s)

    # temporal accumulation (short), rejected on disocclusion (NRD's SIGMA
    # plane-distance test — reprojected shadow history must not survive
    # depth discontinuities or it ghosts under camera motion)
    mv_xy = mv[..., :2]
    prev, prev_frames = pre["temporal"][..., 0], pre["temporal"][..., 1]
    prev_z = pre["temporal"][..., 2]
    mv_z = mv[..., 2] if mv.shape[-1] > 2 else jnp.zeros_like(view_z)
    valid = common.in_screen(mv_xy, h, w).astype(view_z.dtype)
    valid = valid * common.disocclusion_weight(
        view_z, mv_z, prev_z, threshold=s.disocclusion_threshold
    )
    valid = jnp.where(reset, 0.0, valid)
    frames = jnp.minimum(prev_frames * valid + 1.0, s.max_accumulated_frames)
    alpha = 1.0 / frames
    out = prev * (1 - alpha) + blurred * alpha
    out = jnp.where(valid > 0, out, blurred)
    out = jnp.clip(out, 0.0, 1.0)

    return out, SigmaHistory(shadow=out, frames=frames, view_z=view_z)
