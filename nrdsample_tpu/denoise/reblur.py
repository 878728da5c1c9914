"""REBLUR — recurrent-blur diffuse/specular denoiser.

Reference: NRD's REBLUR (external submodule; defaults exercised at
NRDSample.cpp:563-585, front-end packing TraceOpaque.cs.hlsl:730-759, hit-dist
normalization via gHitDistSettings). Reimplemented from the published
"ReBLUR: A Hierarchical Recurrent Denoiser" algorithm outline (Ray Tracing
Gems II ch. 49) — behaviorally validated (SURVEY.md §7.3.3):

  1. temporal accumulation with disocclusion-aware accumulation speed,
  2. hit-distance-driven adaptive-radius bilateral blur, realized as a
     reach-budgeted dilated stencil chain (radius shrinks with accumulated
     frames and with normalized hit distance; specular radius also shrinks
     with roughness via the "spec magic curve"),
  3. temporal stabilization: history clamped to the spatial neighborhood
     mean ± sigma (anti-lag).

"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from nrdsample_tpu.denoise import common
from nrdsample_tpu.mathlib import color


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ReblurHistory:
    illum: jnp.ndarray        # (H, W, 3)
    fast_illum: jnp.ndarray   # (H, W, 3) short-history (fast) channel
    hitdist: jnp.ndarray      # (H, W)
    view_z: jnp.ndarray       # (H, W)
    normal: jnp.ndarray       # (H, W, 3)
    frames: jnp.ndarray       # (H, W)

    @staticmethod
    def create(h: int, w: int, dtype=jnp.float32) -> "ReblurHistory":
        z = jnp.zeros((h, w, 3), dtype)
        return ReblurHistory(
            illum=z, fast_illum=z, hitdist=jnp.zeros((h, w), dtype),
            view_z=jnp.full((h, w), 1e5, dtype),
            normal=jnp.zeros((h, w, 3), dtype),
            frames=jnp.zeros((h, w), dtype),
        )


@dataclasses.dataclass(frozen=True)
class ReblurSettings:
    """Mirrors the exercised subset of nrd::ReblurSettings
    (GetDefaultReblurSettings, NRDSample.cpp:563-585)."""

    max_accumulated_frames: int = 30
    max_fast_accumulated_frames: int = 6
    blur_radius_px: float = 15.0
    min_blur_radius_px: float = 1.0
    disocclusion_threshold: float = 0.02
    anti_lag_sigma: float = 2.0
    enable_anti_firefly: bool = True
    phi_normal: float = 64.0
    phi_depth: float = 1.0
    # NRD historyFixFrameNum: pixels with fewer accumulated frames than this
    # (fresh disocclusions) get their signal reconstructed spatially
    history_fix_frame_num: float = 3.0
    history_fix_stride: int = 2


def spec_magic_curve(roughness):
    """GetSpecMagicCurve (Shared.hlsli:305-311)."""
    from nrdsample_tpu.mathlib import geometry as geo

    f = 1.0 - jnp.exp2(-200.0 * roughness * roughness)
    return f * geo.pow01(roughness, 0.5)


def specular_dominant_factor(roughness):
    """Fraction of the specular lobe that behaves like a mirror reflection
    (ImportanceSampling::GetSpecularDominantFactor shape): 1 at r=0, -> 0 as
    r -> 1. Drives how far the virtual image sits behind the reflector."""
    r = jnp.clip(roughness, 0.0, 1.0)
    return (1.0 - r) * (jnp.sqrt(1.0 - r) + r)


def specular_virtual_mv(cam, x, view_dir, spec_hitdist, roughness, mv,
                        width: int, height: int, miss=None):
    """Virtual-motion reprojection for the specular channel (the REBLUR
    virtual-history idea, GetDefaultReblurSettings NRDSample.cpp:563-585):
    a reflection does not move with the reflector surface — it moves with the
    VIRTUAL image at X + V * hitT * D behind the surface. Reprojecting the
    specular history at the virtual point keeps mirror reflections sharp under
    camera motion instead of smearing them with the surface motion vector.

    x: (H, W, 3) primary hit position; view_dir: (H, W, 3) unit eye->surface;
    mv: (H, W, 3) surface 2.5D motion. Returns (H, W, 3) motion for the
    specular history lookup (xy blended toward virtual, z kept surface-based
    for the disocclusion test).
    """
    from nrdsample_tpu.scene import camera as cam_mod

    amount = specular_dominant_factor(roughness)
    xv = x + view_dir * (spec_hitdist * amount)[..., None]
    # Xv lies on the primary ray, so its current projection IS this pixel;
    # only the previous-frame projection differs from the surface one.
    uv_cur = cam_mod.world_to_uv(cam, x, prev=False)
    uv_prev = cam_mod.world_to_uv(cam, xv, prev=True)
    wh = jnp.array([width, height], jnp.float32)
    mv_virt_xy = (uv_prev - uv_cur) * wh
    mv_xy = mv[..., :2] + (mv_virt_xy - mv[..., :2]) * amount[..., None]
    if miss is not None:
        mv_xy = jnp.where(miss[..., None], mv[..., :2], mv_xy)
    return jnp.concatenate([mv_xy, mv[..., 2:3]], axis=-1)


def blur_radius(hitdist, view_z, roughness, frames, s: ReblurSettings,
                is_spec: bool, unproject: float):
    """Per-pixel adaptive blur radius in pixels: shrinks with convergence,
    scales with world-space hit distance (contact -> small), and with the
    specular magic curve for the spec channel (REBLUR's adaptive radius)."""
    conv = frames / s.max_accumulated_frames
    radius = s.blur_radius_px * (1.0 - 0.9 * conv)
    pixel_size = jnp.maximum(jnp.abs(view_z) * unproject, 1e-6)
    hit_factor = jnp.clip(hitdist / (pixel_size * 30.0), 0.05, 1.0)
    radius = radius * hit_factor
    if is_spec:
        radius = radius * jnp.clip(spec_magic_curve(roughness), 0.05, 1.0)
    return jnp.maximum(radius, s.min_blur_radius_px)


_GAUSS_3 = (0.25, 0.5, 0.25)
_BLUR_STEPS = (1, 2, 4, 8)


def adaptive_blur(illum, hitdist, view_z, normal, roughness, frames, frame_idx,
                  s: ReblurSettings, is_spec: bool, unproject: float):
    """Adaptive-radius bilateral blur as a reach-budgeted dilated 3x3 chain —
    STATIC shifts only (the same form as SIGMA's penumbra blur). The per-pixel radius is a cumulative kernel-reach
    budget: pass `step` engages with gate clip(remaining/step, 0, 1) and
    consumes gate*step, so total kernel half-width tracks the adaptive radius
    exactly like the Poisson form's disk radius did, while staying a fused
    stencil pipeline instead of 8 dynamic robust gathers (which dominated the
    512^2 REBLUR frame at 99 ms/signal)."""
    radius = blur_radius(hitdist, view_z, roughness, frames, s, is_spec,
                         unproject)
    geom = jnp.concatenate([view_z[..., None], normal], axis=-1)  # static
    out = illum
    out_hd = hitdist
    remaining = jnp.maximum(radius - 0.5, 0.0)  # sub-pixel radii stay sharp
    for step in _BLUR_STEPS:
        gate = jnp.clip(remaining / step, 0.0, 1.0)
        remaining = jnp.maximum(remaining - gate * step, 0.0)
        packed = jnp.concatenate([out, out_hd[..., None], geom], axis=-1)
        acc = jnp.zeros_like(out)
        acc_hd = jnp.zeros_like(out_hd)
        acc_w = jnp.zeros_like(out_hd)
        for iy, ky in enumerate(_GAUSS_3):
            for ix, kx in enumerate(_GAUSS_3):
                dy, dx = (iy - 1) * step, (ix - 1) * step
                tap = common.shifted(packed, dy, dx)
                z_n, n_n = tap[..., 4], tap[..., 5:8]
                wz = jnp.exp(-jnp.abs(z_n - view_z)
                             / (s.phi_depth
                                * jnp.maximum(jnp.abs(view_z), 1e-3)))
                wn = jnp.power(
                    jnp.clip(jnp.sum(n_n * normal, axis=-1), 0.0, 1.0),
                    s.phi_normal,
                )
                wgt = ky * kx * wz * wn * (gate if (dy or dx) else 1.0)
                acc = acc + tap[..., 0:3] * wgt[..., None]
                acc_hd = acc_hd + tap[..., 3] * wgt
                acc_w = acc_w + wgt
        inv = 1.0 / jnp.maximum(acc_w, 1e-6)
        out = acc * inv[..., None]
        out_hd = acc_hd * inv
    return out, out_hd


def history_fix(acc, fast, view_z, normal, frames, s: ReblurSettings):
    """NRD REBLUR HistoryFix: right after a disocclusion the accumulated
    signal is 1-2 raw samples — pure noise. Reconstruct it from a WIDE
    (5x5, stride-s) depth/normal-bilateral blur, blending back to the
    accumulated value as the history refills (NRD's mip-chain fix-up,
    approximated with one strided stencil; exercised via the REBLUR row of
    SURVEY.md §2.3, NRDSample.cpp:563-585 defaults).

    Returns (fixed_slow, fixed_fast)."""
    fix_w = jnp.clip(1.0 - frames / s.history_fix_frame_num, 0.0, 1.0)
    st = s.history_fix_stride
    acc_s = jnp.zeros_like(acc)
    acc_f = jnp.zeros_like(fast)
    w_sum = jnp.zeros_like(view_z)
    for dy, dx in common.stencil_taps(2):
        z_n = common.shifted(view_z, dy * st, dx * st)
        n_n = common.shifted(normal, dy * st, dx * st)
        wz = jnp.exp(
            -jnp.abs(z_n - view_z)
            / (s.phi_depth * jnp.maximum(jnp.abs(view_z), 1e-3))
        )
        wn = jnp.power(
            jnp.clip(jnp.sum(n_n * normal, axis=-1), 0.0, 1.0), s.phi_normal
        )
        wgt = wz * wn
        acc_s = acc_s + common.shifted(acc, dy * st, dx * st) * wgt[..., None]
        acc_f = acc_f + common.shifted(fast, dy * st, dx * st) * wgt[..., None]
        w_sum = w_sum + wgt
    inv = 1.0 / jnp.maximum(w_sum, 1e-6)
    blur_s = acc_s * inv[..., None]
    blur_f = acc_f * inv[..., None]
    return (
        acc + (blur_s - acc) * fix_w[..., None],
        fast + (blur_f - fast) * fix_w[..., None],
    )


def taccum_requests(hist: ReblurHistory, mv_xy):
    """Gather-pass plan for temporal accumulation: 'illum' = bicubic history
    color; 'packed' = bilinear [fast(3), hitdist(1), view_z(1), normal(3),
    frames(1)] — both at cur + mv."""
    packed = jnp.concatenate(
        [hist.fast_illum, hist.hitdist[..., None], hist.view_z[..., None],
         hist.normal, hist.frames[..., None]], axis=-1)
    h, w = hist.view_z.shape
    pos = common.pixel_positions(h, w) + mv_xy
    return {"illum": (hist.illum, pos), "packed": (packed, pos)}


def accumulate(hist: ReblurHistory, illum, hitdist, view_z, normal, mv,
               s: ReblurSettings, reset=False, confidence=None, pre=None):
    """Temporal accumulation + history fix-up. Returns (acc, fast, hd, frames).

    pre: optional pre-gathered taccum_requests dict (staged gather pass)."""
    h, w = view_z.shape
    mv_xy = mv[..., :2]

    if pre is None:
        from nrdsample_tpu.denoise import gatherpass

        pre = gatherpass.execute_inline(
            taccum_requests(hist, mv_xy),
            {"illum": gatherpass.BICUBIC, "packed": gatherpass.BILINEAR},
        )
    prev_illum = pre["illum"]
    packed = pre["packed"]
    prev_fast, prev_hd = packed[..., 0:3], packed[..., 3]
    prev_z, prev_n, prev_frames = packed[..., 4], packed[..., 5:8], packed[..., 8]

    valid = common.disocclusion_weight(
        view_z, mv[..., 2], prev_z, normal, prev_n, s.disocclusion_threshold
    )
    valid = valid * common.in_screen(mv_xy, h, w).astype(view_z.dtype)
    valid = jnp.where(reset, 0.0, valid)
    if confidence is not None:
        # gPrevFrameConfidence / ConfidenceBlur output: cut history on change
        valid = valid * confidence

    frames = jnp.minimum(prev_frames * valid + 1.0, s.max_accumulated_frames)
    fast_frames = jnp.minimum(prev_frames * valid + 1.0, s.max_fast_accumulated_frames)
    alpha = 1.0 / frames
    alpha_f = 1.0 / fast_frames

    acc = prev_illum * (1 - alpha[..., None]) + illum * alpha[..., None]
    acc = jnp.where(valid[..., None] > 0, acc, illum)
    fast = prev_fast * (1 - alpha_f[..., None]) + illum * alpha_f[..., None]
    fast = jnp.where(valid[..., None] > 0, fast, illum)
    hd = prev_hd * (1 - alpha) + hitdist * alpha
    hd = jnp.where(valid > 0, hd, hitdist)

    # ---- history fix-up: spatial reconstruction of fresh disocclusions ----
    acc, fast = history_fix(acc, fast, view_z, normal, frames, s)
    return acc, fast, hd, frames


def stabilize(blurred, fast, frames, s: ReblurSettings):
    """Temporal stabilization + anti-lag (NRD REBLUR's TemporalStabilization):
    clamp the blurred slow signal to the fast channel's 3x3 neighborhood
    mean ± sigma, and where the slow signal sits OUTSIDE that box (a lighting
    change without disocclusion) cut the accumulated frame count so the slow
    history re-converges quickly — NRD shortens accumSpeed on anti-lag, it
    does NOT relax the clamp as history converges (the previous blend-out
    disabled anti-lag exactly when it matters; caught by
    tests/test_reblur_response.py step-response).

    Returns (stabilized signal, adjusted frames to store in history)."""
    mu = jnp.zeros_like(blurred)
    mu2 = jnp.zeros_like(blurred)
    for dy, dx in common.stencil_taps(1):
        f_n = common.shifted(fast, dy, dx)
        mu = mu + f_n
        mu2 = mu2 + f_n * f_n
    mu /= 9.0
    sigma = jnp.sqrt(jnp.maximum(mu2 / 9.0 - mu * mu, 0.0) + 1e-12)
    lo = mu - sigma * s.anti_lag_sigma
    hi = mu + sigma * s.anti_lag_sigma
    clamped = jnp.clip(blurred, lo, hi)
    # anti-lag: distance outside the box in sigma units (luminance-weighted)
    out_dist = color.luminance(jnp.abs(blurred - clamped))
    sig_lum = color.luminance(sigma) * s.anti_lag_sigma + 1e-6
    delta = out_dist / sig_lum
    frames_out = frames / (1.0 + delta)
    return clamped, frames_out


@jax.named_scope("reblur")
def denoise(hist: ReblurHistory, illum, hitdist, view_z, normal, roughness, mv,
            frame_idx, unproject: float, s: ReblurSettings = ReblurSettings(),
            is_spec: bool = False, reset=False, confidence=None, pre=None):
    """Full REBLUR pipeline for one signal. Returns (denoised, new_history).
    confidence: optional (H, W) [0,1] history-confidence plane.
    pre: optional pre-gathered taccum_requests dict (staged gather pass).
    The adaptive blur is a static stencil chain — no second gather stage."""
    if s.enable_anti_firefly:
        illum = common.anti_firefly(illum)

    acc, fast, hd, frames = accumulate(
        hist, illum, hitdist, view_z, normal, mv, s, reset, confidence, pre
    )

    # ---- adaptive spatial blur ----
    blurred, hd_blur = adaptive_blur(
        acc, hd, view_z, normal, roughness, frames, frame_idx, s, is_spec,
        unproject,
    )

    out, frames = stabilize(blurred, fast, frames, s)

    new_hist = ReblurHistory(
        illum=out, fast_illum=fast, hitdist=hd_blur, view_z=view_z, normal=normal,
        frames=frames,
    )
    return out, new_hist
