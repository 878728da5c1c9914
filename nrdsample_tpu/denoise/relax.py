"""RELAX — SVGF-family diffuse/specular denoiser (A-trous with temporal
accumulation and variance-guided edge stopping).

Reference: NRD's RELAX denoiser (external submodule, characterized by its API
surface: NRDSample.cpp:543-561 defaults, Composition.cs.hlsl:85-167 back-end).
Reimplemented from the published SVGF/RELAX algorithm family (SURVEY.md §7.3.3
says: validate behaviorally, not bit-exactly):

  1. temporal accumulation of illumination + 1st/2nd luminance moments with
     motion reprojection + depth/normal disocclusion,
  2. variance estimation (spatial 3x3 fallback for short histories),
  3. N à-trous wavelet iterations (5x5, powers-of-two steps) with
     depth/normal/luminance edge-stopping; variance filtered alongside.

All stencils are static-shift stacks (clamped edges) — elementwise work that
XLA fuses, sharding-friendly (halo exchange is inserted by GSPMD when H is sharded).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from nrdsample_tpu.denoise import common


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RelaxHistory:
    illum: jnp.ndarray        # (H, W, 3) accumulated illumination
    moments: jnp.ndarray      # (H, W, 2) accumulated (mu1, mu2) of luminance
    view_z: jnp.ndarray       # (H, W)
    normal: jnp.ndarray       # (H, W, 3)
    frames: jnp.ndarray       # (H, W) accumulated frame count

    @staticmethod
    def create(h: int, w: int, dtype=jnp.float32) -> "RelaxHistory":
        return RelaxHistory(
            illum=jnp.zeros((h, w, 3), dtype),
            moments=jnp.zeros((h, w, 2), dtype),
            view_z=jnp.full((h, w), 1e5, dtype),
            normal=jnp.zeros((h, w, 3), dtype),
            frames=jnp.zeros((h, w), dtype),
        )


@dataclasses.dataclass(frozen=True)
class RelaxSettings:
    """Mirrors the exercised subset of nrd::RelaxSettings
    (GetDefaultRelaxSettings, NRDSample.cpp:543-561)."""

    max_accumulated_frames: int = 30
    atrous_iterations: int = 5
    enable_anti_firefly: bool = True
    phi_luminance: float = 4.0
    phi_normal: float = 64.0
    phi_depth: float = 1.0
    disocclusion_threshold: float = 0.02


def taccum_requests(hist: RelaxHistory, mv_xy):
    """Gather-pass plan for temporal accumulation: ONE packed 10-channel
    bilinear request [illum(3), moments(2), view_z(1), normal(3), frames(1)]
    at cur + mv (see denoise/gatherpass.py)."""
    packed = jnp.concatenate(
        [hist.illum, hist.moments, hist.view_z[..., None], hist.normal,
         hist.frames[..., None]], axis=-1)
    h, w = hist.view_z.shape
    return packed, common.pixel_positions(h, w) + mv_xy


def temporal_accumulate(hist: RelaxHistory, illum, view_z, normal, mv,
                        s: RelaxSettings, reset=False, confidence=None,
                        pre=None):
    """Step 1: reproject + accumulate illumination and moments.

    pre: optional pre-gathered (H, W, 10) result of taccum_requests from the
    staged gather pass; when None the gather runs in-program (robust taps).
    """
    h, w = view_z.shape
    mv_xy = mv[..., :2]
    if pre is None:
        from nrdsample_tpu.mathlib import filtering

        plane, pos = taccum_requests(hist, mv_xy)
        pre = filtering.sample_bilinear(plane, pos)
    prev_illum, prev_moments = pre[..., 0:3], pre[..., 3:5]
    prev_z, prev_n, prev_frames = pre[..., 5], pre[..., 6:9], pre[..., 9]

    valid = common.disocclusion_weight(
        view_z, mv[..., 2], prev_z, normal, prev_n, s.disocclusion_threshold
    )
    valid = valid * common.in_screen(mv_xy, h, w).astype(view_z.dtype)
    valid = jnp.where(reset, 0.0, valid)
    if confidence is not None:
        # history-confidence clamp (gPrevFrameConfidence / the ConfidenceBlur
        # output): lighting changes cut the accumulated history
        valid = valid * confidence

    frames = jnp.minimum(prev_frames * valid + 1.0, s.max_accumulated_frames)
    alpha = 1.0 / frames

    lum = common.luminance(illum)
    new_moments = jnp.stack([lum, lum * lum], axis=-1)
    acc_illum = prev_illum * (1.0 - alpha[..., None]) + illum * alpha[..., None]
    acc_illum = jnp.where(valid[..., None] > 0, acc_illum, illum)
    acc_moments = prev_moments * (1.0 - alpha[..., None]) + new_moments * alpha[..., None]
    acc_moments = jnp.where(valid[..., None] > 0, acc_moments, new_moments)

    new_hist = RelaxHistory(
        illum=acc_illum, moments=acc_moments, view_z=view_z, normal=normal,
        frames=frames,
    )
    return acc_illum, acc_moments, frames, new_hist


def estimate_variance(illum, moments, frames):
    """Temporal variance, with a 3x3 spatial fallback for short histories."""
    var_t = jnp.maximum(moments[..., 1] - moments[..., 0] ** 2, 0.0)
    # spatial estimate
    lum = common.luminance(illum)
    s1 = jnp.zeros_like(lum)
    s2 = jnp.zeros_like(lum)
    for dy, dx in common.stencil_taps(1):
        ln = common.shifted(lum, dy, dx)
        s1 += ln
        s2 += ln * ln
    mu1 = s1 / 9.0
    var_s = jnp.maximum(s2 / 9.0 - mu1 * mu1, 0.0)
    short = frames < 4.0
    return jnp.where(short, jnp.maximum(var_s, var_t), var_t)


_KERNEL_3 = [1.0 / 4.0, 1.0 / 2.0, 1.0 / 4.0]  # B3-spline atrous 1D weights


def atrous_iteration(illum, variance, view_z, normal, step, s: RelaxSettings,
                     max_step: int | None = None):
    """One edge-aware à-trous wavelet iteration (5x5 via separable-ish 3x3 at
    stride `step`; SVGF uses 5x5 B3, we use the 3x3x(2 iters) equivalent shape
    with powers-of-two strides).

    `step` may be a TRACED value when `max_step` (static bound) is given — the
    lax.scan'd chain in `denoise` uses that form (shifted_dyn is bit-identical
    to the static shifted)."""
    lum_c = common.luminance(illum)
    # +eps inside sqrt: d/dx sqrt(0) = inf poisons autodiff (NaN via 0*inf)
    sigma_l = jnp.sqrt(
        jnp.maximum(variance, 0.0) + 1e-12
    ) * s.phi_luminance + 1e-4

    def shift(a, dy, dx):
        if max_step is None:
            return common.shifted(a, dy, dx)
        return common.shifted_dyn(a, dy, dx, max_step)

    # pack the per-tap planes into ONE channel stack so the dynamic-slice form
    # pays one padded copy per tap, not four
    packed = jnp.concatenate(
        [illum, variance[..., None], view_z[..., None], normal], axis=-1
    )
    acc = jnp.zeros_like(illum)
    acc_var = jnp.zeros_like(variance)
    acc_w = jnp.zeros_like(variance)
    for iy, ky in enumerate(_KERNEL_3):
        for ix, kx in enumerate(_KERNEL_3):
            dy = (iy - 1) * step
            dx = (ix - 1) * step
            k = ky * kx
            tap = shift(packed, dy, dx)
            illum_n, var_n = tap[..., 0:3], tap[..., 3]
            z_n, n_n = tap[..., 4], tap[..., 5:8]
            lum_n = common.luminance(illum_n)
            wz = jnp.exp(
                -jnp.abs(z_n - view_z)
                / (s.phi_depth * jnp.maximum(jnp.abs(view_z), 1e-3) * (abs(dy) + abs(dx) + 1e-3))
            )
            wn = jnp.power(jnp.clip(jnp.sum(n_n * normal, axis=-1), 0.0, 1.0), s.phi_normal)
            wl = jnp.exp(-jnp.abs(lum_n - lum_c) / sigma_l)
            wgt = k * wz * wn * wl
            acc = acc + illum_n * wgt[..., None]
            acc_var = acc_var + var_n * wgt * wgt
            acc_w = acc_w + wgt
    inv = 1.0 / jnp.maximum(acc_w, 1e-6)
    return acc * inv[..., None], acc_var * inv * inv


@jax.named_scope("relax")
def denoise(hist: RelaxHistory, illum, view_z, normal, mv,
            s: RelaxSettings = RelaxSettings(), reset=False, confidence=None,
            pre=None):
    """Full RELAX pipeline for one signal (diffuse or specular).

    illum: (H, W, 3) demodulated radiance; returns (denoised, new history).
    confidence: optional (H, W) [0,1] history-confidence plane.
    pre: optional pre-gathered taccum_requests result (staged gather pass).
    """
    if s.enable_anti_firefly:
        illum = common.anti_firefly(illum)
    acc_illum, acc_moments, frames, new_hist = temporal_accumulate(
        hist, illum, view_z, normal, mv, s, reset, confidence, pre=pre
    )
    variance = estimate_variance(acc_illum, acc_moments, frames)
    # à-trous chain as lax.scan over the dilation steps: one compiled body
    # instead of atrous_iterations unrolled copies (the unrolled form made the
    # full-frame grad graph big enough to stall XLA:CPU/GSPMD compiles)
    n_it = s.atrous_iterations
    max_step = 1 << (n_it - 1)
    steps = jnp.array([1 << i for i in range(n_it)], jnp.int32)

    def body(carry, step_i):
        out, var, first = carry
        i, step = step_i
        out2, var2 = atrous_iteration(out, var, view_z, normal, step, s,
                                      max_step=max_step)
        # feed the first-iteration result back as the next frame's history
        # (standard SVGF trick: reduces temporal lag artifacts)
        first = jnp.where(i == 0, out2, first)
        return (out2, var2, first), None

    (out, _, first_out), _ = jax.lax.scan(
        body, (acc_illum, variance, acc_illum),
        (jnp.arange(n_it, dtype=jnp.int32), steps),
    )
    new_hist = dataclasses.replace(new_hist, illum=first_out)
    return out, new_hist
