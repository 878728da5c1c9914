"""Shared denoiser infrastructure: reprojection, disocclusion tests, stencil
taps. Equivalent of NRD's internal common passes (temporal reprojection with
plane-distance-based disocclusion is the core of REBLUR/RELAX temporal
accumulation; SURVEY.md §7.3.3).

Images are [H, W, C] (or [H, W]); motion is the reference's 2.5D motion
(GetMotion, Shared.hlsli:318-335): mv.xy in pixels such that
prev_pos = cur_pos + mv.xy, mv.z = viewZprev - viewZ.
"""

from __future__ import annotations

import jax.numpy as jnp

from nrdsample_tpu.mathlib import filtering


def shifted(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Clamped-edge shifted view of [H, W, ...]: out[y, x] = img[y+dy, x+dx].

    Implemented as edge-pad + STATIC slice (not gather), which XLA folds into
    the consuming elementwise op.
    """
    h, w = img.shape[0], img.shape[1]
    pt, pb = max(-dy, 0), max(dy, 0)
    pl_, pr = max(-dx, 0), max(dx, 0)
    if pt == pb == pl_ == pr == 0:
        return img
    pad = ((pt, pb), (pl_, pr)) + ((0, 0),) * (img.ndim - 2)
    padded = jnp.pad(img, pad, mode="edge")
    y0 = max(dy, 0)
    x0 = max(dx, 0)
    return padded[y0:y0 + h, x0:x0 + w]


def shifted_dyn(img: jnp.ndarray, dy, dx, max_shift: int) -> jnp.ndarray:
    """`shifted` with TRACED (dy, dx), |dy|,|dx| <= max_shift (static).

    Exactly clamp-to-edge (bit-identical to `shifted`): edge-pad by max_shift
    once, then dynamic_slice at (max_shift+dy, max_shift+dx) — edge-mode
    padding replicates the border value, which IS index clamping for shifts
    within the pad. Used by the lax.scan'd à-trous chains, where the dilation
    step varies per scan iteration (compile-cost fix: the unrolled chains made
    the frame graph big enough to stall XLA:CPU / GSPMD compiles)."""
    h, w = img.shape[0], img.shape[1]
    pad = ((max_shift, max_shift), (max_shift, max_shift)) + ((0, 0),) * (img.ndim - 2)
    padded = jnp.pad(img, pad, mode="edge")
    import jax

    start = (max_shift + jnp.asarray(dy, jnp.int32),
             max_shift + jnp.asarray(dx, jnp.int32))
    start = start + (jnp.int32(0),) * (img.ndim - 2)
    return jax.lax.dynamic_slice(padded, start, (h, w) + img.shape[2:])


def stencil_taps(radius: int):
    """(dy, dx) offsets of a (2r+1)² stencil."""
    return [
        (dy, dx)
        for dy in range(-radius, radius + 1)
        for dx in range(-radius, radius + 1)
    ]


def pixel_positions(h: int, w: int) -> jnp.ndarray:
    """Continuous pixel centers [H, W, 2] = (x, y)."""
    x = jnp.arange(w, dtype=jnp.float32) + 0.5
    y = jnp.arange(h, dtype=jnp.float32) + 0.5
    gx, gy = jnp.meshgrid(x, y)
    return jnp.stack([gx, gy], axis=-1)


def reproject(prev: jnp.ndarray, mv_xy: jnp.ndarray, bicubic: bool = False) -> jnp.ndarray:
    """Sample the previous-frame image at cur + mv (bilinear or 5-tap bicubic).

    prev: [H, W, C]; mv_xy: [H, W, 2] in pixels. Clamp-to-edge tap gathers.
    """
    pos = pixel_positions(prev.shape[0], prev.shape[1]) + mv_xy
    if bicubic:
        return filtering.sample_bicubic_no_corners(prev, pos)
    return filtering.sample_bilinear(prev, pos)


def anti_firefly(img: jnp.ndarray) -> jnp.ndarray:
    """RCRS-style outlier clamp (NRD's enableAntiFirefly): clamp each pixel's
    luminance to the [min, max] of its 8 neighbors, preserving chroma. A
    single 10^4x firefly is pulled to the neighborhood ceiling instead of
    bleeding a bright blob through the spatial filters."""
    lum = luminance(img)
    nmin = None
    nmax = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            ln = shifted(lum, dy, dx)
            nmin = ln if nmin is None else jnp.minimum(nmin, ln)
            nmax = ln if nmax is None else jnp.maximum(nmax, ln)
    clamped = jnp.clip(lum, nmin, nmax)
    scale = clamped / jnp.maximum(lum, 1e-9)
    return img * scale[..., None]


def reproject_many(planes: list, mv_xy: jnp.ndarray) -> list:
    """Reproject several history planes with ONE packed bilinear sample.

    Each separate reproject costs 4 XLA gathers; packing the planes into one
    (H, W, sum C) array first makes it 4 gathers TOTAL.
    planes: list of (H, W) or (H, W, C); returns same-shape reprojections.

    NOTE: the production denoisers plan packed gathers explicitly
    (taccum_requests / requests, see denoise/gatherpass.py); this helper
    remains for ad-hoc reprojection.
    """
    chans = []
    shapes = []
    for p in planes:
        if p.ndim == 2:
            chans.append(p[..., None])
            shapes.append(None)
        else:
            chans.append(p)
            shapes.append(p.shape[-1])
    packed = jnp.concatenate(chans, axis=-1)
    out = reproject(packed, mv_xy)
    res = []
    o = 0
    for s in shapes:
        c = 1 if s is None else s
        sl = out[..., o:o + c]
        res.append(sl[..., 0] if s is None else sl)
        o += c
    return res


def in_screen(mv_xy: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    """[H, W] bool: does the reprojected position land on screen?"""
    pos = pixel_positions(h, w) + mv_xy
    return (
        (pos[..., 0] >= 0.0)
        & (pos[..., 0] <= w)
        & (pos[..., 1] >= 0.0)
        & (pos[..., 1] <= h)
    )


def disocclusion_weight(view_z: jnp.ndarray, mv_z: jnp.ndarray,
                        prev_view_z_reproj: jnp.ndarray,
                        normal: jnp.ndarray | None = None,
                        prev_normal_reproj: jnp.ndarray | None = None,
                        threshold: float = 0.02) -> jnp.ndarray:
    """[H, W] in [0,1]: 1 = history valid. Plane-distance style test: expected
    prev viewZ = viewZ + mv.z, compared against the reprojected history viewZ
    relative to the absolute depth (NRD's disocclusionThreshold ~ 1-2%)."""
    expected = view_z + mv_z
    rel = jnp.abs(prev_view_z_reproj - expected) / jnp.maximum(
        jnp.abs(view_z), 1e-3
    )
    ok = (rel < threshold).astype(view_z.dtype)
    if normal is not None and prev_normal_reproj is not None:
        ndot = jnp.sum(normal * prev_normal_reproj, axis=-1)
        ok = ok * (ndot > 0.5).astype(view_z.dtype)
    return ok


def edge_stopping_weights(view_z, normal, radius: int, phi_z: float = 1.0,
                          phi_n: float = 128.0, mv_xy=None):
    """Per-tap geometric edge-stopping weights for an à-trous/stencil pass.

    Returns list of ([H,W] weight, (dy,dx)) for all taps at the given radius
    (step 1). Depth weight uses relative depth difference; normal weight is the
    SVGF pow(max(dot,0), phi_n).
    """
    taps = stencil_taps(radius)
    out = []
    for dy, dx in taps:
        zn = shifted(view_z, dy, dx)
        nn = shifted(normal, dy, dx)
        wz = jnp.exp(-jnp.abs(zn - view_z) / (phi_z * jnp.maximum(jnp.abs(view_z), 1e-3)
                                              * (abs(dy) + abs(dx) + 1e-3)))
        wn = jnp.power(jnp.clip(jnp.sum(nn * normal, axis=-1), 0.0, 1.0), phi_n)
        out.append((wz * wn, (dy, dx)))
    return out


def luminance(img: jnp.ndarray) -> jnp.ndarray:
    from nrdsample_tpu.mathlib import color

    return color.luminance(img)
