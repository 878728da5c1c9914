"""Behaviour of the plain XLA denoiser paths on every platform: history
reprojection (clamp-to-edge bilinear), RELAX temporal accumulation (reset,
confidence), the à-trous iteration at every dilation step on odd image sizes,
and the TAA resolve tail — each against an independent float64 numpy oracle
or a stated invariant."""

import numpy as np
import jax.numpy as jnp
import pytest

from nrdsample_tpu import config as cfgmod
from nrdsample_tpu.denoise import common, relax, sigma, taa
from nrdsample_tpu.mathlib import filtering


def np_bilinear(img, pos):
    """float64 clamp-to-edge bilinear: pos (..., 2) = (x, y) pixel units."""
    img = np.asarray(img, np.float64)
    h, w = img.shape[:2]
    p = np.asarray(pos, np.float64) - 0.5
    x0 = np.floor(p[..., 0]).astype(int)
    y0 = np.floor(p[..., 1]).astype(int)
    fx, fy = p[..., 0] - x0, p[..., 1] - y0
    if img.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]

    def at(y, x):
        return img[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)]

    return (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
            + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)


@pytest.mark.parametrize("max_disp", [0.5, 3.0, 8.0, 16.0])
@pytest.mark.parametrize("c", [1, 3])
def test_bilinear_clamp_to_edge(max_disp, c):
    """History reprojection up to 16 px of motion, including samples that
    leave the image (clamped to the edge texel)."""
    rs = np.random.RandomState(int(max_disp * 10) + c)
    h, w = 40, 56
    img = rs.rand(h, w, c).astype(np.float32)
    disp = rs.uniform(-max_disp, max_disp, (h, w, 2)).astype(np.float32)
    pos = np.asarray(common.pixel_positions(h, w)) + disp
    plane = img[..., 0] if c == 1 else img
    got = filtering.sample_bilinear(jnp.asarray(plane), jnp.asarray(pos))
    np.testing.assert_allclose(np.asarray(got), np_bilinear(plane, pos),
                               rtol=1e-5, atol=1e-5)


def test_bilinear_batched_taps():
    """A leading tap axis on the positions (SIGMA/REBLUR tap batches) gives
    the per-tap results."""
    rs = np.random.RandomState(1)
    img = rs.rand(16, 16, 2).astype(np.float32)
    pos = np.asarray(common.pixel_positions(16, 16))[None] + rs.uniform(
        -3, 3, (8, 16, 16, 2)).astype(np.float32)
    got = np.asarray(filtering.sample_bilinear(jnp.asarray(img), jnp.asarray(pos)))
    assert got.shape == (8, 16, 16, 2)
    np.testing.assert_allclose(got, np_bilinear(img, pos), rtol=1e-5, atol=1e-5)


def _planes(h=37, w=51, seed=0):
    rs = np.random.RandomState(seed)
    illum = rs.rand(h, w, 3).astype(np.float32) * 3.0
    var = rs.rand(h, w).astype(np.float32) * 0.2
    vz = (1.0 + rs.rand(h, w) * 5.0).astype(np.float32)
    n = rs.randn(h, w, 3).astype(np.float32) * 0.3 + np.array([0, 0, 1.0], np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return illum, var, vz, n


def np_atrous(illum, var, vz, n, step, s):
    """float64 oracle of relax.atrous_iteration: 3x3 B-spline taps at stride
    `step`, index-clamped edges, depth/normal/luminance edge stopping."""
    illum, var, vz, n = (np.asarray(a, np.float64) for a in (illum, var, vz, n))
    h, w = vz.shape
    luma = np.array([0.2126, 0.7152, 0.0722])
    lum_c = illum @ luma
    sigma_l = np.sqrt(np.maximum(var, 0.0) + 1e-12) * s.phi_luminance + 1e-4
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    k3 = [0.25, 0.5, 0.25]
    acc = np.zeros_like(illum)
    acc_var = np.zeros_like(var)
    acc_w = np.zeros_like(var)
    for iy in range(3):
        for ix in range(3):
            dy, dx = (iy - 1) * step, (ix - 1) * step
            ys, xs = np.clip(yy + dy, 0, h - 1), np.clip(xx + dx, 0, w - 1)
            il_n, v_n, z_n, n_n = illum[ys, xs], var[ys, xs], vz[ys, xs], n[ys, xs]
            wz = np.exp(-np.abs(z_n - vz) / (s.phi_depth * np.maximum(np.abs(vz), 1e-3)
                                              * (abs(dy) + abs(dx) + 1e-3)))
            wn = np.clip((n_n * n).sum(-1), 0.0, 1.0) ** s.phi_normal
            wl = np.exp(-np.abs(il_n @ luma - lum_c) / sigma_l)
            wgt = k3[iy] * k3[ix] * wz * wn * wl
            acc += il_n * wgt[..., None]
            acc_var += v_n * wgt * wgt
            acc_w += wgt
    inv = 1.0 / np.maximum(acc_w, 1e-6)
    return acc * inv[..., None], acc_var * inv * inv


@pytest.mark.parametrize("form", ["static", "scan"])
@pytest.mark.parametrize("step", [1, 2, 4, 8, 16])
def test_atrous_odd_sizes(step, form):
    """Odd image sizes (not a multiple of any tile) at every dilation step,
    in both the static-shift and the scan (traced step) forms."""
    illum, var, vz, n = _planes(seed=step)
    s = relax.RelaxSettings()
    max_step = None if form == "static" else 16
    step_arg = step if form == "static" else jnp.int32(step)
    got_i, got_v = relax.atrous_iteration(
        jnp.asarray(illum), jnp.asarray(var), jnp.asarray(vz), jnp.asarray(n),
        step_arg, s, max_step=max_step)
    want_i, want_v = np_atrous(illum, var, vz, n, step, s)
    np.testing.assert_allclose(np.asarray(got_i), want_i, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_v), want_v, rtol=1e-4, atol=1e-6)


def _history(h, w, seed=3):
    rs = np.random.RandomState(seed)
    illum, _, vz, n = _planes(h, w, seed)
    hist = relax.RelaxHistory(
        illum=jnp.asarray(rs.rand(h, w, 3).astype(np.float32) * 2.0),
        moments=jnp.asarray(rs.rand(h, w, 2).astype(np.float32)),
        view_z=jnp.asarray(vz),
        normal=jnp.asarray(n),
        frames=jnp.asarray((rs.rand(h, w) * 20).astype(np.float32)),
    )
    mv = np.zeros((h, w, 3), np.float32)
    mv[..., :2] = rs.uniform(-0.4, 0.4, (h, w, 2))
    return hist, jnp.asarray(illum), jnp.asarray(vz), jnp.asarray(n), jnp.asarray(mv)


def test_reset_zeroes_history():
    hist, illum, vz, n, mv = _history(24, 40)
    s = relax.RelaxSettings()
    acc, moments, frames, _ = relax.temporal_accumulate(
        hist, illum, vz, n, mv, s, reset=jnp.bool_(True))
    np.testing.assert_allclose(np.asarray(frames), 1.0)
    np.testing.assert_allclose(np.asarray(acc), np.asarray(illum), rtol=1e-6)
    lum = np.asarray(common.luminance(illum))
    np.testing.assert_allclose(np.asarray(moments)[..., 1], lum * lum, rtol=1e-5)


@pytest.mark.parametrize("conf", [0.0, 0.5, 1.0])
def test_confidence_scales_history(conf):
    """History confidence multiplies the reprojected validity: 0 cuts the
    history (frames = 1), 1 leaves temporal accumulation unchanged."""
    hist, illum, vz, n, mv = _history(24, 40, seed=5)
    s = relax.RelaxSettings(max_accumulated_frames=30)
    base = relax.temporal_accumulate(hist, illum, vz, n, mv, s)
    got = relax.temporal_accumulate(hist, illum, vz, n, mv, s,
                                    confidence=jnp.full(vz.shape, conf))
    prev_frames = np_bilinear(hist.frames, np.asarray(
        common.pixel_positions(24, 40)) + np.asarray(mv)[..., :2])
    valid = (np.asarray(base[2]) > 1.0).astype(np.float64)
    want = np.minimum(prev_frames * valid * conf + 1.0, 30.0)
    np.testing.assert_allclose(np.asarray(got[2]), want, rtol=1e-5, atol=1e-5)
    if conf == 1.0:
        for a, b in zip(got[:2], base[:2]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)
    if conf == 0.0:
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(illum), rtol=1e-6)


def test_relax_pre_gathered_equals_inline():
    """The staged gather pass's pre-gathered history gives the inline result."""
    hist, illum, vz, n, mv = _history(20, 28, seed=7)
    plane, pos = relax.taccum_requests(hist, mv[..., :2])
    pre = filtering.sample_bilinear(plane, pos)
    a, ha = relax.denoise(hist, illum, vz, n, mv)
    b, hb = relax.denoise(hist, illum, vz, n, mv, pre=pre)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ha.frames), np.asarray(hb.frames))


def test_sigma_pre_gathered_equals_inline():
    rs = np.random.RandomState(2)
    h, w = 20, 28
    shadow = jnp.asarray((rs.rand(h, w) > 0.4).astype(np.float32))
    hit = jnp.asarray(rs.rand(h, w).astype(np.float32) * (1 - np.asarray(shadow)))
    vz = jnp.asarray((1.0 + rs.rand(h, w) * 4).astype(np.float32))
    mv = jnp.asarray(rs.uniform(-2, 2, (h, w, 3)).astype(np.float32))
    hist = sigma.SigmaHistory.create(h, w)
    args = (hist, shadow, hit, vz, mv, 0.01, 1e-3, jnp.int32(3))
    plane, pos = sigma.requests(*args)["temporal"]
    a, _ = sigma.denoise(*args)
    b, _ = sigma.denoise(*args, pre={"temporal": filtering.sample_bilinear(plane, pos)})
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


def test_variance_short_history_spatial_fallback():
    """Fewer than 4 accumulated frames: variance is at least the 3x3 spatial
    estimate; long histories use the temporal moments alone."""
    illum, _, _, _ = _planes(16, 20, seed=9)
    lum = np.asarray(common.luminance(jnp.asarray(illum)))
    moments = np.stack([lum, lum * lum + 0.01], axis=-1).astype(np.float32)
    for frames, expect_spatial in ((2.0, True), (10.0, False)):
        var = np.asarray(relax.estimate_variance(
            jnp.asarray(illum), jnp.asarray(moments),
            jnp.full(lum.shape, frames)))
        if expect_spatial:
            assert (var >= 0.01 - 1e-6).all() and (var > 0.0105).any()
        else:
            np.testing.assert_allclose(var, 0.01, rtol=1e-2, atol=1e-4)


def _taa_planes(h=24, w=32, seed=0):
    rs = np.random.RandomState(seed)
    cur = jnp.asarray(rs.rand(h, w, 3).astype(np.float32) * 1.5)
    prev = jnp.asarray(rs.rand(h, w, 3).astype(np.float32) * 1.5)
    mv_d = jnp.asarray(rs.uniform(-3, 3, (h, w, 2)).astype(np.float32))
    return cur, prev, mv_d


def test_taa_offscreen_forces_full_mix():
    """Pixels whose dilated velocity lands off screen take cur wholesale."""
    cur, prev, mv_d = _taa_planes(seed=4)
    big = mv_d.at[..., 0].set(500.0)
    got = taa.resolve_tail(cur, prev, big, None, jnp.zeros(cur.shape[:2]),
                           cfgmod.TAA_SIGMA_SCALE, 0.1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(cur), rtol=1e-5, atol=1e-5)


def test_taa_apply_history():
    """First frame (history invalid) returns cur; the next blends history."""
    rs = np.random.RandomState(1)
    h = w = 48
    cur = jnp.asarray(rs.rand(h, w, 3).astype(np.float32))
    mv = jnp.zeros((h, w, 3), jnp.float32)
    vz = jnp.ones((h, w), jnp.float32)
    out, hist2 = taa.apply(taa.TaaHistory.create(h, w), cur, mv, vz)
    np.testing.assert_allclose(np.asarray(out), np.asarray(cur), rtol=1e-6)
    out2, _ = taa.apply(hist2, cur * 0.5, mv, vz)
    assert np.isfinite(np.asarray(out2)).all()
    assert not np.allclose(np.asarray(out2), np.asarray(cur * 0.5))
