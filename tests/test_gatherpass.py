"""Staged gather-pass parity (denoise/gatherpass.py).

The staged frame hoists every history reprojection into a dedicated
gathers-only jit program. These tests pin:
  1. sample_bilinear_block == sample_bilinear (the robust tap form) texel-for-
     texel, including edge clamping and batched positions,
  2. the staged frame (make_staged_frame) == the monolithic jitted frame on
     the full flagship config, outputs AND history, over several frames.
"""

import numpy as np
import jax
import jax.numpy as jnp

from nrdsample_tpu.config import Denoiser, RenderConfig, Settings, TracingMode
from nrdsample_tpu.mathlib import filtering
from nrdsample_tpu.ops import traversal
from nrdsample_tpu.pipeline import frame as frame_mod
from nrdsample_tpu.scene import procedural
from nrdsample_tpu.scene.types import look_at


def test_block_gather_matches_taps():
    rng = np.random.default_rng(7)
    img = jnp.asarray(rng.standard_normal((33, 41, 5)), jnp.float32)
    # positions spanning in-bounds, sub-texel, and far out-of-bounds
    pos = jnp.asarray(
        rng.uniform(-8.0, 50.0, (17, 23, 2)), jnp.float32
    )
    a = filtering.sample_bilinear(img, pos)
    b = filtering.sample_bilinear_block(img, pos)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_block_gather_2d_and_batched():
    rng = np.random.default_rng(3)
    img = jnp.asarray(rng.standard_normal((16, 24)), jnp.float32)
    pos = jnp.asarray(rng.uniform(-2.0, 30.0, (4, 9, 11, 2)), jnp.float32)
    a = filtering.sample_bilinear(img[..., None], pos)[..., 0]
    b = filtering.sample_bilinear_block(img, pos)
    assert b.shape == (4, 9, 11)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_bicubic_block_matches_taps():
    rng = np.random.default_rng(11)
    img = jnp.asarray(rng.standard_normal((20, 28, 3)), jnp.float32)
    pos = jnp.asarray(rng.uniform(-1.0, 30.0, (10, 14, 2)), jnp.float32)
    a = filtering.sample_bicubic_no_corners(img, pos)
    b = filtering.sample_bicubic_no_corners(
        img, pos, bilinear_fn=filtering.sample_bilinear_block
    )
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def _setup(denoiser):
    scene = procedural.cornell_box()
    ctx, scene = traversal.build_context(scene)
    cfg = RenderConfig(
        width=40, height=40, rpp=1, bounce_num=1,
        tracing_mode=TracingMode.FULL_PROBABILISTIC,
        denoiser=denoiser, use_taa=True,
    )
    cam = look_at(eye=[0.0, -3.2, 1.0], target=[0.0, 0.0, 1.0],
                  fov_y_deg=39.0, aspect=1.0)
    settings = Settings(sun_elevation=jnp.float32(40.0))
    return ctx, scene, cam, cfg, settings


def _run_frames(frame_fn, scene, cam, cfg, settings, n=3):
    hist = frame_mod.History.create(cfg)
    out = None
    for _ in range(n):
        out, hist = frame_fn(scene, cam, settings, hist)
    return out, hist


def _assert_tree_close(ta, tb, atol):
    la, lb = jax.tree.leaves(ta), jax.tree.leaves(tb)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        # rtol covers large-magnitude planes (hit distances ~1e4 where rays
        # miss); atol covers radiance-scale planes
        np.testing.assert_allclose(
            np.asarray(a, np.float64), np.asarray(b, np.float64),
            atol=atol, rtol=1e-4,
        )


def test_staged_frame_matches_monolithic():
    for denoiser in (Denoiser.RELAX, Denoiser.REBLUR):
        ctx, scene, cam, cfg, settings = _setup(denoiser)
        out_m, hist_m = _run_frames(
            frame_mod.make_jitted_frame(ctx, cfg), scene, cam, cfg, settings
        )
        out_s, hist_s = _run_frames(
            frame_mod.make_staged_frame(ctx, cfg), scene, cam, cfg, settings
        )
        # the block and tap gather forms associate the bilinear blend
        # differently; 3 frames of accumulation amplify the float noise
        np.testing.assert_allclose(
            np.asarray(out_m["color"]), np.asarray(out_s["color"]), atol=5e-4
        )
        np.testing.assert_allclose(
            np.asarray(out_m["final"]), np.asarray(out_s["final"]), atol=5e-4
        )
        _assert_tree_close(hist_m, hist_s, atol=5e-4)


def test_staged_frame_reference_fallback():
    # no gather requests for REFERENCE without TAA -> monolithic fallback
    scene = procedural.cornell_box()
    ctx, scene = traversal.build_context(scene)
    cfg = RenderConfig(width=32, height=32, rpp=1, bounce_num=1,
                       denoiser=Denoiser.REFERENCE)
    cam = look_at(eye=[0.0, -3.2, 1.0], target=[0.0, 0.0, 1.0],
                  fov_y_deg=39.0, aspect=1.0)
    settings = Settings(sun_elevation=jnp.float32(40.0))
    out_s, _ = _run_frames(
        frame_mod.make_staged_frame(ctx, cfg), scene, cam, cfg, settings
    )
    out_m, _ = _run_frames(
        frame_mod.make_jitted_frame(ctx, cfg), scene, cam, cfg, settings
    )
    np.testing.assert_allclose(
        np.asarray(out_m["color"]), np.asarray(out_s["color"]), atol=1e-6
    )
