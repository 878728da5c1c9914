"""Dynamic resolution scaling (pipeline/drs.py) — the static-shape gRectSize
analogue (NRDSample.cpp:2104-2119): bucketed static shapes, a host-side
feedback controller, and history resampling across bucket switches."""

import jax
import jax.numpy as jnp
import numpy as np

from nrdsample_tpu.config import Denoiser, RenderConfig, Settings, TracingMode
from nrdsample_tpu.ops import traversal
from nrdsample_tpu.pipeline import drs, frame as frame_mod
from nrdsample_tpu.scene import procedural
from nrdsample_tpu.scene.types import look_at


def test_controller_steps_down_when_over_budget():
    c = drs.DrsController(target_ms=10.0)
    assert c.scale == 1.0
    for _ in range(12):
        c.update(25.0)  # consistently over budget
    assert c.scale < 1.0


def test_controller_steps_back_up_with_headroom():
    c = drs.DrsController(target_ms=10.0, start_index=3)
    for _ in range(12):
        c.update(2.0)  # far under budget even after quadratic scale-up
    assert c.scale > drs.BUCKETS[3]


def test_controller_holds_at_target():
    c = drs.DrsController(target_ms=10.0, start_index=1)
    for _ in range(20):
        c.update(9.5)
    assert c.index == 1  # within budget, stepping up would bust it


def test_render_size_alignment():
    w, h = drs.render_size(1920, 1080, 0.75)
    assert w % 8 == 0 and h % 8 == 0
    assert abs(w - 1440) <= 8 and abs(h - 810) <= 8


def test_two_bucket_animate_with_history_resize():
    """Render at full bucket, switch down, resize history, keep rendering:
    output stays finite at the new size and history structure is preserved."""
    scene = procedural.cornell_box()
    ctx, scene = traversal.build_context(scene)
    cam = look_at(eye=[0.0, -3.2, 1.0], target=[0.0, 0.0, 1.0], fov_y_deg=39.0)
    settings = Settings()
    base = RenderConfig(width=32, height=32, rpp=1, bounce_num=1,
                        tracing_mode=TracingMode.FULL_PROBABILISTIC,
                        denoiser=Denoiser.RELAX, use_taa=True)

    cfg_a = drs.bucket_cfg(base, 1.0)
    cfg_b = drs.bucket_cfg(base, 0.5)
    assert (cfg_b.width, cfg_b.height) == (16, 16)
    assert (cfg_b.output_width, cfg_b.output_height) == (32, 32)

    hist = frame_mod.History.create(cfg_a)
    out = None
    for cfg in (cfg_a, cfg_a, cfg_b, cfg_b):
        if out is not None and cfg is cfg_b and prev_cfg is cfg_a:
            hist = drs.resize_history(hist, cfg_a, cfg_b)
            ref = frame_mod.History.create(cfg_b)
            assert (jax.tree_util.tree_structure(hist)
                    == jax.tree_util.tree_structure(ref))
            for got, want in zip(jax.tree_util.tree_leaves(hist),
                                 jax.tree_util.tree_leaves(ref)):
                assert got.shape == want.shape, (got.shape, want.shape)
        out, hist = jax.jit(
            lambda h, c=cfg: frame_mod.render_frame(
                ctx, scene, cam, c, settings, h)
        )(hist)
        prev_cfg = cfg
    # display is always at the pinned output size, finite
    assert out["display"].shape == (32, 32, 3)
    assert bool(jnp.all(jnp.isfinite(out["display"])))
    # the frame counter survived all four frames (history wasn't recreated)
    assert int(hist.frame_index) == 4
