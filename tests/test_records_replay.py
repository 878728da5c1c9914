"""Replay the shipped Tests/*.json settings+camera records — the Tests/*.bin
regression mechanism (SURVEY.md §4.1, NRDSample.cpp:1788): each record renders
without error under ITS OWN pinned render config (v2 records carry denoiser /
SHARC / PSR / checkerboard / TAA pins), animated records advance a short
camera orbit with history carried across frames, and the curated CHECK_ME
records render deterministically (replay twice, identical output — the whole
frame is a pure function of (record, frame index))."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nrdsample_tpu.config import Denoiser, NrdMode, RenderConfig, TracingMode
from nrdsample_tpu.ops import traversal
from nrdsample_tpu.pipeline import frame as frame_mod, records
from nrdsample_tpu.scene import procedural
from nrdsample_tpu.scene.types import look_at

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 32

SCENES = {
    "cornellbox": procedural.cornell_box,
    "cornellbox-glass": procedural.cornell_box_glass,
    "kitchen": procedural.kitchen,
    "shaderballs": lambda: procedural.shader_balls(grid=2, sphere_res=12),
    "interior-night": lambda: procedural.interior_night(n_lights=8, grid=2,
                                                        sphere_res=10),
    "exterior": lambda: procedural.exterior(blocks=2, window_grid=2, cobbles=8,
                                            tree_count=6, tree_res=8,
                                            lamp_count=4),
}
GLASS_SCENES = {"cornellbox-glass", "exterior"}


def _record_ids():
    out = []
    for scene in SCENES:
        path = os.path.join(REPO, "Tests", f"{scene}.json")
        for i in range(records.count_records(path)):
            out.append((scene, i))
    return out


def _cfg_from_render(render: dict) -> RenderConfig:
    kw = dict(width=RES, height=RES, rpp=1, bounce_num=1,
              tracing_mode=TracingMode.FULL_PROBABILISTIC,
              denoiser=Denoiser.REFERENCE)
    enums = {"denoiser": Denoiser, "tracing_mode": TracingMode,
             "nrd_mode": NrdMode}
    for k, v in render.items():
        kw[k] = enums[k](v) if k in enums else v
    if kw.get("use_sharc"):
        kw["sharc_capacity"] = 1 << 14  # the full 4M-entry table is the frame-scale default
    return RenderConfig(**kw)


def _orbit_cam(cam, step: int, total: int):
    """Small camera orbit around the look target: rotate eye by a few degrees
    per frame about world z, threading view_to_world_prev correctly."""
    def at(i):
        ang = np.deg2rad(4.0 * i)
        v2w = np.asarray(cam.view_to_world)
        eye = v2w[:3, 3]
        c, s = np.cos(ang), np.sin(ang)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
        new_eye = rot @ eye
        # keep looking at the same point the original camera looked at
        fwd = v2w[:3, 2]
        target = eye + fwd * 3.0
        return look_at(eye=new_eye.tolist(), target=(rot @ target).tolist(),
                       fov_y_deg=60.0)
    cur = at(step)
    prev = at(max(step - 1, 0))
    return dataclasses.replace(
        cur,
        view_to_world_prev=prev.view_to_world,
        tan_half_fov_y=cam.tan_half_fov_y,
        aspect=cam.aspect,
    )


@pytest.fixture(scope="module")
def contexts():
    out = {}
    for name, fn in SCENES.items():
        scene = fn()
        if name in GLASS_SCENES:
            out[name] = traversal.build_scene_contexts(scene)
        else:
            out[name] = traversal.build_context(scene)
    return out


_JITTED: dict = {}


def _jitted_frame(contexts, scene_name, cfg):
    """One compiled frame program per unique (scene, RenderConfig): the
    corpus deliberately reuses render configs across its state sweeps (like
    the reference's 343 state-only .bin records over ~10 pipeline setups,
    NRDSample.cpp:1788), so replay cost is one compile per config plus a fast
    execution per record — not an eager re-trace per record."""
    key = (scene_name, cfg)
    if key not in _JITTED:
        ctx, scene = contexts[scene_name]

        @jax.jit
        def fn(scene, cam, settings, history, reset):
            return frame_mod.render_frame(
                ctx, scene, cam, cfg, settings, history, reset_history=reset
            )

        _JITTED[key] = fn
    return _JITTED[key]


@pytest.mark.parametrize("scene_name,index", _record_ids())
def test_record_renders(contexts, scene_name, index):
    path = os.path.join(REPO, "Tests", f"{scene_name}.json")
    settings, cam, render, animation = records.load_record_full(path, index)
    ctx, scene = contexts[scene_name]
    cfg = _cfg_from_render(render)
    hist = frame_mod.History.create(cfg)
    frames = (animation or {}).get("frames", 1)
    fn = _jitted_frame(contexts, scene_name, cfg)
    out = None
    for step in range(frames):
        frame_cam = _orbit_cam(cam, step, frames) if animation else cam
        # forced history reset on record load (step 0), traced flag
        out, hist = fn(scene, frame_cam, settings, hist, jnp.bool_(step == 0))
    img = np.asarray(out["color"])
    assert np.isfinite(img).all()
    assert img.max() > 0.0


@pytest.mark.parametrize("index", records.CHECK_ME.get("cornellbox", []))
def test_check_me_deterministic(contexts, index):
    """checkMe records are the regression-sensitive set: the replay must be
    bit-deterministic (failure recovery story, SURVEY.md §5.3)."""
    path = os.path.join(REPO, "Tests", "cornellbox.json")
    settings, cam, render, _ = records.load_record_full(path, index)
    ctx, scene = contexts["cornellbox"]
    cfg = _cfg_from_render(render)

    def render_once():
        out, _ = frame_mod.render_frame(
            ctx, scene, cam, cfg, settings, frame_mod.History.create(cfg)
        )
        return np.asarray(out["color"])

    a = render_once()
    b = render_once()
    np.testing.assert_array_equal(a, b)


def test_corpus_size():
    """The shipped corpus stays at reference-meaningful density (the reference
    ships 343 .bin records; the corpus now matches that count)."""
    total = sum(records.count_records(os.path.join(REPO, "Tests", f"{s}.json"))
                for s in SCENES)
    assert total >= 343, total


def test_corpus_covers_feature_matrix():
    """At least one record pins each headline feature combination."""
    import json
    seen = set()
    for s in SCENES:
        path = os.path.join(REPO, "Tests", f"{s}.json")
        if not os.path.exists(path):
            continue
        for d in json.load(open(path)):
            r = d.get("render", {})
            if r.get("use_sharc"):
                seen.add("sharc")
            if r.get("psr_bounce_num", 0) > 0:
                seen.add("psr")
            if r.get("tracing_mode") == int(TracingMode.HALF):
                seen.add("checkerboard")
            if r.get("use_taa"):
                seen.add("taa")
            if r.get("use_confidence"):
                seen.add("confidence")
            if d.get("animation"):
                seen.add("animated")
            if s in GLASS_SCENES and "denoiser" in r:
                seen.add("glass")
    assert seen >= {"sharc", "psr", "checkerboard", "taa", "confidence",
                    "animated", "glass"}, seen
