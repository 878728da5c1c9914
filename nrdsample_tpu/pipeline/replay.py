"""Record replay harness shared by the pytest suite and the golden-image
tools — the runtime half of the Tests/*.bin mechanism (SURVEY.md §4.1;
NRDSample.cpp:1771-1948: load record by index, reset volatile fields, force a
history reset, render).

`render_record` replays one record end-to-end at a given resolution; the
golden gate (tools/make_goldens.py + tests/test_golden.py) stores per-tile
statistics of the result and asserts them on every run — the
analogue of the reference's human-inspected regression states, made
machine-checkable."""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from nrdsample_tpu.config import Denoiser, NrdMode, RenderConfig, TracingMode
from nrdsample_tpu.ops import traversal
from nrdsample_tpu.pipeline import frame as frame_mod, records
from nrdsample_tpu.scene import procedural
from nrdsample_tpu.scene.types import look_at

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TESTS_DIR = os.path.join(REPO, "Tests")
GOLDEN_DIR = os.path.join(TESTS_DIR, "golden")

#: replay scenes at test scale (procedural stand-ins for the reference's glTFs)
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


def build_contexts(scene_names=None):
    """(ctx, scene) per scene name; build once, reuse across records."""
    out = {}
    for name in scene_names or SCENES:
        scene = SCENES[name]()
        if name in GLASS_SCENES:
            out[name] = traversal.build_scene_contexts(scene)
        else:
            out[name] = traversal.build_context(scene)
    return out


def cfg_from_render(render: dict, res: int = 32) -> RenderConfig:
    kw = dict(width=res, height=res, rpp=1, bounce_num=1,
              tracing_mode=TracingMode.FULL_PROBABILISTIC,
              denoiser=Denoiser.REFERENCE)
    enums = {"denoiser": Denoiser, "tracing_mode": TracingMode,
             "nrd_mode": NrdMode}
    for k, v in render.items():
        kw[k] = enums[k](v) if k in enums else v
    if kw.get("use_sharc"):
        kw["sharc_capacity"] = 1 << 14  # the full 4M-entry table is the frame-scale default
    return RenderConfig(**kw)


def orbit_cam(cam, step: int, total: int):
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


def render_record(contexts: dict, scene_name: str, index: int, res: int = 32):
    """Replay one record (all its animation frames). Returns (out, history)."""
    path = os.path.join(TESTS_DIR, f"{scene_name}.json")
    settings, cam, render, animation = records.load_record_full(path, index)
    ctx, scene = contexts[scene_name]
    cfg = cfg_from_render(render, res=res)
    hist = frame_mod.History.create(cfg)
    frames = (animation or {}).get("frames", 1)
    out = None
    for step in range(frames):
        use_orbit = animation and animation.get("mode", "orbit") == "orbit"
        frame_cam = orbit_cam(cam, step, frames) if use_orbit else cam
        out, hist = frame_mod.render_frame(
            ctx, scene, frame_cam, cfg, settings, hist,
            reset_history=(step == 0),  # forced history reset on record load
        )
    return out, hist


TILE = 8


def golden_stats(color: np.ndarray, res: int) -> dict:
    """Robust per-tile statistics of a flat (res*res, 3) color image: tile
    means + global mean/std — sensitive to denoiser regressions (a blur-to-
    gray failure shifts tile means), tolerant of tiny numeric drift."""
    img = np.asarray(color, np.float32).reshape(res, res, 3)
    nt = res // TILE
    tiles = img.reshape(nt, TILE, nt, TILE, 3).mean(axis=(1, 3))
    return {
        "tile_means": tiles.astype(np.float32),
        "mean": np.float32(img.mean()),
        "std": np.float32(img.std()),
    }


def golden_path(scene_name: str, index: int) -> str:
    return os.path.join(GOLDEN_DIR, f"{scene_name}-{index:03d}.npz")
