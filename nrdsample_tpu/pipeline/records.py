"""Settings+camera test records — the Tests/*.bin replay system.

Reference (SURVEY.md §4.1): a "test" is a 648-byte raw memcpy of
`struct Settings` + camera state (NRDSample.cpp:1788), stored per scene in
Tests/<scene>.bin, loaded by index with volatile-field reset + forced history
reset (1870-1899), advanced with F2. Curated watch lists mark
regression-sensitive ("checkMe") and known-weak ("improveMe") records.

Here a record is JSON (versioned, diffable); `load_record` resets the same
volatile fields; pytest parametrizes over the lists (SURVEY.md §4 implication).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import jax.numpy as jnp
import numpy as np

from nrdsample_tpu.config import Settings
from nrdsample_tpu.scene.types import Camera

RECORD_VERSION = 2

# RenderConfig fields a record may pin (serialized by name; everything else
# stays at the replay harness's defaults). The reference's 648-byte blob pins
# the analogous toggles via Settings bit-fields (NRDSample.cpp:1788).
RENDER_FIELDS = (
    "denoiser", "tracing_mode", "nrd_mode", "bounce_num", "rpp",
    "psr_bounce_num", "use_sharc", "use_confidence", "use_taa",
    "use_translucency", "use_hair_sss", "use_l1_cache",
    # stress/fault-injection pins (SURVEY.md §5.3)
    "use_inf_stress_test", "use_drs_stress_test", "use_firefly_test",
    "use_material_id_test", "use_sanitization",
)

# Curated watch lists (NRDSample.cpp:58-79 analogue): indices into a scene's
# record file that are regression-sensitive or known-weak. One record per
# non-default STATIC bucket (VERDICT r3 #9): every denoiser / tracing-mode /
# nrd-mode / rpp / bounce / feature-flag value the corpus pins has a golden.
CHECK_ME: dict[str, list[int]] = {
    "cornellbox": [
        0,    # legacy default bucket
        3,    # REBLUR, bounce 1
        4,    # RELAX, bounce 1
        6,    # REBLUR, bounce 2, rpp 2
        7,    # NrdMode.OCCLUSION
        8,    # NrdMode.SH
        10,   # TracingMode.FULL
        11,   # TracingMode.HALF (checkerboard)
        12,   # RELAX + TAA
    ],
    "kitchen": [
        0,
        2,    # PSR mirror walk
        5,    # SHARC + history confidence
        7,    # L1 cache
    ],
    "shaderballs": [0, 3],
    "interior-night": [
        0,
        9,    # hair/SSS (RTXCR slot)
        147,  # blinking emitters (moving-emission fix + lights/cubes split)
    ],
    "cornellbox-glass": [
        2,    # SIGMA translucency march
    ],
}


def static_bucket(render: dict) -> str:
    """Stable key of the jit-compile bucket a record's RenderConfig pins land
    in. Replay harnesses group records by this so each worker compiles each
    bucket once (the reference replays everything in ONE binary's pipelines;
    our analogue is bounding jit cache misses)."""
    return ",".join(f"{k}={render[k]}" for k in sorted(render))
IMPROVE_ME: dict[str, dict[str, list[int]]] = {
    "reblur": {"interior-night": [2]},   # low-emission record: slow converge
    "relax": {"shaderballs": [5]},       # high roughness-override record
}


def record_to_dict(settings: Settings, cam: Camera,
                   render: dict | None = None,
                   animation: dict | None = None) -> dict:
    """render: RenderConfig overrides (subset of RENDER_FIELDS, enums as int);
    animation: e.g. {"mode": "orbit", "frames": 3} — replayed as a short
    multi-frame sequence with moving geometry + camera."""
    d = {
        "version": RECORD_VERSION,
        "settings": {
            f.name: np.asarray(getattr(settings, f.name)).tolist()
            for f in dataclasses.fields(settings)
        },
        "camera": {
            "view_to_world": np.asarray(cam.view_to_world).tolist(),
            "tan_half_fov_y": float(cam.tan_half_fov_y),
            "aspect": float(cam.aspect),
            "near_z": float(cam.near_z),
            "aperture": float(cam.aperture),
            "focal_distance": float(cam.focal_distance),
            "ortho": float(cam.ortho),
        },
    }
    if render:
        unknown = set(render) - set(RENDER_FIELDS)
        assert not unknown, f"unknown render fields {unknown}"
        d["render"] = {k: int(v) if not isinstance(v, bool) else v
                       for k, v in render.items()}
    if animation:
        d["animation"] = animation
    return d


def dict_to_record(d: dict) -> tuple[Settings, Camera]:
    assert d.get("version") in (1, RECORD_VERSION), \
        f"unknown record version {d.get('version')}"
    s = Settings(
        **{
            k: (jnp.int32(v) if isinstance(v, int) else jnp.float32(v))
            for k, v in d["settings"].items()
        }
    )
    c = d["camera"]
    v2w = jnp.asarray(np.array(c["view_to_world"], np.float32))
    cam = Camera(
        view_to_world=v2w,
        view_to_world_prev=v2w,
        tan_half_fov_y=jnp.float32(c["tan_half_fov_y"]),
        aspect=jnp.float32(c["aspect"]),
        near_z=jnp.float32(c["near_z"]),
        jitter=jnp.zeros(2, jnp.float32),
        jitter_prev=jnp.zeros(2, jnp.float32),
        aperture=jnp.float32(c["aperture"]),
        focal_distance=jnp.float32(c["focal_distance"]),
        ortho=jnp.float32(c["ortho"]),
    )
    return s, cam


def save_record(path: str, settings: Settings, cam: Camera, index: int | None = None):
    """Append (or overwrite at index) a record in a per-scene JSON file —
    the UI "Add" button (NRDSample.cpp:1911-1923)."""
    records = []
    if os.path.exists(path):
        with open(path) as f:
            records = json.load(f)
    rec = record_to_dict(settings, cam)
    if index is None or index >= len(records):
        records.append(rec)
    else:
        records[index] = rec
    with open(path, "w") as f:
        json.dump(records, f, indent=1)
    return len(records) - 1


def load_record(path: str, index: int) -> tuple[Settings, Camera]:
    """Load record by index with volatile-field reset (NRDSample.cpp:1885-1892:
    debug off, jitter on, forced history reset is the caller's job)."""
    settings, cam, _, _ = load_record_full(path, index)
    return settings, cam


def load_record_full(path: str, index: int
                     ) -> tuple[Settings, Camera, dict, dict | None]:
    """(settings, camera, render_overrides, animation|None) — v2 records carry
    RenderConfig pins + optional animation; v1 records return empty overrides."""
    with open(path) as f:
        records = json.load(f)
    d = records[index]
    settings, cam = dict_to_record(d)
    settings = dataclasses.replace(
        settings, debug=jnp.float32(0.0), separator=jnp.float32(0.0)
    )
    return settings, cam, d.get("render", {}), d.get("animation")


def count_records(path: str) -> int:
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return len(json.load(f))
