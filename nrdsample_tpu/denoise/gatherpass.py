"""The gather pass — history reprojection as its own pipeline stage.

The reference samples history textures with the GPU's hardware gather from
inside each denoiser pass (e.g. Taa.cs.hlsl:122-123). This module can instead
hoist ALL history gathers into one dedicated jit program between the "plan"
stage (elementwise: sample positions, packed planes) and the "finish" stage
(elementwise/stencil: blends, a-trous chains); pipeline/frame.py's
`make_staged_frame` uses it. The production frame gathers inline.

Protocol: each denoiser exposes a ``requests(...)`` function returning
``{name: (plane, pos)}`` plus a mode per request ("bilinear" | "bicubic");
``execute`` runs every request with the fast block gather. The denoiser's
finish path accepts the gathered results via a ``pre=`` argument and falls
back to in-program robust tap gathers when ``pre is None`` (CPU tests,
monolithic jit, autodiff training).
"""

from __future__ import annotations

import jax.numpy as jnp

from nrdsample_tpu.mathlib import filtering

BILINEAR = "bilinear"
BICUBIC = "bicubic"


def execute(requests: dict, modes: dict) -> dict:
    """Run every gather request with the fast block emitter.

    requests: {name: (plane [H,W,C?], pos [...,2])}; modes: {name: mode}.
    MUST be jitted as its own program with nothing else in it — any
    substantial extra computation un-matches the hardware gather.
    """
    out = {}
    for name in sorted(requests):
        plane, pos = requests[name]
        if modes[name] == BICUBIC:
            out[name] = filtering.sample_bicubic_no_corners(
                plane, pos, bilinear_fn=filtering.sample_bilinear_block
            )
        else:
            out[name] = filtering.sample_bilinear_block(plane, pos)
    return out


def execute_inline(requests: dict, modes: dict) -> dict:
    """Reference path: the same requests inline in a monolithic program,
    with the clamp-to-edge tap gathers."""
    out = {}
    for name in sorted(requests):
        plane, pos = requests[name]
        if modes[name] == BICUBIC:
            out[name] = filtering.sample_bicubic_no_corners(plane, pos)
        else:
            out[name] = filtering.sample_bilinear(plane, pos)
    return out
