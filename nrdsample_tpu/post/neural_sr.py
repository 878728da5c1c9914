"""Learned super-resolution for the DLSS-SR slot.

The reference dispatches DLSS-SR with guide buffers prepared by
DlssBefore.cs.hlsl:15-62 and consumed at NRDSample.cpp:791-867 / 4284-4317.
Here the slot is a small residual CNN: the base estimate is the Lanczos-2
resize (post/upscale.py, two matmuls), and the network — conditioned on the
G-buffer guides (normal, roughness, hw-depth) — predicts a residual
correction. Weights ship with the repo (tools/train_neural_sr.py trains them
on repo-rendered low/high pairs; tests/test_neural_sr.py asserts PSNR beats
plain Lanczos on a held-out scene).

Notes: 3x3 convs at NHWC lower to XLA convolutions;
the whole network is ~11k parameters, so the weights travel as tiny HLO
constants inside the jitted frame.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp

from nrdsample_tpu.post import upscale

WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "neural_sr.npz")

# input channels: lanczos-upscaled color(3) + normal(3) + roughness(1) +
# hw_depth(1)
C_IN = 8
HIDDEN = 24
LAYERS = 3  # conv(in->h) relu conv(h->h) relu conv(h->3)


def init_params(key) -> dict:
    """He-initialized 3x3 conv stack; final layer zero-init so the untrained
    network is exactly Lanczos (residual starts at 0)."""
    ks = jax.random.split(key, LAYERS)
    shapes = [(3, 3, C_IN, HIDDEN), (3, 3, HIDDEN, HIDDEN), (3, 3, HIDDEN, 3)]
    params = {}
    for i, (k, shp) in enumerate(zip(ks, shapes)):
        fan_in = shp[0] * shp[1] * shp[2]
        w = jax.random.normal(k, shp, jnp.float32) * np.sqrt(2.0 / fan_in)
        if i == LAYERS - 1:
            w = jnp.zeros(shp, jnp.float32)
        params[f"w{i}"] = w
        params[f"b{i}"] = jnp.zeros((shp[3],), jnp.float32)
    return params


def _conv(x, w, b):
    y = jax.lax.conv_general_dilated(
        x[None], w, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )[0]
    return y + b


def apply(params: dict, color: jnp.ndarray, guides: dict,
          out_h: int, out_w: int) -> jnp.ndarray:
    """Upscale (H, W, 3) render-res color to (out_h, out_w, 3).

    guides: dict with render-res (H, W, 3) "normal", (H, W) "roughness",
    (H, W) "depth" (hw_depth from post/guides.py). Guides are Lanczos-lifted
    to output res and concatenated with the base estimate.
    """
    base = upscale.lanczos_resize(color, out_h, out_w)
    n_up = upscale.lanczos_resize(guides["normal"], out_h, out_w)
    r_up = upscale.lanczos_resize(guides["roughness"], out_h, out_w)
    d_up = upscale.lanczos_resize(guides["depth"], out_h, out_w)
    x = jnp.concatenate(
        [base, n_up, r_up[..., None], d_up[..., None]], axis=-1)
    for i in range(LAYERS):
        x = _conv(x, params[f"w{i}"], params[f"b{i}"])
        if i < LAYERS - 1:
            x = jax.nn.relu(x)
    return jnp.maximum(base + x, 0.0)


@functools.lru_cache(maxsize=1)
def load_weights(path: str = WEIGHTS_PATH) -> dict | None:
    """Shipped weights as numpy (None if the file is absent — callers fall
    back to Lanczos)."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: jnp.asarray(z[k]) for k in z.files}


def save_weights(params: dict, path: str = WEIGHTS_PATH):
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
