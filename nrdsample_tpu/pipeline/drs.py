"""Dynamic resolution scaling (DRS) — the gRectSize mechanism under static shapes.

The reference adjusts the render rect every frame from measured GPU timings
and crops all passes by `gRectSize` (NRDSample.cpp:2104-2119). Under XLA every
jitted program has static shapes, so a continuously varying rect would
recompile each frame; the equivalent here is a small static BUCKET
ladder: the controller picks a scale bucket from an EMA of frame times, each
bucket is a separate jit specialization at (round8(h*s), round8(w*s)) — XLA
caches one executable per bucket — and the display chain upscales the bucket
output to the fixed output size (post/upscale.py or the neural-SR slot).

History survives bucket switches by resampling (`resize_history`), matching
the reference's behavior where full-size history textures persist across rect
changes.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

BUCKETS = (1.0, 0.875, 0.75, 0.625, 0.5)


def render_size(width: int, height: int, scale: float) -> tuple[int, int]:
    """Bucket render size: multiples of 8, >= 16."""
    w = max(int(round(width * scale / 8)) * 8, 16)
    h = max(int(round(height * scale / 8)) * 8, 16)
    return w, h


def bucket_cfg(cfg, scale: float):
    """RenderConfig specialized to a bucket; display size pinned to the
    original raster so the post chain upscales back to it."""
    w, h = render_size(cfg.width, cfg.height, scale)
    return dataclasses.replace(
        cfg, width=w, height=h,
        output_width=cfg.output_width or cfg.width,
        output_height=cfg.output_height or cfg.height,
        enable_post=True,
    )


class DrsController:
    """Host-side feedback loop (the adjustment role of NRDSample.cpp:2104-2119):
    EMA of frame ms vs a target; step DOWN a bucket when over budget, step UP
    when there is enough headroom that the larger bucket should still fit
    (cost scales ~ with pixel count)."""

    def __init__(self, target_ms: float, buckets=BUCKETS, alpha: float = 0.25,
                 start_index: int = 0):
        self.target_ms = float(target_ms)
        self.buckets = tuple(buckets)
        self.alpha = float(alpha)
        self.index = int(start_index)
        self.ema_ms = None
        self._cooldown = 0

    @property
    def scale(self) -> float:
        return self.buckets[self.index]

    def update(self, frame_ms: float) -> float:
        """Feed one frame's wall time; returns the scale for the NEXT frame."""
        self.ema_ms = (frame_ms if self.ema_ms is None
                       else self.ema_ms + self.alpha * (frame_ms - self.ema_ms))
        if self._cooldown > 0:
            # a switch just happened: let the EMA re-settle at the new cost
            self._cooldown -= 1
            return self.scale
        if self.ema_ms > self.target_ms and self.index + 1 < len(self.buckets):
            self.index += 1
            self._cooldown = 3
            self.ema_ms = None
        elif self.index > 0:
            up = self.buckets[self.index - 1]
            predicted = self.ema_ms * (up / self.scale) ** 2
            if predicted < 0.9 * self.target_ms:
                self.index -= 1
                self._cooldown = 3
                self.ema_ms = None
        return self.scale


def _resize_plane(a, new_hw):
    if a.shape[:2] == tuple(new_hw):
        return a
    shape = tuple(new_hw) + a.shape[2:]
    if jnp.issubdtype(a.dtype, jnp.floating):
        return jax.image.resize(a, shape, method="linear")
    return jax.image.resize(a, shape, method="nearest")


def resize_history(history, old_cfg, new_cfg):
    """Resample all per-pixel history planes from old_cfg's raster to
    new_cfg's, preserving temporal accumulation across bucket switches.

    Leaves whose leading dims match (h, w) — or n_pixels flat, or the
    confidence grid's downscaled raster — are resized; everything else (SHARC
    hash table, frame counter) passes through unchanged."""
    oh, ow = old_cfg.height, old_cfg.width
    nh, nw = new_cfg.height, new_cfg.width
    if (oh, ow) == (nh, nw):
        return history
    ds = old_cfg.sharc_downscale
    shapes = {
        (oh, ow): (nh, nw),
        (max(oh // ds, 1), max(ow // ds, 1)):
            (max(nh // ds, 1), max(nw // ds, 1)),
    }

    def leaf(a):
        if not hasattr(a, "shape"):
            return a
        if a.ndim >= 2 and a.shape[:2] in shapes:
            return _resize_plane(a, shapes[a.shape[:2]])
        if a.ndim >= 1 and a.shape[0] == oh * ow:
            img = a.reshape((oh, ow) + a.shape[1:])
            return _resize_plane(img, (nh, nw)).reshape((nh * nw,) + a.shape[1:])
        return a

    return jax.tree_util.tree_map(leaf, history)
