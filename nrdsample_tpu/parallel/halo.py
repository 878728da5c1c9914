"""Halo exchange for row-sharded image stencils — the SP/CP analogue
(SURVEY.md §2.4(d), §5.7): each denoiser stencil needs <= blur-radius ghost rows
from neighbor shards.

Two realizations:
  1. implicit: keep arrays sharded over rows and let GSPMD insert the halo
     collectives around stencil ops (works when stencils are convs/shifts with
     sharding constraints) — the default inside jit;
  2. explicit (this module): inside shard_map, `exchange_rows` ppermutes the
     boundary rows between devices and returns a locally-padded block, so stencil code
     written against local arrays is exact at shard edges.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def exchange_rows(x: jnp.ndarray, radius: int, axis_name: str) -> jnp.ndarray:
    """Pad a row-sharded local block [h_local, W, ...] with `radius` rows from
    the up/down neighbor shards via ppermute; outermost shards get clamped-edge
    padding. Returns [h_local + 2*radius, W, ...]."""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)

    top_rows = x[:radius]      # rows this shard sends UP (they are the
    bot_rows = x[-radius:]     # neighbor-below's halo), and vice versa

    # neighbor below (idx+1) receives our bottom rows as its top halo
    down = [(i, (i + 1) % n) for i in range(n)]
    up = [(i, (i - 1) % n) for i in range(n)]
    from_above = jax.lax.ppermute(bot_rows, axis_name, down)  # rows of idx-1
    from_below = jax.lax.ppermute(top_rows, axis_name, up)    # rows of idx+1

    # clamp at the image border: outermost shards replicate their own edge
    edge_top = jnp.repeat(x[:1], radius, axis=0)
    edge_bot = jnp.repeat(x[-1:], radius, axis=0)
    from_above = jnp.where((idx == 0), edge_top, from_above)
    from_below = jnp.where((idx == n - 1), edge_bot, from_below)

    return jnp.concatenate([from_above, x, from_below], axis=0)


def crop_rows(x: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Undo exchange_rows padding after the stencil ran."""
    return x[radius:-radius] if radius else x


def stencil_with_halo(fn, radius: int, axis_name: str):
    """Wrap a stencil fn(local_img)->local_img so it sees exact neighbor rows:
    pad -> fn -> crop. fn must be shift-invariant and not change H."""

    def wrapped(x, *args, **kwargs):
        xp = exchange_rows(x, radius, axis_name)
        yp = fn(xp, *args, **kwargs)
        return crop_rows(yp, radius)

    return wrapped
