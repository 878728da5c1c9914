"""Ray-triangle intersection: Möller–Trumbore, batched.

Two entry points:
  * `intersect_dense`  — every ray vs every triangle, tiled; the speed-of-light
    path for small/medium scenes (all work is dense VPU math, zero divergence).
  * `intersect_gathered` — every ray vs its own K gathered triangles (leaf tests
    inside BVH traversal).

Replaces the hardware rayQuery.Proceed() loop (RaytracingShared.hlsli:314-421).
Hit *selection* is discrete and therefore detached from autodiff; shading
recomputes differentiable quantities from the detached hit (SURVEY.md §7.1
"Differentiability").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

EPS = 1e-7
T_MAX = 1e5  # matches INF (Shared.hlsli:141)


def _mt_intersect(o, d, p0, e1, e2):
    """Möller–Trumbore core. All args broadcast to [..., 3].

    Returns (t, u, v, hit): hit requires t in (EPS_t, inf) and barycentrics valid.
    Backface hits are reported (two-sided, like the reference's opaque traversal
    which does not cull backfaces — RayFlags = PT_RAY_FLAGS = 0).

    LAYOUT: computed component-split (separate x/y/z planes), so every op is
    a 2D elementwise op with no reduction or broadcast over a trailing
    3-axis."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    p0x, p0y, p0z = p0[..., 0], p0[..., 1], p0[..., 2]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]

    # pvec = d x e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = jnp.where(jnp.abs(det) < EPS, 0.0, 1.0 / jnp.where(det == 0, 1.0, det))
    # tvec = o - p0
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    # qvec = tvec x e1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = (
        (jnp.abs(det) >= EPS)
        & (u >= -1e-6)
        & (v >= -1e-6)
        & (u + v <= 1.0 + 1e-6)
        & (t > 1e-5)
    )
    return t, u, v, hit


# live-memory budget for one (R_chunk, tile) intersection plane: frame-sized
# launches (4M+ rays at 1080p with batched shadows) would otherwise
# materialize an R x tile fusion output of tens of GB -> device OOM
_DENSE_BYTES_BUDGET = 256 << 20


def intersect_dense(origin: jnp.ndarray, direction: jnp.ndarray,
                    p0: jnp.ndarray, e1: jnp.ndarray, e2: jnp.ndarray,
                    t_max=T_MAX, tile: int = 2048):
    """Closest-hit of R rays against T triangles, O(R*T) dense.

    origin/direction: (R, 3); p0/e1/e2: (T, 3).
    Returns dict(t, u, v, tri) with tri = -1 on miss. The triangle loop is a
    `lax.scan` over tiles of `tile` triangles so working sets stay bounded;
    rays chunk via lax.map when the per-tile
    plane would exceed the live-memory budget.
    """
    r = origin.shape[0]
    t_count = p0.shape[0]
    # right-size the tile: tiny scenes (CornellBox: 36 tris) must not pay a
    # 2048-wide padded Möller-Trumbore per ray
    tile = min(tile, max(-(-t_count // 128) * 128, 128))
    rc = max(128, _DENSE_BYTES_BUDGET // (tile * 4))
    if r * tile * 4 > _DENSE_BYTES_BUDGET and rc < r:
        rpad = (-r) % rc
        if rpad:
            padr = lambda a: jnp.concatenate(
                [a, jnp.broadcast_to(a[-1:], (rpad,) + a.shape[1:])], axis=0)
            origin, direction = padr(origin), padr(direction)
        tmf = jnp.broadcast_to(jnp.asarray(t_max, origin.dtype), (r,))
        tmp = jnp.concatenate([tmf, jnp.zeros((rpad,), origin.dtype)], axis=0)             if rpad else tmf
        nch = (r + rpad) // rc

        def one(args):
            o, d, tm = args
            return intersect_dense(o, d, p0, e1, e2, tm, tile)

        out = jax.lax.map(
            one,
            (origin.reshape(nch, rc, 3), direction.reshape(nch, rc, 3),
             tmp.reshape(nch, rc)),
        )
        return {k: v.reshape(-1)[:r] for k, v in out.items()}
    pad = (-t_count) % tile
    if pad:
        padz = lambda a: jnp.concatenate([a, jnp.zeros((pad, 3), a.dtype)], axis=0)
        p0, e1, e2 = padz(p0), padz(e1), padz(e2)
    n_tiles = (t_count + pad) // tile
    p0t = p0.reshape(n_tiles, tile, 3)
    e1t = e1.reshape(n_tiles, tile, 3)
    e2t = e2.reshape(n_tiles, tile, 3)

    t_max = jnp.broadcast_to(jnp.asarray(t_max, origin.dtype), (r,))
    init = (
        t_max,
        jnp.zeros((r,), origin.dtype),
        jnp.zeros((r,), origin.dtype),
        jnp.full((r,), -1, jnp.int32),
    )

    def body(carry, tile_data):
        best_t, best_u, best_v, best_i = carry
        tp0, te1, te2, base = tile_data
        t, u, v, hit = _mt_intersect(
            origin[:, None, :], direction[:, None, :],
            tp0[None, :, :], te1[None, :, :], te2[None, :, :],
        )  # (R, tile)
        t = jnp.where(hit, t, T_MAX)
        # padded triangles are degenerate (zero e1/e2) -> det≈0 -> miss
        arg = jnp.argmin(t, axis=-1)
        tmin = jnp.take_along_axis(t, arg[:, None], axis=-1)[:, 0]
        umin = jnp.take_along_axis(u, arg[:, None], axis=-1)[:, 0]
        vmin = jnp.take_along_axis(v, arg[:, None], axis=-1)[:, 0]
        closer = tmin < best_t
        best_u = jnp.where(closer, umin, best_u)
        best_v = jnp.where(closer, vmin, best_v)
        best_i = jnp.where(closer, base + arg.astype(jnp.int32), best_i)
        best_t = jnp.where(closer, tmin, best_t)
        return (best_t, best_u, best_v, best_i), None

    bases = jnp.arange(n_tiles, dtype=jnp.int32) * tile
    (bt, bu, bv, bi), _ = jax.lax.scan(body, init, (p0t, e1t, e2t, bases))
    return {"t": bt, "u": bu, "v": bv, "tri": bi}


def occluded_dense(origin: jnp.ndarray, direction: jnp.ndarray,
                   p0: jnp.ndarray, e1: jnp.ndarray, e2: jnp.ndarray,
                   t_max, tile: int = 2048) -> jnp.ndarray:
    """Any-hit visibility: True where the segment [0, t_max] is blocked.

    The CastVisibilityRay_AnyHit equivalent (RaytracingShared.hlsli:249-264).
    """
    r = origin.shape[0]
    t_count = p0.shape[0]
    tile = min(tile, max(-(-t_count // 128) * 128, 128))
    rc = max(128, _DENSE_BYTES_BUDGET // (tile * 4))
    if r * tile * 4 > _DENSE_BYTES_BUDGET and rc < r:
        rpad = (-r) % rc
        if rpad:
            padr = lambda a: jnp.concatenate(
                [a, jnp.broadcast_to(a[-1:], (rpad,) + a.shape[1:])], axis=0)
            origin, direction = padr(origin), padr(direction)
        tmf = jnp.broadcast_to(jnp.asarray(t_max), (r,))
        tmp = jnp.concatenate([tmf, jnp.zeros((rpad,))], axis=0) if rpad else tmf
        nch = (r + rpad) // rc

        def one(args):
            o, d, tm = args
            return occluded_dense(o, d, p0, e1, e2, tm, tile)

        out = jax.lax.map(
            one,
            (origin.reshape(nch, rc, 3), direction.reshape(nch, rc, 3),
             tmp.reshape(nch, rc)),
        )
        return out.reshape(-1)[:r]
    pad = (-t_count) % tile
    if pad:
        padz = lambda a: jnp.concatenate([a, jnp.zeros((pad, 3), a.dtype)], axis=0)
        p0, e1, e2 = padz(p0), padz(e1), padz(e2)
    n_tiles = (t_count + pad) // tile
    p0t = p0.reshape(n_tiles, tile, 3)
    e1t = e1.reshape(n_tiles, tile, 3)
    e2t = e2.reshape(n_tiles, tile, 3)
    t_max = jnp.broadcast_to(jnp.asarray(t_max), (r,))

    def body(blocked, tile_data):
        tp0, te1, te2 = tile_data
        t, _, _, hit = _mt_intersect(
            origin[:, None, :], direction[:, None, :],
            tp0[None, :, :], te1[None, :, :], te2[None, :, :],
        )
        any_hit = jnp.any(hit & (t < t_max[:, None]), axis=-1)
        return blocked | any_hit, None

    blocked, _ = jax.lax.scan(body, jnp.zeros((r,), bool), (p0t, e1t, e2t))
    return blocked


def intersect_gathered(o, d, p0, e1, e2):
    """Rays vs per-ray gathered triangles: o/d (..., 3), p0/e1/e2 (..., K, 3).

    Returns (t, u, v, hit) each (..., K)."""
    return _mt_intersect(o[..., None, :], d[..., None, :], p0, e1, e2)
