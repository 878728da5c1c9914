"""Clustered traversal — BVH-ordered triangle clusters (SURVEY.md §7.3 hard
part #1).

Design here:
  * Triangles are reordered by a binned-SAH BVH build (spatial coherence), then
    chopped into fixed CLUSTER_SIZE blocks with AABBs ("clusters"). No tree.
  * Stage 1 (dense): every ray slab-tests every cluster -> (R, C) entry
    distances. Elementwise math, zero divergence, one memory stream.
  * Stage 2 (bounded scan): per ray, clusters are visited nearest-first
    (argsort of entry distance); a batch-wide `while_loop` tests one
    CLUSTER_SIZE-triangle block per ray per step and terminates when every
    ray's next cluster is farther than its closest hit.

This is the reference's TLAS->BLAS split re-shaped: stage 1 is the "TLAS" in
dense form, stage 2 the "BLAS" leaf test (CastRay,
RaytracingShared.hlsli:314-421). `closest_hit_clustered` is the plain XLA
path (CPU, and the oracle of the packet kernel in ops/packet.py, which walks
the same clusters one 128-ray packet per program on the GPU). For
Bistro-scale C (> ~2k clusters) stage 1 is chunked over rays to bound the
matrix.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from nrdsample_tpu.ops import intersect

CLUSTER_SIZE = 128  # triangles per cluster (worklist granularity)
N_PLANES = 9        # component planes per cluster: p0xyz e1xyz e2xyz
SUPER_SIZE = 8      # clusters per supercluster (stage-1 hierarchy level)
T_MAX = intersect.T_MAX


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ClusterSet:
    bounds_min: jnp.ndarray   # (C, 3)
    bounds_max: jnp.ndarray   # (C, 3)
    # cluster-major triangle blocks: one contiguous CLUSTER_SIZE-triangle
    # block per cluster, so the scan's per-ray gather moves whole rows
    p0_b: jnp.ndarray         # (C, CLUSTER_SIZE, 3)
    e1_b: jnp.ndarray         # (C, CLUSTER_SIZE, 3)
    e2_b: jnp.ndarray         # (C, CLUSTER_SIZE, 3)
    # packet-kernel table: (C * N_PLANES, CLUSTER_SIZE) f32 — per cluster the
    # component planes p0x p0y p0z e1x e1y e1z e2x e2y e2z as consecutive
    # rows, so one row offset locates a whole cluster
    planes: jnp.ndarray
    # supercluster AABBs over SUPER_SIZE consecutive (BVH-ordered) clusters:
    # the stage-1 hierarchy level — per-ray entry tests run on these (8x fewer)
    super_min: jnp.ndarray    # (ceil(C/SUPER_SIZE), 3)
    super_max: jnp.ndarray

    @property
    def count(self) -> int:
        return self.bounds_min.shape[0]


def build_clusters(tris):
    """Reorder a TriangleSoA by BVH build order, pad to a CLUSTER_SIZE multiple
    with degenerate triangles, and compute per-block AABBs.

    Returns (ClusterSet, padded_reordered_tris, order) where order[new] = old
    (the un-padded permutation).
    """
    from nrdsample_tpu.scene.bvh import _build_binary
    from nrdsample_tpu.scene.types import TriangleSoA

    p0 = np.asarray(tris.p0)
    e1 = np.asarray(tris.e1)
    e2 = np.asarray(tris.e2)
    p1 = p0 + e1
    p2 = p0 + e2
    tmin = np.minimum(np.minimum(p0, p1), p2)
    tmax = np.maximum(np.maximum(p0, p1), p2)
    # build the binary BVH purely for its space-filling triangle order —
    # native binned-SAH builder first (~50x on Bistro-class counts; the 1M-tri
    # exterior's order build drops from ~50 s to ~1 s), numpy fallback when
    # the toolchain is unavailable
    from nrdsample_tpu import native

    built = native.build_order(tmin, tmax, leaf_size=8)
    if built is not None:
        order = built[0]
    else:
        _, order = _build_binary(tmin, tmax, leaf_size=8)

    t = len(p0)
    pad = (-t) % CLUSTER_SIZE

    def reorder_pad(a):
        a = np.asarray(a)[order]
        if pad:
            padding = np.zeros((pad,) + a.shape[1:], a.dtype)
            a = np.concatenate([a, padding], axis=0)
        return a

    tris_np = {
        f.name: reorder_pad(getattr(tris, f.name))
        for f in dataclasses.fields(tris)
    }
    # the whole build stays numpy: one host->device upload per array
    tris_p = TriangleSoA(**{k: jnp.asarray(v) for k, v in tris_np.items()})

    tmin_o = tmin[order]
    tmax_o = tmax[order]
    if pad:
        # padded triangles get empty boxes that never intersect
        tmin_o = np.concatenate([tmin_o, np.full((pad, 3), np.inf, np.float32)])
        tmax_o = np.concatenate([tmax_o, np.full((pad, 3), -np.inf, np.float32)])
    c = (t + pad) // CLUSTER_SIZE
    cmin = tmin_o.reshape(c, CLUSTER_SIZE, 3).min(axis=1)
    cmax = tmax_o.reshape(c, CLUSTER_SIZE, 3).max(axis=1)
    p0_b = tris_np["p0"].reshape(c, CLUSTER_SIZE, 3)
    e1_b = tris_np["e1"].reshape(c, CLUSTER_SIZE, 3)
    e2_b = tris_np["e2"].reshape(c, CLUSTER_SIZE, 3)
    spad = (-c) % SUPER_SIZE
    cmin_p = np.concatenate([cmin, np.full((spad, 3), np.inf, np.float32)]) \
        if spad else cmin
    cmax_p = np.concatenate([cmax, np.full((spad, 3), -np.inf, np.float32)]) \
        if spad else cmax
    cs_n = (c + spad) // SUPER_SIZE
    super_min = cmin_p.reshape(cs_n, SUPER_SIZE, 3).min(axis=1)
    super_max = cmax_p.reshape(cs_n, SUPER_SIZE, 3).max(axis=1)

    cs = ClusterSet(
        jnp.asarray(cmin), jnp.asarray(cmax),
        p0_b=jnp.asarray(p0_b),
        e1_b=jnp.asarray(e1_b),
        e2_b=jnp.asarray(e2_b),
        planes=jnp.asarray(component_planes(p0_b, e1_b, e2_b, np)),
        super_min=jnp.asarray(super_min),
        super_max=jnp.asarray(super_max),
    )
    return cs, tris_p, order


def component_planes(p0_b, e1_b, e2_b, xp=jnp):
    """(C, K, 3) x 3 cluster blocks -> the (C * N_PLANES, K) plane table of
    the packet kernel (numpy at build time, jnp under refit)."""
    c, k, _ = p0_b.shape
    planes = xp.stack(
        [a[..., j] for a in (p0_b, e1_b, e2_b) for j in range(3)], axis=1
    )                                                   # (C, 9, K)
    return planes.reshape(c * N_PLANES, k)


def _cluster_entry(o, d, cs, t_max):
    """Dense stage 1: (R, C) cluster entry distances; INF where missed.

    `cs` may be a ClusterSet or any (bounds_min, bounds_max) pair of (C, 3)
    arrays (the supercluster level passes its own AABBs).

    Component-split: every op is an (R, C) elementwise op, no trailing
    3-axis."""
    if isinstance(cs, tuple):
        bounds_min, bounds_max = cs
    else:
        bounds_min, bounds_max = cs.bounds_min, cs.bounds_max
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, jnp.where(d >= 0, 1e-12, -1e-12), d)
    tmin = None
    tmax_ = None
    for k in range(3):
        bmin = bounds_min[None, :, k]
        bmax = bounds_max[None, :, k]
        ok = o[:, None, k]
        ik = inv_d[:, None, k]
        t0 = (bmin - ok) * ik
        t1 = (bmax - ok) * ik
        lo = jnp.minimum(t0, t1)
        hi = jnp.maximum(t0, t1)
        tmin = lo if tmin is None else jnp.maximum(tmin, lo)
        tmax_ = hi if tmax_ is None else jnp.minimum(tmax_, hi)
    tnear = jnp.maximum(tmin, 0.0)
    hit = (tnear <= tmax_) & (tnear < t_max[:, None])
    return jnp.where(hit, tnear, T_MAX)


K_PREFIX = 4  # clusters tested unconditionally (covers the typical ray; the
              # batch-wide while_loop only runs for the divergent tail)


def _scan_clusters(o, d, entry, order, n_hit, cs: "ClusterSet", t_max, any_hit: bool):
    """Stage 2: nearest-first scan. A static K_PREFIX-unrolled dense phase
    handles the common case; a batch-wide while_loop finishes the tail.

    Layout note: the per-step lookups are transposed to (C, R) so each loop
    iteration reads contiguous rows instead of a stride-C column."""
    r = o.shape[0]
    c = entry.shape[1]

    # (C, R): cluster id visited at step i per ray, and its (sorted) entry key
    order_t = order.T
    entry_sorted_t = jnp.take_along_axis(entry, order, axis=1).T

    init = {
        "i": jnp.int32(0),
        "t": t_max.astype(jnp.float32),
        "u": jnp.zeros((r,), jnp.float32),
        "v": jnp.zeros((r,), jnp.float32),
        "tri": jnp.full((r,), -1, jnp.int32),
        "blocked": jnp.zeros((r,), bool),
    }

    def ray_done(s, i):
        past_end = i >= n_hit
        next_key = entry_sorted_t[jnp.minimum(i, c - 1)]
        # entry keys along `order` are sorted ascending per ray
        pruned = next_key >= s["t"]
        if_any = s["blocked"] if any_hit else jnp.zeros((r,), bool)
        return past_end | pruned | if_any

    def step(s, i):
        cid = order_t[jnp.minimum(i, c - 1)]
        active = jnp.logical_not(ray_done(s, i))
        # one contiguous 64-triangle block per ray (cluster-major layout)
        tp0 = cs.p0_b[cid]
        te1 = cs.e1_b[cid]
        te2 = cs.e2_b[cid]
        t, u, v, hit = intersect._mt_intersect(
            o[:, None, :], d[:, None, :], tp0, te1, te2
        )
        hit = hit & active[:, None] & (t < s["t"][:, None])
        t = jnp.where(hit, t, T_MAX)
        arg = jnp.argmin(t, axis=-1)
        tmin = jnp.take_along_axis(t, arg[:, None], axis=-1)[:, 0]
        closer = tmin < s["t"]
        tri_hit = cid * CLUSTER_SIZE + arg.astype(jnp.int32)
        return {
            "i": i + 1,
            "t": jnp.where(closer, tmin, s["t"]),
            "u": jnp.where(closer, jnp.take_along_axis(u, arg[:, None], -1)[:, 0], s["u"]),
            "v": jnp.where(closer, jnp.take_along_axis(v, arg[:, None], -1)[:, 0], s["v"]),
            "tri": jnp.where(closer, tri_hit, s["tri"]),
            "blocked": s["blocked"] | jnp.any(hit, axis=-1),
        }

    s = init
    for i in range(min(K_PREFIX, c)):
        s = step(s, jnp.int32(i))

    def cond(s):
        return (s["i"] < c) & jnp.logical_not(jnp.all(ray_done(s, s["i"])))

    def body(s):
        return step(s, s["i"])

    s["i"] = jnp.int32(min(K_PREFIX, c))
    out = jax.lax.while_loop(cond, body, s)
    return out


def closest_hit_clustered(cs: ClusterSet, tris, origin, direction, t_max=T_MAX,
                          ray_chunk: int = 1 << 16):
    """Closest-hit for (R, 3) rays. Chunked over rays to bound the (R, C)
    matrix + argsort footprint."""
    r = origin.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,))

    def run(o, d, tm):
        entry = _cluster_entry(o, d, cs, tm)
        order = jnp.argsort(entry, axis=1).astype(jnp.int32)
        entry_sorted_key = entry  # looked up through `order` inside the scan
        n_hit = jnp.sum(entry < T_MAX, axis=1).astype(jnp.int32)
        s = _scan_clusters(o, d, entry_sorted_key, order, n_hit, cs, tm, False)
        return {"t": s["t"], "u": s["u"], "v": s["v"], "tri": s["tri"]}

    if r <= ray_chunk:
        return run(origin, direction, t_max)
    pad = (-r) % ray_chunk
    o = jnp.concatenate([origin, jnp.zeros((pad, 3), origin.dtype)], axis=0)
    d = jnp.concatenate([direction, jnp.ones((pad, 3), direction.dtype)], axis=0)
    tm = jnp.concatenate([t_max, jnp.zeros((pad,), t_max.dtype)], axis=0)
    n = (r + pad) // ray_chunk
    res = jax.lax.map(
        lambda args: run(*args),
        (o.reshape(n, ray_chunk, 3), d.reshape(n, ray_chunk, 3), tm.reshape(n, ray_chunk)),
    )
    return {k: v.reshape(-1)[:r] for k, v in res.items()}


def any_hit_clustered(cs: ClusterSet, tris, origin, direction, t_max,
                      ray_chunk: int = 1 << 16):
    r = origin.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,))

    def run(o, d, tm):
        entry = _cluster_entry(o, d, cs, tm)
        order = jnp.argsort(entry, axis=1).astype(jnp.int32)
        n_hit = jnp.sum(entry < T_MAX, axis=1).astype(jnp.int32)
        s = _scan_clusters(o, d, entry, order, n_hit, cs, tm, True)
        # any_hit semantics: blocked only counts hits strictly inside t_max
        return s["blocked"] & (s["t"] < tm)

    if r <= ray_chunk:
        return run(origin, direction, t_max)
    pad = (-r) % ray_chunk
    o = jnp.concatenate([origin, jnp.zeros((pad, 3), origin.dtype)], axis=0)
    d = jnp.concatenate([direction, jnp.ones((pad, 3), direction.dtype)], axis=0)
    tm = jnp.concatenate([t_max, jnp.zeros((pad,), t_max.dtype)], axis=0)
    n = (r + pad) // ray_chunk
    res = jax.lax.map(
        lambda args: run(*args),
        (o.reshape(n, ray_chunk, 3), d.reshape(n, ray_chunk, 3), tm.reshape(n, ray_chunk)),
    )
    return res.reshape(-1)[:r]
