"""BVH8 traversal — the TraceRayInline replacement (SURVEY.md §7.3 hard part #1).

Design: breadth-vectorized 8-wide traversal. Each ray runs a `lax.while_loop`
with a short stack; per step it pops one node and slab-tests all 8 children at
once (vectorizing over children in-lane and over the ray batch via `vmap`), then
tests up to WIDTH leaf ranges of LEAF_SIZE triangles. Children are pushed
far-to-near so the nearest is popped first, enabling t-based culling.

For scenes below `DENSE_CUTOFF` triangles the dense intersector is used (zero
divergence, one fused elementwise pass), so `trace` dispatches on static
triangle count.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from nrdsample_tpu.ops import intersect
from nrdsample_tpu.scene.bvh import BVH8, LEAF_SIZE, decode_leaf

T_MAX = intersect.T_MAX
DENSE_CUTOFF = 1024     # tris; at or below this, brute force (no clusters)
STACK_DEPTH = 64


def _slab_test(o, inv_d, t_best, cmin, cmax):
    """Ray vs 8 AABBs: o/inv_d (3,), cmin/cmax (8, 3) -> (tnear (8,), hit (8,))."""
    t0 = (cmin - o) * inv_d
    t1 = (cmax - o) * inv_d
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    tnear = jnp.maximum(jnp.max(tmin, axis=-1), 0.0)
    tfar = jnp.min(tmax, axis=-1)
    hit = (tnear <= tfar) & (tnear < t_best)
    return tnear, hit


def _traverse_one(o, d, bvh: BVH8, tri_p0, tri_e1, tri_e2, t_max):
    """Closest-hit traversal for a single ray (vmapped over the batch)."""
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, jnp.where(d >= 0, 1e-12, -1e-12), d)

    stack = jnp.zeros((STACK_DEPTH,), jnp.int32)
    sp = jnp.int32(1)  # root pushed
    best = (jnp.asarray(t_max, jnp.float32), jnp.float32(0), jnp.float32(0), jnp.int32(-1))

    def cond(state):
        sp, _, _ = state
        return sp > 0

    def body(state):
        sp, stack, best = state
        node = stack[sp - 1]
        sp = sp - 1
        t_best = best[0]

        cmin = bvh.child_min[node]     # (8, 3)
        cmax = bvh.child_max[node]
        meta = bvh.child_meta[node]    # (8,)
        tnear, boxhit = _slab_test(o, inv_d, t_best, cmin, cmax)
        boxhit = boxhit & (meta != -1)

        is_leaf = meta <= -2
        # --- leaf triangles: gather up to 8 leaves * LEAF_SIZE tris, test all ---
        lstart, lcount = decode_leaf(meta)
        leafhit = boxhit & is_leaf
        # (8, LEAF_SIZE) triangle ids; invalid -> 0 with mask
        offs = jnp.arange(LEAF_SIZE, dtype=jnp.int32)
        tri_ids = lstart[:, None] + offs[None, :]
        valid = leafhit[:, None] & (offs[None, :] < lcount[:, None])
        tri_ids = jnp.where(valid, tri_ids, 0)
        tp0 = tri_p0[tri_ids]  # (8, LEAF_SIZE, 3)
        te1 = tri_e1[tri_ids]
        te2 = tri_e2[tri_ids]
        t, u, v, hit = intersect._mt_intersect(
            o[None, None, :], d[None, None, :], tp0, te1, te2
        )
        hit = hit & valid & (t < t_best)
        t = jnp.where(hit, t, T_MAX)
        flat = jnp.argmin(t.ravel())
        tmin = t.ravel()[flat]
        closer = tmin < t_best
        best = (
            jnp.where(closer, tmin, best[0]),
            jnp.where(closer, u.ravel()[flat], best[1]),
            jnp.where(closer, v.ravel()[flat], best[2]),
            jnp.where(closer, tri_ids.ravel()[flat], best[3]),
        )

        # --- push internal children, far first ---
        push = boxhit & (meta >= 0)
        # sort by tnear descending so nearest ends on top of the stack
        order = jnp.argsort(-tnear)
        meta_s = meta[order]
        push_s = push[order]
        cnt = jnp.cumsum(push_s.astype(jnp.int32)) - push_s.astype(jnp.int32)
        pos = jnp.where(push_s, sp + cnt, STACK_DEPTH - 1)
        pos = jnp.minimum(pos, STACK_DEPTH - 1)
        stack = stack.at[pos].set(jnp.where(push_s, meta_s, stack[pos]))
        sp = jnp.minimum(sp + jnp.sum(push_s.astype(jnp.int32)), STACK_DEPTH - 1)
        return sp, stack, best

    _, _, best = jax.lax.while_loop(cond, body, (sp, stack, best))
    t, u, v, tri = best
    return {"t": t, "u": u, "v": v, "tri": tri}


def traverse_bvh8(origin, direction, bvh: BVH8, tri_p0, tri_e1, tri_e2, t_max=T_MAX):
    """Batched closest-hit: origin/direction (R, 3) -> dict of (R,) results."""
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), origin.shape[:1])
    return jax.vmap(
        lambda o, d, tm: _traverse_one(o, d, bvh, tri_p0, tri_e1, tri_e2, tm)
    )(origin, direction, t_max)


def _occluded_one(o, d, bvh: BVH8, tri_p0, tri_e1, tri_e2, t_max):
    """Any-hit traversal for one ray: early-exits when any hit < t_max is found."""
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, jnp.where(d >= 0, 1e-12, -1e-12), d)
    stack = jnp.zeros((STACK_DEPTH,), jnp.int32)

    def cond(state):
        sp, _, blocked = state
        return (sp > 0) & jnp.logical_not(blocked)

    def body(state):
        sp, stack, blocked = state
        node = stack[sp - 1]
        sp = sp - 1
        cmin = bvh.child_min[node]
        cmax = bvh.child_max[node]
        meta = bvh.child_meta[node]
        tnear, boxhit = _slab_test(o, inv_d, t_max, cmin, cmax)
        boxhit = boxhit & (meta != -1)

        is_leaf = meta <= -2
        lstart, lcount = decode_leaf(meta)
        leafhit = boxhit & is_leaf
        offs = jnp.arange(LEAF_SIZE, dtype=jnp.int32)
        tri_ids = lstart[:, None] + offs[None, :]
        valid = leafhit[:, None] & (offs[None, :] < lcount[:, None])
        tri_ids = jnp.where(valid, tri_ids, 0)
        t, _, _, hit = intersect._mt_intersect(
            o[None, None, :], d[None, None, :],
            tri_p0[tri_ids], tri_e1[tri_ids], tri_e2[tri_ids],
        )
        blocked = blocked | jnp.any(hit & valid & (t < t_max))

        push = boxhit & (meta >= 0)
        cnt = jnp.cumsum(push.astype(jnp.int32)) - push.astype(jnp.int32)
        pos = jnp.where(push, sp + cnt, STACK_DEPTH - 1)
        pos = jnp.minimum(pos, STACK_DEPTH - 1)
        stack = stack.at[pos].set(jnp.where(push, meta, stack[pos]))
        sp = jnp.minimum(sp + jnp.sum(push.astype(jnp.int32)), STACK_DEPTH - 1)
        return sp, stack, blocked

    _, _, blocked = jax.lax.while_loop(
        cond, body, (jnp.int32(1), stack, jnp.bool_(False))
    )
    return blocked


def occluded_bvh8(origin, direction, bvh: BVH8, tri_p0, tri_e1, tri_e2, t_max):
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), origin.shape[:1])
    return jax.vmap(
        lambda o, d, tm: _occluded_one(o, d, bvh, tri_p0, tri_e1, tri_e2, tm)
    )(origin, direction, t_max)


# ---------------------------------------------------------------------------
# Unified tracing entry points (dense vs BVH dispatch on static scene size)
# ---------------------------------------------------------------------------

class TraceContext:
    """Static wrapper bundling the acceleration data for a scene.

    Built once per scene (host). `mode` selects the traversal strategy:
      "dense"   — brute-force tiled intersection (small scenes; speed of light)
      "cluster" — cluster culling + nearest-first walk (default for big
                  scenes: the packet kernel on the GPU, the XLA scan of
                  ops/cluster.py on the CPU)
      "bvh8"    — stack-based wide-BVH traversal (reference implementation,
                  CPU-friendly, used to cross-validate)
    The reference analogue is the TLAS pair + instance buffers bound in
    SET_RAY_TRACING (RaytracingShared.hlsli:3-16).
    """

    def __init__(self, tris, mode: str, bvh=None, clusters=None, tri_offset: int = 0):
        self.tris = tris
        self.mode = mode
        self.bvh = bvh
        self.clusters = clusters
        # offset of this context's triangle range inside the merged scene array
        # (two-TLAS analogue: opaque range + transparent range, NRDSample.cpp
        # GEOMETRY masks; hit indices are returned in GLOBAL scene coordinates)
        self.tri_offset = tri_offset

    @property
    def use_dense(self) -> bool:
        return self.mode == "dense"


def build_context(scene, mode: str | None = None):
    """Build acceleration data for `scene` (a Scene pytree or bare TriangleSoA).

    Returns (TraceContext, scene') — scene' has its triangles REORDERED (and,
    for cluster mode, padded) so hit indices from traversal decode against the
    same arrays; the emissive IS list is remapped through the permutation.
    Always use the returned scene with this context.
    """
    import numpy as np

    from nrdsample_tpu.scene.bvh import build_bvh8, reorder_tris
    from nrdsample_tpu.scene.types import Scene

    bare = not isinstance(scene, Scene)
    tris = scene if bare else scene.tris
    n = tris.count
    if mode is None:
        mode = "dense" if n <= DENSE_CUTOFF else "cluster"

    from nrdsample_tpu.scene.types import scene_to_device
    import jax as _jax

    if mode == "dense":
        if bare:
            tris_dev = _jax.tree_util.tree_map(jnp.asarray, tris)
            ctx = TraceContext(tris_dev, "dense")
            ctx.order = None
            return ctx, tris_dev
        scene_dev = scene_to_device(scene)
        ctx = TraceContext(scene_dev.tris, "dense")
        ctx.order = None
        return ctx, scene_dev

    if mode == "cluster":
        from nrdsample_tpu.ops.cluster import build_clusters

        cs, tris_p, order = build_clusters(tris)
        ctx = TraceContext(tris_p, "cluster", clusters=cs)
        new_tris = tris_p
    elif mode == "bvh8":
        bvh, order = build_bvh8(
            np.asarray(tris.p0), np.asarray(tris.e1), np.asarray(tris.e2)
        )
        new_tris = reorder_tris(tris, order)
        ctx = TraceContext(new_tris, "bvh8", bvh=bvh)
    else:
        raise ValueError(f"unknown traversal mode {mode!r}")
    ctx.order = order

    new_tris = _jax.tree_util.tree_map(jnp.asarray, new_tris)
    ctx.tris = new_tris

    if bare:
        return ctx, new_tris

    # remap emissive triangle indices old->new through the permutation
    import dataclasses as dc

    inv = np.empty(len(order), np.int32)
    inv[np.asarray(order)] = np.arange(len(order), dtype=np.int32)
    em = np.asarray(scene.emissive_tris)
    em_new = np.where(em >= 0, inv[np.clip(em, 0, len(order) - 1)], -1).astype(np.int32)
    # big emitter sets get their own packet ClusterSet (merged-emissive BLAS
    # analogue) — built from the HOST numpy scene (no device readbacks)
    from nrdsample_tpu.render import emissive_is as _em

    ctx.emissive = _em.build_emissive_clusters(scene)
    new_scene = scene_to_device(
        dc.replace(scene, tris=new_tris, emissive_tris=em_new)
    )
    return ctx, new_scene


def _use_packet(ctx) -> bool:
    from nrdsample_tpu.platform import use_gpu_kernels

    return ctx.mode == "cluster" and use_gpu_kernels()


@jax.named_scope("traversal")
def closest_hit(ctx: TraceContext, origin, direction, t_max=T_MAX,
                coherent: bool = True):
    """Closest-hit dispatch. Hit results are detached (non-differentiable
    decisions, SURVEY.md §7.1); shading recomputes continuous quantities.
    Returned tri indices are in global scene coordinates (ctx.tri_offset).

    coherent=False (divergent bounce/shadow wavefronts) enables morton ray
    re-binning on the packet path."""
    tr = ctx.tris
    o = jax.lax.stop_gradient(origin)
    d = jax.lax.stop_gradient(direction)
    if ctx.mode == "dense":
        res = intersect.intersect_dense(o, d, tr.p0, tr.e1, tr.e2, t_max=t_max)
    elif ctx.mode == "cluster":
        if _use_packet(ctx):
            from nrdsample_tpu.ops.packet import closest_hit_packet

            res = closest_hit_packet(
                ctx.clusters, o, d, t_max=t_max, sort=not coherent,
            )
        else:
            from nrdsample_tpu.ops.cluster import closest_hit_clustered

            res = closest_hit_clustered(ctx.clusters, tr, o, d, t_max=t_max)
    else:
        res = traverse_bvh8(o, d, ctx.bvh, tr.p0, tr.e1, tr.e2, t_max=t_max)
    if ctx.tri_offset:
        res = dict(res, tri=jnp.where(res["tri"] >= 0, res["tri"] + ctx.tri_offset, -1))
    return res


class SceneContexts:
    """Opaque + transparent trace contexts over one merged scene — the analogue
    of the reference's world TLAS with FLAG_NON_TRANSPARENT / FLAG_TRANSPARENT
    instance masks (Shared.hlsli:156-165, TraceTransparent.cs.hlsl:193-198)."""

    def __init__(self, opaque: TraceContext, transparent: TraceContext | None):
        self.opaque = opaque
        self.transparent = transparent


def build_scene_contexts(scene, mode: str | None = None):
    """Partition the scene into opaque/transparent ranges, build a context for
    each, and return (SceneContexts, merged scene) with remapped emissive ids."""
    import dataclasses as dc

    import numpy as np

    from nrdsample_tpu import config as cfgmod

    flags = np.asarray(scene.materials.flags)[np.asarray(scene.tris.material)]
    is_trans = (flags & cfgmod.FLAG_TRANSPARENT) != 0
    if not is_trans.any():
        ctx, scene2 = build_context(scene, mode)
        return SceneContexts(ctx, None), scene2

    order0 = np.concatenate([np.nonzero(~is_trans)[0], np.nonzero(is_trans)[0]])
    n_opaque = int((~is_trans).sum())

    def gather_tris(tris, ids):
        idx = ids.astype(np.int32)
        return jax.tree.map(lambda a: np.asarray(a)[idx], tris)

    tris_o = gather_tris(scene.tris, order0[:n_opaque])
    tris_t = gather_tris(scene.tris, order0[n_opaque:])

    ctx_o, tris_o2 = build_context(tris_o, mode)
    ctx_t, tris_t2 = build_context(tris_t, mode)
    offset = tris_o2.count
    ctx_t.tri_offset = offset

    merged = jax.tree.map(
        lambda a, b: jnp.concatenate([a, b], axis=0), tris_o2, tris_t2
    )

    # emissive remap: old scene index -> merged index. Each build_context may
    # have internally permuted its subset; recover by matching through both maps
    # (host-side, cheap).
    # Build the composed old->new map by replaying the permutations: both
    # build_context calls record their order on the context.
    old_to_new = np.full(scene.tris.count, -1, np.int64)
    o_order = getattr(ctx_o, "order", None)
    t_order = getattr(ctx_t, "order", None)
    ids_o = order0[:n_opaque]
    ids_t = order0[n_opaque:]
    if o_order is not None:
        ids_o = ids_o[o_order]
    if t_order is not None:
        ids_t = ids_t[t_order]
    old_to_new[ids_o] = np.arange(len(ids_o))
    old_to_new[ids_t] = offset + np.arange(len(ids_t))

    em = np.asarray(scene.emissive_tris)
    em_new = np.where(
        em >= 0, old_to_new[np.clip(em, 0, scene.tris.count - 1)], -1
    ).astype(np.int32)

    from nrdsample_tpu.scene.types import scene_to_device

    from nrdsample_tpu.render import emissive_is as _em

    ctx_o.emissive = _em.build_emissive_clusters(scene)
    scene2 = scene_to_device(
        dc.replace(scene, tris=merged, emissive_tris=em_new)
    )
    return SceneContexts(ctx_o, ctx_t), scene2


def closest_hit_alpha(ctx: TraceContext, scene, origin, direction,
                      t_max=T_MAX, rounds: int = 4, coherent: bool = True):
    """Closest hit with the any-hit alpha test — CheckNonOpaqueTriangle
    semantics (RaytracingShared.hlsli:191-247): hits on FLAG_ALPHA_TEST
    materials whose point-sampled alpha is below 0.5 are transparent and
    traversal continues behind them.

    Wavefront shape: instead of testing alpha inside the traversal inner loop
    (divergent, needs texture fetches mid-kernel), re-trace past rejected hits
    in up to `rounds` wavefront iterations. After round 1 only the rays that
    hit an alpha-tested surface stay active, so convergence is fast; scenes
    with no such materials (scene.has_alpha_test static False) skip all of it.
    """
    if not getattr(scene, "has_alpha_test", False) or scene.textures is None:
        return closest_hit(ctx, origin, direction, t_max, coherent=coherent)

    from nrdsample_tpu import config as cfg_mod
    from nrdsample_tpu.scene import textures as tex_mod

    tr = scene.tris
    t_max_arr = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), origin.shape[:1])
    res = closest_hit(ctx, origin, direction, t_max_arr, coherent=coherent)
    offset = jnp.zeros_like(res["t"])  # accumulated skip distance per ray

    for _ in range(rounds):
        tri = jnp.maximum(res["tri"], 0)
        mat = tr.material[tri]
        flags = scene.materials.flags[mat]
        needs_test = (res["tri"] >= 0) & ((flags & cfg_mod.FLAG_ALPHA_TEST) != 0)
        u, v = res["u"], res["v"]
        w = 1.0 - u - v
        uv = (
            w[..., None] * tr.uv0[tri]
            + u[..., None] * tr.uv1[tri]
            + v[..., None] * tr.uv2[tri]
        )
        alpha = tex_mod.sample_alpha(scene.textures, mat, uv)
        reject = needs_test & (alpha < 0.5)
        # advance rejected rays just past the rejected hit and re-trace; the
        # whole round is skipped at runtime once no ray needs it (lax.cond)
        new_offset = jnp.where(reject, offset + res["t"] + 1e-4, offset)

        def retrace(res, new_offset=new_offset, reject=reject):
            o2 = origin + direction * new_offset[..., None]
            res2 = closest_hit(ctx, o2, direction, t_max_arr - new_offset,
                               coherent=coherent)
            return {
                "t": jnp.where(reject, res2["t"], res["t"]),
                "u": jnp.where(reject, res2["u"], res["u"]),
                "v": jnp.where(reject, res2["v"], res["v"]),
                "tri": jnp.where(reject, res2["tri"], res["tri"]),
            }

        res = jax.lax.cond(
            jnp.any(reject), retrace, lambda r: dict(r), res
        )
        offset = new_offset

    # report t from the ORIGINAL origin
    res = dict(res, t=jnp.where(res["tri"] >= 0, res["t"] + offset, res["t"]))
    return res


def any_hit_t(ctx: TraceContext, origin, direction, t_max,
              coherent: bool = False):
    """Occlusion query that ALSO returns the closest-blocker distance.

    Returns (blocked [R] bool, t [R] f32; t is T_MAX where unblocked). The
    SIGMA penumbra estimate needs the shadow ray's hitT (the reference packs it
    in TraceOpaque.cs.hlsl:767-804) — and on the packet path this is free:
    any_hit_packet already runs the closest-hit kernel and discards t."""
    t_max_arr = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), origin.shape[:1])
    res = closest_hit(ctx, origin, direction, t_max_arr, coherent=coherent)
    blocked = (res["tri"] >= 0) & (res["t"] < t_max_arr)
    return blocked, jnp.where(blocked, res["t"], T_MAX)


@jax.named_scope("traversal")
def any_hit(ctx: TraceContext, origin, direction, t_max, coherent: bool = False):
    tr = ctx.tris
    o = jax.lax.stop_gradient(origin)
    d = jax.lax.stop_gradient(direction)
    if ctx.mode == "dense":
        return intersect.occluded_dense(o, d, tr.p0, tr.e1, tr.e2, t_max=t_max)
    if ctx.mode == "cluster":
        if _use_packet(ctx):
            from nrdsample_tpu.ops.packet import any_hit_packet

            return any_hit_packet(ctx.clusters, o, d, t_max, sort=not coherent)
        from nrdsample_tpu.ops.cluster import any_hit_clustered

        return any_hit_clustered(ctx.clusters, tr, o, d, t_max)
    return occluded_bvh8(o, d, ctx.bvh, tr.p0, tr.e1, tr.e2, t_max=t_max)
