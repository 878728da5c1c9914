"""Packet traversal — the Pallas kernel for ray-cluster intersection.

This is the hot path of `TraceRayInline` (SURVEY.md §7.3 hard part #1): the
H100 has no RT cores, so every ray of every scene above
`traversal.DENSE_CUTOFF` triangles runs through this kernel. The plain XLA
alternative (`cluster.closest_hit_clustered`) argsorts an (R, C) entry
matrix per ray chunk and runs a batch-wide `while_loop` until the slowest
ray finishes; it stays as the test oracle and the CPU path.

Route: Pallas through Triton (`backend="triton"`), named explicitly.

Design (classic packet traversal):
  * rays are grouped into BLOCK_RAYS-sized packets (screen-coherent; divergent
    wavefronts are re-binned by direction octant + origin morton code first);
  * stage 1 (XLA, dense) computes each packet's shared cluster worklist:
    clusters any ray in the packet enters, sorted by packet-min entry distance;
  * the kernel runs ONE program per packet; programs run in parallel on the
    SMs, and each walks its own worklist in a `while_loop` until the next
    cluster's entry key lies beyond the packet's farthest current hit. The
    cluster id is packet-uniform, so each step loads the cluster's 9 component
    planes from global memory at a dynamic row offset — no per-ray gathers;
  * a cluster's CLUSTER_SIZE triangles are tested in TRI_TILE-wide sub-tiles
    so the ~15 live Möller-Trumbore planes of a (BLOCK_RAYS, TRI_TILE) tile
    stay in registers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from nrdsample_tpu.ops.cluster import (
    CLUSTER_SIZE, N_PLANES, ClusterSet, _cluster_entry,
)
from nrdsample_tpu.ops.intersect import EPS, T_MAX

BLOCK_RAYS = 128  # rays per packet (one program); tight worklists win
FLAT_WORKLIST_MAX_C = 2048  # above this, stage-1 switches to the
                            # supercluster hierarchy (tests patch this down)
# register tile and launch shape, chosen on an H100 over tile 8-64 x warps
# 2-8 (PERF.md): 32 triangles x 8 warps was fastest on coherent and sorted
# wavefronts of shaderballs512 and exterior720
TRI_TILE = 32     # triangles per register tile inside a cluster
NUM_WARPS = 8     # warps of one packet program


def _mt_block(ox, oy, oz, dx, dy, dz, p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z):
    """Möller-Trumbore on (B, 1) rays x (1, K) triangles -> (B, K) planes;
    the same arithmetic and epsilons as intersect._mt_intersect."""
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = jnp.where(jnp.abs(det) < EPS, 0.0, 1.0 / jnp.where(det == 0.0, 1.0, det))
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
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


def _merge_tile(t, u, v, base, best):
    """Fold a (B, K) t-plane (T_MAX on miss) into the per-ray best. Ties keep
    the lowest triangle index of the tile, like intersect_dense's argmin."""
    t_best, tri_best, u_best, v_best = best
    k = t.shape[1]
    idxs = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)
    tmin = jnp.min(t, axis=1)
    kmin = jnp.min(jnp.where(t <= tmin[:, None], idxs, k), axis=1)
    closer = tmin < t_best
    t_best = jnp.where(closer, tmin, t_best)
    tri_best = jnp.where(closer, base + kmin, tri_best)
    if u is not None:
        sel = idxs == kmin[:, None]
        u_best = jnp.where(closer, jnp.sum(jnp.where(sel, u, 0.0), axis=1), u_best)
        v_best = jnp.where(closer, jnp.sum(jnp.where(sel, v, 0.0), axis=1), v_best)
    return t_best, tri_best, u_best, v_best


def _packet_kernel(order_ref, keys_ref, rays_ref, planes_ref,
                   t_out, tri_out, u_out, v_out, *, any_hit: bool,
                   track_uv: bool, tile: int):
    """One program = one packet. rays_ref rows: ox oy oz dx dy dz t_max.

    No explicit worklist length: sorted keys are +inf (or T_MAX) past the end
    and t_best <= t_max, so the key test stops the walk there."""
    c = order_ref.shape[0]
    ray = [rays_ref[k, :][:, None] for k in range(6)]
    t0 = rays_ref[6, :]

    def cond(state):
        i, t_best = state[0], state[1]
        key = keys_ref[jnp.minimum(i, c - 1)]
        go = (i < c) & (key < jnp.max(t_best))
        if any_hit:
            # occlusion needs only *a* hit inside t_max for every ray
            open_rays = jnp.max(jnp.where((t_best >= t0) & (t0 > 0.0), 1, 0))
            go = go & (open_rays > 0)
        return go

    def body(state):
        i, best = state[0], state[1:]
        cid = order_ref[i]
        row = cid * N_PLANES
        for k0 in range(0, CLUSTER_SIZE, tile):
            tri = [planes_ref[row + p, pl.ds(k0, tile)][None, :]
                   for p in range(N_PLANES)]
            t, u, v, hit = _mt_block(*ray, *tri)
            t = jnp.where(hit, t, T_MAX)
            if not track_uv:
                u = v = None
            best = _merge_tile(t, u, v, cid * CLUSTER_SIZE + k0, best)
        return (i + 1,) + best

    zeros = jnp.zeros_like(t0)
    init = (jnp.int32(0), t0, jnp.full(t0.shape, -1, jnp.int32), zeros, zeros)
    _, t_best, tri_best, u_best, v_best = jax.lax.while_loop(cond, body, init)
    t_out[...] = t_best
    tri_out[...] = tri_best
    u_out[...] = u_best
    v_out[...] = v_best


_CID_BITS = 14  # cluster-id payload bits in the packed sort key (<= 16384 clusters)


def _sort_worklists(key, hit):
    """(order, keys_sorted, count) from per-block keys via ONE int32 sort.

    Packing the quantized key into the high bits of one int32 and the cluster
    id into the low 14 bits turns the f32-key + i32-payload co-sort and its
    gather into a single-operand sort. The reconstructed keys have their low
    mantissa bits zeroed — a conservative LOWER bound, so the kernel's
    sorted-key t-pruning stays correct (it may prune a hair later, never
    earlier)."""
    c = key.shape[1]
    if c >= (1 << _CID_BITS):
        order = jnp.argsort(key, axis=1).astype(jnp.int32)
        keys_sorted = jnp.take_along_axis(key, order, axis=1)
        return order, keys_sorted, jnp.sum(hit, axis=1).astype(jnp.int32)
    mask = jnp.int32((1 << _CID_BITS) - 1)
    # miss entries must stay ABOVE every quantized hit key after the low bits
    # are zeroed (else sky rays would walk the whole list): +inf's exponent
    # pattern survives the masking exactly, T_MAX would be rounded DOWN
    key = jnp.where(hit, jnp.maximum(key, 0.0), jnp.inf)
    # float bits are order-preserving for non-negative floats
    bits = jax.lax.bitcast_convert_type(key, jnp.int32)
    cid = jax.lax.broadcasted_iota(jnp.int32, key.shape, 1)
    packed = jnp.sort((bits & ~mask) | cid, axis=1)
    order = packed & mask
    keys_sorted = jax.lax.bitcast_convert_type(packed & ~mask, jnp.float32)
    return order, keys_sorted, jnp.sum(hit, axis=1).astype(jnp.int32)


# live-memory budget for the stage-1 exact entry matrix; beyond it the
# block-min is computed in lax.map chunks (XLA fuses the entry math into the
# reduction within a chunk, but at frame-sized R x C the single-shot fusion
# can materialize the full matrix -> device OOM at 1080p+)
_STAGE1_BYTES_BUDGET = 256 << 20


def _block_min_entry(origin, direction, cs, t_max, block: int):
    """min over each ray block of the exact per-ray entry distances:
    (R,3) x C boxes -> (nb, C), chunked to bound live memory."""
    r = origin.shape[0]
    bounds = cs if isinstance(cs, tuple) else (cs.bounds_min, cs.bounds_max)
    c = bounds[0].shape[0]
    nb = r // block
    if r * c * 4 <= _STAGE1_BYTES_BUDGET:
        entry = _cluster_entry(origin, direction, bounds, t_max)   # (R, C)
        return jnp.min(entry.reshape(nb, block, c), axis=1)
    o_b = origin.reshape(nb, block, 3)
    d_b = direction.reshape(nb, block, 3)
    tm_b = t_max.reshape(nb, block)
    chunk = max(1, _STAGE1_BYTES_BUDGET // (block * c * 4))

    def one(args):
        o, d, tm = args
        e = _cluster_entry(o, d, bounds, tm)                        # (block, C)
        return jnp.min(e, axis=0)

    return jax.lax.map(one, (o_b, d_b, tm_b), batch_size=min(chunk, nb))


def _block_worklists(origin, direction, cs: ClusterSet, t_max, block: int):
    """Stage 1 (flat): exact dense (R, C) entry matrix -> per-packet worklist.
    Best for small C; _block_worklists_super is the big-scene variant."""
    block_near = _block_min_entry(origin, direction, cs, t_max, block)  # (nb, C)
    hit = block_near < T_MAX
    key = jnp.where(hit, block_near, T_MAX)
    return _sort_worklists(key, hit)


def _block_worklists_super(origin, direction, cs: ClusterSet, t_max,
                           block: int):
    """Hierarchical stage 1 for big scenes: exact per-ray entry tests run on
    the SUPERCLUSTER level ((R, C/8) instead of (R, C)); cluster membership is
    refined with the cheap per-block interval test; the sort key per cluster
    is max(supercluster exact block key, cluster interval lower bound) — both
    conservative lower bounds, so kernel t-pruning stays correct."""
    from nrdsample_tpu.ops.cluster import SUPER_SIZE

    c = cs.count

    # exact per-ray supercluster entries, block-reduced (chunked: the full
    # (R, Cs) matrix at frame-sized R would exhaust memory, see _block_min_entry)
    block_near_s = _block_min_entry(
        origin, direction, (cs.super_min, cs.super_max), t_max, block
    )                                                                 # (nb, Cs)
    super_key = jnp.repeat(block_near_s, SUPER_SIZE, axis=1)[:, :c]   # (nb, C)

    # cluster-level interval refinement (per-block ray bounds)
    hit_i, lb_i = _block_worklists_interval_parts(
        origin, direction, cs, t_max, block
    )

    hit = (super_key < T_MAX) & hit_i
    key = jnp.where(hit, jnp.maximum(super_key, lb_i), T_MAX)
    return _sort_worklists(key, hit)


def _block_worklists_interval_parts(origin, direction, cs: ClusterSet, t_max,
                                    block: int):
    """Per-block interval-arithmetic cluster test; returns (hit (nb,C) bool,
    lower-bound keys (nb,C))."""
    r = origin.shape[0]
    c = cs.count
    nb = r // block

    ob = origin.reshape(nb, block, 3)
    db = direction.reshape(nb, block, 3)
    tmb = t_max.reshape(nb, block)
    o_lo = jnp.min(ob, axis=1)     # (nb, 3)
    o_hi = jnp.max(ob, axis=1)
    d_lo = jnp.min(db, axis=1)
    d_hi = jnp.max(db, axis=1)
    t_cap = jnp.max(tmb, axis=1)   # (nb,)

    tnear_lb = jnp.zeros((nb, c), jnp.float32)
    tfar_ub = jnp.full((nb, c), T_MAX, jnp.float32)
    big = jnp.float32(T_MAX)
    for k in range(3):
        bmin = cs.bounds_min[None, :, k]                       # (1, C)
        bmax = cs.bounds_max[None, :, k]
        # interval of (b - o): o in [o_lo, o_hi]
        a_lo = bmin - o_hi[:, k:k + 1]
        a_hi = bmax - o_lo[:, k:k + 1]
        dl = d_lo[:, k:k + 1]
        dh = d_hi[:, k:k + 1]
        same_sign = (dl > 1e-12) | (dh < -1e-12)               # (nb, 1)
        # 1/d interval for same-sign directions (order-preserving endpoints)
        i_lo = 1.0 / jnp.where(jnp.abs(dh) < 1e-12, 1e-12, dh)
        i_hi = 1.0 / jnp.where(jnp.abs(dl) < 1e-12, 1e-12, dl)
        # products of interval endpoints: t = (b - o) * (1/d)
        p1 = a_lo * i_lo
        p2 = a_lo * i_hi
        p3 = a_hi * i_lo
        p4 = a_hi * i_hi
        lo_k = jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4))
        hi_k = jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4))
        # mixed-sign direction interval: axis k is unbounded (conservative)
        lo_k = jnp.where(same_sign, lo_k, -big)
        hi_k = jnp.where(same_sign, hi_k, big)
        tnear_lb = jnp.maximum(tnear_lb, lo_k)
        tfar_ub = jnp.minimum(tfar_ub, hi_k)

    hit = (tnear_lb <= tfar_ub) & (tnear_lb < t_cap[:, None])
    return hit, jnp.maximum(tnear_lb, 0.0)


def _morton_sort_keys(origin, direction, cs: ClusterSet):
    """Ray-coherence sort key: direction octant (high bits) + 10-bit-per-axis
    morton code of the origin within the scene bounds."""
    lo = jnp.min(cs.bounds_min, axis=0)
    hi = jnp.max(cs.bounds_max, axis=0)
    q = jnp.clip((origin - lo) / jnp.maximum(hi - lo, 1e-6), 0.0, 1.0)
    q = (q * 1023.0).astype(jnp.uint32)

    def spread(a):
        a = (a | (a << 16)) & jnp.uint32(0x030000FF)
        a = (a | (a << 8)) & jnp.uint32(0x0300F00F)
        a = (a | (a << 4)) & jnp.uint32(0x030C30C3)
        a = (a | (a << 2)) & jnp.uint32(0x09249249)
        return a

    morton = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    octant = (
        (direction[:, 0] > 0).astype(jnp.uint32) * 4
        + (direction[:, 1] > 0).astype(jnp.uint32) * 2
        + (direction[:, 2] > 0).astype(jnp.uint32)
    )
    return (octant << jnp.uint32(30)) | (morton >> jnp.uint32(2))


def closest_hit_packet(cs: ClusterSet, origin, direction, t_max=T_MAX, *,
                       interpret: bool = False, sort: bool = False,
                       need_uv: bool = True, any_hit: bool = False):
    """Packet-traversal closest hit: origin/direction (R, 3) -> dict(t, u, v,
    tri); R is padded to a whole packet here. u/v of the winning triangle are
    tracked inside the kernel.

    sort=True re-bins rays by (direction octant, origin morton) before
    packetization and scatters results back — use for divergent bounce/shadow
    wavefronts; primary rays are already screen-coherent.

    need_uv=False (occlusion queries) skips the in-loop u/v tracking; the
    returned u/v are zeros. any_hit=True ends a packet's walk once every ray
    has a hit inside its t_max."""
    if sort:
        key = _morton_sort_keys(origin, direction, cs)
        # ONE variadic sort carrying every ray attribute + the original index
        # as payload, and a second one keyed on that index to restore order
        # (no gathers: the sort moves payload rows with the keys)
        r0 = origin.shape[0]
        tmb = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r0,))
        idx = jax.lax.broadcasted_iota(jnp.int32, (r0,), 0)
        (_, ox, oy, oz, dx, dy, dz, tms, idx_s) = jax.lax.sort(
            (key, origin[:, 0], origin[:, 1], origin[:, 2], direction[:, 0],
             direction[:, 1], direction[:, 2], tmb, idx), num_keys=1,
        )
        res = closest_hit_packet(
            cs, jnp.stack([ox, oy, oz], axis=1), jnp.stack([dx, dy, dz], axis=1),
            tms, interpret=interpret, need_uv=need_uv, any_hit=any_hit,
        )
        (_, t, u, v, tri) = jax.lax.sort(
            (idx_s, res["t"], res["u"], res["v"], res["tri"]), num_keys=1,
        )
        return {"t": t, "u": u, "v": v, "tri": tri}

    block = BLOCK_RAYS
    r = origin.shape[0]
    pad = (-r) % block
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,))
    if pad:
        # padding rays have t_max = 0: they enter no cluster and never hit
        origin = jnp.concatenate([origin, jnp.zeros((pad, 3), origin.dtype)], axis=0)
        direction = jnp.concatenate(
            [direction, jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], direction.dtype),
                                         (pad, 3))], axis=0)
        t_max = jnp.concatenate([t_max, jnp.zeros((pad,), jnp.float32)], axis=0)
    nb = (r + pad) // block

    # stage 1: flat exact entries whenever affordable; the supercluster
    # hierarchy (exact per-ray keys at C/8 granularity + per-block interval
    # refinement) bounds the stage-1 work for scenes with thousands of clusters
    if cs.count <= FLAT_WORKLIST_MAX_C:
        order, keys_sorted, _ = _block_worklists(origin, direction, cs, t_max, block)
    else:
        order, keys_sorted, _ = _block_worklists_super(
            origin, direction, cs, t_max, block)
    c = order.shape[1]

    rays = jnp.stack(
        [origin[:, 0], origin[:, 1], origin[:, 2],
         direction[:, 0], direction[:, 1], direction[:, 2], t_max,
         jnp.zeros_like(t_max)], axis=0,
    ).reshape(8, nb, block).transpose(1, 0, 2)                      # (nb, 8, B)

    kernel = functools.partial(
        _packet_kernel, any_hit=any_hit, track_uv=need_uv, tile=TRI_TILE,
    )
    row = pl.BlockSpec((None, block), lambda b: (b, 0))
    t, tri, u, v = pl.pallas_call(
        kernel,
        grid=(nb,),
        in_specs=[
            pl.BlockSpec((None, c), lambda b: (b, 0)),          # order
            pl.BlockSpec((None, c), lambda b: (b, 0)),          # keys
            pl.BlockSpec((None, 8, block), lambda b: (b, 0, 0)),  # rays
            pl.BlockSpec(tuple(cs.planes.shape), lambda b: (0, 0)),
        ],
        out_specs=[row] * 4,
        out_shape=[
            jax.ShapeDtypeStruct((nb, block), jnp.float32),
            jax.ShapeDtypeStruct((nb, block), jnp.int32),
            jax.ShapeDtypeStruct((nb, block), jnp.float32),
            jax.ShapeDtypeStruct((nb, block), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="packet_traversal",
    )(order, keys_sorted, rays, cs.planes)

    return {
        "t": t.reshape(-1)[:r],
        "u": u.reshape(-1)[:r],
        "v": v.reshape(-1)[:r],
        "tri": tri.reshape(-1)[:r],
    }


def any_hit_packet(cs: ClusterSet, origin, direction, t_max, *,
                   interpret: bool = False, sort: bool = False):
    """Occlusion query via the same kernel (the any-hit early exit engages
    in-kernel and u/v tracking is skipped)."""
    res = closest_hit_packet(
        cs, origin, direction, t_max, interpret=interpret, sort=sort,
        need_uv=False, any_hit=True,
    )
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), origin.shape[:1])
    return (res["tri"] >= 0) & (res["t"] < t_max)
