"""CPU BVH builder: binned-SAH binary build, collapsed to an 8-wide (BVH8) flat
array layout for breadth-vectorized traversal.

Replaces the reference's driver-side BLAS/TLAS build + compaction
(NRDSample.cpp:2464-2864). The design (SURVEY.md §7.3.1): wide nodes so the 8
child-slab tests vectorize across children *and* across the ray batch;
leaves hold contiguous triangle ranges (triangles are reordered at build).

A C++ builder (native/bvh_builder.cpp) accelerates the same algorithm for
Bistro-class triangle counts; this numpy version is the always-available
reference implementation and is used to validate the native one.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

LEAF_SIZE = 4          # max triangles per leaf
WIDTH = 8              # children per node
_LEAF_COUNT_BITS = 4   # leaf meta: count in low bits (<= 15)

# child_meta encoding (int32):
#   -1                         : empty slot
#   >= 0                       : internal child -> node index
#   <= -2                      : leaf -> -(2 + (start << 4 | count))
EMPTY = -1


def _encode_leaf(start: int, count: int) -> int:
    assert 0 < count <= (1 << _LEAF_COUNT_BITS) - 1
    return -(2 + ((start << _LEAF_COUNT_BITS) | count))


def decode_leaf(meta):
    """Works on numpy or jnp arrays: returns (start, count) for leaf metas."""
    v = -(meta) - 2
    return v >> _LEAF_COUNT_BITS, v & ((1 << _LEAF_COUNT_BITS) - 1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BVH8:
    """Flat 8-wide BVH. Node i's children live in child_*[i]."""

    child_min: jnp.ndarray   # (N, 8, 3) f32
    child_max: jnp.ndarray   # (N, 8, 3) f32
    child_meta: jnp.ndarray  # (N, 8) int32

    @property
    def num_nodes(self) -> int:
        return self.child_meta.shape[0]


# ---------------------------------------------------------------------------
# Binary binned-SAH build (numpy, host)
# ---------------------------------------------------------------------------

_NBINS = 16


def _build_binary(tri_min: np.ndarray, tri_max: np.ndarray, leaf_size: int):
    """Returns (nodes, order). nodes: list of tuples
    (bmin, bmax, left, right, start, count); internal: start=-1; leaf: left=-1.
    `order` is the triangle permutation making leaf ranges contiguous."""
    t = len(tri_min)
    centroid = 0.5 * (tri_min + tri_max)
    order = np.arange(t, dtype=np.int64)

    nodes_bmin, nodes_bmax = [], []
    nodes_left, nodes_right = [], []
    nodes_start, nodes_count = [], []

    def alloc():
        nodes_bmin.append(None)
        nodes_bmax.append(None)
        nodes_left.append(-1)
        nodes_right.append(-1)
        nodes_start.append(-1)
        nodes_count.append(0)
        return len(nodes_bmin) - 1

    root = alloc()
    stack = [(root, 0, t)]
    while stack:
        ni, lo, hi = stack.pop()
        ids = order[lo:hi]
        bmin = tri_min[ids].min(axis=0)
        bmax = tri_max[ids].max(axis=0)
        nodes_bmin[ni] = bmin
        nodes_bmax[ni] = bmax
        n = hi - lo
        if n <= leaf_size:
            nodes_start[ni] = lo
            nodes_count[ni] = n
            continue
        c = centroid[ids]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        ext = cmax - cmin
        axis = int(np.argmax(ext))
        if ext[axis] < 1e-12:
            mid = lo + n // 2
        else:
            # binned SAH
            scale = _NBINS * (1.0 - 1e-6) / ext[axis]
            bin_idx = ((c[:, axis] - cmin[axis]) * scale).astype(np.int32)
            bin_idx = np.clip(bin_idx, 0, _NBINS - 1)
            counts = np.bincount(bin_idx, minlength=_NBINS)
            # per-bin bounds
            binmin = np.full((_NBINS, 3), np.inf, np.float32)
            binmax = np.full((_NBINS, 3), -np.inf, np.float32)
            for b in range(_NBINS):
                sel = bin_idx == b
                if counts[b]:
                    binmin[b] = tri_min[ids[sel]].min(axis=0)
                    binmax[b] = tri_max[ids[sel]].max(axis=0)
            # sweep
            lmin = np.minimum.accumulate(binmin, axis=0)
            lmax = np.maximum.accumulate(binmax, axis=0)
            rmin = np.minimum.accumulate(binmin[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(binmax[::-1], axis=0)[::-1]
            lcnt = np.cumsum(counts)
            rcnt = np.cumsum(counts[::-1])[::-1]

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            cost = area(lmin, lmax)[: _NBINS - 1] * lcnt[: _NBINS - 1] + area(
                rmin[1:], rmax[1:]
            ) * rcnt[1:]
            valid = (lcnt[: _NBINS - 1] > 0) & (rcnt[1:] > 0)
            if not valid.any():
                mid = lo + n // 2
            else:
                cost = np.where(valid, cost, np.inf)
                split_bin = int(np.argmin(cost))
                go_left = bin_idx <= split_bin
                left_ids = ids[go_left]
                right_ids = ids[~go_left]
                order[lo : lo + len(left_ids)] = left_ids
                order[lo + len(left_ids) : hi] = right_ids
                mid = lo + len(left_ids)
        if mid == lo or mid == hi:
            mid = lo + n // 2
            # re-sort by centroid for a median split
            ids = order[lo:hi]
            key = centroid[ids][:, axis]
            order[lo:hi] = ids[np.argsort(key, kind="stable")]
        li = alloc()
        ri = alloc()
        nodes_left[ni] = li
        nodes_right[ni] = ri
        stack.append((ri, mid, hi))
        stack.append((li, lo, mid))

    nodes = {
        "bmin": np.asarray(nodes_bmin, np.float32),
        "bmax": np.asarray(nodes_bmax, np.float32),
        "left": np.asarray(nodes_left, np.int64),
        "right": np.asarray(nodes_right, np.int64),
        "start": np.asarray(nodes_start, np.int64),
        "count": np.asarray(nodes_count, np.int64),
    }
    return nodes, order


# ---------------------------------------------------------------------------
# Collapse binary -> 8-wide
# ---------------------------------------------------------------------------

def _collapse(nodes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    bmin, bmax = nodes["bmin"], nodes["bmax"]
    left, right = nodes["left"], nodes["right"]
    start, count = nodes["start"], nodes["count"]
    is_leaf = left < 0

    out_min, out_max, out_meta = [], [], []

    def alloc():
        out_min.append(np.zeros((WIDTH, 3), np.float32))
        out_max.append(np.zeros((WIDTH, 3), np.float32))
        out_meta.append(np.full(WIDTH, EMPTY, np.int32))
        return len(out_meta) - 1

    # map binary root -> wide root; BFS
    wide_root = alloc()
    work = [(wide_root, 0)]
    while work:
        wi, bi = work.pop()
        # gather up to WIDTH binary subtrees under bi, splitting largest-area
        # internal entries first
        slots = [bi]
        while len(slots) < WIDTH:
            # pick internal slot with largest surface area to expand
            best, best_a = -1, -1.0
            for k, s in enumerate(slots):
                if not is_leaf[s]:
                    d = np.maximum(bmax[s] - bmin[s], 0)
                    a = d[0] * d[1] + d[1] * d[2] + d[2] * d[0]
                    if a > best_a:
                        best, best_a = k, a
            if best < 0:
                break
            s = slots.pop(best)
            slots.extend([left[s], right[s]])
        for k, s in enumerate(slots):
            out_min[wi][k] = bmin[s]
            out_max[wi][k] = bmax[s]
            if is_leaf[s]:
                out_meta[wi][k] = _encode_leaf(int(start[s]), int(count[s]))
            else:
                ci = alloc()
                out_meta[wi][k] = ci
                work.append((ci, s))

    return (
        np.stack(out_min),
        np.stack(out_max),
        np.stack(out_meta),
    )


def build_bvh8(tri_p0: np.ndarray, tri_e1: np.ndarray, tri_e2: np.ndarray,
               leaf_size: int = LEAF_SIZE):
    """Build a BVH8 over triangles given as (p0, e1, e2) arrays.

    Returns (BVH8, order) where `order` is the int64 permutation to apply to all
    per-triangle arrays so leaf ranges are contiguous.
    """
    p0 = np.asarray(tri_p0, np.float32)
    p1 = p0 + np.asarray(tri_e1, np.float32)
    p2 = p0 + np.asarray(tri_e2, np.float32)
    tri_min = np.minimum(np.minimum(p0, p1), p2)
    tri_max = np.maximum(np.maximum(p0, p1), p2)
    # small epsilon pad for degenerate/axis-aligned triangles
    pad = 1e-6 * np.maximum(1.0, np.abs(tri_max) + np.abs(tri_min))
    tri_min -= pad
    tri_max += pad
    nodes, order = _build_binary(tri_min, tri_max, leaf_size)
    cmin, cmax, cmeta = _collapse(nodes)
    bvh = BVH8(
        child_min=jnp.asarray(cmin),
        child_max=jnp.asarray(cmax),
        child_meta=jnp.asarray(cmeta),
    )
    return bvh, order


def reorder_tris(tris, order: np.ndarray):
    """Apply the BVH triangle permutation to a TriangleSoA pytree (host side —
    no eager device gathers; build_context uploads the result once)."""
    idx = order.astype(np.int32)
    return jax.tree.map(lambda a: np.asarray(a)[idx], tris)


def max_depth_estimate(bvh: BVH8) -> int:
    """Host-side: longest root-to-leaf path (for traversal stack sizing)."""
    meta = np.asarray(bvh.child_meta)
    depth = {0: 1}
    best = 1
    work = [0]
    while work:
        n = work.pop()
        for m in meta[n]:
            if m >= 0:
                depth[int(m)] = depth[n] + 1
                best = max(best, depth[int(m)])
                work.append(int(m))
    return best
