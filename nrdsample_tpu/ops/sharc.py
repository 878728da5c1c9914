"""SHARC — spatial hash radiance cache as array programs.

Reference: the SHARC header-only HLSL library (CMake-fetched; SURVEY.md §2.3):
a 2^22-entry hash grid over (quantized world position, LOD level, normal
orientation) with accumulation + resolved buffers; exercised via
`SharcGetCachedRadiance` (TraceOpaque.cs.hlsl:347), `SharcUpdateHit`
(SharcUpdate.cs.hlsl:109-119) and `SharcResolveEntry` (SharcResolve.cs.hlsl:33).

Re-design (SURVEY.md §7.1 row "SHARC"): the CAS-loop insertion becomes
vectorized gather (probe keys) -> select slot -> scatter (claim) + scatter-add
(accumulate). Within one jitted frame scatter-adds combine deterministically;
cross-cell slot conflicts are resolved last-writer-wins at claim time and
checksum-verified at query time, so a lost claim only costs a cache miss, never
corruption. The resolve pass is a flat 1-D map over all entries — exactly the
shape of the reference's SharcResolve dispatch (2^22 / 256 groups).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from nrdsample_tpu import config as cfgmod

_U32 = jnp.uint32


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SharcState:
    """Device-resident cache state (the 3 SHARC buffers, NRDSample.cpp:2964-2966)."""

    keys: jnp.ndarray        # (C,) uint32 checksum; 0 = empty
    accum: jnp.ndarray       # (C, 4) f32: sum(rgb), sample count (this frame)
    resolved: jnp.ndarray    # (C, 4) f32: resolved rgb, accumulated frame count
    last_seen: jnp.ndarray   # (C,) int32 frame index of last touch

    @staticmethod
    def create(capacity: int = cfgmod.SHARC_CAPACITY, dtype=jnp.float32) -> "SharcState":
        return SharcState(
            keys=jnp.zeros((capacity,), _U32),
            accum=jnp.zeros((capacity, 4), dtype),
            resolved=jnp.zeros((capacity, 4), dtype),
            last_seen=jnp.zeros((capacity,), jnp.int32),
        )

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


# ---------------------------------------------------------------------------
# Hash-grid keying
# ---------------------------------------------------------------------------

def grid_level(pos: jnp.ndarray, cam_pos: jnp.ndarray,
               scene_scale: float = cfgmod.SHARC_SCENE_SCALE,
               dither=None) -> jnp.ndarray:
    """Logarithmic LOD from camera distance (HashGridGetLevel): voxels double in
    size with each power-of-2 distance ring.

    dither: optional per-sample uniform in [0, 1) replacing the fixed 0.5
    rounding offset — samples near a LOD ring land in either level
    probabilistically, so the voxel-size change dissolves into noise the
    temporal accumulation averages out instead of a visible seam (the
    reference's LOD transition dithering)."""
    d = jnp.linalg.norm(pos - cam_pos, axis=-1)
    r = 0.5 if dither is None else dither
    lvl = jnp.floor(jnp.log2(jnp.maximum(d, 1e-3)) + r)
    return jnp.clip(lvl, -4.0, 10.0)


def voxel_size(level: jnp.ndarray, scene_scale: float = cfgmod.SHARC_SCENE_SCALE) -> jnp.ndarray:
    """World-space voxel edge at a level (HashGridGetVoxelSize)."""
    return jnp.exp2(level) * (4.0 / scene_scale)


def _hash_u32x4(a, b, c, d):
    """xxhash-style avalanche over 4 words -> uint32."""
    h = a.astype(_U32) * _U32(0x9E3779B1)
    h = (h ^ (h >> 15)) * _U32(0x85EBCA77)
    h = h + b.astype(_U32) * _U32(0xC2B2AE3D)
    h = (h ^ (h >> 13)) * _U32(0x27D4EB2F)
    h = h + c.astype(_U32) * _U32(0x165667B1)
    h = (h ^ (h >> 16)) * _U32(0x9E3779B1)
    h = h + d.astype(_U32)
    h = (h ^ (h >> 15)) * _U32(0x85EBCA77)
    return h ^ (h >> 13)


def cell_key(pos: jnp.ndarray, normal: jnp.ndarray, cam_pos: jnp.ndarray,
             scene_scale: float = cfgmod.SHARC_SCENE_SCALE, dither=None):
    """Quantize (pos, normal) -> (hash words). Normal contributes its dominant
    axis octant (6 orientations) so opposite faces of thin walls don't share
    cells — matching SHARC's normal-based key component."""
    lvl = grid_level(pos, cam_pos, scene_scale, dither=dither)
    vs = voxel_size(lvl, scene_scale)
    q = jnp.floor(pos / vs[..., None]).astype(jnp.int32)
    ax = jnp.argmax(jnp.abs(normal), axis=-1).astype(jnp.int32)
    sgn = jnp.take_along_axis(normal, ax[..., None], axis=-1)[..., 0] < 0
    orient = ax * 2 + sgn.astype(jnp.int32)
    w = orient + (lvl.astype(jnp.int32) + 8) * 8
    return q[..., 0], q[..., 1], q[..., 2], w, lvl


def slot_and_checksum(pos, normal, cam_pos, capacity: int,
                      scene_scale: float = cfgmod.SHARC_SCENE_SCALE,
                      dither=None):
    """(slot index, checksum) per element; checksum is never 0."""
    x, y, z, w, lvl = cell_key(pos, normal, cam_pos, scene_scale, dither=dither)
    h1 = _hash_u32x4(x, y, z, w)
    h2 = _hash_u32x4(w, z, y, x)
    slot = (h1 % _U32(capacity)).astype(jnp.int32)
    checksum = jnp.maximum(h2, _U32(1))
    return slot, checksum, lvl


# ---------------------------------------------------------------------------
# Operations
# ---------------------------------------------------------------------------

def query(state: SharcState, pos, normal, cam_pos,
          scene_scale: float = cfgmod.SHARC_SCENE_SCALE, dither=None):
    """SharcGetCachedRadiance: returns (radiance [...,3], found [...])."""
    slot, checksum, _ = slot_and_checksum(pos, normal, cam_pos, state.capacity,
                                          scene_scale, dither=dither)
    key = state.keys[slot]
    res = state.resolved[slot]
    count = res[..., 3]
    found = (key == checksum) & (count > 0.0)
    radiance = res[..., :3] / jnp.maximum(count, 1.0)[..., None]
    return jnp.where(found[..., None], radiance, 0.0), found


def update(state: SharcState, pos, normal, radiance, cam_pos, frame,
           mask=None, scene_scale: float = cfgmod.SHARC_SCENE_SCALE,
           dither=None) -> SharcState:
    """SharcUpdateHit: claim slots + scatter-add radiance samples.

    radiance: [..., 3] per-sample incident radiance estimate at the cell.
    Claim policy: a sample whose checksum mismatches the stored key overwrites
    the key only if the entry is empty or stale-evicted; accumulation is gated
    on checksum match *after* claiming, so first-frame inserts accumulate too.
    """
    slot, checksum, _ = slot_and_checksum(pos, normal, cam_pos, state.capacity,
                                          scene_scale, dither=dither)
    slot_f = slot.reshape(-1)
    csum_f = checksum.reshape(-1)
    rad_f = radiance.reshape(-1, 3)
    if mask is None:
        mask_f = jnp.ones(slot_f.shape, bool)
    else:
        mask_f = mask.reshape(-1)

    keys = state.keys
    cur = keys[slot_f]
    empty = cur == 0
    claim = mask_f & empty
    # Last-writer-wins claim (benign: losers just miss this frame). The last
    # writer of a slot is its highest-index sample, as in a sequential pass
    # over the samples; found with a scatter-max of indices, because the
    # winner of a duplicate-index scatter-set depends on the order a device
    # applies it in, and every device (and every shard) must build the same
    # table.
    n = slot_f.shape[0]
    last = jnp.full(keys.shape, -1, jnp.int32).at[slot_f].max(
        jnp.arange(n, dtype=jnp.int32), mode="drop")
    has_last = last >= 0
    last = jnp.maximum(last, 0)
    keys = jnp.where(has_last & claim[last], csum_f[last], keys)

    owned = mask_f & (keys[slot_f] == csum_f)
    add = jnp.concatenate([rad_f, jnp.ones_like(rad_f[..., :1])], axis=-1)
    add = jnp.where(owned[..., None], add, 0.0)
    accum = state.accum.at[slot_f].add(add, mode="drop")
    # every owner writes the same frame index: any order gives one result
    last_seen = state.last_seen.at[jnp.where(owned, slot_f, state.capacity)].set(
        jnp.int32(frame), mode="drop")
    return dataclasses.replace(state, keys=keys, accum=accum, last_seen=last_seen)


def resolve(state: SharcState, frame,
            responsive_frames: int = cfgmod.SHARC_RESPONSIVE_FRAME_NUM,
            stale_frames: int = cfgmod.SHARC_STALE_FRAME_NUM_MIN * 4) -> SharcState:
    """SharcResolveEntry for every entry (flat map, no gather/scatter):
    fold this frame's accumulation into the resolved estimate with a
    history-capped running mean; evict entries unseen for `stale_frames`."""
    acc = state.accum
    res = state.resolved
    n_new = acc[..., 3]
    n_old = res[..., 3]
    n_total = jnp.minimum(n_old + n_new, float(responsive_frames * 4))
    # running mean over samples, capped: resolved stores sum-normalized-by-count
    scale = jnp.where(
        n_old + n_new > 0.0, n_total / jnp.maximum(n_old + n_new, 1.0), 0.0
    )
    new_rgb = (res[..., :3] + acc[..., :3]) * scale[..., None]
    resolved = jnp.concatenate([new_rgb, n_total[..., None]], axis=-1)

    stale = (jnp.int32(frame) - state.last_seen) > stale_frames
    keys = jnp.where(stale, _U32(0), state.keys)
    resolved = jnp.where(stale[..., None], 0.0, resolved)
    return SharcState(
        keys=keys,
        accum=jnp.zeros_like(acc),
        resolved=resolved,
        last_seen=state.last_seen,
    )
