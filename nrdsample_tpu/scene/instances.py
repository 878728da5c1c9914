"""Instanced dynamic scenes — the TLAS-rebuild / animated-instance analogue.

Reference per-frame dynamics (SURVEY.md §2.1): `GatherInstanceData`
(NRDSample.cpp:3395-3630) rebuilds the TLAS instance array every frame from
animated transforms, `CmdBuildTopLevelAccelerationStructures` refits the TLAS
(NRDSample.cpp:3907-3944), and motion vectors come from each instance's
``worldToWorldPrev`` (static vs dynamic matrix overload, 3395-3630).

Design: instance-local triangle geometry is flattened ONCE at build
(fixed cluster assignment from the rest pose); per frame a jitted transform
pass re-computes world-space triangle SoA + cluster AABBs as dense batched
matmuls — the "TLAS rebuild" becomes ~2 fused einsums + a reshape-min/max,
no host round trip, fully differentiable w.r.t. transforms.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from nrdsample_tpu.scene.types import Scene, TriangleSoA

_HI = jax.lax.Precision.HIGHEST  # full f32 products (no TF32 on GPUs)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class InstancedScene:
    """A Scene whose triangles carry an instance id, plus rest-pose geometry.

    ``scene`` holds the REST-POSE world geometry (identity transforms) already
    reordered/padded by build_context; ``instance_id`` aligns with
    scene.tris rows. Transforms are per-frame inputs, not state.
    """

    scene: Scene
    instance_id: jnp.ndarray     # (T,) int32, 0 = static background
    n_instances: int = dataclasses.field(default=1, metadata=dict(static=True))
    # optional (I, 10) per-instance material scales (see Scene.instance_scales)
    instance_scales: jnp.ndarray | None = None


def assign_instance_ids(scene: Scene, tri_instance: np.ndarray, ctx,
                        instance_scales=None) -> InstancedScene:
    """Build an InstancedScene AFTER build_context: permute the host-side
    per-triangle instance ids through the context's triangle order and pad.

    instance_scales: optional (I, 10) per-instance material scale rows
    [baseColor.xyz, metalness, emission.xyz, roughness, normalUv.xy]
    (InstanceData scale factors, RaytracingShared.hlsli:456-468)."""
    order = getattr(ctx, "order", None)
    ids = np.asarray(tri_instance, np.int32)
    if order is not None:
        ids = ids[np.asarray(order)]
    t_dev = scene.tris.count
    if len(ids) < t_dev:  # cluster padding
        ids = np.concatenate([ids, np.zeros(t_dev - len(ids), np.int32)])
    return InstancedScene(
        scene=scene,
        instance_id=jnp.asarray(ids),
        n_instances=int(tri_instance.max()) + 1 if len(tri_instance) else 1,
        instance_scales=(None if instance_scales is None
                         else jnp.asarray(instance_scales, jnp.float32)),
    )


def identity_transforms(n: int, dtype=jnp.float32) -> jnp.ndarray:
    """(n, 3, 4) rigid transforms, identity."""
    m = jnp.zeros((n, 3, 4), dtype)
    return m.at[:, :3, :3].set(jnp.eye(3, dtype=dtype))


def transform_scene(inst: InstancedScene, transforms: jnp.ndarray) -> Scene:
    """Apply (n_instances, 3, 4) transforms; returns a Scene with world
    triangles + (for vertex normals) rotated normals. Jit-safe, differentiable.

    The per-triangle gather of its instance matrix is a (T, 3, 4) take — tiny
    vs. the geometry itself; positions then transform as one batched einsum.
    """
    tr = inst.scene.tris
    m = transforms[inst.instance_id]           # (T, 3, 4)
    r = m[:, :, :3]                            # (T, 3, 3)
    t = m[:, :, 3]                             # (T, 3)

    def xf_point(p):
        return jnp.einsum("tij,tj->ti", r, p, precision=_HI) + t

    def xf_vec(v):
        return jnp.einsum("tij,tj->ti", r, v, precision=_HI)

    def xf_normal(nrm):
        # rigid/uniform-scale assumption: rotate (full inverse-transpose not
        # needed for the animation modes the reference uses — orbits are rigid)
        out = jnp.einsum("tij,tj->ti", r, nrm, precision=_HI)
        return out / jnp.maximum(jnp.linalg.norm(out, axis=-1, keepdims=True), 1e-20)

    new_tris = dataclasses.replace(
        tr,
        p0=xf_point(tr.p0), e1=xf_vec(tr.e1), e2=xf_vec(tr.e2),
        n0=xf_normal(tr.n0), n1=xf_normal(tr.n1), n2=xf_normal(tr.n2),
        t0=xf_normal(tr.t0), t1=xf_normal(tr.t1), t2=xf_normal(tr.t2),
    )
    return dataclasses.replace(
        inst.scene, tris=new_tris,
        tri_instance=(inst.instance_id
                      if inst.instance_scales is not None else None),
        instance_scales=inst.instance_scales,
    )


def _invert_3x4(m: jnp.ndarray) -> jnp.ndarray:
    """Batch-invert (N, 3, 4) affine transforms (general 3x3 via adjugate)."""
    r = m[..., :3]
    t = m[..., 3]
    c0 = jnp.cross(r[..., :, 1], r[..., :, 2], axis=-1)
    det = jnp.sum(r[..., :, 0] * c0, axis=-1, keepdims=True)
    inv_r = jnp.stack(
        [
            jnp.cross(r[..., :, 1], r[..., :, 2], axis=-1),
            jnp.cross(r[..., :, 2], r[..., :, 0], axis=-1),
            jnp.cross(r[..., :, 0], r[..., :, 1], axis=-1),
        ],
        axis=-2,
    ) / jnp.where(jnp.abs(det[..., None]) < 1e-20, 1e-20, det[..., None])
    inv_t = -jnp.einsum("nij,nj->ni", inv_r, t, precision=_HI)
    return jnp.concatenate([inv_r, inv_t[..., None]], axis=-1)


def prev_position(inst: InstancedScene, m_curr: jnp.ndarray, m_prev: jnp.ndarray,
                  x: jnp.ndarray, tri: jnp.ndarray) -> jnp.ndarray:
    """Xprev for hit points on animated geometry — the worldToWorldPrev
    motion-matrix path of GatherInstanceData (NRDSample.cpp:3395-3630, dynamic
    overload): x_prev = M_prev * M_curr^{-1} * x, per the hit triangle's
    instance. Feed the result to camera.get_motion for true 2.5D motion
    vectors of moving objects."""
    tri_safe = jnp.clip(tri, 0, inst.instance_id.shape[0] - 1)
    iid = inst.instance_id[tri_safe]
    w2w = jnp.einsum(
        "nij,njk->nik",
        m_prev[iid][..., :3],
        _invert_3x4(m_curr)[iid][..., :3],
        precision=_HI,
    )
    t_rel = m_prev[iid][..., 3] + jnp.einsum(
        "nij,nj->ni", m_prev[iid][..., :3], _invert_3x4(m_curr)[iid][..., 3],
        precision=_HI,
    )
    x_prev = jnp.einsum("nij,nj->ni", w2w, x, precision=_HI) + t_rel
    return jnp.where((tri >= 0)[..., None], x_prev, x)


def refit_context(ctx, world_scene: Scene):
    """Refit the acceleration structure to moved geometry (the BLAS/TLAS refit
    analogue, NRDSample.cpp:2727-2780 ALLOW_UPDATE path).

    Cluster mode: cluster membership is frozen at the rest pose; bounds and the
    cluster-major triangle slabs are recomputed on device. Dense mode: nothing
    to refit. Returns a NEW context sharing everything else.
    """
    from nrdsample_tpu.ops import traversal as trav
    from nrdsample_tpu.ops.cluster import CLUSTER_SIZE

    tr = world_scene.tris
    if ctx.mode == "dense":
        new_ctx = trav.TraceContext(tr, "dense")
        new_ctx.order = getattr(ctx, "order", None)
        return new_ctx

    if ctx.mode == "cluster":
        from nrdsample_tpu.ops.cluster import SUPER_SIZE, component_planes

        cs = ctx.clusters
        c = cs.count
        p0b = tr.p0.reshape(c, CLUSTER_SIZE, 3)
        e1b = tr.e1.reshape(c, CLUSTER_SIZE, 3)
        e2b = tr.e2.reshape(c, CLUSTER_SIZE, 3)
        p1b = p0b + e1b
        p2b = p0b + e2b
        # padded (degenerate) triangles are all-zero and would pollute bounds;
        # mask them by their rest-pose degeneracy (e1 == e2 == 0)
        degenerate = (
            jnp.all(cs.e1_b == 0.0, axis=-1) & jnp.all(cs.e2_b == 0.0, axis=-1)
        )[..., None]
        big = jnp.float32(3.0e37)
        lo = jnp.minimum(jnp.minimum(p0b, p1b), p2b)
        hi = jnp.maximum(jnp.maximum(p0b, p1b), p2b)
        lo = jnp.where(degenerate, big, lo)
        hi = jnp.where(degenerate, -big, hi)
        bmin = jnp.min(lo, axis=1)
        bmax = jnp.max(hi, axis=1)
        spad = (-c) % SUPER_SIZE
        bmin_p = jnp.concatenate(
            [bmin, jnp.full((spad, 3), 3.0e37, bmin.dtype)]
        ) if spad else bmin
        bmax_p = jnp.concatenate(
            [bmax, jnp.full((spad, 3), -3.0e37, bmax.dtype)]
        ) if spad else bmax
        cs_n = (c + spad) // SUPER_SIZE
        new_cs = dataclasses.replace(
            cs,
            bounds_min=bmin,
            bounds_max=bmax,
            p0_b=p0b, e1_b=e1b, e2_b=e2b,
            planes=component_planes(p0b, e1b, e2b),
            super_min=bmin_p.reshape(cs_n, SUPER_SIZE, 3).min(axis=1),
            super_max=bmax_p.reshape(cs_n, SUPER_SIZE, 3).max(axis=1),
        )
        new_ctx = trav.TraceContext(tr, "cluster", clusters=new_cs)
        new_ctx.order = getattr(ctx, "order", None)
        new_ctx.tri_offset = getattr(ctx, "tri_offset", 0)
        return new_ctx

    raise NotImplementedError(f"refit for mode {ctx.mode!r}")
