"""Emissive importance sampling — the light-BVH reservoir of the reference.

Reference (RaytracingShared.hlsli:750-839 + CastLightRay_AnyHit at 283): up to
PT_IMPORTANCE_SAMPLES_NUM(=16) BRDF-sampled candidate directions are probed
against the *emissive-only* TLAS (merged-emissive BLAS, NRDSample.cpp:2516-2523);
weighted reservoir sampling picks one proportional to the emissive intensity it
would reach, and the path throughput is scaled by
sumIntensity / (chosenIntensity * K), clamped to 8 (firefly suppression).
Occlusion is NOT tested here — the chosen ray is traced normally afterwards, so
blockers resolve naturally.

Wavefront shape: all K candidate directions are generated up front and probed
in ONE batched launch, then the reservoir folds the precomputed intensities in
a cheap lax.scan. Two probe paths:
  * dense (E <= DENSE_EMISSIVE_MAX): (K*R, E) Möller-Trumbore, fused by XLA —
    exact and fastest for small emitter sets;
  * packet (big sets, GPU): closest-hit of the packet kernel against a
    dedicated emissive ClusterSet (the merged-emissive BLAS analogue) built
    host-side in build_context — Bistro-night class scenes (1000s of
    emissive tris) keep ALL emitters instead of an area-truncated 256.
Light intensity is a *sampling weight* -> detached from autodiff; radiance
gradients flow through the normal shading path.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from nrdsample_tpu.mathlib import color, geometry as geo, rng, sampling
from nrdsample_tpu.ops import intersect
from nrdsample_tpu.scene.types import Scene

# biggest emitter set the dense (K*R, E) probe handles; beyond this the
# packet path (GPU) or the chunked dense probe (CPU) takes over
DENSE_EMISSIVE_MAX = 512


def build_emissive_clusters(scene: Scene):
    """HOST-side (numpy, once per scene): ClusterSet over the emissive subset
    + per padded/reordered triangle base luminance. Returns None for small
    sets (the dense probe path needs nothing extra). Built on every platform;
    light_probe_batch decides at trace time whether the kernel uses it.

    The analogue of the reference's merged-emissive BLAS build
    (NRDSample.cpp:2516-2523): a separate acceleration structure holding only
    emitters, traced by CastLightRay_AnyHit."""
    import numpy as np

    from nrdsample_tpu.ops.cluster import build_clusters
    from nrdsample_tpu.scene.types import TriangleSoA

    ids = np.asarray(scene.emissive_tris)
    ids = ids[ids >= 0]
    if len(ids) <= DENSE_EMISSIVE_MAX:
        return None
    sub = TriangleSoA(**{
        f.name: np.asarray(getattr(scene.tris, f.name))[ids]
        for f in dataclasses.fields(TriangleSoA)
    })
    cs, tris_p, order = build_clusters(sub)
    mat = np.asarray(sub.material)[order]
    em = np.asarray(scene.materials.emission)[mat]
    lum = em @ np.asarray([0.2126, 0.7152, 0.0722], em.dtype)
    pad = tris_p.count - len(lum)
    if pad:
        lum = np.concatenate([lum, np.zeros(pad, lum.dtype)])
    return {"clusters": cs, "base_lum": jnp.asarray(lum)}


def build_emissive_set(scene: Scene, emission_scale=1.0, clusters=None):
    """Gather the padded emissive-triangle subset: the light-BVH analogue.

    Returns dict with p0/e1/e2 (E, 3) (degenerate rows for padding) and
    intensity (E,) = luminance of the material emission. `clusters` is the
    optional host-built packet structure (build_emissive_clusters)."""
    ids = scene.emissive_tris
    valid = ids >= 0
    safe = jnp.maximum(ids, 0)
    tr = scene.tris
    mask = valid[:, None].astype(tr.p0.dtype)
    p0 = tr.p0[safe] * mask
    e1 = tr.e1[safe] * mask
    e2 = tr.e2[safe] * mask
    mat = tr.material[safe]
    inten = color.luminance(scene.materials.emission[mat]) * emission_scale
    inten = jnp.where(valid, inten, 0.0)
    out = {"p0": p0, "e1": e1, "e2": e2, "intensity": inten,
           "any": scene.emissive_count > 0}
    if clusters is not None:
        out["clusters"] = clusters["clusters"]
        out["cl_lum"] = clusters["base_lum"] * emission_scale
    return out


_PROBE_CHUNK = 1 << 19


def light_probe(em: dict, origin: jnp.ndarray, direction: jnp.ndarray) -> jnp.ndarray:
    """CastLightRay_AnyHit: intensity of the nearest emissive surface along the
    ray (0 on miss). Dense closest-hit against the emissive set.

    Frame-scale batched launches (K x R rays at 1080p+ = tens of millions)
    are chunked OUTSIDE the body: both the (N, E) intersection planes and the
    tiny-table intensity gather (XLA lowers it as a lane-padded one-hot dot —
    a tiny-table intensity gather) must stay chunk-sized."""
    r = origin.shape[0]
    if r > _PROBE_CHUNK:
        rc = _PROBE_CHUNK
        rpad = (-r) % rc
        if rpad:
            padr = lambda a: jnp.concatenate(
                [a, jnp.broadcast_to(a[-1:], (rpad,) + a.shape[1:])], axis=0)
            origin, direction = padr(origin), padr(direction)
        nch = (r + rpad) // rc
        out = jax.lax.map(
            lambda args: light_probe(em, *args),
            (origin.reshape(nch, rc, 3), direction.reshape(nch, rc, 3)),
        )
        return out.reshape(-1)[:r]
    res = intersect.intersect_dense(
        origin, direction, em["p0"], em["e1"], em["e2"]
    )
    hit = res["tri"] >= 0
    return jnp.where(hit, em["intensity"][jnp.maximum(res["tri"], 0)], 0.0)


@jax.named_scope("emissive_probe")
def light_probe_batch(em: dict, origin: jnp.ndarray, dir_planes,
                      active: jnp.ndarray) -> jnp.ndarray:
    """All K candidates in ONE launch: origin (R, 3), dir_planes = 3 x (K, R)
    direction components, active (K, R) -> intensities (K, R). Packet path
    when the emissive set ships a ClusterSet (big scenes, GPU), dense
    Möller-Trumbore otherwise.

    Directions travel as component planes, not (K, R, 3), so no (K, R, 3)
    temporary is materialized at frame scale."""
    dx, dy, dz = dir_planes
    k, r = dx.shape
    d_flat = jnp.stack([dx.reshape(-1), dy.reshape(-1), dz.reshape(-1)], axis=1)
    o_flat = jnp.broadcast_to(origin[None], (k, r, 3)).reshape(k * r, 3)
    from nrdsample_tpu.platform import use_gpu_kernels

    if "clusters" in em and use_gpu_kernels():
        from nrdsample_tpu.ops.packet import closest_hit_packet

        # inactive candidates still trace (static shape); masked after
        res = closest_hit_packet(em["clusters"], o_flat, d_flat,
                                 sort=True, need_uv=False)
        hit = res["tri"] >= 0
        li = jnp.where(hit, em["cl_lum"][jnp.maximum(res["tri"], 0)], 0.0)
        return li.reshape(k, r) * active
    li = light_probe(em, o_flat, d_flat)
    return li.reshape(k, r) * active


def reservoir_sample_direction(props: dict, em: dict, is_diffuse: jnp.ndarray,
                               pixel_idx, frame, dim: int, n_candidates: int,
                               trim, spec_k_scale: jnp.ndarray | None = None):
    """Pick a bounce direction by weighted reservoir over K BRDF candidates.

    spec_k_scale: per-ray fraction in [0,1] scaling the candidate count for
    specular lobes (GetSpecMagicCurve coupling, TraceOpaque.cs.hlsl:213).
    Returns (ray_local [N,3], throughput_multiplier [N])."""
    n = props["n"]
    v_local = sampling.to_local(props["v"], n)
    x = props["x"]
    # origin slightly off the surface (visibility not tested, but avoid self-hit
    # of the emitter's own backface)
    origin = x + props["n_geom"] * 1e-4

    k_eff = jnp.full(x.shape[:-1], float(n_candidates))
    if spec_k_scale is not None:
        k_spec = jnp.ceil(n_candidates * jnp.clip(spec_k_scale, 0.0, 1.0))
        k_eff = jnp.where(is_diffuse, k_eff, jnp.maximum(k_spec, 1.0))

    # ---- phase 1: ALL candidate directions, vectorized over k. Everything
    # (K, R)-shaped travels as COMPONENT PLANES (see light_probe_batch) ----
    ks = jnp.arange(n_candidates, dtype=jnp.int32)

    def gen(_, k):
        rnd = rng.uniform2(pixel_idx, frame, dim + 3 * k)
        cand_diff = sampling.cosine_ray(rnd)
        h = sampling.vndf_ggx(rnd, v_local, props["roughness"], trim)
        cand_spec = geo.reflect(-v_local, h)
        c = jnp.where(is_diffuse[..., None], cand_diff, cand_spec)
        w = sampling.to_world(c, n)
        return None, (c[..., 0], c[..., 1], c[..., 2],
                      w[..., 0], w[..., 1], w[..., 2])

    # scan (not vmap): per-k intermediates stay (R,)-sized
    _, (cx, cy, cz, wx, wy, wz) = jax.lax.scan(gen, None, ks)   # 6 x (K, R)
    active = (ks[:, None] < k_eff[None, :]).astype(x.dtype)     # (K, R)

    # ---- phase 2: ONE batched light probe ----
    li_all = light_probe_batch(em, origin, (wx, wy, wz), active)  # (K, R)

    # ---- phase 3: reservoir fold over precomputed intensities (cheap) ----
    sum_i = jnp.zeros(x.shape[:-1])
    chosen_i = jnp.ones(x.shape[:-1])
    ray_local = jnp.zeros_like(x)

    def body(carry, inp):
        sum_i, chosen_i, ray_local = carry
        k, li, ccx, ccy, ccz = inp
        cand = jnp.stack([ccx, ccy, ccz], axis=-1)
        sum_i = sum_i + li
        take_rnd = rng.uniform1(pixel_idx, frame, dim + 3 * k + 2)
        take = (li > 0.0) & (take_rnd < li / jnp.maximum(sum_i, 1e-9))
        ray_local = jnp.where((take | (k == 0))[..., None], cand, ray_local)
        chosen_i = jnp.where(take, li, chosen_i)
        return (sum_i, chosen_i, ray_local), None

    (sum_i, chosen_i, ray_local), _ = jax.lax.scan(
        body, (sum_i, chosen_i, ray_local), (ks, li_all, cx, cy, cz),
    )

    mult = sum_i / (chosen_i * jnp.maximum(k_eff, 1.0))
    mult = jnp.minimum(mult, 8.0)  # firefly clamp (RaytracingShared.hlsli:836)
    mult = jnp.where(sum_i > 0.0, mult, 1.0)
    return ray_local, jax.lax.stop_gradient(mult)
