"""Hit decoding and material fetch — the CastRay hit-decode + GetMaterialProps
equivalents (RaytracingShared.hlsli:314-555).

`GeometryProps` / `MaterialProps` become dicts of batched arrays. The hit
triangle index is detached (discrete decision); everything recomputed here from
scene arrays (positions, normals, material parameters) stays differentiable so
gradients flow to scene parameters (SURVEY.md §7.1 "Differentiability").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nrdsample_tpu.mathlib import geometry as geo
from nrdsample_tpu.ops import traversal
from nrdsample_tpu.render import lighting
from nrdsample_tpu.scene.types import Scene

T_MAX = traversal.T_MAX


def decode_hit(scene: Scene, hit: dict, origin: jnp.ndarray, direction: jnp.ndarray,
               sun_dir: jnp.ndarray, tan_sun_radius, white_furnace: bool = False,
               emission_scale=1.0, cone_width=None, forced_material=None,
               use_normal_map=None, emission_scale_cubes=None):
    """Build geometry+material props from a traversal result.

    Returns a dict with:
      miss, t, x, v, n (shading), n_geom, uv, mat (material id), view-facing n,
      base_color, roughness, metalness, lemi, albedo-ready fields.
    On miss: lemi = sky radiance along the ray, base_color = 0 — matching
    GetMaterialProps miss handling so the path loop can just read Lemi.
    """
    tri = jnp.maximum(hit["tri"], 0)
    miss = hit["tri"] < 0
    u = hit["u"]
    v_bc = hit["v"]
    t = hit["t"]

    tr = scene.tris
    f32 = tr.p0.dtype
    # ONE wide row gather for every per-triangle attribute instead of ten
    # narrow (R, 3) gathers (the concat is fused). material id rides along as
    # float (< 2^24, exact).
    tri_pack = jnp.concatenate(
        [tr.p0, tr.e1, tr.e2, tr.n0, tr.n1, tr.n2, tr.uv0, tr.uv1, tr.uv2,
         tr.world_area[:, None], tr.material.astype(f32)[:, None],
         tr.t0, tr.t1, tr.t2, tr.bitan_sign[:, None]],
        axis=1,
    )
    g = tri_pack[tri]
    p0, e1, e2 = g[..., 0:3], g[..., 3:6], g[..., 6:9]
    tn0, tn1, tn2 = g[..., 9:12], g[..., 12:15], g[..., 15:18]
    tuv0, tuv1, tuv2 = g[..., 18:20], g[..., 20:22], g[..., 22:24]
    world_area = g[..., 24]
    mat = g[..., 25].astype(jnp.int32)
    tt0, tt1, tt2 = g[..., 26:29], g[..., 29:32], g[..., 32:35]
    bitan_sign = g[..., 35]

    # differentiable hit position from detached (t, u, v): prefer barycentric
    # reconstruction so vertex-position gradients flow
    x = p0 + u[..., None] * e1 + v_bc[..., None] * e2
    x = jnp.where(miss[..., None], origin + direction * T_MAX, x)

    w = 1.0 - u - v_bc
    n_smooth = geo.normalize(
        w[..., None] * tn0 + u[..., None] * tn1 + v_bc[..., None] * tn2
    )
    n_geom = geo.normalize(jnp.cross(e1, e2))
    view = -direction  # V points away from the surface toward the previous vertex

    # two-sided: flip normals to face the incoming ray (the reference renders
    # two-sided since RayFlags==0 and normals get flipped in CastRay's decode)
    flip = jnp.sign(geo.dot3(n_geom, view))[..., None]
    n_geom = n_geom * flip
    n_smooth = n_smooth * jnp.sign(geo.dot3(n_smooth, view))[..., None]

    uv = w[..., None] * tuv0 + u[..., None] * tuv1 + v_bc[..., None] * tuv2

    # interpolated tangent, orthonormalized against the shading normal
    # (RaytracingShared.hlsli:403-410: barycentric T + normalize; sign rides
    # along for the bitangent handedness)
    t_raw = w[..., None] * tt0 + u[..., None] * tt1 + v_bc[..., None] * tt2
    t_raw = t_raw - n_smooth * geo.dot3(t_raw, n_smooth)[..., None]
    t_fallback, _ = geo.orthonormal_basis(n_smooth)
    tangent = geo.normalize(
        jnp.where(geo.length(t_raw)[..., None] > 1e-6, t_raw, t_fallback)
    )

    mats = scene.materials
    # same wide-gather trick for the material constants (flags as exact float)
    mat_pack = jnp.concatenate(
        [mats.base_color, mats.roughness[:, None], mats.metalness[:, None],
         mats.emission, mats.flags.astype(f32)[:, None]],
        axis=1,
    )
    mg = mat_pack[mat]
    base_color = mg[..., 0:3]
    roughness = mg[..., 3]
    metalness = mg[..., 4]
    flags = mg[..., 8].astype(jnp.int32)
    # lights/cubes emission split (NRDSample.cpp:243-244): forced-emission
    # materials (animated cubes) get their own intensity scale
    if emission_scale_cubes is not None:
        from nrdsample_tpu import config as cfgmod

        is_cube = (flags & cfgmod.FLAG_FORCED_EMISSION) != 0
        e_scale = jnp.where(is_cube,
                            jnp.asarray(emission_scale_cubes, f32),
                            jnp.asarray(emission_scale, f32))[..., None]
    else:
        e_scale = emission_scale
    emission = mg[..., 5:8] * e_scale

    # per-instance material scales (InstanceData.baseColorAndMetalnessScale /
    # emissionAndRoughnessScale / normalUvScale, RaytracingShared.hlsli:
    # 456-468): one extra row gather, compiled only when the scene carries
    # instance scales (the common case stays scale-free)
    inst_sc = None
    if scene.tri_instance is not None and scene.instance_scales is not None:
        inst_sc = scene.instance_scales[scene.tri_instance[tri]]
        base_color = base_color * inst_sc[..., 0:3]
        metalness = metalness * inst_sc[..., 3]
        emission = emission * inst_sc[..., 4:7]
        roughness = roughness * inst_sc[..., 7]

    # material textures with ray-cone mip (GetMaterialProps' 4 bindless
    # fetches, RaytracingShared.hlsli:424-555; LOD :154-189). Texture values
    # MULTIPLY the material constants (glTF convention); texels are pytree
    # leaves so gradients flow into them (differentiable texture optimization)
    mip = jnp.zeros_like(t)
    local_curv = jnp.zeros_like(t)
    if scene.textures is not None:
        from nrdsample_tpu.render import raycone
        from nrdsample_tpu.scene import textures as tex_mod

        ts = scene.textures
        if cone_width is not None:
            uva = raycone.uv_area(tuv0, tuv1, tuv2)
            mip = raycone.texture_mip(
                cone_width, world_area, uva,
                geo.dot3(n_geom, view), ts.base_res, max_mip=ts.n_mips - 1.0,
            )
        texel = tex_mod.sample(ts, mat, uv, mip)
        base_color = base_color * texel[..., 0:3]
        roughness = roughness * texel[..., 5]
        metalness = metalness * texel[..., 6]
        emission = emission * texel[..., 7:8]

        # normal mapping (Geometry::TransformLocalNormal,
        # RaytracingShared.hlsli:467-479): tangent-space XY from the map,
        # Z reconstructed, rotated into the TBN frame; gUseNormalMap analogue
        # is the dynamic `use_normal_map` scalar (1.0 default when None).
        nm_gate = (jnp.float32(1.0) if use_normal_map is None
                   else jnp.asarray(use_normal_map, f32))
        if inst_sc is not None:
            # normalUvScale: the normal map samples at scaled uv
            # (RaytracingShared.hlsli:469) — a second fetch, only compiled
            # for instance-scaled scenes
            texel_n = tex_mod.sample(ts, mat, uv * inst_sc[..., 8:10], mip)
            n_local_xy = texel_n[..., 8:10] * nm_gate
        else:
            n_local_xy = texel[..., 8:10] * nm_gate
        n_local_z = jnp.sqrt(jnp.clip(
            1.0 - jnp.sum(n_local_xy * n_local_xy, axis=-1), 1e-6, 1.0))
        bitan = jnp.cross(n_smooth, tangent) * bitan_sign[..., None]
        n_mapped = geo.normalize(
            n_local_xy[..., 0:1] * tangent
            + n_local_xy[..., 1:2] * bitan
            + n_local_z[..., None] * n_smooth
        )
        # keep the mapped normal in the visible hemisphere, then re-orthogonalize
        # the tangent against it so (T, B, N) stays a frame for hair/aniso
        n_mapped = n_mapped * jnp.sign(geo.dot3(n_mapped, view))[..., None]
        n_smooth = jnp.where(miss[..., None], n_smooth, n_mapped)
        t_reproj = tangent - n_smooth * geo.dot3(tangent, n_smooth)[..., None]
        tangent = geo.normalize(
            jnp.where(geo.length(t_reproj)[..., None] > 1e-6, t_reproj, tangent)
        )
        # local curvature from the normal-map slope over the pixel footprint
        # (RaytracingShared.hlsli:476-479: length(Nlocal.xy) / pixelSize);
        # cone_width IS the footprint at the hit for camera rays
        if cone_width is not None:
            local_curv = geo.length(n_local_xy) / jnp.maximum(cone_width, 1e-6)

    if white_furnace:
        base_color = jnp.ones_like(base_color)
        emission = jnp.zeros_like(emission)

    if forced_material is not None:
        # GetMaterialProps forced-material branch
        # (RaytracingShared.hlsli:497-515): GYPSUM = flat white diffuse,
        # COBALT = metal whose roughness encodes the original base color.
        # The reference early-outs on miss, so force only hit lanes.
        from nrdsample_tpu import config as cfgmod

        fm = jnp.asarray(forced_material, jnp.int32)
        gypsum = jnp.logical_and(fm == cfgmod.ForcedMaterial.GYPSUM, ~miss)
        cobalt = jnp.logical_and(fm == cfgmod.ForcedMaterial.COBALT, ~miss)
        cobalt_rough = jnp.cbrt(
            jnp.clip(base_color[..., 0] * base_color[..., 1] * base_color[..., 2],
                     0.0, 1.0)
        )
        roughness = jnp.where(gypsum, 1.0, jnp.where(cobalt, cobalt_rough, roughness))
        metalness = jnp.where(gypsum, 0.0, jnp.where(cobalt, 1.0, metalness))
        base_color = jnp.where(
            gypsum[..., None], 0.5,
            jnp.where(
                cobalt[..., None],
                jnp.asarray([0.672411, 0.637331, 0.585456], base_color.dtype),
                base_color,
            ),
        )

    sky = lighting.sky_intensity(direction, sun_dir, tan_sun_radius, white_furnace)
    lemi = jnp.where(miss[..., None], sky, emission)
    base_color = jnp.where(miss[..., None], 0.0, base_color)

    return {
        "miss": miss,
        "t": jnp.where(miss, T_MAX, t),
        "x": x,
        "v": view,
        "n": n_smooth,
        "n_geom": n_geom,
        "tangent": tangent,
        "uv": uv,
        "mat": mat,
        "tri": hit["tri"],
        "base_color": base_color,
        "roughness": roughness,
        "metalness": metalness,
        "lemi": lemi,
        "flags": flags,
        # curvature from vertex-normal divergence across the triangle edges
        # (RaytracingShared.hlsli:382-386): |dN|/|dX| per edge, worst edge
        # geometric term (vertex-normal divergence, RaytracingShared.hlsli:
        # 382-386) + normal-map local term (:476-479)
        "curvature": jnp.where(
            miss, 0.0,
            jnp.maximum(
                geo.length(tn1 - tn0) * geo.positive_rcp(geo.length(e1)),
                geo.length(tn2 - tn0) * geo.positive_rcp(geo.length(e2)),
            ) + local_curv,
        ),
        "mip": mip,
    }


def apply_overrides(props: dict, roughness_override, metalness_override) -> dict:
    """Settings-driven material overrides (UpdateConstantBuffer plumbs
    gRoughnessOverride/gMetalnessOverride; GetMaterialProps applies them)."""
    out = dict(props)
    out["roughness"] = jnp.clip(props["roughness"] + roughness_override, 0.0, 1.0)
    out["metalness"] = jnp.clip(props["metalness"] + metalness_override, 0.0, 1.0)
    return out
