"""TraceTransparent — full-rate glass pass.

Reference: Shaders/TraceTransparent.cs.hlsl (243 LoC): re-cast the primary ray
against the transparent TLAS limited by the opaque hit distance (193-198); on a
glass hit, trace TWO delta chains — one starting as reflection, one as
refraction — each up to PT_DELTA_BOUNCES_NUM Fresnel-driven bounces with
Beer-Lambert absorption inside the medium (37-169), each ending with the
radiance cascade; combine with the Fresnel split and overwrite the composed
color (else passthrough).

Wavefront form: both chains run as masked lockstep loops over all pixels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nrdsample_tpu import config as cfgmod
from nrdsample_tpu.config import RenderConfig, Settings
from nrdsample_tpu.mathlib import geometry as geo, rng
from nrdsample_tpu.ops import traversal
from nrdsample_tpu.render import gbuffer, lighting
from nrdsample_tpu.scene import camera as cam_mod
from nrdsample_tpu.scene.types import Camera, Scene

# absorption color inside glass (np constant: module import may happen inside
# a jit trace, where a module-level jnp.array would capture the tracer context)
import numpy as _np

GLASS_TINT = _np.array([0.9, 0.95, 1.0], _np.float32)


def _closest_hit_world(ctxs: traversal.SceneContexts, o, d, t_max=traversal.T_MAX):
    """Closest hit against opaque+transparent (GEOMETRY_ALL mask)."""
    a = traversal.closest_hit(ctxs.opaque, o, d, t_max=t_max)
    if ctxs.transparent is None:
        return a
    b = traversal.closest_hit(ctxs.transparent, o, d, t_max=t_max)
    take_b = b["t"] < a["t"]
    return {k: jnp.where(take_b, b[k], a[k]) for k in a}


def _fresnel_dielectric(cos_i, eta):
    """Exact dielectric Fresnel for unpolarized light; eta = n_t / n_i."""
    cos_i = jnp.clip(jnp.abs(cos_i), 0.0, 1.0)
    sin2_t = (1.0 - cos_i**2) / jnp.maximum(eta**2, 1e-6)
    tir = sin2_t > 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t) + 1e-12)
    rs = (cos_i - eta * cos_t) / jnp.maximum(cos_i + eta * cos_t, 1e-9)
    rp = (eta * cos_i - cos_t) / jnp.maximum(eta * cos_i + cos_t, 1e-9)
    f = 0.5 * (rs * rs + rp * rp)
    return jnp.where(tir, 1.0, jnp.clip(f, 0.0, 1.0))


def _delta_chain(ctxs, scene, cfg: RenderConfig, settings, frame, pixel_idx,
                 origin, direction, start_mask, start_is_reflection,
                 glass_props, sun_dir, tan_sun, unproject, cam, sharc_state=None):
    """One delta chain from the first glass hit. Returns radiance.

    Shadow scheme: each lane ends its chain AT MOST ONCE (alive &= hit_is_glass),
    so the end-of-chain sun visibility is deferred — the shade point is latched
    at the ending bounce, both shadow outcomes of the radiance are accumulated
    (rad0/rad1), and ONE batched any-hit launch after the loop selects between
    them. This collapses delta_bounce_num traversal launches into one — the
    same deferred-binary-shadow replay trace_opaque uses (vs the per-bounce
    shadow of TraceTransparent.cs.hlsl:37-169 on SIMT hardware)."""
    n_px = origin.shape[0]
    f32 = cfg.dtype
    ior = scene.materials.ior[glass_props["mat"]]

    # first event at the known glass hit
    props = glass_props
    inside = jnp.zeros((n_px,), bool)
    throughput = jnp.ones((n_px, 3), f32)
    rad0 = jnp.zeros((n_px, 3), f32)   # radiance if shadowed
    rad1 = jnp.zeros((n_px, 3), f32)   # radiance if lit
    alive = start_mask
    # latched end-of-chain shade point for the deferred shadow launch
    end_x = origin
    end_n = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], f32), origin.shape)
    end_shadowable = jnp.zeros((n_px,), bool)

    # bounce loop as lax.scan (compile-cost: one body instead of
    # delta_bounce_num unrolled traversals; identical math/order)
    def bounce_body(carry, bounce):
        (props, inside, throughput, rad0, rad1, alive, end_x, end_n,
         end_shadowable) = carry
        dim = 700_000 + 1000 * bounce
        n = props["n"]
        v = props["v"]
        cos_i = geo.dot3(v, n)
        eta = jnp.where(inside, 1.0 / ior, ior)  # n_t / n_i at this interface
        f = _fresnel_dielectric(cos_i, eta)

        # bounce 0: the chain id fixes the first event (reflection vs
        # refraction, Fresnel-weighted); later bounces: Fresnel-driven
        # stochastic choice (TraceTransparent.cs.hlsl:50-70), probability
        # cancels the weight
        first = bounce == 0
        rnd = rng.uniform1(pixel_idx, frame, dim)
        reflect_now = jnp.where(first, start_is_reflection, rnd < f)
        w = jnp.where(first, jnp.where(reflect_now, f, 1.0 - f),
                      jnp.ones_like(f))

        ray_refl = geo.reflect(-v, n)
        # refraction: incident = -v, relative index n_i/n_t = 1/eta
        ray_refr = geo.refract(-v, n, 1.0 / jnp.maximum(eta, 1e-6))
        tir = geo.length(ray_refr) < 0.5
        reflect_now = reflect_now | tir
        ray = jnp.where(reflect_now[..., None], ray_refl, geo.normalize(ray_refr))
        throughput = throughput * w[..., None]

        # crossing the interface flips the medium
        inside = jnp.where(alive & jnp.logical_not(reflect_now),
                           jnp.logical_not(inside), inside)

        s = jnp.where(geo.dot3(ray, props["n_geom"]) >= 0, 1.0, -1.0)
        view_z = cam_mod.world_to_view_z(cam, props["x"])
        xo = geo.offset_ray(
            props["x"], props["n_geom"] * s[..., None], view_z, unproject,
            cfgmod.PT_GLASS_RAY_OFFSET,
        )
        hit = _closest_hit_world(ctxs, xo, ray)
        new_props = gbuffer.decode_hit(
            scene, hit, xo, ray, sun_dir, tan_sun, cfg.use_white_furnace,
            settings.emission_intensity,
            forced_material=settings.forced_material,
            use_normal_map=settings.use_normal_map,
            emission_scale_cubes=settings.emission_intensity_cubes,
        )

        # Beer-Lambert absorption through the medium (TraceTransparent:81-84)
        seg = jnp.where(new_props["miss"], 0.0, new_props["t"])
        absorb = jnp.exp(
            -seg[..., None] * (1.0 - GLASS_TINT) * 2.0
        )
        throughput = jnp.where(
            (inside & alive)[..., None], throughput * absorb, throughput
        )

        hit_flags = new_props["flags"]
        hit_is_glass = (hit_flags & cfgmod.FLAG_TRANSPARENT) != 0
        hit_is_glass = hit_is_glass & jnp.logical_not(new_props["miss"])

        # chain ends on a non-glass hit or miss: shade with the cascade,
        # computed for BOTH shadow outcomes (visibility resolved after the loop)
        ended = alive & jnp.logical_not(hit_is_glass)
        direct = lighting.direct_sun_lighting(
            new_props["n"], new_props["v"], new_props["base_color"],
            new_props["metalness"], new_props["roughness"], sun_dir, tan_sun,
            cfg.use_white_furnace,
        )
        l_end0 = new_props["lemi"]                       # shadowed (or miss)
        l_end1 = jnp.where(
            new_props["miss"][..., None],
            new_props["lemi"],
            direct + new_props["lemi"],
        )
        shadow_dep = jnp.logical_not(new_props["miss"])  # needs a shadow ray
        if sharc_state is not None:
            # radiance cascade at the chain end (TraceTransparent.cs.hlsl:94-165):
            # prefer the L2 cache (has multi-bounce light) over analytic direct
            from nrdsample_tpu.ops import sharc as sharc_mod

            rad, found = sharc_mod.query(
                sharc_state, new_props["x"], new_props["n"], cam.position,
                dither=rng.uniform1(pixel_idx, frame, dim + 7),
            )
            use = found & jnp.logical_not(new_props["miss"])
            l_end0 = jnp.where(use[..., None], rad + new_props["lemi"], l_end0)
            l_end1 = jnp.where(use[..., None], rad + new_props["lemi"], l_end1)
            shadow_dep = shadow_dep & jnp.logical_not(use)
        rad0 = rad0 + jnp.where(ended[..., None], throughput * l_end0, 0.0)
        rad1 = rad1 + jnp.where(ended[..., None], throughput * l_end1, 0.0)
        latch = (ended & shadow_dep)[..., None]
        end_x = jnp.where(latch, new_props["x"], end_x)
        end_n = jnp.where(latch, new_props["n_geom"], end_n)
        end_shadowable = end_shadowable | (ended & shadow_dep)
        alive = alive & hit_is_glass
        return (new_props, inside, throughput, rad0, rad1, alive, end_x,
                end_n, end_shadowable), None

    carry = (props, inside, throughput, rad0, rad1, alive, end_x, end_n,
             end_shadowable)
    carry, _ = jax.lax.scan(
        bounce_body, carry, jnp.arange(cfg.delta_bounce_num, dtype=jnp.int32)
    )
    (props, inside, throughput, rad0, rad1, alive, end_x, end_n,
     end_shadowable) = carry

    # ---- ONE deferred shadow launch for all chain ends ----
    vz = cam_mod.world_to_view_z(cam, end_x)
    sxo, sdir = lighting.sun_shadow_ray_params(
        end_x, end_n, sun_dir, tan_sun, pixel_idx, frame, unproject, vz,
        dim=700_777,
    )
    blocked = traversal.any_hit(
        ctxs.opaque, sxo, sdir, jnp.full((n_px,), traversal.T_MAX),
        coherent=False,
    )
    lit = jnp.logical_not(blocked) | jnp.logical_not(end_shadowable)
    lit = lit | (settings.disable_shadows > 0)
    return jnp.where(lit[..., None], rad1, rad0)


def trace_transparent_color(ctxs: traversal.SceneContexts, scene: Scene,
                            cam: Camera, cfg: RenderConfig, settings: Settings,
                            frame, gb: dict, pixel_idx, sharc_state=None):
    """The traversal part of the glass pass: returns (glass_color, glass_mask)
    without touching the composed image — callers overlay with
    `where(mask, color, composed)`. Split out so the trace phase can run
    sharded while the overlay happens image-side (pipeline.frame two phases)."""
    sun_dir = cfgmod.sun_direction(settings)
    tan_sun = jnp.tan(jnp.deg2rad(settings.sun_angular_diameter * 0.5))
    unproject = cam_mod.unproject_scale(cam, cfg.height)

    origin, direction, _ = cam_mod.camera_rays(
        cam, cfg.width, cfg.height, pixel_idx, frame
    )
    t_opaque = gb["primary_t"]
    hit = traversal.closest_hit(ctxs.transparent, origin, direction, t_max=t_opaque)
    glass = hit["tri"] >= 0
    props = gbuffer.decode_hit(
        scene, hit, origin, direction, sun_dir, tan_sun, cfg.use_white_furnace,
        settings.emission_intensity,
        forced_material=settings.forced_material,
            use_normal_map=settings.use_normal_map,
            emission_scale_cubes=settings.emission_intensity_cubes,
    )

    # BOTH delta chains (reflection + refraction, TraceTransparent.cs.hlsl:
    # 37-169) in ONE batched wavefront: chain id selects the first event; the
    # per-bounce traversal launches then cover 2N rays each instead of
    # launching the whole chain twice (halves the glass-pass launch count)
    def cat(a):
        return jnp.concatenate([a, a], axis=0)

    props2 = {k: cat(v) for k, v in props.items()}
    both = _delta_chain(
        ctxs, scene, cfg, settings, frame,
        jnp.concatenate([pixel_idx, pixel_idx + cfg.n_pixels], axis=0),
        cat(origin), cat(direction), cat(glass),
        jnp.concatenate([jnp.ones_like(glass), jnp.zeros_like(glass)], axis=0),
        props2, sun_dir, tan_sun, unproject, cam, sharc_state,
    )
    n_px = glass.shape[0]
    glass_color = both[:n_px] + both[n_px:]
    return glass_color, glass


@jax.named_scope("trace_transparent")
def trace_transparent(ctxs: traversal.SceneContexts, scene: Scene, cam: Camera,
                      cfg: RenderConfig, settings: Settings, frame,
                      composed: jnp.ndarray, gb: dict, pixel_idx,
                      sharc_state=None):
    """Overlay glass on the composed image. Returns (color, glass_mask)."""
    if ctxs.transparent is None:
        return composed, jnp.zeros(composed.shape[:-1], bool)
    glass_color, glass = trace_transparent_color(
        ctxs, scene, cam, cfg, settings, frame, gb, pixel_idx, sharc_state
    )
    return jnp.where(glass[..., None], glass_color, composed), glass
