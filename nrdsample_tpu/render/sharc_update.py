"""SharcUpdate — the 1/5-resolution cache-population tracer.

Reference: Shaders/SharcUpdate.cs.hlsl (250 LoC): at SHARC_DOWNSCALE=5 reduced
resolution, trace a primary ray (+ delta chain) then up to
SHARC_PROPAGATION_DEPTH=4 propagation bounces, calling SharcUpdateHit at every
vertex so each cache cell accumulates the full outgoing radiance estimate from
the remainder of the path (20-220). The PREV-frame gradient retrace (222-250)
feeds history confidence — see render/confidence.py.

Wavefront form: forward-trace recording per-vertex (position, normal, direct
light, segment throughput), then a backward sweep composes suffix radiances and
one batched scatter updates the hash grid.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nrdsample_tpu import config as cfgmod
from nrdsample_tpu.config import RenderConfig, Settings
from nrdsample_tpu.mathlib import color, geometry as geo, rng, sampling
from nrdsample_tpu.ops import sharc, traversal
from nrdsample_tpu.render import gbuffer, lighting
from nrdsample_tpu.scene import camera as cam_mod
from nrdsample_tpu.scene.types import Camera, Scene


def _delta_walk(ctxs: traversal.SceneContexts, scene: Scene, origin, direction,
                pixel_idx, frame, delta_bounces: int):
    """FULL-mode prologue: jump the probe ray through glass delta events
    (SharcUpdate.cs.hlsl:41-69) so the cache populates BEHIND/THROUGH glass.
    Fresnel-driven reflect/refract per layer; lanes that never meet glass keep
    their original ray. Returns (origin, direction) of the post-glass ray."""
    from nrdsample_tpu.render.trace_transparent import _fresnel_dielectric

    tctx = ctxs.transparent
    tr = tctx.tris
    o, d = origin, direction
    inside = jnp.zeros(origin.shape[:1], bool)
    active = jnp.ones(origin.shape[:1], bool)

    def body(carry, bounce):
        o, d, inside, active = carry
        hit_t = traversal.closest_hit(tctx, o, d)
        hit_o = traversal.closest_hit(ctxs.opaque, o, d)
        glass = (hit_t["tri"] >= 0) & (hit_t["t"] < hit_o["t"]) & active
        tri_local = jnp.maximum(hit_t["tri"] - tctx.tri_offset, 0)
        n_geom = geo.normalize(geo.cross(tr.e1[tri_local], tr.e2[tri_local]))
        # orient against the ray
        n_geom = jnp.where(geo.dot3(n_geom, d)[..., None] > 0, -n_geom, n_geom)
        ior = scene.materials.ior[tr.material[tri_local]]
        eta = jnp.where(inside, 1.0 / ior, ior)
        cos_i = jnp.abs(geo.dot3(d, n_geom))
        f = _fresnel_dielectric(cos_i, eta)
        rnd = rng.uniform1(pixel_idx, frame, 820_000 + 1000 * bounce)
        reflect_now = rnd < f
        ray_refl = geo.reflect(d, n_geom)
        ray_refr = geo.refract(d, n_geom, 1.0 / jnp.maximum(eta, 1e-6))
        tir = geo.length(ray_refr) < 0.5
        reflect_now = reflect_now | tir
        new_d = jnp.where(reflect_now[..., None], ray_refl,
                          geo.normalize(ray_refr))
        x = o + d * hit_t["t"][..., None]
        s = jnp.where(geo.dot3(new_d, n_geom) >= 0, 1.0, -1.0)
        new_o = x + n_geom * (s * 1e-4)[..., None]
        new_inside = jnp.where(glass & jnp.logical_not(reflect_now),
                               jnp.logical_not(inside), inside)
        o = jnp.where(glass[..., None], new_o, o)
        d = jnp.where(glass[..., None], new_d, d)
        return (o, d, new_inside, glass), None

    (o, d, _, _), _ = jax.lax.scan(
        body, (o, d, inside, active),
        jnp.arange(delta_bounces, dtype=jnp.int32),
    )
    return o, d


def _trace_probe_paths(ctxs, scene: Scene, cam: Camera,
                       cfg: RenderConfig, settings: Settings, frame,
                       sidx=None, mode: str = "curr"):
    """Trace the 1/ds-res probe paths for frame index `frame` with THAT
    frame's RNG streams and camera matrices. Pure function of (scene, cam,
    settings, frame) — re-invoking it with a PREVIOUS frame index replays the
    previous frame's exact paths under CURRENT lighting, which is the
    reference's gradient mechanism (SharcUpdate.cs.hlsl:222-250: Trace(PREV)
    with the prev-frame RNG seed).

    sidx: optional (m,) probe-grid indices — under pixel sharding each device
    traces its own contiguous probe slice (sharc_update_pass gathers the
    results back to the full grid). Default: the whole grid.

    mode: "curr" = opaque primary (SharcUpdate's CURR/PREV); "full" = jump
    through glass delta events first (SharcUpdate.cs.hlsl:46: FULL traces
    PT_DELTA_BOUNCES_NUM delta events so the cache reaches through glass).

    Returns (first_l (m,3), probe_vz (m,), probe_n (m,3),
    verts (depth, m, ...) stacked per-vertex records pre-flatten,
    grad_lum (m,) gradient luminance incl. the dynamic-object term)."""
    ctxs = (
        ctxs if isinstance(ctxs, traversal.SceneContexts)
        else traversal.SceneContexts(ctxs, None)
    )
    ctx = ctxs.opaque
    ds = cfg.sharc_downscale
    sw, sh = max(cfg.width // ds, 1), max(cfg.height // ds, 1)
    n_px = sw * sh
    sun_dir = cfgmod.sun_direction(settings)
    tan_sun = jnp.tan(jnp.deg2rad(settings.sun_angular_diameter * 0.5))
    unproject = cam_mod.unproject_scale(cam, cfg.height)

    # map the low-res grid onto full-res pixels, rotating the sub-pixel offset
    # per frame so the cache sees all positions over time (SharcUpdate's
    # jittered downscale grid)
    if sidx is None:
        sidx = jnp.arange(n_px, dtype=jnp.int32)
    sx = sidx % sw
    sy = sidx // sw
    off = rng.hash_u32(sidx, frame, 9001)
    ox = (off[..., 0] % ds).astype(jnp.int32)
    oy = (off[..., 1] % ds).astype(jnp.int32)
    px = jnp.minimum(sx * ds + ox, cfg.width - 1)
    py = jnp.minimum(sy * ds + oy, cfg.height - 1)
    pixel_idx = py * cfg.width + px

    origin, direction, _ = cam_mod.camera_rays(
        cam, cfg.width, cfg.height, pixel_idx, frame, sample_dim=7
    )
    if mode == "full" and ctxs.transparent is not None:
        origin, direction = _delta_walk(
            ctxs, scene, origin, direction, pixel_idx, frame,
            cfg.delta_bounce_num,
        )

    hit = traversal.closest_hit(ctx, origin, direction)
    props = gbuffer.decode_hit(
        scene, hit, origin, direction, sun_dir, tan_sun, cfg.use_white_furnace,
        settings.emission_intensity,
        forced_material=settings.forced_material,
            use_normal_map=settings.use_normal_map,
            emission_scale_cubes=settings.emission_intensity_cubes,
    )

    alive = jnp.logical_not(props["miss"])
    probe_vz = cam_mod.world_to_view_z(cam, props["x"])
    probe_n = props["n"]

    # propagation as lax.scan (compile-cost: one traced bounce body), stacking
    # per-vertex records; the backward suffix sweep is a reverse scan.
    # grad_extra/path_w: the dynamic-object indirect-shadow term for the
    # history-confidence gradient (SharcUpdate.cs.hlsl:181-193) — lighting is
    # too noisy to catch moving shadow casters, so the hitT of a
    # static-origin -> dynamic-hit segment is converted into a pseudo-lighting
    # term that changes when the dynamic object moves.
    exposure = jnp.maximum(settings.exposure * 1e-2, 1e-3)

    def fwd_body(carry, bounce):
        props, alive, grad_extra, path_w = carry
        dim = 800_000 + 1000 * bounce
        # direct lighting at this vertex
        view_z = cam_mod.world_to_view_z(cam, props["x"])
        direct = lighting.direct_sun_lighting(
            props["n"], props["v"], props["base_color"], props["metalness"],
            props["roughness"], sun_dir, tan_sun, cfg.use_white_furnace,
        )
        shadow = lighting.sun_shadow_ray(
            ctx, props["x"], props["n_geom"], sun_dir, tan_sun, pixel_idx, frame,
            unproject, view_z, dim=dim + 5,
        )
        shadow = jnp.where(settings.disable_shadows > 0, 1.0, shadow)
        l_direct = direct * shadow[..., None] + props["lemi"]

        # diffuse propagation (SHARC propagates the diffuse field)
        rnd = rng.uniform2(pixel_idx, frame, dim + 1)
        ray_local = sampling.cosine_ray(rnd)
        ray = sampling.to_world(ray_local, props["n"])
        # lambert cosine-sampled: per-segment throughput = diffuse albedo
        seg_w = props["base_color"] * (1.0 - props["metalness"][..., None])

        vert = {"x": props["x"], "n": props["n"], "l": l_direct, "w": seg_w,
                "alive": alive}
        static_origin = (props["flags"] & cfgmod.FLAG_STATIC) != 0

        xo = geo.offset_ray(
            props["x"], props["n_geom"], view_z, unproject, cfgmod.PT_BOUNCE_RAY_OFFSET
        )
        hit = traversal.closest_hit(ctx, xo, ray)
        props = gbuffer.decode_hit(
            scene, hit, xo, ray, sun_dir, tan_sun, cfg.use_white_furnace,
            settings.emission_intensity,
            forced_material=settings.forced_material,
            use_normal_map=settings.use_normal_map,
            emission_scale_cubes=settings.emission_intensity_cubes,
        )
        # dynamic-object heuristic: static origin, dynamic hit -> inject an
        # AO-style hitT term (exposure-independent, SharcUpdate.cs.hlsl:187-190)
        dyn_hit = ((props["flags"] & cfgmod.FLAG_STATIC) == 0) & jnp.logical_not(
            props["miss"]
        )
        ao = jnp.sqrt(jnp.clip(
            props["t"] / cfgmod.SHARC_GRADIENT_HITDIST_SCALE, 0.0, 1.0
        ))
        term = (1.0 - ao) * jnp.where(static_origin & dyn_hit & alive, 1.0, 0.0)
        grad_extra = grad_extra + term * path_w * 25.0 / exposure
        path_w = path_w * color.luminance(seg_w)
        alive = alive & jnp.logical_not(props["miss"])
        return (props, alive, grad_extra, path_w), vert

    depth = cfgmod.SHARC_PROPAGATION_DEPTH
    zero = jnp.zeros(origin.shape[:1], cfg.dtype)
    (props, alive, grad_extra, _), verts = jax.lax.scan(
        fwd_body, (props, alive, zero, zero + 1.0),
        jnp.arange(depth, dtype=jnp.int32),
    )

    # tail: sky/emission seen by the last segment
    l_tail = props["lemi"]

    # backward sweep: suffix radiance at each vertex (reverse scan)
    def back_body(l_next, vert):
        l_here = vert["l"] + vert["w"] * l_next
        return l_here, l_here

    _, l_heres = jax.lax.scan(
        back_body, l_tail, {"l": verts["l"], "w": verts["w"]}, reverse=True
    )

    first_l = l_heres[0]  # suffix radiance at the FIRST path vertex
    stacked = {"x": verts["x"], "n": verts["n"], "l": l_heres,
               "alive": verts["alive"]}
    grad_lum = color.luminance(first_l) + grad_extra
    return first_l, probe_vz, probe_n, stacked, grad_lum


def _rev_flat(a):
    """Flatten stacked (depth, n_px, ...) vertex records in the original
    last-vertex-first scatter order."""
    depth, n_px = a.shape[0], a.shape[1]
    return jnp.flip(a, axis=0).reshape((depth * n_px,) + a.shape[2:])


@jax.named_scope("sharc_update")
def sharc_update_pass(ctx: traversal.TraceContext, scene: Scene, cam: Camera,
                      cfg: RenderConfig, settings: Settings, frame,
                      state: sharc.SharcState,
                      probe_axis: str | None = None) -> sharc.SharcState:
    """Trace the low-res update paths and scatter radiance into the cache.

    With cfg.use_confidence, ALSO re-traces the PREVIOUS frame's probe paths
    (prev camera matrices + prev-frame RNG streams) under current lighting —
    probes["prev_retrace_lum"/"prev_retrace_vz"] feed the history-confidence
    gradient |L_prev_retraced - L_prev_stored| (SharcUpdate.cs.hlsl:222-250),
    which isolates lighting change from sampling noise (the same path is
    replayed, so the Monte-Carlo noise cancels exactly on static scenes).

    probe_axis: mesh axis name when called inside shard_map — each device
    traces 1/n of the probe grid and the results are all_gathered back to the
    full grid (bit-identical to the unsharded pass: per-probe RNG is keyed by
    probe id, and the gather restores canonical order before the scatter), so
    the table/probe planes stay replicated while the TRACE work — the
    expensive part — shards with the pixels. Without this the probe pass was
    replicated-compute on every device (round-2 review weak #9).

    With cfg.sharc_full_mode and a transparent context, a SECOND probe trace
    jumps through glass delta events before landing (FULL mode,
    SharcUpdate.cs.hlsl:46,232) and its vertices join the same cache scatter —
    this is what populates the L2 cache behind/through glass. FULL contributes
    no gradient (the reference discards FULL's return, :232)."""
    import dataclasses as dc

    ctxs = (
        ctx if isinstance(ctx, traversal.SceneContexts)
        else traversal.SceneContexts(ctx, None)
    )
    ds = cfg.sharc_downscale
    sw, sh = max(cfg.width // ds, 1), max(cfg.height // ds, 1)
    n_px = sw * sh

    if probe_axis is not None:
        n_dev = jax.lax.axis_size(probe_axis)
        n_loc = -(-n_px // n_dev)
        lo = jax.lax.axis_index(probe_axis) * n_loc
        sidx = lo + jnp.arange(n_loc, dtype=jnp.int32)
        valid = sidx < n_px
        sidx = jnp.minimum(sidx, n_px - 1)

        def gather_full(a, axis):
            full = jax.lax.all_gather(a, probe_axis, axis=axis, tiled=True)
            # local slices are contiguous ascending probe ids; pad entries
            # (clamped duplicates) land past n_px and are cut here
            return jax.lax.slice_in_dim(full, 0, n_px, axis=axis)
    else:
        sidx = None
        valid = None

        def gather_full(a, axis):
            return a

    def trace_full(cam_t, frame_t, mode="curr"):
        first_l, probe_vz, probe_n, stacked, grad_lum = _trace_probe_paths(
            ctxs, scene, cam_t, cfg, settings, frame_t, sidx=sidx, mode=mode
        )
        if valid is not None:
            stacked = dict(stacked, alive=stacked["alive"] & valid[None, :])
        first_l = gather_full(first_l, 0)
        probe_vz = gather_full(probe_vz, 0)
        probe_n = gather_full(probe_n, 0)
        grad_lum = gather_full(grad_lum, 0)
        stacked = {k: gather_full(v, 1) for k, v in stacked.items()}
        return first_l, probe_vz, probe_n, stacked, grad_lum

    first_l, probe_vz, probe_n, stacked, grad_lum = trace_full(cam, frame)
    xs, ns = _rev_flat(stacked["x"]), _rev_flat(stacked["n"])
    ls, ms = _rev_flat(stacked["l"]), _rev_flat(stacked["alive"])
    if cfg.sharc_full_mode and ctxs.transparent is not None:
        _, _, _, stacked_f, _ = trace_full(cam, frame, mode="full")
        xs = jnp.concatenate([xs, _rev_flat(stacked_f["x"])], axis=0)
        ns = jnp.concatenate([ns, _rev_flat(stacked_f["n"])], axis=0)
        ls = jnp.concatenate([ls, _rev_flat(stacked_f["l"])], axis=0)
        ms = jnp.concatenate([ms, _rev_flat(stacked_f["alive"])], axis=0)
    # LOD transition dithering on the WRITE side too, so both rings near a
    # level boundary stay populated for the dithered queries
    lod_dither = rng.uniform1(jnp.arange(xs.shape[0], dtype=jnp.int32), frame, 800_077)
    state = sharc.update(state, xs, ns, ls, cam.position, frame, mask=ms,
                         dither=lod_dither)

    # probe "small G-buffer" for the history-confidence gradient
    # (SharcUpdate.cs.hlsl:104-107 luminance+normal+viewZ store; the gradient
    # consumer is denoise/confidence.py): first-vertex suffix radiance +
    # primary viewZ/normal at probe resolution. grad_lum additionally carries
    # the dynamic-object indirect-shadow term (:181-193).
    probes = {
        "radiance": first_l.reshape(sh, sw, 3),
        "grad_lum": grad_lum.reshape(sh, sw),
        "view_z": probe_vz.reshape(sh, sw),
        "normal": probe_n.reshape(sh, sw, 3),
    }
    if cfg.use_confidence:
        prev_cam = dc.replace(
            cam, view_to_world=cam.view_to_world_prev, jitter=cam.jitter_prev
        )
        _, prev_vz, _, _, prev_grad_lum = trace_full(prev_cam, frame - 1)
        probes["prev_retrace_lum"] = prev_grad_lum.reshape(sh, sw)
        probes["prev_retrace_vz"] = prev_vz.reshape(sh, sw)
    return sharc.resolve(state, frame), probes
