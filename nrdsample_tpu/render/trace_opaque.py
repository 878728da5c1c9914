"""TraceOpaque — the main per-pixel path tracer, re-designed wavefront-style.

Reference: Shaders/TraceOpaque.cs.hlsl (805 LoC): primary ray -> G-buffer ->
`TraceOpaque()` path loop (95-476) with probabilistic lobe split, importance
sampling, throughput-threshold termination (no Russian roulette — the reference
itself calls RR bad practice, 238-268), radiance cascade at every hit, and
NRD-oriented hit-distance accumulation.

Re-design: the per-pixel megakernel loop becomes a *batched wavefront*: all
N = H*W rays advance in lockstep through a statically-unrolled bounce loop with
an `alive` mask (static shapes for XLA; divergence is masked lanes, SURVEY.md
§7.3.5). Paths (rpp) are a python loop accumulating into the same buffers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nrdsample_tpu import config as cfgmod
from nrdsample_tpu.config import Denoiser, RenderConfig, Settings, TracingMode
from nrdsample_tpu.mathlib import brdf, color, geometry as geo, rng, sampling
from nrdsample_tpu.ops import traversal
from nrdsample_tpu.render import gbuffer, lighting
from nrdsample_tpu.scene import camera as cam_mod
from nrdsample_tpu.scene.types import Camera, Scene

_HI = jax.lax.Precision.HIGHEST  # full f32 products (no TF32 on GPUs)


def _shadow_rnd(cfg: RenderConfig, pixel_idx, frame, dim: int):
    """USE_BLUE_NOISE_FOR_SHADOWS (Shared.hlsli:25, "a must have for SIGMA"):
    blue-noise disc sample for the sun-shadow cone. Returns None (= default
    white PCG stream) under REFERENCE accumulation, matching the reference's
    gate — temporal accumulation wants an equidistributed per-pixel sequence,
    not a spatially-shaped one."""
    if not cfg.use_blue_noise or cfg.denoiser == Denoiser.REFERENCE:
        return None
    from nrdsample_tpu.mathlib import bluenoise

    return bluenoise.blue2(pixel_idx, cfg.width, frame, dim)


def estimate_diffuse_probability(props: dict, use_magic_boost: bool = False):
    """EstimateDiffuseProbability (RaytracingShared.hlsli:980-1009)."""
    albedo, f0 = brdf.base_color_to_f0_albedo(props["base_color"], props["metalness"])
    n_dot_v = jnp.abs(geo.dot3(props["n"], props["v"]))
    f_env = brdf.environment_term_rtg(f0, n_dot_v, props["roughness"])
    lum_spec = color.luminance(f_env)
    lum_diff = color.luminance(albedo * (1.0 - f_env))
    p = lum_diff / jnp.maximum(lum_diff + lum_spec, 1e-6)
    if use_magic_boost:
        f = 1.0 - jnp.exp2(-200.0 * props["roughness"] ** 2)
        f = f * geo.pow01(props["roughness"], 0.5)
        p = p + (1.0 - p) * f
    p = jnp.where(p < cfgmod.PT_EVIL_TWIN_LOBE_TOLERANCE, 0.0, p)
    p = jnp.where(p > 1.0 - cfgmod.PT_EVIL_TWIN_LOBE_TOLERANCE, 1.0, p)
    return p


def _burley_diffuse_term(roughness, n_dot_l, n_dot_v, v_dot_h):
    """BRDF::DiffuseTerm_Burley (Disney diffuse), including the 1/pi."""
    f90 = 0.5 + 2.0 * roughness * v_dot_h**2
    fl = 1.0 + (f90 - 1.0) * (1.0 - n_dot_l) ** 5
    fv = 1.0 + (f90 - 1.0) * (1.0 - n_dot_v) ** 5
    return fl * fv / sampling.PI


def generate_ray_and_update_throughput(props: dict, throughput: jnp.ndarray,
                                       is_diffuse: jnp.ndarray, pixel_idx, frame,
                                       dim: int, trim_lobe: bool = True,
                                       em_set: dict | None = None,
                                       n_candidates: int = 1,
                                       use_translucency: bool = False):
    """GenerateRayAndUpdateThroughput (RaytracingShared.hlsli:725-924), minus
    hair. With `em_set` + n_candidates > 1 the direction comes
    from the emissive-IS weighted reservoir (16-candidate light probing,
    RaytracingShared.hlsli:750-839) and throughput gains its multiplier.

    use_translucency enables the leaf-transmit branch
    (RaytracingShared.hlsli:728, :866-878): diffuse samples on FLAG_LEAF
    geometry become a flipped cosine lobe with probability LEAF_TRANSLUCENCY,
    weighted pow01(albedo, 1.2)/p (chlorophyll tint); the non-transmitted leaf
    diffuse divides by 1-p. IS candidates are light-checked in the reflection
    frame (the reference flips the check ray, :796-801 — approximation here).

    Returns (ray_world [N,3], throughput' [N,3], shading_n' [N,3],
    is_transmission [N] bool).
    """
    n = props["n"]
    v = props["v"]
    v_local = sampling.to_local(v, n)
    trim = cfgmod.PT_SPEC_LOBE_ENERGY if trim_lobe else 1.0

    if em_set is not None and n_candidates > 1:
        from nrdsample_tpu.denoise.reblur import spec_magic_curve
        from nrdsample_tpu.render import emissive_is

        ray_local, mult = emissive_is.reservoir_sample_direction(
            props, em_set, is_diffuse, pixel_idx, frame, dim + 50,
            n_candidates, trim, spec_k_scale=spec_magic_curve(props["roughness"]),
        )
        throughput = throughput * mult[..., None]
    else:
        rnd = rng.uniform2(pixel_idx, frame, dim)
        ray_diff_local = sampling.cosine_ray(rnd)
        h_local = sampling.vndf_ggx(rnd, v_local, props["roughness"], trim)
        ray_spec_local = geo.reflect(-v_local, h_local)
        ray_local = jnp.where(is_diffuse[..., None], ray_diff_local, ray_spec_local)

    if use_translucency:
        is_leaf = (props["flags"] & cfgmod.FLAG_LEAF) > 0
        rnd_t = rng.uniform1(pixel_idx, frame, dim + 7)
        is_transmission = is_leaf & is_diffuse & (rnd_t < cfgmod.LEAF_TRANSLUCENCY)
    else:
        is_transmission = jnp.zeros(is_diffuse.shape, bool)

    albedo, f0 = brdf.base_color_to_f0_albedo(props["base_color"], props["metalness"])
    n_dot_l = jnp.clip(ray_local[..., 2], 0.0, 1.0)
    h_full = geo.normalize(v_local + ray_local)
    v_dot_h = jnp.abs(geo.dot3(v_local, h_full))
    n_dot_v = jnp.abs(v_local[..., 2])

    # diffuse weight: albedo * pi * Kdiff  (NoL cancelled by cosine sampling)
    k_diff = _burley_diffuse_term(props["roughness"], n_dot_l, n_dot_v, v_dot_h)
    if use_translucency:
        # the reflected share of a leaf's diffuse lobe is chosen with
        # probability 1-p: compensate (RaytracingShared.hlsli:884-885)
        k_diff = jnp.where(is_leaf, k_diff / (1.0 - cfgmod.LEAF_TRANSLUCENCY),
                           k_diff)
    w_diff = albedo * (sampling.PI * k_diff)[..., None]
    # specular weight for VNDF sampling: F * G2/G1 = F * G1(L)  (separable Smith;
    # see "Sampling the GGX Distribution of Visible Normals", JCGT 2018 §6)
    f = brdf.fresnel_schlick(f0, v_dot_h)
    alpha = props["roughness"] ** 2
    w_spec = f * sampling.smith_g1(n_dot_l, alpha)[..., None]

    w = jnp.where(is_diffuse[..., None], w_diff, w_spec)
    if use_translucency:
        # Lambert transmit at 1/p weight, chlorophyll-tinted albedo^1.2
        # (RaytracingShared.hlsli:866-878; NoL and pi cancel as in diffuse)
        w_trans = geo.pow01(albedo, 1.2) / cfgmod.LEAF_TRANSLUCENCY
        w = jnp.where(is_transmission[..., None], w_trans, w)
        ray_local = jnp.where(is_transmission[..., None], -ray_local, ray_local)
    throughput = throughput * w

    ray = sampling.to_world(ray_local, n)

    # Geometric backface fixes (RaytracingShared.hlsli:904-921); transmitted
    # rays legitimately point through the surface and are exempt (:907)
    n_geom = props["n_geom"]
    n_dot_l_geom = geo.dot3(n_geom, ray)
    bad = (n_dot_l_geom < 0.0) & jnp.logical_not(is_transmission)
    rough_threshold = jnp.clip(props["roughness"] / 0.15, 0.0, 1.0)
    kill_rnd = rng.uniform1(pixel_idx, frame, dim + 1)
    kill = bad & (is_diffuse | (kill_rnd < rough_threshold))
    throughput = jnp.where(kill[..., None], 0.0, throughput)
    # patch low-roughness specular rays pointing inside the surface
    b = jnp.abs(geo.dot3(n_geom, n)) * 0.99
    patched = geo.normalize(
        ray + n_geom * (jnp.abs(n_dot_l_geom) * geo.positive_rcp(b))[..., None]
    )
    patch = bad & jnp.logical_not(kill)
    ray = jnp.where(patch[..., None], patched, ray)
    shading_n = jnp.where(patch[..., None], geo.normalize(v + ray), n)
    return ray, throughput, shading_n, is_transmission


def trace_paths(ctx: traversal.TraceContext, scene: Scene, cam: Camera,
                cfg: RenderConfig, settings: Settings, frame,
                props0: dict, pixel_idx: jnp.ndarray, sharc_state=None,
                l1_hist=None, cone0: dict | None = None,
                primary_shadow: tuple | None = None):
    """The TraceOpaque() path loop (TraceOpaque.cs.hlsl:95-476) for all pixels.

    props0: decoded primary-hit properties. Returns dict with diff/spec radiance
    (demodulated), normalized hit distances, and per-path bookkeeping.
    primary_shadow: optional (origin, direction) of the caller's primary sun
    visibility rays — batched into the single shadow launch; the resulting
    visibility comes back as out["primary_shadow"].
    """
    n_px = pixel_idx.shape[0]
    f32 = cfg.dtype
    sun_dir = cfgmod.sun_direction(settings)
    tan_sun = jnp.tan(jnp.deg2rad(settings.sun_angular_diameter * 0.5))
    unproject = cam_mod.unproject_scale(cam, cfg.height)
    view_z0 = cam_mod.world_to_view_z(cam, props0["x"])

    # de-modulation factors at the primary hit (TraceOpaque.cs.hlsl:107-114):
    # irradiance -> radiance so the denoiser works on a albedo-free signal
    albedo0, f00 = brdf.base_color_to_f0_albedo(props0["base_color"], props0["metalness"])
    n_dot_v0 = jnp.abs(geo.dot3(props0["n"], props0["v"]))
    f_env0 = brdf.environment_term_rtg(f00, n_dot_v0, props0["roughness"])
    diff_factor0 = albedo0 * (1.0 - f_env0) + 0.001
    spec_factor0 = f_env0 + 0.001

    diff_radiance = jnp.zeros((n_px, 3), f32)
    spec_radiance = jnp.zeros((n_px, 3), f32)
    diff_hitdist = jnp.zeros((n_px,), f32)
    spec_hitdist = jnp.zeros((n_px,), f32)
    diff_path_num = jnp.zeros((n_px,), f32)
    diff_dir = jnp.zeros((n_px, 3), f32)
    spec_dir = jnp.zeros((n_px, 3), f32)

    px = pixel_idx % cfg.width
    py = pixel_idx // cfg.width
    checkerboard = rng.checkerboard(px, py, frame).astype(bool)

    # emissive-IS light set (the merged-emissive BLAS analogue); built when the
    # scene has emitters and IS is enabled (USE_IMPORTANCE_SAMPLING)
    em_set = None
    n_cand = 1
    if cfg.use_importance_sampling and scene.has_emissive:
        from nrdsample_tpu.render import emissive_is

        em_set = emissive_is.build_emissive_set(
            scene, settings.emission_intensity,
            clusters=getattr(ctx, "emissive", None),
        )
        n_cand = cfg.importance_samples

    path_num = cfg.rpp * (2 if cfg.tracing_mode == TracingMode.FULL else 1)

    # Deferred-shadow scheme: shadow visibility is BINARY, so every shadow-
    # dependent quantity is precomputed for both outcomes (contrib0/contrib1)
    # and selected after ONE batched any-hit launch covering every bounce of
    # every path (+ the caller's primary shadow) — (bounces*rpp + 1) traversal
    # launches collapse into one, with better ray-binning occupancy. Exact:
    # nothing inside the loop depends on shadow except these terms.
    per_path = []

    for path in range(path_num):
        throughput = jnp.ones((n_px, 3), f32)
        alive = jnp.logical_not(props0["miss"])
        is_diffuse_path = jnp.zeros((n_px,), bool)
        first_ray = jnp.zeros((n_px, 3), f32)
        records = []  # per-bounce deferred-shadow records
        props = props0
        from nrdsample_tpu.render import raycone

        cone = cone0 if cone0 is not None else {
            "width": jnp.zeros((n_px,), f32),
            "spread": jnp.zeros((n_px,), f32),
        }

        for bounce in range(1, cfg.bounce_num + 1):
            dim_base = 10_000 * (path + 1) + 100 * bounce
            # ---- lobe selection (TraceOpaque.cs.hlsl:178-204) ----
            diffuse_prob = estimate_diffuse_probability(props)
            diffuse_prob = (diffuse_prob != 0.0) * jnp.clip(
                diffuse_prob, settings.min_probability, 1.0 - settings.min_probability
            )
            rnd_lobe = rng.uniform1(pixel_idx, frame, dim_base)
            if bounce == 1 and cfg.tracing_mode == TracingMode.FULL_PROBABILISTIC:
                # guarantee a sample in a 3x3 area for the 1st bounce: Bayer +
                # screen-uniform Weyl decorrelation (TraceOpaque.cs.hlsl:189-197)
                bayer = rng.bayer4x4(px, py, 0)
                jitter = rng.weyl1d(frame)
                rnd_lobe = jnp.mod(bayer + jitter, 1.0)
            is_diffuse = rnd_lobe < diffuse_prob
            if cfg.tracing_mode == TracingMode.FULL_PROBABILISTIC or bounce > 1:
                sel_pdf = jnp.where(is_diffuse, diffuse_prob, 1.0 - diffuse_prob)
                throughput = throughput / jnp.maximum(sel_pdf, 1e-6)[..., None]
            elif cfg.tracing_mode == TracingMode.HALF:
                is_diffuse = checkerboard
            else:  # FULL: alternate paths
                is_diffuse = jnp.full((n_px,), bool(path & 1))

            if bounce == 1:
                is_diffuse_path = is_diffuse

            # ---- ray generation + throughput (incl. emissive IS when enabled;
            # USE_IS_FOR_ALL_BOUNCES=1 in the reference, Shared.hlsli:24) ----
            ray, throughput, shading_n, is_trans = generate_ray_and_update_throughput(
                props, throughput, is_diffuse, pixel_idx, frame, dim_base + 2,
                em_set=em_set, n_candidates=n_cand,
                use_translucency=cfg.use_translucency,
            )
            if bounce == 1:
                first_ray = ray  # SH / DIRECTIONAL_OCCLUSION direction guide
                                 # (TraceOpaque.cs.hlsl:227-234)

            # throughput-threshold termination (TraceOpaque.cs.hlsl:266-267)
            alive = alive & (color.luminance(throughput) >= cfgmod.PT_THROUGHPUT_THRESHOLD)

            # ---- cast bounce ray (TraceOpaque.cs.hlsl:277-279) ----
            view_z = cam_mod.world_to_view_z(cam, props["x"])
            xo = geo.offset_ray(
                props["x"], props["n_geom"], view_z, unproject, cfgmod.PT_BOUNCE_RAY_OFFSET
            )
            if cfg.use_translucency:
                # transmitted rays start on the BACK side of the leaf
                # (X - LEAF_THICKNESS * N, RaytracingShared.hlsli:870)
                xo_back = props["x"] - props["n_geom"] * cfgmod.LEAF_THICKNESS
                xo = jnp.where(is_trans[..., None], xo_back, xo)
            # cone: widen at the bounce surface (curvature + roughness), grow
            # over the segment (RaytracingShared.hlsli:389-397 ray-cone mip)
            cone = raycone.reflect(
                cone, props.get("curvature", 0.0),
                jnp.where(is_diffuse, 1.0, props["roughness"]),
            )
            hit = traversal.closest_hit_alpha(ctx, scene, xo, ray, coherent=False)
            cone = raycone.propagate(cone, hit["t"])
            props = gbuffer.decode_hit(
                scene, hit, xo, ray, sun_dir, tan_sun, cfg.use_white_furnace,
                settings.emission_intensity,
                forced_material=settings.forced_material,
            use_normal_map=settings.use_normal_map,
            emission_scale_cubes=settings.emission_intensity_cubes, cone_width=cone["width"],
            )

            # ---- radiance at the hit (TraceOpaque.cs.hlsl:291-371) ----
            # cascade: emissive -> L2 SHARC (footprint-gated) -> analytic
            # lighting fallback (L1 prev-frame reprojection: render/l1cache.py)
            direct = lighting.direct_sun_lighting(
                props["n"], props["v"], props["base_color"], props["metalness"],
                props["roughness"], sun_dir, tan_sun, cfg.use_white_furnace,
                flags=props["flags"] if cfg.use_hair_sss else None,
                tangent=props["tangent"] if cfg.use_hair_sss else None,
            )
            # deferred shadow ray params (batched launch after the loop);
            # everything downstream is computed for BOTH shadow outcomes
            view_z_b = cam_mod.world_to_view_z(cam, props["x"])
            sxo, sdir = lighting.sun_shadow_ray_params(
                props["x"], props["n_geom"], sun_dir, tan_sun,
                pixel_idx, frame, unproject, view_z_b, dim=dim_base + 5,
                rnd=_shadow_rnd(cfg, pixel_idx, frame, dim_base + 5),
            )
            l_hit0 = props["lemi"]                      # shadow = 0
            l_hit1 = direct + props["lemi"]             # shadow = 1
            # Lcached starts as pure emission (Lemi; sky radiance on miss)
            l_cached = props["lemi"]
            cache_w = jnp.zeros((n_px,), f32)

            if l1_hist is not None:
                # L1 cache: prev-frame screen-space reprojection
                # (TraceOpaque.cs.hlsl:295 -> GetRadianceFromPreviousFrame)
                from nrdsample_tpu.render import l1cache

                l1, w1 = l1cache.radiance_from_previous_frame(
                    l1_hist, cam, props, pixel_idx, cfg.width, cfg.height,
                    sun_dir, settings.prev_frame_confidence,
                )
                use_l1 = (w1 > 0.0) & jnp.logical_not(props["miss"])
                l_cached = jnp.where(use_l1[..., None], l1, l_cached)
                cache_w = jnp.where(use_l1, w1, cache_w)

            if sharc_state is not None:
                # L2 SHARC lookup with footprint gating
                # (TraceOpaque.cs.hlsl:297-364)
                from nrdsample_tpu.ops import sharc as sharc_mod

                cam_pos = cam.position
                # LOD transition dithering: jitter the level rounding per
                # pixel/frame so voxel-size rings dissolve into noise the
                # temporal accumulation averages out (reference SHARC behavior)
                lod_dither = rng.uniform1(pixel_idx, frame, dim_base + 11)
                lvl = sharc_mod.grid_level(props["x"], cam_pos, dither=lod_dither)
                vs = sharc_mod.voxel_size(lvl)
                rt = jnp.where(is_diffuse, 1.0, props["roughness"])
                lobe_tan = rt * rt / (1.0 + rt * rt)
                footprint = props["t"] * lobe_tan * 2.0
                footprint_norm = jnp.clip(footprint / jnp.maximum(vs, 1e-6), 0.0, 1.0)
                gate_rnd = rng.uniform1(pixel_idx, frame, dim_base + 8)
                gate = jnp.where(
                    bounce == cfg.bounce_num, True, gate_rnd < footprint_norm
                )
                # don't override an already-confident L1 value
                # (TraceOpaque.cs.hlsl:337)
                l1_rnd = rng.uniform1(pixel_idx, frame, dim_base + 10)
                gate = gate & (l1_rnd > cache_w)
                rad, found = sharc_mod.query(
                    sharc_state, props["x"], props["n"], cam_pos,
                    dither=lod_dither,
                )
                use = found & gate & jnp.logical_not(props["miss"])
                l_cached = jnp.where(use[..., None], rad, l_cached)
                cache_w = jnp.where(use, 1.0, cache_w)

            # cache miss -> analytic lighting (TraceOpaque.cs.hlsl:367-371):
            # stochastic selection by the cascade confidence; last bounce takes
            # the max so energy is never dropped
            miss_rnd = rng.uniform1(pixel_idx, frame, dim_base + 9)
            use_analytic = (miss_rnd >= cache_w) & jnp.logical_not(props["miss"])
            if bounce < cfg.bounce_num:
                repl0, repl1 = l_hit0, l_hit1
            else:
                repl0 = jnp.maximum(l_cached, l_hit0)
                repl1 = jnp.maximum(l_cached, l_hit1)
            l_c0 = jnp.where(use_analytic[..., None], repl0, l_cached)
            l_c1 = jnp.where(use_analytic[..., None], repl1, l_cached)

            live3 = alive[..., None]
            contrib0 = l_c0 * throughput * live3
            contrib1 = l_c1 * throughput * live3
            # cache hit already contains multi-bounce light: damp the remainder
            # of the path (TraceOpaque.cs.hlsl:383)
            throughput = throughput * (1.0 - cache_w)[..., None]

            diffuse_like = estimate_diffuse_probability(props, use_magic_boost=True)
            records.append({
                "sxo": sxo, "sdir": sdir,
                "c0": contrib0, "c1": contrib1,
                "lem_thr": color.luminance(props["lemi"] * throughput),
                "diffuse_like": jnp.where(is_diffuse, 1.0, diffuse_like),
                "hit_t": jnp.where(alive, props["t"], 0.0),
                "curv": props["curvature"],
            })

            alive = alive & jnp.logical_not(props["miss"])

        per_path.append((is_diffuse_path, first_ray, records))

    # ---- ONE batched shadow launch for every pending visibility ray ----
    all_recs = [r for (_, _, recs) in per_path for r in recs]
    extra = [primary_shadow] if primary_shadow is not None else []
    if not all_recs and not extra:
        return {
            "diff_radiance": diff_radiance, "spec_radiance": spec_radiance,
            "diff_hitdist": diff_hitdist, "spec_hitdist": spec_hitdist,
            "diff_factor": diff_factor0, "spec_factor": spec_factor0,
            "diff_dir": diff_dir, "spec_dir": spec_dir,
            "primary_shadow": None, "primary_shadow_hitdist": None,
        }
    origins = jnp.concatenate(
        [r["sxo"] for r in all_recs] + [e[0] for e in extra], axis=0
    )
    dirs = jnp.concatenate(
        [r["sdir"] for r in all_recs] + [e[1] for e in extra], axis=0
    )
    blocked, hit_t = traversal.any_hit_t(
        ctx, origins, dirs, jnp.full((origins.shape[0],), traversal.T_MAX),
        coherent=False,
    )
    # disable_shadows doubles as "IS enabled" in the reference; the sun NEE
    # shadow ray is skipped then (GetLighting:675)
    vis = jnp.where(
        settings.disable_shadows > 0, 1.0, 1.0 - blocked.astype(f32)
    )
    primary_shadow_vis = vis[len(all_recs) * n_px:] if extra else None
    # closest-blocker distance of the primary sun-shadow ray — the SIGMA
    # penumbra estimate (TraceOpaque.cs.hlsl:767-804); 0 where unblocked
    primary_shadow_hitt = None
    if extra:
        seg = slice(len(all_recs) * n_px, None)
        primary_shadow_hitt = jnp.where(
            blocked[seg], hit_t[seg], 0.0
        ).astype(f32)

    # ---- replay: select contribs by visibility, rebuild the accumulation ----
    rec_i = 0
    for is_diff, first_ray, recs in per_path:
        lsum = jnp.zeros((n_px, 3), f32)
        acc_hitdist = jnp.zeros((n_px,), f32)
        acc_diffuse_like_motion = jnp.zeros((n_px,), f32)
        acc_curvature = jnp.zeros((n_px,), f32)
        for r in recs:
            s = vis[rec_i * n_px:(rec_i + 1) * n_px]
            rec_i += 1
            contrib = jnp.where(s[..., None] > 0.5, r["c1"], r["c0"])
            lsum = lsum + contrib
            # ---- NRD hit-distance accumulation (TraceOpaque.cs.hlsl:385-397) ----
            a = color.luminance(contrib)
            b = color.luminance(lsum)
            importance = a / (b + 1e-6)
            importance = importance * (1.0 - r["lem_thr"] / (a + 1e-6))
            thin_lens = r["hit_t"] / (2.0 * acc_curvature * r["hit_t"] + 1.0)
            acc_hitdist = acc_hitdist + thin_lens * geo.smoothstep(
                0.2, 0.0, acc_diffuse_like_motion
            )
            acc_diffuse_like_motion = acc_diffuse_like_motion + 1.0 - importance * (
                1.0 - r["diffuse_like"]
            )
            acc_curvature = acc_curvature + r["curv"]

        # ---- accumulate per-path results (TraceOpaque.cs.hlsl:423-447) ----
        diff_radiance = diff_radiance + jnp.where(is_diff[..., None], lsum, 0.0)
        spec_radiance = spec_radiance + jnp.where(is_diff[..., None], 0.0, lsum)
        diff_hitdist = diff_hitdist + jnp.where(is_diff, acc_hitdist, 0.0)
        spec_hitdist = spec_hitdist + jnp.where(is_diff, 0.0, acc_hitdist)
        diff_path_num = diff_path_num + is_diff.astype(f32)
        # luminance-weighted first-bounce direction (SH-mode guide,
        # TraceOpaque.cs.hlsl:470-473)
        wdir = color.luminance(lsum)[..., None] + 1e-6
        diff_dir = diff_dir + jnp.where(is_diff[..., None], first_ray * wdir, 0.0)
        spec_dir = spec_dir + jnp.where(is_diff[..., None], 0.0, first_ray * wdir)

    # demodulation + averaging (TraceOpaque.cs.hlsl:449-468)
    radiance_norm = 1.0 / float(cfg.rpp)
    diff_radiance = diff_radiance / diff_factor0 * radiance_norm
    spec_radiance = spec_radiance / spec_factor0 * radiance_norm
    # indirect kill switches (NRDSample.cpp Settings.indirectDiffuse /
    # indirectSpecular): zero the traced indirect signal, debug ergonomics
    diff_radiance = diff_radiance * settings.indirect_diffuse.astype(f32)
    spec_radiance = spec_radiance * settings.indirect_specular.astype(f32)
    if cfg.use_moving_emission_fix:
        # USE_MOVING_EMISSION_FIX (TraceOpaque.cs.hlsl:714-718): primary
        # emission /2pi rides in BOTH denoised signals (post-demodulation,
        # like the reference) so a moving emitter's reprojected history stays
        # lit where the emitter just was instead of leaving a dark tail
        emi0 = jnp.where(props0["miss"][..., None], 0.0, props0["lemi"])
        emi0 = emi0 / (2.0 * jnp.pi)
        diff_radiance = diff_radiance + emi0
        spec_radiance = spec_radiance + emi0
    diff_norm = jnp.where(diff_path_num > 0, 1.0 / jnp.maximum(diff_path_num, 1.0), 0.0)
    spec_cnt = path_num - diff_path_num
    spec_norm = jnp.where(spec_cnt > 0, 1.0 / jnp.maximum(spec_cnt, 1.0), 0.0)
    return {
        "diff_radiance": diff_radiance,
        "spec_radiance": spec_radiance,
        "diff_hitdist": diff_hitdist * diff_norm,
        "spec_hitdist": spec_hitdist * spec_norm,
        "diff_factor": diff_factor0,
        "spec_factor": spec_factor0,
        "diff_dir": diff_dir * diff_norm[..., None],
        "spec_dir": spec_dir * spec_norm[..., None],
        "primary_shadow": primary_shadow_vis,
        "primary_shadow_hitdist": primary_shadow_hitt,
    }


def is_delta(props: dict) -> jnp.ndarray:
    """IsDelta (RaytracingShared.hlsli:973-978): mirror-like surfaces that PSR
    can walk through."""
    dark = jnp.sum(props["base_color"] * jnp.array([0.2126, 0.7152, 0.0722]), -1) < 0.005
    return (
        (props["roughness"] < 0.041)
        & ((props["metalness"] > 0.941) | dark)
        & jnp.logical_not(props["miss"])
    )


def psr_walk(ctx, scene, cfg, settings, frame, pixel_idx, props, view_z, cam,
             sun_dir, tan_sun, unproject):
    """Primary Surface Replacement mirror walk (TraceOpaque.cs.hlsl:569-603):
    follow up to cfg.psr_bounce_num delta (mirror) bounces; the G-buffer then
    describes the *virtual* surface seen in the mirror, which denoisers track
    far better than the mirror itself.

    Returns (props', l_psr, psr_throughput, virt_dist, mirror_matrix):
    virt_dist is the curvature-corrected accumulated virtual hit distance
    (ApplyThinLensEquation per bounce, TraceOpaque.cs.hlsl:598-601) used by the
    caller to place the virtual surface Xvirtual = X0 - V0 * virt_dist for
    viewZ/MV; mirror_matrix (N, 3, 3) is the accumulated householder product
    whose inverse (= transpose) unfolds the virtual surface normal into
    camera space (TraceOpaque.cs.hlsl:636-638).
    """
    n_px = pixel_idx.shape[0]
    f32 = cfg.dtype
    l_psr = jnp.zeros((n_px, 3), f32)
    throughput = jnp.ones((n_px, 3), f32)
    virt_dist = jnp.zeros((n_px,), f32)
    acc_curv = jnp.zeros((n_px,), f32)
    mirror_mat = jnp.broadcast_to(jnp.eye(3, dtype=f32), (n_px, 3, 3))
    for k in range(cfg.psr_bounce_num):
        delta = is_delta(props)
        # accumulate curvature at the origin point ("yes, before hit")
        acc_curv = jnp.where(delta, acc_curv + props["curvature"], acc_curv)
        # accumulate the mirror (householder) matrix: M = (I - 2 n n^T) @ M
        n_s = props["n"]
        house = (
            jnp.broadcast_to(jnp.eye(3, dtype=f32), (n_px, 3, 3))
            - 2.0 * n_s[:, :, None] * n_s[:, None, :]
        )
        mirror_mat = jnp.where(
            delta[:, None, None],
            jnp.einsum("nij,njk->nik", house, mirror_mat, precision=_HI),
            mirror_mat,
        )
        # mirror reflection with Fresnel throughput
        _, f0 = brdf.base_color_to_f0_albedo(props["base_color"], props["metalness"])
        cos_i = jnp.abs(geo.dot3(props["v"], props["n"]))
        f = brdf.fresnel_schlick(f0, cos_i)
        ray = geo.reflect(-props["v"], props["n"])
        vz = cam_mod.world_to_view_z(cam, props["x"])
        xo = geo.offset_ray(
            props["x"], props["n_geom"], vz, unproject, cfgmod.PT_BOUNCE_RAY_OFFSET
        )
        hit = traversal.closest_hit(ctx, xo, ray)
        new_props = gbuffer.decode_hit(
            scene, hit, xo, ray, sun_dir, tan_sun, cfg.use_white_furnace,
            settings.emission_intensity,
            forced_material=settings.forced_material,
            use_normal_map=settings.use_normal_map,
            emission_scale_cubes=settings.emission_intensity_cubes,
        )
        # accumulate emission seen through the mirror chain
        new_throughput = throughput * f
        l_new = l_psr + new_throughput * new_props["lemi"] * jnp.logical_not(
            new_props["miss"]
        )[..., None]
        # select per-lane: only delta lanes advance
        sel = delta[..., None]
        props = {
            k2: jnp.where(
                sel if new_props[k2].ndim == 2 else delta, new_props[k2], props[k2]
            )
            for k2 in props
        }
        throughput = jnp.where(sel, new_throughput, throughput)
        l_psr = jnp.where(sel, l_new, l_psr)
        # thin-lens correction: curved mirrors move the virtual image off the
        # unfolded distance (ApplyThinLensEquation, Shared.hlsli:313)
        thin = new_props["t"] / (2.0 * acc_curv * new_props["t"] + 1.0)
        virt_dist = jnp.where(delta, virt_dist + thin, virt_dist)
    return props, l_psr, throughput, virt_dist, mirror_mat


def trace_opaque(ctx: traversal.TraceContext, scene: Scene, cam: Camera,
                 cfg: RenderConfig, settings: Settings, frame,
                 pixel_idx: jnp.ndarray | None = None, sharc_state=None,
                 l1_hist=None, dynamics=None):
    """Full TraceOpaque pass: primary ray + G-buffer + indirect path loop.

    Mirrors TraceOpaque.cs.hlsl `main` (521-805): primary cast, G-buffer writes,
    direct lighting, SIGMA shadow inputs, then the path loop. PSR mirror walk is
    applied when cfg.psr_bounce_num > 0 (delta chain).

    `pixel_idx` (flat indices) lets callers shard the pixel dimension across a
    device mesh (SURVEY.md §2.4: tile/ray data-parallel sharding).

    `dynamics` — optional (InstancedScene, m_curr, m_prev) with (I, 3, 4)
    per-instance transforms: enables TRUE moving-object motion vectors via the
    worldToWorldPrev path (Xprev = M_prev M_curr^-1 X per hit instance;
    Source/NRDSample.cpp:3395-3630, Shaders/TraceOpaque.cs.hlsl:610-614).
    Without it, Xprev = X (camera motion only, static scenes).
    """
    if pixel_idx is None:
        pixel_idx = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    n_px = pixel_idx.shape[0]
    sun_dir = cfgmod.sun_direction(settings)
    tan_sun = jnp.tan(jnp.deg2rad(settings.sun_angular_diameter * 0.5))
    unproject = cam_mod.unproject_scale(cam, cfg.height)

    origin, direction, uv = cam_mod.camera_rays(
        cam, cfg.width, cfg.height, pixel_idx, frame
    )
    # ray cone: primary spread = one pixel angle (RaytracingShared.hlsli:129-142)
    from nrdsample_tpu.render import raycone

    pixel_angle = 2.0 * cam.tan_half_fov_y / cfg.height
    cone = {
        "width": jnp.zeros((n_px,), cfg.dtype),
        "spread": jnp.broadcast_to(pixel_angle.astype(cfg.dtype), (n_px,)),
    }
    hit = traversal.closest_hit_alpha(ctx, scene, origin, direction)
    cone = raycone.propagate(cone, hit["t"])
    props = gbuffer.decode_hit(
        scene, hit, origin, direction, sun_dir, tan_sun, cfg.use_white_furnace,
        settings.emission_intensity,
        forced_material=settings.forced_material,
            use_normal_map=settings.use_normal_map,
            emission_scale_cubes=settings.emission_intensity_cubes, cone_width=cone["width"],
    )
    props = gbuffer.apply_overrides(
        props, settings.roughness_override, settings.metalness_override
    )

    # ---- PSR mirror walk (TraceOpaque.cs.hlsl:569-603) ----
    l_psr = jnp.zeros((n_px, 3), cfg.dtype)
    psr_throughput = jnp.ones((n_px, 3), cfg.dtype)
    x0, v0 = props["x"], props["v"]      # primary surface, pre-walk
    primary_t0 = props["t"]              # glass recast limit stays pre-PSR
    gb_normal = props["n"]
    x_for_gbuf = props["x"]
    if cfg.psr_bounce_num > 0:
        vz0 = cam_mod.world_to_view_z(cam, props["x"])
        props, l_psr, psr_throughput, virt_dist, mirror_mat = psr_walk(
            ctx, scene, cfg, settings, frame, pixel_idx, props, vz0, cam,
            sun_dir, tan_sun, unproject,
        )
        # place the VIRTUAL surface for viewZ/MV (TraceOpaque.cs.hlsl:608-628):
        # Xvirtual = X0 - V0 * accumulated virtual distance — mirror pixels
        # then reproject by the unfolded image, not the mirror surface
        x_for_gbuf = x0 - v0 * virt_dist[..., None]
        # unfold the virtual surface normal into camera space via the inverse
        # (= transpose) mirror matrix (TraceOpaque.cs.hlsl:636-638)
        gb_normal = jnp.einsum("nji,nj->ni", mirror_mat, props["n"], precision=_HI)

    view_z = jnp.where(
        props["miss"], cfgmod.INF, cam_mod.world_to_view_z(cam, x_for_gbuf)
    )

    # motion vectors (TraceOpaque.cs.hlsl:610-614): Xprev from the hit
    # instance's worldToWorldPrev when dynamics are provided, else Xprev = X;
    # for PSR pixels the motion is evaluated at the virtual point
    # (XvirtualPrev = Xvirtual + Xprev - X, TraceOpaque.cs.hlsl:609-611)
    if dynamics is not None:
        from nrdsample_tpu.scene import instances as inst_mod

        inst, m_curr, m_prev = dynamics
        x_prev = inst_mod.prev_position(inst, m_curr, m_prev, props["x"], props["tri"])
    else:
        x_prev = props["x"]
    x_prev_virt = x_for_gbuf + (x_prev - props["x"])
    mv = cam_mod.get_motion(cam, x_for_gbuf, x_prev_virt, cfg.width, cfg.height)
    # MV_3D encoding (Settings.mvType): world-space motion delta; exported to
    # the upscaler guides when mv_type == 1 (the screen-space 2.5D form above
    # is what the in-repo denoisers always reproject with)
    mv_world = x_prev_virt - x_for_gbuf

    # direct lighting at the primary hit: sun (unshadowed; SIGMA provides the
    # shadow at composition) + emission (TraceOpaque.cs.hlsl:663-706)
    direct = lighting.direct_sun_lighting(
        props["n"], props["v"], props["base_color"], props["metalness"],
        props["roughness"], sun_dir, tan_sun, cfg.use_white_furnace,
        flags=props["flags"] if cfg.use_hair_sss else None,
        tangent=props["tangent"] if cfg.use_hair_sss else None,
    )
    direct = jnp.where(props["miss"][..., None], 0.0, direct)
    emission = jnp.where(
        props["miss"][..., None],
        lighting.sky_intensity(direction, sun_dir, tan_sun, cfg.use_white_furnace),
        props["lemi"],
    )

    # SIGMA input: sun shadow at primary surface (penumbra pass,
    # TraceOpaque.cs.hlsl:767-804); shadow translucency omitted round-1.
    # The visibility ray itself joins trace_paths' single batched launch.
    p_sxo, p_sdir = lighting.sun_shadow_ray_params(
        props["x"], props["n_geom"], sun_dir, tan_sun, pixel_idx, frame,
        unproject, view_z, dim=501, rnd=_shadow_rnd(cfg, pixel_idx, frame, 501),
    )

    paths = trace_paths(
        ctx, scene, cam, cfg, settings, frame, props, pixel_idx, sharc_state,
        l1_hist, cone0=cone, primary_shadow=(p_sxo, p_sdir),
    )
    shadow = paths.pop("primary_shadow")
    shadow = jnp.where(props["miss"], 1.0, shadow)
    shadow = jnp.where(settings.disable_shadows > 0, 1.0, shadow)
    # SIGMA penumbra input: closest-blocker distance along the sun-shadow ray
    # (TraceOpaque.cs.hlsl:767-804); 0 for lit/miss/disabled pixels
    shadow_hit_dist = paths.pop("primary_shadow_hitdist")
    shadow_hit_dist = jnp.where(props["miss"], 0.0, shadow_hit_dist)
    shadow_hit_dist = jnp.where(settings.disable_shadows > 0, 0.0, shadow_hit_dist)

    return {
        "view_z": view_z,
        "mv": mv,
        "mv_world": mv_world,
        "normal": gb_normal,
        "roughness": props["roughness"],
        "metalness": props["metalness"],
        "base_color": props["base_color"],
        "material_id": jnp.where(
            props["metalness"] > 0.5, cfgmod.MATERIAL_ID_METAL, cfgmod.MATERIAL_ID_DEFAULT
        ),
        "direct_lighting": direct,
        "emission": emission,
        "shadow": shadow,
        "shadow_hit_dist": shadow_hit_dist,
        # primary sun-visibility ray, exported so the glass-aware SIGMA
        # translucency march can reuse it (TraceOpaque.cs.hlsl:767-804)
        "shadow_ray": (p_sxo, p_sdir),
        "miss": props["miss"],
        "primary_x": x_for_gbuf,
        "primary_t": primary_t0,
        "uv": uv,
        "tri": props["tri"],
        "flags": props["flags"],
        "curvature": props["curvature"],
        "mip": props.get("mip"),
        "l_psr": l_psr,
        "psr_throughput": psr_throughput,
        **paths,
    }
