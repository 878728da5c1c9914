"""The frame function — RenderFrame (NRDSample.cpp:3814-4513) as one pure jitted
function: trace -> denoise (SIGMA + REBLUR/RELAX/REFERENCE) -> compose -> TAA,
threading an explicit history pytree (temporal state, SURVEY.md §5.4) instead of
persistent GPU textures.

XLA replaces the reference's command buffers, barriers and descriptor machinery
wholesale (SURVEY.md §2.3 "NRI" row): the pass graph is just function
composition, fused and scheduled by the compiler.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from nrdsample_tpu.config import Denoiser, RenderConfig, Settings
from nrdsample_tpu.denoise import composition, reblur, reference, relax, sigma, taa
from nrdsample_tpu.ops import traversal
from nrdsample_tpu.render import trace_opaque
from nrdsample_tpu.scene import camera as cam_mod
from nrdsample_tpu.scene.types import Camera, Scene


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class History:
    """All cross-frame state (the reference's persistent textures + SHARC
    buffers + NRD-internal history, SURVEY.md §5.4). Unused denoiser slots are
    None (static pytree structure per RenderConfig)."""

    frame_index: jnp.ndarray          # () int32
    reference: Any = None             # reference.ReferenceHistory
    relax_diff: Any = None            # relax.RelaxHistory
    relax_spec: Any = None
    reblur_diff: Any = None           # reblur.ReblurHistory
    reblur_spec: Any = None
    sigma: Any = None                 # sigma.SigmaHistory
    taa: Any = None                   # taa.TaaHistory
    sharc: Any = None                 # sharc.SharcState (L2 radiance cache)
    l1: Any = None                    # l1cache.L1History (prev-frame irradiance)
    confidence: Any = None            # confidence.ConfidenceHistory (probe lum)
    neural_rr: Any = None             # neural_rr.NeuralRRHistory (RR slot)

    @staticmethod
    def create(cfg: RenderConfig) -> "History":
        h, w, dt = cfg.height, cfg.width, cfg.dtype
        kw: dict[str, Any] = {"frame_index": jnp.int32(0)}
        if cfg.use_sharc:
            from nrdsample_tpu.ops import sharc as sharc_mod

            kw["sharc"] = sharc_mod.SharcState.create(cfg.sharc_capacity, dt)
            if cfg.use_confidence:
                from nrdsample_tpu.denoise import confidence as conf_mod

                ds = cfg.sharc_downscale
                kw["confidence"] = conf_mod.ConfidenceHistory.create(
                    max(h // ds, 1), max(w // ds, 1), dt
                )
        if cfg.use_l1_cache:
            from nrdsample_tpu.render import l1cache

            kw["l1"] = l1cache.L1History.create(h, w, dt)
        if cfg.denoiser == Denoiser.REFERENCE:
            kw["reference"] = reference.ReferenceHistory.create(cfg.n_pixels, dt)
        elif cfg.denoiser == Denoiser.RELAX:
            kw["relax_diff"] = relax.RelaxHistory.create(h, w, dt)
            kw["relax_spec"] = relax.RelaxHistory.create(h, w, dt)
            kw["sigma"] = sigma.SigmaHistory.create(h, w, dt)
        elif cfg.denoiser == Denoiser.REBLUR:
            kw["reblur_diff"] = reblur.ReblurHistory.create(h, w, dt)
            kw["reblur_spec"] = reblur.ReblurHistory.create(h, w, dt)
            kw["sigma"] = sigma.SigmaHistory.create(h, w, dt)
        elif cfg.denoiser == Denoiser.NEURAL:
            from nrdsample_tpu.post import neural_rr

            kw["neural_rr"] = neural_rr.NeuralRRHistory.create(h, w, dt)
        if cfg.use_taa:
            kw["taa"] = taa.TaaHistory.create(h, w, dt)
        return History(**kw)


def _shadow_translucency_march(tctx, scene: Scene, cfg: RenderConfig,
                               sxo: jnp.ndarray, sdir: jnp.ndarray):
    """Bounded multi-layer glass march of the sun-shadow ray.

    Reference semantics (TraceOpaque.cs.hlsl:780-798): walk the shadow ray
    hit-to-hit; every transparent hit multiplies translucency by
    lerp(0.9, 0.0, pow01(1 - NoV, 2.5)) — grazing-incidence layers block more
    (Fresnel-ish) — and the march stops when translucency <= 0.01. The static
    PT_SHADOW_GLASS_LAYERS unroll keeps shapes XLA-static; opaque blockers are
    already folded in by the deferred binary-shadow launch, so this marches the
    TRANSPARENT context only. Colored extension: each layer also multiplies by
    the glass base-color tint (the data the reference's scalar pack drops).

    Returns (trans_rgb (N,3), first_glass_t (N,)) — first_glass_t is 0 where
    no glass layer was hit (feeds the SIGMA penumbra distance).
    """
    from nrdsample_tpu import config as cfgmod
    from nrdsample_tpu.mathlib import color as color_mod, geometry as geo

    n_px = sxo.shape[0]
    f32 = cfg.dtype
    trans = jnp.ones((n_px, 3), f32)
    first_t = jnp.zeros((n_px,), f32)
    dist = jnp.zeros((n_px,), f32)      # cumulative distance marched so far
    o = sxo
    active = jnp.ones((n_px,), bool)
    tr = tctx.tris
    for _ in range(cfgmod.PT_SHADOW_GLASS_LAYERS):
        hit = traversal.closest_hit(tctx, o, sdir)
        found = (hit["tri"] >= 0) & active
        tri_local = jnp.maximum(hit["tri"] - tctx.tri_offset, 0)
        n_geom = geo.normalize(geo.cross(tr.e1[tri_local], tr.e2[tri_local]))
        nov = jnp.abs(geo.dot3(n_geom, sdir))
        p = jnp.power(jnp.clip(1.0 - nov, 0.0, 1.0), 2.5)
        factor = 0.9 * (1.0 - p)        # lerp(0.9, 0.0, p)
        tint = scene.materials.base_color[tr.material[tri_local]]
        layer = jnp.where(found[..., None], factor[..., None] * tint, 1.0)
        trans = trans * layer
        t = jnp.where(found, hit["t"], 0.0)
        first_t = jnp.where(found & (first_t == 0.0), dist + t, first_t)
        dist = dist + t
        # advance past the layer (hitT + epsilon, TraceOpaque.cs.hlsl:797)
        o = o + sdir * (t + 1e-3 * jnp.where(found, 1.0, 0.0))[..., None]
        active = found & (color_mod.luminance(trans) > 0.01)
    return trans, first_t


@jax.named_scope("trace")
def trace_frame(ctx: traversal.TraceContext, scene: Scene, cam: Camera,
                cfg: RenderConfig, settings: Settings, history: History,
                pixel_idx=None, dynamics=None,
                probe_axis: str | None = None):
    """Phase 1 — everything that launches rays: SHARC update probes, the opaque
    trace, the glass-shadow translucency march, and the glass delta chains.

    All outputs are per-pixel planes (flat, aligned with `pixel_idx`), except
    `aux` entries which are pixel-independent (SHARC table, probe grid). This
    phase shards perfectly over the pixel dimension: run it inside shard_map
    with a per-device `pixel_idx` block and everything else replicated.

    Returns (gb, aux): gb with added glass_color/glass_mask and the final
    shadow (incl. translucency); aux = {sharc, probes}.
    """
    ctxs = (
        ctx if isinstance(ctx, traversal.SceneContexts)
        else traversal.SceneContexts(ctx, None)
    )
    frame = history.frame_index

    # ---- SHARC cache update + resolve (NRDSample.cpp:3965-3997); probe grid
    # is full-image (1/ds res) and RNG-deterministic, so under sharding every
    # device recomputes identical probes/table (replicated-compute; the probe
    # work is 1/ds^2 of the ray budget) ----
    sharc_state = history.sharc
    probes = None
    if cfg.use_sharc and sharc_state is not None:
        from nrdsample_tpu.render import sharc_update

        sharc_state, probes = sharc_update.sharc_update_pass(
            ctxs, scene, cam, cfg, settings, frame, sharc_state,
            probe_axis=probe_axis,
        )

    gb = trace_opaque.trace_opaque(
        ctxs.opaque, scene, cam, cfg, settings, frame, pixel_idx,
        sharc_state if cfg.use_sharc else None,
        history.l1 if cfg.use_l1_cache else None,
        dynamics=dynamics,
    )

    # ---- stress injection + sanitization (SURVEY.md §4.4; Shared.hlsli:28-45) ----
    stress_on = (cfg.use_drs_stress_test or cfg.use_inf_stress_test
                 or cfg.use_firefly_test or cfg.use_material_id_test)
    if stress_on or cfg.use_sanitization:
        from nrdsample_tpu.render import stress as stress_mod

        pidx_s = (
            pixel_idx if pixel_idx is not None
            else jnp.arange(cfg.n_pixels, dtype=jnp.int32)
        )
        if stress_on:
            gb = stress_mod.apply_stress_tests(gb, cfg, settings, pidx_s, frame)
        if cfg.use_sanitization:
            gb = stress_mod.sanitize_gbuffer(gb, cfg, settings, pidx_s)

    # ---- glass-aware shadow translucency (SIGMA_TRANSLUCENCY,
    # TraceOpaque.cs.hlsl:767-804): the sun shadow ray marches through up to
    # PT_SHADOW_GLASS_LAYERS transparent layers; each layer attenuates by an
    # NoV-dependent factor x the glass tint (colored; the reference packs a
    # gray scalar into SIGMA's RGB translucency, Composition.cs.hlsl:58-64) ----
    shadow = gb["shadow"]
    if ctxs.transparent is not None and cfg.use_translucency and "shadow_ray" in gb:
        sxo, sdir = gb["shadow_ray"]
        trans_rgb, glass_t = _shadow_translucency_march(
            ctxs.transparent, scene, cfg, sxo, sdir
        )
        trans_rgb = jnp.where(settings.disable_shadows > 0,
                              jnp.ones_like(trans_rgb), trans_rgb)
        from nrdsample_tpu.mathlib import color as color_mod

        lum = color_mod.luminance(trans_rgb)
        shadow = shadow * lum
        # chroma ratio plane (luminance-normalized tint), applied to the
        # SIGMA-denoised scalar shadow at composition -> tinted RGB shadow
        tint = trans_rgb / jnp.maximum(lum, 1e-6)[..., None]
        gb["shadow_tint"] = jnp.where(
            (lum > 1e-6)[..., None], tint, jnp.ones_like(tint)
        )
        # the closest glass layer participates in the SIGMA penumbra estimate
        # exactly like an opaque blocker (shadowHitDist accumulation,
        # TraceOpaque.cs.hlsl:785-788)
        if "shadow_hit_dist" in gb:
            hd = gb["shadow_hit_dist"]
            glass_t = jnp.where(settings.disable_shadows > 0, 0.0, glass_t)
            gb["shadow_hit_dist"] = jnp.where(
                glass_t > 0.0,
                jnp.where(hd > 0.0, jnp.minimum(hd, glass_t), glass_t),
                hd,
            )
    gb = dict(gb, shadow=shadow)
    gb.pop("shadow_ray", None)

    # ---- TraceTransparent glass chains (NRDSample.cpp:4190-4211): the
    # traversal part runs here; the overlay onto the composed image happens in
    # image_frame ----
    if ctxs.transparent is not None:
        from nrdsample_tpu.render import trace_transparent as tt

        pidx = (
            pixel_idx if pixel_idx is not None
            else jnp.arange(cfg.n_pixels, dtype=jnp.int32)
        )
        glass_color, glass_mask = tt.trace_transparent_color(
            ctxs, scene, cam, cfg, settings, frame, gb, pidx,
            sharc_state if cfg.use_sharc else None,
        )
        gb = dict(gb, glass_color=glass_color, glass_mask=glass_mask)

    return gb, {"sharc": sharc_state, "probes": probes}


def _reblur_spec_mv(cfg: RenderConfig, cam: Camera, gb: dict, img):
    """Specular virtual-motion vector for REBLUR (history follows the virtual
    image behind the reflector, not the surface)."""
    from nrdsample_tpu.mathlib import geometry as geo_mod

    x_img = img(gb["primary_x"])
    eye = cam.view_to_world[:3, 3]
    vdir = geo_mod.normalize(x_img - eye)
    return reblur.specular_virtual_mv(
        cam, x_img, vdir, img(gb["spec_hitdist"]), img(gb["roughness"]),
        img(gb["mv"]), cfg.width, cfg.height, miss=img(gb["miss"]),
    )


def gather_modes(cfg: RenderConfig) -> dict:
    """Static request-name -> gather mode map for collect_gather_requests."""
    from nrdsample_tpu.denoise import gatherpass as gp

    modes = {}
    if cfg.denoiser in (Denoiser.RELAX, Denoiser.REBLUR):
        modes["sigma.temporal"] = gp.BILINEAR
    if cfg.denoiser == Denoiser.RELAX:
        modes["relax_diff"] = gp.BILINEAR
        modes["relax_spec"] = gp.BILINEAR
    elif cfg.denoiser == Denoiser.REBLUR:
        for sig in ("reblur_diff", "reblur_spec"):
            modes[f"{sig}.illum"] = gp.BICUBIC
            modes[f"{sig}.packed"] = gp.BILINEAR
    if cfg.use_taa:
        modes["taa"] = gp.BICUBIC
    return modes


def collect_gather_requests(cfg: RenderConfig, settings: Settings, cam: Camera,
                            history: History, gb: dict, aux: dict) -> dict:
    """The 'plan' stage of the staged frame: compute every history-gather
    request (packed plane + sample positions) from the trace outputs. Pure
    elementwise/stencil work — jitted as its own small program; the requests
    feed gatherpass.execute (one gathers-only program), whose results reach
    image_frame via `gathered=`."""
    n_local = gb["view_z"].shape[0]
    w = cfg.width
    h_local = n_local // w

    def img(a):
        return a.reshape((h_local, w) + a.shape[1:])

    reqs: dict = {}
    frame = history.frame_index
    if history.sigma is not None:
        tan_sun = jnp.tan(jnp.deg2rad(settings.sun_angular_diameter * 0.5))
        unproj = cam_mod.unproject_scale(cam, cfg.height)
        for k, v in sigma.requests(
            history.sigma, img(gb["shadow"]), img(gb["shadow_hit_dist"]),
            img(gb["view_z"]), img(gb["mv"]), tan_sun, unproj, frame,
        ).items():
            reqs[f"sigma.{k}"] = v
    if cfg.denoiser == Denoiser.RELAX:
        mv_xy = img(gb["mv"])[..., :2]
        reqs["relax_diff"] = relax.taccum_requests(history.relax_diff, mv_xy)
        reqs["relax_spec"] = relax.taccum_requests(history.relax_spec, mv_xy)
    elif cfg.denoiser == Denoiser.REBLUR:
        mv_xy = img(gb["mv"])[..., :2]
        for k, v in reblur.taccum_requests(history.reblur_diff, mv_xy).items():
            reqs[f"reblur_diff.{k}"] = v
        mv_spec = _reblur_spec_mv(cfg, cam, gb, img)
        for k, v in reblur.taccum_requests(
            history.reblur_spec, mv_spec[..., :2]
        ).items():
            reqs[f"reblur_spec.{k}"] = v
    if cfg.use_taa and history.taa is not None:
        reqs["taa"] = taa.requests(history.taa, img(gb["mv"]), img(gb["view_z"]))
    return reqs


def _max_acc(settings: Settings):
    """Accumulation-frame cap from Settings (adaptive accumulation plumbs the
    fps-derived value here each frame, NRDSample.cpp:2161-2189; fast history
    = max/5 per :2172). Floored at 1: a full reset goes through the explicit
    reset_history path, not a zero cap."""
    return jnp.maximum(settings.max_accumulated_frame_num, 1).astype(jnp.float32)


def image_frame_begin(cfg: RenderConfig, settings: Settings, cam: Camera,
                      history: History, gb: dict, aux: dict,
                      reset_history=False, gathered: dict | None = None):
    """Phase 2a — image work through the denoisers' temporal accumulation:
    history confidence, checkerboard reconstruction, SIGMA, RELAX (complete),
    REBLUR accumulate + blur-tap PLAN (the blur positions depend on the
    accumulated state, so the taps are a second gather round in the staged
    frame). Returns a `mid` pytree for image_frame_finish; mid["reqs2"] holds
    the second-round gather requests ({} when none).

    gathered: optional pre-gathered history samples (collect_gather_requests →
    gatherpass.execute); None = gathers run in-program (robust tap form).
    """
    gathered = gathered or {}
    frame = history.frame_index
    sharc_state = aux.get("sharc")
    probes = aux.get("probes")

    n_local = gb["view_z"].shape[0]
    w = cfg.width
    h_local = n_local // w
    full_image = n_local == cfg.n_pixels

    def img(a):
        return a.reshape((h_local, w) + a.shape[1:])

    def flat(a):
        return a.reshape((n_local,) + a.shape[2:])

    diff = gb["diff_radiance"]
    spec = gb["spec_radiance"]
    shadow = gb["shadow"]

    # ---- history confidence: probe gradient -> ConfidenceBlur x5 ->
    # confidence plane (NRDSample.cpp:3999-4026; ConfidenceBlur.cs.hlsl) ----
    confidence_img = None
    if (cfg.use_sharc and cfg.use_confidence and history.confidence is not None
            and probes is not None and full_image):
        from nrdsample_tpu.denoise import confidence as conf_mod

        grad, new_conf_h = conf_mod.gradient_from_probes(
            history.confidence, probes
        )
        grad = conf_mod.atrous_blur(grad, probes["view_z"], probes["normal"])
        conf_lo = conf_mod.gradient_to_confidence(
            grad, frame, relax_square=cfg.denoiser == Denoiser.RELAX
        )
        conf_lo = conf_lo * settings.prev_frame_confidence
        # upsample the 1/ds probe grid to render resolution (nearest),
        # edge-padding the remainder rows/cols
        ds = cfg.sharc_downscale
        up = jnp.repeat(jnp.repeat(conf_lo, ds, axis=0), ds, axis=1)
        up = up[: cfg.height, : cfg.width]
        pad_h = cfg.height - up.shape[0]
        pad_w = cfg.width - up.shape[1]
        confidence_img = jnp.pad(up, ((0, pad_h), (0, pad_w)), mode="edge")
        # confidence is a history-CONTROL signal (gPrevFrameConfidence), not a
        # radiance path: detach it from autodiff like the other history gates
        confidence_img = jax.lax.stop_gradient(confidence_img)
        new_confidence_state = new_conf_h
    else:
        new_confidence_state = history.confidence

    # ---- checkerboard reconstruction (RESOLUTION_HALF, Shared.hlsli:62-65):
    # each lobe was traced at half rate; fill the untraced pixels from
    # horizontal neighbors before the denoisers see them ----
    from nrdsample_tpu.config import TracingMode

    gb_updates: dict = {}  # G-buffer planes changed here (the rest of gb
    # passes to image_frame_finish OUTSIDE the mid pytree — no HBM round-trip)
    if (cfg.tracing_mode == TracingMode.FULL_PROBABILISTIC
            and cfg.denoiser in (Denoiser.REBLUR, Denoiser.RELAX)):
        # AREA_3X3 hitT reconstruction: probabilistic lobe selection leaves
        # the unsampled lobe's hit distance at 0 (NRDSample.cpp:548/:569)
        from nrdsample_tpu.denoise import checkerboard as cb_mod

        gb_updates = {
            "diff_hitdist": flat(cb_mod.hitdist_reconstruct_3x3(img(gb["diff_hitdist"]))),
            "spec_hitdist": flat(cb_mod.hitdist_reconstruct_3x3(img(gb["spec_hitdist"]))),
        }
        gb = dict(gb, **gb_updates)

    if cfg.tracing_mode == TracingMode.HALF and full_image:
        from nrdsample_tpu.denoise import checkerboard as cb_mod

        cb = cb_mod.checkerboard_mask(h_local, w, frame)  # True = diffuse traced
        diff = flat(cb_mod.resolve(img(diff), cb))
        spec = flat(cb_mod.resolve(img(spec), jnp.logical_not(cb)))
        gb_updates = {
            "diff_hitdist": flat(cb_mod.resolve(img(gb["diff_hitdist"]), cb)),
            "spec_hitdist": flat(
                cb_mod.resolve(img(gb["spec_hitdist"]), jnp.logical_not(cb))
            ),
        }
        gb = dict(gb, **gb_updates)

    new_h = {"frame_index": frame + 1}
    if new_confidence_state is not None:
        new_h["confidence"] = new_confidence_state
    tan_sun = jnp.tan(jnp.deg2rad(settings.sun_angular_diameter * 0.5))

    # ---- SIGMA shadow denoising (NRDSample.cpp:4068-4084) ----
    if history.sigma is not None:
        unproj = cam_mod.unproject_scale(cam, cfg.height)
        pre_sigma = (
            {"temporal": gathered["sigma.temporal"]}
            if "sigma.temporal" in gathered else None
        )
        shadow_img, new_sigma = sigma.denoise(
            history.sigma, img(shadow), img(gb["shadow_hit_dist"]), img(gb["view_z"]),
            img(gb["mv"]), tan_sun, unproj, frame, reset=reset_history,
            pre=pre_sigma,
        )
        shadow = flat(shadow_img)
        new_h["sigma"] = new_sigma

    # ---- OCCLUSION / DIRECTIONAL_OCCLUSION modes (NRD_MODE, Shared.hlsli:52-55;
    # denoiser variants NRDSample.cpp:888-899) — the stack switches to
    # hit-distance-only signals; the radiance planes are REPLACED by [0,1]
    # occlusion so the stencil machinery below runs unchanged ----
    from nrdsample_tpu.config import NrdMode

    occl_mode = cfg.nrd_mode in (NrdMode.OCCLUSION, NrdMode.DIRECTIONAL_OCCLUSION)
    if occl_mode:
        from nrdsample_tpu.denoise import occlusion as occl

        nh_d = occl.norm_hitdist(gb["diff_hitdist"], gb["view_z"])
        nh_s = occl.norm_hitdist(gb["spec_hitdist"], gb["view_z"])
        if cfg.nrd_mode == NrdMode.DIRECTIONAL_OCCLUSION:
            d_occ = occl.directional_occlusion(nh_d, gb["diff_dir"], gb["normal"])
            s_occ = occl.directional_occlusion(nh_s, gb["spec_dir"], gb["normal"])
        else:
            d_occ = occl.occlusion_from_hitdist(nh_d)
            s_occ = occl.occlusion_from_hitdist(nh_s)
        diff = jnp.repeat(d_occ[..., None], 3, axis=-1)
        spec = jnp.repeat(s_occ[..., None], 3, axis=-1)

    # ---- diffuse/specular denoising (NRDSample.cpp:4086-4154) ----
    conf_arg = confidence_img if confidence_img is not None else None
    reqs2: dict = {}
    reblur_mid: dict = {}
    if cfg.denoiser == Denoiser.RELAX:
        s = relax.RelaxSettings(max_accumulated_frames=_max_acc(settings))
        d_img, new_rd = relax.denoise(
            history.relax_diff, img(diff), img(gb["view_z"]), img(gb["normal"]),
            img(gb["mv"]), s, reset=reset_history, confidence=conf_arg,
            pre=gathered.get("relax_diff"),
        )
        sp_img, new_rs = relax.denoise(
            history.relax_spec, img(spec), img(gb["view_z"]), img(gb["normal"]),
            img(gb["mv"]), s, reset=reset_history, confidence=conf_arg,
            pre=gathered.get("relax_spec"),
        )
        diff, spec = flat(d_img), flat(sp_img)
        new_h["relax_diff"], new_h["relax_spec"] = new_rd, new_rs
    elif cfg.denoiser == Denoiser.REBLUR:
        s = reblur.ReblurSettings(
            max_accumulated_frames=_max_acc(settings),
            max_fast_accumulated_frames=jnp.maximum(_max_acc(settings) / 5.0, 1.0),
        )
        unproj = cam_mod.unproject_scale(cam, cfg.height)
        for sig, hist_sig, radiance, hitdist_key, mv_sig, is_spec in (
            ("reblur_diff", history.reblur_diff, diff, "diff_hitdist",
             img(gb["mv"]), False),
            # specular history follows the VIRTUAL image behind the reflector,
            # not the surface (REBLUR virtual-motion reprojection)
            ("reblur_spec", history.reblur_spec, spec, "spec_hitdist",
             _reblur_spec_mv(cfg, cam, gb, img), True),
        ):
            pre_sig = (
                {"illum": gathered[f"{sig}.illum"],
                 "packed": gathered[f"{sig}.packed"]}
                if f"{sig}.illum" in gathered else None
            )
            illum_in = img(radiance)
            if s.enable_anti_firefly:
                from nrdsample_tpu.denoise import common as dn_common

                illum_in = dn_common.anti_firefly(illum_in)
            acc, fast, hd, frames_sig = reblur.accumulate(
                hist_sig, illum_in, img(gb[hitdist_key]), img(gb["view_z"]),
                img(gb["normal"]), mv_sig, s, reset=reset_history,
                confidence=conf_arg, pre=pre_sig,
            )
            # the adaptive blur is a static dilated stencil chain now — no
            # second gather round needed (reqs2 stays empty for REBLUR)
            reblur_mid[sig] = (acc, fast, hd, frames_sig)

    return {
        "gb_updates": gb_updates, "diff": diff, "spec": spec, "shadow": shadow,
        "new_h": new_h, "reqs2": reqs2, "reblur": reblur_mid,
        "taa_pre": gathered.get("taa"),
    }


def image_frame_finish(cfg: RenderConfig, settings: Settings, cam: Camera,
                       history: History, gb: dict, aux: dict, mid: dict,
                       reset_history=False, gathered2: dict | None = None):
    """Phase 2b — REBLUR blur/stabilize (from pre-gathered or inline taps),
    then composition, glass overlay, REFERENCE accumulate, TAA, post chain,
    debug views, L1-history update, history assembly.

    gb: the trace-phase G-buffer with mid["gb_updates"] already merged in (the
    caller merges outside jit so unchanged planes skip the mid round-trip).
    gathered2: optional pre-gathered results for mid["reqs2"] (the staged
    frame's second gather round); None = inline robust-tap gathers."""
    from nrdsample_tpu.config import NrdMode

    frame = history.frame_index
    sharc_state = aux.get("sharc")
    diff = mid["diff"]
    spec = mid["spec"]
    shadow = mid["shadow"]
    new_h = dict(mid["new_h"])

    n_local = gb["view_z"].shape[0]
    w = cfg.width
    h_local = n_local // w

    def img(a):
        return a.reshape((h_local, w) + a.shape[1:])

    def flat(a):
        return a.reshape((n_local,) + a.shape[2:])

    occl_mode = cfg.nrd_mode in (NrdMode.OCCLUSION, NrdMode.DIRECTIONAL_OCCLUSION)

    if cfg.denoiser == Denoiser.REBLUR:
        s = reblur.ReblurSettings(
            max_accumulated_frames=_max_acc(settings),
            max_fast_accumulated_frames=jnp.maximum(_max_acc(settings) / 5.0, 1.0),
        )
        outs = {}
        for sig in ("reblur_diff", "reblur_spec"):
            acc, fast, hd, frames_sig = mid["reblur"][sig]
            is_spec = sig == "reblur_spec"
            unproj = cam_mod.unproject_scale(cam, cfg.height)
            blurred, hd_blur = reblur.adaptive_blur(
                acc, hd, img(gb["view_z"]), img(gb["normal"]),
                img(gb["roughness"]), frames_sig, frame, s, is_spec, unproj,
            )
            out_sig, frames_sig = reblur.stabilize(blurred, fast, frames_sig, s)
            new_h[sig] = reblur.ReblurHistory(
                illum=out_sig, fast_illum=fast, hitdist=hd_blur,
                view_z=img(gb["view_z"]), normal=img(gb["normal"]),
                frames=frames_sig,
            )
            outs[sig] = flat(out_sig)
        diff, spec = outs["reblur_diff"], outs["reblur_spec"]

    # ---- composition (NRDSample.cpp:4158-4188) ----
    if occl_mode:
        from nrdsample_tpu.denoise import occlusion as occl

        composed = occl.compose_occlusion(gb, diff[..., 0], spec[..., 0], shadow)
    elif cfg.nrd_mode == NrdMode.SH:
        # SH resolve re-sharpens with the actual normal (Composition.cs.hlsl:95-123)
        from nrdsample_tpu.denoise import sh as sh_mod

        diff_res = sh_mod.resolve(
            {"radiance": diff, "dir": gb["diff_dir"]}, gb["normal"]
        )
        spec_res = sh_mod.resolve(
            {"radiance": spec, "dir": gb["spec_dir"]}, gb["normal"],
            gb["roughness"], is_spec=True,
        )
        composed = composition.compose(gb, diff_res, spec_res, shadow)
    else:
        composed = composition.compose(gb, diff, spec, shadow)

    # ---- glass overlay (NRDSample.cpp:4190-4211; chains traced in
    # trace_frame, the passthrough/overlay select happens here) ----
    glass_mask = gb.get("glass_mask")
    if glass_mask is not None:
        composed = jnp.where(glass_mask[..., None], gb["glass_color"], composed)

    # ---- DLSS-RR slot: learned recurrent denoiser on the noisy composed
    # image + guide buffers (NRDSample.cpp:4284-4317) ----
    if cfg.denoiser == Denoiser.NEURAL and history.neural_rr is not None:
        from nrdsample_tpu.post import guides as guides_mod, neural_rr

        nrr_params = neural_rr.load_weights()
        if nrr_params is not None:
            rg = guides_mod.rr_guides(gb, near=0.01, mv_type=settings.mv_type)
            rr_g = {
                "diff_albedo": img(rg["diff_albedo"]),
                "spec_albedo": img(rg["spec_albedo"]),
                "normal_roughness": img(rg["normal_roughness"]),
                "depth": img(rg["depth"]),
            }
            den_img, new_nrr = neural_rr.denoise(
                nrr_params, img(composed), rr_g, img(gb["mv"])[..., :2],
                history.neural_rr, reset=reset_history,
            )
            composed = flat(den_img)
            new_h["neural_rr"] = new_nrr

    if cfg.denoiser == Denoiser.REFERENCE and history.reference is not None:
        composed, new_ref = reference.accumulate(
            history.reference, composed, reset=reset_history
        )
        new_h["reference"] = new_ref

    final = composed
    # ---- TAA (NRDSample.cpp:4339-4358) ----
    if cfg.use_taa and history.taa is not None:
        taa_in = img(composed * settings.exposure * 1e-2)
        # wide (5x5) neighborhood clamp for sky/hair/glass pixels — the
        # negative-TAA-mask surfaces of Taa.cs.hlsl:77. Glass comes from the
        # TraceTransparent hit mask (the opaque G-buffer never carries
        # FLAG_TRANSPARENT: transparent tris live in a separate context)
        from nrdsample_tpu import config as cfgmod3

        wide = gb["miss"] | ((gb["flags"] & cfgmod3.FLAG_HAIR) > 0)
        if glass_mask is not None:
            wide = wide | glass_mask
        taa_out, new_taa = taa.apply(
            history.taa, taa_in, img(gb["mv"]), img(gb["view_z"]),
            wide_mask=img(wide), reset=reset_history, pre=mid.get("taa_pre"),
        )
        final = flat(taa_out)
        new_h["taa"] = new_taa
        taa_wide_mask = wide
    else:
        taa_wide_mask = None

    # ---- output-resolution chain: SR slot -> NIS -> Final ----
    # (NRDSample.cpp:4236-4409; post/ package; slots for DLSS-SR/RR kept as
    # classical kernels per SURVEY.md §2.3 "Upscalers" row)
    display = None
    if cfg.enable_post:
        from nrdsample_tpu import post

        out_h = cfg.output_height or h_local
        out_w = cfg.output_width or w
        exp = settings.exposure * 1e-2
        if cfg.use_taa and history.taa is not None:
            tm = img(final)  # TAA output is already tonemap-range
        else:
            tm = post.final.tonemap_output(img(composed), exp)
        sr_params = None
        if cfg.use_neural_sr:
            from nrdsample_tpu.post import guides as guides_mod, neural_sr

            sr_params = neural_sr.load_weights()
        if sr_params is not None:
            # learned SR in the DLSS-SR slot (NRDSample.cpp:791-867): residual
            # CNN over the Lanczos base, conditioned on DlssBefore-style guides
            sr_guides = {
                "normal": img(gb["normal"]),
                "roughness": img(gb["roughness"]),
                "depth": img(guides_mod.hw_depth(gb["view_z"], 0.01)),
            }
            tm = neural_sr.apply(sr_params, tm, sr_guides, out_h, out_w)
        else:
            tm = post.upscale.lanczos_resize(tm, out_h, out_w)
        if cfg.use_nis:
            tm = post.nis.sharpen(tm, settings.sharpness)
        # split-screen "noisy" side = pre-denoise signals recomposed
        # (Final.cs.hlsl:29 reads the un-denoised input chain)
        noisy = composition.compose(
            gb, gb["diff_radiance"], gb["spec_radiance"], gb["shadow"]
        )
        noisy_up = post.upscale.lanczos_resize(
            post.final.tonemap_output(img(noisy), exp), out_h, out_w
        )
        display = post.final.final_pass(
            tm, noisy=noisy_up, separator=settings.separator, frame_index=frame
        )

    # debug views (gOnScreen, Composition.cs.hlsl:200-238)
    from nrdsample_tpu.config import OnScreen

    debug = None
    if cfg.on_screen != OnScreen.FINAL:
        taa_w = None
        if cfg.on_screen == OnScreen.TAA_WEIGHT and history.taa is not None:
            taa_w = flat(taa.debug_weight(
                history.taa, img(composed * settings.exposure * 1e-2),
                img(gb["mv"]), img(gb["view_z"]),
            ))
        debug = composition.debug_view(
            cfg.on_screen, gb, composed,
            sharc_state=sharc_state, cam_pos=cam.position, taa_weight=taa_w,
        )

    # NRD validation overlay (Final.cs.hlsl:46-51): accumulation-age heatmap
    if cfg.use_validation_overlay and final is not None:
        frames_plane = None
        for k in ("relax_diff", "reblur_diff"):
            if new_h.get(k) is not None:
                frames_plane = new_h[k].frames
        if frames_plane is not None:
            final = composition.validation_overlay(
                final, flat(frames_plane), _max_acc(settings)
            )

    outputs = {
        "color": composed,
        "final": final,
        "display": display,
        "debug": debug,
        "view_z": gb["view_z"],
        "normal": gb["normal"],
        "shadow": shadow,
        "diff_radiance": diff,
        "spec_radiance": spec,
        "gbuffer": gb,
        "glass_mask": glass_mask,
        "taa_wide_mask": taa_wide_mask,
    }
    if cfg.use_sharc:
        new_h["sharc"] = sharc_state
    if cfg.use_l1_cache:
        from nrdsample_tpu.render import l1cache
        from nrdsample_tpu import config as cfgmod2

        sun_dir = cfgmod2.sun_direction(settings)
        composed_diff = (
            gb["direct_lighting"] * shadow[..., None] + gb["emission"]
            + diff * gb["diff_factor"]
        )
        composed_spec = spec * gb["spec_factor"]
        new_h["l1"] = l1cache.update_history(
            cam, composed_diff, composed_spec, gb["view_z"], gb["normal"],
            sun_dir, h_local, w,
        )
    return outputs, History(**new_h)


@jax.named_scope("image")
def image_frame(cfg: RenderConfig, settings: Settings, cam: Camera,
                history: History, gb: dict, aux: dict, reset_history=False,
                gathered: dict | None = None):
    """Phase 2 — pure image-space work (image_frame_begin ∘ image_frame_finish
    with inline second-round gathers): history confidence, checkerboard
    reconstruction, SIGMA, REBLUR/RELAX, composition, glass overlay, REFERENCE,
    TAA, post chain, L1-history update.

    Every op here is a stencil/elementwise/gather on (H, W) planes. Under
    multi-chip sharding this phase runs on GLOBAL row-sharded arrays inside
    jit — GSPMD inserts the exact halo collectives around the stencils, so the
    sharded frame equals the single-chip frame (SURVEY.md §2.4(d)).

    gathered: optional pre-gathered history samples (collect_gather_requests →
    gatherpass.execute); None = gathers run in-program (robust tap form).
    """
    mid = image_frame_begin(
        cfg, settings, cam, history, gb, aux, reset_history, gathered
    )
    gb = dict(gb, **mid["gb_updates"])
    return image_frame_finish(
        cfg, settings, cam, history, gb, aux, mid, reset_history, gathered2=None
    )


def render_frame(ctx: traversal.TraceContext, scene: Scene, cam: Camera,
                 cfg: RenderConfig, settings: Settings, history: History,
                 reset_history=False, pixel_idx=None, dynamics=None):
    """One frame: trace_frame ∘ image_frame. Returns (outputs dict, new history).

    outputs["color"] is the composed HDR radiance (N, 3); outputs["final"] is
    post-TAA when enabled. `ctx` may be a TraceContext (opaque-only scene) or
    SceneContexts (glass scene; adds the TraceTransparent pass). `dynamics` —
    optional (InstancedScene, m_curr, m_prev) for true moving-object motion
    vectors.

    For multi-chip rendering do NOT call this inside shard_map — use
    parallel.mesh.sharded_render_fn, which runs trace_frame per shard and
    image_frame on global row-sharded images so denoiser stencils are exact at
    shard boundaries (sharded == unsharded).
    """
    # dynamic camFov (Settings.camFov, NRDSample.cpp:237): 0 keeps the
    # camera's own FoV; traced scalar, so no recompile on change
    fov = jnp.asarray(settings.cam_fov, jnp.float32)
    cam = dataclasses.replace(
        cam,
        tan_half_fov_y=jnp.where(
            fov > 0.0, jnp.tan(jnp.deg2rad(fov * 0.5)), cam.tan_half_fov_y
        ),
    )
    # blink (Settings.blink): smooth pulse on the emissive cubes' intensity
    blink_wave = 0.5 + 0.5 * jnp.sin(
        history.frame_index.astype(jnp.float32) * 0.4
    )
    settings = dataclasses.replace(
        settings,
        emission_intensity_cubes=jnp.where(
            settings.blink > 0,
            settings.emission_intensity_cubes * blink_wave,
            settings.emission_intensity_cubes,
        ),
    )
    gb, aux = trace_frame(
        ctx, scene, cam, cfg, settings, history,
        pixel_idx=pixel_idx, dynamics=dynamics,
    )
    return image_frame(cfg, settings, cam, history, gb, aux, reset_history)


def make_jitted_frame(ctx: traversal.TraceContext, cfg: RenderConfig):
    """Close over static structures; jit the dynamic-arg frame function.

    The analogue of pipeline creation (CreatePipelines, NRDSample.cpp:2866-2912):
    one compile, then per-frame calls are pure dispatch.
    """

    # no history donation: denoiser history slots share geometry buffers
    # (reblur_diff.view_z and reblur_spec.view_z alias the same output), and
    # donating an aliased buffer twice is an XLA runtime error
    @jax.jit
    def frame_fn(scene, cam, settings, history):
        return render_frame(ctx, scene, cam, cfg, settings, history)

    return frame_fn


def make_staged_frame(ctx: traversal.TraceContext, cfg: RenderConfig):
    """The staged frame: trace / gather-plan / gather / image as SEPARATE
    jit programs, same signature as make_jitted_frame's frame_fn.

    Every history reprojection is hoisted into one dedicated gather program
    (denoise/gatherpass.py). Callers must NOT wrap frame_fn in an outer
    jax.jit — that would re-merge the programs. Not the production path
    (make_jitted_frame is); kept with its parity tests.

    Falls back to the monolithic jit when the config has no gather requests
    (REFERENCE denoiser without TAA).
    """
    modes = gather_modes(cfg)
    if not modes:
        return make_jitted_frame(ctx, cfg)

    from nrdsample_tpu.denoise import gatherpass

    @jax.jit
    def _trace(scene, cam, settings, history):
        return trace_frame(ctx, scene, cam, cfg, settings, history)

    @jax.jit
    def _plan(settings, cam, history, gb, aux):
        return collect_gather_requests(cfg, settings, cam, history, gb, aux)

    @jax.jit
    def _gather(reqs):
        return gatherpass.execute(reqs, modes)

    # no donation: history leaves may alias each other across denoiser slots
    # (e.g. reblur_diff.view_z and reblur_spec.view_z are the same buffer),
    # and donating an aliased buffer twice is an XLA runtime error
    @jax.jit
    def _image_a(settings, cam, history, gb, aux, gathered):
        return image_frame_begin(cfg, settings, cam, history, gb, aux,
                                 gathered=gathered)

    @jax.jit
    def _gather2(reqs2):
        return gatherpass.execute(
            reqs2, {k: gatherpass.BILINEAR for k in reqs2}
        )

    @jax.jit
    def _image_b(settings, cam, history, gb, aux, mid, gathered2):
        return image_frame_finish(cfg, settings, cam, history, gb, aux, mid,
                                  gathered2=gathered2)

    def frame_fn(scene, cam, settings, history):
        gb, aux = _trace(scene, cam, settings, history)
        reqs = _plan(settings, cam, history, gb, aux)
        gathered = _gather(reqs)
        mid = _image_a(settings, cam, history, gb, aux, gathered)
        # second gather round: REBLUR adaptive-blur taps (positions depend on
        # the accumulated state computed in _image_a)
        gathered2 = _gather2(mid["reqs2"]) if mid["reqs2"] else {}
        gb = dict(gb, **mid["gb_updates"])
        return _image_b(settings, cam, history, gb, aux, mid, gathered2)

    return frame_fn


def render_converged(ctx, scene, cam, cfg, settings, n_frames: int,
                     history: History | None = None):
    """Accumulate n_frames with the REFERENCE denoiser (ground-truth oracle).

    Uses lax.fori_loop so compile time is frame-count independent.
    """
    if history is None:
        history = History.create(cfg)

    def body(i, h):
        _, h2 = render_frame(ctx, scene, cam, cfg, settings, h, reset_history=False)
        return h2

    history = jax.lax.fori_loop(0, n_frames, body, history)
    return history.reference.accum, history
