"""Composition — denoiser back-end unpack + re-modulation + debug views.

Reference: Shaders/Composition.cs.hlsl (243 LoC): unpack SIGMA shadow, direct =
Ldirect*shadow + emission, unpack diffuse/specular denoised irradiance,
re-modulate with material factors, fold direct in, debug view switch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nrdsample_tpu import config as cfgmod
from nrdsample_tpu.config import OnScreen


@jax.named_scope("compose")
def compose(gb: dict, diff_radiance: jnp.ndarray, spec_radiance: jnp.ndarray,
            shadow: jnp.ndarray) -> jnp.ndarray:
    """Combine denoised signals into the final HDR radiance [N, 3].

    Composition.cs.hlsl:58-197: direct = Ldirect*shadow + Lemi; indirect diffuse/
    specular are re-modulated by the same factors used for de-modulation in
    TraceOpaque (:177-188), then summed. The SIGMA translucency is RGB
    (Composition.cs.hlsl:58-64 unpacks .yzw): when the trace produced a glass
    chroma plane, the scalar denoised shadow is re-tinted with it here.
    """
    shadow_rgb = shadow[..., None]
    tint = gb.get("shadow_tint")
    if tint is not None and tint.ndim == shadow.ndim + 1:
        shadow_rgb = shadow_rgb * tint
    direct = gb["direct_lighting"] * shadow_rgb + gb["emission"]
    diff = diff_radiance * gb["diff_factor"]
    spec = spec_radiance * gb["spec_factor"]
    # PSR: indirect signals live on the virtual mirror surface; re-apply the
    # mirror-chain throughput and the emission collected along the walk
    # (Composition.cs.hlsl:190-194)
    psr_t = gb.get("psr_throughput")
    out = direct + (diff + spec) * (psr_t if psr_t is not None else 1.0)
    l_psr = gb.get("l_psr")
    if l_psr is not None:
        out = out + l_psr
    return out


def debug_view(on_screen: int, gb: dict, composed: jnp.ndarray,
               sharc_state=None, cam_pos=None, taa_weight=None) -> jnp.ndarray:
    """The ~21 visualizations: G-buffer views (Composition.cs.hlsl:200-238)
    plus SHARC cache/grid (USE_SHARC_DEBUG, TraceOpaque.cs.hlsl:117-154) and
    the TAA weight (USE_TAA_DEBUG, Final.cs.hlsl:54-56)."""
    if on_screen == OnScreen.FINAL:
        return composed
    if on_screen == OnScreen.BASE_COLOR:
        return gb["base_color"]
    if on_screen == OnScreen.NORMAL:
        return gb["normal"] * 0.5 + 0.5
    if on_screen == OnScreen.ROUGHNESS:
        return jnp.repeat(gb["roughness"][..., None], 3, axis=-1)
    if on_screen == OnScreen.METALNESS:
        return jnp.repeat(gb["metalness"][..., None], 3, axis=-1)
    if on_screen == OnScreen.SHADOW:
        return jnp.repeat(gb["shadow"][..., None], 3, axis=-1)
    if on_screen == OnScreen.MATERIAL_ID:
        return jnp.repeat(gb["material_id"][..., None] / 3.0, 3, axis=-1)
    if on_screen == OnScreen.WORLD_UNITS:
        return jnp.mod(gb["primary_x"], 1.0)
    if on_screen == OnScreen.DENOISED_DIFFUSE:
        return gb["diff_radiance"] * gb["diff_factor"]
    if on_screen == OnScreen.DENOISED_SPECULAR:
        return gb["spec_radiance"] * gb["spec_factor"]
    if on_screen == OnScreen.AMBIENT_OCCLUSION:
        occ = jnp.clip(gb["diff_hitdist"] / (gb["diff_hitdist"] + 1.0), 0.0, 1.0)
        return jnp.repeat(occ[..., None], 3, axis=-1)
    if on_screen == OnScreen.SPECULAR_OCCLUSION:
        occ = jnp.clip(gb["spec_hitdist"] / (gb["spec_hitdist"] + 1.0), 0.0, 1.0)
        return jnp.repeat(occ[..., None], 3, axis=-1)
    if on_screen == OnScreen.PSR_THROUGHPUT:
        return gb.get("psr_throughput", jnp.ones_like(composed))
    if on_screen == OnScreen.INSTANCE_INDEX:
        # hashed triangle id as a stand-in color (TraceOpaque.cs.hlsl:666-670)
        tri = jnp.maximum(gb["tri"] if "tri" in gb else gb["material_id"].astype(jnp.int32), 0)
        h = (tri.astype(jnp.uint32) * jnp.uint32(0x9E3779B9))
        return jnp.stack(
            [((h >> s) & 0xFF).astype(composed.dtype) / 255.0 for s in (0, 8, 16)],
            axis=-1,
        )
    if on_screen == OnScreen.UV:
        uv = gb["uv"]
        return jnp.concatenate(
            [jnp.mod(uv, 1.0), jnp.zeros_like(uv[..., :1])], axis=-1
        )
    if on_screen == OnScreen.CURVATURE:
        c = jnp.sqrt(jnp.abs(gb.get("curvature", jnp.zeros_like(gb["view_z"]))) + 1e-12)
        return jnp.repeat(c[..., None], 3, axis=-1)
    if on_screen == OnScreen.MIP_PRIMARY:
        m = gb.get("mip", jnp.zeros_like(gb["view_z"])) / 8.0
        return jnp.repeat(m[..., None], 3, axis=-1)
    if on_screen == OnScreen.SHARC_CACHE and sharc_state is not None:
        # USE_SHARC_DEBUG == 1 (TraceOpaque.cs.hlsl:145-150): resolved cache
        # radiance straight at the primary hit; invalid cells highlighted red
        from nrdsample_tpu.ops import sharc as sharc_mod

        rad, found = sharc_mod.query(
            sharc_state, gb["primary_x"], gb["normal"], cam_pos
        )
        red = jnp.zeros_like(rad).at[..., 0].set(1.0)
        return jnp.where(found[..., None], rad, red)
    if on_screen == OnScreen.SHARC_GRID and cam_pos is not None:
        # USE_SHARC_DEBUG == 2: HashGridDebugColoredHash — color from the
        # grid-cell hash so voxel boundaries/levels are visible
        from nrdsample_tpu.ops import sharc as sharc_mod

        x, y, z, w_key, _ = sharc_mod.cell_key(
            gb["primary_x"], gb["normal"], cam_pos
        )
        h = sharc_mod._hash_u32x4(x, y, z, w_key)
        return jnp.stack(
            [((h >> s) & 0xFF).astype(composed.dtype) / 255.0
             for s in (0, 8, 16)],
            axis=-1,
        )
    if on_screen == OnScreen.TAA_WEIGHT and taa_weight is not None:
        # USE_TAA_DEBUG (Final.cs.hlsl:54-56): the per-pixel TAA mix rate
        return jnp.repeat(
            jnp.asarray(taa_weight, composed.dtype)[..., None], 3, axis=-1
        )
    return composed


def validation_overlay(img: jnp.ndarray, frames: jnp.ndarray,
                       max_frames: float, alpha: float = 0.5) -> jnp.ndarray:
    """NRD validation-layer analogue (Final.cs.hlsl:46-51 gValidation blend):
    overlays a green->red accumulation-age heatmap (fresh disocclusions red,
    converged history green) over the final image at `alpha`.

    img: (N, 3) or (H, W, 3); frames: matching leading shape."""
    conv = jnp.clip(frames / max_frames, 0.0, 1.0)[..., None]
    heat = jnp.concatenate(
        [1.0 - conv, conv, jnp.zeros_like(conv)], axis=-1
    ).astype(img.dtype)
    return img * (1.0 - alpha) + heat * alpha
