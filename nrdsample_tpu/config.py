"""Configuration tiers — the JAX equivalent of the reference's 3-tier config.

Reference (SURVEY.md §5.6): compile-time macros + constants live in
``Shaders/Shared.hlsli:7-150``, CLI flags in ``Source/NRDSample.cpp:533-541``, and the
mutable per-frame ``struct Settings`` (``NRDSample.cpp:233-297``) flows to the GPU via the
``GlobalConstants`` cbuffer (``Shared.hlsli:213-281``).

Here the same three tiers are:
  1. module-level constants + ``RenderConfig`` (frozen dataclass, static under jit —
     changing it recompiles, like recompiling shaders in the reference),
  2. CLI flags (``nrdsample_tpu.cli``),
  3. ``Settings`` (a pytree of dynamic scalars, a plain jit argument — no recompile).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Tier-1 constants (Shared.hlsli:47-165 equivalents)
# ---------------------------------------------------------------------------

# NRD variant (Shared.hlsli:52-55)
class NrdMode(enum.IntEnum):
    NORMAL = 0
    SH = 1
    OCCLUSION = 2
    DIRECTIONAL_OCCLUSION = 3


# Denoiser selection (Shared.hlsli:57-60)
class Denoiser(enum.IntEnum):
    REBLUR = 0
    RELAX = 1
    REFERENCE = 2
    NEURAL = 3   # DLSS-RR slot: learned recurrent denoiser (post/neural_rr.py)
                 # replacing the NRD-style denoisers (NRDSample.cpp:853-867)


# Indirect-tracing resolution mode (Shared.hlsli:62-65)
class TracingMode(enum.IntEnum):
    FULL = 0
    FULL_PROBABILISTIC = 1
    HALF = 2  # checkerboard: diffuse/specular interleaved per pixel


# Debug views (Shared.hlsli:67-87)
class OnScreen(enum.IntEnum):
    FINAL = 0
    DENOISED_DIFFUSE = 1
    DENOISED_SPECULAR = 2
    AMBIENT_OCCLUSION = 3
    SPECULAR_OCCLUSION = 4
    SHADOW = 5
    BASE_COLOR = 6
    NORMAL = 7
    ROUGHNESS = 8
    METALNESS = 9
    MATERIAL_ID = 10
    PSR_THROUGHPUT = 11
    WORLD_UNITS = 12
    INSTANCE_INDEX = 13
    UV = 14
    CURVATURE = 15
    MIP_PRIMARY = 16
    MIP_SPECULAR = 17
    # SHARC cache visualizations (USE_SHARC_DEBUG 1/2,
    # TraceOpaque.cs.hlsl:117-154): cached radiance at the primary hit
    # (invalid cells red) / colored grid-cell hash
    SHARC_CACHE = 18
    SHARC_GRID = 19
    # TAA blend-weight debug (USE_TAA_DEBUG, Final.cs.hlsl:54-56)
    TAA_WEIGHT = 20


# Forced material override (Shared.hlsli:89-91)
class ForcedMaterial(enum.IntEnum):
    NONE = 0
    GYPSUM = 1
    COBALT = 2


# Material IDs (Shared.hlsli:93-97)
MATERIAL_ID_DEFAULT = 0.0
MATERIAL_ID_METAL = 1.0
MATERIAL_ID_HAIR = 2.0
MATERIAL_ID_SELF_REFLECTION = 3.0

# Path tracing constants (Shared.hlsli:110-120)
PT_THROUGHPUT_THRESHOLD = 0.001
PT_IMPORTANCE_SAMPLES_NUM = 16
PT_SPEC_LOBE_ENERGY = 0.95
PT_SHADOW_RAY_OFFSET = 0.25  # pixels
PT_BOUNCE_RAY_OFFSET = 0.25  # pixels
PT_GLASS_RAY_OFFSET = 0.05  # pixels
PT_EVIL_TWIN_LOBE_TOLERANCE = 0.005
PT_DELTA_BOUNCES_NUM = 16
PT_PSR_BOUNCES_NUM = 2
# hitT normalization scale for the SHARC-gradient dynamic-object
# indirect-shadow heuristic (gHitDistSettings.x, SharcUpdate.cs.hlsl:187)
SHARC_GRADIENT_HITDIST_SCALE = 3.0
# static unroll bound for the sun-shadow glass march (the reference marches
# until translucency <= 0.01, TraceOpaque.cs.hlsl:780-798; 4 layers cover two
# double-pane windows — beyond that 0.9^4*tint^4 is visually black anyway)
PT_SHADOW_GLASS_LAYERS = 4

# SHARC radiance-cache constants (Shared.hlsli:122-134)
SHARC_CAPACITY = 1 << 22
SHARC_SCENE_SCALE = 45.0
SHARC_DOWNSCALE = 5
SHARC_RESPONSIVE_FRAME_NUM = 32
SHARC_STALE_FRAME_NUM_MIN = 8
SHARC_RADIANCE_SCALE = 100.0
SHARC_RESAMPLING_DEPTH_MIN = 1
SHARC_PROPAGATION_DEPTH = 4

# Misc (Shared.hlsli:139-150)
INF = 1e5
MAX_MIP_LEVEL = 11.0
LEAF_TRANSLUCENCY = 0.25
LEAF_THICKNESS = 0.001   # Shared.hlsli:146 — back-side offset for transmitted rays
TAA_HISTORY_SHARPNESS = 0.66
TAA_SIGMA_SCALE = 2.0

# Sky model (Shared.hlsli:424-425)
SKY_INTENSITY = 1.0
SUN_INTENSITY = 10.0

# Instance flags (Shared.hlsli:152-165)
FLAG_NON_TRANSPARENT = 0x01
FLAG_TRANSPARENT = 0x02
FLAG_FORCED_EMISSION = 0x04
FLAG_STATIC = 0x08
FLAG_HAIR = 0x10
FLAG_LEAF = 0x20
FLAG_SKIN = 0x40
FLAG_MORPH = 0x80
# extension bit: material demands the any-hit alpha test
# (the reference expresses this as a non-opaque TLAS instance flag consumed by
# CheckNonOpaqueTriangle, RaytracingShared.hlsli:191-247)
FLAG_ALPHA_TEST = 0x100
GEOMETRY_ALL = FLAG_NON_TRANSPARENT | FLAG_TRANSPARENT


# ---------------------------------------------------------------------------
# Tier-1: static render configuration (recompile on change)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (compile-time) render configuration.

    Hashable + frozen so it can be a `static_argnum` to jit. The reference's
    equivalents are the `#define` switches in Shared.hlsli:7-45 plus resolution
    state held by the Sample class.
    """

    width: int = 256
    height: int = 256
    rpp: int = 1                      # paths per pixel (NRDSample.cpp:266 `rpp`)
    bounce_num: int = 1               # indirect bounces (Settings.bounceNum)
    delta_bounce_num: int = 4         # glass/PSR delta chain cap (PT_DELTA_BOUNCES_NUM=16 in ref)
    psr_bounce_num: int = 0           # primary-surface-replacement mirror walk depth
    nrd_mode: NrdMode = NrdMode.NORMAL
    tracing_mode: TracingMode = TracingMode.FULL_PROBABILISTIC
    on_screen: OnScreen = OnScreen.FINAL   # debug visualization (gOnScreen)
    use_importance_sampling: bool = True
    use_blue_noise: bool = True       # USE_BLUE_NOISE_FOR_SHADOWS
                                      # (Shared.hlsli:25; auto-off under
                                      # REFERENCE accumulation like the ref)
    importance_samples: int = PT_IMPORTANCE_SAMPLES_NUM
    use_sharc: bool = False
    sharc_capacity: int = SHARC_CAPACITY
    sharc_downscale: int = SHARC_DOWNSCALE
    sharc_full_mode: bool = True      # FULL through-glass probe pass
                                      # (SharcUpdate.cs.hlsl:46,232); only
                                      # active when the scene has glass
    use_l1_cache: bool = False   # prev-frame screen-space irradiance reprojection
    use_confidence: bool = False  # SHARC-probe gradient -> history confidence
                                  # (needs use_sharc; ConfidenceBlur pipeline)
    use_white_furnace: bool = False   # USE_WHITE_FURNACE energy-conservation test
    use_hair_sss: bool = False        # RTXCR_INTEGRATION analogue: hair BCSDF +
                                      # SSS for FLAG_HAIR/FLAG_SKIN materials
    use_translucency: bool = True
    denoiser: Denoiser = Denoiser.REFERENCE
    use_taa: bool = False
    # output-resolution chain (0 = native, no upscale): the DLSS-SR slot is a
    # Lanczos-2 resize (post/upscale.py), NIS a contrast-adaptive sharpen
    output_width: int = 0
    output_height: int = 0
    use_nis: bool = False
    use_neural_sr: bool = False       # learned residual CNN in the DLSS-SR slot
                                      # (post/neural_sr.py; falls back to
                                      # Lanczos if shipped weights are absent)
    enable_post: bool = False         # tonemap + Final pass -> outputs["display"]
    dtype: Any = jnp.float32          # compute dtype for shading
    # stress tests + sanitization (SURVEY.md §4.4, Shared.hlsli:28-45)
    # NRD validation-layer analogue (Final.cs.hlsl:46-51): overlay the
    # accumulation-age heatmap on outputs["final"]
    use_validation_overlay: bool = False
    # USE_MOVING_EMISSION_FIX (Shared.hlsli:23, default ON): fold primary
    # emission /2pi into the denoised diff/spec signals so animated emitters
    # don't leave a dark history tail (TraceOpaque.cs.hlsl:714-718)
    use_moving_emission_fix: bool = True
    use_inf_stress_test: bool = False
    use_drs_stress_test: bool = False
    use_firefly_test: bool = False        # USE_SIMULATED_FIREFLY_TEST
    use_material_id_test: bool = False    # USE_SIMULATED_MATERIAL_ID_TEST
    use_sanitization: bool = False        # USE_SANITIZATION + NRD_IsValidRadiance

    @property
    def n_pixels(self) -> int:
        return self.width * self.height


# ---------------------------------------------------------------------------
# Tier-3: dynamic per-frame settings (jit arguments, no recompile)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Settings:
    """Dynamic per-frame settings — the `struct Settings` + `GlobalConstants` analogue.

    Every field is a scalar jnp array (weak-typed python scalars get promoted on
    first trace). This is the test-serialization unit, like the reference's
    648-byte Settings+Camera records (NRDSample.cpp:1788).
    """

    sun_azimuth: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.float32(-147.0))
    sun_elevation: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.float32(45.0))
    sun_angular_diameter: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.float32(0.533))
    exposure: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.float32(80.0))
    roughness_override: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.float32(0.0))
    metalness_override: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.float32(0.0))
    # ForcedMaterial debug override (Shared.hlsli:89-91); applied at every hit
    # decode like the reference's GetMaterialProps forced-material branch
    # (RaytracingShared.hlsli:497-515)
    forced_material: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.int32(0))
    # lights/cubes emission split (NRDSample.cpp:243-244
    # emissionIntensityLights / emissionIntensityCubes): `emission_intensity`
    # scales regular emissive materials, `emission_intensity_cubes` scales
    # FLAG_FORCED_EMISSION materials (the animated emissive cubes)
    emission_intensity: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.float32(1.0))
    emission_intensity_cubes: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.float32(1.0))
    # gUseNormalMap analogue (NRDSample.cpp Settings; RaytracingShared.hlsli:470)
    use_normal_map: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.int32(1))
    # indirect kill switches (NRDSample.cpp Settings.indirectDiffuse/-Specular):
    # zero the traced indirect signals before denoising (debug ergonomics)
    indirect_diffuse: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.int32(1))
    indirect_specular: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.int32(1))
    # dynamic vertical FoV in degrees; 0 = keep the camera's own
    # (Settings.camFov, NRDSample.cpp:237)
    cam_fov: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.float32(0.0))
    # blink: pulse the emissive cubes (Settings.blink) — cubes intensity is
    # modulated by a smooth pulse of the frame index
    blink: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.int32(0))
    # MV_25D (0) vs MV_3D (1): which motion-vector encoding lands in the
    # upscaler guide plane (Settings.mvType; the denoisers always consume the
    # screen-space form internally)
    mv_type: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.int32(0))
    debug: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.float32(0.0))
    separator: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.float32(0.0))
    max_accumulated_frame_num: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.int32(31))
    min_probability: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.float32(0.0))
    disable_shadows: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.int32(0))
    prev_frame_confidence: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.float32(1.0))
    sharpness: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.float32(0.15))
    # dynamic resolution scaling (gRectSize cropping, NRDSample.cpp:2104-2109);
    # 1.0 = full resolution, the padded buffer is always (width, height)
    resolution_scale: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.float32(1.0))

    def to_flat(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


def sun_direction(settings: Settings) -> jnp.ndarray:
    """World-space unit sun direction from azimuth/elevation degrees (z = up).

    The reference derives `gSunDirection` from Settings.sunAzimuth/sunElevation in
    UpdateConstantBuffer (NRDSample.cpp:3643-3769); world up is +Z there too.
    """
    az = jnp.deg2rad(settings.sun_azimuth)
    el = jnp.deg2rad(settings.sun_elevation)
    cos_el = jnp.cos(el)
    return jnp.stack([cos_el * jnp.cos(az), cos_el * jnp.sin(az), jnp.sin(el)])
