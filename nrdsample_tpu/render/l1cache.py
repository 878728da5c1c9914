"""L1 radiance cache: previous-frame screen-space irradiance reprojection.

Reference: ReprojectIrradiance (RaytracingShared.hlsli:1011-1085) +
GetRadianceFromPreviousFrame (TraceOpaque.cs.hlsl:28-50): project a path vertex
into the previous frame, sample last frame's composed diffuse/specular, and
weight by viewZ consistency, screen-edge fade, sun-side (back-face) agreement,
ray length, and the global history confidence. The specular part is further
attenuated by how view-dependent the hit material is (spec magic curve).

State: ONE packed (H, W, 7) plane [viewZ*sign(N.sun), diff(3), spec(3)] — the
prev frame's ComposedDiff/ComposedSpec and the Composition.cs.hlsl:44-46
signed-viewZ trick. Packing makes the reprojection a single bilinear gather
instead of three (the wide-gather trick); the sample positions are
data-dependent (bounce-hit reprojections inside the trace program), so this
path keeps the robust tap gather form rather than the staged block gather.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from nrdsample_tpu.mathlib import color, filtering, geometry as geo
from nrdsample_tpu.scene import camera as cam_mod


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class L1History:
    packed: jnp.ndarray        # (H, W, 7): [|viewZ|*sign(N.sun), diff(3), spec(3)]
    valid: jnp.ndarray         # () int32

    @staticmethod
    def create(h: int, w: int, dtype=jnp.float32) -> "L1History":
        packed = jnp.zeros((h, w, 7), dtype).at[..., 0].set(1e5)
        return L1History(packed=packed, valid=jnp.int32(0))

    @property
    def view_z_signed(self) -> jnp.ndarray:
        return self.packed[..., 0]

    @property
    def diff(self) -> jnp.ndarray:
        return self.packed[..., 1:4]

    @property
    def spec(self) -> jnp.ndarray:
        return self.packed[..., 4:7]


def _linear_step(a, b, x):
    return jnp.clip((x - a) / (b - a), 0.0, 1.0)


def reproject_irradiance(hist: L1History, cam, props: dict, pixel_idx,
                         width: int, height: int, sun_dir,
                         prev_frame_confidence):
    """Returns (l_diff [N,3], l_spec [N,3], weight [N])."""
    x = props["x"]
    uv = cam_mod.world_to_uv(cam, x, prev=True)
    pos = uv * jnp.array([width, height], jnp.float32)

    data = filtering.sample_bilinear(hist.packed, pos)  # ONE 7-ch gather
    data_z = data[..., 0]
    l_diff = data[..., 1:4]
    l_spec = data[..., 4:7]
    prev_view_z = jnp.abs(data_z)

    view_z = jnp.abs(geo.affine_transform(cam.world_to_view_prev, x)[..., 2])
    err = (view_z - prev_view_z) * geo.positive_rcp(jnp.maximum(view_z, prev_view_z))
    weight = _linear_step(0.01, 0.005, jnp.abs(err))

    # soft screen-edge fade
    f = _linear_step(0.0, 0.1, uv) * _linear_step(1.0, 0.9, uv)
    weight = weight * f[..., 0] * f[..., 1]

    # back-face agreement via sign(N.sun) folded into stored viewZ
    n_dot_l = geo.dot3(props["n"], sun_dir)
    weight = weight * (n_dot_l * jnp.sign(data_z) > 0.0)

    # ignore too-short rays (self-reprojection loop)
    uv_cur = cam_mod.world_to_uv(cam, x, prev=False)
    px = (pixel_idx % width).astype(jnp.float32) + 0.5
    py = (pixel_idx // width).astype(jnp.float32) + 0.5
    d = geo.length(
        (uv_cur - jnp.stack([px / width, py / height], -1))
        * jnp.array([width, height], jnp.float32)
    )
    weight = weight * _linear_step(1.0, 3.0, d)

    weight = weight * jnp.logical_not(props["miss"])
    weight = weight * prev_frame_confidence * (hist.valid > 0)

    ok = jnp.isfinite(l_diff).all(-1) & jnp.isfinite(l_spec).all(-1)
    weight = weight * ok
    fade = jnp.clip(weight / 0.001, 0.0, 1.0)[..., None]
    return l_diff * fade, l_spec * fade, weight


def radiance_from_previous_frame(hist: L1History, cam, props: dict, pixel_idx,
                                 width: int, height: int, sun_dir,
                                 prev_frame_confidence):
    """GetRadianceFromPreviousFrame: returns (L [N,3], weight [N])."""
    l_diff, l_spec, w = reproject_irradiance(
        hist, cam, props, pixel_idx, width, height, sun_dir, prev_frame_confidence
    )
    norm_curv = jnp.clip(jnp.sqrt(jnp.abs(props["curvature"]) + 1e-12) / 2.5, 0.0, 1.0)
    f = 1.0 - jnp.exp2(-200.0 * props["roughness"] ** 2)
    spec_conf = f * geo.pow01(props["roughness"], 0.5)
    spec_conf = spec_conf + (1.0 - spec_conf) * norm_curv

    diff_lum = color.luminance(l_diff)
    spec_lum = color.luminance(l_spec)
    spec_w = spec_lum / (diff_lum + spec_lum + 1e-6)
    w = w * (1.0 + (spec_conf - 1.0) * spec_w)

    l_sum = l_diff + l_spec * spec_conf[..., None]
    l_sum = l_sum * jnp.clip(w / 0.05, 0.0, 1.0)[..., None]
    return l_sum, w


def update_history(cam, composed_diff, composed_spec, view_z, normal, sun_dir,
                   height: int, width: int) -> L1History:
    """Build next frame's L1 state (Composition.cs.hlsl outputs)."""
    sgn = jnp.where(geo.dot3(normal, sun_dir) >= 0, 1.0, -1.0)
    packed = jnp.concatenate(
        [
            (jnp.abs(view_z) * sgn)[..., None],
            composed_diff.reshape(-1, 3),
            composed_spec.reshape(-1, 3),
        ],
        axis=-1,
    ).reshape(height, width, 7)
    return L1History(packed=packed, valid=jnp.int32(1))
