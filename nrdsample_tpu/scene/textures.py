"""Material textures — the bindless texture array + HW mip sampling equivalent.

Reference: each material binds 4 textures (baseColor, normalRoughness,
emissive, occlusion/metalness) from one bindless descriptor array
(RaytracingShared.hlsli:14-16 ``gIn_Textures[]``), sampled with a mip level
driven by ray cones (``GetMaterialProps``, RaytracingShared.hlsli:424-555;
mip logic 154-189).

Design (SURVEY.md §7.1 "Bindless material textures" row): no
samplers and no per-material resolutions — all textures are resampled at build
time into ONE stacked mip pyramid per channel-set, shape (M, H>>l, W>>l, C)
per level l. A fetch is then a static-shape gather; trilinear filtering is 8
gathers + lerps, vectorized over the whole ray batch. Build-time resampling is
host-side numpy (the analogue of the reference's detex texture upload,
UploadStaticData NRDSample.cpp:3308-3393).

Layers (one packed (M, H, W, 10) array per mip level):
  * [0:4]  rgba: base color + alpha
  * [4:8]  orme: occlusion, roughness, metalness, emissive-luma
  * [8:10] normal: tangent-space normal XY in [-1, 1] (0 = flat); Z is
           reconstructed at shade time (Geometry::UnpackLocalNormal analogue)
(emissive keeps the material-constant color, scaled by the map's luma — the
reference multiplies the emissive map by instance emission anyway.)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from nrdsample_tpu import config


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TextureSet:
    """Stacked mip pyramids for all materials. ``levels[l]`` has shape
    (M, H>>l, W>>l, 10): rgba ++ orme ++ normal-XY. Python list length =
    static mip count."""

    levels: list  # of (M, h, w, 10) arrays

    @property
    def n_mips(self) -> int:
        return len(self.levels)

    @property
    def base_res(self) -> int:
        return self.levels[0].shape[1]


def _box_downsample(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[0] // 2, img.shape[1] // 2
    return img[: 2 * h, : 2 * w].reshape(h, 2, w, 2, -1).mean(axis=(1, 3))


def build_texture_set(per_material: list, res: int = 128) -> TextureSet:
    """per_material: list of dicts with optional numpy images in [0,1]:
    ``base_color`` (h,w,3|4), ``roughness`` (h,w), ``metalness`` (h,w),
    ``emissive`` (h,w[,3]), ``alpha`` (h,w), ``normal`` (h,w,2|3) tangent-space
    in [0,1] image convention (0.5 = flat) or [-1,1] if signed. Missing maps
    become constant 1 (multiplied with the Materials constants at shade time);
    a missing normal map becomes flat (0, 0)."""
    assert res & (res - 1) == 0, "texture res must be a power of two"
    mats = []
    for m in per_material or [{}]:
        m = m or {}

        def fetch(key, ch, default=1.0):
            img = m.get(key)
            if img is None:
                return np.full((res, res, ch), default, np.float32)
            img = np.asarray(img, np.float32)
            if img.ndim == 2:
                img = img[..., None]
            if img.shape[-1] < ch:
                img = np.repeat(img, ch, axis=-1)[..., :ch]
            img = img[..., :ch]
            return _resize_pow2(img, res)

        rgb = fetch("base_color", 3)
        alpha = fetch("alpha", 1)
        if m.get("base_color") is not None and np.asarray(m["base_color"]).ndim == 3 \
                and np.asarray(m["base_color"]).shape[-1] == 4:
            alpha = _resize_pow2(np.asarray(m["base_color"], np.float32)[..., 3:4], res)
        occ = fetch("occlusion", 1)
        rough = fetch("roughness", 1)
        metal = fetch("metalness", 1)
        emis = fetch("emissive", 1)
        nrm_img = m.get("normal")
        if nrm_img is None:
            nxy = np.zeros((res, res, 2), np.float32)
        else:
            nrm_img = np.asarray(nrm_img, np.float32)[..., :2]
            if nrm_img.min() >= 0.0:   # [0,1] image convention -> [-1,1]
                nrm_img = nrm_img * 2.0 - 1.0
            nxy = _resize_pow2(nrm_img, res)
        mats.append(np.concatenate([rgb, alpha, occ, rough, metal, emis, nxy],
                                   axis=-1))

    stack = np.stack(mats)  # (M, res, res, 10)
    levels = [stack]
    while levels[-1].shape[1] > 1:
        levels.append(
            np.stack([_box_downsample(x) for x in levels[-1]])
        )
    return TextureSet(levels=[jnp.asarray(l) for l in levels])


def _resize_pow2(img: np.ndarray, res: int) -> np.ndarray:
    """Nearest-neighbor host-side resize to (res, res, C)."""
    h, w = img.shape[:2]
    yi = (np.arange(res) * h // res).clip(0, h - 1)
    xi = (np.arange(res) * w // res).clip(0, w - 1)
    return np.ascontiguousarray(img[yi][:, xi], dtype=np.float32)


def constant_texture_set(n_materials: int, res: int = 4) -> TextureSet:
    """All-ones set: textured and untextured scenes share one shading path."""
    return build_texture_set([{} for _ in range(n_materials)], res=res)


def _fetch_bilinear(level: jnp.ndarray, mat: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """level: (M, h, w, 10); mat: (N,) int32; uv: (N, 2) in [0,1) wrap."""
    h, w = level.shape[1], level.shape[2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)

    def tap(yy, xx):
        yy = jnp.mod(yy, h)
        xx = jnp.mod(xx, w)
        return level[mat, yy, xx]

    c00 = tap(y0, x0)
    c01 = tap(y0, x0 + 1)
    c10 = tap(y0 + 1, x0)
    c11 = tap(y0 + 1, x0 + 1)
    return (
        c00 * (1 - fx) * (1 - fy)
        + c01 * fx * (1 - fy)
        + c10 * (1 - fx) * fy
        + c11 * fx * fy
    )


def sample(ts: TextureSet, mat: jnp.ndarray, uv: jnp.ndarray, mip) -> jnp.ndarray:
    """Trilinear sample: (N,) material ids, (N, 2) uv, (N,) continuous mip.

    Returns (N, 10) = rgba ++ orme ++ normal-XY. Mip is clamped to the pyramid; the two
    adjacent levels are fetched with bilinear taps and lerped — the analogue of
    ``SampleLevel`` with the ray-cone mip (RaytracingShared.hlsli:154-189).

    Implementation note: this evaluates every mip level and masks (static
    unroll over the pyramid) — levels are cheap past the first two, and it
    avoids dynamic-shape dispatch under jit.
    """
    n_mips = ts.n_mips
    mip = jnp.clip(jnp.asarray(mip, jnp.float32), 0.0, n_mips - 1.0)
    l0 = jnp.floor(mip).astype(jnp.int32)
    frac = (mip - l0.astype(jnp.float32))[..., None]

    out0 = jnp.zeros(uv.shape[:-1] + (10,), ts.levels[0].dtype)
    out1 = jnp.zeros_like(out0)
    for l, level in enumerate(ts.levels):
        v = _fetch_bilinear(level, mat, uv)
        out0 = jnp.where((l0 == l)[..., None], v, out0)
        out1 = jnp.where((jnp.minimum(l0 + 1, n_mips - 1) == l)[..., None], v, out1)
    return out0 * (1.0 - frac) + out1 * frac


def sample_alpha(ts: TextureSet, mat: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Point-sampled alpha at a coarse-ish mip for the any-hit alpha test
    (CheckNonOpaqueTriangle, RaytracingShared.hlsli:191-247 uses mip 3)."""
    l = min(3, ts.n_mips - 1)
    return _fetch_bilinear(ts.levels[l], mat, uv)[..., 3]
