"""Camera ray generation and screen-space transforms.

Equivalent of `GetCameraRay` (Shared.hlsli:389-409: pinhole + cosine-disk DoF
aperture sampling) plus the matrix plumbing UpdateConstantBuffer derives
(NRDSample.cpp:3643-3769). All functions are batched over pixels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nrdsample_tpu.mathlib import geometry as geo, rng, sampling
from nrdsample_tpu.scene.types import Camera

_HI = jax.lax.Precision.HIGHEST  # full f32 products (no TF32 on GPUs)


def pixel_centers(width: int, height: int) -> jnp.ndarray:
    """Continuous pixel centers [(H*W), 2] in pixel units, row-major."""
    x = jnp.arange(width, dtype=jnp.float32) + 0.5
    y = jnp.arange(height, dtype=jnp.float32) + 0.5
    gx, gy = jnp.meshgrid(x, y)
    return jnp.stack([gx.ravel(), gy.ravel()], axis=-1)


def view_dir_from_uv(cam: Camera, uv: jnp.ndarray) -> jnp.ndarray:
    """uv in [0,1] (y down) -> unit view-space direction (z forward)."""
    x = (uv[..., 0] * 2.0 - 1.0) * cam.tan_half_fov_y * cam.aspect
    y = (1.0 - uv[..., 1] * 2.0) * cam.tan_half_fov_y
    d = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)
    return geo.normalize(d)


def camera_rays(cam: Camera, width: int, height: int, pixel_idx: jnp.ndarray,
                frame, sample_dim: int = 0, antialias: bool = True):
    """Generate world-space primary rays for flat pixel indices.

    Returns (origin [N,3], direction [N,3], uv [N,2]). Applies sub-pixel jitter
    (cam.jitter, the TAA Halton jitter) and thin-lens DoF when aperture > 0 —
    matching GetCameraRay's structure: pinhole direction from the reconstructed
    view position, origin perturbed on the aperture disk, re-aimed at the focal
    plane (Shared.hlsli:389-409).
    """
    px = (pixel_idx % width).astype(jnp.float32) + 0.5
    py = (pixel_idx // width).astype(jnp.float32) + 0.5
    jx = cam.jitter[0]
    jy = cam.jitter[1]
    uv = jnp.stack(
        [(px + jx) / width, (py + jy) / height], axis=-1
    )
    d_view = view_dir_from_uv(cam, uv)

    # thin-lens: sample aperture disk with a cosine-disk distribution
    rnd = rng.uniform2(pixel_idx, frame, 1000 + sample_dim)
    disk = sampling.cosine_ray(rnd)[..., :2]  # disk distribution in xy
    offset = disk * cam.aperture
    xv = jnp.stack(
        [
            uv[..., 0] * 0.0 + offset[..., 0],
            offset[..., 1],
            jnp.zeros_like(offset[..., 0]),
        ],
        axis=-1,
    )
    focal_pt = d_view * cam.focal_distance[..., None]
    d_view_dof = geo.normalize(focal_pt - xv)
    use_dof = cam.aperture > 0.0
    d_view = jnp.where(use_dof, d_view_dof, d_view)

    r = cam.view_to_world[:3, :3]
    origin_w = geo.affine_transform(cam.view_to_world, xv)
    dir_w = jnp.einsum("ij,...j->...i", r, d_view, precision=_HI)
    return origin_w, geo.normalize(dir_w), uv


def world_to_view_z(cam: Camera, p: jnp.ndarray) -> jnp.ndarray:
    """Positive forward depth of world points."""
    v = geo.affine_transform(cam.world_to_view, p)
    return v[..., 2]


def world_to_uv(cam: Camera, p: jnp.ndarray, prev: bool = False) -> jnp.ndarray:
    """Project world point to screen uv in [0,1] (y down), unjittered."""
    w2v = cam.world_to_view_prev if prev else cam.world_to_view
    v = geo.affine_transform(w2v, p)
    z = jnp.maximum(v[..., 2], 1e-6)
    x = v[..., 0] / (z * cam.tan_half_fov_y * cam.aspect)
    y = v[..., 1] / (z * cam.tan_half_fov_y)
    return jnp.stack([x * 0.5 + 0.5, 0.5 - y * 0.5], axis=-1)


def get_motion(cam: Camera, x: jnp.ndarray, x_prev: jnp.ndarray, width: int, height: int):
    """2.5D motion vector in (pixels, pixels, viewZ delta) — GetMotion
    (Shared.hlsli:318-335)."""
    uv = world_to_uv(cam, x, prev=False)
    uv_prev = world_to_uv(cam, x_prev, prev=True)
    mxy = (uv_prev - uv) * jnp.array([width, height], jnp.float32)
    vz = world_to_view_z(cam, x)
    vz_prev = geo.affine_transform(cam.world_to_view_prev, x_prev)[..., 2]
    return jnp.concatenate([mxy, (vz_prev - vz)[..., None]], axis=-1)


def unproject_scale(cam: Camera, height: int) -> jnp.ndarray:
    """World size of one pixel at unit viewZ (the reference's gUnproject,
    NRDSample.cpp UpdateConstantBuffer): 2 * tan(fov/2) / height."""
    return 2.0 * cam.tan_half_fov_y / height


def advance_frame(cam: Camera, jitter: jnp.ndarray, view_to_world: jnp.ndarray | None = None) -> Camera:
    """Roll current -> prev and install new jitter/matrices (per-frame camera step)."""
    import dataclasses

    return dataclasses.replace(
        cam,
        view_to_world=cam.view_to_world if view_to_world is None else view_to_world,
        view_to_world_prev=cam.view_to_world,
        jitter=jitter,
        jitter_prev=cam.jitter,
    )
