"""Flat-array (SoA) scene representation — the array answer to the reference's
`utils::Scene` + `PrimitiveData`/`InstanceData` (Shared.hlsli:172-205).

Everything is a registered dataclass pytree of jnp arrays so scenes can be jit
arguments, donated, sharded, and differentiated (material/emission gradients are
first-class: BASELINE.json asks for albedo/roughness/metalness/emission/light
grads).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Materials:
    """Per-material parameter arrays (differentiable leaves)."""

    base_color: jnp.ndarray   # (M, 3)
    metalness: jnp.ndarray    # (M,)
    roughness: jnp.ndarray    # (M,)
    emission: jnp.ndarray     # (M, 3) radiance scale (linear)
    ior: jnp.ndarray          # (M,) index of refraction (glass)
    flags: jnp.ndarray        # (M,) int32 FLAG_* bits (config.py)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TriangleSoA:
    """Pre-transformed world-space triangle SoA consumed by intersection kernels.

    The equivalent of the packed `PrimitiveData` buffer (NRDSample.cpp:3308-3393)
    fused with the BLAS geometry: p0/e1/e2 give the watertight intersection basis,
    n0..n2/uv0..uv2 give shading attributes.
    """

    p0: jnp.ndarray    # (T, 3)
    e1: jnp.ndarray    # (T, 3) = p1 - p0
    e2: jnp.ndarray    # (T, 3) = p2 - p0
    n0: jnp.ndarray    # (T, 3) vertex normals
    n1: jnp.ndarray    # (T, 3)
    n2: jnp.ndarray    # (T, 3)
    uv0: jnp.ndarray   # (T, 2)
    uv1: jnp.ndarray   # (T, 2)
    uv2: jnp.ndarray   # (T, 2)
    material: jnp.ndarray  # (T,) int32
    world_area: jnp.ndarray  # (T,) for emissive IS + ray-cone spread
    # per-vertex tangents + shared bitangent sign (the reference packs these
    # per vertex, RaytracingShared.hlsli:398-412 DecodeUnitVector(t0..t2) +
    # primitiveData.bitangentSign; here full fp32 SoA — HBM is the budget,
    # not vertex-buffer bytes)
    t0: jnp.ndarray    # (T, 3)
    t1: jnp.ndarray    # (T, 3)
    t2: jnp.ndarray    # (T, 3)
    bitan_sign: jnp.ndarray  # (T,)

    @property
    def count(self) -> int:
        return self.p0.shape[0]

    def geometric_normal(self) -> jnp.ndarray:
        n = jnp.cross(self.e1, self.e2)
        return n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Scene:
    """A complete renderable scene."""

    tris: TriangleSoA
    materials: Materials
    # Emissive importance-sampling list: triangle indices with nonzero emission,
    # padded to a static size with -1 (the emissive-TLAS analogue,
    # NRDSample.cpp:2516-2523 merged-emissive BLAS).
    emissive_tris: jnp.ndarray    # (E,) int32, -1 padded
    emissive_count: jnp.ndarray   # () int32
    # static (hashed into the jit key): whether the scene has any emitters, so
    # the emissive-IS reservoir is only compiled in when it can matter
    has_emissive: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )
    # Material texture pyramids (scene/textures.py TextureSet) or None; the
    # bindless texture array analogue (RaytracingShared.hlsli:14-16)
    textures: object = None
    # static: any material carries FLAG_ALPHA_TEST — compiles in the
    # alpha-tested re-trace loop (CheckNonOpaqueTriangle semantics)
    has_alpha_test: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )
    # Per-instance material scale factors (InstanceData.baseColorAndMetalness-
    # Scale / emissionAndRoughnessScale / normalUvScale,
    # RaytracingShared.hlsli:456-468). Optional pair:
    #   tri_instance: (T,) int32 instance id per triangle
    #   instance_scales: (I, 10) = [baseColor.xyz, metalness, emission.xyz,
    #                               roughness, normalUv.xy]
    # None = all scales 1 (the common case compiles the lookup out).
    tri_instance: object = None
    instance_scales: object = None

    @property
    def num_tris(self) -> int:
        return self.tris.count


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Camera:
    """Camera state incl. previous-frame matrices and jitter.

    Mirrors NRIFramework's `Camera` consumed by UpdateConstantBuffer
    (NRDSample.cpp:3643-3769): view<->world for current and previous frame,
    projection parameters, and the sub-pixel jitter pair.

    View space: x right, y up, z forward; view_z = forward depth > 0.
    """

    view_to_world: jnp.ndarray       # (4, 4)
    view_to_world_prev: jnp.ndarray  # (4, 4)
    tan_half_fov_y: jnp.ndarray      # ()
    aspect: jnp.ndarray              # () width / height
    near_z: jnp.ndarray              # ()
    jitter: jnp.ndarray              # (2,) in pixels, [-0.5, 0.5]
    jitter_prev: jnp.ndarray         # (2,)
    aperture: jnp.ndarray            # () DoF aperture radius (world units)
    focal_distance: jnp.ndarray      # ()
    ortho: jnp.ndarray               # () 0 = perspective

    @property
    def position(self) -> jnp.ndarray:
        return self.view_to_world[:3, 3]

    @property
    def world_to_view(self) -> jnp.ndarray:
        return _invert_rigid(self.view_to_world)

    @property
    def world_to_view_prev(self) -> jnp.ndarray:
        return _invert_rigid(self.view_to_world_prev)


def _invert_rigid(m: jnp.ndarray) -> jnp.ndarray:
    r = m[:3, :3]
    t = m[:3, 3]
    rt = r.T
    out = jnp.eye(4, dtype=m.dtype)
    out = out.at[:3, :3].set(rt)
    out = out.at[:3, 3].set(-jnp.sum(rt * t[None, :], axis=-1))
    return out


def look_at(eye, target, up=(0.0, 0.0, 1.0), fov_y_deg: float = 60.0, aspect: float = 1.0,
            near_z: float = 0.01) -> Camera:
    """Build a Camera pytree from eye/target (world z-up by default, like the
    reference's sun/sky model which treats +Z as up, Shared.hlsli:427-474)."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    cam_up = np.cross(right, fwd)
    v2w = np.eye(4, dtype=np.float32)
    v2w[:3, 0] = right
    v2w[:3, 1] = cam_up
    v2w[:3, 2] = fwd
    v2w[:3, 3] = eye
    v2w = jnp.asarray(v2w)
    return Camera(
        view_to_world=v2w,
        view_to_world_prev=v2w,
        tan_half_fov_y=jnp.float32(np.tan(np.deg2rad(fov_y_deg) * 0.5)),
        aspect=jnp.float32(aspect),
        near_z=jnp.float32(near_z),
        jitter=jnp.zeros(2, jnp.float32),
        jitter_prev=jnp.zeros(2, jnp.float32),
        aperture=jnp.float32(0.0),
        focal_distance=jnp.float32(1.0),
        ortho=jnp.float32(0.0),
    )


def build_triangle_soa(vertices: np.ndarray, indices: np.ndarray, normals: np.ndarray | None,
                       uvs: np.ndarray | None, material: np.ndarray,
                       tangents: np.ndarray | None = None) -> TriangleSoA:
    """Assemble the SoA from indexed mesh arrays (numpy, host side).

    ``tangents``: optional (V, 4) glTF-style per-vertex tangents (xyz +
    bitangent-sign w). When absent they are DERIVED per triangle from the UV
    parameterization (the standard dp/du construction); triangles with a
    degenerate UV chart fall back to an arbitrary tangent of the geometric
    normal. Reference: RaytracingShared.hlsli:398-412 (per-vertex decode)."""
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    p0 = vertices[indices[:, 0]]
    p1 = vertices[indices[:, 1]]
    p2 = vertices[indices[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    gn = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(gn, axis=-1)
    if normals is None:
        gnn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
        n0 = n1 = n2 = gnn
    else:
        normals = np.asarray(normals, np.float32)
        n0, n1, n2 = (normals[indices[:, k]] for k in range(3))
    if uvs is None:
        uv0 = uv1 = uv2 = np.zeros((len(indices), 2), np.float32)
    else:
        uvs = np.asarray(uvs, np.float32)
        uv0, uv1, uv2 = (uvs[indices[:, k]] for k in range(3))
    if tangents is not None:
        tangents = np.asarray(tangents, np.float32)
        t0, t1, t2 = (tangents[indices[:, k], :3] for k in range(3))
        bitan_sign = tangents[indices[:, 0], 3]
    else:
        # derive one tangent per triangle from the UV chart: solve
        # [e1 e2] = [T B] @ [[du1 du2],[dv1 dv2]]  =>  T = (e1*dv2 - e2*dv1)/det
        duv1 = np.asarray(uv1, np.float32) - np.asarray(uv0, np.float32)
        duv2 = np.asarray(uv2, np.float32) - np.asarray(uv0, np.float32)
        det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
        ok = np.abs(det) > 1e-12
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tang = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv[:, None]
        # degenerate chart: arbitrary tangent of the geometric normal
        gnn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
        alt = np.cross(gnn, np.where(np.abs(gnn[:, 2:3]) < 0.9,
                                     np.array([0.0, 0.0, 1.0], np.float32),
                                     np.array([1.0, 0.0, 0.0], np.float32)))
        tlen = np.linalg.norm(tang, axis=-1, keepdims=True)
        good = (ok[:, None]) & (tlen > 1e-12)
        tang = np.where(good, tang / np.maximum(tlen, 1e-20), alt)
        t0 = t1 = t2 = tang.astype(np.float32)
        bitan_sign = np.where(det < 0.0, -1.0, 1.0).astype(np.float32)
    # NOTE: stays host-side numpy — one batched upload happens at the end of
    # build_context (scene_to_device), with no device readbacks during build.
    return TriangleSoA(
        p0=p0, e1=e1, e2=e2,
        n0=np.asarray(n0, np.float32), n1=np.asarray(n1, np.float32),
        n2=np.asarray(n2, np.float32),
        uv0=np.asarray(uv0, np.float32), uv1=np.asarray(uv1, np.float32),
        uv2=np.asarray(uv2, np.float32),
        material=np.asarray(material, np.int32),
        world_area=np.asarray(area, np.float32),
        t0=np.asarray(t0, np.float32), t1=np.asarray(t1, np.float32),
        t2=np.asarray(t2, np.float32),
        bitan_sign=np.asarray(bitan_sign, np.float32),
    )


MAX_EMISSIVE_HARD_CAP = 8192


def make_scene(tris: TriangleSoA, materials: Materials,
               max_emissive: int | None = None) -> Scene:
    """Finalize a scene: derive the emissive triangle list (host side).

    max_emissive=None (default) auto-sizes the padded set: 256 for small
    emitter counts (the dense light-probe path), otherwise the full count
    rounded up to a 128 multiple (the emissive-IS packet path handles big
    sets, render/emissive_is.py) up to MAX_EMISSIVE_HARD_CAP — Bistro-night
    class scenes keep ALL their emitters instead of an area-truncated 256
    (the reference's merged-emissive BLAS holds every emissive triangle,
    NRDSample.cpp:2516-2523)."""
    emission = np.asarray(materials.emission)
    tri_mat = np.asarray(tris.material)
    is_emissive = emission.max(axis=-1)[tri_mat] > 0.0
    ids = np.nonzero(is_emissive)[0].astype(np.int32)
    count = len(ids)
    if max_emissive is None:
        max_emissive = 256 if count <= 256 else min(
            -(-count // 128) * 128, MAX_EMISSIVE_HARD_CAP
        )
    if count > max_emissive:
        # keep the largest-area emitters (budget like the ref's merged-emissive BLAS)
        areas = np.asarray(tris.world_area)[ids]
        ids = ids[np.argsort(-areas)[:max_emissive]]
        count = max_emissive
    padded = np.full(max_emissive, -1, np.int32)
    padded[:count] = ids
    return Scene(
        tris=tris,
        materials=materials,
        emissive_tris=padded,
        emissive_count=np.int32(count),
        has_emissive=bool(count > 0),
    )


def scene_to_device(scene: Scene) -> Scene:
    """One batched host->device transfer of every scene leaf (the analogue of
    UploadStaticData's single staging submit, NRDSample.cpp:3308-3393)."""
    return jax.tree_util.tree_map(jnp.asarray, scene)
