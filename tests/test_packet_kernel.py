"""Packet traversal kernel (ops/packet.py, Pallas through Triton) in interpret
mode against the dense intersector and the XLA cluster scan (CPU-runnable).

On the GPU the same kernel is compiled by Triton; `chip_smoke.py` compares it
with the cluster scan there at real widths.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nrdsample_tpu.ops import cluster, intersect, packet
from nrdsample_tpu.ops.cluster import build_clusters
from nrdsample_tpu.scene import procedural

T_MAX = packet.T_MAX


@functools.lru_cache(maxsize=None)
def _clusters(scene_name: str):
    scene = {
        "shaderballs": procedural.shader_balls,
        "soup": lambda: procedural.random_soup(20_000),
    }[scene_name]()
    cs, tris_p, _ = build_clusters(scene.tris)
    return cs, tris_p


def _rays(scene_name: str, n_rays: int, seed: int):
    rs = np.random.RandomState(seed)
    if scene_name == "shaderballs":
        origin = rs.uniform(-6, 6, (n_rays, 3)).astype(np.float32) + [0, -9, 4]
    else:
        origin = rs.uniform(-40, 40, (n_rays, 3)).astype(np.float32)
    d = rs.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(origin, jnp.float32), jnp.asarray(d)


def _dense(tris_p, origin, direction, t_max=T_MAX):
    return intersect.intersect_dense(
        origin, direction, tris_p.p0, tris_p.e1, tris_p.e2, t_max=t_max)


def _assert_same_hits(res, ref, min_hits=10):
    t, t_ref = np.asarray(res["t"]), np.asarray(ref["t"])
    tri, tri_ref = np.asarray(res["tri"]), np.asarray(ref["tri"])
    hit, hit_ref = tri >= 0, tri_ref >= 0
    assert hit_ref.sum() >= min_hits  # the rays actually hit the scene
    np.testing.assert_array_equal(hit, hit_ref)
    np.testing.assert_allclose(t, t_ref, rtol=1e-4, atol=1e-4)
    # a different triangle is only acceptable on a shared-edge tie (same t)
    same = tri == tri_ref
    np.testing.assert_allclose(t[~same], t_ref[~same], rtol=1e-6, atol=1e-6)
    for k in ("u", "v"):
        np.testing.assert_allclose(np.asarray(res[k])[hit & same],
                                   np.asarray(ref[k])[hit & same],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_rays", [512, 300])
@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("scene_name", ["shaderballs", "soup"])
def test_closest_hit_matches_dense(scene_name, sort, n_rays):
    """R not a multiple of BLOCK_RAYS pads one partial packet."""
    cs, tris_p = _clusters(scene_name)
    origin, direction = _rays(scene_name, n_rays, seed=n_rays)
    res = packet.closest_hit_packet(cs, origin, direction, interpret=True,
                                    sort=sort)
    assert res["t"].shape == (n_rays,) and res["tri"].dtype == jnp.int32
    _assert_same_hits(res, _dense(tris_p, origin, direction))


@pytest.mark.parametrize("per_ray", [False, True])
@pytest.mark.parametrize("sort", [False, True])
def test_any_hit_matches_dense(sort, per_ray):
    cs, tris_p = _clusters("shaderballs")
    origin, direction = _rays("shaderballs", 512, seed=1)
    if per_ray:
        t_max = jnp.asarray(np.random.RandomState(4).uniform(0.5, 12.0, 512),
                            jnp.float32)
    else:
        t_max = jnp.full((512,), 8.0, jnp.float32)
    blocked = packet.any_hit_packet(cs, origin, direction, t_max,
                                    interpret=True, sort=sort)
    ref = intersect.occluded_dense(origin, direction, tris_p.p0, tris_p.e1,
                                   tris_p.e2, t_max=t_max)
    assert np.asarray(ref).sum() > 20
    np.testing.assert_array_equal(np.asarray(blocked), np.asarray(ref))


@pytest.mark.parametrize("sort", [False, True])
def test_bounded_t_max(sort):
    """Per-ray t_max: hits beyond it are misses reporting t = t_max."""
    cs, tris_p = _clusters("shaderballs")
    origin, direction = _rays("shaderballs", 384, seed=5)
    t_max = jnp.asarray(np.random.RandomState(6).uniform(1.0, 10.0, 384),
                        jnp.float32)
    res = packet.closest_hit_packet(cs, origin, direction, t_max,
                                    interpret=True, sort=sort)
    ref = _dense(tris_p, origin, direction, t_max)
    _assert_same_hits(res, ref)
    miss = np.asarray(ref["tri"]) < 0
    np.testing.assert_allclose(np.asarray(res["t"])[miss], np.asarray(t_max)[miss])


@pytest.mark.parametrize("any_hit", [False, True])
def test_empty_worklists(any_hit):
    """Rays that enter no cluster walk nothing and miss."""
    cs, _ = _clusters("shaderballs")
    n = 256
    origin = jnp.tile(jnp.asarray([[0.0, 0.0, 500.0]]), (n, 1))
    direction = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (n, 1))
    order, keys, count = packet._block_worklists(
        origin, direction, cs, jnp.full((n,), T_MAX), packet.BLOCK_RAYS)
    assert int(jnp.max(count)) == 0
    assert bool(jnp.all(keys[:, 0] >= T_MAX))
    if any_hit:
        out = packet.any_hit_packet(cs, origin, direction, 100.0, interpret=True)
        assert not np.asarray(out).any()
    else:
        res = packet.closest_hit_packet(cs, origin, direction, interpret=True)
        assert (np.asarray(res["tri"]) == -1).all()
        np.testing.assert_allclose(np.asarray(res["t"]), T_MAX)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("sort", [False, True])
def test_supercluster_stage1_matches_dense(monkeypatch, sort, any_hit):
    """The hierarchical stage 1 (supercluster keys + per-block interval
    refinement) is forced on a small scene by patching the flat threshold."""
    monkeypatch.setattr(packet, "FLAT_WORKLIST_MAX_C", 4)
    cs, tris_p = _clusters("soup")
    assert cs.count > 4
    origin, direction = _rays("soup", 256, seed=11)
    if any_hit:
        t_max = jnp.full((256,), 30.0, jnp.float32)
        got = packet.any_hit_packet(cs, origin, direction, t_max,
                                    interpret=True, sort=sort)
        ref = intersect.occluded_dense(origin, direction, tris_p.p0,
                                       tris_p.e1, tris_p.e2, t_max=t_max)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    else:
        res = packet.closest_hit_packet(cs, origin, direction, interpret=True,
                                        sort=sort)
        _assert_same_hits(res, _dense(tris_p, origin, direction))


@pytest.mark.parametrize("tile", [8, 16, 128])
def test_triangle_tile_width(monkeypatch, tile):
    """Every register-tile width that divides CLUSTER_SIZE gives the same
    hits (the width is a tuning constant, not a semantic one)."""
    monkeypatch.setattr(packet, "TRI_TILE", tile)
    cs, tris_p = _clusters("shaderballs")
    origin, direction = _rays("shaderballs", 256, seed=8)
    res = packet.closest_hit_packet(cs, origin, direction, interpret=True)
    _assert_same_hits(res, _dense(tris_p, origin, direction))


def test_matches_cluster_scan():
    """The kernel and the plain XLA path (the CPU route and on-GPU oracle)
    agree, both as whole results."""
    cs, tris_p = _clusters("shaderballs")
    origin, direction = _rays("shaderballs", 512, seed=9)
    res = packet.closest_hit_packet(cs, origin, direction, interpret=True)
    ref = cluster.closest_hit_clustered(cs, tris_p, origin, direction)
    _assert_same_hits(res, ref)


def test_super_worklists_conservative():
    """Hierarchical stage 1 must be CONSERVATIVE vs the flat exact path: every
    flat-hit cluster appears within the super worklist's count, keys ascend,
    and its key is a lower bound of the flat key."""
    cs, _ = _clusters("soup")
    origin, direction = _rays("soup", 512, seed=3)
    tm = jnp.full((512,), T_MAX, jnp.float32)
    block = packet.BLOCK_RAYS
    o_f, k_f, c_f = map(np.asarray, packet._block_worklists(
        origin, direction, cs, tm, block))
    o_s, k_s, c_s = map(np.asarray, packet._block_worklists_super(
        origin, direction, cs, tm, block))
    for b in range(512 // block):
        # direct comparison, not np.diff — inf - inf is NaN
        assert (k_s[b, 1:] >= k_s[b, :-1]).all()
        super_hits = {int(c): k_s[b, i] for i, c in enumerate(o_s[b, :c_s[b]])}
        for i, cid in enumerate(o_f[b, :c_f[b]]):
            assert int(cid) in super_hits, f"block {b}: cluster {cid} missing"
            assert super_hits[int(cid)] <= k_f[b, i] + 1e-3


def test_component_planes_layout():
    """planes[c * 9 + p, k] is component p (p0xyz e1xyz e2xyz) of triangle
    k of cluster c — the row offset the kernel loads."""
    cs, _ = _clusters("shaderballs")
    planes = np.asarray(cs.planes)
    blocks = [np.asarray(cs.p0_b), np.asarray(cs.e1_b), np.asarray(cs.e2_b)]
    assert planes.shape == (cs.count * cluster.N_PLANES, cluster.CLUSTER_SIZE)
    for c in (0, cs.count // 2, cs.count - 1):
        for p in range(cluster.N_PLANES):
            np.testing.assert_array_equal(planes[c * 9 + p],
                                          blocks[p // 3][c, :, p % 3])


def test_refit_rebuilds_planes():
    """instances.refit_context recomputes the kernel's plane table from moved
    geometry (identity motion reproduces the build)."""
    from nrdsample_tpu.ops import traversal
    from nrdsample_tpu.scene import instances

    ctx, scene = traversal.build_context(procedural.shader_balls(), mode="cluster")
    new_ctx = instances.refit_context(ctx, scene)
    np.testing.assert_allclose(np.asarray(new_ctx.clusters.planes),
                               np.asarray(ctx.clusters.planes))
    np.testing.assert_allclose(np.asarray(new_ctx.clusters.bounds_min),
                               np.asarray(ctx.clusters.bounds_min), atol=1e-6)


@pytest.mark.parametrize("scene_fn", [procedural.kitchen,
                                      procedural.interior_night])
def test_emissive_cluster_probe(monkeypatch, scene_fn):
    """The emissive light probe through the kernel (the merged-emissive
    BLAS analogue) equals the dense probe."""
    from nrdsample_tpu.render import emissive_is
    from nrdsample_tpu import platform

    scene = scene_fn()
    monkeypatch.setattr(emissive_is, "DENSE_EMISSIVE_MAX", 0)
    # built on the CPU too: the kernel is chosen at trace time only
    clusters = emissive_is.build_emissive_clusters(scene)
    assert clusters is not None
    monkeypatch.setattr(platform, "use_gpu_kernels", lambda: True)
    monkeypatch.setattr(packet, "closest_hit_packet", functools.partial(
        packet.closest_hit_packet, interpret=True))
    em_dense = emissive_is.build_emissive_set(scene)
    em_pkt = emissive_is.build_emissive_set(scene, clusters=clusters)
    rs = np.random.RandomState(0)
    k, r = 2, 256
    origin = jnp.asarray(rs.uniform(-1.5, 1.5, (r, 3)).astype(np.float32)
                         + [0.0, 0.0, 1.2])
    d = rs.normal(size=(3, k, r)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    planes = tuple(jnp.asarray(p) for p in d)
    active = jnp.ones((k, r), jnp.float32)
    want = np.asarray(emissive_is.light_probe_batch(em_dense, origin, planes, active))
    got = np.asarray(emissive_is.light_probe_batch(em_pkt, origin, planes, active))
    assert (want > 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_grad_traces_through_kernel(monkeypatch):
    """jax.grad of a frame whose traversal runs through the kernel: the
    kernel's inputs are detached, so it needs no VJP, and the material
    gradient equals the one through the plain cluster scan."""
    from nrdsample_tpu.config import Denoiser, RenderConfig, Settings, TracingMode
    from nrdsample_tpu.ops import traversal
    from nrdsample_tpu.pipeline import frame as frame_mod, train as train_mod
    from nrdsample_tpu.scene.types import look_at

    ctx, scene = traversal.build_context(procedural.shader_balls(), mode="cluster")
    cfg = RenderConfig(width=16, height=16, rpp=1, bounce_num=1,
                       tracing_mode=TracingMode.FULL_PROBABILISTIC,
                       denoiser=Denoiser.REFERENCE)
    cam = look_at(eye=[0.0, -9.0, 4.5], target=[0.0, 0.0, 0.8], fov_y_deg=50.0)
    settings = Settings(sun_elevation=jnp.float32(45.0))
    history = frame_mod.History.create(cfg)
    target = jnp.zeros((cfg.n_pixels, 3), jnp.float32)
    mat_diff, mat_rest = train_mod.split_materials(scene.materials)
    args = (mat_diff, mat_rest, scene, cam, settings, history, target)
    # fresh function objects per trace: jit's trace cache is keyed on the
    # function, and the routing below changes what the same function traces
    def vag(*a):
        return jax.value_and_grad(train_mod.make_loss_fn(ctx, cfg))(*a)

    loss_ref, g_ref = jax.jit(lambda *a: vag(*a))(*args)

    monkeypatch.setattr(traversal, "_use_packet", lambda ctx: ctx.mode == "cluster")
    monkeypatch.setattr(packet, "closest_hit_packet", functools.partial(
        packet.closest_hit_packet, interpret=True))
    monkeypatch.setattr(packet, "any_hit_packet", functools.partial(
        packet.any_hit_packet, interpret=True))
    jaxpr = jax.make_jaxpr(lambda *a: vag(*a))(*args)
    assert "pallas_call" in str(jaxpr)
    loss, g = jax.jit(lambda *a: vag(*a))(*args)
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-4)
    for k in g_ref:
        np.testing.assert_allclose(np.asarray(g[k]), np.asarray(g_ref[k]),
                                   rtol=1e-3, atol=1e-5, err_msg=k)
