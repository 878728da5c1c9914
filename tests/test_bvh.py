"""BVH build + traversal correctness: BVH8 results must match the dense
intersector exactly (same closest hit) on random scenes."""

import jax.numpy as jnp
import numpy as np
import pytest

from nrdsample_tpu.ops import intersect, traversal
from nrdsample_tpu.scene import bvh as bvh_mod
from nrdsample_tpu.scene import procedural


def _random_rays(n, extent=30.0, seed=1):
    rs = np.random.RandomState(seed)
    o = (rs.rand(n, 3).astype(np.float32) - 0.5) * extent
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.fixture(scope="module")
def soup():
    return procedural.random_soup(num_tris=3000, extent=20.0, seed=3)


class TestBvhBuild:
    def test_leaves_cover_all_triangles(self, soup):
        bvh, order = bvh_mod.build_bvh8(
            np.asarray(soup.tris.p0), np.asarray(soup.tris.e1), np.asarray(soup.tris.e2)
        )
        meta = np.asarray(bvh.child_meta)
        covered = np.zeros(soup.num_tris, bool)
        leaf = meta <= -2
        start, count = bvh_mod.decode_leaf(meta[leaf])
        for s, c in zip(start, count):
            covered[s : s + c] = True
        assert covered.all()
        assert sorted(order.tolist()) == list(range(soup.num_tris))

    def test_child_bounds_contain_triangles(self, soup):
        tris = soup.tris
        bvh, order = bvh_mod.build_bvh8(
            np.asarray(tris.p0), np.asarray(tris.e1), np.asarray(tris.e2)
        )
        p0 = np.asarray(tris.p0)[order]
        p1 = p0 + np.asarray(tris.e1)[order]
        p2 = p0 + np.asarray(tris.e2)[order]
        meta = np.asarray(bvh.child_meta)
        cmin = np.asarray(bvh.child_min)
        cmax = np.asarray(bvh.child_max)
        for ni in range(meta.shape[0]):
            for k in range(8):
                m = meta[ni, k]
                if m <= -2:
                    s, c = bvh_mod.decode_leaf(np.array(m))
                    pts = np.concatenate([p0[s : s + c], p1[s : s + c], p2[s : s + c]])
                    assert (pts >= cmin[ni, k] - 1e-3).all()
                    assert (pts <= cmax[ni, k] + 1e-3).all()

    def test_depth_reasonable(self, soup):
        bvh, _ = bvh_mod.build_bvh8(
            np.asarray(soup.tris.p0), np.asarray(soup.tris.e1), np.asarray(soup.tris.e2)
        )
        assert bvh_mod.max_depth_estimate(bvh) <= 12


class TestTraversalMatchesDense:
    def test_closest_hit_parity(self, soup):
        tris = soup.tris
        ctx, _ = traversal.build_context(tris, mode="bvh8")
        o, d = _random_rays(512)
        dense = intersect.intersect_dense(o, d, ctx.tris.p0, ctx.tris.e1, ctx.tris.e2)
        wide = traversal.traverse_bvh8(o, d, ctx.bvh, ctx.tris.p0, ctx.tris.e1, ctx.tris.e2)
        t_d = np.asarray(dense["t"])
        t_w = np.asarray(wide["t"])
        np.testing.assert_allclose(t_w, t_d, rtol=1e-4, atol=1e-4)
        hit_d = np.asarray(dense["tri"]) >= 0
        hit_w = np.asarray(wide["tri"]) >= 0
        np.testing.assert_array_equal(hit_w, hit_d)
        # where both hit, same triangle unless coplanar tie (t equal)
        both = hit_d & hit_w
        same = np.asarray(dense["tri"])[both] == np.asarray(wide["tri"])[both]
        close_t = np.abs(t_d[both] - t_w[both]) < 1e-4
        assert np.all(same | close_t)

    def test_any_hit_parity(self, soup):
        tris = soup.tris
        ctx, _ = traversal.build_context(tris, mode="bvh8")
        o, d = _random_rays(512, seed=7)
        t_max = jnp.full((512,), 5.0)
        dense = intersect.occluded_dense(o, d, ctx.tris.p0, ctx.tris.e1, ctx.tris.e2, t_max)
        wide = traversal.occluded_bvh8(o, d, ctx.bvh, ctx.tris.p0, ctx.tris.e1, ctx.tris.e2, t_max)
        np.testing.assert_array_equal(np.asarray(wide), np.asarray(dense))


class TestClusterMatchesDense:
    """ops/cluster.py (the clustered traversal) must agree with brute force."""

    def test_closest_hit_parity(self, soup):
        ctx, _ = traversal.build_context(soup.tris, mode="cluster")
        o, d = _random_rays(512, seed=11)
        tr = ctx.tris
        dense = intersect.intersect_dense(o, d, tr.p0, tr.e1, tr.e2)
        res = traversal.closest_hit(ctx, o, d)
        np.testing.assert_allclose(
            np.asarray(res["t"]), np.asarray(dense["t"]), rtol=1e-4, atol=1e-4
        )
        np.testing.assert_array_equal(
            np.asarray(res["tri"]) >= 0, np.asarray(dense["tri"]) >= 0
        )

    def test_any_hit_parity(self, soup):
        ctx, _ = traversal.build_context(soup.tris, mode="cluster")
        o, d = _random_rays(512, seed=13)
        tr = ctx.tris
        t_max = jnp.full((512,), 5.0)
        dense = intersect.occluded_dense(o, d, tr.p0, tr.e1, tr.e2, t_max)
        res = traversal.any_hit(ctx, o, d, t_max)
        np.testing.assert_array_equal(np.asarray(res), np.asarray(dense))

    def test_ray_chunking(self, soup):
        from nrdsample_tpu.ops import cluster as cl

        ctx, _ = traversal.build_context(soup.tris, mode="cluster")
        o, d = _random_rays(300, seed=17)
        tr = ctx.tris
        full = cl.closest_hit_clustered(ctx.clusters, tr, o, d)
        chunked = cl.closest_hit_clustered(ctx.clusters, tr, o, d, ray_chunk=128)
        np.testing.assert_allclose(
            np.asarray(chunked["t"]), np.asarray(full["t"]), rtol=1e-5
        )
        np.testing.assert_array_equal(
            np.asarray(chunked["tri"]), np.asarray(full["tri"])
        )


class TestDenseIntersect:
    def test_single_triangle_analytic(self):
        p0 = jnp.array([[0.0, 0.0, 0.0]])
        e1 = jnp.array([[1.0, 0.0, 0.0]])
        e2 = jnp.array([[0.0, 1.0, 0.0]])
        o = jnp.array([[0.25, 0.25, 1.0], [2.0, 2.0, 1.0]])
        d = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
        res = intersect.intersect_dense(o, d, p0, e1, e2)
        assert float(res["t"][0]) == pytest.approx(1.0, abs=1e-6)
        assert int(res["tri"][0]) == 0
        assert int(res["tri"][1]) == -1
        assert float(res["u"][0]) == pytest.approx(0.25, abs=1e-5)
        assert float(res["v"][0]) == pytest.approx(0.25, abs=1e-5)

    def test_backface_hits(self):
        p0 = jnp.array([[0.0, 0.0, 0.0]])
        e1 = jnp.array([[1.0, 0.0, 0.0]])
        e2 = jnp.array([[0.0, 1.0, 0.0]])
        o = jnp.array([[0.25, 0.25, -1.0]])
        d = jnp.array([[0.0, 0.0, 1.0]])
        res = intersect.intersect_dense(o, d, p0, e1, e2)
        assert int(res["tri"][0]) == 0
