"""Budget-fallback (chunked) paths must equal their unchunked counterparts.

The memory-budget fallbacks fire only at frame scale on the device, so
without these tests they would have no CPU coverage. Each budget is shrunk
via monkeypatch so every chunked branch runs on small shapes and is asserted
bit-equal (or allclose) against the dense branch. The worklist sort the
traversal kernel consumes is checked here too.

Reference bar: the TraceRayInline hot loop the worklist sort feeds
(/root/reference/Shaders/RaytracingShared.hlsli:314-422).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nrdsample_tpu.ops import packet
from nrdsample_tpu.render import emissive_is
from nrdsample_tpu.ops.cluster import build_clusters
from nrdsample_tpu.scene import procedural


@pytest.mark.parametrize("c", [20, 600])
def test_sort_worklists_packed_keys(c):
    """_sort_worklists' single packed int32 sort: per row the order is a
    permutation whose first `count` entries are exactly the hit clusters,
    keys ascend, each key is a lower bound of the cluster's float key (low
    mantissa bits dropped), and misses sort after every hit."""
    rs = np.random.RandomState(c)
    key = jnp.asarray(rs.uniform(0.1, 50.0, size=(32, c)).astype(np.float32))
    hit = jnp.asarray(rs.rand(32, c) > 0.4)
    order, keys, count = map(np.asarray, jax.jit(packet._sort_worklists)(key, hit))
    key, hit = np.asarray(key), np.asarray(hit)
    for b in range(32):
        assert sorted(order[b].tolist()) == list(range(c))
        n = int(count[b])
        assert n == hit[b].sum()
        assert set(order[b, :n].tolist()) == set(np.nonzero(hit[b])[0].tolist())
        assert (keys[b, 1:] >= keys[b, :-1]).all()
        assert (keys[b, :n] <= key[b, order[b, :n]]).all()
        assert (keys[b, :n] >= key[b, order[b, :n]] * (1 - 2.0 ** -8)).all()
        assert np.isinf(keys[b, n:]).all()


def test_stage1_block_min_chunked(monkeypatch):
    """_block_min_entry's lax.map fallback (ops/packet.py:640-660) must match
    the single-shot dense entry matrix."""
    scene = procedural.cornell_box()
    cs, _, _ = build_clusters(scene.tris)
    rs = np.random.RandomState(0)
    r, block = 512, 64
    origin = jnp.asarray(rs.uniform(-1, 1, (r, 3)).astype(np.float32))
    d = rs.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    direction = jnp.asarray(d)
    t_max = jnp.full((r,), packet.T_MAX)
    dense = np.asarray(packet._block_min_entry(origin, direction, cs, t_max, block))
    monkeypatch.setattr(packet, "_STAGE1_BYTES_BUDGET", 1)
    chunked = np.asarray(packet._block_min_entry(origin, direction, cs, t_max, block))
    np.testing.assert_array_equal(dense, chunked)


def test_light_probe_chunked(monkeypatch):
    """light_probe's frame-scale chunking (render/emissive_is.py:100-124),
    incl. the ragged-tail padding path, must match the unchunked probe."""
    scene = procedural.cornell_box()
    em = emissive_is.build_emissive_set(scene)
    rs = np.random.RandomState(2)
    r = 333  # deliberately not a multiple of the shrunken chunk
    origin = jnp.asarray(rs.uniform(-0.8, 0.8, (r, 3)).astype(np.float32))
    # aim half the rays at the light so the >0 sanity check is meaningful
    target = np.asarray(em["p0"] + 0.5 * em["e1"] + 0.5 * em["e2"])
    target = target[np.asarray(em["intensity"]) > 0][:1]
    d = rs.normal(size=(r, 3)).astype(np.float32)
    d[::2] = target - np.asarray(origin)[::2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    direction = jnp.asarray(d)
    dense = np.asarray(emissive_is.light_probe(em, origin, direction))
    monkeypatch.setattr(emissive_is, "_PROBE_CHUNK", 64)
    chunked = np.asarray(emissive_is.light_probe(em, origin, direction))
    np.testing.assert_allclose(dense, chunked, rtol=1e-6, atol=1e-6)
    assert (dense > 0).any()  # some rays actually see the cornell light
