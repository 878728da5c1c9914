"""SHARC hash-grid radiance cache unit tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from nrdsample_tpu.ops import sharc

CAP = 1 << 14  # small capacity for tests
CAM = jnp.zeros(3)


def _mk(n, seed=0):
    rs = np.random.RandomState(seed)
    pos = jnp.asarray(rs.rand(n, 3).astype(np.float32) * 10.0 + 2.0)
    nrm = jnp.zeros((n, 3)).at[:, 2].set(1.0)
    return pos, nrm


class TestSharc:
    def test_update_query_roundtrip(self):
        state = sharc.SharcState.create(CAP)
        pos, nrm = _mk(256)
        rad = jnp.ones((256, 3)) * 2.5
        state = sharc.update(state, pos, nrm, rad, CAM, 0)
        state = sharc.resolve(state, 0)
        out, found = sharc.query(state, pos, nrm, CAM)
        assert float(found.mean()) > 0.95  # collisions may drop a few
        got = np.asarray(out)[np.asarray(found)]
        np.testing.assert_allclose(got, 2.5, rtol=1e-5)

    def test_query_miss_before_insert(self):
        state = sharc.SharcState.create(CAP)
        pos, nrm = _mk(64, seed=3)
        out, found = sharc.query(state, pos, nrm, CAM)
        assert not bool(found.any())
        np.testing.assert_allclose(np.asarray(out), 0.0)

    def test_accumulation_averages(self):
        state = sharc.SharcState.create(CAP)
        pos, nrm = _mk(32, seed=4)
        for f, v in enumerate([1.0, 3.0]):
            state = sharc.update(state, pos, nrm, jnp.full((32, 3), v), CAM, f)
            state = sharc.resolve(state, f)
        out, found = sharc.query(state, pos, nrm, CAM)
        got = np.asarray(out)[np.asarray(found)]
        np.testing.assert_allclose(got, 2.0, rtol=1e-4)  # mean of 1 and 3

    def test_normal_orientation_separates_cells(self):
        state = sharc.SharcState.create(CAP)
        pos = jnp.asarray(np.full((16, 3), 5.0, np.float32))
        n_up = jnp.zeros((16, 3)).at[:, 2].set(1.0)
        n_dn = jnp.zeros((16, 3)).at[:, 2].set(-1.0)
        state = sharc.update(state, pos, n_up, jnp.ones((16, 3)), CAM, 0)
        state = sharc.update(state, pos, n_dn, jnp.full((16, 3), 9.0), CAM, 0)
        state = sharc.resolve(state, 0)
        up, fu = sharc.query(state, pos, n_up, CAM)
        dn, fd = sharc.query(state, pos, n_dn, CAM)
        assert bool(fu.all()) and bool(fd.all())
        np.testing.assert_allclose(np.asarray(up), 1.0, rtol=1e-4)
        np.testing.assert_allclose(np.asarray(dn), 9.0, rtol=1e-4)

    def test_stale_eviction(self):
        state = sharc.SharcState.create(CAP)
        pos, nrm = _mk(32, seed=5)
        state = sharc.update(state, pos, nrm, jnp.ones((32, 3)), CAM, 0)
        state = sharc.resolve(state, 0)
        # advance far beyond staleness with no touches
        state = sharc.resolve(state, 1000)
        out, found = sharc.query(state, pos, nrm, CAM)
        assert not bool(found.any())

    def test_level_increases_with_distance(self):
        near = jnp.array([[1.0, 0, 0]])
        far = jnp.array([[100.0, 0, 0]])
        l_near = sharc.grid_level(near, CAM)
        l_far = sharc.grid_level(far, CAM)
        assert float(l_far[0]) > float(l_near[0])
        assert float(sharc.voxel_size(l_far)[0]) > float(sharc.voxel_size(l_near)[0])


def _update_sequential(keys, accum, last_seen, slot, csum, rad, mask, frame):
    """numpy oracle of sharc.update: one sample after another, in index
    order (SharcUpdateHit's claim, then accumulation against the final
    keys)."""
    keys, accum, last_seen = keys.copy(), accum.copy(), last_seen.copy()
    cur = keys[slot].copy()
    for i in range(len(slot)):
        keys[slot[i]] = csum[i] if (mask[i] and cur[i] == 0) else cur[i]
    owned = mask & (keys[slot] == csum)
    for i in range(len(slot)):
        if owned[i]:
            accum[slot[i], :3] += rad[i]
            accum[slot[i], 3] += 1.0
        last_seen[slot[i]] = frame if owned[i] else last_seen[slot[i]]
    return keys, accum, last_seen


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_claims_like_sequential_pass(seed):
    """Many samples per slot (some masked off, some slots already owned):
    the claimed keys and last_seen equal a one-sample-at-a-time pass exactly,
    the accumulated radiance to rounding. The claim is a scatter-max of
    sample indices and last_seen a scatter of one value, so no device's
    scatter order can change either."""
    rs = np.random.RandomState(seed)
    cap, n = 64, 2048
    state = sharc.SharcState.create(cap)
    pos = jnp.asarray(rs.rand(n, 3).astype(np.float32) * 6.0 + 2.0)
    nrm = jnp.asarray(rs.normal(size=(n, 3)).astype(np.float32))
    rad = rs.rand(n, 3).astype(np.float32)
    mask = rs.rand(n) < 0.7
    # frame 0 owns some slots; frame 5 competes for the rest
    state = sharc.update(state, pos[:200], nrm[:200], jnp.asarray(rad[:200]),
                         CAM, 0, mask=jnp.asarray(mask[:200]))
    slot, csum, _ = sharc.slot_and_checksum(pos, nrm, CAM, cap)
    assert len(np.unique(np.asarray(slot))) < n // 8   # heavy duplication
    got = sharc.update(state, pos, nrm, jnp.asarray(rad), CAM, 5,
                       mask=jnp.asarray(mask))
    want = _update_sequential(
        np.asarray(state.keys), np.asarray(state.accum),
        np.asarray(state.last_seen), np.asarray(slot), np.asarray(csum), rad,
        mask, 5)
    np.testing.assert_array_equal(np.asarray(got.keys), want[0])
    np.testing.assert_allclose(np.asarray(got.accum), want[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.last_seen), want[2])
    assert (want[0] != 0).sum() > 0 and (want[2] == 5).sum() > 0


def test_lod_dither_blends_ring_boundary():
    """With a uniform dither, points exactly at a LOD ring land in BOTH
    adjacent levels (~50/50), while the undithered level is deterministic and
    dither=0.5 reproduces it exactly."""
    import numpy as np

    n = 4096
    # distance 2^2.5 -> log2 = 2.5: the rounding boundary of the undithered
    # floor(log2 + 0.5) level
    pos = jnp.tile(jnp.array([[2.0 ** 2.5, 0.0, 0.0]]), (n, 1))
    cam = jnp.zeros((3,))
    base = sharc.grid_level(pos, cam)
    d = jnp.linspace(0.0, 1.0, n, endpoint=False)
    lv = np.asarray(sharc.grid_level(pos, cam, dither=d))
    lo, hi = lv.min(), lv.max()
    assert hi == lo + 1.0
    frac_hi = float((lv == hi).mean())
    assert 0.4 < frac_hi < 0.6
    np.testing.assert_array_equal(
        np.asarray(sharc.grid_level(pos, cam, dither=jnp.full((n,), 0.5))),
        np.asarray(base),
    )
