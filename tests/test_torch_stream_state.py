"""The port's stream data and host state against the JAX package's.

``repro_torch.data.PointStream`` and ``repro_torch.streaming.state`` are
numpy copies of the reference's, so they must agree bit for bit: the
same shards from one seed, the same inflated bounds, the same float64
ledger and the same LRU order. The soundness property of the carried
bounds (the reference's Hypothesis test) runs here as fixed
parametrised cases.
"""
import numpy as np
import pytest

from repro.data import PointStream as JaxPointStream
from repro.streaming import state as jstate
from repro_torch.data import PointStream
from repro_torch.streaming import state


@pytest.mark.parametrize("seed,shard_size,n_shards,d,k", [
    (0, 128, 4, 8, 4), (3, 100, 5, 3, 7), (11, 256, 2, 33, 16)])
def test_point_stream_equals_jax_shard_for_shard(seed, shard_size,
                                                 n_shards, d, k):
    kw = dict(n_shards=n_shards, n_dims=d, k=k, seed=seed)
    ps, js = PointStream(shard_size, **kw), JaxPointStream(shard_size, **kw)
    assert (len(ps), ps.n_points) == (len(js), js.n_points)
    for i in range(n_shards + 2):                   # wraps past the end
        np.testing.assert_array_equal(ps.shard(i), js.shard(i))
    got = list(ps.batches(epochs=2, start=3))
    want = list(js.batches(epochs=2, start=3))
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for step in (0, n_shards + 1):
        a, b = ps.global_batch(step), js.global_batch(step)
        assert a["shard_id"] == b["shard_id"]
        np.testing.assert_array_equal(a["points"], b["points"])


def test_point_stream_over_data_and_npy_equals_jax(tmp_path):
    data = np.random.default_rng(2).standard_normal((100, 3)).astype(
        np.float32)
    path = tmp_path / "pts.npy"
    np.save(path, data)
    for ps, js in ((PointStream(32, data=data), JaxPointStream(32, data=data)),
                   (PointStream.from_npy(str(path), 32),
                    JaxPointStream.from_npy(str(path), 32))):
        assert ps.n_shards == js.n_shards == 4
        for i in range(5):
            np.testing.assert_array_equal(ps.shard(i), js.shard(i))
            assert ps.shard(i).dtype == np.float32


def test_point_stream_determinism_and_coverage():
    ps = PointStream(shard_size=128, n_shards=4, n_dims=8, k=4, seed=3)
    np.testing.assert_array_equal(ps.shard(1), ps.shard(1))
    np.testing.assert_array_equal(ps.shard(5), ps.shard(1))   # wraps
    assert ps.shard(0).shape == (128, 8) and ps.shard(0).dtype == np.float32
    assert not np.array_equal(ps.shard(0), ps.shard(1))

    data = np.arange(100 * 3, dtype=np.float32).reshape(100, 3)
    ds = PointStream(shard_size=32, data=data)
    assert ds.n_shards == 4
    got = np.concatenate([ds.shard(i) for i in range(ds.n_shards)])
    np.testing.assert_array_equal(got, data)   # short last shard kept
    batches = list(ds.batches(epochs=2))
    assert len(batches) == 8
    assert [sid for sid, _ in batches[:4]] == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        PointStream(0, data=data)
    with pytest.raises(ValueError):
        PointStream(8, n_shards=2)


def _entry(mod, rng, n, g, k):
    a = rng.integers(0, k, n).astype(np.int32)
    return mod.ShardBounds(
        assignments=a, ub=rng.uniform(0, 3, n).astype(np.float32),
        lb=rng.uniform(0, 3, (n, g)).astype(np.float32),
        ub_off=rng.uniform(0, 1, k)[a], gdrift_snap=rng.uniform(0, 1, g),
        gmax=int(rng.integers(1, g + 1)), ub_scale=1.5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inflate_bounds_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, g, k = 64, 5, 12
    e = _entry(state, rng, n, g, k)
    je = jstate.ShardBounds(**vars(e))
    cum_c = rng.uniform(1, 3, k)
    cum_g = rng.uniform(1, 3, g)
    for a, b in zip(state.inflate_bounds(e, cum_c, cum_g),
                    jstate.inflate_bounds(je, cum_c, cum_g)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_drift_ledger_matches_jax_in_float64():
    rng = np.random.default_rng(4)
    k, g = 9, 3
    led, jled = state.DriftLedger(k, g), jstate.DriftLedger(k, g)
    for step in range(50):
        drift = rng.uniform(0, 1e-3, k).astype(np.float32).astype(np.float64)
        gdrift = rng.uniform(0, 1e-3, g).astype(np.float32).astype(
            np.float64)
        led.add(drift, gdrift)
        jled.add(drift, gdrift)
        if step % 17 == 0:
            led.add_reseed(step % k, 2.5, step % g)
            jled.add_reseed(step % k, 2.5, step % g)
    assert led.centroid.dtype == led.group.dtype == np.float64
    np.testing.assert_array_equal(led.centroid, jled.centroid)
    np.testing.assert_array_equal(led.group, jled.group)


def test_bound_cache_lru_matches_jax():
    rng = np.random.default_rng(5)
    c, jc = state.BoundCache(3), jstate.BoundCache(3)
    for op, sid in [("put", 0), ("put", 1), ("put", 2), ("get", 0),
                    ("put", 3), ("get", 1), ("drop", 2), ("put", 4),
                    ("put", 5), ("get", 0), ("drop", 9), ("put", 1)]:
        if op == "put":
            e = _entry(state, rng, 4, 2, 3)
            c.put(sid, e)
            jc.put(sid, jstate.ShardBounds(**vars(e)))
        elif op == "get":
            assert (c.get(sid) is None) == (jc.get(sid) is None)
        else:
            c.drop(sid)
            jc.drop(sid)
        assert list(c._d) == list(jc._d) and len(c) == len(jc)


def test_stream_stats_match_jax_fields():
    assert state.StreamStats().to_dict() == jstate.StreamStats().to_dict()


def _check_bounds_survive_drift(seed, steps, scale):
    """inflate_bounds must keep ub an upper bound on d(x, c_assign) and
    lb[., g] a lower bound on the group-g min (without the assigned
    centroid) after any sequence of centroid moves, given only the
    cumulative drift ledgers."""
    rng = np.random.default_rng(seed)
    n, d, k, g = 48, 4, 8, 3
    pts = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    groups = np.arange(k) % g

    d_mat = np.linalg.norm(pts[:, None] - c[None], axis=-1)
    assign = d_mat.argmin(1).astype(np.int32)
    ub = d_mat.min(1).astype(np.float32)
    d_ex = d_mat.copy()
    d_ex[np.arange(n), assign] = np.inf
    lb = np.stack([d_ex[:, groups == j].min(1) for j in range(g)],
                  axis=1).astype(np.float32)

    cum_c = np.zeros(k)
    cum_g = np.zeros(g)
    entry = state.ShardBounds(assign, ub, lb,
                              cum_c[assign].astype(np.float32),
                              cum_g.copy(), g, float(ub.mean()))
    for _ in range(steps):
        move = rng.standard_normal((k, d)) * scale * rng.uniform(size=(k, 1))
        c = c + move
        dr = np.linalg.norm(move, axis=-1)
        cum_c += dr
        for j in range(g):
            cum_g[j] += dr[groups == j].max()

    ub2, lb2 = state.inflate_bounds(entry, cum_c, cum_g)
    d_now = np.linalg.norm(pts[:, None] - c[None], axis=-1)
    assert np.all(ub2 >= d_now[np.arange(n), assign] - 1e-3)
    d_now_ex = d_now.copy()
    d_now_ex[np.arange(n), assign] = np.inf
    for j in range(g):
        assert np.all(lb2[:, j] <= d_now_ex[:, groups == j].min(1) + 1e-3)


# the reference's fixed cases, then fixed draws across its Hypothesis
# strategy's range (seed 0..2^16, 1..6 steps, scale 0.01..2.0)
@pytest.mark.parametrize("seed,steps,scale", [
    (0, 1, 0.05), (1, 3, 0.5), (2, 6, 2.0), (7, 4, 1.0), (11, 2, 0.2),
    (65536, 6, 0.01), (40503, 1, 2.0), (1234, 5, 1.37), (31337, 2, 0.7),
    (999, 6, 1.9), (27182, 3, 0.011), (16180, 4, 0.33),
])
def test_bounds_survive_drift(seed, steps, scale):
    _check_bounds_survive_drift(seed, steps, scale)
