"""The port's resilient streaming fits (``StreamingKMeans.save`` /
``restore`` / ``restore_state`` / ``fit_stream(resilient=True)``,
``repro_torch.streaming.resilient``) on the CPU.

Every single-device case of ``tests/test_resilient.py`` runs against the
port at the reference's sizes (4 shards of 256 points, D 8, K 8): a
stream that crashes between batches, mid-batch with torn host state,
before its first checkpoint or onto a corrupt checkpoint restores and
replays to centroids, counts and drift ledger bit for bit those of an
uninterrupted port stream. The two elastic cases belong to the sharded
drivers (ROADMAP Queue 1 item 9).

Across the packages, in both directions: a stream state saved by one is
restored and saved again by the other with the same manifest and the
same leaves (``stats.ckpt_saves`` and ``stats.restores`` may differ);
the port, continuing JAX's state for an epoch, lands on JAX's labels
with centroids within rtol 1e-5 (bits are not expected: the sums run in
another order, ROADMAP Queue 3 item 1); and a crash-and-replay stream
counts the same restores, replays and saves in both.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans_plusplus as jax_kmeans_plusplus
from repro.data import PointStream as JaxPointStream
from repro.runtime.fault_tolerance import FailureInjector as JaxInjector
from repro.streaming import StreamingKMeans as JaxStreamingKMeans
from repro_torch import NotFittedError, tune
from repro_torch.checkpoint import load_checkpoint_arrays, save_checkpoint
from repro_torch.data import PointStream
from repro_torch.obs import MetricsRegistry
from repro_torch.runtime import FailureInjector, InjectedFailure
from repro_torch.streaming import StreamingKMeans

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _tmp_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(tune.ENV_VAR, str(tmp_path / "tune.json"))
    tune.set_default_cache(None)
    yield
    tune.set_default_cache(None)


def _stream(seed=7, n_shards=4):
    return PointStream(shard_size=256, n_shards=n_shards, n_dims=8, k=8,
                       seed=seed)


def _skm(k, **kw):
    return StreamingKMeans(k, **CPU, **kw)


def _assert_stream_state_equal(a, b):
    np.testing.assert_array_equal(a.cluster_centers_, b.cluster_centers_)
    np.testing.assert_array_equal(a.counts_, b.counts_)
    np.testing.assert_array_equal(a._ledger.centroid, b._ledger.centroid)
    np.testing.assert_array_equal(a._ledger.group, b._ledger.group)


# -- save/restore roundtrip and resume -------------------------------------------

def test_save_restore_roundtrip_full_state(tmp_path):
    """Every piece of stream state survives the checkpoint (bound cache
    with its LRU order and scalars, the float64 ledger bit for bit, the
    reseed reservoir, stats, the engine configuration), and the restored
    estimator's next batch is bit for bit the original's."""
    stream = _stream()
    skm = _skm(8, seed=1).fit_stream(stream, epochs=2)
    skm.save(tmp_path, step=8)
    got, step = StreamingKMeans.restore(tmp_path, **CPU)
    assert step == 8
    _assert_stream_state_equal(skm, got)
    np.testing.assert_array_equal(skm._since_hit, got._since_hit)
    np.testing.assert_array_equal(skm._groups_np, got._groups_np)
    np.testing.assert_array_equal(skm.labels_, got.labels_)
    assert got._ledger.centroid.dtype == np.float64
    assert got.tune == "off" and got.device == torch.device("cpu")
    assert torch.equal(skm._members, got._members)
    assert torch.equal(skm._gsize, got._gsize)
    assert torch.equal(skm._groups, got._groups)
    d1, d2 = skm.stats_.to_dict(), got.stats_.to_dict()
    for key in ("ckpt_saves", "restores"):   # legitimately differ
        d1.pop(key), d2.pop(key)
    assert d1 == d2
    assert skm.ewa_inertia_ == got.ewa_inertia_
    assert (skm.min_bucket, skm.chunk, skm._ggf) == \
        (got.min_bucket, got.chunk, got._ggf)
    assert len(skm._far) == len(got._far)
    for (u1, p1), (u2, p2) in zip(skm._far, got._far):
        assert u1 == u2
        np.testing.assert_array_equal(p1, p2)
    assert list(skm._cache._d.keys()) == list(got._cache._d.keys())
    for sid in skm._cache._d:
        e1, e2 = skm._cache._d[sid], got._cache._d[sid]
        np.testing.assert_array_equal(e1.assignments, e2.assignments)
        np.testing.assert_array_equal(e1.ub, e2.ub)
        np.testing.assert_array_equal(e1.lb, e2.lb)
        np.testing.assert_array_equal(e1.ub_off, e2.ub_off)
        np.testing.assert_array_equal(e1.gdrift_snap, e2.gdrift_snap)
        assert (e1.gmax, e1.ub_scale) == (e2.gmax, e2.ub_scale)
    # the restored estimator continues bit for bit
    skm.partial_fit(stream.shard(0), shard_id=0)
    got.partial_fit(stream.shard(0), shard_id=0)
    _assert_stream_state_equal(skm, got)
    assert skm.stats_.cache_hits == got.stats_.cache_hits


def test_save_requires_initialized(tmp_path):
    with pytest.raises(NotFittedError):
        _skm(4).save(tmp_path, step=0)


def test_restore_rejects_wrong_format(tmp_path):
    save_checkpoint(tmp_path, 1, [np.zeros((3,))], meta={"format": "other"})
    with pytest.raises(ValueError, match="not a stream-state"):
        StreamingKMeans.restore(tmp_path, **CPU)
    with pytest.raises(ValueError, match="not a stream-state"):
        _skm(4).restore_state(tmp_path)


def test_resilient_requires_global_batch_source(tmp_path):
    with pytest.raises(ValueError):
        _skm(4).fit_stream(
            [np.zeros((8, 3), np.float32)], resilient=True,
            ckpt_dir=tmp_path)
    with pytest.raises(ValueError):
        _skm(4).fit_stream(_stream(), resilient=True)


def test_resume_across_runs_bit_exact(tmp_path):
    """Stop after 2 epochs (the terminal checkpoint), resume a fresh
    estimator for 4: bit for bit 4 uninterrupted epochs, nothing
    replayed."""
    stream = _stream(seed=9)
    sk_u = _skm(8, seed=3).fit_stream(stream, epochs=4)

    sk_a = _skm(8, seed=3)
    sk_a.fit_stream(stream, epochs=2, resilient=True, ckpt_dir=tmp_path,
                    ckpt_every=3)
    sk_b = _skm(8, seed=3)   # a new process, no memory of sk_a
    sk_b.fit_stream(stream, epochs=4, resilient=True, ckpt_dir=tmp_path,
                    ckpt_every=3)
    _assert_stream_state_equal(sk_u, sk_b)
    assert sk_b.stats_.restores == 1
    assert sk_b.stats_.replayed_batches == 0


def test_adopt_centroids_keeps_cached_bounds_valid():
    stream = _stream(seed=5)
    skm = _skm(8, seed=2).fit_stream(stream, epochs=2)
    led_before = skm._ledger.centroid.copy()
    rng = np.random.default_rng(0)
    skm.adopt_centroids(skm.cluster_centers_
                        + rng.standard_normal((8, 8)).astype(np.float32))
    assert np.all(skm._ledger.centroid >= led_before)
    hits_before = skm.stats_.cache_hits
    skm.fit_stream(stream, epochs=1)
    assert skm.stats_.cache_hits > hits_before   # cache survived
    pts = np.concatenate([stream.shard(i) for i in range(4)])
    assert np.isfinite(skm.inertia_of(pts))


# -- failure injection ------------------------------------------------------------

pytest_chaos = pytest.mark.chaos


@pytest_chaos
def test_restore_replay_bit_exact_after_crash(tmp_path):
    stream = _stream()
    sk_u = _skm(8, seed=3).fit_stream(stream, epochs=3)
    inj = FailureInjector(fail_at=(7,))
    sk_r = _skm(8, seed=3)
    sk_r.fit_stream(stream, epochs=3, resilient=True, ckpt_dir=tmp_path,
                    ckpt_every=3, injector=inj)
    assert inj.seen == {7}
    assert sk_r.stats_.restores == 1
    assert sk_r.stats_.replayed_batches >= 1
    _assert_stream_state_equal(sk_u, sk_r)


@pytest_chaos
def test_crash_mid_batch_torn_state_recovers(tmp_path):
    """The chaos hook fires after the device update landed but before
    the host commit, so the estimator is torn; the restore discards the
    half step and lands bit for bit."""
    stream = _stream(seed=2)
    sk_u = _skm(8, seed=1).fit_stream(stream, epochs=3)
    sk_r = _skm(8, seed=1)
    fired = []

    def tear_once(est, sid):
        if est.stats_.batches == 8 and not fired:
            fired.append(sid)
            raise InjectedFailure("host died mid-batch")

    sk_r.chaos_hook = tear_once
    sk_r.fit_stream(stream, epochs=3, resilient=True, ckpt_dir=tmp_path,
                    ckpt_every=4)
    assert fired
    assert sk_r.stats_.restores == 1
    _assert_stream_state_equal(sk_u, sk_r)


@pytest_chaos
def test_failure_before_first_checkpoint_cold_restarts(tmp_path):
    stream = _stream(seed=4)
    sk_u = _skm(8, seed=2).fit_stream(stream, epochs=2)
    inj = FailureInjector(fail_at=(5,))
    sk_r = _skm(8, seed=2)
    sk_r.fit_stream(stream, epochs=2, resilient=True, ckpt_dir=tmp_path,
                    ckpt_every=1000, injector=inj)
    assert sk_r.stats_.restores == 1
    assert sk_r.stats_.replayed_batches == 5
    _assert_stream_state_equal(sk_u, sk_r)


@pytest_chaos
def test_corrupt_checkpoint_falls_back_and_replays(tmp_path):
    stream = _stream(seed=6)
    sk_u = _skm(8, seed=5).fit_stream(stream, epochs=3)
    corrupted = []

    def corrupt_then_fail(est, sid):
        if est.stats_.batches == 9 and not corrupted:
            # tear the newest published step, then crash
            steps = sorted(p for p in os.listdir(tmp_path)
                           if p.startswith("step_"))
            with open(os.path.join(tmp_path, steps[-1], "shard_0.npz"),
                      "wb") as f:
                f.write(b"torn write")
            corrupted.append(steps[-1])
            raise InjectedFailure("crash onto corrupt checkpoint")

    sk_r = _skm(8, seed=5)
    sk_r.chaos_hook = corrupt_then_fail
    sk_r.fit_stream(stream, epochs=3, resilient=True, ckpt_dir=tmp_path,
                    ckpt_every=3, async_ckpt=False)
    assert corrupted == ["step_000009"]
    assert sk_r.stats_.restores == 1
    # steps 6-9 again: the torn batch 9 counts as a replay when it reruns
    assert sk_r.stats_.replayed_batches == 4
    _assert_stream_state_equal(sk_u, sk_r)


@pytest_chaos
def test_shard_dropout_stream_keeps_going(tmp_path):
    stream = _stream(seed=8)
    skm = _skm(8, seed=1)
    skm.fit_stream(stream, epochs=2, resilient=True, ckpt_dir=tmp_path,
                   ckpt_every=4)
    got, step = StreamingKMeans.restore(tmp_path, **CPU)
    assert step == 8
    surviving = [s for s in range(4) if s != 2]
    for epoch in range(2):
        for s in surviving:
            got.partial_fit(stream.shard(s), shard_id=s)
    pts = np.concatenate([stream.shard(i) for i in range(4)])
    assert np.isfinite(got.inertia_of(pts))
    assert got.stats_.batches == 8 + 6


@pytest_chaos
def test_multiple_failures_within_budget(tmp_path):
    stream = _stream(seed=12)
    sk_u = _skm(8, seed=7).fit_stream(stream, epochs=4)
    inj = FailureInjector(fail_at=(3, 9, 13))
    sk_r = _skm(8, seed=7)
    sk_r.fit_stream(stream, epochs=4, resilient=True, ckpt_dir=tmp_path,
                    ckpt_every=2, injector=inj, max_restarts=5)
    assert sk_r.stats_.restores == 3
    _assert_stream_state_equal(sk_u, sk_r)


@pytest_chaos
def test_restart_budget_exhausted_raises(tmp_path):
    stream = _stream(seed=1)
    inj = FailureInjector(fail_at=(2, 3, 4))
    with pytest.raises(InjectedFailure):
        _skm(8, seed=1).fit_stream(
            stream, epochs=2, resilient=True, ckpt_dir=tmp_path,
            ckpt_every=2, injector=inj, max_restarts=2)


@pytest_chaos
def test_recovery_metrics_published(tmp_path):
    reg = MetricsRegistry()
    stream = _stream(seed=3)
    inj = FailureInjector(fail_at=(7,))   # off the ckpt lattice: replay
    skm = _skm(8, seed=2, obs=reg)
    skm.fit_stream(stream, epochs=2, resilient=True, ckpt_dir=tmp_path,
                   ckpt_every=2, injector=inj)
    m = reg.to_dict()
    assert m["ckpt_saves_total"] >= 2
    assert m["restore_total"] == 1
    assert m["replay_batches_total"] >= 1
    assert m["ckpt_last_step"] == 8 and m["restore_step"] == 6
    events = [e["event"] for e in reg.events]
    assert "ckpt_save" in events and "restore" in events


# -- across the packages -----------------------------------------------------------

def _jax_seeds(est):
    """Seed ``est`` with JAX's k-means++ draw over its own buffer."""
    def seed(points, weights):
        assert weights is None
        init = jax_kmeans_plusplus(jax.random.PRNGKey(est.seed),
                                   jnp.asarray(points.numpy()),
                                   est.n_clusters)
        return torch.from_numpy(np.array(init))
    est._seed_centroids = seed
    return est


def _manifest(d, step):
    return json.loads((d / f"step_{step:06d}" / "manifest.json").read_text())


def _without_counters(manifest):
    out = json.loads(json.dumps(manifest))
    for key in ("ckpt_saves", "restores"):
        out["meta"]["stats"].pop(key)
    return out


JAX_KW = dict(shard_size=256, n_shards=4, n_dims=8, k=8, seed=11)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stream_state_crosses_packages(tmp_path, writer):
    """One package streams 2 epochs and saves; the other restores that
    state and saves it again: the same manifest, the same leaves."""
    if writer == "jax":
        a = JaxStreamingKMeans(8, seed=2, tune="off")
        a.fit_stream(JaxPointStream(**JAX_KW), epochs=2)
    else:
        a = _jax_seeds(_skm(8, seed=2, tune="off"))
        a.fit_stream(PointStream(**JAX_KW), epochs=2)
    a.save(tmp_path / "a", step=8)
    if writer == "jax":
        b, step = StreamingKMeans.restore(tmp_path / "a", **CPU)
    else:
        b, step = JaxStreamingKMeans.restore(tmp_path / "a")
    assert step == 8
    b.save(tmp_path / "b", step=8)
    ma, mb = _manifest(tmp_path / "a", 8), _manifest(tmp_path / "b", 8)
    assert _without_counters(ma) == _without_counters(mb)
    # a save snapshots the stats before it counts itself; the restore
    # counts one more
    assert (mb["meta"]["stats"]["ckpt_saves"],
            mb["meta"]["stats"]["restores"]) == (
        ma["meta"]["stats"]["ckpt_saves"],
        ma["meta"]["stats"]["restores"] + 1)
    assert len(ma["leaves"]) == 9 + 5 * 4
    la = load_checkpoint_arrays(tmp_path / "a")[2]
    lb = load_checkpoint_arrays(tmp_path / "b")[2]
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert [str(x.dtype) for x in la[:9]] == [
        "float32", "float32", "float64", "float64", "int64", "int32",
        "int32", "float64", "float32"]
    assert [str(x.dtype) for x in la[9:14]] == [
        "int32", "float32", "float32", "float64", "float64"]


def test_port_continues_jax_state(tmp_path):
    """JAX streams 2 epochs and saves; both packages restore the state
    and stream one more epoch: the same labels batch by batch, the same
    cache hits and evals, centroids within rtol 1e-5."""
    js = JaxPointStream(**JAX_KW)
    a = JaxStreamingKMeans(8, seed=4, tune="off").fit_stream(js, epochs=2)
    a.save(tmp_path, step=8)
    t, _ = StreamingKMeans.restore(tmp_path, **CPU)
    j, _ = JaxStreamingKMeans.restore(tmp_path)
    ps = PointStream(**JAX_KW)
    for step in range(8, 12):
        b = ps.global_batch(step)
        t.partial_fit(b["points"], shard_id=b["shard_id"])
        jb = js.global_batch(step)
        j.partial_fit(jb["points"], shard_id=jb["shard_id"])
        np.testing.assert_array_equal(t.labels_, j.labels_)
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t.counts_, j.counts_)
    assert (t.stats_.cache_hits, t.stats_.batches) == \
        (j.stats_.cache_hits, j.stats_.batches)
    pts = np.concatenate([ps.shard(i) for i in range(4)])
    np.testing.assert_array_equal(t.predict(pts), j.predict(pts))


@pytest.mark.chaos
def test_crash_and_replay_counts_match_jax(tmp_path):
    """The same failures in both packages' resilient streams: the same
    restores, replays and saves, the same labels at the end, centroids
    within rtol 1e-5."""
    j = JaxStreamingKMeans(8, seed=6, tune="off")
    j.fit_stream(JaxPointStream(**JAX_KW), epochs=3, resilient=True,
                 ckpt_dir=tmp_path / "j", ckpt_every=3,
                 injector=JaxInjector(fail_at=(4, 10)))
    t = _jax_seeds(_skm(8, seed=6, tune="off"))
    t.fit_stream(PointStream(**JAX_KW), epochs=3, resilient=True,
                 ckpt_dir=tmp_path / "t", ckpt_every=3,
                 injector=FailureInjector(fail_at=(4, 10)))
    assert t.stats_.to_dict().keys() == j.stats_.to_dict().keys()
    for f in ("batches", "cache_hits", "cache_misses", "restores",
              "replayed_batches", "ckpt_saves", "reseeds", "drift_resets"):
        assert getattr(t.stats_, f) == getattr(j.stats_, f), f
    np.testing.assert_array_equal(t.labels_, j.labels_)
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_,
                               rtol=1e-5, atol=1e-5)
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))
