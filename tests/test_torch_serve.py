"""The port's serving subsystem (``repro_torch.serve`` and the engine's
serve-side assign) against the JAX package's, on the CPU.

Swap consistency (every response's labels are exactly its own epoch's
oracle labels), bucket discipline with reused pad buffers, drift-gated
table reuse, the serve knob family, the engine's lifecycle, and every
behaviour of the reference's serving review fixes: a failing batch fails
only its own futures, a wrong D is rejected at ``submit``, the client's
tensor is never written, a failed jumbo split propagates, and the
fallback config is not pinned before the first publish. The ``kernel``
backend runs the plain version of ``grouped_assign`` here.

The oracle is ``argmin`` of the fp64 distance matrix. The port's
backends compute fp32 distances, so a label may differ from it only at
an fp32 near-tie: the two best fp64 squared distances within a relative
1e-5, counted by :func:`_check_labels` (norms here are a few units, so
the expanded form's fp32 error stays under that gap). Against JAX's server, on the same
(carried-across) centroids, the same rule holds.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KMeans as JaxKMeans
from repro.serve import CentroidIndex as JaxIndex
from repro.serve import ServeEngine as JaxServeEngine
from repro.tune import ServeConfig as JaxServeConfig
from repro_torch import obs, tune
from repro_torch.convert import kmeans_state_from_numpy
from repro_torch.core import engine as _engine
from repro_torch.core.distances import row_norms_sq
from repro_torch.serve import CentroidIndex, ServeEngine
from repro_torch.tune import (ServeConfig, TuneCache, autotune_serve,
                              lookup_serve, serve_signature)

TIE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _tmp_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(tune.ENV_VAR, str(tmp_path / "tune.json"))
    tune.set_default_cache(None)
    yield
    tune.set_default_cache(None)


def _mk(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _check_labels(q, centroids, labels):
    """``labels`` against the fp64 argmin; a differing label must sit at
    an fp32 near-tie. Returns the count of such ties."""
    d2 = ((np.asarray(q, np.float64)[:, None, :]
           - np.asarray(centroids, np.float64)[None]) ** 2).sum(-1)
    ref = d2.argmin(1)
    bad = np.nonzero(labels != ref)[0]
    if len(bad):
        two = np.sort(d2[bad], axis=1)[:, :2]
        assert np.all(two[:, 1] - two[:, 0] <= TIE_RTOL * two[:, 1]), \
            "labels differ from the fp64 oracle off a near-tie"
        got = d2[bad, labels[bad]]
        assert np.all(got - two[:, 0] <= TIE_RTOL * two[:, 1])
    return len(bad)


def _index(c, **kw):
    return CentroidIndex(c, device="cpu", **kw)


# -- swap consistency ------------------------------------------------------

@pytest.mark.parametrize("backend", ["fused", "grouped", "kernel"])
def test_swap_consistency_exactly_one_epoch(backend):
    d, k = 8, 16
    q = _mk(4096, d, 0)
    pub_rng = np.random.default_rng(1)
    c0 = _mk(k, d, 2)
    epoch_centroids = {1: c0}
    idx = _index(c0)
    stop = threading.Event()

    def publisher():
        while not stop.is_set():
            c = pub_rng.standard_normal((k, d)).astype(np.float32)
            ep = idx.publish(c)
            epoch_centroids[ep] = c
            time.sleep(0.001)

    cfg = ServeConfig(backend=backend, min_bucket=64, max_batch=1024)
    req_rng = np.random.default_rng(3)
    results = []
    with ServeEngine(idx, config=cfg, tune="off") as eng:
        eng.assign(q[:64])
        t = threading.Thread(target=publisher)
        t.start()
        try:
            for _ in range(60):
                m = int(req_rng.integers(16, 600))
                lo = int(req_rng.integers(0, q.shape[0] - m))
                results.append((lo, m, eng.assign(q[lo:lo + m])))
                time.sleep(0.001)
        finally:
            stop.set()
            t.join()
    epochs = set()
    for lo, m, (labels, epoch) in results:
        assert labels.shape == (m,) and labels.dtype == np.int32
        _check_labels(q[lo:lo + m], epoch_centroids[epoch], labels)
        epochs.add(epoch)
    assert len(epochs) > 1


def test_concurrent_clients_coalesce_exactly():
    """Four client threads, ragged requests: batches coalesce several
    requests, never exceed ``max_batch``, and every request gets its own
    rows' labels."""
    d, k = 8, 16
    c = _mk(k, d, 1)
    q = _mk(20_000, d, 2)
    # a 2 ms linger after a batch's first request: coalescing does not
    # hang on the clients outpacing the serving thread
    cfg = ServeConfig(backend="kernel", min_bucket=64, max_batch=1024,
                      max_wait_us=2000)
    idx = _index(c)
    out = {}
    with ServeEngine(idx, config=cfg, tune="off") as eng:
        def client(i):
            rng = np.random.default_rng(10 + i)
            futs = []
            for _ in range(40):
                m = int(rng.integers(1, 700))
                lo = int(rng.integers(0, q.shape[0] - m))
                futs.append((lo, m, eng.submit(q[lo:lo + m])))
            out[i] = [(lo, m, f.result(timeout=60)) for lo, m, f in futs]
        ts = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert eng.batches < 160 and eng.points == sum(
            m for v in out.values() for _, m, _ in v)
    for v in out.values():
        for lo, m, (labels, _) in v:
            _check_labels(q[lo:lo + m], c, labels)


# -- bucket lattice: reused pad buffers ------------------------------------

def test_bucket_buffers_reused():
    d, k = 12, 20
    q = _mk(1024, d, 0)
    idx = _index(_mk(k, d, 1))
    cfg = ServeConfig(min_bucket=256, max_batch=1024)
    with ServeEngine(idx, config=cfg, tune="off") as eng:
        eng.assign(q[:300])                  # bucket 512
        assert list(eng._buffers) == [(512, d)]
        buf = eng._buffers[(512, d)][0]
        for m in (257, 400, 511):            # all land in bucket 512
            labels, _ = eng.assign(q[:m])
            assert labels.shape == (m,)
        assert list(eng._buffers) == [(512, d)]
        assert eng._buffers[(512, d)][0] is buf
        eng.assign(q[:600])                  # bucket 1024: one new buffer
        assert sorted(eng._buffers) == [(512, d), (1024, d)]
        assert len(eng._assigns) == 1


# -- drift-gated table rebuild vs reuse ------------------------------------

def test_index_reuses_tables_under_drift_threshold():
    k, d = 16, 8
    c = _mk(k, d, 0)
    reg = obs.MetricsRegistry()
    idx = CentroidIndex(rebuild_threshold=0.05, device="cpu", obs=reg)
    idx.publish(c, cum_drift=np.zeros(k))
    s1 = idx.acquire()
    assert (idx.publishes, idx.rebuilds, idx.reuses) == (1, 1, 0)
    drift = np.full(k, 1e-4)
    idx.publish(c + 1e-4, cum_drift=drift)
    s2 = idx.acquire()
    assert s2.epoch == 2 and s2.tables_epoch == s1.epoch
    assert s2.members is s1.members and s2.groups is s1.groups
    assert idx.reuses == 1
    idx.publish(c * 3.0, cum_drift=drift + 100.0)
    s3 = idx.acquire()
    assert s3.tables_epoch == s3.epoch == 3
    assert idx.rebuilds == 2
    idx.publish(c)
    assert idx.rebuilds == 3
    idx.publish(c, cum_drift=np.zeros(k), force_rebuild=True)
    assert idx.rebuilds == 4
    assert reg.counter("serve_publishes_total").value == 5
    assert reg.counter("serve_table_rebuilds_total").value == 4
    # the published centroids are a copy, never the caller's tensor
    ct = torch.from_numpy(c.copy())
    idx.publish(ct)
    assert idx.acquire().centroids.data_ptr() != ct.data_ptr()


def test_index_acquire_before_publish_raises():
    idx = CentroidIndex(device="cpu")
    assert not idx.ready
    with pytest.raises(RuntimeError):
        idx.acquire()


def test_index_defaults_to_cuda():
    if torch.cuda.is_available():
        assert CentroidIndex().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            CentroidIndex()


# -- every serve backend is exact ------------------------------------------

@pytest.mark.parametrize("backend", ["fused", "grouped", "kernel",
                                     "pallas"])
def test_make_serve_assign_backends_exact(backend):
    k, d = 32, 8
    q = torch.from_numpy(_mk(512, d, 0))
    centroids = torch.from_numpy(_mk(k, d, 1))
    c2 = row_norms_sq(centroids)
    groups, members, gsize = _engine.build_assign_tables(centroids)
    fn = _engine.make_serve_assign((k, int(gsize.shape[0])),
                                   backend=backend, chunk=256)
    q0 = q.clone()
    labels = fn(q, centroids, c2, groups, members, gsize)
    assert labels.dtype == torch.int32 and torch.equal(q, q0)
    _check_labels(q.numpy(), centroids.numpy(), labels.numpy())
    # the dense oracle of the expanded form, bit for bit
    dense = torch.argmin(c2[None] - 2.0 * (q @ centroids.T), dim=1)
    assert torch.equal(labels.long(), dense)


def test_make_serve_assign_unknown_backend():
    with pytest.raises(ValueError):
        _engine.make_serve_assign((8, 2), backend="nope")


# -- engine lifecycle ------------------------------------------------------

def test_engine_empty_request():
    idx = _index(_mk(4, 8, 0))
    with ServeEngine(idx, config=ServeConfig(), tune="off") as eng:
        labels, epoch = eng.assign(np.zeros((0, 8), np.float32))
        assert labels.shape == (0,) and epoch == 1


def test_engine_jumbo_request_split_and_exact():
    d, k = 8, 16
    q = _mk(1300, d, 0)
    centroids = _mk(k, d, 1)
    cfg = ServeConfig(min_bucket=64, max_batch=512)
    with ServeEngine(_index(centroids), config=cfg, tune="off") as eng:
        labels, epoch = eng.assign(q)
        assert labels.shape == (1300,) and epoch == 1
        _check_labels(q, centroids, labels)
        assert eng.batches == 3


def test_engine_device_tensor_submit_exact_and_never_written():
    """A float32 tensor on the index's device skips host staging (the
    exact-fit path hands it to the assign as it is) and gives the numpy
    route's labels; the client's tensor is never written, in the
    exact-fit path or staged into a pad buffer that holds stale rows."""
    d, k = 8, 16
    q = _mk(512, d, 3)
    centroids = _mk(k, d, 1)
    cfg = ServeConfig(backend="kernel", min_bucket=64, max_batch=512)
    with ServeEngine(_index(centroids), config=cfg, tune="off") as eng:
        labels_np, _ = eng.assign(q)
        qt = torch.from_numpy(q.copy())
        labels_dev, epoch = eng.assign(qt)          # exact fit
        assert epoch == 1 and np.array_equal(labels_dev, labels_np)
        part = torch.from_numpy(q[:300].copy())
        labels_part, _ = eng.assign(part)           # staged, bucket 512
        assert np.array_equal(labels_part, labels_np[:300])
        assert np.array_equal(qt.numpy(), q)
        assert np.array_equal(part.numpy(), q[:300])
        big = torch.from_numpy(_mk(1300, d, 4))
        labels, _ = eng.assign(big)                 # a split tensor
        _check_labels(big.numpy(), centroids, labels)
        # non-f32 input takes the host coercion path
        labels16, _ = eng.assign(torch.from_numpy(q).half())
        assert labels16.shape == (512,)


def test_engine_submit_requires_running():
    eng = ServeEngine(_index(_mk(4, 8, 0)), config=ServeConfig(), tune="off")
    with pytest.raises(RuntimeError):
        eng.submit(np.zeros((4, 8), np.float32))


def test_engine_stop_before_publish_fails_pending():
    eng = ServeEngine(CentroidIndex(device="cpu"), config=ServeConfig(),
                      tune="off").start()
    fut = eng.submit(np.zeros((4, 8), np.float32))
    eng.stop()
    with pytest.raises(RuntimeError):
        fut.result(timeout=30)


def test_engine_stop_before_publish_fails_split_jumbo():
    cfg = ServeConfig(min_bucket=64, max_batch=128)
    eng = ServeEngine(CentroidIndex(device="cpu"), config=cfg,
                      tune="off").start()
    fut = eng.submit(_mk(300, 8, 0))      # 3 parts
    eng.stop()
    with pytest.raises(RuntimeError):
        fut.result(timeout=30)


def test_engine_failed_jumbo_part_propagates():
    """One failing part of a split request fails the whole request's
    future, exactly once."""
    d, k = 8, 16
    cfg = ServeConfig(min_bucket=64, max_batch=128)
    with ServeEngine(_index(_mk(k, d, 0)), config=cfg, tune="off") as eng:
        orig, calls = eng._resolve_assign, []

        def second_batch_fails(snap):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("injected part failure")
            return orig(snap)
        eng._resolve_assign = second_batch_fails
        with pytest.raises(RuntimeError, match="injected part"):
            eng.submit(_mk(300, d, 1)).result(timeout=30)
        eng._resolve_assign = orig
        assert eng.assign(_mk(200, d, 2))[0].shape == (200,)


def test_engine_submit_rejects_wrong_feature_dim():
    idx = _index(_mk(8, 16, 0))
    with ServeEngine(idx, config=ServeConfig(), tune="off") as eng:
        with pytest.raises(ValueError, match="feature dim"):
            eng.submit(_mk(4, 8, 1))
        labels, _ = eng.assign(_mk(4, 16, 2))   # engine still serves
        assert labels.shape == (4,)


def test_engine_thread_survives_batch_error():
    d, k = 8, 16
    cfg = ServeConfig(min_bucket=64, max_batch=512)
    with ServeEngine(_index(_mk(k, d, 0)), config=cfg, tune="off") as eng:
        orig = eng._resolve_assign

        def boom(*a, **kw):
            raise RuntimeError("injected backend failure")

        eng._resolve_assign = boom
        with pytest.raises(RuntimeError, match="injected"):
            eng.submit(_mk(16, d, 1)).result(timeout=30)
        eng._resolve_assign = orig
        labels, _ = eng.assign(_mk(16, d, 2))
        assert labels.shape == (16,)


def test_engine_config_not_pinned_before_first_publish(monkeypatch):
    import repro_torch.serve.engine as se
    tuned = ServeConfig(max_batch=2048, chunk=512)
    monkeypatch.setattr(se, "lookup_serve", lambda **kw: tuned)
    idx = CentroidIndex(device="cpu")
    eng = ServeEngine(idx, tune="on")
    assert eng._config() == se.DEFAULT_SERVE_CONFIG
    assert eng._cfg is None               # fallback was NOT memoized
    idx.publish(_mk(8, 8, 0))
    assert eng._config() == tuned


def test_engine_reads_the_tuned_serve_entry():
    idx = _index(_mk(8, 4, 0))
    tuned = ServeConfig(backend="grouped", max_batch=1024)
    tune.default_cache().store(serve_signature(8, 4, "cpu"), tuned)
    assert ServeEngine(idx, tune="on")._config() == tuned
    assert ServeEngine(idx, tune="off")._config() == \
        tune.DEFAULT_SERVE_CONFIG


def test_engine_counts_and_metrics():
    d, k = 8, 16
    q = _mk(2048, d, 0)
    reg = obs.MetricsRegistry()
    idx = _index(_mk(k, d, 1), obs=reg)
    cfg = ServeConfig(min_bucket=256, max_batch=1024)
    with ServeEngine(idx, config=cfg, tune="off", obs=reg) as eng:
        eng.assign(q[:300])
        eng.assign(q[:900])
        idx.publish(_mk(k, d, 2))
        _, epoch = eng.assign(q[:100])
        assert epoch == 2
        assert eng.batches == 3 and eng.points == 1300
        assert eng.epoch_swaps == 1
    text = reg.to_prometheus()
    for name in ("serve_batches_total", "serve_points_total",
                 "serve_epoch_swaps_total", "serve_batch_fill",
                 "serve_latency_seconds", "serve_publishes_total",
                 "serve_epoch"):
        assert name in text, f"missing metric {name}"
    assert reg.histogram("serve_latency_seconds").count == 3


# -- the JAX package's server on the same centroids ------------------------

@pytest.mark.parametrize("backend,jax_backend", [
    ("fused", "fused"), ("grouped", "grouped"), ("kernel", "pallas")])
def test_serves_jax_fitted_centroids_like_jax(backend, jax_backend):
    """Centroids fitted by the JAX package, carried across by
    ``convert.kmeans_state_from_numpy``, served by both packages'
    servers: the same labels but at fp32 near-ties, which are counted."""
    from repro.data import make_points
    pts, _, _ = make_points(3000, 8, 24, seed=7)
    km_j = JaxKMeans(n_clusters=24, n_groups=4, seed=2, engine="compact",
                     tune="off").fit(pts)
    state = kmeans_state_from_numpy(
        type(km_j.result_)(*(np.asarray(f) for f in km_j.result_)),
        device="cpu")
    q = _mk(2500, 8, 8) * 3.0
    cfg = dict(backend=backend, min_bucket=64, max_batch=1024)
    with ServeEngine(_index(state.centroids, n_groups=4),
                     config=ServeConfig(**cfg), tune="off") as eng:
        got = [eng.assign(q[lo:lo + 500]) for lo in range(0, 2500, 500)]
    jidx = JaxIndex(np.asarray(km_j.cluster_centers_), n_groups=4)
    jcfg = JaxServeConfig(**{**cfg, "backend": jax_backend})
    with JaxServeEngine(jidx, config=jcfg, tune="off") as jeng:
        want = [jeng.assign(q[lo:lo + 500]) for lo in range(0, 2500, 500)]
    labels = np.concatenate([g.labels for g in got])
    jlabels = np.concatenate([np.asarray(w.labels) for w in want])
    assert [g.epoch for g in got] == [w.epoch for w in want] == [1] * 5
    c = state.centroids.numpy()
    ties = _check_labels(q, c, labels) + _check_labels(q, c, jlabels)
    assert int((labels != jlabels).sum()) <= ties


# -- the serve knob family --------------------------------------------------

def test_serve_config_roundtrip_and_tolerance():
    cfg = ServeConfig(backend="grouped", chunk=512).replace(max_batch=2048)
    assert ServeConfig.from_dict(cfg.to_dict()) == cfg
    assert ServeConfig.from_dict(
        {**cfg.to_dict(), "future_knob": 1}) == cfg
    assert cfg.to_dict() == JaxServeConfig(
        backend="grouped", chunk=512, max_batch=2048).to_dict()


def test_serve_signature_shape():
    assert serve_signature(64, 32, platform="cpu") == "torch|serve|cpu|k64|d32"


def test_autotune_serve_stores_and_lookup_finds(tmp_path):
    cache = TuneCache(str(tmp_path / "tc.json"))
    assert lookup_serve(k=8, d=4, platform="cpu", cache=cache) is None
    grid = []
    cfg = autotune_serve(k=8, d=4, chunks=(256,), max_batch=512, repeats=1,
                         cache=cache, device="cpu", grid=grid)
    assert [g[0].backend for g in grid] == ["fused", "grouped"]
    assert cfg.backend in ("fused", "grouped") and cfg.chunk == 256
    assert lookup_serve(k=8, d=4, platform="cpu", cache=cache) == cfg


def test_autotune_serve_does_not_swallow_a_failing_backend(tmp_path,
                                                           monkeypatch):
    real = _engine.make_serve_assign

    def broken(shape, *, backend="fused", chunk=1024):
        if backend == "grouped":
            def run(*a):
                raise RuntimeError("kernel failed to launch")
            return run
        return real(shape, backend=backend, chunk=chunk)
    monkeypatch.setattr(_engine, "make_serve_assign", broken)
    cache = TuneCache(str(tmp_path / "tc.json"))
    with pytest.raises(RuntimeError, match="failed to launch"):
        autotune_serve(k=8, d=4, chunks=(256,), max_batch=512, repeats=1,
                       cache=cache, device="cpu")
    assert cache.signatures() == []
