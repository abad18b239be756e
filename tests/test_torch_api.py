"""The port's ``KMeans`` against the JAX package's, on the CPU.

The port's k-means++ draws from a ``torch.Generator`` and cannot give
``jax.random``'s numbers, so the parity tests hand the port JAX's
starting centroids. Labels are compared exactly; inertia, transform and
score to rtol 1e-5 (sums in another order than XLA's).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KMeans as JaxKMeans
from repro.data import make_points
from repro_torch import KMeans, NotFittedError, tune
from repro_torch.convert import kmeans_state_from_numpy
from repro_torch.core import engine
from repro_torch.streaming import StreamingKMeans


def _blobs(n=1500, d=8, k=8, seed=0):
    pts, _, _ = make_points(n, d, k, seed=seed)
    new, _, _ = make_points(700, d, k, seed=seed + 100)
    return pts, new


def _with_jax_init(monkeypatch, jax_km):
    """Make the port's estimators start from JAX's k-means++ draw."""
    def init(self, points, weights=None):
        w = None if weights is None else jnp.asarray(weights.numpy())
        c = jax_km._init_centroids(jnp.asarray(points.numpy()), w)
        return torch.from_numpy(np.array(c)).to(points.device)
    monkeypatch.setattr(KMeans, "_init_centroids", init)


@pytest.mark.parametrize("algorithm,engine_name", [
    ("yinyang", "pallas"), ("hamerly", "pallas"), ("yinyang", None),
    ("lloyd", None)])
def test_kmeans_matches_jax(monkeypatch, algorithm, engine_name):
    pts, new = _blobs()
    kw = dict(n_clusters=8, algorithm=algorithm, n_groups=3, seed=1,
              engine=engine_name, tune="off")
    km_j = JaxKMeans(**kw).fit(pts)
    _with_jax_init(monkeypatch, km_j)
    km_t = KMeans(device="cpu", **kw).fit(pts)
    np.testing.assert_array_equal(km_t.labels_, np.asarray(km_j.labels_))
    assert km_t.n_iter_ == km_j.n_iter_
    np.testing.assert_allclose(km_t.inertia_, km_j.inertia_, rtol=1e-5)
    np.testing.assert_allclose(km_t.cluster_centers_,
                               np.asarray(km_j.cluster_centers_),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(km_t.predict(new), km_j.predict(new))
    np.testing.assert_allclose(km_t.transform(new), km_j.transform(new),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(km_t.score(new), km_j.score(new), rtol=1e-5)
    w = np.random.default_rng(2).random(700).astype(np.float32)
    np.testing.assert_allclose(km_t.score(new, sample_weight=w),
                               km_j.score(new, sample_weight=w), rtol=1e-5)
    assert isinstance(km_t.labels_, np.ndarray)
    assert isinstance(km_t.predict(new), np.ndarray)
    np.testing.assert_array_equal(km_t.fit_predict(pts), km_t.labels_)


def test_weighted_fit_matches_jax(monkeypatch):
    pts, _ = _blobs(seed=4)
    w = np.random.default_rng(4).integers(1, 4, size=1500).astype(np.float32)
    kw = dict(n_clusters=8, seed=3, engine="pallas", tune="off")
    km_j = JaxKMeans(**kw).fit(pts, sample_weight=w)
    _with_jax_init(monkeypatch, km_j)
    km_t = KMeans(device="cpu", **kw).fit(pts, sample_weight=w)
    np.testing.assert_array_equal(km_t.labels_, np.asarray(km_j.labels_))
    np.testing.assert_allclose(km_t.inertia_, km_j.inertia_, rtol=1e-5)


def test_convert_round_trip_jax_fit_to_port_predict():
    pts, new = _blobs(seed=5)
    km_j = JaxKMeans(n_clusters=8, n_groups=3, seed=2, engine="pallas",
                     tune="off").fit(pts)
    state = kmeans_state_from_numpy(
        type(km_j.result_)(*(np.asarray(f) for f in km_j.result_)),
        device="cpu")
    km_t = KMeans.from_state(state, n_groups=3, device="cpu")
    np.testing.assert_array_equal(km_t.labels_, np.asarray(km_j.labels_))
    assert km_t.n_iter_ == km_j.n_iter_
    assert km_t.distance_evals_ == km_j.distance_evals_
    np.testing.assert_array_equal(km_t.predict(new), km_j.predict(new))
    np.testing.assert_array_equal(km_t.predict(pts),
                                  np.asarray(km_j.labels_))
    np.testing.assert_allclose(km_t.transform(new), km_j.transform(new),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(km_t.score(new), km_j.score(new), rtol=1e-5)


def test_not_fitted_error():
    km = KMeans(n_clusters=4, device="cpu")
    for attr in ("cluster_centers_", "labels_", "inertia_", "n_iter_",
                 "distance_evals_"):
        with pytest.raises(NotFittedError):
            getattr(km, attr)
    with pytest.raises(NotFittedError):
        km.predict(np.zeros((3, 2), np.float32))
    with pytest.raises(AttributeError):
        km.labels_
    with pytest.raises(ValueError):
        km.score(np.zeros((3, 2), np.float32))


def test_entry_points_raise_without_cuda(monkeypatch):
    """No ``device=`` means cuda; where it is missing every entry point
    raises instead of carrying on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((8, 2), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KMeans(n_clusters=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.fit(pts, pts[:2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.assign(pts, pts[:2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KMeans(n_clusters=2, device="cuda")


@pytest.mark.parametrize("backend", ["kernel", "oracle", "compact",
                                     "lloyd"])
def test_uniform_weights_bit_identical(backend):
    pts, _ = _blobs(1000, 8, 12)
    init = pts[:: 1000 // 12][:12].copy()
    kw = dict(n_groups=3, max_iters=50, tol=1e-5, backend=backend,
              device="cpu")
    r0 = engine.fit(pts, init, **kw)
    r1 = engine.fit(pts, init, sample_weight=np.ones(1000, np.float32), **kw)
    assert r0.n_iters == r1.n_iters
    assert torch.equal(r0.assignments, r1.assignments)
    assert torch.equal(r0.centroids, r1.centroids)
    assert float(r0.inertia) == float(r1.inertia)
    assert int(r0.distance_evals) == int(r1.distance_evals)


def test_later_slices_raise_not_implemented():
    # the sharded stream has landed: a mesh is validated (an object that
    # is not a 1-D mesh is refused by name)
    with pytest.raises(ValueError, match="1-D mesh"):
        StreamingKMeans(2, mesh=object(), device="cpu")
    # the ladder runs only inside the sharded fit, as in the reference
    with pytest.raises(ValueError, match="ladder"):
        KMeans(n_clusters=2, engine="ladder", device="cpu")
    # sharded keys exist now: a miss is None
    assert tune.lookup(n=64, k=2, d=2, platform="cpu", shards=2) is None
