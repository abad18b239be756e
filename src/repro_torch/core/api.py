"""sklearn-flavoured API for the KPynq K-means family (port of
``repro.core.api``). Returns numpy where the JAX class returns numpy."""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_float32, resolve_device
from ..obs.metrics import normalize_obs
from . import engine as _engine
from . import kmeans as _km
from .distances import pairwise_dists, row_norms_sq
from .init import kmeans_plusplus, random_init


class NotFittedError(ValueError, AttributeError):
    """Raised when results are requested from an unfitted estimator
    (a ValueError and an AttributeError, as in sklearn)."""


class KMeans:
    """Exact K-means with KPynq's multi-level triangle-inequality filters.

    Parameters
    ----------
    n_clusters : K
    algorithm : 'lloyd' | 'hamerly' | 'yinyang'
    n_groups : group count for 'yinyang' (default K//10).
    init : 'k-means++' | 'random' (drawn from a ``torch.Generator``
        seeded with ``seed`` on ``device``).
    engine : None | 'auto' | 'oracle' | 'compact' | 'kernel' | 'pallas'
        | 'lloyd'
        None runs the reference loop (:mod:`repro_torch.core.kmeans`);
        any other value routes the filtered algorithms through
        :mod:`repro_torch.core.engine`. 'pallas' is an alias of
        'kernel'.
    tune : 'auto' | 'off' | 'force' — the engine's per-(card, N, K, D)
        tuning cache (:mod:`repro_torch.tune`): 'auto' uses a stored
        winner, 'force' also searches on a miss, 'off' the defaults.
    obs : None | True | MetricsRegistry | ObsConfig — the engine fit's
        telemetry ring and metrics (:mod:`repro_torch.obs`); ``stats_``
        then carries the drained ring.
    device : None (= 'cuda', raising when CUDA is not there) or a
        device.
    """

    def __init__(self, n_clusters: int, algorithm: str = "yinyang",
                 n_groups: int | None = None, init: str = "k-means++",
                 max_iters: int = 100, tol: float = 1e-4, seed: int = 0,
                 engine: str | None = None, decay: float = 1.0,
                 tune: str = "auto", obs=None, device=None):
        if algorithm not in ("lloyd", "hamerly", "yinyang"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        if engine is not None:
            _engine._backend_name(engine)
        if tune not in ("auto", "off", "force"):
            raise ValueError(f"unknown tune mode {tune!r}; expected "
                             f"'auto', 'off' or 'force'")
        normalize_obs(obs)                       # validate early
        self.n_clusters = n_clusters
        self.algorithm = algorithm
        self.n_groups = n_groups
        self.init = init
        self.max_iters = max_iters
        self.tol = tol
        self.seed = seed
        self.engine = engine
        self.decay = decay
        self.tune = tune
        self.obs = obs
        self.device = resolve_device(device)
        self.stats_: _engine.EngineStats | None = None
        self.result_: _km.KMeansResult | None = None
        self._stream = None
        self._assign_tables = None

    @classmethod
    def from_state(cls, result: _km.KMeansResult, **params) -> "KMeans":
        """A fitted estimator around an existing result (for example one
        carried over from the JAX package by
        :func:`repro_torch.convert.kmeans_state_from_numpy`).
        ``params`` are the constructor's; ``n_clusters`` defaults to
        the result's K."""
        params.setdefault("n_clusters", int(result.centroids.shape[0]))
        est = cls(**params)
        dev = est.device
        est.result_ = _km.KMeansResult(
            result.centroids.to(dev), result.assignments.to(dev),
            int(result.n_iters), result.distance_evals.to(dev),
            result.inertia.to(dev))
        return est

    def _init_centroids(self, points, weights=None):
        gen = torch.Generator(device=points.device).manual_seed(self.seed)
        if self.init == "k-means++":
            return kmeans_plusplus(gen, points, self.n_clusters,
                                   weights=weights)
        return random_init(gen, points, self.n_clusters)

    def fit(self, points, sample_weight=None) -> "KMeans":
        """Batch fit. ``sample_weight``: optional (N,) weights (weighted
        means, inertia and k-means++ draws)."""
        points = as_float32(points, self.device)
        weights = None if sample_weight is None else \
            as_float32(sample_weight, self.device)
        init_c = self._init_centroids(points, weights)
        self.stats_ = None
        if self.algorithm == "lloyd":
            res = _km.lloyd(points, init_c, self.max_iters, self.tol,
                            weights=weights)
        else:
            n_groups = 1 if self.algorithm == "hamerly" else self.n_groups
            if self.engine is None:
                res = _km.yinyang(points, init_c, n_groups=n_groups,
                                  max_iters=self.max_iters, tol=self.tol,
                                  weights=weights)
            else:
                res, self.stats_ = _engine.fit(
                    points, init_c, n_groups=n_groups,
                    max_iters=self.max_iters, tol=self.tol,
                    backend=self.engine, tune=self.tune,
                    sample_weight=weights, return_stats=True,
                    obs=self.obs, device=self.device)
        self.result_ = res
        self._stream = None       # a batch fit supersedes any stream state
        self._assign_tables = None
        return self

    def partial_fit(self, points, shard_id=None,
                    sample_weight=None) -> "KMeans":
        """Streaming mini-batch update, delegated to
        :class:`repro_torch.streaming.StreamingKMeans` (decayed
        count-weighted EMA with ``self.decay``; ``shard_id`` keys the
        carried-bounds cache). The first calls may only buffer points
        for the cold start; the accessors raise ``NotFittedError`` until
        then. Afterwards ``inertia_`` is the EWA per-point batch cost (an
        upper-bound estimate) and ``n_iter_`` counts batches."""
        from .. import streaming as _streaming
        if self._stream is None:
            n_groups = 1 if self.algorithm in ("lloyd", "hamerly") \
                else self.n_groups
            self._stream = _streaming.StreamingKMeans(
                self.n_clusters, n_groups=n_groups, init=self.init,
                decay=self.decay, seed=self.seed, tune=self.tune,
                obs=self.obs, device=self.device)
        s = self._stream.partial_fit(points, shard_id=shard_id,
                                     sample_weight=sample_weight)
        if s.initialized:
            dev = self.device
            self.result_ = _km.KMeansResult(
                s._centroids, torch.from_numpy(s.labels_.copy()).to(dev),
                int(s.stats_.batches),
                torch.tensor(int(s.stats_.distance_evals),
                             dtype=torch.int64, device=dev),
                torch.tensor(s.ewa_inertia_, dtype=torch.float32,
                             device=dev))
            self._assign_tables = None    # the centroids moved
        return self

    def _fitted(self) -> _km.KMeansResult:
        if self.result_ is None:
            raise NotFittedError(
                f"This KMeans instance is not fitted yet; call fit() "
                f"before using this {type(self).__name__} "
                f"attribute/method.")
        return self.result_

    # sklearn-style accessors ----------------------------------------------
    @property
    def cluster_centers_(self) -> np.ndarray:
        return self._fitted().centroids.cpu().numpy()

    @property
    def labels_(self) -> np.ndarray:
        return self._fitted().assignments.cpu().numpy()

    @property
    def inertia_(self) -> float:
        return float(self._fitted().inertia)

    @property
    def n_iter_(self) -> int:
        return int(self._fitted().n_iters)

    @property
    def distance_evals_(self) -> float:
        return float(self._fitted().distance_evals)

    # inference -------------------------------------------------------------
    def _tables(self):
        """Group tables over the fitted centroids, built once."""
        if self._assign_tables is None:
            centroids = self._fitted().centroids.float()
            g = self.n_groups if self.algorithm == "yinyang" else 1
            self._assign_tables = (centroids,) + \
                _engine.build_assign_tables(centroids, g)
        return self._assign_tables

    def _assign(self, points):
        centroids, groups, members, gsize = self._tables()
        return _engine.assign(points, centroids, groups=groups,
                              members=members, gsize=gsize,
                              device=self.device)

    def predict(self, points) -> np.ndarray:
        labels, _ = self._assign(points)
        return labels.cpu().numpy()

    def fit_predict(self, points, sample_weight=None) -> np.ndarray:
        return self.fit(points, sample_weight=sample_weight).labels_

    def transform(self, points) -> np.ndarray:
        """Distances to every fitted centroid, (N, K), computed tiled."""
        centroids = self._fitted().centroids.float()
        pts = as_float32(points, self.device)
        c2 = row_norms_sq(centroids)
        tile = 8192
        out = [pairwise_dists(pts[lo:lo + tile], centroids, None, c2)
               for lo in range(0, pts.shape[0], tile)]
        return torch.cat(out, dim=0).cpu().numpy()

    def score(self, points, sample_weight=None) -> float:
        """Negative (weighted) inertia under the fitted centroids."""
        _, dists = self._assign(points)
        d2 = dists * dists
        if sample_weight is not None:
            d2 = d2 * as_float32(sample_weight, self.device)
        return -float(torch.sum(d2))
