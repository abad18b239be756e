"""Per-(platform, N, K, D) autotuning for the port's K-means engine
(port of ``repro.tune``).

The engine's fixed heuristics (``tile_n``, ``min_cap``, the
group-gather crossover, the capacity-downshift hysteresis, the
Lloyd-versus-filter backend choice) are measured choices whose right
values depend on the problem signature. This package searches that
configuration space (:func:`autotune`), stores winners in a disk cache
of the port's own (:class:`TuneCache`,
``~/.cache/repro_torch_kmeans_tune.json`` or
``$REPRO_TORCH_KMEANS_TUNE_CACHE``; the JAX package's cache is never
written), and answers lookups from ``engine.fit(tune=...)`` /
``KMeans(tune=...)``. The serve knob family (:mod:`.serve`) shares the
cache.

Tuning is pure wall-clock: every configuration gives bit-identical
labels, ``n_iters`` and inertia (``tests/test_torch_tune.py``), so a
stale cache can never corrupt results.
"""
from __future__ import annotations

from ..core.engine import DEFAULT_CONFIG, EngineConfig
from .cache import (ENV_VAR, TuneCache, default_cache, default_path,
                    set_default_cache)
from .search import (autotune, candidate_backends, get_or_tune,
                     sharded_timing_measure, timing_measure)
from .serve import (DEFAULT_SERVE_CONFIG, ServeConfig, autotune_serve,
                    lookup_serve, serve_signature)
from .signature import platform_name, pow2_bucket, signature

__all__ = [
    "EngineConfig", "DEFAULT_CONFIG", "TuneCache", "default_cache",
    "default_path", "set_default_cache", "autotune", "get_or_tune",
    "timing_measure", "sharded_timing_measure", "signature",
    "pow2_bucket", "platform_name", "candidate_backends", "lookup",
    "ENV_VAR", "ServeConfig", "DEFAULT_SERVE_CONFIG", "serve_signature",
    "lookup_serve", "autotune_serve",
]


def lookup(*, n: int, k: int, d: int, platform: str | None = None,
           shards: int = 1,
           cache: TuneCache | None = None) -> EngineConfig | None:
    """Tuned config for a problem signature, or None on a cache miss.
    The (cheap, in-memory after the first disk read) call on
    ``engine.fit``'s path when ``tune != "off"``. ``shards > 1``
    queries the sharded engine's key (``n`` the per-shard count)."""
    if cache is None:
        cache = default_cache()
    return cache.lookup(signature(n, k, d, platform, shards=shards))
