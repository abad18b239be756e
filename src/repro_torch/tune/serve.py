"""Serve-path knob family: the serving hot loop's tuned choices (port
of ``repro.tune.serve``).

The serving subsystem (:mod:`repro_torch.serve`) has its own
configuration axis, disjoint from
:class:`~repro_torch.core.engine.EngineConfig`: the batched-assign
backend and its tile, the micro-batching bucket lattice, and the drift
threshold at which the centroid index rebuilds its group tables. The
right values depend on (platform, K, D) only: the serve path never sees
a fixed N, so N is not part of the signature.

Entries live in the same :class:`~repro_torch.tune.cache.TuneCache` as
the engine's, under ``torch|serve|``-prefixed signatures. Serve tuning
is pure wall-clock: every backend is exact, so a stale cache can never
corrupt labels.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device
from .cache import TuneCache, default_cache
from .signature import PREFIX, platform_name


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of the serving hot loop.

    backend : batched-assign realisation — ``"fused"`` (dense product +
        min-trick reduction), ``"grouped"`` (the compact candidate pass
        over the group tables), ``"kernel"`` (alias ``"pallas"``: the
        ``grouped_assign`` kernel).
    chunk : row tile inside one batch (fused backend).
    max_batch : coalescing ceiling = largest padding bucket. Requests
        larger than this are split by ``ServeEngine.submit``.
    min_bucket : smallest padding bucket; ragged batches pad up to the
        next pow2 in [min_bucket, max_batch].
    max_wait_us : optional linger after the first request of a batch,
        trading p50 latency for batch fill (0 = serve greedily).
    rebuild_threshold : max cumulative per-centroid drift (relative to
        the typical centroid norm) the index tolerates before a publish
        rebuilds the group tables instead of reusing them. Reuse is
        always exact — stale grouping only costs pruning efficiency.
    """
    backend: str = "fused"
    chunk: int = 1024
    max_batch: int = 8192
    min_bucket: int = 256
    max_wait_us: int = 0
    rebuild_threshold: float = 0.05

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ServeConfig":
        """Tolerant inverse of :meth:`to_dict` (unknown keys from a
        newer writer are ignored)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_SERVE_CONFIG = ServeConfig()


def serve_signature(k: int, d: int, platform: str | None = None) -> str:
    """Cache key of the serve knob family: ``torch|serve|platform|kK|dD``
    (the platform as :func:`~repro_torch.tune.signature.platform_name`
    gives it)."""
    if platform is None:
        platform = platform_name()
    return f"{PREFIX}|serve|{platform}|k{int(k)}|d{int(d)}"


def lookup_serve(*, k: int, d: int, platform: str | None = None,
                 cache: TuneCache | None = None) -> ServeConfig | None:
    """Tuned serve config for a (platform, K, D) signature, or None."""
    if cache is None:
        cache = default_cache()
    e = cache.entry(serve_signature(k, d, platform))
    if not e or "config" not in e:
        return None
    return ServeConfig.from_dict(e["config"])


def autotune_serve(*, k: int, d: int, backends=None,
                   chunks=(512, 1024, 2048), max_batch: int = 8192,
                   repeats: int = 5, cache: TuneCache | None = None,
                   store: bool = True, device=None,
                   grid: list | None = None) -> ServeConfig:
    """Measure the serve backend x chunk grid on a synthetic full bucket
    on ``device`` (default ``cuda``) and store the winner.

    The grid lists only backends the device runs (the kernel only on a
    card), and a candidate that raises fails the tuning: a kernel that
    does not build or launch is a fault, not a missing option.
    Every candidate computes identical labels, so best-of wall-clock (the
    device synchronised) is the whole objective. ``grid``, when given a
    list, receives one ``(config, seconds)`` per measured candidate."""
    from ..core import engine as _engine
    from ..core.distances import row_norms_sq

    dev = resolve_device(device)
    if backends is None:
        backends = ("fused", "grouped") + (
            ("kernel",) if dev.type == "cuda" else ())
    rng = np.random.default_rng(0)
    q = torch.from_numpy(
        rng.standard_normal((max_batch, d)).astype(np.float32)).to(dev)
    centroids = torch.from_numpy(
        rng.standard_normal((k, d)).astype(np.float32)).to(dev)
    c2 = row_norms_sq(centroids)
    groups, members, gsize = _engine.build_assign_tables(centroids)
    shape = (k, int(gsize.shape[0]))

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(q, centroids, c2, groups, members, gsize)
        out.cpu()                       # the labels reach the host
        return time.perf_counter() - t0

    best_cfg, best_t = DEFAULT_SERVE_CONFIG, float("inf")
    for backend in backends:
        for chunk in chunks:
            fn = _engine.make_serve_assign(shape, backend=backend,
                                           chunk=int(chunk))
            timed(fn)                   # build + warm up; raises on fault
            t_best = min(timed(fn) for _ in range(repeats))
            cfg = ServeConfig(backend=backend, chunk=int(chunk),
                              max_batch=int(max_batch))
            if grid is not None:
                grid.append((cfg, t_best))
            if t_best < best_t:
                best_t, best_cfg = t_best, cfg
    if store:
        if cache is None:
            cache = default_cache()
        cache.store(serve_signature(k, d, platform_name(dev)), best_cfg,
                    points_per_sec=max_batch / max(best_t, 1e-12),
                    measured_ms=best_t * 1e3)
    return best_cfg
