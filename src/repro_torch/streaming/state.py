"""Streaming-fit state (port of ``repro.streaming.state``): drift
ledger, per-shard bound cache, stats. Host-side numpy only.

The streaming fit saves work by *carrying* triangle-inequality bounds
across mini-batches instead of recomputing them per batch:

* :class:`DriftLedger` -- cumulative per-centroid and per-group drift
  since the stream started, in float64 on the host, so sums of fp32
  drifts over millions of batches stay exact enough;
* :class:`ShardBounds` -- the filter state of one shard, valid against
  the centroids at store time, plus the ledger snapshot taken then;
* :func:`inflate_bounds` -- re-validates a cached entry against the
  current centroids by the triangle inequality: every upper bound grows
  by its assigned centroid's accumulated drift, every group lower bound
  shrinks by its group's accumulated max drift.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np


@dataclasses.dataclass
class StreamStats:
    """Convergence and work diagnostics for a streaming fit. The last
    three count checkpoints written, restores and batches replayed after
    a restore (:mod:`repro_torch.streaming.resilient`)."""
    batches: int = 0
    points_seen: int = 0
    distance_evals: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    drift_resets: int = 0
    reseeds: int = 0
    init_batches: int = 0     # batches buffered for the cold-start init
    sharded_batches: int = 0  # batches run through a sharded step
    ckpt_saves: int = 0
    restores: int = 0
    replayed_batches: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ShardBounds:
    """Cached filter state for one shard. ``ub``/``lb`` are valid
    against the centroids at store time; ``ub_off``/``gdrift_snap``
    snapshot the :class:`DriftLedger` then, so :func:`inflate_bounds`
    can re-validate later without any per-step history."""
    assignments: np.ndarray   # (B,) int32
    ub: np.ndarray            # (B,) fp32
    lb: np.ndarray            # (B, G) fp32
    ub_off: np.ndarray        # (B,) f64 ledger.centroid[assignments] at store
    gdrift_snap: np.ndarray   # (G,) f64 ledger.group at store
    gmax: int                 # surviving-group high-water at store time
    ub_scale: float           # mean ub at store (drift-reset yardstick)


def inflate_bounds(entry: ShardBounds, cum_drift: np.ndarray,
                   cum_gdrift: np.ndarray):
    """Re-validate cached bounds against the current centroids:
    ``d(x, c_a_now) <= d(x, c_a_then) + ||c_a moved|| <= ub + delta``,
    and symmetrically for the group lower bounds, where the deltas are
    the ledger's accumulation since the entry's snapshot. Returns fp32
    ``(ub, lb)`` for :func:`repro_torch.core.engine.stream_bounds`."""
    ub = entry.ub + (cum_drift[entry.assignments] - entry.ub_off)
    lb = np.maximum(
        entry.lb - (cum_gdrift - entry.gdrift_snap)[None, :], 0.0)
    return ub.astype(np.float32), lb.astype(np.float32)


class DriftLedger:
    """Cumulative centroid movement since the stream started (float64)."""

    def __init__(self, k: int, n_groups: int):
        self.centroid = np.zeros((k,), np.float64)
        self.group = np.zeros((n_groups,), np.float64)

    def add(self, drift: np.ndarray, gdrift: np.ndarray) -> None:
        self.centroid += drift
        self.group += gdrift

    def add_reseed(self, c: int, dist: float, group: int) -> None:
        """A re-seeded centroid is a large drift: bounds cached before
        the reseed stay valid through the ledger."""
        self.centroid[c] += dist
        self.group[group] += dist


class BoundCache:
    """LRU map shard id -> :class:`ShardBounds`, bounded so a long tail
    of one-shot shards cannot grow host memory without limit."""

    def __init__(self, max_shards: int = 256):
        self.max_shards = max_shards
        self._d: OrderedDict = OrderedDict()

    def get(self, sid) -> ShardBounds | None:
        entry = self._d.get(sid)
        if entry is not None:
            self._d.move_to_end(sid)
        return entry

    def put(self, sid, entry: ShardBounds) -> None:
        self._d[sid] = entry
        self._d.move_to_end(sid)
        while len(self._d) > self.max_shards:
            self._d.popitem(last=False)

    def drop(self, sid) -> None:
        self._d.pop(sid, None)

    def __len__(self) -> int:
        return len(self._d)
