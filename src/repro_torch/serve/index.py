"""Double-buffered centroid index: publish/acquire epoch swap (port of
``repro.serve.index``).

The serving consistency contract in one line: **a query batch sees
exactly one epoch**. :class:`CentroidIndex` makes that structural:
every :meth:`publish` builds a fully immutable :class:`CentroidSnapshot`
(centroids, cached norms, group tables, all on the index's device) and
swaps it in atomically; :meth:`acquire` hands out the current snapshot
as one reference. Serving binds ONE snapshot per batch, so fitting and
serving never block each other and no batch can mix centroids from two
epochs.

The drift ledger decides table work: group tables only steer pruning
(any valid centroid partition is exact), so a publish whose cumulative
drift since the last rebuild stays under ``rebuild_threshold`` x the
typical centroid norm REUSES the previous snapshot's tables and skips
the ``group_centroids`` mini-kmeans. Large drift rebuilds.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..core import engine as _engine
from ..core.distances import row_norms_sq
from ..device import as_float32, resolve_device
from ..obs import normalize_obs


@dataclasses.dataclass(frozen=True)
class CentroidSnapshot:
    """One immutable published epoch: centroids + everything the
    batched assign needs, so serving a batch touches no mutable state.
    ``groups``/``members``/``gsize`` are the inference-side group tables
    (possibly REUSED from an earlier epoch — exact either way)."""
    epoch: int
    centroids: torch.Tensor         # (K, D) f32
    c2: torch.Tensor                # (K,)  f32 cached ||c||^2
    groups: torch.Tensor            # (K,)  int32 centroid -> group
    members: torch.Tensor           # (G, Lmax) int32, -1 padded
    gsize: torch.Tensor             # (G,)  int64
    tables_epoch: int               # epoch whose publish BUILT the tables

    @property
    def k(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def d(self) -> int:
        return int(self.centroids.shape[1])

    @property
    def n_groups(self) -> int:
        return int(self.gsize.shape[0])

    @property
    def device(self) -> torch.device:
        return self.centroids.device


class CentroidIndex:
    """Lock-free-read, double-buffered centroid store on ``device``
    (``None`` = ``cuda``, raising when CUDA is not there).

    Writers call :meth:`publish`; readers
    (:class:`repro_torch.serve.ServeEngine`) call :meth:`acquire` and
    keep the returned snapshot for exactly one batch. The swap is a
    single reference assignment under a lock — readers never wait on
    table builds, which happen on the publisher's thread before the
    swap.

    ``rebuild_threshold`` gates table rebuilds on the publisher's
    cumulative drift (``cum_drift=``): rebuild when any centroid has
    moved more than ``rebuild_threshold * sqrt(mean ||c||^2)`` since the
    tables were last built. Publishes without drift information always
    rebuild (the safe default for arbitrary centroid jumps).
    """

    def __init__(self, centroids=None, *, n_groups: int | None = None,
                 rebuild_threshold: float = 0.05, obs=None, device=None):
        self.device = resolve_device(device)
        self.n_groups = n_groups
        self.rebuild_threshold = float(rebuild_threshold)
        self._lock = threading.Lock()
        self._snap: CentroidSnapshot | None = None
        self._drift_at_rebuild: np.ndarray | None = None
        self._rebuild_scale = 0.0
        self.publishes = 0
        self.rebuilds = 0
        self.reuses = 0
        self._obs = normalize_obs(obs)
        if centroids is not None:
            self.publish(centroids)

    # -- writer side -------------------------------------------------------

    def _should_rebuild(self, snap, centroids, cum_drift,
                        force_rebuild) -> bool:
        if force_rebuild or snap is None or cum_drift is None:
            return True
        if centroids.shape != snap.centroids.shape:
            return True
        if self._drift_at_rebuild is None or \
                len(cum_drift) != len(self._drift_at_rebuild):
            return True
        moved = float(np.max(np.asarray(cum_drift, np.float64)
                             - self._drift_at_rebuild))
        return moved > self.rebuild_threshold * self._rebuild_scale

    def publish(self, centroids, *, cum_drift=None,
                force_rebuild: bool = False) -> int:
        """Swap in a new epoch; returns its epoch number.

        ``cum_drift`` — (K,) cumulative per-centroid drift; enables table
        REUSE under the drift threshold. ``force_rebuild`` rebuilds
        unconditionally. Never called concurrently with itself (one
        fitter owns the index); safe against any number of concurrent
        readers. The centroids are copied (never aliased) onto the
        index's device."""
        if isinstance(centroids, torch.Tensor):
            centroids = centroids.detach().to(self.device, torch.float32,
                                              copy=True)
        else:
            centroids = as_float32(centroids, self.device)
        c2 = row_norms_sq(centroids)
        snap = self._snap
        epoch = (snap.epoch if snap else 0) + 1
        if self._should_rebuild(snap, centroids, cum_drift, force_rebuild):
            groups, members, gsize = _engine.build_assign_tables(
                centroids, self.n_groups)
            tables_epoch = epoch
            self._drift_at_rebuild = (
                None if cum_drift is None
                else np.asarray(cum_drift, np.float64).copy())
            self._rebuild_scale = float(torch.sqrt(torch.mean(c2) + 1e-12))
            self.rebuilds += 1
        else:
            groups, members, gsize = snap.groups, snap.members, snap.gsize
            tables_epoch = snap.tables_epoch
            self.reuses += 1
        new = CentroidSnapshot(epoch=epoch, centroids=centroids, c2=c2,
                               groups=groups, members=members,
                               gsize=gsize, tables_epoch=tables_epoch)
        with self._lock:
            self._snap = new
        self.publishes += 1
        if self._obs is not None:
            reg = self._obs.resolve_registry()
            reg.counter("serve_publishes_total",
                        "centroid epochs published").inc()
            reg.counter("serve_table_rebuilds_total",
                        "publishes that rebuilt group tables").inc(
                1.0 if tables_epoch == epoch else 0.0)
            reg.gauge("serve_epoch", "current published epoch").set(
                float(epoch))
        return epoch

    # -- reader side -------------------------------------------------------

    @property
    def ready(self) -> bool:
        return self._snap is not None

    def acquire(self) -> CentroidSnapshot:
        """The current snapshot. Hold it for one batch; never cache it
        across batches (that would pin an old epoch alive)."""
        with self._lock:
            snap = self._snap
        if snap is None:
            raise RuntimeError(
                "CentroidIndex has no published centroids yet; call "
                "publish() first")
        return snap
