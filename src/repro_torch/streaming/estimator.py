"""StreamingKMeans: bound-carrying mini-batch K-means (port of
``repro.streaming.estimator``), on one device or sharded over the ranks
of a mesh.

The batch engine realises KPynq's two filter levels as skipped work
inside one fit; this estimator carries the same candidate pass over
point streams that never fit in memory at once:

1. **Ingest**: ``partial_fit(batch, shard_id=...)`` or
   ``fit_stream(PointStream, epochs=...)``. A shard id promises that
   the same id always carries the same points (the ``(seed, shard)``
   generation of :class:`repro_torch.data.PointStream` keeps it).
2. **Bound carry**: on a revisit the cached filter state is
   re-validated by :func:`inflate_bounds` from the float64
   :class:`DriftLedger`, then the point-level filter
   (:func:`repro_torch.core.engine.stream_bounds`) decides which points
   need distance work. First visits run with vacuous bounds.
3. **Candidate pass + update**: :func:`repro_torch.core.engine.stream_step`,
   the engine's compact pass at a pow2 (``cap_n``, ``cap_g``) bucket,
   the decayed count-weighted EMA (its sums from the ``centroid_update``
   kernel on the card), then the post-move bound decay, so the stored
   cache entry is valid against the new centroids.
4. **Upkeep** on the host: the drift ledger, dead-centroid patience and
   re-seeding from a far-point reservoir, the EWA inertia estimate and
   :class:`StreamStats`.

Host syncs a batch: a revisit reads its candidate count, the bounds'
own-distance refreshes and the pass's group high-water in one transfer
(the compact pass needs ``cap_n`` on the host); every batch then brings
its nine step outputs home in one transfer. A first visit makes only
the second. A reseed reads the old centroid's row.

``decay=1.0`` (default) is pure count-weighting, a per-centroid 1/n
learning rate that converges to the batch fit on a stationary stream;
``decay<1`` forgets with a horizon of about ``1/(1-decay)`` batches.

Cold start: batches are buffered until ``init_size`` points (default
``2 * n_clusters``) are there, the centroids are seeded from the buffer
(:meth:`StreamingKMeans._seed_centroids`), the centroid groups are
built once (they stay fixed; drift handles all later movement), and the
buffered batches are replayed through the normal step.

Checkpoints: ``save`` snapshots the full stream state (the
``skm-stream-state-v1`` format of the reference, so each package
restores the other's) through :mod:`repro_torch.checkpoint`;
``restore``/``restore_state`` bring it back and
``fit_stream(resilient=True)`` replays the deterministic stream after a
failure (:mod:`repro_torch.streaming.resilient`).

Sharded (``mesh=``, a 1-D mesh from
:func:`repro_torch.core.distributed.make_mesh`): every rank of the mesh
calls ``partial_fit``/``fit_stream`` with the same global batch. Each
pads it to the shard lattice with sentinel rows (weight 0, label K - 1,
``ub`` 0, ``lb`` +inf, never a candidate; an unweighted padded batch
passes the valid mask as its weights) and keeps its own rows for the
device work (:func:`~repro_torch.core.distributed.
make_stream_bounds_sharded`, :func:`~repro_torch.core.distributed.
make_stream_update_sharded`). A batch's collectives are the all-reduce
of the (K, D) sums and (K,) counts, the telemetry's, the one gather of
a revisit's candidate counts and the one gather of the step's rows:
every rank then holds the global batch's labels and bounds, and the
host upkeep (ledger, cache, reservoir, reseeds, stats) runs on the same
inputs on every rank, so every rank takes the same branches, issues the
same collectives and would write the same checkpoint. Rank 0 of the
mesh writes it. A checkpoint restores under any other mesh or none
(:meth:`StreamingKMeans.restore`): the cache holds the global batch's
rows unpadded, and the next batch re-pads into the new lattice.
"""
from __future__ import annotations

import collections.abc
import dataclasses
import time

import numpy as np
import torch

from ..core import engine as _engine
from ..core.api import NotFittedError
from ..core.engine import PassCore, _bucket_cap
from ..core.init import kmeans_plusplus, random_init
from ..core.kmeans import group_centroids
from ..device import as_float32, resolve_device
from ..obs.metrics import normalize_obs
from .state import (BoundCache, DriftLedger, ShardBounds, StreamStats,
                    inflate_bounds)



def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float32, copy=False)
    return np.asarray(x, np.float32)


def _step_words(out: _engine.StreamStepOut) -> torch.Tensor:
    """The nine step outputs the host keeps as one int32 tensor on the
    device: each viewed as 32-bit words (the int64 scalars as two) and
    concatenated, so every bit survives the trip home."""
    def bits(t):
        return t.contiguous().reshape(-1).view(torch.int32)

    parts = [out.pairs.long().reshape(1), out.gmax.long().reshape(1),
             out.assignments.int(), out.ub, out.lb, out.drift, out.gdrift,
             out.batch_counts, out.batch_cost.reshape(1)]
    return torch.cat([bits(p) for p in parts])


def _fetch_step(out: _engine.StreamStepOut, b: int, g: int):
    """The nine step outputs the host keeps, in ONE device-to-host
    transfer (:func:`_step_words`). Returns numpy ``(assignments, ub,
    lb, pairs, gmax, drift, gdrift, batch_counts, batch_cost)``."""
    return _unpack_step(_step_words(out).cpu().numpy(), b, g,
                        out.drift.shape[0])


def _fetch_step_sharded(out: _engine.StreamStepOut, b: int, g: int,
                        group, shards: int):
    """:func:`_fetch_step` for a sharded step: every rank's words are
    all-gathered in one collective (one device-to-host copy), the
    rows concatenated in rank order and cut to the global batch's ``b``;
    the reduced outputs are the same on every rank."""
    from ..core.distributed import _gather
    k = out.drift.shape[0]
    words = _gather(_step_words(out), group, shards, host=True).numpy()
    per = [_unpack_step(w, out.ub.shape[0], g, k)
           for w in words.reshape(shards, -1)]
    nas, ub, lb = (np.concatenate([p[i] for p in per])[:b]
                   for i in range(3))
    return (nas, ub, lb) + per[0][3:]


def _unpack_step(flat: np.ndarray, b: int, g: int, k: int):
    pairs, gmax = flat[:4].copy().view(np.int64)
    sizes = (b, b, b * g, k, g, k, 1)
    ends = np.cumsum((4,) + sizes)
    nas, ub, lb, drift, gdrift, bcounts, cost = (
        flat[lo:hi] for lo, hi in zip(ends[:-1], ends[1:]))
    return (nas, ub.view(np.float32), lb.view(np.float32).reshape(b, g),
            int(pairs), int(gmax), drift.view(np.float32),
            gdrift.view(np.float32), bcounts.view(np.float32),
            float(cost.view(np.float32)[0]))


class StreamingKMeans:
    """sklearn-style streaming K-means estimator (see the module
    docstring), on ``device`` (``None`` = ``cuda``, raising when CUDA is
    not there).

    Parameters, as in the reference
    -------------------------------
    n_clusters : K
    n_groups : Yinyang group count (default K//10; 1 = Hamerly filter)
    init : 'k-means++' | 'random', seeding over the cold-start buffer on
        a ``torch.Generator`` seeded with ``seed``
    decay : count decay per batch (1.0 = pure count-weighting)
    init_size : points buffered before seeding (default 2*K)
    min_bucket : floor of the pow2 candidate-capacity lattice
    max_cached_shards : LRU size of the per-shard bound cache
    reseed_patience : full passes over the shards seen (in batches)
        without points before a centroid is re-seeded from the
        far-point reservoir
    drift_reset_factor : drop a cached shard when the accumulated group
        drift exceeds this multiple of its stored mean ub (the bounds
        stay valid but vacuous; recomputing beats carrying them)
    chunk : the compact pass's group-gather limit on ``cap_n``
    tune : 'auto' | 'off' | 'force': at cold start, adopt the port's
        tuned ``min_cap``, ``chunk`` and group-gather factor for
        (card, B, K, D) (:mod:`repro_torch.tune`); explicit
        ``min_bucket``/``chunk`` win; 'force' reads like 'auto' (the
        stream never searches). Results are the same either way.
    obs : publishes per-batch metrics and a ``stream_batch`` event to
        the registry (:mod:`repro_torch.obs`); host bookkeeping only.
    mesh / mesh_axes : a 1-D ``DeviceMesh`` and its axis (default
        ``("data",)``): the global batch is split over the mesh's ranks,
        each runs the step on its rows and the batch sums are
        all-reduced (see the module docstring). Every rank of the mesh
        makes the same calls; a rank outside it raises ``ValueError``.
        With ``device=None`` rank r runs on ``cuda:(r % card count)``.
    """

    def __init__(self, n_clusters: int, *, n_groups: int | None = None,
                 init: str = "k-means++", decay: float = 1.0,
                 init_size: int | None = None, seed: int = 0,
                 min_bucket: int | None = None,
                 max_cached_shards: int = 256,
                 reseed_patience: int = 20,
                 drift_reset_factor: float = 8.0,
                 chunk: int | None = None,
                 tune: str = "auto",
                 mesh=None, mesh_axes=("data",), obs=None, device=None):
        if init not in ("k-means++", "random"):
            raise ValueError(f"unknown init {init!r}")
        if not 0.0 < decay <= 1.0:
            raise ValueError("decay must be in (0, 1]")
        if tune not in ("auto", "off", "force"):
            raise ValueError(f"unknown tune mode {tune!r}; expected "
                             f"'auto', 'off' or 'force'")
        self.n_clusters = int(n_clusters)
        self.n_groups = n_groups
        self.init = init
        self.decay = float(decay)
        self.init_size = init_size
        self.seed = seed
        # None = the default, tunable; an explicit value always wins
        self._explicit_min_bucket = min_bucket is not None
        self._explicit_chunk = chunk is not None
        self.min_bucket = int(min_bucket) if min_bucket is not None else 256
        self.reseed_patience = int(reseed_patience)
        self.drift_reset_factor = float(drift_reset_factor)
        self.chunk = int(chunk) if chunk is not None else 2048
        self.tune = tune
        self._ggf = 4                     # group-gather crossover factor
        self.mesh = mesh
        self.mesh_axes = tuple(mesh_axes or ("data",))
        self._n_shards, self._rank, self._group = 1, 0, None
        if mesh is not None:
            from ..core import distributed as _dist
            self._group = _dist._group(mesh, self.mesh_axes)
            self._rank = _dist.mesh_rank(mesh, self.mesh_axes)
            self._n_shards = _dist._mesh_shards(mesh, self.mesh_axes)
            self.device = _dist._default_device(device)
        else:
            self.device = resolve_device(device)
        self._sharded_bounds = None       # built lazily for the mesh
        self._sharded_updates: dict = {}  # (cap_n, cap_g, weighted) -> fn

        self._obs = normalize_obs(obs)
        self.stats_ = StreamStats()
        self.ewa_inertia_: float | None = None
        self._ewa_alpha = 0.25
        self._centroids = None            # (K, D) on the device once live
        self._counts = None               # (K,)
        self._buffer: list = []           # [(shard_id, points, weights)]
        self._buffered = 0
        self._cache = BoundCache(max_cached_shards)
        self._ledger: DriftLedger | None = None
        self._labels_last: np.ndarray | None = None
        # chaos-test seam: called in _step after the device update has
        # landed and before the host commit (ledger, cache, stats).
        # Raising here models a host crash mid-batch: the estimator is
        # left torn, and only a checkpoint restore makes it whole again
        self.chaos_hook = None
        # a repro_torch.serve.CentroidIndex published into every
        # _publish_every committed batches (attach_index)
        self._serve_index = None
        self._publish_every = 1

    # -- lifecycle ---------------------------------------------------------

    @property
    def initialized(self) -> bool:
        return self._centroids is not None

    def _require_fitted(self):
        if not self.initialized:
            raise NotFittedError(
                "This StreamingKMeans instance has no centroids yet; "
                "call partial_fit()/fit_stream() (enough points to cover "
                "init_size) first.")

    def _resolved_groups(self) -> int:
        g = self.n_groups
        if g is None:
            g = max(self.n_clusters // 10, 1)
        return int(min(g, self.n_clusters))

    def _seed_centroids(self, points: torch.Tensor,
                        weights: torch.Tensor | None) -> torch.Tensor:
        """The cold start's (K, D) seeds from the buffered points (and
        their weights, where any batch carried them)."""
        gen = torch.Generator(device=points.device).manual_seed(self.seed)
        if self.init == "k-means++":
            return kmeans_plusplus(gen, points, self.n_clusters,
                                   weights=weights)
        return random_init(gen, points, self.n_clusters)

    def _initialize(self) -> None:
        buf = np.concatenate([p for _, p, _ in self._buffer], axis=0)
        k = self.n_clusters
        dev = self.device
        if len(buf) < k:
            raise ValueError(
                f"need at least n_clusters={k} buffered points to "
                f"initialize, got {len(buf)}")
        # weighted D^2 seeding when any buffered batch carried weights
        # (weightless batches count as 1.0)
        buf_w = None
        if any(w is not None for _, _, w in self._buffer):
            buf_w = as_float32(np.concatenate(
                [w if w is not None else np.ones((len(p),), np.float32)
                 for _, p, w in self._buffer], axis=0), dev)
        init_c = self._seed_centroids(as_float32(buf, dev), buf_w).float()

        g = self._resolved_groups()
        self._groups = group_centroids(init_c, g)
        self._groups_np = self._groups.cpu().numpy()
        self._g = g
        self._members, self._gsize = _engine.build_group_tables(
            self._groups_np, g, dev)

        if self.tune != "off":
            # the tuned engine configuration for this batch shape (B =
            # the first batch's size); explicit arguments keep precedence
            from .. import tune as _tune
            cfg = _tune.lookup(n=self._buffer[0][1].shape[0], k=k,
                               d=int(buf.shape[1]),
                               platform=_tune.platform_name(dev))
            if cfg is not None:
                if not self._explicit_min_bucket:
                    self.min_bucket = int(cfg.min_cap)
                if not self._explicit_chunk:
                    self.chunk = int(cfg.chunk)
                self._ggf = int(cfg.group_gather_factor)
        self._centroids = init_c
        self._counts = torch.zeros((k,), dtype=torch.float32, device=dev)
        self._ledger = DriftLedger(k, g)
        self._since_hit = np.zeros((k,), np.int64)
        self._shards_seen: set = set()
        self._far: list = []              # [(ub, point)] reseed reservoir

        replay, self._buffer, self._buffered = self._buffer, [], 0
        for sid, batch, w in replay:
            self._step(batch, sid, w)

    # -- the per-batch step ------------------------------------------------

    def partial_fit(self, points, shard_id=None,
                    sample_weight=None) -> "StreamingKMeans":
        """One mini-batch update. ``shard_id`` (hashable) keys the bound
        cache: pass it whenever the same points will come again, so
        carried bounds can skip the distance work. ``sample_weight``:
        optional (B,) weights for the batch sums, counts and the EWA
        cost; bounds and filters do not depend on them."""
        pts = _host_array(points)
        if pts.ndim != 2 or pts.shape[0] == 0:
            raise ValueError(f"expected a non-empty (B, D) batch, got "
                             f"shape {pts.shape}")
        w = None if sample_weight is None else _host_array(sample_weight)
        if w is not None and w.shape != (pts.shape[0],):
            raise ValueError(f"sample_weight shape {w.shape} does not "
                             f"match batch shape {pts.shape}")
        if not self.initialized:
            self._buffer.append((shard_id, pts, w))
            self._buffered += len(pts)
            self.stats_.init_batches += 1
            size = self.init_size or 2 * self.n_clusters
            if self._buffered >= max(size, self.n_clusters):
                self._initialize()
            return self
        self._step(pts, shard_id, w)
        return self

    def _local_core(self, cap_n: int, cap_g: int) -> PassCore:
        """The step's pass core at one (cap_n, cap_g) bucket: the compact
        backend, as the reference's, so ``distance_evals`` counts the
        same pairs (the kernel backend counts whole tiles)."""
        return PassCore(backend="compact", k=self.n_clusters,
                        n_groups=self._g, cap_n=cap_n, cap_g=cap_g,
                        chunk=self.chunk, group_gather_factor=self._ggf)

    def _sharded_update_fn(self, cap_n: int, cap_g: int, weighted: bool):
        key = (cap_n, cap_g, weighted)
        fn = self._sharded_updates.get(key)
        if fn is None:
            from ..core import distributed as _dist
            fn = _dist.make_stream_update_sharded(
                self.mesh, self.mesh_axes, k=self.n_clusters,
                n_groups=self._g, cap_n=cap_n, cap_g=cap_g,
                chunk=self.chunk, group_gather_factor=self._ggf,
                weighted=weighted)
            self._sharded_updates[key] = fn
        return fn

    def _barrier(self) -> None:
        """Wait for every rank of the mesh (no-op without one)."""
        if self._group is not None:
            import torch.distributed as dist
            dist.barrier(group=self._group)

    def _step(self, pts_np: np.ndarray, sid, w_np=None) -> None:
        t0 = time.perf_counter()
        b = pts_np.shape[0]
        g = self._g
        k = self.n_clusters
        st = self.stats_
        dev = self.device
        sharded = self.mesh is not None
        # this rank's rows of the global batch padded to the shard
        # lattice: [lo, lo + shard_b), the real ones [lo, hi)
        shard_b = (b + (-b) % self._n_shards) // self._n_shards
        lo = self._rank * shard_b
        hi = min(lo + shard_b, b)
        n_sent = shard_b - max(hi - lo, 0)
        pad = shard_b * self._n_shards - b
        mine = slice(min(lo, b), hi)

        def padded(part, fill):
            """This rank's real rows, then its sentinel rows (``fill``)."""
            if not n_sent:
                return part
            return np.concatenate([part, np.full(
                (n_sent,) + part.shape[1:], fill, part.dtype)])

        entry = self._cache.get(sid) if sid is not None else None
        if entry is not None:
            slack = float(np.max(self._ledger.group - entry.gdrift_snap))
            if slack > self.drift_reset_factor * max(entry.ub_scale, 1e-12):
                # bounds still valid but vacuous: recompute from scratch
                self._cache.drop(sid)
                st.drift_resets += 1
                entry = None

        pts = as_float32(padded(pts_np[mine], 0.0), dev)
        # sentinel rows weigh 0: an unweighted padded batch passes the
        # valid mask (ones on real rows are no weights, bit for bit)
        w = None
        if w_np is not None or pad:
            ones = np.ones((b,), np.float32) if w_np is None else w_np
            w = as_float32(padded(ones[mine], 0.0), dev)
        tightened = 0
        if entry is not None:
            st.cache_hits += 1
            # inflate this rank's rows only; the entry stays global
            own = entry if not sharded else dataclasses.replace(
                entry, assignments=entry.assignments[mine],
                ub=entry.ub[mine], lb=entry.lb[mine],
                ub_off=entry.ub_off[mine])
            ub_i, lb_i = inflate_bounds(own, self._ledger.centroid,
                                        self._ledger.group)
            assign = torch.from_numpy(
                padded(own.assignments.astype(np.int32), k - 1)).to(dev)
            lb_d = torch.from_numpy(padded(lb_i, np.inf)).to(dev)
            ub_i = torch.from_numpy(padded(ub_i, 0.0)).to(dev)
            if sharded:
                if self._sharded_bounds is None:
                    from ..core import distributed as _dist
                    self._sharded_bounds = _dist.make_stream_bounds_sharded(
                        self.mesh, self.mesh_axes)
                # n_cand is the largest per-rank count, what the
                # per-rank cap_n must cover; gmax is this rank's own
                ub_t, need, n_cand, tightened, gmax = self._sharded_bounds(
                    pts, self._centroids, assign, ub_i, lb_d)
            else:
                ub_t, need, n_cand, n_tight = _engine.stream_bounds(
                    pts, self._centroids, assign, ub_i, lb_d)
                # the one read of a revisit: cap_n needs the candidate
                # count on the host, and with the pass's gmax beside it
                # the compact pass takes its branch without a read
                n_cand, tightened, gmax = (int(v) for v in torch.stack([
                    n_cand, n_tight,
                    _engine.pending_gmax(need, ub_t, lb_d)]).tolist())
            gmax_guess = max(int(entry.gmax), 1)
        else:
            st.cache_misses += 1

            def vacuous(tail, real, sentinel, dtype):
                t = torch.full((shard_b,) + tail, real, dtype=dtype,
                               device=dev)
                if n_sent:
                    t[shard_b - n_sent:] = sentinel
                return t

            assign = vacuous((), 0, k - 1, torch.int32)
            ub_t = vacuous((), float("inf"), 0.0, torch.float32)
            lb_d = vacuous((g,), 0.0, float("inf"), torch.float32)
            need = vacuous((), True, False, torch.bool)
            # vacuous bounds: every point a candidate, every group alive
            n_cand, gmax, gmax_guess = shard_b, g, g

        # pow2 capacity lattice: cap_n >= the candidate count is a hard
        # requirement of the compact pass; cap_g is a guess it spills
        # past. Sharded, both are per rank, sized from the worst rank
        cap_n = min(_bucket_cap(max(n_cand, 1), min(self.min_bucket,
                                                     shard_b), shard_b),
                    shard_b)
        cap_g = _bucket_cap(gmax_guess, 1, g)
        if sharded:
            upd = self._sharded_update_fn(cap_n, cap_g, w is not None)
            out = upd(pts, self._centroids, self._counts, self.decay,
                      self._groups, self._members, self._gsize, assign,
                      ub_t, lb_d, need, w, gmax=gmax)
            st.sharded_batches += 1
        else:
            out = _engine.stream_step(
                pts, self._centroids, self._counts, self.decay,
                self._groups, self._members, self._gsize, assign, ub_t,
                lb_d, need, w, core=self._local_core(cap_n, cap_g),
                gmax=gmax)
        self._centroids, self._counts = out.centroids, out.counts
        if self.chaos_hook is not None:
            self.chaos_hook(self, sid)

        (nas_np, ub_np, lb_np, pairs, gmax, drift_np, gdrift_np,
         bcounts_np, bcost) = (
            _fetch_step_sharded(out, b, g, self._group, self._n_shards)
            if sharded else _fetch_step(out, b, g))
        self._ledger.add(drift_np.astype(np.float64),
                         gdrift_np.astype(np.float64))

        st.batches += 1
        st.points_seen += b
        st.distance_evals += float(pairs + tightened)
        # EWA cost per unit of sample mass (per point when unweighted)
        mass = b if w_np is None else max(float(w_np.sum()), 1e-12)
        per_pt = bcost / mass
        self.ewa_inertia_ = per_pt if self.ewa_inertia_ is None else \
            (1 - self._ewa_alpha) * self.ewa_inertia_ \
            + self._ewa_alpha * per_pt
        self._labels_last = nas_np

        if sid is not None:
            self._cache.put(sid, ShardBounds(
                assignments=nas_np, ub=ub_np, lb=lb_np,
                ub_off=self._ledger.centroid[nas_np],
                gdrift_snap=self._ledger.group.copy(),
                gmax=max(gmax, 1), ub_scale=float(np.mean(ub_np))))
            self._shards_seen.add(sid)
        self._since_hit = np.where(bcounts_np > 0, 0, self._since_hit + 1)
        self._push_far(pts_np, ub_np)
        self._maybe_reseed()

        if self._serve_index is not None and \
                st.batches % self._publish_every == 0:
            # the index swaps in this batch's committed centroids; the
            # cumulative drift rides along for its rebuild-or-reuse rule
            self._serve_index.publish(
                self._centroids, cum_drift=self._ledger.centroid)

        if self._obs is not None:
            # the step's transfer above already waited for the device,
            # so this wall-clock covers the batch's device work
            dt = time.perf_counter() - t0
            self._publish_batch(b=b, dt=dt, sid=sid, n_cand=n_cand,
                                pairs=float(pairs + tightened),
                                hit=entry is not None)

    def _publish_batch(self, *, b, dt, sid, n_cand, pairs, hit) -> None:
        """Per-batch metrics (``obs=`` on only), the reference's names."""
        reg = self._obs.resolve_registry()
        st = self.stats_
        reg.counter("stream_batches_total", "mini-batches processed").inc()
        reg.counter("stream_points_total", "points processed").inc(b)
        reg.histogram("stream_batch_seconds", "per-batch wall-clock",
                      ).observe(dt)
        reg.gauge("stream_points_per_s",
                  "last batch's throughput").set(b / max(dt, 1e-9))
        reg.gauge("stream_drift_magnitude",
                  "cumulative drift-ledger centroid magnitude").set(
            float(self._ledger.centroid.sum()))
        reg.gauge("stream_cache_hits", "bound-cache hits").set(
            st.cache_hits)
        reg.gauge("stream_cache_misses", "bound-cache misses").set(
            st.cache_misses)
        reg.gauge("stream_reseeds", "dead-centroid reseeds").set(
            st.reseeds)
        reg.gauge("stream_ewa_inertia", "EWA per-point batch cost").set(
            self.ewa_inertia_ or 0.0)
        reg.log_event("stream_batch", batch=st.batches, size=b,
                      seconds=dt, shard=sid, n_cand=int(n_cand),
                      pairs=pairs, cache_hit=bool(hit),
                      reseeds=st.reseeds,
                      drift=float(self._ledger.centroid.sum()))

    # -- dead-centroid re-seeding ------------------------------------------

    def _push_far(self, pts_np: np.ndarray, ub_np: np.ndarray,
                  keep: int = 2, cap: int = 64) -> None:
        """Reservoir of far points (largest distance to the assigned
        centroid), the reseed candidates: O(B) a batch, no distances."""
        order = np.argsort(ub_np)[-keep:]
        for i in order:
            if np.isfinite(ub_np[i]):
                self._far.append((float(ub_np[i]), pts_np[i].copy()))
        self._far.sort(key=lambda t: -t[0])
        del self._far[cap:]

    def _maybe_reseed(self, per_batch: int = 2) -> None:
        # patience in epochs: dead only after reseed_patience full passes
        # over the shards seen so far without a point
        patience = self.reseed_patience * max(len(self._shards_seen), 1)
        dead = np.nonzero(self._since_hit >= patience)[0]
        for c in dead[:per_batch]:
            if not self._far:
                break
            _, p = self._far.pop(0)
            old = self._centroids[c].cpu().numpy()
            # new tensors: a published or returned centroid set never
            # changes under its holder
            self._centroids = self._centroids.clone()
            self._centroids[c] = torch.from_numpy(p).to(self.device)
            self._counts = self._counts.clone()
            self._counts[c] = 1.0
            # a reseed is a big drift: cached bounds stay valid
            self._ledger.add_reseed(int(c), float(np.linalg.norm(p - old)),
                                    int(self._groups_np[c]))
            self._since_hit[c] = 0
            self.stats_.reseeds += 1

    # -- checkpoint / restore ----------------------------------------------

    _CKPT_FORMAT = "skm-stream-state-v1"

    def _pack_state(self):
        """Snapshot the full stream state as ``(leaves, meta)``.

        Every array is a copy: the ledger and ``_since_hit`` change in
        place in later steps, and the cache entries and labels are views
        into a step's transfer buffer, so the snapshot is safe to hand
        to an async writer. The leaf head is ``[centroids, counts,
        ledger_centroid, ledger_group, since_hit, groups, labels_last,
        far_ub, far_pts]``; each cached shard appends ``[assignments,
        ub, lb, ub_off, gdrift_snap]`` in LRU order, its id and scalars
        in ``meta['cache']``. The dtypes are the reference's (f32
        centroids, counts and bounds, f64 ledger and its snapshots, i64
        ``since_hit``, i32 groups and assignments), and the float64
        ledger stays float64 end to end."""
        self._require_fitted()
        d = int(self._centroids.shape[1])
        labels = self._labels_last
        far_ub = np.asarray([u for u, _ in self._far], np.float64)
        far_pts = (np.stack([p for _, p in self._far]).astype(np.float32)
                   if self._far else np.zeros((0, d), np.float32))
        leaves = [
            np.array(self._centroids.cpu().numpy(), np.float32),
            np.array(self._counts.cpu().numpy(), np.float32),
            self._ledger.centroid.copy(),
            self._ledger.group.copy(),
            self._since_hit.copy(),
            np.array(self._groups_np, np.int32),
            (np.zeros((0,), np.int32) if labels is None
             else np.array(labels)),
            far_ub, far_pts,
        ]
        cache_meta = []
        for sid, e in self._cache._d.items():            # LRU order
            leaves += [np.array(e.assignments), np.array(e.ub),
                       np.array(e.lb), np.array(e.ub_off),
                       np.array(e.gdrift_snap)]
            cache_meta.append({"sid": sid, "gmax": int(e.gmax),
                               "ub_scale": float(e.ub_scale)})
        meta = {
            "format": self._CKPT_FORMAT,
            "config": {
                "n_clusters": self.n_clusters, "n_groups": self._g,
                "init": self.init, "decay": self.decay,
                "init_size": self.init_size, "seed": self.seed,
                "min_bucket": self.min_bucket, "chunk": self.chunk,
                "ggf": self._ggf,
                "reseed_patience": self.reseed_patience,
                "drift_reset_factor": self.drift_reset_factor,
                "max_cached_shards": self._cache.max_shards,
            },
            "has_labels": labels is not None,
            "ewa_inertia": self.ewa_inertia_,
            "stats": self.stats_.to_dict(),
            "shards_seen": sorted(self._shards_seen),
            "cache": cache_meta,
            "n_shards_at_save": self._n_shards,
        }
        return leaves, meta

    def save(self, ckpt_dir, step: int, *, async_: bool = False):
        """Checkpoint the full stream state (:meth:`_pack_state`) through
        :func:`repro_torch.checkpoint.save_checkpoint`: atomic publish,
        the ``LATEST`` pointer, an optional async writer thread
        (returned, for the caller to ``join``). ``step`` is the
        stream-schedule index the state stands at; a restore hands it
        back so replay knows where to resume.

        Sharded, every rank calls it and rank 0 of the mesh writes (the
        state is the same on every rank; the others return ``None``).
        ``ckpt_dir`` must be one every rank reads. A synchronous save
        returns on every rank once the checkpoint is published (a
        barrier on the mesh's group); after an async one the caller
        joins rank 0's writer and waits at :meth:`_barrier` before any
        rank restores."""
        from ..checkpoint.checkpoint import save_checkpoint
        self._require_fitted()
        t = None
        if self._rank == 0:
            leaves, meta = self._pack_state()
            t = save_checkpoint(ckpt_dir, step, leaves, async_=async_,
                                meta=meta)
        self.stats_.ckpt_saves += 1
        if not async_:
            self._barrier()
        return t

    @classmethod
    def _check_format(cls, manifest: dict) -> dict:
        meta = manifest.get("meta") or {}
        if meta.get("format") != cls._CKPT_FORMAT:
            raise ValueError(
                f"not a stream-state checkpoint (format="
                f"{meta.get('format')!r})")
        return meta

    def _install(self, manifest: dict, leaves: list) -> None:
        """Overwrite all live state from a checkpoint's host arrays. The
        ledger is copied into float64 arrays on the host and never
        passes through a tensor; the group tables are rebuilt on this
        estimator's device."""
        meta = self._check_format(manifest)
        cfg = meta["config"]
        if cfg["n_clusters"] != self.n_clusters:
            raise ValueError(
                f"checkpoint has n_clusters={cfg['n_clusters']}, "
                f"estimator has {self.n_clusters}")
        (cent, counts, led_c, led_g, since, groups, labels,
         far_ub, far_pts) = leaves[:9]
        k, g = self.n_clusters, int(cfg["n_groups"])
        dev = self.device

        self._centroids = torch.from_numpy(
            np.asarray(cent, np.float32)).to(dev)
        self._counts = torch.from_numpy(
            np.asarray(counts, np.float32)).to(dev)
        self._g = g
        self._groups_np = np.asarray(groups, np.int32)
        self._groups = torch.from_numpy(self._groups_np).to(dev)
        self._members, self._gsize = _engine.build_group_tables(
            self._groups_np, g, dev)
        self._ledger = DriftLedger(k, g)
        self._ledger.centroid[:] = led_c
        self._ledger.group[:] = led_g
        self._since_hit = np.array(since)
        self._labels_last = np.array(labels) if meta["has_labels"] else None
        self._far = [(float(u), far_pts[i].copy())
                     for i, u in enumerate(far_ub)]
        self._shards_seen = set(meta["shards_seen"])
        self.ewa_inertia_ = meta["ewa_inertia"]
        known = {f.name for f in dataclasses.fields(StreamStats)}
        self.stats_ = StreamStats(**{kk: v for kk, v in
                                     meta["stats"].items() if kk in known})
        # the tuned engine configuration was resolved at the cold start;
        # the checkpoint's values make the restored run take the same
        # (cap_n, cap_g) buckets and the same compact-pass branches
        self.min_bucket = int(cfg["min_bucket"])
        self.chunk = int(cfg["chunk"])
        self._ggf = int(cfg["ggf"])
        self._cache = BoundCache(int(cfg["max_cached_shards"]))
        off = 9
        for ce in meta["cache"]:
            a, ub, lb, ub_off, gsnap = leaves[off:off + 5]
            off += 5
            self._cache.put(ce["sid"], ShardBounds(
                assignments=np.array(a), ub=np.array(ub),
                lb=np.array(lb), ub_off=np.array(ub_off),
                gdrift_snap=np.array(gsnap), gmax=int(ce["gmax"]),
                ub_scale=float(ce["ub_scale"])))
        self._buffer, self._buffered = [], 0
        # a step built for the saving estimator's buckets stays valid,
        # but drop it as the reference does
        self._sharded_bounds = None
        self._sharded_updates = {}

    def restore_state(self, ckpt_dir, *, step: int | None = None,
                      fallback: bool = True) -> int:
        """Restore this estimator's full stream state from the latest
        (or given) checkpoint under ``ckpt_dir``; returns its
        stream-schedule step, from which the caller replays the
        deterministic stream. ``fallback=True`` walks back to the newest
        complete save when the latest is corrupt or partial."""
        from ..checkpoint.checkpoint import load_checkpoint_arrays
        got_step, manifest, leaves = load_checkpoint_arrays(
            ckpt_dir, step=step, fallback=fallback)
        self._install(manifest, leaves)
        self.stats_.restores += 1
        return got_step

    @classmethod
    def restore(cls, ckpt_dir, *, step: int | None = None, mesh=None,
                mesh_axes=("data",), obs=None, fallback: bool = True,
                device=None):
        """Build a fresh estimator on ``device`` (``None`` = ``cuda``)
        from a checkpoint, the package's own or the reference's. It is
        built with ``tune="off"`` and takes the checkpoint's
        ``min_bucket``, ``chunk`` and group-gather factor. Returns
        ``(estimator, step)``.

        The elastic entry point: ``mesh`` is the new mesh (grown,
        shrunk, or ``None`` for one device), whatever mesh saved the
        checkpoint; the state re-pads into it on the next batch. Every
        rank of the new mesh calls it."""
        from ..checkpoint.checkpoint import load_checkpoint_arrays
        got_step, manifest, leaves = load_checkpoint_arrays(
            ckpt_dir, step=step, fallback=fallback)
        cfg = cls._check_format(manifest)["config"]
        skm = cls(cfg["n_clusters"], n_groups=cfg["n_groups"],
                  init=cfg["init"], decay=cfg["decay"],
                  init_size=cfg["init_size"], seed=cfg["seed"],
                  min_bucket=cfg["min_bucket"], chunk=cfg["chunk"],
                  max_cached_shards=cfg["max_cached_shards"],
                  reseed_patience=cfg["reseed_patience"],
                  drift_reset_factor=cfg["drift_reset_factor"],
                  tune="off", mesh=mesh, mesh_axes=mesh_axes, obs=obs,
                  device=device)
        skm._install(manifest, leaves)
        skm.stats_.restores += 1
        return skm, got_step

    def reset_state(self) -> None:
        """Drop all learned state, back to the just-constructed cold
        start (the restore of a failure before the first checkpoint:
        replaying the deterministic stream from step 0 through a reset
        estimator reproduces the original cold start bit for bit)."""
        self._centroids = None
        self._counts = None
        self._ledger = None
        self._labels_last = None
        self._buffer, self._buffered = [], 0
        self._cache = BoundCache(self._cache.max_shards)
        self.stats_ = StreamStats()
        self.ewa_inertia_ = None

    def adopt_centroids(self, centroids, counts=None) -> None:
        """Warm handover: replace the live centroids with supplied ones
        without discarding the bound cache. Each centroid's jump enters
        the :class:`DriftLedger` like a reseed, so every cached bound
        stays a true bound against the adopted centroids."""
        self._require_fitted()
        new = _host_array(centroids)
        old = self._centroids.cpu().numpy()
        if new.shape != old.shape:
            raise ValueError(f"adopted centroids shape {new.shape} != "
                             f"{old.shape}")
        jump = np.linalg.norm(new - old, axis=-1).astype(np.float64)
        gjump = np.zeros((self._g,), np.float64)
        np.maximum.at(gjump, self._groups_np.astype(np.int64), jump)
        self._ledger.add(jump, gjump)
        self._centroids = torch.tensor(new, device=self.device)
        if counts is not None:
            self._counts = torch.tensor(_host_array(counts),
                                        device=self.device)

    # -- stream driving ----------------------------------------------------

    def attach_index(self, index, every: int = 1) -> "StreamingKMeans":
        """Continuous refresh: publish the committed centroids into a
        :class:`repro_torch.serve.CentroidIndex` every ``every`` batches,
        after the batch's host commit, with the cumulative drift ledger
        (so the index may reuse its group tables). ``None`` detaches."""
        self._serve_index = index
        self._publish_every = max(int(every), 1)
        if index is not None and self.initialized:
            index.publish(self._centroids, cum_drift=self._ledger.centroid)
        return self

    def fit_stream(self, source, epochs: int = 1,
                   max_batches: int | None = None, *,
                   resilient: bool = False, ckpt_dir=None,
                   ckpt_every: int = 8, injector=None, watchdog=None,
                   max_restarts: int = 8,
                   async_ckpt: bool = True) -> "StreamingKMeans":
        """Drive :meth:`partial_fit` over a stream source: a
        :class:`repro_torch.data.PointStream` (shard ids carried,
        ``epochs`` replays it), a sequence of arrays or ``(shard_id,
        array)`` pairs, or any iterable of those or of ``{'points': ...,
        'shard_id': ..., 'sample_weight': ...}`` dicts (also as
        ``(step, dict)``). Generators are consumed once whatever
        ``epochs`` says. A stream too short to reach ``init_size`` is
        flushed into an init at the end.

        ``resilient=True`` (needs ``ckpt_dir`` and a deterministic
        ``global_batch``-protocol source such as ``PointStream``) drives
        the fit through the fault-tolerant runtime instead: the full
        stream state is checkpointed every ``ckpt_every`` batches
        (atomic, async by default), a failure restores the latest
        complete checkpoint (falling back past corrupt ones) and replays
        the stream from its batch index, landing on the centroids of an
        uninterrupted run bit for bit
        (:mod:`repro_torch.streaming.resilient`). ``injector`` and
        ``watchdog`` are :mod:`repro_torch.runtime`'s chaos and
        straggler hooks."""
        if resilient:
            from .resilient import fit_stream_resilient
            if ckpt_dir is None:
                raise ValueError("resilient=True requires ckpt_dir")
            return fit_stream_resilient(
                self, source, ckpt_dir=ckpt_dir, epochs=epochs,
                max_batches=max_batches, ckpt_every=ckpt_every,
                injector=injector, watchdog=watchdog,
                max_restarts=max_restarts, async_ckpt=async_ckpt)
        seen = 0
        for sid, pts, w in self._iter_source(source, epochs):
            self.partial_fit(pts, shard_id=sid, sample_weight=w)
            seen += 1
            if max_batches is not None and seen >= max_batches:
                break
        if not self.initialized and self._buffer:
            self._initialize()
        return self

    @staticmethod
    def _coerce(item):
        if isinstance(item, dict):
            sid = item.get("shard_id")
            w = item.get("sample_weight")
            return (None if sid is None else int(sid)), \
                _host_array(item["points"]), \
                (None if w is None else _host_array(w))
        if isinstance(item, tuple) and len(item) == 2:
            sid, pts = item
            if isinstance(pts, dict):       # (step, batch)
                return StreamingKMeans._coerce(pts)
            return sid, _host_array(pts), None
        return None, _host_array(item), None

    def _iter_source(self, source, epochs):
        if hasattr(source, "batches"):      # PointStream
            for sid, pts in source.batches(epochs):
                yield sid, pts, None
            return
        reiterable = isinstance(source, collections.abc.Sequence)
        for _ in range(max(int(epochs), 1)):
            for item in source:
                yield self._coerce(item)
            if not reiterable:
                return

    # -- accessors ---------------------------------------------------------

    @property
    def cluster_centers_(self) -> np.ndarray:
        self._require_fitted()
        return self._centroids.cpu().numpy()

    @property
    def counts_(self) -> np.ndarray:
        """Decayed effective per-centroid counts (the EMA weights)."""
        self._require_fitted()
        return self._counts.cpu().numpy()

    @property
    def labels_(self) -> np.ndarray:
        """Assignments of the most recent batch."""
        self._require_fitted()
        return self._labels_last

    def _assign(self, points):
        return _engine.assign(points, self._centroids, groups=self._groups,
                              members=self._members, gsize=self._gsize,
                              device=self.device)

    def predict(self, points) -> np.ndarray:
        """Exact nearest-centroid labels through the tiled engine pass
        (:func:`repro_torch.core.engine.assign`, the ``grouped_assign``
        kernel on the card): no (N, K) matrix."""
        self._require_fitted()
        labels, _ = self._assign(points)
        return labels.cpu().numpy()

    def inertia_of(self, points, sample_weight=None) -> float:
        """Exact (optionally weighted) sum of squared distances of
        ``points`` to their nearest current centroid."""
        self._require_fitted()
        _, dists = self._assign(points)
        d2 = dists * dists
        if sample_weight is not None:
            d2 = d2 * as_float32(sample_weight, self.device)
        return float(torch.sum(d2))
