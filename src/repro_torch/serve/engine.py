"""The serving steady loop: request micro-batching over the
epoch-swapped centroid index (port of ``repro.serve.engine``).

Requests are ragged (m, D) query blocks; the "step" is one batched exact
assign (:func:`repro_torch.core.engine.make_serve_assign`), and the
model state is a :class:`~repro_torch.serve.index.CentroidSnapshot`
acquired fresh per batch, so a centroid publish lands between batches,
never inside one.

Coalesced batches pad up to a pow2 bucket in ``[min_bucket,
max_batch]``, so the set of batch shapes is the bucket lattice. The pad
buffers are reused per bucket: one on the index's device and, where
that is a card, one in pinned host memory, so the host blocks of a
batch are gathered by ``memcpy`` and cross to the card in one
asynchronous copy. Pad rows are zeroed once when a buffer is made and
otherwise hold stale rows, whose labels are sliced away.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import NamedTuple

import numpy as np
import torch

from ..core import engine as _engine
from ..obs import normalize_obs
from ..tune import DEFAULT_SERVE_CONFIG, ServeConfig, lookup_serve
from ..tune.signature import platform_name
from .index import CentroidIndex

_FILL_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


class ServeResult(NamedTuple):
    """One request's response: labels + the exact epoch that produced
    them (the swap-consistency contract: ONE epoch, never a mix)."""
    labels: np.ndarray              # (m,) int32
    epoch: int


class _Request(NamedTuple):
    points: "np.ndarray | torch.Tensor"  # (m, D) f32: host, or a tensor
                                         # on the index's device
    future: Future
    t_submit: float
    part: "_Split | None"           # set when a jumbo request was split


class _Split:
    """Aggregates the parts of a request larger than ``max_batch``.
    Parts are served in submission order by possibly different batches
    (and epochs); the user future resolves with the FIRST part's epoch
    and the concatenated labels once every part lands. The first part
    that fails fails the whole request — later parts are ignored, so
    the user future resolves exactly once either way."""

    def __init__(self, future: Future, n_parts: int):
        self.future = future
        self.labels: list = [None] * n_parts
        self.epochs: list = [None] * n_parts
        self._left = n_parts
        self._failed = False
        self._lock = threading.Lock()

    def deliver(self, i: int, labels: np.ndarray, epoch: int) -> None:
        with self._lock:
            if self._failed:
                return
            self.labels[i] = labels
            self.epochs[i] = epoch
            self._left -= 1
            done = self._left == 0
        if done:
            self.future.set_result(ServeResult(
                np.concatenate(self.labels), self.epochs[0]))

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            if self._failed:
                return
            self._failed = True
        self.future.set_exception(exc)

    def on_part(self, i: int):
        """Done-callback for part ``i``'s future. Raising inside
        ``add_done_callback`` is swallowed by concurrent.futures, so
        the exception check must happen here, not via ``f.result()``."""
        def cb(f: Future) -> None:
            exc = f.exception()
            if exc is not None:
                self.fail(exc)
            else:
                self.deliver(i, *f.result())
        return cb


def _on_device(device: torch.device):
    """Make the index's card current in this thread (the serving thread
    starts on the process's default card)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ServeEngine:
    """Micro-batching front-end over a :class:`CentroidIndex`.

    ``submit`` enqueues a (m, D) query block and returns a
    ``concurrent.futures.Future`` resolving to :class:`ServeResult`; a
    background thread drains the queue, coalesces requests up to
    ``config.max_batch`` points, pads to the pow2 bucket, binds ONE
    index snapshot, runs the batched assign on the index's device, and
    fans the label slices back out. ``assign`` is the synchronous
    convenience wrapper.

    Configuration comes from ``config=`` or the tuned serve family
    (:func:`repro_torch.tune.lookup_serve`) when ``tune != "off"``.
    Use as a context manager, or ``start()``/``stop()`` explicitly.
    """

    def __init__(self, index: CentroidIndex, *,
                 config: ServeConfig | None = None, tune: str = "on",
                 obs=None):
        self._index = index
        self._device = index.device
        self._cfg = config
        self._tune = tune
        self._obs = normalize_obs(obs)
        self._q: queue.Queue = queue.Queue()
        self._held: _Request | None = None  # opens the next batch
        self._thread: threading.Thread | None = None
        self._running = False
        self._buffers: dict = {}        # (bucket, D) -> (device, host)
        self._assigns: dict = {}        # (k, n_groups) -> fn
        self._last_epoch = None
        self.batches = 0
        self.points = 0
        self.epoch_swaps = 0
        self._metrics = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServeEngine":
        if self._running:
            return self
        if self._obs is not None:
            reg = self._obs.resolve_registry()
            self._metrics = {
                "depth": reg.gauge("serve_queue_depth",
                                   "requests waiting in the serve queue"),
                "fill": reg.histogram(
                    "serve_batch_fill",
                    "coalesced points / bucket capacity per batch",
                    buckets=_FILL_BUCKETS),
                "batches": reg.counter("serve_batches_total",
                                       "batches served"),
                "points": reg.counter("serve_points_total",
                                      "query points served"),
                "swaps": reg.counter(
                    "serve_epoch_swaps_total",
                    "batches that first observed a new epoch"),
                "latency": reg.histogram(
                    "serve_latency_seconds",
                    "submit-to-labels latency per request"),
            }
        self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-engine", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Drain outstanding requests, then stop the loop."""
        if not self._running:
            return
        self._running = False
        self._q.put(None)               # wake the loop
        self._thread.join()
        self._thread = None

    def __enter__(self) -> "ServeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client side -------------------------------------------------------

    def _block(self, points):
        """A request block: a float32 tensor already on the index's
        device is kept as it is (no host staging; made contiguous, which
        copies only a strided view); anything else becomes a contiguous
        float32 host array. The client's data is never written."""
        if isinstance(points, torch.Tensor):
            if points.device == self._device and \
                    points.dtype == torch.float32:
                return points.detach().contiguous()
            points = points.detach().cpu().numpy()
        return np.ascontiguousarray(points, dtype=np.float32)

    def submit(self, points) -> Future:
        """Enqueue one query block; returns a Future of
        :class:`ServeResult`. Blocks of more than ``max_batch`` points
        are split into max_batch-sized parts transparently. A float32
        tensor on the index's device skips host staging; host blocks
        pay one gather into the pinned buffer."""
        if not self._running:
            raise RuntimeError("ServeEngine is not running; call "
                               "start() or use it as a context manager")
        points = self._block(points)
        if points.ndim != 2:
            raise ValueError(f"points must be (m, d), got "
                             f"{tuple(points.shape)}")
        snap = self._index._snap
        if snap is not None and points.shape[1] != snap.d:
            # reject here, synchronously: a wrong-D block reaching the
            # serve thread would fail mid-batch instead
            raise ValueError(
                f"points have feature dim {points.shape[1]}, but the "
                f"index serves {snap.d}-dim centroids")
        fut: Future = Future()
        m = points.shape[0]
        now = time.perf_counter()
        cap = self._config().max_batch
        if m == 0:
            fut.set_result(ServeResult(np.zeros((0,), np.int32),
                                       snap.epoch if snap else 0))
            return fut
        if m <= cap:
            self._q.put(_Request(points, fut, now, None))
            return fut
        parts = [points[lo:lo + cap] for lo in range(0, m, cap)]
        split = _Split(fut, len(parts))
        for i, part in enumerate(parts):
            pf: Future = Future()
            pf.add_done_callback(split.on_part(i))
            self._q.put(_Request(part, pf, now, split))
        return fut

    def assign(self, points) -> ServeResult:
        """Synchronous convenience: submit + wait."""
        return self.submit(points).result()

    # -- the steady loop ---------------------------------------------------

    def _config(self) -> ServeConfig:
        if self._cfg is not None:
            return self._cfg
        if not self._index.ready:
            # the tuned lookup needs the snapshot's (k, d); do NOT
            # memoize the fallback, or a submit racing the first
            # publish pins the default config for the engine's lifetime
            return DEFAULT_SERVE_CONFIG
        cfg = None
        if self._tune != "off":
            snap = self._index._snap
            cfg = lookup_serve(k=snap.k, d=snap.d,
                               platform=platform_name(self._device))
        self._cfg = cfg or DEFAULT_SERVE_CONFIG
        return self._cfg

    def _bucket(self, count: int) -> int:
        cfg = self._config()
        return _engine._bucket_cap(count, cfg.min_bucket, cfg.max_batch)

    def _resolve_assign(self, snap):
        key = (snap.k, snap.n_groups)
        fn = self._assigns.get(key)
        if fn is None:
            cfg = self._config()
            fn = _engine.make_serve_assign(
                (snap.k, snap.n_groups), backend=cfg.backend,
                chunk=cfg.chunk)
            self._assigns[key] = fn
        return fn

    def _drain(self, first: _Request) -> list:
        """Coalesce up to max_batch points, optionally lingering
        ``max_wait_us`` for batch fill. A request that would take the
        batch past ``max_batch`` is held back to open the next batch
        (the reference appends it, and its staging then fails)."""
        cfg = self._config()
        reqs = [first]
        total = first.points.shape[0]
        deadline = first.t_submit + cfg.max_wait_us * 1e-6
        while total < cfg.max_batch:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                wait = deadline - time.perf_counter()
                if wait <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=wait)
                except queue.Empty:
                    break
            if nxt is None:             # stop sentinel: put it back
                self._q.put(None)
                break
            if total + nxt.points.shape[0] > cfg.max_batch:
                self._held = nxt
                break
            reqs.append(nxt)
            total += nxt.points.shape[0]
        return reqs

    def _stage(self, reqs: list, bucket: int):
        """The pad buffer of ``bucket`` rows holding every request's
        rows, and each request's row offset. Host blocks are gathered
        first (into the pinned buffer on a card, then one asynchronous
        copy), tensors on the device after them (device copies)."""
        d = reqs[0].points.shape[1]
        dev = self._device
        bufs = self._buffers.get((bucket, d))
        if bufs is None:
            dbuf = torch.zeros((bucket, d), dtype=torch.float32, device=dev)
            hbuf = torch.zeros((bucket, d), dtype=torch.float32,
                               pin_memory=True) if dev.type == "cuda" \
                else dbuf
            bufs = self._buffers[(bucket, d)] = (dbuf, hbuf)
        dbuf, hbuf = bufs
        offsets = [0] * len(reqs)
        off = 0
        for i, r in enumerate(reqs):
            if isinstance(r.points, np.ndarray):
                m = r.points.shape[0]
                hbuf[off:off + m].copy_(torch.from_numpy(r.points))
                offsets[i] = off
                off += m
        if off and hbuf is not dbuf:
            dbuf[:off].copy_(hbuf[:off], non_blocking=True)
        for i, r in enumerate(reqs):
            if isinstance(r.points, torch.Tensor):
                m = r.points.shape[0]
                dbuf[off:off + m].copy_(r.points)
                offsets[i] = off
                off += m
        return dbuf, offsets

    def _serve_batch(self, reqs: list) -> None:
        total = sum(r.points.shape[0] for r in reqs)
        bucket = self._bucket(total)
        if len(reqs) == 1 and reqs[0].points.shape[0] == bucket and \
                isinstance(reqs[0].points, torch.Tensor):
            batch = reqs[0].points      # exact-fit device block: no copy
            offsets = [0]
        else:
            batch, offsets = self._stage(reqs, bucket)
        snap = self._index.acquire()
        fn = self._resolve_assign(snap)
        labels = fn(batch, snap.centroids, snap.c2, snap.groups,
                    snap.members, snap.gsize)[:total].cpu().numpy()
        now = time.perf_counter()
        # the counts include a batch before its futures resolve, so a
        # client that holds its labels sees them counted
        self.batches += 1
        self.points += total
        swapped = self._last_epoch is not None \
            and snap.epoch != self._last_epoch
        if swapped:
            self.epoch_swaps += 1
        self._last_epoch = snap.epoch
        if self._metrics is not None:
            mt = self._metrics
            mt["depth"].set(float(self._q.qsize()))
            mt["fill"].observe(total / bucket)
            mt["batches"].inc()
            mt["points"].inc(float(total))
            if swapped:
                mt["swaps"].inc()
            for r in reqs:
                mt["latency"].observe(now - r.t_submit)
        for r, off in zip(reqs, offsets):
            m = r.points.shape[0]
            r.future.set_result(ServeResult(labels[off:off + m],
                                            snap.epoch))

    def _serve_safely(self, reqs: list) -> None:
        """One batch, fault-isolated: any error (backend failure, bad
        input that slipped past submit validation) fails THIS batch's
        futures and leaves the serve thread alive for the next batch —
        an unhandled raise here would kill the daemon thread silently
        and hang every pending and future request forever."""
        try:
            with _on_device(self._device):
                self._serve_batch(reqs)
        except BaseException as e:
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)

    def _loop(self) -> None:
        while True:
            if self._held is not None:
                first, self._held = self._held, None
            else:
                try:
                    first = self._q.get(timeout=0.05)
                except queue.Empty:
                    if not self._running:
                        return
                    continue
            if first is None:
                if self._running:       # spurious wake
                    continue
                # drain what's left, then exit
                rest = []
                while True:
                    try:
                        r = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if r is not None:
                        rest.append(r)
                for r in rest:
                    if self._index.ready:
                        self._serve_safely([r])
                    else:
                        r.future.set_exception(RuntimeError(
                            "ServeEngine stopped before any centroids "
                            "were published"))
                return
            if not self._index.ready:
                # nothing published yet: requeue and wait briefly
                self._q.put(first)
                time.sleep(0.005)
                continue
            self._serve_safely(self._drain(first))
