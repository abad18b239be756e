"""Data pipelines (port of ``repro.data.pipeline``): synthetic or
corpus-backed token batches, point clouds and point streams for the
K-means workloads, and a prefetch thread that moves batches to the
device.

Numpy-seeded, so both packages draw the same tokens and points from one
seed. Batches are made from ``(seed, step)`` alone, so any step's batch
can be made again: restart from a checkpoint needs no loader state.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from .device import resolve_device


class TokenPipeline:
    """Deterministic LM batches: ``global_batch(step)`` draws
    ``batch`` rows of ``seq + 1`` tokens from ``rng((seed, step))``,
    uniform over the vocab or, with ``corpus``, windows of it at random
    starts; ``tokens`` are the first ``seq``, ``labels`` the last
    (numpy int32), as the reference draws them. A vlm config also gets
    ``vision_embeds`` (batch, n_vision_tokens, d_model) standard normal
    in float32: numpy has no bfloat16, and the model rounds them to its
    compute dtype, as the reference's cast does."""

    def __init__(self, cfg, batch: int, seq: int, seed: int = 0,
                 corpus: np.ndarray | None = None):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.corpus = corpus

    def global_batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        if self.corpus is not None:
            starts = rng.integers(0, len(self.corpus) - self.seq - 1,
                                  size=self.batch)
            toks = np.stack([self.corpus[s:s + self.seq + 1]
                             for s in starts])
        else:
            toks = rng.integers(0, self.cfg.vocab,
                                size=(self.batch, self.seq + 1),
                                dtype=np.int32)
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        if self.cfg.n_vision_tokens:
            out["vision_embeds"] = rng.standard_normal(
                (self.batch, self.cfg.n_vision_tokens, self.cfg.d_model),
                dtype=np.float32)
        return out


def to_device(batch: dict, device) -> dict:
    """A batch's arrays as tensors on ``device`` (other values as they
    are). The copy is synchronous: a tensor is never read before it
    has landed."""
    return {k: torch.as_tensor(v).to(device) if isinstance(v, np.ndarray)
            else v for k, v in batch.items()}


class PrefetchingLoader:
    """A thread that keeps ``depth`` batches of ``pipeline`` (anything
    with ``global_batch(step)``) ahead of the consumer, already on
    ``device`` (``None``: ``cuda``). ``next(loader)`` gives
    ``(step, batch)`` in step order from ``start_step``; ``close()``
    stops the thread and drains the queue.

    Each batch is copied by :func:`to_device` on the thread, from
    pageable memory, which returns only when the copy has ended, so the
    consumer's stream never reads a batch still in flight (an
    asynchronous copy on the thread's own stream would race with it).
    """

    def __init__(self, pipeline, device=None, start_step: int = 0,
                 depth: int = 2):
        self.pipeline = pipeline
        self.device = resolve_device(device)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = to_device(self.pipeline.global_batch(step), self.device)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=10)


def make_points(n: int, d: int, k: int, seed: int = 0,
                cluster_std: float = 1.0, spread: float = 8.0):
    """Gaussian-blob point cloud with ground-truth structure. Returns
    numpy ``(points (n, d) f32, centers (k, d) f32, assign (n,))``."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * spread
    assign = rng.integers(0, k, size=n)
    pts = centers[assign] + rng.standard_normal((n, d)).astype(np.float32) \
        * cluster_std
    return pts.astype(np.float32), centers, assign


class PointStream:
    """Sharded point stream for the streaming K-means fit.

    Synthetic shard ``s`` is generated from ``rng((seed, s + 1))`` (the
    centres from ``rng((seed, 0))``), so it is bit-identical on every
    epoch and every host: what lets
    :class:`repro_torch.streaming.StreamingKMeans` key its carried-bounds
    cache on the shard id. ``data=`` instead wraps an existing (N, D)
    array, an ``np.load(..., mmap_mode='r')`` memmap included, sliced
    into contiguous shards (the last may be short).

    ``global_batch(step)`` returns ``{"shard_id", "points"}`` for a
    global step (epochs wrap by ``step % n_shards``), the item shape
    ``StreamingKMeans.fit_stream`` also takes.
    """

    def __init__(self, shard_size: int = 1024, *, n_shards: int | None = None,
                 n_dims: int | None = None, k: int | None = None,
                 data: np.ndarray | None = None, seed: int = 0,
                 cluster_std: float = 1.0, spread: float = 8.0):
        if shard_size <= 0:
            raise ValueError("shard_size must be positive")
        self.shard_size = int(shard_size)
        self.seed = seed
        self.data = data
        if data is not None:
            if data.ndim != 2 or len(data) == 0:
                raise ValueError("data must be a non-empty (N, D) array")
            self.n_shards = -(-len(data) // self.shard_size)
            self.n_dims = data.shape[1]
        else:
            if not (n_shards and n_dims and k):
                raise ValueError(
                    "synthetic stream needs n_shards, n_dims and k")
            self.n_shards = int(n_shards)
            self.n_dims = int(n_dims)
            self.k = int(k)
            self.cluster_std = cluster_std
            rng = np.random.default_rng((seed, 0))
            self._centers = rng.standard_normal(
                (self.k, self.n_dims)).astype(np.float32) * spread

    @classmethod
    def from_npy(cls, path: str, shard_size: int = 1024) -> "PointStream":
        """File-backed stream over a .npy array without loading it."""
        return cls(shard_size, data=np.load(path, mmap_mode="r"))

    @property
    def n_points(self) -> int:
        if self.data is not None:
            return len(self.data)
        return self.n_shards * self.shard_size

    def __len__(self) -> int:
        return self.n_shards

    def shard(self, idx: int) -> np.ndarray:
        """Shard ``idx`` (wraps modulo n_shards) as (B, D) float32."""
        idx = int(idx) % self.n_shards
        if self.data is not None:
            lo = idx * self.shard_size
            return np.asarray(self.data[lo:lo + self.shard_size],
                              np.float32)
        rng = np.random.default_rng((self.seed, idx + 1))
        assign = rng.integers(0, self.k, size=self.shard_size)
        pts = self._centers[assign] + rng.standard_normal(
            (self.shard_size, self.n_dims)).astype(np.float32) \
            * self.cluster_std
        return pts.astype(np.float32)

    def batches(self, epochs: int = 1, start: int = 0):
        """Yield ``(shard_id, points)`` over ``epochs`` full passes,
        from global step ``start``."""
        total = max(int(epochs), 1) * self.n_shards
        for step in range(int(start), total):
            s = step % self.n_shards
            yield s, self.shard(s)

    def global_batch(self, step: int) -> dict:
        s = step % self.n_shards
        return {"shard_id": s, "points": self.shard(s)}
