"""Synthetic data: the port's own copies of ``repro.data.make_points``
and ``repro.data.PointStream``.

Numpy-seeded, so both packages draw the same points from one seed.
"""
from __future__ import annotations

import numpy as np


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
