"""Synthetic data: the port's own copy of ``repro.data.make_points``.

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
