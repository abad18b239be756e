"""Centroid initialisation (port of ``repro.core.init``) on a
``torch.Generator``. These match the JAX draws only in distribution:
``jax.random`` and torch give other numbers from one seed, so parity
tests feed JAX's starting centroids into the port."""
from __future__ import annotations

import torch

from .distances import pairwise_sq_dists


def random_init(generator: torch.Generator, points: torch.Tensor,
                k: int) -> torch.Tensor:
    idx = torch.randperm(points.shape[0], generator=generator,
                         device=points.device)[:k]
    return points[idx].float()


def kmeans_plusplus(generator: torch.Generator, points: torch.Tensor,
                    k: int, weights: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """k-means++ seeding (Arthur & Vassilvitskii). ``weights``: optional
    (N,) nonnegative weights; the first centroid is drawn proportional
    to w and each later one proportional to w * D^2. ``None`` draws the
    first uniformly. Stays on the device: no host sync per draw."""
    n = points.shape[0]
    pts = points.float()
    dev = pts.device
    if weights is None:
        first_idx = torch.randint(0, n, (1,), generator=generator,
                                  device=dev)
        w = wp = None
    else:
        w = torch.clamp_min(weights.float(), 0.0)
        wp = torch.where(w.sum() > 0, w, torch.ones_like(w))
        first_idx = torch.multinomial(wp, 1, generator=generator)
    centroids = torch.zeros((k, pts.shape[1]), dtype=torch.float32,
                            device=dev)
    first = pts[first_idx]                                 # (1, D)
    centroids[0] = first[0]
    min_d2 = pairwise_sq_dists(pts, first)[:, 0]
    for i in range(1, k):
        # sample proportional to (w *) D^2; guard the all-zero corner
        scores = min_d2 if w is None else w * min_d2
        fallback = torch.ones_like(scores) if w is None else wp
        probs = torch.where(scores.sum() > 0, scores, fallback)
        idx = torch.multinomial(probs, 1, generator=generator)
        c = pts[idx]                                       # (1, D)
        centroids[i] = c[0]
        min_d2 = torch.minimum(min_d2, pairwise_sq_dists(pts, c)[:, 0])
    return centroids
