"""Carry fitted state across from the JAX package.

A JAX ``KMeansResult`` whose fields went through ``np.asarray`` holds
plain numpy arrays; :func:`kmeans_state_from_numpy` turns it into the
port's :class:`~repro_torch.core.kmeans.KMeansResult` on a device, and
``KMeans.from_state`` wraps that into a fitted estimator.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.kmeans import KMeansResult
from .device import resolve_device


def kmeans_state_from_numpy(result, device=None) -> KMeansResult:
    """``result``: any object with numpy-convertible ``centroids``,
    ``assignments``, ``n_iters``, ``distance_evals`` and ``inertia``."""
    dev = resolve_device(device)
    evals = np.rint(np.asarray(result.distance_evals, np.float64))
    return KMeansResult(
        torch.tensor(np.asarray(result.centroids, np.float32), device=dev),
        torch.tensor(np.asarray(result.assignments, np.int32), device=dev),
        int(np.asarray(result.n_iters)),
        torch.tensor(int(evals), dtype=torch.int64, device=dev),
        torch.tensor(float(np.asarray(result.inertia, np.float32)),
                     dtype=torch.float32, device=dev))
