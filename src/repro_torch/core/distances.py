"""Distance primitives shared by the K-means family (port of
``repro.core.distances``).

The dense product stays ``torch.matmul``, as the JAX side left it to
XLA. It must run in full fp32: on CUDA, ``pairwise_sq_dists`` refuses
to run while TF32 matmuls are enabled, because TF32 changes labels
(``repro_torch.device.resolve_device`` turns it off). Optional
precomputed squared norms (``x2`` rows, ``c2`` centroids) are threaded
through exactly as in the reference.
"""
from __future__ import annotations

import torch


def _check_fp32_matmul(x: torch.Tensor) -> None:
    if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "repro_torch needs full-fp32 matmuls on CUDA: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")


def row_norms_sq(x: torch.Tensor) -> torch.Tensor:
    """``||x_i||^2`` per row, (N, D) -> (N,) fp32."""
    x = x.float()
    return torch.sum(x * x, dim=-1)


def pairwise_sq_dists(x, c, x2=None, c2=None) -> torch.Tensor:
    """Squared Euclidean distances (N, D) x (K, D) -> (N, K), expanded
    as ``max(||x||^2 - 2 x.c + ||c||^2, 0)``."""
    x = x.float()
    c = c.float()
    _check_fp32_matmul(x)
    if x2 is None:
        x2 = row_norms_sq(x)
    if c2 is None:
        c2 = row_norms_sq(c)
    d2 = x2[:, None] - 2.0 * (x @ c.T) + c2[None, :]
    return torch.clamp_min(d2, 0.0)


def pairwise_dists(x, c, x2=None, c2=None) -> torch.Tensor:
    return torch.sqrt(pairwise_sq_dists(x, c, x2, c2))


def rowwise_dists(x, c) -> torch.Tensor:
    """d(x_i, c_i) for paired rows, (N, D) x (N, D) -> (N,)."""
    diff = x.float() - c.float()
    return torch.sqrt(torch.clamp_min(torch.sum(diff * diff, dim=-1), 0.0))
