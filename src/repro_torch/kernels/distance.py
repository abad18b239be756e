"""Tiled pairwise squared distances: the CUDA kernel, its plain version
and a launch counter.

Replaces the Pallas kernel ``repro/kernels/distance.py``
(``pairwise_sq_dists`` -> ``_dist_kernel``). In the JAX package only the
``repro.kernels`` entry point reaches it; the engine's own distances
stay on ``core/distances`` (``torch.matmul``), as the reference leaves
them to XLA. ``csrc/pairwise_sq_dists.cu`` holds the kernel and the
note on its design and its bound.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import pairwise_sq_dists_ref

NAME = "pairwise_sq_dists"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pairwise_sq_dists_plain(x, c, *, tile_n: int = 256, tile_k: int = 128):
    """Plain PyTorch version: ``max(x2 - 2 x.c + c2, 0)`` in fp32 from
    fp32 or bf16 inputs (``repro.kernels.ref.pairwise_sq_dists_ref``).
    The tiles do not change the result."""
    return pairwise_sq_dists_ref(x, c)


def _check(x, c, tile_n, tile_k):
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"pairwise_sq_dists: x (N, D) and c (K, D) "
                         f"expected, got {tuple(x.shape)} and "
                         f"{tuple(c.shape)}")
    if x.dtype not in DTYPES or c.dtype != x.dtype:
        raise TypeError(f"pairwise_sq_dists: x and c must both be float32 "
                        f"or both bfloat16, got {x.dtype} and {c.dtype}")
    if c.device != x.device:
        raise ValueError("pairwise_sq_dists: x and c must share a device")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("pairwise_sq_dists: inputs must be contiguous")
    if tile_n < 1 or tile_k < 1:
        raise ValueError("pairwise_sq_dists: tiles must be positive")


def pairwise_sq_dists(x, c, *, tile_n: int = 256, tile_k: int = 128):
    """(N, D) x (K, D) -> (N, K) fp32 squared distances
    ``max(||x||^2 - 2 x.c + ||c||^2, 0)``, both norms computed inside.

    ``x`` and ``c`` are both float32 or both bfloat16. ``tile_n`` and
    ``tile_k`` are the reference's tiles; they do not change the result
    and the kernel keeps its own 128 x 128 output tile. A CUDA tensor
    launches the kernel (or raises); a CPU tensor takes
    :func:`pairwise_sq_dists_plain`."""
    if not x.is_cuda:
        return pairwise_sq_dists_plain(x, c, tile_n=tile_n, tile_k=tile_k)
    _check(x, c, tile_n, tile_k)
    n, d = x.shape
    k = c.shape[0]
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    if n == 0 or k == 0:
        return out
    lib = _build.load(NAME)
    fn = lib.pairwise_sq_dists_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), c.data_ptr(), out.data_ptr(), n, k, d,
                DTYPES[x.dtype], _build.stream_ptr(x.device))
    _build.check(lib, NAME, rc)
    pairwise_sq_dists.launches += 1
    return out


pairwise_sq_dists.launches = 0
