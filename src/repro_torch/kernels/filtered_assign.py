"""Block-skip nearest-centroid search over (tile_n x tile_k) blocks:
the CUDA kernel, its plain version and a launch counter.

Replaces the Pallas kernel ``repro/kernels/filtered_assign.py``
(``filtered_assign`` -> ``_filtered_assign_kernel``), reached through
the ``repro.kernels`` entry point (``ops.filtered_assign_auto``).
``csrc/filtered_assign.cu`` holds the kernel and the note on its
design, its tie rule and its bound.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import filtered_assign_ref

NAME = "filtered_assign"


def filtered_assign_plain(x, c, block_mask, *, tile_n: int = 256,
                          tile_k: int = 128, x2=None, c2=None):
    """Plain PyTorch version (``repro.kernels.ref.filtered_assign_ref``
    with the norms taken as given, as the kernel takes them). Returns
    ``(best (N,) f32, idx (N,) i32)``."""
    return filtered_assign_ref(x, c, block_mask, tile_n, tile_k, x2=x2,
                               c2=c2)


def _check(x, c, block_mask, tile_n, tile_k, x2, c2):
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"filtered_assign: x (N, D) and c (K, D) "
                         f"expected, got {tuple(x.shape)} and "
                         f"{tuple(c.shape)}")
    n = x.shape[0]
    k = c.shape[0]
    if not 1 <= tile_n <= 1024 or tile_k < 1:
        raise ValueError(f"filtered_assign: tile_n must be in [1, 1024] "
                         f"(one thread per point) and tile_k >= 1, got "
                         f"{tile_n} and {tile_k}")
    shape = (-(-n // tile_n), -(-k // tile_k))
    if block_mask.shape != shape or block_mask.dtype != torch.bool:
        raise ValueError(f"filtered_assign: block_mask must be bool "
                         f"{shape}, got {block_mask.dtype} "
                         f"{tuple(block_mask.shape)}")
    if x2.shape != (n,) or c2.shape != (k,):
        raise ValueError("filtered_assign: x2 must be (N,), c2 (K,)")
    floats = (x, c, x2, c2)
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("filtered_assign: float32 x, c, x2 and c2 expected")
    tensors = floats + (block_mask,)
    if any(t.device != x.device for t in tensors):
        raise ValueError("filtered_assign: all inputs must share a device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("filtered_assign: inputs must be contiguous")


def filtered_assign(x, c, block_mask, *, tile_n: int = 256,
                    tile_k: int = 128, x2=None, c2=None):
    """Block-skipping nearest-centroid search.

    x: (N, D) f32; c: (K, D) f32; block_mask: (ceil(N/tile_n),
    ceil(K/tile_k)) bool, True where the block must be computed;
    ``x2`` (N,) / ``c2`` (K,): precomputed squared norms, used as given
    (``None`` computes them). Returns ``(min_sq_dist (N,) f32,
    argmin (N,) int32)``; rows with no live block give (+inf, -1).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    :func:`filtered_assign_plain`."""
    if not x.is_cuda:
        return filtered_assign_plain(x, c, block_mask, tile_n=tile_n,
                                     tile_k=tile_k, x2=x2, c2=c2)
    if x2 is None:
        x2 = torch.sum(x * x, dim=-1)
    if c2 is None:
        c2 = torch.sum(c * c, dim=-1)
    _check(x, c, block_mask, tile_n, tile_k, x2, c2)
    n, d = x.shape
    k = c.shape[0]
    best = torch.empty((n,), dtype=torch.float32, device=x.device)
    idx = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n == 0:
        return best, idx
    fn = _build.entry(NAME, "filtered_assign_launch",
                      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 +
                      [ctypes.c_void_p])
    with _build.on_device(x.device):
        rc = fn(x.data_ptr(), x2.data_ptr(), c.data_ptr(), c2.data_ptr(),
                block_mask.data_ptr(), best.data_ptr(), idx.data_ptr(), n,
                k, d, tile_n, tile_k, _build.stream_ptr(x.device))
    _build.check(NAME, rc)
    filtered_assign.launches += 1
    return best, idx


filtered_assign.launches = 0
