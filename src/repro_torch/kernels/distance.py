"""Tiled pairwise squared distances: the CUDA kernel, its plain version
and a launch counter.

Replaces the Pallas kernel ``repro/kernels/distance.py``
(``pairwise_sq_dists`` -> ``_dist_kernel``). In the JAX package only the
``repro.kernels`` entry point reaches it; the engine's own distances
stay on ``core/distances`` (``torch.matmul``), as the reference leaves
them to XLA. ``csrc/pairwise_sq_dists.cu`` holds the kernel and the
note on its design and its bound. The port's first kernel stays in the
same source, as the yardstick (:func:`pairwise_sq_dists_simple`) and
for the inputs the kernel does not take, which the launch sends to it
itself: a D too wide for a slice of 128 centroids (:func:`slice_cols`
0: D > 148, or D > 111 in fp32 where D % 4 != 0) and an x not on 16
bytes.
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


def _launch(symbol, x, c, tile_n, tile_k):
    _check(x, c, tile_n, tile_k)
    n, d = x.shape
    k = c.shape[0]
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    if n == 0 or k == 0:
        return out
    fn = _build.entry(NAME, symbol, [ctypes.c_void_p] * 3 +
                      [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with _build.on_device(x.device):
        rc = fn(x.data_ptr(), c.data_ptr(), out.data_ptr(), n, k, d,
                DTYPES[x.dtype], _build.stream_ptr(x.device))
    _build.check(NAME, rc)
    return out


def slice_cols(k: int, d: int, dtype) -> int:
    """Centroids a block of the kernel keeps in shared memory at (K, D,
    dtype), a multiple of 128, or 0 where the launch takes the first
    kernel (the .cu's ``pairwise_sq_dists_slice_cols``, which the launch
    itself uses; an x not on 16 bytes takes the first kernel too)."""
    return _build.entry(NAME, "pairwise_sq_dists_slice_cols",
                        [ctypes.c_int] * 3)(k, d, DTYPES[dtype])


def pairwise_sq_dists(x, c, *, tile_n: int = 256, tile_k: int = 128):
    """(N, D) x (K, D) -> (N, K) fp32 squared distances
    ``max(||x||^2 - 2 x.c + ||c||^2, 0)``, both norms computed inside.

    ``x`` and ``c`` are both float32 or both bfloat16. ``tile_n`` and
    ``tile_k`` are the reference's tiles; they do not change the result,
    and the kernel picks its own (128-row tiles against a slice of
    :func:`slice_cols` centroids; the first kernel's 128 x 128 output
    tiles for a wide D or an x not on 16 bytes, the same bits). A CUDA
    tensor launches the kernel (or raises); a CPU tensor takes
    :func:`pairwise_sq_dists_plain`."""
    if not x.is_cuda:
        return pairwise_sq_dists_plain(x, c, tile_n=tile_n, tile_k=tile_k)
    out = _launch("pairwise_sq_dists_launch", x, c, tile_n, tile_k)
    pairwise_sq_dists.launches += 1
    return out


def pairwise_sq_dists_simple(x, c, *, tile_n: int = 256,
                             tile_k: int = 128):
    """The port's first ``pairwise_sq_dists`` kernel (a CTA a 128 x 128
    output tile, staged, computed and stored in turn), kept as the
    yardstick the kernel is held to bit for bit and timed against. CUDA
    tensors only; it counts no launch, and no path of the port calls it
    (the entry point's own launch reaches the same kernel for the inputs
    of the module's note, and counts that launch)."""
    if not x.is_cuda:
        raise ValueError("pairwise_sq_dists_simple: CUDA tensors expected")
    return _launch("pairwise_sq_dists_simple_launch", x, c, tile_n, tile_k)


pairwise_sq_dists.launches = 0
