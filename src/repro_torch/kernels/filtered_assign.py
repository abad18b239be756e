"""Block-skip nearest-centroid search over (tile_n x tile_k) blocks:
the CUDA kernel, its plain version and a launch counter.

Replaces the Pallas kernel ``repro/kernels/filtered_assign.py``
(``filtered_assign`` -> ``_filtered_assign_kernel``), reached through
the ``repro.kernels`` entry point (``ops.filtered_assign_auto``).
``csrc/filtered_assign.cu`` holds the kernel and the note on its
design, its tie rule and its bound. The launch picks its variant from
the shape itself (:func:`variant` asks the library which) and refuses
a shape it cannot take (``cudaErrorInvalidValue``, raised here as
``RuntimeError``), so this module keeps no copy of the kernel's layout;
nor of the first kernel's (:func:`simple_takes`).
The port's first kernel stays in the same source as a yardstick,
reached only through :func:`filtered_assign_simple`.
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


def variant(d: int, k: int, tile_n: int,
            tile_k: int) -> tuple[int, int, int]:
    """``(points a block owns, centroid chunks in flight, columns of D
    walked at a time)`` of the kernel at (D, K, tile_n, tile_k): (256 or
    64, 3 or 2, 0 or 32). A slice of 0 is whole rows (``fa_kernel``); 32
    is a D too wide for two ring stages of whole rows (``fa_wide_kernel``,
    the same products and tie rule, so the same bits). ``(0, 0, 0)`` is a
    shape the launch refuses (a mask row of more blocks than shared memory
    holds; every D is taken). The .cu's ``filtered_assign_variant``, which
    the launch itself uses: a function of the shape alone, decided before
    anything is launched."""
    out = [ctypes.c_int(0) for _ in range(3)]
    _build.entry(NAME, "filtered_assign_variant",
                 [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3)(
        d, k, tile_n, tile_k, *(ctypes.byref(v) for v in out))
    return tuple(v.value for v in out)


def simple_takes(d: int, tile_n: int, tile_k: int) -> bool:
    """Whether the first kernel (:func:`filtered_assign_simple`) takes
    (D, tile_n, tile_k): its shared memory fits in one block's. The .cu's
    ``filtered_assign_simple_takes``, which its launch checks itself."""
    return bool(_build.entry(NAME, "filtered_assign_simple_takes",
                             [ctypes.c_int] * 3)(d, tile_n, tile_k))


def _check(x, c, block_mask, tile_n, tile_k, x2, c2):
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"filtered_assign: x (N, D) and c (K, D) "
                         f"expected, got {tuple(x.shape)} and "
                         f"{tuple(c.shape)}")
    n = x.shape[0]
    k = c.shape[0]
    if tile_n < 1 or tile_k < 1:
        raise ValueError(f"filtered_assign: tile_n and tile_k must be "
                         f">= 1, got {tile_n} and {tile_k}")
    shape = (-(-n // tile_n), -(-k // tile_k))
    if block_mask.shape != shape or block_mask.dtype != torch.bool:
        raise ValueError(f"filtered_assign: block_mask must be bool "
                         f"{shape}, got {block_mask.dtype} "
                         f"{tuple(block_mask.shape)}")
    if (x2 is not None and x2.shape != (n,)) or c2.shape != (k,):
        raise ValueError("filtered_assign: x2 must be (N,), c2 (K,)")
    floats = (x, c, c2) if x2 is None else (x, c, x2, c2)
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("filtered_assign: float32 x, c, x2 and c2 expected")
    tensors = floats + (block_mask,)
    if any(t.device != x.device for t in tensors):
        raise ValueError("filtered_assign: all inputs must share a device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("filtered_assign: inputs must be contiguous")


def _norms(x):
    """The squared norm of each row of x (N, D) f32 on the card, one fmaf
    chain a row (the .cu's norm kernel, the chain the kernel forms from
    its tile), for the first kernel where no norms are given; torch's for
    an empty x, or for an x that ``_check`` then refuses."""
    if x.dim() != 2 or x.shape[0] == 0 or x.dtype != torch.float32 or \
            not x.is_contiguous():
        return torch.sum(x * x, dim=-1)
    n, d = x.shape
    x2 = torch.empty((n,), dtype=torch.float32, device=x.device)
    fn = _build.entry(NAME, "filtered_assign_norms_launch",
                      [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 +
                      [ctypes.c_void_p])
    with _build.on_device(x.device):
        rc = fn(x.data_ptr(), x2.data_ptr(), n, d,
                _build.stream_ptr(x.device))
    _build.check(NAME, rc)
    return x2


def _launch(simple, x, c, block_mask, tile_n, tile_k, x2, c2):
    """Launch ``csrc/filtered_assign.cu``'s kernel, or with ``simple`` its
    first kernel. Norms not given are computed: the centroids' by torch;
    the points' by the kernel from its tile, or for the first kernel by
    :func:`_norms`, the same fmaf chain, so both give the same bits."""
    if x2 is None and simple:
        x2 = _norms(x)
    if c2 is None:
        c2 = torch.sum(c * c, dim=-1)
    _check(x, c, block_mask, tile_n, tile_k, x2, c2)
    n, d = x.shape
    k = c.shape[0]
    best = torch.empty((n,), dtype=torch.float32, device=x.device)
    idx = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n == 0:
        return best, idx
    ptrs = [0 if t is None else t.data_ptr()
            for t in (x, x2, c, c2, block_mask, best, idx)]
    symbol = ("filtered_assign_simple_launch" if simple
              else "filtered_assign_launch")
    fn = _build.entry(NAME, symbol, [ctypes.c_void_p] * 7 +
                      [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with _build.on_device(x.device):
        rc = fn(*ptrs, n, k, d, tile_n, tile_k, _build.stream_ptr(x.device))
    _build.check(NAME, rc)
    return best, idx


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
    out = _launch(False, x, c, block_mask, tile_n, tile_k, x2, c2)
    _build.count_launch(filtered_assign)
    return out


def filtered_assign_simple(x, c, block_mask, *, tile_n: int = 256,
                           tile_k: int = 128, x2=None, c2=None):
    """The port's first ``filtered_assign`` kernel (one thread per
    point, tile_n up to 1024, a block's centroids 32 at a time), kept as
    the yardstick the kernel is held to bit for bit and timed against.
    CUDA tensors only; no path of the port calls it, and it counts no
    launch."""
    if not x.is_cuda:
        raise ValueError("filtered_assign_simple: CUDA tensors expected")
    return _launch(True, x, c, block_mask, tile_n, tile_k, x2, c2)


filtered_assign.launches = 0
