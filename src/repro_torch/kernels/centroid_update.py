"""Per-cluster sums and counts: the CUDA kernel, its plain version and
a launch counter.

Replaces the Pallas kernel ``repro/kernels/centroid_update.py``
(``centroid_update``, a one-hot matmul). In the JAX engine the same
function is ``jax.ops.segment_sum`` (``repro.core.kmeans.centroid_sums``);
in the port this kernel computes it on every ``move_and_bounds`` and in
``group_centroids``. It replaces ``index_add_`` on the card because
``index_add_`` on CUDA adds with atomics in no fixed order, which breaks
the bit-identities the reference asserts (a fit run twice; weights of
1.0 against no weights). ``csrc/centroid_update.cu`` reduces in a fixed
order instead; see the note there for its design and its bound.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "centroid_update"
# rows per CTA of the first pass: fixed, so the order of the sums (and
# with it every bit of the result) depends on the shapes only
ROWS_PER_CHUNK = 2048
SMEM_LIMIT = 232_448             # bytes of shared memory a block can use


def centroid_update_plain(points, labels, k: int, weights=None):
    """Plain PyTorch version: ``(sums (K, D) f32, counts (K,) f32)``.
    Labels outside [0, K) contribute nothing; rows are added in row
    order on the CPU (``index_add_``)."""
    pts = points.float()
    keep = (labels >= 0) & (labels < k)
    idx = torch.where(keep, labels, 0).long()
    if weights is None:
        src = torch.where(keep[:, None], pts, 0.0)
        mass = keep.float()
    else:
        w = torch.where(keep, weights.float(), 0.0)
        src = w[:, None] * pts
        mass = w
    sums = torch.zeros((k, pts.shape[1]), dtype=torch.float32,
                       device=pts.device).index_add_(0, idx, src)
    counts = torch.zeros((k,), dtype=torch.float32,
                         device=pts.device).index_add_(0, idx, mass)
    return sums, counts


def _check(points, labels, k, weights):
    if points.dim() != 2 or labels.shape != (points.shape[0],):
        raise ValueError(f"centroid_update: points (N, D) and labels (N,) "
                         f"expected, got {tuple(points.shape)} and "
                         f"{tuple(labels.shape)}")
    if points.dtype != torch.float32 or labels.dtype != torch.int32:
        raise TypeError(f"centroid_update: float32 points and int32 "
                        f"labels expected, got {points.dtype} and "
                        f"{labels.dtype}")
    tensors = [points, labels]
    if weights is not None:
        if weights.shape != labels.shape or weights.dtype != torch.float32:
            raise ValueError("centroid_update: weights must be (N,) float32")
        tensors.append(weights)
    if any(t.device != points.device for t in tensors):
        raise ValueError("centroid_update: all inputs must share a device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("centroid_update: inputs must be contiguous")
    if k < 1:
        raise ValueError(f"centroid_update: k must be >= 1, got {k}")
    smem = (k * 32 + k) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"centroid_update: k={k} needs {smem} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")


def centroid_update(points, labels, k: int, weights=None):
    """``(sums (K, D), counts (K,))`` of float32 ``points`` (N, D) by
    int32 ``labels`` (N,), optionally weighted by float32 ``weights``.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    :func:`centroid_update_plain`."""
    if not points.is_cuda:
        return centroid_update_plain(points, labels, k, weights)
    _check(points, labels, k, weights)
    n, d = points.shape
    chunks = -(-n // ROWS_PER_CHUNK)
    dev = points.device
    part_sums = torch.empty((max(chunks, 1), k, d), dtype=torch.float32,
                            device=dev)
    part_counts = torch.empty((max(chunks, 1), k), dtype=torch.float32,
                              device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    lib = _build.load(NAME)
    fn = lib.centroid_update_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(points.data_ptr(), labels.data_ptr(),
                None if weights is None else weights.data_ptr(),
                part_sums.data_ptr(), part_counts.data_ptr(),
                sums.data_ptr(), counts.data_ptr(), n, d, k,
                ROWS_PER_CHUNK, _build.stream_ptr(dev))
    _build.check(lib, NAME, rc)
    centroid_update.launches += 1
    return sums, counts


centroid_update.launches = 0
