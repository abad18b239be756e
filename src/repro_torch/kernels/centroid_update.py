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
order instead; see the note there for its design and its bound, and
:func:`plan` for how it cuts the rows, a function of the shapes alone.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..obs.trace import phase
from . import _build

NAME = "centroid_update"
SMEM_LIMIT = 232_448             # bytes of shared memory a block can use
SM_SMEM = 233_472                # bytes of shared memory an SM gives blocks
BLOCK_RESERVED = 1_024           # bytes the card keeps back for each block
# csrc/centroid_update.cu's kStages and kGroup: ring stages a warp keeps,
# and rows added together from registers (a stage holds 1 to MAX_GROUPS
# groups). The launch refuses a plan whose warp_floats falls short of the
# layout the .cu reads
STAGES, GROUP = 4, 8
MAX_GROUPS = 8
MAX_WARPS = 8
# pass-1 blocks to aim for: two on each SM of a 132-SM H100. A constant,
# so the order of the sums (and with it every bit of the result) depends
# on the shapes alone, on any card
TARGET_BLOCKS = 264


@dataclasses.dataclass(frozen=True)
class Plan:
    """How ``csrc/centroid_update.cu`` cuts (N, D, K): pass 1 runs
    ``chunks`` x ``d_tiles`` blocks of ``warps`` warps; a warp adds
    ``rows_per_warp`` rows of its block's ``rows_per_chunk`` into its
    own K x ``tile`` accumulator, through a ring of ``STAGES`` stages of
    ``stage_rows`` rows; ``smem`` bytes a block."""
    warps: int
    tile: int
    stage_rows: int
    d_tiles: int
    chunks: int
    rows_per_chunk: int
    rows_per_warp: int
    warp_floats: int
    smem: int


def _warp_bytes(k: int, tile: int, stage_rows: int) -> int:
    """One warp's shared memory, rounded up to 16 bytes: the x ring, the
    K x tile accumulator, K counts, the ring's labels and weights (the
    layout the .cu's ``cu_partial`` notes)."""
    ring = STAGES * stage_rows
    return 16 * -(-(ring * tile + k * tile + k + 2 * ring) // 4)


def plan(n: int, d: int, k: int) -> Plan:
    """The launch plan for (N, D, K), a function of the shapes alone.

    Each warp has an accumulator of its own. Columns tile 32 wide,
    halved until one warp fits in a block. Warps: as many as leave each
    a ring of 4 groups with two blocks an SM (at most ``MAX_WARPS``),
    else one; then the ring grows to as many groups as still fit. Raises
    ``ValueError`` where even a tile of one column does not fit."""
    tile = 32
    while _warp_bytes(k, tile, GROUP) > SMEM_LIMIT:
        if tile == 1:
            raise ValueError(f"centroid_update: k={k} needs "
                             f"{_warp_bytes(k, 1, GROUP)} bytes of shared "
                             f"memory, more than {SMEM_LIMIT}")
        tile //= 2
    half = SM_SMEM // 2 - BLOCK_RESERVED
    warps = max(1, min(MAX_WARPS, half // _warp_bytes(k, tile, 4 * GROUP)))
    budget = half if warps * _warp_bytes(k, tile, GROUP) <= half \
        else SMEM_LIMIT
    groups = max(g for g in range(1, MAX_GROUPS + 1)
                 if g == 1 or warps * _warp_bytes(k, tile, g * GROUP)
                 <= budget)
    stage_rows = groups * GROUP
    per_warp = _warp_bytes(k, tile, stage_rows)
    d_tiles = -(-d // tile)
    chunks = max(1, min(-(-TARGET_BLOCKS // d_tiles),
                        -(-n // (warps * GROUP))))
    rows_per_chunk = max(1, -(-n // chunks))
    return Plan(warps=warps, tile=tile, stage_rows=stage_rows,
                d_tiles=d_tiles, chunks=chunks,
                rows_per_chunk=rows_per_chunk,
                rows_per_warp=-(-rows_per_chunk // warps),
                warp_floats=per_warp // 4, smem=warps * per_warp)


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
    if k < 1 or points.shape[1] < 1:
        raise ValueError(f"centroid_update: k and D must be >= 1, got "
                         f"k={k}, D={points.shape[1]}")


def centroid_update(points, labels, k: int, weights=None):
    """``(sums (K, D), counts (K,))`` of float32 ``points`` (N, D) by
    int32 ``labels`` (N,), optionally weighted by float32 ``weights``.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    :func:`centroid_update_plain`. Entry to return is one
    ``kpynq/centroid_update`` span."""
    with phase("kpynq/centroid_update", points.is_cuda):
        if not points.is_cuda:
            return centroid_update_plain(points, labels, k, weights)
        return _launch(points, labels, k, weights)


def _launch(points, labels, k, weights):
    """Launch ``csrc/centroid_update.cu``'s kernel on the card."""
    _check(points, labels, k, weights)
    n, d = points.shape
    p = plan(n, d, k)
    chunks = p.chunks if n else 0
    dev = points.device
    part = torch.empty((max(chunks, 1), k * d + k), dtype=torch.float32,
                       device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    fn = _build.entry(NAME, "centroid_update_launch",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 +
                      [ctypes.c_void_p])
    with _build.on_device(dev):
        rc = fn(points.data_ptr(), labels.data_ptr(),
                None if weights is None else weights.data_ptr(),
                part.data_ptr(), sums.data_ptr(), counts.data_ptr(), n, d,
                k, p.warps, p.tile, p.stage_rows, chunks, p.rows_per_chunk,
                p.rows_per_warp, p.warp_floats, p.smem,
                _build.stream_ptr(dev))
    _build.check(NAME, rc)
    _build.count_launch(centroid_update)
    return sums, counts


centroid_update.launches = 0
