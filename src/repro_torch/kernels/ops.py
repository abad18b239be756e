"""Glue between the filter decisions and the kernels (port of
``repro.kernels.ops``).

``build_block_mask`` turns the per-(point, group) filter decisions into
the block-granular skip mask of ``filtered_assign``: the point where
KPynq's per-point pipeline bypass becomes a block bypass.
``build_group_block_mask`` does the same for ``grouped_assign``, whose
blocks are whole groups. ``compact_indices`` is the stream compaction
of the engine's compact backend (gather the survivors into a dense
buffer).
"""
from __future__ import annotations

import torch


def build_block_mask(group_need: torch.Tensor, groups: torch.Tensor, *,
                     tile_n: int, tile_k: int) -> torch.Tensor:
    """(N, G) per-point-per-group need + (K,) group ids ->
    (ceil(N/tile_n), ceil(K/tile_k)) bool block mask: block (i, j) is
    live iff a point of tile i needs a group that owns a centroid of
    block j."""
    n = group_need.shape[0]
    k = groups.shape[0]
    cand = group_need.bool()[:, groups.long()]                  # (N, K)
    cand = torch.nn.functional.pad(cand, (0, (-k) % tile_k,
                                          0, (-n) % tile_n))
    gn, gk = cand.shape[0] // tile_n, cand.shape[1] // tile_k
    blocks = cand.reshape(gn, tile_n, gk, tile_k)
    return blocks.any(dim=3).any(dim=1)


def build_group_block_mask(group_need: torch.Tensor, *,
                           tile_n: int) -> torch.Tensor:
    """(N, G) per-point-per-group need -> (ceil(N/tile_n), G) bool mask
    for ``grouped_assign``: block (i, g) is live iff any point in tile
    i needs group g."""
    n, g = group_need.shape
    n_pad = (-n) % tile_n
    padded = torch.nn.functional.pad(group_need, (0, 0, 0, n_pad))
    return torch.any(padded.reshape(-1, tile_n, g), dim=1)


def compact_indices(mask: torch.Tensor, *, capacity: int):
    """Stream compaction: the indices of the True entries of the (N,)
    ``mask``, in order, padded to ``capacity``.

    Returns ``(idx (capacity,) int32`` (invalid slots point at 0),
    ``valid (capacity,) bool, count`` (int32 scalar, which may exceed
    ``capacity``; the entries past it are dropped)``)``. Reads nothing
    back to the host."""
    n = mask.shape[0]
    mask = mask.bool()
    pos = torch.cumsum(mask.int(), dim=0) - 1
    count = mask.sum(dtype=torch.int32)
    # misses and hits past the capacity land in one spare slot
    slot = torch.where(mask & (pos < capacity), pos, capacity)
    src = torch.arange(n, dtype=torch.int32, device=mask.device)
    idx = torch.zeros((capacity + 1,), dtype=torch.int32,
                      device=mask.device)
    idx = idx.scatter_(0, slot.long(), src)[:capacity]
    valid = torch.arange(capacity, device=mask.device) < \
        torch.clamp_max(count, capacity)
    return idx, valid, count


def filtered_assign_auto(x, c, group_need, groups, *, tile_n: int = 256,
                         tile_k: int = 128):
    """One call: filter decisions -> block mask -> the block-skip
    kernel. Returns ``(min_sq_dist (N,), argmin (N,) int32,
    block_density)``, the density as an fp32 scalar tensor."""
    from .. import kernels        # the package's wrapper, swappable
    mask = build_block_mask(group_need, groups, tile_n=tile_n,
                            tile_k=tile_k)
    best, idx = kernels.filtered_assign(x, c, mask.contiguous(),
                                        tile_n=tile_n, tile_k=tile_k)
    return best, idx, mask.float().mean()
