"""Glue between the filter decisions and the kernels (port of
``repro.kernels.ops.build_group_block_mask``)."""
from __future__ import annotations

import torch


def build_group_block_mask(group_need: torch.Tensor, *,
                           tile_n: int) -> torch.Tensor:
    """(N, G) per-point-per-group need -> (ceil(N/tile_n), G) bool mask
    for ``grouped_assign``: block (i, g) is live iff any point in tile
    i needs group g."""
    n, g = group_need.shape
    n_pad = (-n) % tile_n
    padded = torch.nn.functional.pad(group_need, (0, 0, 0, n_pad))
    return torch.any(padded.reshape(-1, tile_n, g), dim=1)
