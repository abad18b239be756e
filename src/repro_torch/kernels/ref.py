"""Plain PyTorch oracles of the kernels (port of ``repro.kernels.ref``:
``pairwise_sq_dists_ref``, ``filtered_assign_ref``,
``flash_attention_ref`` and ``ssd_intra_ref``).

Each mirrors one kernel of this package with the same output semantics.
The kernels' modules use them as their plain versions, which take
precomputed squared norms (``x2`` rows, ``c2`` centroids) as given, as
the kernels do; ``None`` computes them, as the reference does.
"""
from __future__ import annotations

import math

import torch

from ..core.distances import pairwise_sq_dists


def pairwise_sq_dists_ref(x, c, x2=None, c2=None) -> torch.Tensor:
    """(N, D), (K, D) of any float type -> (N, K) fp32 squared
    distances ``max(x2 - 2 x.c + c2, 0)``, accumulated in fp32."""
    return pairwise_sq_dists(x.float(), c.float(), x2, c2)


def expand_block_mask(block_mask, n: int, k: int, tile_n: int,
                      tile_k: int) -> torch.Tensor:
    """(ceil(N/tile_n), ceil(K/tile_k)) block mask -> (N, K) bool."""
    full = torch.repeat_interleave(block_mask.bool(), tile_n, dim=0)
    return torch.repeat_interleave(full, tile_k, dim=1)[:n, :k]


def filtered_assign_ref(x, c, block_mask, tile_n: int, tile_k: int,
                        x2=None, c2=None):
    """Block-skip argmin oracle.

    ``block_mask[i, j]`` says whether the distance block (points
    ``i*tile_n:(i+1)*tile_n``) x (centroids ``j*tile_k:(j+1)*tile_k``)
    is computed; skipped blocks count as +inf. Returns
    ``(min_sq_dist (N,) f32, argmin (N,) int32)``; ties go to the lowest
    index, and rows whose every block is skipped give (+inf, -1)."""
    n, k = x.shape[0], c.shape[0]
    d2 = pairwise_sq_dists_ref(x, c, x2, c2)
    live = expand_block_mask(block_mask, n, k, tile_n, tile_k)
    d2 = torch.where(live, d2, float("inf"))
    best, idx = torch.min(d2, dim=1)             # first index wins ties
    idx = torch.where(torch.isfinite(best), idx, -1)
    return best, idx.int()


def flash_attention_ref(q, k, v):
    """Causal softmax attention oracle: q, k, v (B, H, S, D) of any
    float type, fp32 scores and softmax, output in q's dtype."""
    s, d = q.shape[2], q.shape[3]
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    sc = torch.where(mask, sc, -math.inf)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def ssd_intra_ref(c, b, x, cum):
    """Intra-chunk SSD oracle. c, b: (G, Q, N); x: (G, Q, P); cum:
    (G, Q) -> (G, Q, P) fp32. The decay above the diagonal is selected
    to 0, never multiplied (its exp may be inf)."""
    scores = torch.einsum("gin,gjn->gij", c.float(), b.float())
    diff = cum[:, :, None] - cum[:, None, :]
    q = c.shape[1]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=c.device))
    decay = torch.where(mask[None], torch.exp(diff.float()), 0.0)
    return torch.einsum("gij,gjp->gip", scores * decay, x.float())
