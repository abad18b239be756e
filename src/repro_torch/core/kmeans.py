"""Lloyd and triangle-inequality-filtered K-means, the reference loops
(port of ``repro.core.kmeans``).

* ``lloyd``   -- the baseline (N*K distance evaluations per iteration);
* ``yinyang`` -- KPynq's multi-level filter; ``n_groups == 1`` is the
  point-level (Hamerly) filter alone. It is the oracle the engine is
  tested against.

PyTorch has no ``while_loop``: each loop reads the scalar ``shift`` on
the host once per iteration. ``distance_evals`` is an int64 count (the
JAX package carries a compensated fp32 pair because it runs without
x64); at sizes below 2^24 both give the same integer.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels as _kernels
from ..obs.trace import phase
from .distances import (pairwise_dists, pairwise_sq_dists, row_norms_sq,
                        rowwise_dists)


# --------------------------------------------------------------------------
# shared pieces
# --------------------------------------------------------------------------

def centroid_sums(points, assignments, k: int, weights=None):
    """Per-cluster sums (K, D) and counts (K,), weighted by the optional
    (N,) ``weights``. On the card this is the ``centroid_update`` kernel,
    which sums in a fixed order (uniform weights of 1.0 are bit-identical
    to ``None``)."""
    labels = assignments if assignments.dtype == torch.int32 \
        else assignments.int()
    w = None if weights is None else weights.float().contiguous()
    return _kernels.centroid_update(points.float().contiguous(),
                                    labels.contiguous(), k, w)


def centroids_from_sums(sums, counts, prev_centroids):
    """Divide sums by counts; an empty cluster keeps its centroid."""
    safe = torch.clamp_min(counts, 1.0)[:, None]
    return torch.where(counts[:, None] > 0, sums / safe, prev_centroids)


def update_centroids(points, assignments, k: int, prev_centroids,
                     weights=None):
    sums, counts = centroid_sums(points, assignments, k, weights=weights)
    return centroids_from_sums(sums, counts, prev_centroids), counts


def group_centroids(centroids, n_groups: int, n_iters: int = 5):
    """Partition centroids into groups by clustering the centroids
    themselves (the Yinyang construction), seeded with a strided
    subset. Returns int32 group ids (K,)."""
    k = centroids.shape[0]
    if n_groups >= k:
        return (torch.arange(k, device=centroids.device) % n_groups).int()
    stride = max(k // n_groups, 1)
    seeds = centroids[::stride][:n_groups]
    for _ in range(n_iters):
        gid = torch.argmin(pairwise_dists(centroids, seeds), dim=1)
        seeds, _ = update_centroids(centroids, gid, n_groups, seeds)
    return torch.argmin(pairwise_dists(centroids, seeds), dim=1).int()


class KMeansResult(NamedTuple):
    centroids: torch.Tensor       # (K, D) fp32
    assignments: torch.Tensor     # (N,) int32
    n_iters: int
    distance_evals: torch.Tensor  # scalar int64
    inertia: torch.Tensor         # scalar fp32


def _inertia(points, centroids, assignments, weights=None):
    d = rowwise_dists(points, centroids[assignments.long()])
    d2 = d * d
    if weights is not None:
        d2 = d2 * weights.float()
    return torch.sum(d2)


def _f32(x: float) -> float:
    """``x`` rounded to fp32, as JAX compares a fp32 ``shift`` with a
    weakly typed python ``tol``."""
    return float(torch.tensor(x, dtype=torch.float32))


def _count(n: int, k: int, device) -> torch.Tensor:
    return torch.tensor(n * k, dtype=torch.int64, device=device)


# --------------------------------------------------------------------------
# Lloyd baseline
# --------------------------------------------------------------------------

def lloyd(points, init_centroids, max_iters: int = 100, tol: float = 1e-4,
          weights=None) -> KMeansResult:
    """Standard K-means. One host read of ``shift`` per iteration."""
    k = init_centroids.shape[0]
    n = points.shape[0]
    tol = _f32(tol)
    centroids = init_centroids.float()
    assign = torch.zeros((n,), dtype=torch.int32, device=points.device)
    evals = _count(0, 0, points.device)
    i, shift = 0, float("inf")
    while i < max_iters and shift > tol:
        assign = torch.argmin(pairwise_dists(points, centroids), dim=1).int()
        new_c, _ = update_centroids(points, assign, k, centroids,
                                    weights=weights)
        shift_t = torch.max(torch.sqrt(torch.sum(
            (new_c - centroids) ** 2, dim=-1)))
        with phase("kpynq/host_read", points.is_cuda):
            shift = float(shift_t)
        centroids = new_c
        evals = evals + n * k
        i += 1
    return KMeansResult(centroids, assign, i, evals,
                        _inertia(points, centroids, assign, weights))


# --------------------------------------------------------------------------
# KPynq multi-level filtered K-means (Yinyang/Hamerly family)
# --------------------------------------------------------------------------

class FilterState(NamedTuple):
    iteration: int
    centroids: torch.Tensor   # (K, D)
    assignments: torch.Tensor  # (N,) int32
    ub: torch.Tensor          # (N,)   upper bound on d(x, a(x))
    lb: torch.Tensor          # (N, G) lower bound per group
    shift: torch.Tensor       # max centroid drift last iteration
    distance_evals: torch.Tensor  # int64


def segment_min_cols(d, groups, n_groups: int):
    """(N, K) -> (N, G): per row, the min over each group's columns
    (+inf for an empty group), as ``segment_min(d.T, groups).T``."""
    out = torch.full((d.shape[0], n_groups), float("inf"),
                     dtype=d.dtype, device=d.device)
    idx = groups.long()[None, :].expand(d.shape[0], -1)
    return out.scatter_reduce_(1, idx, d, "amin")


def segment_max(v, groups, n_groups: int):
    """(K,) -> (G,) per-group max (-inf for an empty group)."""
    out = torch.full((n_groups,), float("-inf"), dtype=v.dtype,
                     device=v.device)
    return out.scatter_reduce_(0, groups.long(), v, "amax")


def min_at(lb, rows_cols, values):
    """``lb.at[rows, cols].min(values)`` for one column per row."""
    cur = torch.gather(lb, 1, rows_cols[:, None])
    return lb.scatter(1, rows_cols[:, None],
                      torch.minimum(cur, values[:, None]))


def _init_filter_state(points, centroids, groups, n_groups: int, x2=None,
                       c2=None) -> FilterState:
    """Initial exact assignment + bounds, reduced on squared distances.
    The (N, K) distance matrix is overwritten in place (the assigned
    column set to +inf) to keep one such buffer alive."""
    n, k = points.shape[0], centroids.shape[0]
    d2 = pairwise_sq_dists(points, centroids, x2, c2)          # (N, K)
    ub2, assign = torch.min(d2, dim=1)
    ub = torch.sqrt(ub2)
    d2.scatter_(1, assign[:, None], float("inf"))
    lb = torch.sqrt(segment_min_cols(d2, groups, n_groups))
    return FilterState(0, centroids.float(), assign.int(), ub, lb,
                       torch.tensor(float("inf"), device=points.device),
                       _count(n, k, points.device))


def _filtered_step(points, state: FilterState, groups, n_groups: int,
                   k: int, x2=None, weights=None) -> FilterState:
    """One KPynq iteration: centroid move -> bound maintenance ->
    point-level filter -> group-level filter -> masked distance pass."""
    n = points.shape[0]
    rows = torch.arange(n, device=points.device)
    a_old = state.assignments.long()

    new_c, _ = update_centroids(points, state.assignments, k,
                                state.centroids, weights=weights)
    c2 = row_norms_sq(new_c)
    drift = torch.sqrt(torch.sum((new_c - state.centroids) ** 2, dim=-1))
    group_drift = segment_max(drift, groups, n_groups)
    shift = torch.max(drift)

    ub = state.ub + drift[a_old]
    lb = torch.clamp_min(state.lb - group_drift[None, :], 0.0)
    glb = torch.min(lb, dim=1).values

    maybe = ub > glb
    if x2 is None:
        d_own = rowwise_dists(points, new_c[a_old])
    else:
        d_own = torch.sqrt(torch.clamp_min(
            x2 - 2.0 * torch.sum(points * new_c[a_old], dim=-1)
            + c2[a_old], 0.0))
    ub_t = torch.where(maybe, d_own, ub)
    need = ub_t > glb
    evals = state.distance_evals + maybe.sum()

    group_need = need[:, None] & (lb < ub_t[:, None])             # (N, G)
    cand = group_need[:, groups.long()]                            # (N, K)
    evals = evals + cand.sum()

    d2_cand = torch.where(cand, pairwise_sq_dists(points, new_c, x2, c2),
                          float("inf"))
    best2, best_other = torch.min(d2_cand, dim=1)
    best_other_d = torch.sqrt(best2)
    changed = best_other_d < ub_t
    new_assign = torch.where(changed, best_other, a_old)
    new_ub = torch.minimum(ub_t, best_other_d)

    d2_cand[rows, new_assign] = float("inf")
    lb_comp = torch.sqrt(segment_min_cols(d2_cand, groups, n_groups))
    new_lb = torch.where(group_need, lb_comp, lb)
    old_group = groups.long()[a_old]
    new_lb = min_at(new_lb, old_group,
                    torch.where(changed, ub_t, float("inf")))
    return FilterState(state.iteration + 1, new_c, new_assign.int(), new_ub,
                       new_lb, shift, evals)


def yinyang(points, init_centroids, n_groups: int | None = None,
            max_iters: int = 100, tol: float = 1e-4,
            weights=None) -> KMeansResult:
    """KPynq filtered K-means, the reference loop. ``n_groups=1`` ->
    point-level filter only; default ``K // 10`` groups."""
    k = init_centroids.shape[0]
    if n_groups is None:
        n_groups = max(k // 10, 1)
    n_groups = int(min(n_groups, k))
    init_c = init_centroids.float()
    groups = group_centroids(init_c, n_groups)
    x2 = row_norms_sq(points)
    state = _init_filter_state(points, init_c, groups, n_groups, x2=x2)
    tol, shift = _f32(tol), float("inf")
    while state.iteration < max_iters and shift > tol:
        state = _filtered_step(points, state, groups, n_groups, k, x2=x2,
                               weights=weights)
        shift = float(state.shift)
    return KMeansResult(state.centroids, state.assignments, state.iteration,
                        state.distance_evals,
                        _inertia(points, state.centroids, state.assignments,
                                 weights))
