"""Legacy host-driven stream-compaction K-means driver (port of
``repro.core.compact``).

The baseline the engine is measured against. The iteration math is the
engine's own (:func:`engine.move_and_bounds` and
:func:`engine.compact_candidate_pass` with the centroid-level bucket
off); what makes it the legacy driver is the control flow: the loop
moves first and then runs the candidate pass, every iteration reads the
candidate count, the refresh count and ``shift`` to the host (one
transfer here), and the compaction capacity is the next power of two
of that iteration's count.
"""
from __future__ import annotations

import torch

from .distances import row_norms_sq, rowwise_dists
from .engine import compact_candidate_pass, move_and_bounds
from .kmeans import KMeansResult, _init_filter_state, group_centroids


def yinyang_compact(points, init_centroids, n_groups=None,
                    max_iters: int = 100, tol: float = 1e-4,
                    min_cap: int = 256) -> KMeansResult:
    """Filtered K-means with a host-sized compaction buffer. Every
    candidate is scored against all K centroids, and
    ``distance_evals`` counts ``n_cand * K`` per iteration, as the
    reference does. Runs on the device of ``points``."""
    k = init_centroids.shape[0]
    n = points.shape[0]
    if n_groups is None:
        n_groups = max(k // 10, 1)
    n_groups = int(min(n_groups, k))
    init_c = init_centroids.float()
    groups = group_centroids(init_c, n_groups)
    x2 = row_norms_sq(points)                 # once per fit
    state = _init_filter_state(points, init_c, groups, n_groups, x2=x2)
    centroids, assignments = state.centroids, state.assignments
    ub, lb = state.ub, state.lb
    evals = int(state.distance_evals)
    # cap_g = n_groups with no member table: the dense branch, always
    members = torch.full((n_groups, 1), -1, dtype=torch.int32,
                         device=points.device)
    gsize = torch.zeros((n_groups,), dtype=torch.int64, device=points.device)

    it = 0
    for it in range(1, max_iters + 1):
        mv = move_and_bounds(points, centroids, assignments, ub, lb, groups,
                             k=k, n_groups=n_groups, x2=x2)
        centroids, ub, lb = mv.centroids, mv.ub, mv.lb
        n_cand, tightened, shift = torch.stack(
            [mv.need.sum().double(), mv.tightened.double(),
             mv.shift.double()]).tolist()      # per-iteration host sync
        n_cand = int(n_cand)
        evals += int(tightened)
        if n_cand > 0:
            cap = min(max(min_cap, 1 << (n_cand - 1).bit_length()), n)
            assignments, ub, lb, _, _ = compact_candidate_pass(
                points, centroids, assignments, ub, lb, groups, members,
                gsize, mv.need, cap_n=cap, cap_g=n_groups, n_groups=n_groups,
                use_groups=False, x2=x2, c2=mv.c2)
            evals += n_cand * k
        if shift <= tol:
            break

    d = rowwise_dists(points, centroids[assignments.long()])
    return KMeansResult(centroids, assignments, it,
                        torch.tensor(evals, dtype=torch.int64,
                                     device=points.device),
                        torch.sum(d * d))
