"""Filtered K-means execution engine (port of ``repro.core.engine``).

One pass core, the batch fit driver, and tiled assignment. Backends:

``"oracle"``
    Masked-dense candidate pass over all N points: computes every
    distance and discards the filtered ones. Ground truth.
``"kernel"`` (alias ``"pallas"``)
    The group-granular block-skip CUDA kernel
    (:mod:`repro_torch.kernels.grouped_assign`): the (point, group)
    filter decisions become a (N/tile_n, G) block mask, and only live
    blocks are scored.
``"lloyd"``
    The reference Lloyd loop: one dense product per iteration.
``"auto"``
    ``"lloyd"`` when ``n * k <= lloyd_max_work``, else ``"kernel"``.

The loop keeps the reference's split structure: the initial pending
candidate pass is empty, each body runs the pending candidate pass and
then :func:`move_and_bounds`, and one epilogue pass follows the loop, so
``n_iters`` and ``distance_evals`` come out as in JAX. PyTorch has no
``while_loop``: the host reads ``shift`` once per iteration, and
:class:`EngineStats` counts every such read in ``host_syncs``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..device import as_float32, resolve_device
from ..kernels import build_group_block_mask
from ..kernels import grouped_assign as _ga
from .distances import pairwise_sq_dists, row_norms_sq, rowwise_dists
from .kmeans import (KMeansResult, _f32, _init_filter_state, centroid_sums,
                     centroids_from_sums, group_centroids, lloyd, min_at,
                     segment_max, segment_min_cols)

BACKENDS = ("oracle", "kernel")
ALIASES = {"pallas": "kernel"}
NOT_PORTED = {
    "compact": "ROADMAP Queue 1 item 3 (the compact backend)",
    "ladder": "ROADMAP Queue 1 item 9 (the sharded drivers)",
}

# backend="auto" routes n*k at or below this to the dense Lloyd loop
AUTO_LLOYD_MAX_WORK = 1 << 17


def _backend_name(backend: str) -> str:
    backend = ALIASES.get(backend, backend)
    if backend in NOT_PORTED:
        raise NotImplementedError(
            f"engine backend {backend!r} is not ported yet: "
            f"{NOT_PORTED[backend]}")
    if backend not in BACKENDS + ("auto", "lloyd"):
        raise ValueError(f"unknown engine backend {backend!r}; expected "
                         f"one of {BACKENDS + ('auto', 'lloyd')} or "
                         f"'pallas'")
    return backend


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The engine's knobs that this port has. None affects the fixed
    point, only dispatch and shapes.

    backend : "auto" | "oracle" | "kernel" | "lloyd"
    tile_n : point-tile height of the block mask and the kernel.
    lloyd_max_work : backend="auto" routes ``n * k <= lloyd_max_work``
        to the Lloyd loop.
    """
    backend: str = "auto"
    tile_n: int = 256
    lloyd_max_work: int = AUTO_LLOYD_MAX_WORK

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "EngineConfig":
        """Tolerant inverse of :meth:`to_dict`: keys this port does not
        have (a JAX configuration's compact knobs) are dropped."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = EngineConfig()


@dataclasses.dataclass(frozen=True)
class ConvergenceUpdate:
    """Batch-fit centroid rule: mean of the sums; an empty cluster keeps
    its centroid. An empty group's max drift stays ``-inf``, which the
    bound decay turns into a vacuous (+inf) lower bound."""

    def apply(self, sums, counts, centroids):
        return centroids_from_sums(sums, counts, centroids), counts


CONVERGENCE_UPDATE = ConvergenceUpdate()


class MoveOut(NamedTuple):
    centroids: torch.Tensor    # (K, D) after the update rule
    c2: torch.Tensor           # (K,) ||centroids||^2, once per iteration
    counts: torch.Tensor       # (K,)
    ub: torch.Tensor           # (N,) drift-inflated, refreshed
    lb: torch.Tensor           # (N, G) drift-decayed
    need: torch.Tensor         # (N,) pending candidate mask
    shift: torch.Tensor        # f32 max centroid drift
    tightened: torch.Tensor    # int64 own-distance refreshes
    drift: torch.Tensor        # (K,)
    gdrift: torch.Tensor       # (G,)


# --------------------------------------------------------------------------
# the iteration
# --------------------------------------------------------------------------

def move_and_bounds(points, centroids, assignments, ub, lb, groups, *,
                    k: int, n_groups: int, update=CONVERGENCE_UPDATE,
                    weights=None, x2=None) -> MoveOut:
    """Centroid move + triangle-inequality bound upkeep + the point-level
    filter with its own-distance refresh (local reduction only)."""
    a = assignments.long()
    sums, bcounts = centroid_sums(points, assignments, k, weights=weights)
    new_c, new_counts = update.apply(sums, bcounts, centroids)
    new_c2 = row_norms_sq(new_c)
    drift = torch.sqrt(torch.sum((new_c - centroids) ** 2, dim=-1))
    group_drift = segment_max(drift, groups, n_groups)
    shift = torch.max(drift)
    ub = ub + drift[a]
    lb_dec = torch.clamp_min(lb - group_drift[None, :], 0.0)
    glb = torch.min(lb_dec, dim=1).values
    maybe = ub > glb
    if x2 is None:
        d_own = rowwise_dists(points, new_c[a])
    else:
        d_own = torch.sqrt(torch.clamp_min(
            x2 - 2.0 * torch.sum(points * new_c[a], dim=-1) + new_c2[a],
            0.0))
    ub_t = torch.where(maybe, d_own, ub)
    need = ub_t > glb
    return MoveOut(new_c, new_c2, new_counts, ub_t, lb_dec, need, shift,
                   maybe.sum(), drift, group_drift)


def _finish_pass(best_d, best_id, lb_comp, assignments, ub_t, lb, groups,
                 group_need):
    """The candidate passes' shared tail: reassign, tighten ``ub``,
    refresh the computed groups' ``lb`` and cap the old group's."""
    a = assignments.long()
    changed = best_d < ub_t
    new_assign = torch.where(changed, best_id.long(), a)
    new_ub = torch.minimum(ub_t, best_d)
    new_lb = torch.where(group_need, lb_comp, lb)
    # a point that left centroid b puts b back into its group's pool at
    # exact distance ub_t; a skipped group's decayed lb may exceed it
    new_lb = min_at(new_lb, groups.long()[a],
                    torch.where(changed, ub_t, float("inf")))
    return new_assign.int(), new_ub, new_lb


def dense_candidate_pass(points, new_c, assignments, ub_t, lb, groups, need,
                         *, n_groups: int, x2=None, c2=None):
    """Masked-dense candidate pass (the oracle backend). Returns
    ``(new_assign, new_ub, new_lb, n_pairs)``."""
    group_need = need[:, None] & (lb < ub_t[:, None])              # (N, G)
    cand = group_need[:, groups.long()]                             # (N, K)
    pairs = cand.sum()
    d_cand = torch.where(cand, pairwise_sq_dists(points, new_c, x2, c2),
                         float("inf"))
    best2, best = torch.min(d_cand, dim=1)
    best_d = torch.sqrt(best2)
    changed = best_d < ub_t
    new_a = torch.where(changed, best, assignments.long())
    d_cand.scatter_(1, new_a[:, None], float("inf"))       # in place
    lb_comp = torch.sqrt(segment_min_cols(d_cand, groups, n_groups))
    out = _finish_pass(best_d, best, lb_comp, assignments, ub_t, lb, groups,
                       group_need)
    return out + (pairs,)


def kernel_candidate_pass(points, new_c, assignments, ub_t, lb, groups,
                          members, gsize, need, *, tile_n: int = 256,
                          x2=None, c2=None):
    """Candidate pass through the ``grouped_assign`` kernel (port of
    ``pallas_candidate_pass``). The pair count is
    ``tile_n * sum(mask * gsize)``, pad rows of the tail tile included,
    as the reference counts it."""
    group_need = need[:, None] & (lb < ub_t[:, None])              # (N, G)
    mask = build_group_block_mask(group_need, tile_n=tile_n)       # (gn, G)
    mem_s = members.clamp_min(0).long()
    c_grouped = new_c[mem_s].contiguous()                   # (G, Lmax, D)
    c2g = None if c2 is None else c2[mem_s].contiguous()
    best2, idx, gmin, garg, gmin2 = _ga.grouped_assign(
        points, c_grouped, members, mask.contiguous(), tile_n=tile_n,
        x2=x2, c2g=c2g)
    best_d = torch.sqrt(best2)
    changed = best_d < ub_t
    new_a = torch.where(changed, idx, assignments)
    # the group argmin collides with the new assignment iff it came from
    # that group; then the second min is the min excluding it
    lb_comp = torch.sqrt(torch.where(garg == new_a[:, None], gmin2, gmin))
    out = _finish_pass(best_d, idx, lb_comp, assignments, ub_t, lb, groups,
                       group_need)
    pairs = tile_n * (mask.long() * gsize[None, :]).sum()
    return out + (pairs,)


# --------------------------------------------------------------------------
# the loop
# --------------------------------------------------------------------------

class EngineCarry(NamedTuple):
    """Loop state. ``ub``/``lb``/``need`` describe the PENDING candidate
    pass, which the next body (or the epilogue) runs."""
    iteration: int            # completed move+bounds iterations
    centroids: torch.Tensor   # (K, D)
    c2: torch.Tensor          # (K,)
    assignments: torch.Tensor  # (N,) int32
    ub: torch.Tensor          # (N,)
    lb: torch.Tensor          # (N, G)
    x2: torch.Tensor          # (N,) ||x||^2, once per fit
    need: torch.Tensor        # (N,) bool
    shift: torch.Tensor       # f32 max centroid drift
    evals: torch.Tensor       # int64


@dataclasses.dataclass
class EngineStats:
    """Execution telemetry. ``host_syncs`` counts every host read of a
    device value: the group table fetch, and one ``shift`` read per
    loop iteration (a CUDA graph per body is a later step)."""
    backend: str = ""
    n_iters: int = 0
    host_syncs: int = 0
    config: dict = dataclasses.field(default_factory=dict)
    n_points: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class PassCore:
    """The candidate-pass dispatch: the masked-dense oracle or the
    ``grouped_assign`` kernel. ``_loop_body`` pairs it with
    :func:`move_and_bounds`."""
    backend: str
    k: int
    n_groups: int
    tile_n: int = 256

    def candidate_pass(self, points, centroids, assignments, ub, lb, need,
                       groups, members, gsize, *, x2, c2):
        """``(assign, ub, lb, pairs)`` for the pending candidates."""
        if self.backend == "oracle":
            return dense_candidate_pass(
                points, centroids, assignments, ub, lb, groups, need,
                n_groups=self.n_groups, x2=x2, c2=c2)
        return kernel_candidate_pass(
            points, centroids, assignments, ub, lb, groups, members, gsize,
            need, tile_n=self.tile_n, x2=x2, c2=c2)


def _loop_body(core: PassCore, points, weights, groups, members, gsize):
    """The pending candidate pass, then move + bound upkeep."""

    def body(c: EngineCarry) -> EngineCarry:
        new_as, new_ub, new_lb, pairs = core.candidate_pass(
            points, c.centroids, c.assignments, c.ub, c.lb, c.need, groups,
            members, gsize, x2=c.x2, c2=c.c2)
        mv = move_and_bounds(points, c.centroids, new_as, new_ub, new_lb,
                             groups, k=core.k, n_groups=core.n_groups,
                             weights=weights, x2=c.x2)
        return EngineCarry(c.iteration + 1, mv.centroids, mv.c2, new_as,
                           mv.ub, mv.lb, c.x2, mv.need, mv.shift,
                           c.evals + pairs + mv.tightened)

    return body


def _loop_cond(*, max_iters: int, tol: float):
    """Terminal exits only: out of iterations, or converged. ``shift``
    is the host copy of the carry's drift; ``tol`` compares in fp32."""
    tol32 = _f32(tol)

    def cond(iteration: int, shift: float) -> bool:
        return iteration < max_iters and shift > tol32

    return cond


def _epilogue_pass(core: PassCore, points, weights, carry: EngineCarry,
                   groups, members, gsize):
    """The final pending candidate pass + (weighted) inertia. Returns
    ``(assignments, evals, inertia)``."""
    new_as, _, _, pairs = core.candidate_pass(
        points, carry.centroids, carry.assignments, carry.ub, carry.lb,
        carry.need, groups, members, gsize, x2=carry.x2, c2=carry.c2)
    d = rowwise_dists(points, carry.centroids[new_as.long()])
    d2 = d * d
    if weights is not None:
        d2 = d2 * weights
    return new_as, carry.evals + pairs, torch.sum(d2)


def _init_carry(points, init_c, groups, *, n_groups: int) -> EngineCarry:
    """Point norms (THE once-per-fit ``||x||^2``), the initial filter
    state, and an empty pending pass."""
    n = points.shape[0]
    x2 = row_norms_sq(points)
    c2 = row_norms_sq(init_c)
    s0 = _init_filter_state(points, init_c, groups, n_groups, x2=x2, c2=c2)
    return EngineCarry(0, s0.centroids, c2, s0.assignments, s0.ub, s0.lb, x2,
                       torch.zeros((n,), dtype=torch.bool,
                                   device=points.device),
                       s0.shift, s0.distance_evals)


# --------------------------------------------------------------------------
# tables and setup
# --------------------------------------------------------------------------

def build_group_tables(groups_np: np.ndarray, n_groups: int, device):
    """(G, Lmax) -1-padded membership table (ascending ids per row) and
    int64 group sizes, built on the host."""
    counts = np.bincount(groups_np, minlength=n_groups)
    l_max = max(int(counts.max()), 1)
    members_np = np.full((n_groups, l_max), -1, np.int32)
    for g in range(n_groups):
        ids = np.nonzero(groups_np == g)[0]
        members_np[g, :len(ids)] = ids
    return (torch.from_numpy(members_np).to(device),
            torch.from_numpy(counts.astype(np.int64)).to(device))


def build_assign_tables(centroids, n_groups: int | None = None):
    """Group map + tables over fixed centroids (K//10 heuristic, clamp
    to K). Returns ``(groups, members, gsize)``."""
    k = centroids.shape[0]
    if n_groups is None:
        n_groups = max(k // 10, 1)
    n_groups = int(min(max(n_groups, 1), k))
    groups = group_centroids(centroids, n_groups)
    members, gsize = build_group_tables(groups.cpu().numpy(), n_groups,
                                        centroids.device)
    return groups, members, gsize


def _resolve_config(*, backend, tile_n, config, tune, n, k):
    """``(config, resolved_backend)``: explicit ``tile_n`` > ``config``
    > defaults (the port has no tuning cache yet). The caller's backend
    wins unless it is ``"auto"``."""
    if tune not in ("auto", "off"):
        if tune == "force":
            raise NotImplementedError(
                "tune='force' is not ported yet: ROADMAP Queue 1 item 5 "
                "(autotuning)")
        raise ValueError(f"unknown tune mode {tune!r}")
    cfg = DEFAULT_CONFIG if config is None else config
    if tile_n is not None:
        cfg = cfg.replace(tile_n=int(tile_n))
    resolved = _backend_name(backend)
    if resolved == "auto":
        resolved = _backend_name(cfg.backend)
    if resolved == "auto":
        resolved = "lloyd" if n * k <= cfg.lloyd_max_work else "kernel"
    return cfg, resolved


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def fit(points, init_centroids, *, n_groups: int | None = None,
        max_iters: int = 100, tol: float = 1e-4, backend: str = "auto",
        tile_n: int | None = None, config: EngineConfig | None = None,
        tune: str = "auto", sample_weight=None, return_stats: bool = False,
        device=None):
    """Filtered K-means on ``device`` (default ``cuda``; raises when it
    is not there). ``sample_weight`` enters the centroid sums and the
    inertia only; uniform weights of 1.0 are bit-identical to ``None``.

    Returns a :class:`KMeansResult` (tensors on ``device``); with
    ``return_stats=True`` returns ``(result, EngineStats)``."""
    dev = resolve_device(device)
    points = as_float32(points, dev)
    init_c = as_float32(init_centroids, dev)
    k = init_c.shape[0]
    n = points.shape[0]
    weights = None if sample_weight is None else \
        as_float32(sample_weight, dev)
    cfg, backend = _resolve_config(backend=backend, tile_n=tile_n,
                                   config=config, tune=tune, n=n, k=k)
    stats = EngineStats(backend=backend, config=cfg.to_dict(), n_points=n)

    if backend == "lloyd":
        res = lloyd(points, init_c, int(max_iters), float(tol),
                    weights=weights)
        stats.n_iters = res.n_iters
        stats.host_syncs = res.n_iters      # one shift read per iteration
        return (res, stats) if return_stats else res

    if n_groups is None:
        n_groups = max(k // 10, 1)
    n_groups = int(min(n_groups, k))
    core = PassCore(backend=backend, k=k, n_groups=n_groups,
                    tile_n=cfg.tile_n)

    groups = group_centroids(init_c, n_groups)
    members, gsize = build_group_tables(groups.cpu().numpy(), n_groups, dev)
    stats.host_syncs += 1
    carry = _init_carry(points, init_c, groups, n_groups=n_groups)

    cond = _loop_cond(max_iters=int(max_iters), tol=float(tol))
    body = _loop_body(core, points, weights, groups, members, gsize)
    shift = float("inf")
    while cond(carry.iteration, shift):
        carry = body(carry)
        shift = float(carry.shift)          # the per-iteration host sync
        stats.host_syncs += 1
    stats.n_iters = carry.iteration

    assignments, evals, inertia = _epilogue_pass(
        core, points, weights, carry, groups, members, gsize)
    result = KMeansResult(carry.centroids, assignments, carry.iteration,
                          evals, inertia)
    return (result, stats) if return_stats else result


def assign(points, centroids, *, n_groups: int | None = None, groups=None,
           members=None, gsize=None, tile_n: int = 1 << 16, device=None):
    """Exact nearest-centroid assignment against fixed centroids: each
    ``tile_n`` slice of ``points`` runs the kernel candidate pass with
    vacuous bounds (every block live), so no (N, K) buffer exists.

    Returns ``(labels (N,) int32, dists (N,) f32)`` on ``device``."""
    dev = resolve_device(device)
    points = as_float32(points, dev)
    centroids = as_float32(centroids, dev)
    n, k = points.shape[0], centroids.shape[0]
    if n == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.float32, device=dev))
    if groups is None:
        groups, members, gsize = build_assign_tables(centroids, n_groups)
    core = PassCore(backend="kernel", k=k, n_groups=int(gsize.shape[0]))
    c2 = row_norms_sq(centroids)
    labels, dists = [], []
    for lo in range(0, n, tile_n):
        part = points[lo:lo + tile_n].contiguous()
        b = part.shape[0]
        a0 = torch.zeros((b,), dtype=torch.int32, device=dev)
        ub = torch.full((b,), float("inf"), device=dev)
        lb = torch.zeros((b, core.n_groups), device=dev)
        need = torch.ones((b,), dtype=torch.bool, device=dev)
        nas, nub, _, _ = core.candidate_pass(
            part, centroids, a0, ub, lb, need, groups, members, gsize,
            x2=row_norms_sq(part), c2=c2)
        labels.append(nas)
        dists.append(nub)
    return torch.cat(labels), torch.cat(dists)
