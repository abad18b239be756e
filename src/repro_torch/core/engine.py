"""Filtered K-means execution engine (port of ``repro.core.engine``).

One pass core, the batch fit driver, and tiled assignment. Backends:

``"oracle"``
    Masked-dense candidate pass over all N points: computes every
    distance and discards the filtered ones. Ground truth.
``"compact"``
    Two-level compaction: the pending candidates are stream-compacted
    into a buffer of ``cap_n`` rows, and where few groups survive, each
    candidate's surviving groups into a bucket of ``cap_g`` slots, so
    only those groups' centroids are scored. Capacities come from a
    power-of-two lattice picked by the reference's bucket rules. The
    JAX package picks this backend off the TPU; here ``"auto"`` does
    not, and it runs when asked for.
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
``while_loop``: the host reads the loop's exit scalars once per
iteration (``shift``; on the compact backend ``shift``, ``n_cand`` and
``gmax`` in one transfer) and applies the reference's exit rules to
them. :class:`EngineStats` counts every such read in ``host_syncs``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels as _kernels
from ..device import as_float32, resolve_device
from ..kernels import build_group_block_mask, compact_indices
from .distances import (_check_fp32_matmul, pairwise_sq_dists, row_norms_sq,
                        rowwise_dists)
from .kmeans import (KMeansResult, _f32, _init_filter_state, centroid_sums,
                     centroids_from_sums, group_centroids, lloyd, min_at,
                     segment_max, segment_min_cols)

BACKENDS = ("oracle", "compact", "kernel")
ALIASES = {"pallas": "kernel"}
NOT_PORTED = {
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
    """The engine's knobs, with the reference's defaults. None affects
    the fixed point, only dispatch and shapes.

    backend : "auto" | "oracle" | "compact" | "kernel" | "lloyd"
    tile_n : point-tile height of the block mask and the kernel.
    min_cap : floor of the power-of-two point-capacity lattice
        (compact backend).
    chunk : largest point capacity at which the compact pass considers
        its group-gather branch.
    group_gather_factor : the group-gather branch is taken only when
        ``cap_g * l_max * group_gather_factor <= k``.
    down_n / down_g : downshift hysteresis: a segment exits to a smaller
        bucket when ``n_cand * down_n <= cap_n`` (resp.
        ``gmax * down_g <= cap_g``); 0 disables that axis.
    refresh_in_pass : on the compact backend, run the own-distance
        refresh on the compacted buffer inside the candidate pass
        (buckets then follow the larger *maybe* count) instead of over
        all N rows in :func:`move_and_bounds`.
    lloyd_max_work : backend="auto" routes ``n * k <= lloyd_max_work``
        to the Lloyd loop.
    """
    backend: str = "auto"
    tile_n: int = 256
    min_cap: int = 256
    chunk: int = 2048
    group_gather_factor: int = 4
    down_n: int = 2
    down_g: int = 4
    refresh_in_pass: bool = False
    lloyd_max_work: int = AUTO_LLOYD_MAX_WORK

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "EngineConfig":
        """Tolerant inverse of :meth:`to_dict`: unknown keys are
        dropped, missing keys default."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = EngineConfig()


def use_groups_decision(*, cap_n: int, cap_g: int, l_max: int, k: int,
                        chunk: int, group_gather_factor: int) -> bool:
    """The compact pass's group-gather versus dense-product crossover,
    the one copy of the rule (pass and driver)."""
    return (cap_g * l_max * group_gather_factor <= k) and cap_n <= chunk


def _bucket_cap(count: int, floor: int, ceil: int) -> int:
    """Smallest power of two >= count, clamped to [floor, ceil]."""
    cap = 1 << (max(int(count), 1) - 1).bit_length()
    return max(min(cap, ceil), min(floor, ceil))


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
                    weights=None, x2=None, refresh: bool = True) -> MoveOut:
    """Centroid move + triangle-inequality bound upkeep + the point-level
    filter (local reduction only).

    ``refresh=False`` (the compact backend's in-pass placement) skips
    the own-distance refresh: the returned ``ub`` is the drift-inflated
    bound and ``need`` the *maybe* mask, and
    :func:`compact_candidate_pass` refreshes on its compacted buffer.
    ``tightened`` counts the *maybe* rows either way."""
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
    if refresh:
        if x2 is None:
            d_own = rowwise_dists(points, new_c[a])
        else:
            d_own = torch.sqrt(torch.clamp_min(
                x2 - 2.0 * torch.sum(points * new_c[a], dim=-1)
                + new_c2[a], 0.0))
        ub_t = torch.where(maybe, d_own, ub)
        need = ub_t > glb
    else:
        ub_t, need = ub, maybe
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
    best2, idx, gmin, garg, gmin2 = _kernels.grouped_assign(
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


def _scatter_rows(dst, rows, src):
    """``dst`` with ``dst[rows] = src``, where ``rows == len(dst)``
    marks a slot to drop (a spare row takes it)."""
    ext = torch.cat([dst, dst[:1]])
    ext.index_copy_(0, rows, src)
    return ext[:dst.shape[0]]


def _dense_branch(cpts, new_c, c_as, c_ub, c_lb, gneed, n_rows, groups, *,
                  n_groups: int, c_x2, c2):
    """One (cap_n, K) product on the survivors (``core/distances``, as
    the reference leaves it to XLA). Counts ``n_rows * K`` pairs."""
    k = new_c.shape[0]
    gmask = gneed[:, groups.long()]                               # (cap, K)
    d_cand = torch.where(gmask, pairwise_sq_dists(cpts, new_c, c_x2, c2),
                         float("inf"))
    bd2, bid = torch.min(d_cand, dim=1)
    bd = torch.sqrt(bd2)
    chg = bd < c_ub
    nas = torch.where(chg, bid, c_as.long())
    nub = torch.minimum(c_ub, bd)
    d_cand.scatter_(1, nas[:, None], float("inf"))         # in place
    lb_comp = torch.sqrt(segment_min_cols(d_cand, groups, n_groups))
    new_clb = torch.where(gneed, lb_comp, c_lb)
    return nas.int(), nub, new_clb, n_rows * k, chg


def _group_branch(cpts, new_c, c_as, c_ub, c_lb, gneed, members, gsize, *,
                  cap_g: int, n_groups: int, c_x2, c2):
    """Centroid-level compaction: each survivor's surviving groups in a
    ``cap_g``-slot bucket (needs ``gmax <= cap_g``), and only those
    groups' centroids scored. Counts ``sum(gneed * gsize)`` pairs."""
    cap_n = cpts.shape[0]
    l_max = members.shape[1]
    dev = cpts.device
    gpos = torch.cumsum(gneed.int(), dim=1) - 1
    gslot = torch.where(gneed, gpos, cap_g)                  # misses: spare
    gsel = torch.full((cap_n, cap_g + 1), n_groups, dtype=torch.long,
                      device=dev)
    gsel.scatter_(1, gslot.long(), torch.arange(
        n_groups, device=dev).expand(cap_n, n_groups))
    gsel = gsel[:, :cap_g]                                   # (cap, cap_g)
    # slot n_groups of the padded table reads as an empty group
    members_ext = torch.cat([members, torch.full(
        (1, l_max), -1, dtype=members.dtype, device=dev)])
    mem = members_ext[gsel]                                  # (cap, g, L)
    mem_s = mem.clamp_min(0).long()
    _check_fp32_matmul(cpts)
    cross = torch.einsum("nd,ngld->ngl", cpts, new_c[mem_s])
    d2 = torch.clamp_min(c_x2[:, None, None] - 2.0 * cross + c2[mem_s], 0.0)
    dm = torch.where(mem >= 0, d2, float("inf")).reshape(cap_n, -1)
    memf = mem.reshape(cap_n, -1)
    bd2, bcol = torch.min(dm, dim=1)
    bd = torch.sqrt(bd2)
    bid = torch.gather(memf, 1, bcol[:, None])[:, 0]
    chg = bd < c_ub
    nas = torch.where(chg, bid, c_as)
    nub = torch.minimum(c_ub, bd)
    d_ex = torch.where(memf == nas[:, None], float("inf"), dm)
    smin = torch.sqrt(d_ex.reshape(cap_n, cap_g, l_max).amin(dim=2))
    clb_ext = torch.cat([c_lb, c_lb[:, :1]], dim=1)          # spare column
    new_clb = clb_ext.scatter(1, gsel, smin)[:, :n_groups]
    pairs = (gneed.long() * gsize[None, :]).sum()
    return nas.int(), nub, new_clb, pairs, chg


def compact_candidate_pass(points, new_c, assignments, ub_t, lb, groups,
                           members, gsize, need, *, cap_n: int, cap_g: int,
                           n_groups: int, chunk: int = 2048,
                           use_groups: bool | None = None, x2=None, c2=None,
                           refresh_ub: bool = False,
                           group_gather_factor: int = 4,
                           gmax: int | None = None):
    """Two-level compacted candidate pass.

    Point level: the ``need`` rows are compacted into a ``cap_n``-row
    buffer (``ops.compact_indices``; ``cap_n`` must be at least their
    count, which the driver's bucket rules guarantee). With
    ``refresh_ub=True`` ``need`` is the *maybe* mask of
    :func:`move_and_bounds` with ``refresh=False``, and the own-centroid
    distance is refreshed here, on the buffer only.

    Centroid level: where :func:`use_groups_decision` allows it
    (``use_groups=None`` applies the rule), each candidate's surviving
    groups go into a ``cap_g``-slot bucket and only those groups'
    centroids (``members``: (G, Lmax) int32, -1-padded) are scored. The
    bucket needs this pass's ``gmax`` (most surviving groups of any
    candidate) at most ``cap_g``; otherwise the pass spills to the dense
    branch, as the reference's ``lax.cond`` does. The branch is taken
    on the host: ``gmax`` is this pass's value as the caller already
    read it, and ``None`` reads it here (one host sync, only when the
    group branch is allowed).

    Returns full-size ``(assignments, ub, lb, n_pairs, gmax)``, the last
    two as device scalars."""
    n = points.shape[0]
    k = new_c.shape[0]
    idx, valid, _ = compact_indices(need, capacity=cap_n)
    idx = idx.long()
    cpts = points[idx]                                        # (cap, D)
    c_ub = ub_t[idx]
    c_lb = lb[idx]                                            # (cap, G)
    c_as = assignments[idx]
    if c2 is None:
        c2 = row_norms_sq(new_c)
    c_x2 = x2[idx] if x2 is not None else row_norms_sq(cpts)
    if refresh_ub:
        # invalid slots compute garbage that the scatter drops
        a = c_as.long()
        c_ub = torch.sqrt(torch.clamp_min(
            c_x2 - 2.0 * torch.sum(cpts * new_c[a], dim=-1) + c2[a], 0.0))
    gneed = (c_lb < c_ub[:, None]) & valid[:, None]           # (cap, G)
    gmax_t = gneed.sum(dim=1).max()
    # rows that still need distance work: the dense branch's count
    n_rows = gneed.any(dim=1).sum()

    if use_groups is None:
        use_groups = use_groups_decision(
            cap_n=cap_n, cap_g=cap_g, l_max=members.shape[1], k=k,
            chunk=chunk, group_gather_factor=group_gather_factor)
    if use_groups:
        use_groups = (int(gmax_t) if gmax is None else gmax) <= cap_g
    if use_groups:
        nas, nub, new_clb, pairs, chg = _group_branch(
            cpts, new_c, c_as, c_ub, c_lb, gneed, members, gsize,
            cap_g=cap_g, n_groups=n_groups, c_x2=c_x2, c2=c2)
    else:
        nas, nub, new_clb, pairs, chg = _dense_branch(
            cpts, new_c, c_as, c_ub, c_lb, gneed, n_rows, groups,
            n_groups=n_groups, c_x2=c_x2, c2=c2)
    new_clb = min_at(new_clb, groups.long()[c_as.long()],
                     torch.where(chg, c_ub, float("inf")))

    # scatter the survivors back; invalid slots go to the spare row
    rows = torch.where(valid, idx, n)
    return (_scatter_rows(assignments, rows, nas),
            _scatter_rows(ub_t, rows, nub),
            _scatter_rows(lb, rows, new_clb), pairs, gmax_t)


def pending_gmax(need, ub, lb):
    """Most surviving groups of any candidate of the pending pass, on
    the device: the ``gmax`` a compact pass over ``need`` will find
    when its bounds are final (the refresh ran in
    :func:`move_and_bounds`)."""
    return (need[:, None] & (lb < ub[:, None])).sum(dim=1).max()


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
    gmax: torch.Tensor        # int64 most surviving groups per candidate
                              # in the LAST executed pass (compact; else 0)
    gmax_next: torch.Tensor | None  # the same for the pending pass, where
                              # the body can know it (compact, refresh in
                              # move_and_bounds); else None
    shift: torch.Tensor       # f32 max centroid drift
    evals: torch.Tensor       # int64


@dataclasses.dataclass
class EngineStats:
    """Execution telemetry. ``host_syncs`` counts every host read of a
    device value: the group table fetch, one read of the exit scalars
    per loop iteration (a CUDA graph per body is a later step), and on
    the compact backend with ``refresh_in_pass`` one ``gmax`` read per
    pass that may take the group branch. ``caps_history`` lists the
    compact backend's (cap_n, cap_g) per segment, ``use_groups`` the
    group-gather decision beside it; ``x2_evals`` is the number of
    full-N norm computations per fit (one, carried in
    ``EngineCarry.x2``)."""
    backend: str = ""
    n_iters: int = 0
    host_syncs: int = 0
    bucket_switches: int = 0
    caps_history: list = dataclasses.field(default_factory=list)
    use_groups: list = dataclasses.field(default_factory=list)
    x2_evals: int = 0
    config: dict = dataclasses.field(default_factory=dict)
    n_points: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class PassCore:
    """The candidate-pass dispatch: the masked-dense oracle, the
    compact pass at the static ``cap_n``/``cap_g``, or the
    ``grouped_assign`` kernel. ``_loop_body`` pairs it with
    :func:`move_and_bounds`."""
    backend: str
    k: int
    n_groups: int
    tile_n: int = 256
    cap_n: int = 0                 # static caps (compact backend)
    cap_g: int = 0
    chunk: int = 2048
    group_gather_factor: int = 4
    down_n: int = 2
    down_g: int = 4
    refresh_in_pass: bool = False
    use_groups: bool | None = None

    @classmethod
    def from_config(cls, cfg: EngineConfig, *, backend: str, k: int,
                    n_groups: int, **kw) -> "PassCore":
        return cls(backend=backend, k=k, n_groups=n_groups,
                   tile_n=cfg.tile_n, chunk=cfg.chunk,
                   group_gather_factor=cfg.group_gather_factor,
                   down_n=cfg.down_n, down_g=cfg.down_g,
                   refresh_in_pass=cfg.refresh_in_pass, **kw)

    @property
    def refresh_in_move(self) -> bool:
        """Where the own-distance refresh runs: in
        :func:`move_and_bounds` unless the compact backend places it on
        its survivor buffer."""
        return not (self.backend == "compact" and self.refresh_in_pass)

    def candidate_pass(self, points, centroids, assignments, ub, lb, need,
                       groups, members, gsize, *, x2, c2, gmax=None):
        """``(assign, ub, lb, pairs, gmax)`` for the pending candidates;
        ``gmax`` is None but on the compact backend, where the argument
        is the pass's own ``gmax`` if the host already has it."""
        if self.backend == "oracle":
            return dense_candidate_pass(
                points, centroids, assignments, ub, lb, groups, need,
                n_groups=self.n_groups, x2=x2, c2=c2) + (None,)
        if self.backend == "compact":
            return compact_candidate_pass(
                points, centroids, assignments, ub, lb, groups, members,
                gsize, need, cap_n=self.cap_n, cap_g=self.cap_g,
                n_groups=self.n_groups, chunk=self.chunk,
                use_groups=self.use_groups, x2=x2, c2=c2,
                refresh_ub=self.refresh_in_pass,
                group_gather_factor=self.group_gather_factor, gmax=gmax)
        return kernel_candidate_pass(
            points, centroids, assignments, ub, lb, groups, members, gsize,
            need, tile_n=self.tile_n, x2=x2, c2=c2) + (None,)

    def reads_gmax(self, gmax_next) -> bool:
        """Whether a pass of this core reads its ``gmax`` to the host:
        it may take the group branch and the caller has no value."""
        return bool(self.use_groups) and gmax_next is None


def _loop_body(core: PassCore, points, weights, groups, members, gsize):
    """The pending candidate pass, then move + bound upkeep. ``gmax``
    is the pending pass's ``gmax`` as the host read it (compact), or
    None."""

    def body(c: EngineCarry, gmax: int | None = None) -> EngineCarry:
        new_as, new_ub, new_lb, pairs, pass_gmax = core.candidate_pass(
            points, c.centroids, c.assignments, c.ub, c.lb, c.need, groups,
            members, gsize, x2=c.x2, c2=c.c2, gmax=gmax)
        mv = move_and_bounds(points, c.centroids, new_as, new_ub, new_lb,
                             groups, k=core.k, n_groups=core.n_groups,
                             weights=weights, x2=c.x2,
                             refresh=core.refresh_in_move)
        gmax_next = None
        if core.backend == "compact" and core.refresh_in_move:
            gmax_next = pending_gmax(mv.need, mv.ub, mv.lb)
        return EngineCarry(
            c.iteration + 1, mv.centroids, mv.c2, new_as, mv.ub, mv.lb,
            c.x2, mv.need, c.gmax if pass_gmax is None else pass_gmax,
            gmax_next, mv.shift, c.evals + pairs + mv.tightened)

    return body


def _loop_cond(*, max_iters: int, tol: float, core: PassCore | None = None,
               min_cap: int = 0, allow_downshift: bool = False):
    """The loop condition on host copies of the exit scalars. Terminal
    exits for every backend: out of iterations, or converged (``tol``
    compared in fp32). The compact backend also exits when the pending
    candidates leave its bucket (``n_cand > cap_n``), when the last
    pass's ``gmax`` exceeded ``cap_g``, and, with ``allow_downshift``,
    when a strictly smaller bucket would do (the hysteresis
    ``down_n`` / ``down_g``; never on ``gmax == 0``)."""
    tol32 = _f32(tol)

    def cond(iteration: int, shift: float, n_cand: int = 0,
             gmax: int = 0) -> bool:
        active = iteration < max_iters and shift > tol32
        if core is None or core.backend != "compact":
            return active
        if not (active and n_cand <= core.cap_n and gmax <= core.cap_g):
            return False
        if allow_downshift:
            if core.down_n and n_cand * core.down_n <= core.cap_n \
                    and core.cap_n > min_cap:
                return False
            if core.down_g and gmax > 0 \
                    and gmax * core.down_g <= core.cap_g and core.cap_g > 1:
                return False
        return True

    return cond


def _epilogue_pass(core: PassCore, points, weights, carry: EngineCarry,
                   groups, members, gsize, gmax: int | None = None):
    """The final pending candidate pass + (weighted) inertia. Returns
    ``(assignments, evals, inertia)``."""
    new_as, _, _, pairs, _ = core.candidate_pass(
        points, carry.centroids, carry.assignments, carry.ub, carry.lb,
        carry.need, groups, members, gsize, x2=carry.x2, c2=carry.c2,
        gmax=gmax)
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
    zero = torch.zeros((), dtype=torch.int64, device=points.device)
    return EngineCarry(0, s0.centroids, c2, s0.assignments, s0.ub, s0.lb, x2,
                       torch.zeros((n,), dtype=torch.bool,
                                   device=points.device),
                       zero, zero, s0.shift, s0.distance_evals)


class _Exit(NamedTuple):
    """Host copies of the loop's exit scalars."""
    iteration: int
    shift: float
    n_cand: int
    gmax: int
    gmax_next: int | None


def _read_exit(carry: EngineCarry) -> _Exit:
    """``shift``, ``n_cand`` (the pending candidates, counted here: only
    the compact driver reads it), ``gmax`` (and ``gmax_next``) in one
    device-to-host transfer."""
    vals = [carry.shift.double(), carry.need.sum().double(),
            carry.gmax.double()]
    if carry.gmax_next is not None:
        vals.append(carry.gmax_next.double())
    got = torch.stack(vals).tolist()
    return _Exit(carry.iteration, got[0], int(got[1]), int(got[2]),
                 int(got[3]) if len(got) > 3 else None)


def _fit_compact(points, weights, carry: EngineCarry, groups, members, gsize,
                 *, cfg: EngineConfig, k: int, n_groups: int, max_iters: int,
                 tol: float, max_bucket_switches: int, stats: EngineStats):
    """The compact backend's bucketed driver (the reference's
    host-picked capacity segments). Returns ``(carry, epilogue core,
    epilogue gmax)``."""
    n = points.shape[0]
    cap_floor = min(cfg.min_cap, n)
    l_max = int(members.shape[1])
    ex = _Exit(0, float("inf"), 0, 0, 0)

    def core_at(cap_n, cap_g, l_rule):
        ug = use_groups_decision(
            cap_n=cap_n, cap_g=cap_g, l_max=l_rule, k=k, chunk=cfg.chunk,
            group_gather_factor=cfg.group_gather_factor)
        return PassCore.from_config(cfg, backend="compact", k=k,
                                    n_groups=n_groups, cap_n=cap_n,
                                    cap_g=cap_g, use_groups=ug)

    def segment(core, carry, ex, *, min_cap, allow_down):
        stats.caps_history.append((core.cap_n, core.cap_g))
        stats.use_groups.append(bool(core.use_groups))
        cond = _loop_cond(max_iters=max_iters, tol=tol, core=core,
                          min_cap=min_cap, allow_downshift=allow_down)
        body = _loop_body(core, points, weights, groups, members, gsize)
        while cond(ex.iteration, ex.shift, ex.n_cand, ex.gmax):
            stats.host_syncs += core.reads_gmax(ex.gmax_next)
            carry = body(carry, ex.gmax_next)
            ex = _read_exit(carry)
            stats.host_syncs += 1
        return carry, ex

    if n <= 4 * cap_floor:
        # the reference's fused small-problem path: one segment at full
        # capacity, its group table as wide as K (so no group branch)
        core = core_at(n, n_groups, k)
        carry, ex = segment(core, carry, ex, min_cap=0, allow_down=False)
        return carry, core, ex.gmax_next

    # start tiny: the first body's pending pass is empty, and the first
    # real candidate count exits the segment and picks the bucket
    cap_n, cap_g = cap_floor, 1
    while True:
        core = core_at(cap_n, cap_g, l_max)
        allow_down = stats.bucket_switches < max_bucket_switches
        carry, ex = segment(core, carry, ex, min_cap=cap_floor,
                            allow_down=allow_down)
        if ex.iteration >= max_iters or ex.shift <= tol:
            break
        stats.bucket_switches += 1
        if stats.bucket_switches >= max_bucket_switches:
            cap_n, cap_g = _bucket_cap(n, cap_floor, n), n_groups
        else:
            cap_n = _bucket_cap(ex.n_cand, cap_floor, n)
            # gmax == 0: no pass has run at this bucket yet (the probe);
            # guess every group rather than spend a segment finding out
            cap_g = _bucket_cap(ex.gmax, 1, n_groups) if ex.gmax > 0 \
                else n_groups
    ecore = core_at(_bucket_cap(ex.n_cand, cap_floor, n),
                    _bucket_cap(ex.gmax, 1, n_groups), l_max)
    return carry, ecore, ex.gmax_next


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


def _resolve_config(*, backend, tile_n, min_cap, chunk, config, tune, n, k):
    """``(config, resolved_backend)``: explicit ``tile_n``/``min_cap``/
    ``chunk`` > ``config`` > defaults (the port has no tuning cache
    yet). The caller's backend wins unless it is ``"auto"``."""
    if tune not in ("auto", "off"):
        if tune == "force":
            raise NotImplementedError(
                "tune='force' is not ported yet: ROADMAP Queue 1 item 5 "
                "(autotuning)")
        raise ValueError(f"unknown tune mode {tune!r}")
    cfg = DEFAULT_CONFIG if config is None else config
    over = {name: int(v) for name, v in (("tile_n", tile_n),
                                         ("min_cap", min_cap),
                                         ("chunk", chunk)) if v is not None}
    if over:
        cfg = cfg.replace(**over)
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
        tile_n: int | None = None, min_cap: int | None = None,
        chunk: int | None = None, max_bucket_switches: int = 32,
        config: EngineConfig | None = None, tune: str = "auto",
        sample_weight=None, return_stats: bool = False, device=None):
    """Filtered K-means on ``device`` (default ``cuda``; raises when it
    is not there). ``sample_weight`` enters the centroid sums and the
    inertia only; uniform weights of 1.0 are bit-identical to ``None``.
    ``min_cap``, ``chunk`` and ``max_bucket_switches`` shape the compact
    backend's buckets, as in the reference.

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
                                   min_cap=min_cap, chunk=chunk,
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
    stats.x2_evals = 1

    groups = group_centroids(init_c, n_groups)
    members, gsize = build_group_tables(groups.cpu().numpy(), n_groups, dev)
    stats.host_syncs += 1
    carry = _init_carry(points, init_c, groups, n_groups=n_groups)

    if backend == "compact":
        carry, core, gmax = _fit_compact(
            points, weights, carry, groups, members, gsize, cfg=cfg, k=k,
            n_groups=n_groups, max_iters=int(max_iters), tol=float(tol),
            max_bucket_switches=int(max_bucket_switches), stats=stats)
        stats.host_syncs += core.reads_gmax(gmax)
    else:
        core = PassCore.from_config(cfg, backend=backend, k=k,
                                    n_groups=n_groups)
        cond = _loop_cond(max_iters=int(max_iters), tol=float(tol))
        body = _loop_body(core, points, weights, groups, members, gsize)
        shift = float("inf")
        while cond(carry.iteration, shift):
            carry = body(carry)
            shift = float(carry.shift)      # the per-iteration host sync
            stats.host_syncs += 1
        gmax = None
    stats.n_iters = carry.iteration

    assignments, evals, inertia = _epilogue_pass(
        core, points, weights, carry, groups, members, gsize, gmax)
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
        nas, nub, _, _, _ = core.candidate_pass(
            part, centroids, a0, ub, lb, need, groups, members, gsize,
            x2=row_norms_sq(part), c2=c2)
        labels.append(nas)
        dists.append(nub)
    return torch.cat(labels), torch.cat(dists)
