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

A fifth pass realisation, ``"ladder"`` (the compact pass at a level of
a fixed capacity lattice, :func:`cap_ladders`, each rank picking its
level on the host with :func:`select_bucket`), runs only inside
:func:`fit_core`, the sharded fit's body
(:mod:`repro_torch.core.distributed`); ``fit`` refuses it, as the
reference's does. The only thing that differs between a local and a
sharded fit is the :class:`Reducer` that joins the per-rank centroid
partial sums and the exit counters: the identity locally, a
``torch.distributed`` all-reduce in the sharded fit.

The loop keeps the reference's split structure: the initial pending
candidate pass is empty, each body runs the pending candidate pass and
then :func:`move_and_bounds`, and one epilogue pass follows the loop, so
``n_iters`` and ``distance_evals`` come out as in JAX. PyTorch has no
``while_loop``: the host reads the loop's exit scalars once per
iteration (``shift``; on the compact backend ``shift``, ``n_cand`` and
``gmax`` in one transfer) and applies the reference's exit rules to
them. :class:`EngineStats` counts every such read in ``host_syncs``.

Observability (``fit(obs=...)``, :mod:`repro_torch.obs`): the fit, its
init, the loop body's phases, each host read and the epilogue run inside
``kpynq/*`` spans (:func:`repro_torch.obs.trace.phase`), and with obs on
it writes one row per iteration into a float64 telemetry ring on the
device, drained once at fit exit. Tuning (``fit(tune=...)``,
:mod:`repro_torch.tune`): a per-(card, N, K, D) cache of measured
:class:`EngineConfig` winners. The serve-side batched assign
(:func:`make_serve_assign`) is what :mod:`repro_torch.serve` runs.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels as _kernels
from ..device import as_float32, resolve_device
from ..kernels import compact_indices
from ..obs import ring as _obs_ring
from ..obs.metrics import normalize_obs
from ..obs.ring import (COL_CAP_G, COL_CAP_N, COL_EVALS, COL_GMAX,
                        COL_INERTIA, COL_N_CAND, COL_SHIFT, COL_TIGHTENED,
                        N_COUNTERS, RING_COLUMNS)
from ..obs.trace import phase
from .distances import (_check_fp32_matmul, pairwise_sq_dists, row_norms_sq,
                        rowwise_dists)
from .kmeans import (KMeansResult, _f32, _init_filter_state, centroid_sums,
                     centroids_from_sums, group_centroids, lloyd, min_at,
                     segment_max, segment_min_cols)

BACKENDS = ("oracle", "compact", "kernel")
ALIASES = {"pallas": "kernel"}

# backend="auto" routes n*k at or below this to the dense Lloyd loop
AUTO_LLOYD_MAX_WORK = 1 << 17


def _backend_name(backend: str) -> str:
    backend = ALIASES.get(backend, backend)
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


# --------------------------------------------------------------------------
# the collective: identity locally, an all-reduce in the sharded fit
# --------------------------------------------------------------------------

def _all_reduce(x, group, op=None):
    """``x`` reduced over ``group`` by ``op`` (default SUM), every rank
    getting the same bits. Under ``gloo`` a CUDA tensor goes through the
    host: the reduction runs on a CPU copy."""
    import torch.distributed as dist
    op = dist.ReduceOp.SUM if op is None else op
    if x.is_cuda and dist.get_backend(group) == "gloo":
        host = x.cpu()
        dist.all_reduce(host, op=op, group=group)
        return host.to(x.device)
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


@dataclasses.dataclass(frozen=True)
class Reducer:
    """Which collective joins the per-rank centroid partial sums and the
    exit counters: the only thing that differs between the local fit
    (``group=None``, the identity) and the sharded fit (a
    ``torch.distributed`` process group, the ranks of one mesh axis).

    ``compress=True`` int8-compresses the (K, D) partial sums only
    (:meth:`sums`): each rank quantises its own sums with its own absmax
    scale and the ranks all-reduce the dequantised fp32. Counts, evals
    and inertia always reduce exactly (:meth:`add`)."""
    group: object = None
    compress: bool = False

    @property
    def is_local(self) -> bool:
        return self.group is None

    def sums(self, x):
        """The (K, D) partial sums, SUM-reduced (int8 with
        ``compress``; no error feedback: the relative error, about
        1/127, corrects itself over the iterations)."""
        if self.group is None:
            return x
        if self.compress:
            from ..optim.compression import dequantize_int8, quantize_int8
            x = dequantize_int8(*quantize_int8(x))
        return _all_reduce(x, self.group)

    def add(self, x):
        """Exact SUM (counts, int64 eval counters, inertia)."""
        return x if self.group is None else _all_reduce(x, self.group)

    def max(self, x):
        """MAX (candidate counts, group high-waters)."""
        if self.group is None:
            return x
        import torch.distributed as dist
        return _all_reduce(x, self.group, dist.ReduceOp.MAX)


LOCAL_REDUCER = Reducer()


@dataclasses.dataclass(frozen=True)
class ConvergenceUpdate:
    """Batch-fit centroid rule: mean of the sums; an empty cluster keeps
    its centroid. ``clamp_gdrift`` stays False: an empty group's max
    drift stays ``-inf``, which the bound decay turns into a vacuous
    (+inf) lower bound. ``carry_counts`` and ``decay`` are unused."""
    clamp_gdrift: bool = False

    def apply(self, sums, counts, centroids, carry_counts, decay):
        return centroids_from_sums(sums, counts, centroids), counts


@dataclasses.dataclass(frozen=True)
class EMAUpdate:
    """Streaming centroid rule, the decayed count-weighted EMA
    ``c <- (decay * n_c * c + sum_batch) / (decay * n_c + b_c)``:
    ``decay=1`` is pure count-weighting (a per-centroid 1/n learning
    rate), ``decay<1`` caps the memory at about 1/(1-decay) batches.
    ``clamp_gdrift=True``: an empty group's ``-inf`` drift would poison
    the caller's cumulative drift ledger (inf - inf = NaN on the next
    inflation)."""
    clamp_gdrift: bool = True

    def apply(self, sums, counts, centroids, carry_counts, decay):
        dec = carry_counts * decay
        new_counts = dec + counts
        tot = dec[:, None] * centroids + sums
        # fractional decayed counts: an epsilon guard, not the batch
        # fit's max(counts, 1), which assumes integer counts
        new_c = torch.where(new_counts[:, None] > 1e-6,
                            tot / torch.clamp_min(new_counts, 1e-6)[:, None],
                            centroids)
        return new_c, new_counts


CONVERGENCE_UPDATE = ConvergenceUpdate()
EMA_UPDATE = EMAUpdate()


class MoveOut(NamedTuple):
    """What :func:`move_and_bounds` produces. The batch drivers read the
    centroids, norms, bounds, ``need``, ``shift`` and ``tightened``; the
    streaming step also reads ``counts`` (the carried effective counts
    after the EMA), ``drift``/``gdrift`` (for the host drift ledger) and
    ``batch_counts`` (this pass's weighted mass a centroid, pre-EMA)."""
    centroids: torch.Tensor    # (K, D) after the update rule
    c2: torch.Tensor           # (K,) ||centroids||^2, once per iteration
    counts: torch.Tensor       # (K,) rule-dependent carried counts
    ub: torch.Tensor           # (N,) drift-inflated, refreshed
    lb: torch.Tensor           # (N, G) drift-decayed
    need: torch.Tensor         # (N,) pending candidate mask
    shift: torch.Tensor        # f32 max centroid drift
    tightened: torch.Tensor    # int64 own-distance refreshes
    drift: torch.Tensor        # (K,)
    gdrift: torch.Tensor       # (G,)
    batch_counts: torch.Tensor  # (K,) this pass's weighted mass


# --------------------------------------------------------------------------
# the iteration
# --------------------------------------------------------------------------

def move_and_bounds(points, centroids, assignments, ub, lb, groups, *,
                    k: int, n_groups: int, reducer: Reducer = LOCAL_REDUCER,
                    update=CONVERGENCE_UPDATE, counts=None, decay=None,
                    weights=None, x2=None, refresh: bool = True) -> MoveOut:
    """Centroid move + triangle-inequality bound upkeep + the point-level
    filter, shared by the batch drivers, the sharded fit and the
    streaming step.

    ``reducer`` joins the per-rank partial sums and counts right after
    :func:`centroid_sums` (the identity locally), so the drift, ``shift``
    and the new centroids are the same on every rank.

    ``update``: :data:`CONVERGENCE_UPDATE` (batch mean) or
    :data:`EMA_UPDATE` (the streaming EMA, which needs the carried
    ``counts`` and ``decay``). With ``update.clamp_gdrift`` an empty
    group's drift is 0, not ``-inf``.

    ``refresh=False`` (the compact backend's in-pass placement, and the
    streaming step, whose refresh belongs to the next visit's
    :func:`stream_bounds`) skips the own-distance refresh: the returned
    ``ub`` is the drift-inflated bound and ``need`` the *maybe* mask.
    ``tightened`` counts the *maybe* rows either way.

    The bounds' upkeep and the refresh after the drift are one call,
    :func:`repro_torch.kernels.bounds_upkeep`: one kernel on the card,
    the plain version on the CPU."""
    sums, bcounts = centroid_sums(points, assignments, k, weights=weights)
    if not reducer.is_local:
        with phase("kpynq/reduce", points.is_cuda):
            sums = reducer.sums(sums)
            bcounts = reducer.add(bcounts)
    new_c, new_counts = update.apply(sums, bcounts, centroids, counts, decay)
    new_c2 = row_norms_sq(new_c)
    drift = torch.sqrt(torch.sum((new_c - centroids) ** 2, dim=-1))
    group_drift = segment_max(drift, groups, n_groups)
    if update.clamp_gdrift:
        group_drift = torch.clamp_min(group_drift, 0.0)
    shift = torch.max(drift)
    ub_t, lb_dec, need, tightened = _kernels.bounds_upkeep(
        points, x2, new_c, new_c2, assignments, ub, lb, drift, group_drift,
        refresh=refresh)
    return MoveOut(new_c, new_c2, new_counts, ub_t, lb_dec, need, shift,
                   tightened, drift, group_drift, bcounts)


def _left_at(changed, new_assign, old_assign, ub_t):
    """The bound a point that left centroid b puts back into b's group's
    pool: its exact distance ``ub_t`` to b (a skipped group's decayed
    ``lb`` may exceed it), +inf where the point stayed.

    The reference caps wherever ``changed`` (``best_d < ub_t``). That
    also fires where the best candidate is the point's own centroid and
    the pass's product rounds its distance below the refresh's: the cap
    then pins the own group's bound at the point's own distance, and the
    point stays a candidate for the rest of the fit. Here the cap needs
    the point to have moved, which in exact arithmetic is what
    ``changed`` means (ROADMAP Queue 3 item 1)."""
    moved = changed & (new_assign != old_assign)
    return torch.where(moved, ub_t, float("inf"))


def _finish_pass(best_d, best_id, lb_comp, assignments, ub_t, lb, groups,
                 group_need):
    """The candidate passes' shared tail: reassign, tighten ``ub``,
    refresh the computed groups' ``lb`` and cap the old group's."""
    a = assignments.long()
    changed = best_d < ub_t
    new_assign = torch.where(changed, best_id.long(), a)
    new_ub = torch.minimum(ub_t, best_d)
    new_lb = torch.where(group_need, lb_comp, lb)
    new_lb = min_at(new_lb, groups.long()[a],
                    _left_at(changed, new_assign, a, ub_t))
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
    d_cand.scatter_(1, new_a[:, None], float("inf"))            # in place
    lb_comp = torch.sqrt(segment_min_cols(d_cand, groups, n_groups))
    out = _finish_pass(best_d, best, lb_comp, assignments, ub_t, lb, groups,
                       group_need)
    return out + (pairs,)


def kernel_candidate_pass(points, new_c, assignments, ub_t, lb, groups,
                          members, gsize, need, *, tile_n: int = 256,
                          x2=None, c2=None):
    """Candidate pass through the ``grouped_assign`` kernel (port of
    ``pallas_candidate_pass``): the group filter's block mask
    (``kernels.candidate_mask``), the kernel, then the reassignment and
    the bounds (``kernels.candidate_tail``). The pair count is
    ``tile_n * sum(mask * gsize)``, pad rows of the tail tile included,
    as the reference counts it."""
    mask = _kernels.candidate_mask(need, lb, ub_t, tile_n=tile_n)  # (gn, G)
    mem_s = members.clamp_min(0).long()
    c_grouped = new_c[mem_s].contiguous()                   # (G, Lmax, D)
    c2g = None if c2 is None else c2[mem_s].contiguous()
    best2, idx, gmin, garg, gmin2 = _kernels.grouped_assign(
        points, c_grouped, members, mask.contiguous(), tile_n=tile_n,
        x2=x2, c2g=c2g)
    out = _kernels.candidate_tail(best2, idx, gmin, garg, gmin2, assignments,
                                  ub_t, lb, need, groups)
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
    d_cand.scatter_(1, nas[:, None], float("inf"))               # in place
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
        # invalid slots compute garbage that the scatter drops; the
        # refresh in the move's order, so both placements agree in bits
        c_ub = _kernels.own_dists(cpts, c_x2, new_c, c2, c_as)
    gneed = (c_lb < c_ub[:, None]) & valid[:, None]           # (cap, G)
    gmax_t = gneed.sum(dim=1).max()
    # rows that still need distance work: the dense branch's count
    n_rows = gneed.any(dim=1).sum()

    if use_groups is None:
        use_groups = use_groups_decision(
            cap_n=cap_n, cap_g=cap_g, l_max=members.shape[1], k=k,
            chunk=chunk, group_gather_factor=group_gather_factor)
    if use_groups and gmax is None:
        with phase("kpynq/host_read", points.is_cuda):
            gmax = int(gmax_t)
    if use_groups:
        use_groups = gmax <= cap_g
    if use_groups:
        nas, nub, new_clb, pairs, chg = _group_branch(
            cpts, new_c, c_as, c_ub, c_lb, gneed, members, gsize,
            cap_g=cap_g, n_groups=n_groups, c_x2=c_x2, c2=c2)
    else:
        nas, nub, new_clb, pairs, chg = _dense_branch(
            cpts, new_c, c_as, c_ub, c_lb, gneed, n_rows, groups,
            n_groups=n_groups, c_x2=c_x2, c2=c2)
    new_clb = min_at(new_clb, groups.long()[c_as.long()],
                     _left_at(chg, nas, c_as, c_ub))

    # scatter the survivors back; invalid slots go to the spare row
    rows = torch.where(valid, idx, n)
    return (_scatter_rows(assignments, rows, nas),
            _scatter_rows(ub_t, rows, nub),
            _scatter_rows(lb, rows, new_clb), pairs, gmax_t)


def cap_ladders(n: int, n_groups: int, *, min_cap: int = 256,
                max_branches: int = 12):
    """The fixed (cap_n, cap_g) lattices of the ladder backend: the
    engine's power-of-two lattice from ``min_cap`` up to the shard size
    (resp. 1 up to ``n_groups``), coarsened until the product of their
    lengths fits ``max_branches``: interior levels go first, then (only
    under a budget too small for 2x2 ladders) the low ends. The top
    levels are never dropped, so ``cap_ns[-1] == n`` and the mandatory
    upshift of :func:`select_bucket` can always cover the candidates."""
    n = max(int(n), 1)
    n_groups = max(int(n_groups), 1)
    cap_ns, c = [], min(_bucket_cap(min_cap, 1, n), n)
    while c < n:
        cap_ns.append(c)
        c *= 2
    cap_ns.append(n)
    cap_gs, g = [], 1
    while g < n_groups:
        cap_gs.append(g)
        g *= 2
    cap_gs.append(n_groups)
    while len(cap_ns) * len(cap_gs) > max(int(max_branches), 1):
        if len(cap_gs) > 2 and len(cap_gs) >= len(cap_ns):
            del cap_gs[len(cap_gs) // 2]
        elif len(cap_ns) > 2:
            del cap_ns[len(cap_ns) // 2]
        elif len(cap_gs) > 1:
            del cap_gs[0]
        elif len(cap_ns) > 1:
            del cap_ns[0]
        else:
            break
    return tuple(cap_ns), tuple(cap_gs)


def select_bucket(n_cand: int, gmax: int, level_n: int, level_g: int, *,
                  cap_ns, cap_gs, down_n: int = 2, down_g: int = 4):
    """A rank's next ``(level_n, level_g)`` on the ladder, on host ints
    (the reference decides the same inside its traced loop). Upshifts
    are mandatory the moment the pending candidate count (or the last
    pass's surviving-group high-water) leaves its level; downshifts fire
    only past the hysteresis ``down_n`` / ``down_g`` (0 disables that
    axis), and never on ``gmax == 0``, which means no candidate was
    seen, not that one group slot is enough."""
    req_n = min(bisect.bisect_left(cap_ns, n_cand), len(cap_ns) - 1)
    move = req_n > level_n or bool(
        down_n and req_n < level_n and n_cand * down_n <= cap_ns[level_n])
    req_g = min(bisect.bisect_left(cap_gs, max(gmax, 1)), len(cap_gs) - 1)
    move_g = req_g > level_g or bool(
        down_g and gmax > 0 and req_g < level_g
        and gmax * down_g <= cap_gs[level_g])
    return (req_n if move else level_n), (req_g if move_g else level_g)


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
    ring: torch.Tensor | None = None  # (ring_iters, N_COUNTERS) float64
                              # telemetry ring (repro_torch.obs.ring),
                              # written in place; None when obs is off


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
    ``EngineCarry.x2``).

    With observability on (``fit(obs=...)``) the stats carry the
    drained telemetry ring: ``ring`` is the trimmed ``(n_iters + 1, C)``
    float64 numpy buffer (column layout ``ring_columns`` =
    :data:`repro_torch.obs.ring.RING_COLUMNS`; final row = epilogue),
    ``init_evals`` the distance evals charged at filter-state init, so
    ``init_evals + ring[:, evals].sum() == result.distance_evals``
    exactly. A sharded fit (:mod:`repro_torch.core.distributed`)
    reduces the ranks' rings into ``ring`` and also keeps the gathered
    per-rank ``shard_rings`` (S, R, C) and the per-iteration work skew
    ``shard_skew``; they stay None on one device."""
    backend: str = ""
    n_iters: int = 0
    host_syncs: int = 0
    bucket_switches: int = 0
    caps_history: list = dataclasses.field(default_factory=list)
    use_groups: list = dataclasses.field(default_factory=list)
    x2_evals: int = 0
    config: dict = dataclasses.field(default_factory=dict)
    n_points: int = 0
    ring: np.ndarray | None = None
    ring_columns: tuple = RING_COLUMNS
    init_evals: float = 0.0
    shard_rings: np.ndarray | None = None
    shard_skew: np.ndarray | None = None

    def telemetry(self) -> dict | None:
        """Headline ring summary (iters, mean candidate fraction, total
        evals, ...); ``None`` when the fit ran without the ring."""
        if self.ring is None:
            return None
        out = _obs_ring.summarize_ring(self.ring, self.n_points,
                                       init_evals=self.init_evals)
        if self.shard_skew is not None and len(self.shard_skew):
            out["mean_shard_skew"] = float(np.mean(self.shard_skew))
            out["max_shard_skew"] = float(np.max(self.shard_skew))
        return out

    def to_dict(self) -> dict:
        """JSON-serialisable view (numpy rings -> nested lists), for
        event logs and measurement records."""
        out = {
            "backend": self.backend,
            "n_iters": int(self.n_iters),
            "host_syncs": int(self.host_syncs),
            "bucket_switches": int(self.bucket_switches),
            "caps_history": [list(c) for c in self.caps_history],
            "use_groups": [bool(u) for u in self.use_groups],
            "x2_evals": int(self.x2_evals),
            "config": dict(self.config),
            "n_points": int(self.n_points),
        }
        if self.ring is not None:
            out["ring_columns"] = list(self.ring_columns)
            out["ring"] = np.asarray(self.ring, np.float64).tolist()
            out["init_evals"] = float(self.init_evals)
            out["telemetry"] = self.telemetry()
        if self.shard_skew is not None:
            out["shard_skew"] = np.asarray(
                self.shard_skew, np.float64).tolist()
        return out


@dataclasses.dataclass(frozen=True)
class PassCore:
    """The candidate-pass dispatch: the masked-dense oracle, the
    compact pass at the static ``cap_n``/``cap_g``, or the
    ``grouped_assign`` kernel; the ``ladder`` backend is the compact
    pass at a level of ``cap_ns`` x ``cap_gs`` (:meth:`at_level`).
    ``_loop_body`` pairs it with :func:`move_and_bounds` through
    ``reducer``."""
    backend: str
    k: int
    n_groups: int
    reducer: Reducer = LOCAL_REDUCER
    tile_n: int = 256
    cap_n: int = 0                 # static caps (compact backend)
    cap_g: int = 0
    cap_ns: tuple = ()             # capacity lattice (ladder backend)
    cap_gs: tuple = ()
    chunk: int = 2048
    group_gather_factor: int = 4
    down_n: int = 2
    down_g: int = 4
    refresh_in_pass: bool = False
    use_groups: bool | None = None
    # telemetry-ring rows carried through the loop (0 = ring off; the
    # driver sets max_iters + 1 so the epilogue gets the last row), and
    # whether each row is handed to the ring listeners as the loop's
    # exit read brings it home. Never feeds back into the fit.
    ring_iters: int = 0
    live_drain: bool = False

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
        return not (self.backend in ("compact", "ladder")
                    and self.refresh_in_pass)

    def at_level(self, level_n: int, level_g: int, l_max: int) -> "PassCore":
        """The ladder's compact core at ``(cap_ns[level_n],
        cap_gs[level_g])``, its group-gather decision taken by
        :func:`use_groups_decision` for the table's ``l_max``, as the
        reference decides it per branch."""
        cap_n, cap_g = self.cap_ns[level_n], self.cap_gs[level_g]
        return dataclasses.replace(
            self, backend="compact", cap_n=cap_n, cap_g=cap_g, cap_ns=(),
            cap_gs=(), use_groups=use_groups_decision(
                cap_n=cap_n, cap_g=cap_g, l_max=l_max, k=self.k,
                chunk=self.chunk,
                group_gather_factor=self.group_gather_factor))

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


def _ring_caps(core: PassCore, n: int):
    """The (cap_n, cap_g) the candidate pass ran at, as ring values: the
    static caps on the compact backend, (N, G) for the kernel and
    oracle passes, which do not compact."""
    if core.backend == "compact":
        return core.cap_n, core.cap_g
    return n, core.n_groups


def _write_ring_row(ring, it: int, caps, *, n_cand, gmax, shift, evals,
                    inertia, tightened) -> None:
    """Row ``it`` of the float64 ring, written in place column by column
    from device scalars (each a copy kernel; no host read). ``gmax``
    None leaves the column at its 0."""
    row = ring[it]
    row[COL_N_CAND] = n_cand
    if gmax is not None:
        row[COL_GMAX] = gmax
    row[COL_SHIFT] = shift
    row[COL_EVALS] = evals
    row[COL_CAP_N] = float(caps[0])
    row[COL_CAP_G] = float(caps[1])
    row[COL_INERTIA] = inertia
    row[COL_TIGHTENED] = tightened


def _loop_body(core: PassCore, points, weights, groups, members, gsize):
    """The pending candidate pass, then move + bound upkeep, each in its
    ``kpynq/*`` profiler range. ``gmax`` is the pending pass's ``gmax``
    as the host read it (compact), or None.

    With ``core.ring_iters > 0`` each body also writes one row of the
    telemetry ring (:mod:`repro_torch.obs.ring` layout) at its
    iteration index, in place on the device: no host traffic."""
    on_card = points.is_cuda

    def body(c: EngineCarry, gmax: int | None = None) -> EngineCarry:
        with phase("kpynq/candidate_pass", on_card):
            new_as, new_ub, new_lb, pairs, pass_gmax = core.candidate_pass(
                points, c.centroids, c.assignments, c.ub, c.lb, c.need,
                groups, members, gsize, x2=c.x2, c2=c.c2, gmax=gmax)
        with phase("kpynq/move_and_bounds", on_card):
            mv = move_and_bounds(points, c.centroids, new_as, new_ub,
                                 new_lb, groups, k=core.k,
                                 n_groups=core.n_groups,
                                 reducer=core.reducer, weights=weights,
                                 x2=c.x2, refresh=core.refresh_in_move)
            gmax_next = None
            if core.backend == "compact" and core.refresh_in_move:
                gmax_next = pending_gmax(mv.need, mv.ub, mv.lb)
        if core.ring_iters:
            with phase("kpynq/ring_write", on_card):
                proxy = mv.ub * mv.ub
                if weights is not None:
                    proxy = proxy * weights
                _write_ring_row(
                    c.ring, c.iteration, _ring_caps(core, points.shape[0]),
                    n_cand=mv.need.sum(), gmax=pass_gmax, shift=mv.shift,
                    evals=pairs + mv.tightened, inertia=torch.sum(proxy),
                    tightened=mv.tightened)
        return EngineCarry(
            c.iteration + 1, mv.centroids, mv.c2, new_as, mv.ub, mv.lb,
            c.x2, mv.need, c.gmax if pass_gmax is None else pass_gmax,
            gmax_next, mv.shift, c.evals + pairs + mv.tightened, c.ring)

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
    ``(assignments, evals, inertia)``, the last two reduced through
    ``core.reducer``. With the ring on, its row ``carry.iteration`` gets the
    epilogue pass's evals and, in the inertia-proxy column, the EXACT
    inertia (this rank's, before the reduction)."""
    on_card = points.is_cuda
    with phase("kpynq/candidate_pass", on_card):
        new_as, _, _, pairs, _ = core.candidate_pass(
            points, carry.centroids, carry.assignments, carry.ub, carry.lb,
            carry.need, groups, members, gsize, x2=carry.x2, c2=carry.c2,
            gmax=gmax)
    d = rowwise_dists(points, carry.centroids[new_as.long()])
    d2 = d * d
    if weights is not None:
        d2 = d2 * weights
    inertia = torch.sum(d2)
    if core.ring_iters:
        with phase("kpynq/ring_write", on_card):
            _write_ring_row(
                carry.ring, carry.iteration,
                _ring_caps(core, points.shape[0]),
                n_cand=carry.need.sum(), gmax=carry.gmax,
                shift=carry.shift, evals=pairs, inertia=inertia,
                tightened=0.0)
    return (new_as, core.reducer.add(carry.evals + pairs),
            core.reducer.add(inertia))


def _init_carry(points, init_c, groups, *, n_groups: int,
                ring_iters: int = 0) -> EngineCarry:
    """Point norms (THE once-per-fit ``||x||^2``), the initial filter
    state, and an empty pending pass. ``ring_iters`` sizes the float64
    telemetry ring (0 = off, no ring)."""
    n = points.shape[0]
    dev = points.device
    x2 = row_norms_sq(points)
    c2 = row_norms_sq(init_c)
    s0 = _init_filter_state(points, init_c, groups, n_groups, x2=x2, c2=c2)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    ring = torch.zeros((ring_iters, N_COUNTERS), dtype=torch.float64,
                       device=dev) if ring_iters else None
    return EngineCarry(0, s0.centroids, c2, s0.assignments, s0.ub, s0.lb, x2,
                       torch.zeros((n,), dtype=torch.bool, device=dev),
                       zero, zero, s0.shift, s0.distance_evals, ring)


class _Exit(NamedTuple):
    """Host copies of the loop's exit scalars."""
    iteration: int
    shift: float
    n_cand: int
    gmax: int
    gmax_next: int | None


def _fetch(carry: EngineCarry, vals: list, live: bool) -> list:
    """The float64 device scalars ``vals`` in one device-to-host
    transfer. ``live`` (``ObsConfig.live_drain``): the ring row the last
    body wrote rides the same transfer and goes to the ring listeners."""
    got = torch.stack(vals)
    if live:
        got = torch.cat([got, carry.ring[carry.iteration - 1]])
    with phase("kpynq/host_read", got.is_cuda):
        got = got.tolist()
    if live:
        _obs_ring.emit_ring_row(carry.iteration - 1, got[len(vals):])
    return got[:len(vals)]


def _read_exit(carry: EngineCarry, live: bool = False) -> _Exit:
    """``shift``, ``n_cand`` (the pending candidates, counted here: only
    the compact driver reads it), ``gmax`` (and ``gmax_next``) in one
    device-to-host transfer (:func:`_fetch`)."""
    vals = [carry.shift.double(), carry.need.sum().double(),
            carry.gmax.double()]
    if carry.gmax_next is not None:
        vals.append(carry.gmax_next.double())
    got = _fetch(carry, vals, live)
    return _Exit(carry.iteration, got[0], int(got[1]), int(got[2]),
                 int(got[3]) if len(got) > 3 else None)


def _fit_compact(points, weights, carry: EngineCarry, groups, members, gsize,
                 *, cfg: EngineConfig, k: int, n_groups: int, max_iters: int,
                 tol: float, max_bucket_switches: int, stats: EngineStats,
                 ring_iters: int = 0, live_drain: bool = False):
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
                                    cap_g=cap_g, use_groups=ug,
                                    ring_iters=ring_iters,
                                    live_drain=live_drain)

    def segment(core, carry, ex, *, min_cap, allow_down):
        stats.caps_history.append((core.cap_n, core.cap_g))
        stats.use_groups.append(bool(core.use_groups))
        cond = _loop_cond(max_iters=max_iters, tol=tol, core=core,
                          min_cap=min_cap, allow_downshift=allow_down)
        body = _loop_body(core, points, weights, groups, members, gsize)
        while cond(ex.iteration, ex.shift, ex.n_cand, ex.gmax):
            stats.host_syncs += core.reads_gmax(ex.gmax_next)
            carry = body(carry, ex.gmax_next)
            ex = _read_exit(carry, live_drain)
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


def fit_core(points, init_c, groups, members, gsize, *, core: PassCore,
             max_iters: int, tol: float, weights=None, valid=None,
             stats: EngineStats | None = None):
    """The whole fit on one rank's rows, with no segments: init, the
    loop of :func:`_loop_body` on the ``oracle`` (dense) or ``ladder``
    core, and the epilogue, every reduction through ``core.reducer``
    (the sharded fit's body; reference ``engine.fit_core``).

    ``valid`` masks the sentinel rows that pad an uneven sharded fit:
    they carry assignment K - 1 (the centroid JAX's clamped gathers read
    for its sentinel label K) with weight 0, so they add nothing to any
    sum, count or cost, and ``ub`` 0 and ``lb`` +inf, so they never
    become candidates; their K initial distances are taken back out of
    the evals, and they leave with assignment K, as JAX's do. The loop
    exits on the iteration count and the REDUCED ``shift`` only, which
    every rank holds in the same bits, so the ranks issue the same
    collectives in the same order. The ladder level is each rank's own:
    :func:`select_bucket` picks it on the host from the pending
    candidate count and the last pass's ``gmax``, read in the
    iteration's one exit transfer (:func:`_read_exit`) together with the
    pending pass's ``gmax`` where the refresh ran in
    :func:`move_and_bounds`; it never gates a collective.

    Returns ``(centroids, assignments, n_iters, evals, inertia, ring)``:
    ``evals`` and ``inertia`` reduced, ``assignments`` this rank's rows
    (K at the sentinels), ``ring`` this rank's ``(core.ring_iters, C)``
    telemetry ring or None. ``stats`` (optional) counts the host
    syncs."""
    k = core.k
    carry = _init_carry(points, init_c, groups, n_groups=core.n_groups,
                        ring_iters=core.ring_iters)
    if valid is not None:
        carry = carry._replace(
            assignments=torch.where(valid, carry.assignments, k - 1).int(),
            ub=torch.where(valid, carry.ub, 0.0),
            lb=torch.where(valid[:, None], carry.lb, float("inf")),
            evals=carry.evals - (~valid).sum() * k)
        weights = valid.float() if weights is None else \
            torch.where(valid, weights, 0.0)
    ladder = core.backend == "ladder"
    l_max = int(members.shape[1])
    level_n = level_g = 0
    pcore = core.at_level(0, 0, l_max) if ladder else core
    cond = _loop_cond(max_iters=max_iters, tol=tol)
    # the first pending pass is empty: its gmax is 0
    ex = _Exit(0, float("inf"), 0, 0, 0)
    syncs = 0
    while cond(ex.iteration, ex.shift):
        syncs += pcore.reads_gmax(ex.gmax_next)
        body = _loop_body(pcore, points, weights, groups, members, gsize)
        carry = body(carry, ex.gmax_next)
        ex = _read_exit(carry, core.live_drain)
        syncs += 1
        if ladder:
            level_n, level_g = select_bucket(
                ex.n_cand, ex.gmax, level_n, level_g, cap_ns=core.cap_ns,
                cap_gs=core.cap_gs, down_n=core.down_n, down_g=core.down_g)
            pcore = core.at_level(level_n, level_g, l_max)
    syncs += pcore.reads_gmax(ex.gmax_next)
    if stats is not None:
        stats.host_syncs += syncs
    assignments, evals, inertia = _epilogue_pass(
        pcore, points, weights, carry, groups, members, gsize, ex.gmax_next)
    if valid is not None:
        assignments = torch.where(valid, assignments, k).int()
    return (carry.centroids, assignments, carry.iteration, evals, inertia,
            carry.ring)


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


def _resolve_config(*, backend, tile_n, min_cap, chunk, config, tune, n, k,
                    d, device):
    """``(config, resolved_backend)`` for this fit.

    Precedence per knob, as in the reference: explicit ``fit`` kwarg >
    explicit ``config`` > the tuned cache entry for this (card, N, K, D)
    (``tune != "off"``, :mod:`repro_torch.tune`) > built-in default. The
    caller's backend wins unless it is ``"auto"``; an entry naming
    ``"pallas"`` resolves to ``"kernel"``. Without an entry ``"auto"``
    picks ``"lloyd"`` for ``n * k <= lloyd_max_work``, else ``"kernel"``
    (the reference picks ``"compact"`` off the TPU)."""
    if tune not in ("auto", "off", "force"):
        raise ValueError(f"unknown tune mode {tune!r}; expected "
                         f"'auto', 'off' or 'force'")
    cfg = DEFAULT_CONFIG
    if config is None and tune != "off":
        # "force" has run the search already (fit() turns its winner
        # into an explicit config); both active modes read the cache
        from .. import tune as _tune
        cfg = _tune.lookup(n=n, k=k, d=d,
                           platform=_tune.platform_name(device)) or cfg
    if config is not None:
        cfg = config
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


def _publish_fit(obs_cfg, stats: EngineStats, distance_evals: float,
                 inertia: float) -> None:
    """Publish one finished fit into the configured metrics registry:
    counters + an ``engine_fit`` event carrying the ring summary. Host
    python on values the fit already brought home; runs only under
    ``obs=``."""
    reg = obs_cfg.resolve_registry()
    labels = {"backend": stats.backend}
    reg.counter("engine_fits_total", "completed engine fits",
                labels=labels).inc()
    reg.counter("engine_distance_evals_total",
                "distance evaluations across fits", labels=labels).inc(
        float(distance_evals))
    reg.gauge("engine_last_n_iters", "iterations of the last fit",
              labels=labels).set(float(stats.n_iters))
    reg.gauge("engine_last_host_syncs", "host syncs of the last fit",
              labels=labels).set(float(stats.host_syncs))
    evt = {"backend": stats.backend, "n_iters": stats.n_iters,
           "host_syncs": stats.host_syncs, "n_points": stats.n_points,
           "distance_evals": float(distance_evals),
           "inertia": float(inertia)}
    tel = stats.telemetry()
    if tel is not None:
        evt["telemetry"] = tel
    reg.log_event("engine_fit", **evt)


def _drain(result: KMeansResult, ring, stats: EngineStats,
           live: bool) -> tuple:
    """Fit exit with obs on: the trimmed ring (if any) and the exit
    scalars ``(distance_evals, inertia)`` come home in ONE transfer. Not
    a loop read, so ``host_syncs`` does not count it (nor does the
    reference's drain). With ``live``, the epilogue's row goes to the
    ring listeners."""
    vals = [result.distance_evals.double().reshape(1),
            result.inertia.double().reshape(1)]
    if ring is not None:
        vals.append(ring[:stats.n_iters + 1].reshape(-1))
    got = torch.cat(vals).cpu().numpy()
    if ring is not None:
        stats.ring = got[2:].reshape(-1, N_COUNTERS)
        stats.init_evals = float(stats.n_points) * int(
            result.centroids.shape[0])
        if live:
            _obs_ring.emit_ring_row(stats.n_iters, stats.ring[-1])
    return float(got[0]), float(got[1])


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def fit(points, init_centroids, *, n_groups: int | None = None,
        max_iters: int = 100, tol: float = 1e-4, backend: str = "auto",
        tile_n: int | None = None, min_cap: int | None = None,
        chunk: int | None = None, max_bucket_switches: int = 32,
        config: EngineConfig | None = None, tune: str = "auto",
        sample_weight=None, return_stats: bool = False, obs=None,
        device=None):
    """Filtered K-means on ``device`` (default ``cuda``; raises when it
    is not there). ``sample_weight`` enters the centroid sums and the
    inertia only; uniform weights of 1.0 are bit-identical to ``None``.
    ``min_cap``, ``chunk`` and ``max_bucket_switches`` shape the compact
    backend's buckets, as in the reference.

    ``config`` pins an :class:`EngineConfig`; ``tune`` controls the
    per-(card, N, K, D) tuning cache (:mod:`repro_torch.tune`):
    ``"auto"`` uses a cached winner when one exists, ``"force"`` also
    runs the measured search on a cache miss and stores the winner,
    ``"off"`` uses the built-in defaults. Tuning changes wall-clock
    only: labels, ``n_iters`` and inertia are bit-identical across
    configurations. ``tile_n``/``min_cap``/``chunk`` override both.

    ``obs``: ``None``/``False`` off, ``True`` defaults, a
    ``MetricsRegistry`` or ``ObsConfig`` (:mod:`repro_torch.obs`). When
    on, the float64 telemetry ring rides the loop carry and is drained
    once at exit into ``EngineStats.ring`` (``host_syncs`` unchanged),
    and the fit publishes counters and an ``engine_fit`` event.
    Results are bit-identical with obs on or off.

    Returns a :class:`KMeansResult` (tensors on ``device``); with
    ``return_stats=True`` returns ``(result, EngineStats)``."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    with phase("kpynq/fit", on_card):
        points = as_float32(points, dev)
        init_c = as_float32(init_centroids, dev)
        k = init_c.shape[0]
        n, d = points.shape
        weights = None if sample_weight is None else \
            as_float32(sample_weight, dev)
        obs_cfg = normalize_obs(obs)
        ring_iters = int(max_iters) + 1 if obs_cfg and obs_cfg.ring else 0
        live_drain = bool(obs_cfg and obs_cfg.live_drain and ring_iters)
        if tune == "force" and config is None:
            from .. import tune as _tune
            config = _tune.get_or_tune(points, init_c, n_groups=n_groups,
                                       max_iters=int(max_iters),
                                       tol=float(tol), device=dev)
        cfg, backend = _resolve_config(backend=backend, tile_n=tile_n,
                                       min_cap=min_cap, chunk=chunk,
                                       config=config, tune=tune, n=n, k=k,
                                       d=d, device=dev)
        stats = EngineStats(backend=backend, config=cfg.to_dict(),
                            n_points=n)

        if backend == "lloyd":
            res = lloyd(points, init_c, int(max_iters), float(tol),
                        weights=weights)
            stats.n_iters = res.n_iters
            stats.host_syncs = res.n_iters  # one shift read an iteration
            if obs_cfg is not None:
                # the dense loop has no filter pass, hence no ring; the
                # registry still gets the fit's counters and event
                _publish_fit(obs_cfg, stats, *_drain(res, None, stats, False))
            return (res, stats) if return_stats else res

        if n_groups is None:
            n_groups = max(k // 10, 1)
        n_groups = int(min(n_groups, k))
        stats.x2_evals = 1

        with phase("kpynq/init", on_card):
            groups = group_centroids(init_c, n_groups)
            with phase("kpynq/host_read", on_card):
                groups_np = groups.cpu().numpy()
            members, gsize = build_group_tables(groups_np, n_groups, dev)
            stats.host_syncs += 1
            carry = _init_carry(points, init_c, groups, n_groups=n_groups,
                                ring_iters=ring_iters)

        if backend == "compact":
            carry, core, gmax = _fit_compact(
                points, weights, carry, groups, members, gsize, cfg=cfg,
                k=k, n_groups=n_groups, max_iters=int(max_iters),
                tol=float(tol), max_bucket_switches=int(max_bucket_switches),
                stats=stats, ring_iters=ring_iters, live_drain=live_drain)
            stats.host_syncs += core.reads_gmax(gmax)
        else:
            core = PassCore.from_config(cfg, backend=backend, k=k,
                                        n_groups=n_groups,
                                        ring_iters=ring_iters,
                                        live_drain=live_drain)
            cond = _loop_cond(max_iters=int(max_iters), tol=float(tol))
            body = _loop_body(core, points, weights, groups, members, gsize)
            shift = float("inf")
            while cond(carry.iteration, shift):
                carry = body(carry)
                # the per-iteration host sync
                if live_drain:
                    shift = _fetch(carry, [carry.shift.double()], True)[0]
                else:
                    with phase("kpynq/host_read", on_card):
                        shift = float(carry.shift)
                stats.host_syncs += 1
            gmax = None
        stats.n_iters = carry.iteration

        with phase("kpynq/epilogue", on_card):
            assignments, evals, inertia = _epilogue_pass(
                core, points, weights, carry, groups, members, gsize, gmax)
        result = KMeansResult(carry.centroids, assignments, carry.iteration,
                              evals, inertia)
        if obs_cfg is not None:
            _publish_fit(obs_cfg, stats,
                         *_drain(result, carry.ring, stats, live_drain))
        return (result, stats) if return_stats else result


# --------------------------------------------------------------------------
# the streaming step (repro_torch.streaming drives this)
# --------------------------------------------------------------------------

class StreamStepOut(NamedTuple):
    """Outputs of one mini-batch :func:`stream_step`. ``ub``/``lb`` are
    already decayed by this step's drift, i.e. valid against the
    returned centroids: what the caller's per-shard cache stores."""
    centroids: torch.Tensor    # (K, D) after the decayed update
    counts: torch.Tensor       # (K,) decayed effective counts
    assignments: torch.Tensor  # (B,) int32
    ub: torch.Tensor           # (B,) post-move upper bounds
    lb: torch.Tensor           # (B, G) post-move lower bounds
    pairs: torch.Tensor        # int64 point-centroid pairs scored
    gmax: torch.Tensor         # int64 surviving-group high-water
    drift: torch.Tensor        # (K,) this step's per-centroid drift
    gdrift: torch.Tensor       # (G,) this step's per-group max drift
    batch_counts: torch.Tensor  # (K,) this batch's weighted mass
    batch_cost: torch.Tensor   # f32 pre-move sum(ub^2) (weighted): an
                               # upper bound on the batch's inertia


def stream_bounds(points, centroids, assignments, ub, lb):
    """The point-level filter over CARRIED (drift-inflated) bounds: the
    first half of :func:`move_and_bounds` without the move. ``ub`` must
    bound d(x, centroids[assignments]) from above and ``lb`` the
    per-group minimum without the assignment from below (the contract
    of :func:`repro_torch.streaming.inflate_bounds`).

    Returns device tensors ``(ub_t, need, n_cand, n_tightened)``: the
    tightened upper bounds, the pending candidate mask, its popcount
    and how many own-centroid distances the tightening spent (int64).
    Nothing is read to the host here."""
    glb = torch.min(lb, dim=1).values
    maybe = ub > glb
    d_own = rowwise_dists(points, centroids[assignments.long()])
    ub_t = torch.where(maybe, d_own, ub)
    need = ub_t > glb
    return ub_t, need, need.sum(), maybe.sum()


def stream_step(points, centroids, counts, decay, groups, members, gsize,
                assignments, ub_t, lb, need, weights=None, *,
                core: PassCore, gmax: int | None = None) -> StreamStepOut:
    """One mini-batch against external carry (centroids and effective
    counts): the :class:`PassCore` candidate pass, then the decayed
    count-weighted EMA (:data:`EMA_UPDATE` through
    :func:`move_and_bounds`), then the post-move bound decay.

    ``core`` is a compact :class:`PassCore`, as the reference's stream
    runs: its pairs are the compact pass's, and it returns ``gmax``.
    ``core.cap_n`` must be at least the candidate count (the caller has
    it from :func:`stream_bounds`); ``core.cap_g`` is a guess the
    compact pass spills past into its dense branch. ``gmax`` is the
    pass's surviving-group high-water where the caller knows it, so the
    compact pass takes its branch without a host read. ``weights``
    enter the batch sums, counts and cost only.

    ``core.reducer`` joins the ranks of a sharded step
    (:func:`repro_torch.core.distributed.make_stream_update_sharded`):
    the batch sums and counts inside :func:`move_and_bounds`, so the EMA
    and the drift come out the same on every rank, and the telemetry
    (``pairs`` and ``batch_cost`` summed, ``gmax`` the largest). The
    local reducer is the identity; ``assignments``, ``ub`` and ``lb``
    stay the rank's own rows either way."""
    x2 = row_norms_sq(points)
    c2 = row_norms_sq(centroids)
    decay = torch.as_tensor(decay, dtype=torch.float32,
                            device=points.device)
    with phase("kpynq/candidate_pass", points.is_cuda):
        new_as, nub, nlb, pairs, pass_gmax = core.candidate_pass(
            points, centroids, assignments, ub_t, lb, need, groups,
            members, gsize, x2=x2, c2=c2, gmax=gmax)
    with phase("kpynq/move_and_bounds", points.is_cuda):
        mv = move_and_bounds(points, centroids, new_as, nub, nlb, groups,
                             k=core.k, n_groups=core.n_groups,
                             reducer=core.reducer, update=EMA_UPDATE,
                             counts=counts, decay=decay, weights=weights,
                             refresh=False)
    cost = nub * nub if weights is None else weights * nub * nub
    red = core.reducer
    return StreamStepOut(mv.centroids, mv.counts, new_as, mv.ub, mv.lb,
                         red.add(pairs), red.max(pass_gmax), mv.drift,
                         mv.gdrift, mv.batch_counts, red.add(torch.sum(cost)))


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


# --------------------------------------------------------------------------
# serve-side batched assignment (repro_torch.serve drives this)
# --------------------------------------------------------------------------
#
# The serving hot path differs from `assign` in two ways:
#
# * centroids, norms and group tables are ARGUMENTS of every call: the
#   double-buffered epoch swap (repro_torch.serve.CentroidIndex)
#   republishes centroids continuously, and a batch binds one snapshot.
# * the fused reduction is the min-trick, not argmin: the distance
#   minimum, then the smallest index attaining it, which reproduces
#   argmin's first-match rule exactly, as in the reference.
#
# Batches arrive padded to a pow2 bucket; nothing here writes into the
# query tensor it is given (the reference's `donate` has no counterpart).

def _serve_fused_impl(q, centroids, c2, *, chunk: int = 1024):
    """Fused dense batched assignment: the norm-cached distance product
    ``c2 - 2 q @ c.T`` (full fp32; ``||q||^2`` is constant per row and
    left out) and the two-pass min trick, tiled by ``chunk`` rows.
    Returns (B,) int32."""
    _check_fp32_matmul(q)
    k = centroids.shape[0]
    iota = torch.arange(k, dtype=torch.int32, device=q.device)
    out = []
    for lo in range(0, q.shape[0], chunk):
        d2 = c2[None, :] - 2.0 * (q[lo:lo + chunk] @ centroids.T)
        mn = torch.min(d2, dim=1, keepdim=True).values
        out.append(torch.min(torch.where(d2 <= mn, iota[None, :], k),
                             dim=1).values)
    return torch.cat(out).int() if len(out) > 1 else out[0].int()


def serve_assign_grouped(q, centroids, c2, groups, members, gsize, *,
                         core: PassCore):
    """Group-table batched assignment: the :class:`PassCore` candidate
    pass with vacuous bounds (the pass :func:`assign` tiles), on the
    compact backend at ``cap_n = B`` or through the ``grouped_assign``
    kernel. Every group survives vacuous bounds, so the compact pass is
    handed ``gmax = G`` and reads nothing back. Returns (B,) int32."""
    b = q.shape[0]
    dev = q.device
    a0 = torch.zeros((b,), dtype=torch.int32, device=dev)
    ub = torch.full((b,), float("inf"), device=dev)
    lb = torch.zeros((b, core.n_groups), device=dev)
    need = torch.ones((b,), dtype=torch.bool, device=dev)
    nas, _, _, _, _ = core.candidate_pass(
        q, centroids, a0, ub, lb, need, groups, members, gsize,
        x2=row_norms_sq(q), c2=c2,
        gmax=core.n_groups if core.backend == "compact" else None)
    return nas


SERVE_BACKENDS = ("fused", "grouped", "kernel")


def make_serve_assign(snapshot_shape, *, backend: str = "fused",
                      chunk: int = 1024):
    """The serve-side batched assign for a centroid snapshot of shape
    ``(k, n_groups)``.

    Returns ``fn(q, centroids, c2, groups, members, gsize) -> labels``,
    one signature over all backends (the fused one ignores the tables):
    ``"fused"`` (the dense product + min trick, plain ``torch.matmul``
    in full fp32, as the reference computes it outside any Pallas
    kernel), ``"grouped"`` (the compact candidate pass over the group
    tables) or ``"kernel"`` (alias ``"pallas"``: the ``grouped_assign``
    kernel, one launch a batch). All three are exact."""
    k, n_groups = snapshot_shape
    if backend == "fused":
        def run(q, centroids, c2, groups=None, members=None, gsize=None):
            return _serve_fused_impl(q, centroids, c2, chunk=chunk)
        return run
    backend = ALIASES.get(backend, backend)
    if backend not in ("grouped", "kernel"):
        raise ValueError(f"unknown serve backend {backend!r}; expected "
                         f"one of {SERVE_BACKENDS} or 'pallas'")
    pc_backend = "kernel" if backend == "kernel" else "compact"

    def run(q, centroids, c2, groups, members, gsize):
        core = PassCore(backend=pc_backend, k=k, n_groups=n_groups,
                        cap_n=q.shape[0], cap_g=n_groups, chunk=chunk)
        return serve_assign_grouped(q, centroids, c2, groups, members,
                                    gsize, core=core)
    return run
