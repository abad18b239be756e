"""Sharded KPynq: data-parallel filtered K-means on ``torch.distributed``
(port of ``repro.core.distributed``).

One process per shard. Every rank calls :func:`distributed_yinyang` with
the same global points, pads them to the shard lattice and keeps its own
rows; bounds, assignments and the ladder level stay with the rank, the
centroids are replicated. Each iteration the only communication is the
:class:`~repro_torch.core.engine.Reducer`'s all-reduce of the (K, D)
partial sums and the (K,) counts (the FPGA design's "stream the points
through, accumulate the centroids centrally"), and the exit gathers the
assignments (and, with stats on, the telemetry rings) onto every rank.
Filtering is local to the rank, so the work saving composes with the
parallelism.

Both sharded fits are thin wrappers over the engine's
:func:`~repro_torch.core.engine.fit_core`, the one loop:

``backend="compact"`` (default, :func:`make_fit_sharded_engine`)
    The compact pass on the capacity ladder (``PassCore(backend=
    "ladder")``): each rank switches levels of a fixed lattice
    (:func:`~repro_torch.core.engine.cap_ladders`) on its own candidate
    count and group high-water
    (:func:`~repro_torch.core.engine.select_bucket`), read on the host in
    the iteration's one exit transfer. The loop exits on the reduced
    ``shift``, the same bits on every rank, so the collectives stay in
    lockstep whatever level each rank is at.
``backend="dense"`` (:func:`make_fit_sharded`)
    The masked-dense oracle pass over every row of the shard: the
    yardstick the compact fit is held to, bit for bit (the two reduce
    the same partial sums). Needs N divisible by the shard count.

``compress=True`` int8-compresses the (K, D) partial sums only; counts,
weights and scalars stay exact. ``sample_weight`` shards with the
points. Uneven N is padded to the shard lattice with sentinel rows
(weight 0, ``ub`` 0, ``lb`` +inf: see :func:`~repro_torch.core.engine.
fit_core`), which add nothing to any centroid sum and are never
candidates.

:func:`make_stream_bounds_sharded` / :func:`make_stream_update_sharded`
are the sharded ``engine.stream_bounds`` / ``engine.stream_step``: one
global mini-batch split over the mesh, the candidate pass on each
rank's rows, the batch sums and counts all-reduced into the decayed
EMA; :class:`repro_torch.streaming.StreamingKMeans` (``mesh=``) drives
them.

The mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh``
(:func:`make_mesh`); the reductions run over ``mesh.get_group(axis)``.
Under ``gloo`` a CUDA tensor is reduced and gathered through the host,
which is how several ranks share one card (NCCL refuses two ranks on one
GPU); across cards the world runs over NCCL. :func:`spawn_world` starts a
world of fresh processes on one machine, with a deadline.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import tempfile
import time
from typing import Sequence

import numpy as np
import torch

from ..device import as_float32, resolve_device
from ..obs import ring as _obs_ring
from ..obs.metrics import normalize_obs
from .engine import (DEFAULT_CONFIG, EngineConfig, EngineStats, PassCore,
                     Reducer, StreamStepOut, build_group_tables, cap_ladders,
                     fit_core, pending_gmax, stream_bounds, stream_step)
from .kmeans import KMeansResult, group_centroids


def _reducer(mesh, axes, compress: bool) -> Reducer:
    return Reducer(group=_group(mesh, axes), compress=bool(compress))


def _group(mesh, axes):
    """The process group of ``mesh``'s axis ``axes[0]``, after checking
    that this rank is in the mesh (a rank outside it has no group to
    ask for)."""
    axis = _axis(mesh, axes)
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")
    return mesh.get_group(axis)


def mesh_rank(mesh, axes=("data",)) -> int:
    """This rank's index along ``mesh``'s axis (``ValueError`` outside
    the mesh): the shard of a global batch it keeps, and 0 for the rank
    that writes a mesh's checkpoints and tuning cache."""
    import torch.distributed as dist
    return dist.get_rank(_group(mesh, axes))


def _axis(mesh, axes) -> str:
    axes = tuple(axes)
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if len(axes) != 1 or axes[0] not in names:
        raise ValueError(f"axes must name the one dimension of a 1-D mesh; "
                         f"got {axes} for a mesh of {names}")
    return axes[0]


def make_fit_sharded(mesh, axes, k: int, n_groups: int, max_iters: int,
                     tol: float, compress: bool = False, ring_iters: int = 0):
    """The dense sharded fit on one rank's rows:
    ``fit(local_points, init_c, weights=None, stats=None) -> (centroids,
    assignments, n_iters, evals, inertia, ring)``, the body
    ``engine.fit_core`` at ``PassCore(backend="oracle")`` with the
    mesh's all-reduce. ``ring_iters > 0`` carries this rank's telemetry
    ring (joined with ``obs.ring.reduce_shard_rings``)."""
    core = PassCore(backend="oracle", k=k, n_groups=n_groups,
                    ring_iters=ring_iters,
                    reducer=_reducer(mesh, axes, compress))

    def fit_sharded(local_points, init_c, weights=None, stats=None):
        groups = group_centroids(init_c, n_groups)
        dev = local_points.device
        # the oracle pass reads no group table
        members = torch.full((n_groups, 1), -1, dtype=torch.int32,
                             device=dev)
        gsize = torch.zeros((n_groups,), dtype=torch.int64, device=dev)
        return fit_core(local_points, init_c, groups, members, gsize,
                        core=core, max_iters=max_iters, tol=tol,
                        weights=weights, stats=stats)

    return fit_sharded


def make_fit_sharded_engine(mesh, axes, k: int, n_groups: int,
                            max_iters: int, tol: float, *, shard_n: int,
                            compress: bool = False,
                            config: EngineConfig | None = None,
                            max_branches: int = 12, ring_iters: int = 0):
    """The compact sharded fit on one rank's rows: ``fit(local_points,
    valid, init_c, groups, members, gsize, weights=None, stats=None) ->
    (centroids, assignments, n_iters, evals, inertia, ring)``, where
    ``valid`` masks the sentinel rows and ``groups``/``members``/
    ``gsize`` are the group map and its host-built tables. The body is
    ``engine.fit_core`` at ``PassCore(backend="ladder")`` over
    ``cap_ladders(shard_n, ...)``: ``cfg.min_cap`` floors the ladder,
    ``cfg.down_n``/``down_g`` set the downshift hysteresis,
    ``cfg.chunk`` and ``cfg.group_gather_factor`` each level's
    gather-versus-product choice, ``cfg.refresh_in_pass`` where the
    own-distance refresh runs."""
    cfg = config or DEFAULT_CONFIG
    cap_ns, cap_gs = cap_ladders(shard_n, n_groups, min_cap=cfg.min_cap,
                                 max_branches=max_branches)
    core = PassCore.from_config(
        cfg, backend="ladder", k=k, n_groups=n_groups,
        reducer=_reducer(mesh, axes, compress), cap_ns=cap_ns,
        cap_gs=cap_gs, ring_iters=ring_iters)

    def fit_sharded(local_points, valid, init_c, groups, members, gsize,
                    weights=None, stats=None):
        return fit_core(local_points, init_c, groups, members, gsize,
                        core=core, max_iters=max_iters, tol=tol,
                        weights=weights, valid=valid, stats=stats)

    return fit_sharded


def _mesh_shards(mesh, axes) -> int:
    return int(np.prod([mesh.size(mesh.mesh_dim_names.index(a))
                        for a in axes], dtype=np.int64))


def make_mesh(shards: int, axis: str = "data", devices=None):
    """A 1-D ``DeviceMesh`` named ``axis`` over the first ``shards``
    ranks of the world (``devices``: the ranks to take them from, by
    default all). Needs an initialised process group; every rank of the
    world calls it. Its device type is ``cuda`` over NCCL, else ``cpu``
    (a ``gloo`` world may still hold its tensors on a card)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed."
                           "init_process_group first")
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    if shards > len(ranks):
        raise ValueError(f"requested {shards} shards but only {len(ranks)} "
                         f"devices are available")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, ranks[:shards], mesh_dim_names=(axis,))


def _pad_sharded(arr, shards: int, shard: int | None = None):
    """Pad (N, ...) rows with zeros to a multiple of ``shards``; returns
    ``(padded, valid bool mask)``, or with ``shard`` only that shard's
    rows of both. ``arr`` is a numpy array or a tensor (kept on its
    device)."""
    n = len(arr)
    total = n + (-n) % shards
    lo, hi = (0, total) if shard is None else \
        (shard * (total // shards), (shard + 1) * (total // shards))
    valid = np.arange(lo, hi) < n
    rows = arr[min(lo, n):min(hi, n)]
    pad = (hi - lo) - len(rows)
    if pad:
        if isinstance(rows, torch.Tensor):
            rows = torch.cat([rows, rows.new_zeros((pad,) + rows.shape[1:])])
        else:
            rows = np.concatenate(
                [rows, np.zeros((pad,) + rows.shape[1:], rows.dtype)])
    return rows, valid


def _gather(x, group, shards: int, host: bool = False):
    """Every rank's ``x`` concatenated in group-rank order, on ``x``'s
    device, or with ``host=True`` on the CPU (one device-to-host copy
    either way). Under ``gloo`` a CUDA tensor goes through the host."""
    import torch.distributed as dist
    via_host = x.is_cuda and dist.get_backend(group) == "gloo"
    src = x.cpu() if via_host else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(shards)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    if host:
        return out.cpu()
    return out.to(x.device) if via_host else out


def _sharded_stats(backend, shard_rings, n_iters, *, n, k, cfg, obs_cfg,
                   watchdog, host_syncs, publish) -> EngineStats:
    """The :class:`EngineStats` of one sharded fit from its gathered
    per-rank rings ``(S, R, C)``: the reduced ring, the work skew and
    the capacity trajectory. Feeds ``watchdog`` (each rank's own);
    ``publish`` (rank 0 only, so a world publishes once) puts the
    ``dist_shard_skew`` histogram, the gauges and a ``distributed_fit``
    event into the metrics registry."""
    shard_rings = np.asarray(shard_rings, np.float64)[:, :n_iters + 1]
    ring = _obs_ring.reduce_shard_rings(shard_rings)
    skew = _obs_ring.shard_skew(shard_rings)
    stats = EngineStats(
        backend=backend, n_iters=n_iters, host_syncs=host_syncs,
        n_points=n, config=cfg.to_dict() if cfg is not None else {},
        ring=ring, init_evals=float(n) * k, shard_rings=shard_rings,
        shard_skew=skew, caps_history=_obs_ring.caps_from_ring(ring))
    per_shard_work = shard_rings[:, :, _obs_ring.COL_EVALS]     # (S, R)
    if watchdog is not None:
        for t in range(per_shard_work.shape[1]):
            watchdog.observe_shards(t, per_shard_work[:, t])
    if obs_cfg is not None and publish:
        reg = obs_cfg.resolve_registry()
        labels = {"backend": backend}
        hist = reg.histogram("dist_shard_skew",
                             "per-iteration max/mean work skew",
                             labels=labels,
                             buckets=(1.0, 1.1, 1.25, 1.5, 2.0, 4.0, 8.0))
        for s in skew:
            hist.observe(float(s))
        reg.gauge("dist_last_shard_skew", "final-iteration work skew",
                  labels=labels).set(float(skew[-1]) if len(skew) else 1.0)
        reg.gauge("dist_last_n_iters", "iterations of the last sharded "
                  "fit", labels=labels).set(float(n_iters))
        reg.log_event("distributed_fit", backend=backend,
                      n_iters=n_iters, n_points=n,
                      shards=int(shard_rings.shape[0]),
                      telemetry=stats.telemetry())
    return stats


def _default_device(device):
    """``None`` -> ``cuda:(rank % card count)``, raising where CUDA is
    absent (:func:`repro_torch.device.resolve_device`)."""
    if device is None and torch.cuda.is_available():
        import torch.distributed as dist
        device = torch.device("cuda",
                              dist.get_rank() % torch.cuda.device_count())
    return resolve_device(device)


def distributed_yinyang(points, init_centroids, mesh,
                        axes: Sequence[str] = ("data",),
                        n_groups: int | None = None,
                        max_iters: int = 100, tol: float = 1e-4,
                        compress: bool = False, backend: str = "compact",
                        config: EngineConfig | None = None,
                        tune: str = "auto",
                        max_branches: int = 12,
                        sample_weight=None, return_stats: bool = False,
                        obs=None, watchdog=None, device=None):
    """Filtered K-means with the points sharded over the ranks of
    ``mesh``'s axis ``axes[0]``. Every rank of the mesh calls it with the
    same arguments; each returns the same result.

    ``points``: the global (N, D) points, a numpy array or a tensor
    (on the CPU or already on this rank's device); each rank keeps its
    own rows. ``backend="compact"`` (default) runs the ladder
    (:func:`make_fit_sharded_engine`), ``"dense"`` the masked-dense
    oracle (:func:`make_fit_sharded`, N divisible by the shard count).
    ``tune`` consults the per-(card, N, K, D, shards) tuning cache for
    the compact body's knobs (``n`` the per-shard count; ``"force"`` on
    a miss runs the measured sharded search once, over this mesh:
    :func:`repro_torch.tune.autotune` with ``shards``); ``config`` pins
    them. ``sample_weight``: (N,) per-point weights,
    sharded with their points (weighted sums, counts and inertia; the
    int8 ``compress`` payload stays the (K, D) sums).

    ``device``: this rank's device; ``None`` is ``cuda:(rank % card
    count)`` and raises without CUDA. The CPU runs only when asked for.

    ``return_stats=True`` returns ``(result, EngineStats)`` with the
    reduced ring, the gathered per-rank ``shard_rings`` and the
    per-iteration ``shard_skew`` (max/mean work, the straggler signal
    under lockstep). ``obs`` also publishes the skew histogram, gauges
    and a ``distributed_fit`` event (rank 0 only); ``watchdog`` gets each
    iteration's per-shard work through ``observe_shards``. None of these
    changes a bit of the result.

    Returns a :class:`KMeansResult` with the global (N,) assignments on
    every rank."""
    if backend not in ("compact", "dense"):
        raise ValueError(f"unknown distributed backend {backend!r}; "
                         f"expected 'compact' or 'dense'")
    if tune not in ("auto", "off", "force"):
        raise ValueError(f"unknown tune mode {tune!r}; expected "
                         f"'auto', 'off' or 'force'")
    axes = tuple(axes)
    group = _group(mesh, axes)
    import torch.distributed as dist
    shard = dist.get_rank(group)
    dev = _default_device(device)
    k = init_centroids.shape[0]
    if n_groups is None:
        n_groups = max(k // 10, 1)
    n_groups = int(min(n_groups, k))
    shards = _mesh_shards(mesh, axes)
    init_c = as_float32(init_centroids, dev)
    obs_cfg = normalize_obs(obs)
    want_stats = return_stats or obs_cfg is not None or \
        watchdog is not None
    ring_iters = int(max_iters) + 1 if want_stats else 0
    n, d = points.shape
    if backend == "dense" and n % shards:
        raise ValueError(
            f"backend='dense' needs N ({n}) divisible by the shard "
            f"count ({shards}); use backend='compact' for uneven "
            f"shards")
    rows, valid_np = _pad_sharded(points, shards, shard)
    local = as_float32(rows, dev).contiguous()
    weights = None
    if sample_weight is not None:
        w = sample_weight if isinstance(sample_weight, torch.Tensor) \
            else np.asarray(sample_weight, np.float32)
        weights = as_float32(_pad_sharded(w, shards, shard)[0],
                             dev).contiguous()      # pad rows: weight 0
    stats = EngineStats()

    if backend == "dense":
        cfg = config
        fit_sharded = make_fit_sharded(mesh, axes, k, n_groups,
                                       int(max_iters), float(tol),
                                       compress, ring_iters=ring_iters)
        c, a, i, evals, inertia, ring = fit_sharded(local, init_c, weights,
                                                    stats)
    else:
        shard_n = len(local)
        cfg = _resolve_sharded_config(
            points, init_c, mesh, axes, shard_n=shard_n, k=k, d=d,
            shards=shards, config=config, tune=tune, n_groups=n_groups,
            max_iters=int(max_iters), tol=float(tol), device=dev)
        # group map + tables, built once on the host (true Lmax)
        groups = group_centroids(init_c, n_groups)
        members, gsize = build_group_tables(groups.cpu().numpy(), n_groups,
                                            dev)
        stats.host_syncs += 1
        fit_sharded = make_fit_sharded_engine(
            mesh, axes, k, n_groups, int(max_iters), float(tol),
            shard_n=shard_n, compress=compress, config=cfg,
            max_branches=int(max_branches), ring_iters=ring_iters)
        valid = None if valid_np.all() else \
            torch.from_numpy(valid_np).to(dev)
        c, a, i, evals, inertia, ring = fit_sharded(
            local, valid, init_c, groups, members, gsize, weights, stats)
    result = KMeansResult(c, _gather(a, group, shards)[:n], i, evals,
                          inertia)
    if not want_stats:
        return result
    rings = _gather(ring[None], group, shards).cpu().numpy()
    stats = _sharded_stats(backend, rings, i, n=n, k=k, cfg=cfg,
                           obs_cfg=obs_cfg, watchdog=watchdog,
                           host_syncs=stats.host_syncs, publish=shard == 0)
    return (result, stats) if return_stats else result


def _resolve_sharded_config(points, init_c, mesh, axes, *, shard_n, k, d,
                            shards, config, tune, n_groups, max_iters, tol,
                            device) -> EngineConfig:
    """Config precedence for the compact sharded fit: explicit
    ``config`` > the tuned ``...|sS`` entry for the per-shard shape >
    (``tune="force"`` only) a fresh measured sharded search over this
    mesh, on ``points[:shard_n]`` (:func:`repro_torch.tune.autotune`
    with ``shards``; every rank of the mesh runs it and gets the same
    winner) > the single-device entry for the per-shard shape >
    defaults."""
    if config is not None:
        return config
    if tune == "off":
        return DEFAULT_CONFIG
    from .. import tune as _tune
    platform = _tune.platform_name(device)
    cfg = _tune.lookup(n=shard_n, k=k, d=d, shards=shards,
                       platform=platform)
    if cfg is None and tune == "force":
        cfg = _tune.autotune(
            points[:shard_n], init_c, n_groups=n_groups,
            max_iters=max_iters, tol=tol, shards=shards, mesh=mesh,
            axes=axes, device=device)
    if cfg is None:
        cfg = _tune.lookup(n=shard_n, k=k, d=d, platform=platform)
    return cfg or DEFAULT_CONFIG


# --------------------------------------------------------------------------
# sharded streaming steps (repro_torch.streaming.StreamingKMeans drives them)
# --------------------------------------------------------------------------

def make_stream_bounds_sharded(mesh, axes: Sequence[str] = ("data",)):
    """The sharded :func:`~repro_torch.core.engine.stream_bounds`: the
    point-level filter over carried (drift-inflated) bounds on this
    rank's rows of one global mini-batch.

    Returns ``bounds(points, centroids, assign, ub, lb) -> (ub_t, need,
    max_shard_cand, tightened, gmax)``: ``ub_t``/``need`` the rank's own
    rows on its device; ``max_shard_cand`` the largest per-rank
    candidate count (what the static per-rank ``cap_n`` must cover),
    ``tightened`` the own-distance refreshes summed over the ranks, and
    ``gmax`` this rank's own pending group high-water (so its compact
    pass takes its branch without a read of its own), as host ints.
    The three come home in one read: each rank's three counts are
    all-gathered in one collective and reduced on the host, the same
    integers on every rank."""
    axes = tuple(axes)
    group = _group(mesh, axes)
    shards = _mesh_shards(mesh, axes)
    rank = mesh_rank(mesh, axes)

    def bounds(points, centroids, assign, ub, lb):
        ub_t, need, n_cand, n_tight = stream_bounds(points, centroids,
                                                    assign, ub, lb)
        mine = torch.stack([n_cand, n_tight,
                            pending_gmax(need, ub_t, lb)]).long()
        counts = _gather(mine[None], group, shards, host=True)  # (S, 3)
        return (ub_t, need, int(counts[:, 0].max()), int(counts[:, 1].sum()),
                int(counts[rank, 2]))

    return bounds


def make_stream_update_sharded(mesh, axes, *, k: int, n_groups: int,
                               cap_n: int, cap_g: int, chunk: int = 2048,
                               group_gather_factor: int = 4,
                               compress: bool = False,
                               weighted: bool = False):
    """The sharded :func:`~repro_torch.core.engine.stream_step`: one
    global mini-batch split over the mesh, the same step body on each
    rank's rows at ``PassCore(backend="compact", reducer=Reducer(group,
    compress))``. The reducer joins the batch sums and counts, so the
    decayed EMA and the drift come out the same on every rank, and
    reduces the telemetry (``pairs``, ``batch_cost`` summed; ``gmax``
    the largest). ``cap_n`` must cover the largest per-rank candidate
    count (:func:`make_stream_bounds_sharded` returns it).
    ``compress=True`` int8-compresses the (K, D) sums only.

    Returns ``update(points, centroids, counts, decay, groups, members,
    gsize, assignments, ub_t, lb, need, weights=None, *, gmax=None) ->
    StreamStepOut`` on this rank's rows; ``assignments``/``ub``/``lb``
    come back as the rank's rows (the caller gathers them). ``weights``
    is given exactly when ``weighted``; ``gmax`` is this rank's own
    pending group high-water where the caller has it."""
    core = PassCore(backend="compact", k=k, n_groups=n_groups,
                    cap_n=cap_n, cap_g=cap_g, chunk=chunk,
                    group_gather_factor=group_gather_factor,
                    reducer=_reducer(mesh, axes, compress))

    def update(points, centroids, counts, decay, groups, members, gsize,
               assignments, ub_t, lb, need, weights=None, *,
               gmax=None) -> StreamStepOut:
        if (weights is not None) != bool(weighted):
            raise ValueError(f"this update was built with weighted="
                             f"{weighted}; weights must be given exactly "
                             f"then")
        return stream_step(points, centroids, counts, decay, groups,
                           members, gsize, assignments, ub_t, lb, need,
                           weights, core=core, gmax=gmax)

    return update


# --------------------------------------------------------------------------
# starting a world on one machine
# --------------------------------------------------------------------------

def _world_entry(rank, fn, world_size, backend, init_method, timeout,
                 outdir):
    import torch.distributed as dist
    with open(os.path.join(outdir, "args.pkl"), "rb") as fh:
        args = pickle.load(fh)
    # the ranks share the machine's cores
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    out = fn(rank, world_size, *args)
    dist.destroy_process_group()
    path = os.path.join(outdir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as fh:
        pickle.dump(out, fh)
    os.replace(path + ".tmp", path)


@contextlib.contextmanager
def one_rank_world(backend: str = "gloo", timeout: float = 600.0):
    """A world of this process alone (rank 0 of 1) for the ``with``
    block, joined over a file store in a temporary directory; over NCCL
    it takes card 0."""
    import torch.distributed as dist
    if backend == "nccl":
        torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "store"),
            world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            yield
        finally:
            dist.destroy_process_group()


def spawn_world(fn, world_size: int, *, args=(), backend: str = "gloo",
                timeout: float = 600.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh
    processes (the ``spawn`` start method) joined by
    ``init_process_group(backend)`` over a file store in a temporary
    directory, with ``timeout`` as the process group's collective
    timeout. ``fn`` must be importable by name (a module-level
    function); ``args`` reach the ranks, and each rank's return value
    comes back, through files (a large payload through the spawn pipe
    would start the ranks one after another). Each rank runs one CPU
    thread; over ``nccl`` rank r takes card ``r % count``.

    Returns the ranks' return values in rank order. A rank that raises
    or dies, or a world still running after ``timeout`` seconds, stops
    every rank and raises; no process outlives the call."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        with open(os.path.join(tmp, "args.pkl"), "wb") as fh:
            pickle.dump(tuple(args), fh)
        ctx = mp.start_processes(
            _world_entry, args=(fn, world_size, backend, init, timeout, tmp),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {world_size} ranks did "
                                       f"not finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
    return out
