"""Measured configuration search: a hill-climb / grid hybrid (port of
``repro.tune.search``).

1. **Backend grid** — measure one default-knob candidate per backend
   the device runs (``kernel`` / ``compact`` / ``lloyd`` on the card,
   ``compact`` / ``lloyd`` on the CPU). The dense Lloyd loop is always
   in the running: for filter-hostile shapes *not filtering* is the
   fastest correct engine.
2. **Coordinate hill-climb** — from the winning filtered backend, sweep
   each of its knobs over a small lattice, adopting strict
   improvements, for up to ``max_rounds`` rounds (stop early when a
   round finds nothing). Deterministic given a deterministic
   ``measure``.
3. **The backend decision**, made on tuned-versus-Lloyd terms.

Measurements go through an injectable ``measure(config) -> seconds`` so
tests can drive the search with a stub; the default measures real
wall-clock (best-of-``repeats`` of a full ``engine.fit``, the card
synchronised after each, a warm-up call excluded).

A sharded key (``shards > 1``, ``...|sS``) is searched by sharded
measurement (:func:`sharded_timing_measure`, the sharded fit over a
mesh): no backend grid and no Lloyd, only the compact knobs climb. Every
rank of the mesh runs the search; each measurement is the slowest
rank's, so every rank compares the same numbers and returns the same
winner, and rank 0 of the mesh writes it to the cache file.

Correctness is never at stake: every candidate gives bit-identical
labels, ``n_iters`` and inertia (``tests/test_torch_tune.py`` asserts
it), so the cache can be stale or hand-edited without risking results.
"""
from __future__ import annotations

import time

import torch

from ..core.engine import EngineConfig
from ..device import as_float32, resolve_device
from ..obs.trace import span
from .cache import TuneCache, default_cache
from .signature import platform_name, signature

# knob -> candidate lattice. Kept small on purpose: each point is a few
# timed fits.
KNOB_LATTICE = {
    "min_cap": (128, 256, 512, 1024),
    "chunk": (1024, 2048, 4096),
    "group_gather_factor": (2, 4, 8),
    "down_n": (0, 2, 4),
    "down_g": (0, 2, 4, 8),
    "refresh_in_pass": (False, True),
    "tile_n": (128, 256, 512),
}

# which knobs matter per backend (lloyd has none: its only knob IS being
# lloyd). refresh_in_pass first: it changes the capacity regime the
# other knobs are then refined under. "kernel" takes the reference's
# "pallas" knobs.
BACKEND_KNOBS = {
    "compact": ("refresh_in_pass", "min_cap", "chunk",
                "group_gather_factor", "down_n", "down_g"),
    "kernel": ("tile_n", "min_cap"),
    "oracle": (),
    "lloyd": (),
}


def candidate_backends(platform: str) -> tuple:
    """The backends the platform runs: on a card (any platform but
    ``cpu``) the kernel first, as the reference on a TPU."""
    if platform != "cpu":
        return ("kernel", "compact", "lloyd")
    return ("compact", "lloyd")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_of(run, repeats):
    """Best-of-``repeats`` wall-clock of ``run`` (warm-up excluded);
    sub-ms runs keep sampling until ~50ms of timing has accumulated
    (capped) so one noisy sample cannot flip a backend decision."""
    run()                                   # build kernels + warm caches
    best = float("inf")
    done = 0
    spent = 0.0
    while done < repeats or (spent < 0.05 and done < 4 * repeats):
        t0 = time.perf_counter()
        run()
        dt = time.perf_counter() - t0
        best = min(best, dt)
        spent += dt
        done += 1
    return best


def timing_measure(points, init_c, *, n_groups=None, max_iters=50,
                   tol=1e-4, repeats=3, device=None):
    """Default measurement: best-of-``repeats`` wall-clock of a full
    ``engine.fit`` under the candidate config, the device synchronised
    inside each timed run (warm-up excluded)."""
    from ..core import engine

    dev = resolve_device(device)
    points = as_float32(points, dev)
    init_c = as_float32(init_c, dev)

    def measure(cfg: EngineConfig) -> float:
        def run():
            engine.fit(points, init_c, n_groups=n_groups,
                       max_iters=max_iters, tol=tol, config=cfg,
                       tune="off", device=dev)
            _sync(dev)
        return _best_of(run, repeats)

    return measure


def sharded_timing_measure(shard_points, init_c, shards: int, *,
                           mesh=None, axes=("data",), n_groups=None,
                           max_iters=50, tol=1e-4, repeats=3, device=None):
    """Measurement for the sharded keys (``...|sS``): the best of
    ``repeats`` runs (a warm-up excluded) of
    ``distributed_yinyang(backend="compact", config=cfg, tune="off")``,
    the card synchronised inside each, so sharded winners come from
    sharded measurement. Each run's time is the slowest rank's (a MAX
    all-reduce over the mesh), so every rank gets the same number.

    ``shard_points`` is one shard's worth of points, the unit the key
    is keyed on; the global problem is its ``shards``-fold tiling, so
    the per-rank shapes are those of a real S-way fit. ``mesh=None``
    builds :func:`~repro_torch.core.distributed.make_mesh` ``(shards)``
    over the initialised world (every rank of the world calls it; it
    raises without one). ``device=None`` is ``cuda:(rank % card
    count)``. Every rank of the mesh calls the measure with the same
    configs, in the same order."""
    from ..core import distributed as _dist
    from ..core.engine import _all_reduce

    if mesh is None:
        mesh = _dist.make_mesh(shards)
        axes = ("data",)
    axes = tuple(axes)
    if _dist._mesh_shards(mesh, axes) != int(shards):
        raise ValueError(f"the mesh has {_dist._mesh_shards(mesh, axes)} "
                         f"shards, not {shards}")
    group = _dist._group(mesh, axes)
    dev = _dist._default_device(device)
    one = as_float32(shard_points, dev)
    global_pts = torch.cat([one] * int(shards))
    init_c = as_float32(init_c, dev)

    def slowest(dt: float) -> float:
        import torch.distributed as dist
        t = torch.tensor([dt], dtype=torch.float64,
                         device=dev if dist.get_backend(group) == "nccl"
                         else "cpu")
        return float(_all_reduce(t, group, dist.ReduceOp.MAX))

    def measure(cfg: EngineConfig) -> float:
        def run():
            _dist.distributed_yinyang(
                global_pts, init_c, mesh, axes=axes, n_groups=n_groups,
                max_iters=max_iters, tol=tol, backend="compact",
                config=cfg, tune="off", device=dev)
            _sync(dev)

        run()                               # build kernels + warm caches
        best = float("inf")
        # a fixed count: the ranks run the same collectives
        for _ in range(max(int(repeats), 1)):
            t0 = time.perf_counter()
            run()
            best = min(best, slowest(time.perf_counter() - t0))
        return best

    return measure


def autotune(points, init_c, *, n_groups=None, max_iters: int = 50,
             tol: float = 1e-4, cache: TuneCache | None = None,
             measure=None, repeats: int = 3, max_rounds: int = 2,
             max_measurements: int = 32, platform: str | None = None,
             shards: int = 1, mesh=None, axes=("data",), device=None,
             verbose: bool = False) -> EngineConfig:
    """Search the engine configuration space for this problem on
    ``device`` (default ``cuda``) and store the winner under its
    (platform, N, K, D[, shards]) signature.

    Returns the winning :class:`EngineConfig`. ``measure`` overrides the
    wall-clock measurement (tests use a stub); ``max_measurements``
    bounds the number of distinct configs measured. ``platform``
    defaults to the device's (:func:`platform_name`) and picks the
    backend grid.

    ``shards > 1`` tunes the sharded key, ``points`` being one shard's
    worth: the default measure is :func:`sharded_timing_measure` over
    ``mesh`` (``make_mesh(shards)`` over the world when ``None``), the
    backend grid is skipped and the climb runs over the compact knobs.
    Every rank of the mesh runs it and returns the same winner; each
    holds it in its cache in memory, and rank 0 of the mesh writes the
    file."""
    shards = int(shards)
    writer = True
    if shards > 1:
        from ..core import distributed as _dist
        if mesh is None and measure is None:
            mesh, axes = _dist.make_mesh(shards), ("data",)
        if mesh is not None:
            writer = _dist.mesh_rank(mesh, axes) == 0
            device = _dist._default_device(device)
    if platform is None:
        platform = platform_name(resolve_device(device))
    n, d = points.shape
    k = init_c.shape[0]
    sig = signature(n, k, d, platform, shards=shards)
    if cache is None:
        cache = default_cache()
    if measure is None:
        if shards > 1:
            measure = sharded_timing_measure(
                points, init_c, shards, mesh=mesh, axes=axes,
                n_groups=n_groups, max_iters=max_iters, tol=tol,
                repeats=repeats, device=device)
        else:
            measure = timing_measure(points, init_c, n_groups=n_groups,
                                     max_iters=max_iters, tol=tol,
                                     repeats=repeats, device=device)

    memo: dict = {}

    def cost(cfg: EngineConfig) -> float:
        key = tuple(sorted(cfg.to_dict().items()))
        if key not in memo:
            if len(memo) >= max_measurements:
                return float("inf")
            with span("tune.measure", sig=sig,
                      backend=cfg.backend) as fields:
                memo[key] = float(measure(cfg))
                fields["best_s"] = memo[key]
            if verbose:
                print(f"tune[{sig}] {cfg.backend} "
                      f"{memo[key] * 1e3:8.2f}ms  {cfg.to_dict()}")
        return memo[key]

    # phase 1: backend grid at default knobs. Lloyd is the bar to clear,
    # not a climb candidate: climb the best FILTERED backend even when
    # its default-knob seed loses to Lloyd, and settle the backend
    # question after the climb. A sharded key has no backend question:
    # the sharded fit is always the compact pass on the ladder
    if shards > 1:
        lloyd_cost = None
        best = EngineConfig(backend="compact")
    else:
        lloyd_cost = cost(EngineConfig(backend="lloyd"))
        engine_seeds = [EngineConfig(backend=b)
                        for b in candidate_backends(platform)
                        if b != "lloyd"]
        best = min(engine_seeds, key=cost)
    best_cost = cost(best)
    climb_knobs = BACKEND_KNOBS[best.backend]

    # phase 2: coordinate hill-climb over the filtered winner's knobs
    for _ in range(max_rounds):
        improved = False
        for knob in climb_knobs:
            for val in KNOB_LATTICE[knob]:
                if val == getattr(best, knob):
                    continue
                cand = best.replace(**{knob: val})
                c = cost(cand)
                if c < best_cost:
                    best, best_cost = cand, c
                    improved = True
        if not improved:
            break

    # phase 3: the backend decision, made on tuned-vs-lloyd terms
    if lloyd_cost is not None and lloyd_cost < best_cost:
        best, best_cost = EngineConfig(backend="lloyd"), lloyd_cost

    extra = {} if lloyd_cost is None else {"lloyd_ms": lloyd_cost * 1e3}
    cache.store(sig, best, persist=writer, ms=best_cost * 1e3,
                measured=len(memo), n=int(n), k=int(k), d=int(d),
                shards=shards, **extra)
    if verbose:
        vs = "" if lloyd_cost is None else \
            f" vs lloyd {lloyd_cost * 1e3:.2f}ms"
        print(f"tune[{sig}] winner: {best.backend} "
              f"{best_cost * 1e3:.2f}ms{vs} ({len(memo)} configs)")
    return best


def get_or_tune(points, init_c, *, n_groups=None, max_iters: int = 50,
                tol: float = 1e-4, cache: TuneCache | None = None,
                device=None, **tune_kw) -> EngineConfig:
    """Cached-or-searched config for this problem (``fit(tune='force')``
    lands here): the cache hit if there is one, else :func:`autotune`'s
    stored winner."""
    if cache is None:
        cache = default_cache()
    n, d = points.shape
    k = init_c.shape[0]
    platform = tune_kw.get("platform") or platform_name(
        resolve_device(device))
    hit = cache.lookup(signature(n, k, d, platform))
    if hit is not None:
        return hit
    return autotune(points, init_c, n_groups=n_groups, max_iters=max_iters,
                    tol=tol, cache=cache, device=device, **tune_kw)
