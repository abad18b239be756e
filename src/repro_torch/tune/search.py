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

Correctness is never at stake: every candidate gives bit-identical
labels, ``n_iters`` and inertia (``tests/test_torch_tune.py`` asserts
it), so the cache can be stale or hand-edited without risking results.
"""
from __future__ import annotations

import time

import torch

from .._unported import ITEM_9B
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


def sharded_timing_measure(*args, **kwargs):
    raise NotImplementedError(
        f"sharded_timing_measure is not ported yet: {ITEM_9B}")


def autotune(points, init_c, *, n_groups=None, max_iters: int = 50,
             tol: float = 1e-4, cache: TuneCache | None = None,
             measure=None, repeats: int = 3, max_rounds: int = 2,
             max_measurements: int = 32, platform: str | None = None,
             shards: int = 1, device=None,
             verbose: bool = False) -> EngineConfig:
    """Search the engine configuration space for this problem on
    ``device`` (default ``cuda``) and store the winner under its
    (platform, N, K, D) signature.

    Returns the winning :class:`EngineConfig`. ``measure`` overrides the
    wall-clock measurement (tests use a stub); ``max_measurements``
    bounds the number of distinct configs measured. ``platform``
    defaults to the device's (:func:`platform_name`) and picks the
    backend grid. ``shards > 1`` (the measured sharded search) raises
    ``NotImplementedError``: ROADMAP item 9b."""
    if int(shards) > 1:
        raise NotImplementedError(
            f"autotune(shards > 1) is not ported yet: {ITEM_9B}")
    if platform is None:
        platform = platform_name(resolve_device(device))
    n, d = points.shape
    k = init_c.shape[0]
    sig = signature(n, k, d, platform)
    if cache is None:
        cache = default_cache()
    if measure is None:
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
    # question after the climb
    lloyd_cost = cost(EngineConfig(backend="lloyd"))
    engine_seeds = [EngineConfig(backend=b)
                    for b in candidate_backends(platform) if b != "lloyd"]
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
    if lloyd_cost < best_cost:
        best, best_cost = EngineConfig(backend="lloyd"), lloyd_cost

    cache.store(sig, best, ms=best_cost * 1e3, measured=len(memo),
                n=int(n), k=int(k), d=int(d), shards=1,
                lloyd_ms=lloyd_cost * 1e3)
    if verbose:
        print(f"tune[{sig}] winner: {best.backend} "
              f"{best_cost * 1e3:.2f}ms vs lloyd {lloyd_cost * 1e3:.2f}ms "
              f"({len(memo)} configs)")
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
