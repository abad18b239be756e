"""The window as one caller's closed loop of k-means restarts, as
sklearn's ``n_init`` runs them: back-to-back fits of the points on the
card, each from K distinct points, through the entry that
``KMeans(algorithm="yinyang", engine="auto").fit`` runs after its
initialisation:

    repro_torch.core.engine.fit(X, C0, n_groups=G, max_iters=..., tol=...,
                                backend="auto", tune="auto",
                                return_stats=True)

Each fit ends when its labels, centroids, inertia and distance count
are on the host, which waits for the card. The points stay on the card.
The traffic's parameters are the points' recipe (``spread``,
``cluster_std``, ``centres_per_k``), ``data_seed`` and ``restarts``.
The points are a cloud made from ``data_seed``, turned by a rotation
drawn from the run's seed and put in an order drawn from it: every
coordinate the card reads is the seed's own, while every distance, and
so the work of a fit, stays the cloud's. The restarts start from a pool
of ``restarts`` initial centroids, K distinct points each, whose rows are
drawn from ``data_seed``; the seed orders the pool, cycle by cycle. So
every seed brings the same work in another frame and order; its fits
differ from another seed's by the rounding of those numbers.

After the window: the numbers of :mod:`perfbench.compare` that the
cell's limits name, those of a fit's own answers on every fit, those
against the reference's whole fit on a sample of ``CHECK_FITS`` fits
drawn from the seed.
"""
from __future__ import annotations

import random
import time
from typing import NamedTuple

import torch

from .. import compare, generator, reference, tracing

KERNELS = ("grouped_assign", "centroid_update")
WARMUP_FITS = 4
CHECK_FITS = 8
TRACE_AT = 2        # the profiler's dropped warm-up fit is this restart
TRACED_FITS = 2     # fits inside the traced range, the ones after it


class FitRecord(NamedTuple):
    start: int              # the pool entry it started from
    n_iters: int
    host_syncs: int
    distance_evals: int
    answer: compare.Answer


def fit(engine, points, cfg: dict, init, device):
    """One restart as the window runs it: ``(answer, stats, evals)``,
    the answer on the host."""
    res, stats = engine.fit(points, init, n_groups=cfg["n_groups"],
                            max_iters=cfg["max_iters"], tol=cfg["tol"],
                            backend="auto", tune="auto", return_stats=True,
                            device=device)
    inertia, evals = torch.stack([res.inertia.double(),
                                  res.distance_evals.double()]).tolist()
    answer = compare.Answer(res.centroids.cpu(), res.assignments.cpu(),
                            res.n_iters, inertia)
    return answer, stats, int(evals)


def _worse(a: float, b: float) -> float:
    """The worse of two readings; NaN is worst."""
    return b if b != b or b > a else a


def _spread_ms(start: float, ends: list[float]) -> dict:
    """Quartiles of the fits' host times, and the mean of the first and
    the last fifth of the window, in ms (for standard error)."""
    steps = [1e3 * (b - a) for a, b in zip([start] + ends, ends)]
    ms = sorted(steps)
    fifth = max(1, len(ends) // 5)
    return {"q1": ms[len(ms) // 4], "median": ms[len(ms) // 2],
            "q3": ms[3 * len(ms) // 4], "max": ms[-1],
            "first_fifth": sum(steps[:fifth]) / fifth,
            "last_fifth": sum(steps[-fifth:]) / fifth}


def run(cell) -> dict:
    """One run of the cell (see :class:`perfbench.bench.Cell`)."""
    stages = {"torch_s": time.perf_counter() - cell.started}
    from repro_torch.core import engine
    stages["program_s"] = time.perf_counter() - cell.started

    cfg, mix, dev = cell.config, cell.traffic["params"], cell.device
    n, d, k = cfg["n_points"], cfg["n_dims"], cfg["k"]
    on_card = dev.type == "cuda"
    compiled = False
    if on_card:
        from repro_torch.kernels import _build
        compiled = not all(_build.library_path(name).exists()
                           for name in KERNELS)
        for name in KERNELS:
            _build.load(name)
    stages["kernels_s"] = time.perf_counter() - cell.started
    data = generator.make_points(
        n, d, n_centres=max(1, round(mix["centres_per_k"] * k)),
        spread=mix["spread"], cluster_std=mix["cluster_std"],
        seed=mix["data_seed"], device=dev)
    data = generator.rotate(data, generator.rotation(d, seed=cell.seed))
    pool = [data[generator.initial_rows(n, k, seed=mix["data_seed"],
                                        restart=i, device=dev)]
            for i in range(mix["restarts"])]
    points = data[generator.permutation(n, seed=cell.seed, device=dev)]
    del data
    if on_card:
        torch.cuda.synchronize(dev)
    stages["points_s"] = time.perf_counter() - cell.started

    def start_of(r: int) -> int:
        """The pool entry that restart ``r`` of the run starts from."""
        p = len(pool)
        return generator.order(p, seed=cell.seed, cycle=r // p)[r % p]

    for i in range(WARMUP_FITS):
        fit(engine, points, cfg, pool[start_of(i)], dev)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    records: list[FitRecord] = []

    def one() -> None:
        entry = start_of(len(records))
        answer, stats, evals = fit(engine, points, cfg, pool[entry], dev)
        records.append(FitRecord(entry, answer.n_iters, stats.host_syncs,
                                 evals, answer))

    def traced_part() -> None:
        for _ in range(TRACED_FITS):
            one()
        if on_card:
            torch.cuda.synchronize(dev)

    trace = None
    start = time.perf_counter()
    setup_s = start - cell.started
    stages["warm_s"] = setup_s
    ends = []
    while True:
        if cell.trace and trace is None and len(records) == TRACE_AT:
            trace = tracing.profile(one, traced_part, TRACED_FITS)
        else:
            one()
        now = time.perf_counter()
        ends.append(now)
        if now - start >= cell.seconds and (trace is not None
                                            or not cell.trace):
            break
    window_s = now - start
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    # the check, after the window: every fit's own answers, and a sample
    # of whole fits against the reference (where the cell compares them)
    compared = [name for name in compare.NUMBERS if name in cell.limits]
    per_fit = [name for name in compared if name in compare.PER_FIT]
    worst = dict.fromkeys(compared, 0.0)
    failed = set()

    def tally(i, got):
        for name, value in got.items():
            worst[name] = _worse(worst[name], value)
            if not compare.passes(value, cell.limits[name]):
                failed.add(i)

    for i, rec in enumerate(records):
        tally(i, compare.readings(points, rec.answer, names=per_fit))
    # the reference on a sample of the fits, one a pool entry at most
    first = {}
    for i, rec in enumerate(records):
        first.setdefault(rec.start, i)
    pick = random.Random(generator.derive(cell.seed, "check"))
    sample = sorted(pick.sample(sorted(first.values()),
                                min(CHECK_FITS, len(first))))
    if len(per_fit) < len(compared):
        for i in sample:
            rec = records[i]
            ref = reference.fit(points, pool[rec.start],
                                max_iters=cfg["max_iters"], tol=cfg["tol"])
            tally(i, compare.readings(
                points, rec.answer, ref,
                names=[m for m in compared if m not in per_fit]))
    checks = {name: (worst[name], cell.limits[name]) for name in compared}
    return {
        "attempted": len(records),
        "failed": len(failed),
        "checks": checks,
        "end_to_end": {"fit_s": window_s / len(records),
                       "fit_peak_gib": peak / 2 ** 30,
                       "setup_s": setup_s},
        "memory_peak_bytes": peak,
        "compiled": compiled,
        "fits": records,
        "trace": trace,
        "traced": records[TRACE_AT + 1:TRACE_AT + 1 + TRACED_FITS]
        if trace is not None else [],
        "notes": {"fits": len(records), "window_s": window_s,
                  "fit_ms": _spread_ms(start, ends), "setup": stages,
                  "checked": [records[i].start for i in sample]},
    }
