"""The program's spans (``repro_torch.obs.trace.phase``) in a fit, read
from a CPU profiler trace: one ``kpynq/fit`` a fit with every other
``kpynq/*`` range inside it, one ``kpynq/host_read`` for each host read
that ``EngineStats.host_syncs`` counts, the kernels' wrappers under the
phases that call them, the same bits traced or not, and no
``record_function`` while no profiler is active. Imports no JAX."""
from collections import defaultdict

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from repro_torch.core import engine

N, D, K, G = 8192, 8, 256, 64
MAX_ITERS = 12
FITS = 2
# compact with the refresh in the pass reads each pass's gmax to the host
CASES = {
    "kernel": dict(backend="kernel"),
    "compact": dict(backend="compact"),
    "compact_refresh_in_pass": dict(
        backend="compact", config=engine.EngineConfig(refresh_in_pass=True)),
    "oracle": dict(backend="oracle"),
    "lloyd": dict(backend="lloyd"),
}


@pytest.fixture(scope="module")
def data():
    gen = torch.Generator().manual_seed(0)
    centres = torch.randn(K, D, generator=gen) * 6
    pts = centres[torch.randint(0, K, (N,), generator=gen)] \
        + torch.randn(N, D, generator=gen)
    inits = [pts[torch.randperm(N, generator=gen)[:K]].clone()
             for _ in range(FITS)]
    return pts, inits


def _fit(pts, init, case):
    return engine.fit(pts, init, n_groups=G, max_iters=MAX_ITERS,
                      tune="off", return_stats=True, device="cpu",
                      **CASES[case])


def _ranges(prof) -> dict[str, list[tuple[float, float]]]:
    """The ``kpynq/*`` ranges by name (a name not seen reads empty)."""
    out = defaultdict(list)
    for e in prof.events():
        if e.name.startswith("kpynq/"):
            out[e.name].append((e.time_range.start, e.time_range.end))
    return out


def _inside(span, parents) -> bool:
    return any(s <= span[0] and span[1] <= e for s, e in parents)


@pytest.mark.parametrize("case", list(CASES))
def test_fit_spans(data, case):
    pts, inits = data
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = [_fit(pts, init, case) for init in inits]
    # the same bits and counts with no profiler
    for (res, stats), (res_t, stats_t) in zip(
            [_fit(pts, init, case) for init in inits], traced):
        assert res.n_iters == res_t.n_iters
        assert stats.host_syncs == stats_t.host_syncs
        for name in ("centroids", "assignments", "distance_evals",
                     "inertia"):
            assert torch.equal(getattr(res, name), getattr(res_t, name))
    spans = _ranges(prof)
    fits = spans.pop("kpynq/fit")
    assert len(fits) == FITS
    for name, found in spans.items():
        assert all(_inside(s, fits) for s in found), name
    # one host read span for each read that host_syncs counts
    assert len(spans["kpynq/host_read"]) == \
        sum(st.host_syncs for _, st in traced)
    iters = sum(res.n_iters for res, _ in traced)
    if case == "lloyd":
        assert set(spans) == {"kpynq/host_read", "kpynq/centroid_update"}
        assert len(spans["kpynq/centroid_update"]) == iters
        return
    # the init holds the group table's read, the epilogue the last pass
    assert len(spans["kpynq/init"]) == len(spans["kpynq/epilogue"]) == FITS
    reads = spans["kpynq/host_read"]
    for init in spans["kpynq/init"]:
        assert sum(_inside(r, [init]) for r in reads) == 1
    passes = spans["kpynq/candidate_pass"]
    assert len(passes) == iters + FITS
    assert sum(_inside(p, spans["kpynq/epilogue"]) for p in passes) == FITS
    assert len(spans["kpynq/move_and_bounds"]) == iters
    # one bound upkeep a move, inside it
    ups = spans["kpynq/bounds_upkeep"]
    assert len(ups) == iters
    assert all(_inside(s, spans["kpynq/move_and_bounds"]) for s in ups)
    # the kernels' wrappers under the phases that call them
    ga = spans["kpynq/grouped_assign"]
    assert len(ga) == (len(passes) if case == "kernel" else 0)
    assert all(_inside(s, passes) for s in ga)
    # the kernel pass's block mask and tail, one span each
    tails = spans["kpynq/candidate_tail"]
    assert len(tails) == (2 * len(passes) if case == "kernel" else 0)
    assert all(_inside(s, passes) for s in tails)
    cu = spans["kpynq/centroid_update"]
    assert len(cu) > iters
    callers = spans["kpynq/move_and_bounds"] + spans["kpynq/init"]
    assert all(_inside(s, callers) for s in cu)
    if case == "compact_refresh_in_pass":
        # some pass read its gmax, inside the pass
        assert any(_inside(r, passes) for r in reads)


@pytest.mark.parametrize("mode", ["off", "scheduled"])
def test_phase_enters_record_function_only_under_an_active_profiler(
        data, monkeypatch, mode):
    pts, inits = data
    real = torch.profiler.record_function
    names = []

    def spy(name, *args, **kwargs):
        names.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    if mode == "off":
        _fit(pts, inits[0], "kernel")
        assert names == []
        return
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        _fit(pts, inits[0], "kernel")       # the warm-up step: not active
        prof.step()
        assert names == []
        _fit(pts, inits[0], "kernel")
        prof.step()
    assert {"kpynq/fit", "kpynq/init", "kpynq/host_read",
            "kpynq/candidate_pass", "kpynq/grouped_assign",
            "kpynq/move_and_bounds", "kpynq/centroid_update",
            "kpynq/bounds_upkeep", "kpynq/candidate_tail",
            "kpynq/epilogue"} <= set(names)
