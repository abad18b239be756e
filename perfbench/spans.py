"""The program's spans in the trace of the traced fits, clipped to the
traced window: what the readers of ``program_span`` metrics and
``device.idle_in_fit_share`` add up. A CPU rehearsal's trace holds no
device operation, and these readers report no time there."""
from __future__ import annotations


def union(spans) -> list[tuple[float, float]]:
    """The union of intervals, in time order, touching ones merged."""
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clipped(trace, *names: str) -> list[tuple[float, float]]:
    """The ranges of ``names`` that reach into the window, clipped to
    it."""
    lo, hi = trace.window
    return [(max(s, lo), min(e, hi)) for name in names
            for s, e in trace.ranges.get(name, []) if e > lo and s < hi]


def ms_per_call(run, name: str) -> float | None:
    """Host ms a call inside the union of the ``name`` ranges (a range
    nested in one of its own name counts once); None without a trace,
    without a device operation in it or without such a range."""
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    spans = union(clipped(tr, name))
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / tr.calls
