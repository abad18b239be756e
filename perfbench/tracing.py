"""The device trace of a short steady part of the window, and what the
per-layer readers take from it.

:func:`profile` runs one call under ``torch.profiler`` as a warm-up step
whose records are dropped (a cold profiler misses the first kernels),
then the measured call inside a ``perfbench/traced`` range, and exports
the Chrome trace into a directory under ``TMPDIR`` that it removes once
the trace is read. :class:`Trace` holds the device operations (kernels,
copies, fills), the host launches tied to them by the trace's
correlation ids, the program's ``kpynq/*`` ranges and the host's
operations, all in microseconds on one clock.
"""
from __future__ import annotations

import bisect
import json
import re
import shutil
import tempfile
from dataclasses import dataclass
from pathlib import Path

WINDOW = "perfbench/traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def short_name(name: str, width: int = 100) -> str:
    """A kernel's name without ``void`` and its argument list."""
    anon = "(anonymous namespace)"
    if name.startswith("void "):
        name = name[5:]
    depth, i = 0, 0
    while i < len(name):
        if name.startswith(anon, i):
            i += len(anon)
            continue
        ch = name[i]
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and name[i - 1] != " ":
            return name[:i][:width]
        i += 1
    return name[:width]


@dataclass
class DeviceOp:
    name: str
    start: float
    end: float
    launched: float | None   # host time of its launch, None if untied


@dataclass
class Trace:
    ops: list[DeviceOp]
    ranges: dict[str, list[tuple[float, float]]]
    host: list[tuple[float, float, str, str]]  # (start, end, cat, name)
    window: tuple[float, float]
    calls: int                                  # calls inside the window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        window, in time order."""
        lo, hi = self.window
        spans = sorted((max(o.start, lo), min(o.end, hi)) for o in self.ops
                       if o.end > lo and o.start < hi)
        out: list[list[float]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e6

    def launched_in(self, range_name: str, pattern: str | None = None):
        """The device operations whose host launch falls inside one of
        the host ranges named ``range_name`` (and whose name matches the
        regular expression ``pattern``, where given)."""
        spans = sorted(self.ranges.get(range_name, []))
        starts = [s for s, _ in spans]
        rx = re.compile(pattern) if pattern else None
        out = []
        for o in self.ops:
            if o.launched is None or (rx and not rx.search(o.name)):
                continue
            i = bisect.bisect_right(starts, o.launched) - 1
            # ranges of one name may nest: look back over the earlier ones
            while i >= 0:
                if spans[i][0] <= o.launched <= spans[i][1]:
                    out.append(o)
                    break
                i -= 1
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps by what the host was doing, each summed by name, in
        seconds."""
        by_op: dict[str, float] = {}
        for o in self.ops:
            key = short_name(o.name)
            by_op[key] = by_op.get(key, 0.0) + (o.end - o.start) / 1e6
        gaps: dict[str, float] = {}
        lo, hi = self.window
        edges = [lo]
        for s, e in self.intervals():
            edges += [s, e]
        edges.append(hi)
        spans = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
        names = self.host_at([(s + e) / 2 for s, e in spans])
        for (s, e), name in zip(spans, names):
            gaps[name] = gaps.get(name, 0.0) + (e - s) / 1e6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                   key=lambda kv: -kv[1])]
        return {"device_ops": rank(by_op)[:top],
                "idle_gaps": rank(gaps)[:top]}

    def host_at(self, times: list[float]) -> list[str]:
        """What the host was doing at each of the ascending ``times``:
        the innermost host operation around it, under the innermost
        program range around it (one sweep over the host's events)."""
        out, active, i = [], [], 0
        for t in times:
            while i < len(self.host) and self.host[i][0] <= t:
                active.append(self.host[i])
                i += 1
            active = [h for h in active if h[1] >= t]
            op = rng = None
            for s, e, cat, name in active:
                if cat == "user_annotation":
                    if name.startswith("kpynq/") and (rng is None
                                                      or e - s < rng[0]):
                        rng = (e - s, name)
                elif op is None or e - s < op[0]:
                    op = (e - s, name)
            parts = [p[1] for p in (rng, op) if p is not None]
            out.append(": ".join(parts) if parts else "host, no operation")
        return out


def parse(events: list[dict], calls: int) -> Trace:
    """A :class:`Trace` from the Chrome trace's events."""
    launches: dict[int, float] = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches.setdefault(e["args"]["correlation"], float(e["ts"]))
    ops, ranges, host = [], {}, []
    window = None
    for e in events:
        cat, name = e.get("cat"), str(e.get("name", ""))
        if e.get("ph") != "X":
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            corr = e.get("args", {}).get("correlation")
            ops.append(DeviceOp(name, ts, ts + dur, launches.get(corr)))
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, cat, name))
            if cat == "user_annotation":
                ranges.setdefault(name, []).append((ts, ts + dur))
                if name == WINDOW:
                    window = (ts, ts + dur)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    host.sort()
    return Trace(ops, ranges, host, window, calls)


def profile(warm, measured, calls: int) -> Trace:
    """Run ``warm()`` as the profiler's dropped warm-up step, then
    ``measured()`` (which makes ``calls`` calls and synchronises) inside
    the ``perfbench/traced`` range; returns the parsed trace."""
    import torch
    from torch.profiler import ProfilerActivity, record_function, schedule
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(tempfile.mkdtemp(prefix="perfbench-trace-"))
    path = out / "trace.json"
    try:
        with torch.profiler.profile(
                activities=acts,
                schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                on_trace_ready=lambda p: p.export_chrome_trace(str(path))) \
                as prof:
            warm()
            prof.step()
            with record_function(WINDOW):
                measured()
            prof.step()
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return parse(events, calls)
