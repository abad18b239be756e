"""Phase tracing: wall-clock spans + profiler traces (port of
``repro.obs.trace``).

Two granularities:

* **Device phases** — :func:`phase` is the one way the program marks a
  span: an NVTX range on the card always (for Nsight), and a
  ``torch.profiler.record_function`` range only while a profiler is
  active, so a fit that nobody traces pays a flag check, not a range.
  Under a profiler the ranges sit in the exported trace on the clock of
  the device activity. The spans (the reference marks its phases with
  ``jax.named_scope``): ``kpynq/fit`` (``core.engine.fit``, entry to
  return), ``kpynq/init`` (groups, tables, the filter state),
  ``kpynq/candidate_pass``, ``kpynq/move_and_bounds``, ``kpynq/reduce``
  (the sharded fit's all-reduce), ``kpynq/ring_write``,
  ``kpynq/epilogue`` (the last pass, the inertia), ``kpynq/host_read``
  (each host read that ``EngineStats.host_syncs`` counts) and
  ``kpynq/grouped_assign`` / ``kpynq/centroid_update`` /
  ``kpynq/bounds_upkeep`` (the kernels' wrappers, checks and launch).
  :func:`profile` runs a callable under ``torch.profiler`` and exports
  a Chrome/Perfetto trace (open at https://ui.perfetto.dev).
* **Host spans** — :func:`span` is a context manager timing a host
  region into a registry histogram + event (used by ``tune.autotune``
  around each measured candidate).
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch
from torch._C._autograd import _profiler_enabled

from .metrics import MetricsRegistry, default_registry

# span-duration histogram buckets: micro-benchmarks to multi-minute fits
SPAN_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                30.0, 60.0, 300.0)


@contextlib.contextmanager
def span(name: str, registry: MetricsRegistry | None = None, **fields):
    """Time a host-side region.

    Records the duration into the ``span_seconds`` histogram (labelled
    by span name) and appends a ``span`` event (with any extra
    ``fields``) to the registry's event log. Yields a dict the caller
    may add result fields to; they land in the same event.

        with obs.span("tune.measure", backend="compact") as s:
            t = measure(cfg)
            s["seconds_measured"] = t
    """
    reg = registry or default_registry()
    extra: dict = {}
    t0 = time.perf_counter()
    try:
        yield extra
    finally:
        dt = time.perf_counter() - t0
        reg.histogram("span_seconds", "host span durations",
                      labels={"span": name},
                      buckets=SPAN_BUCKETS).observe(dt)
        # span's own keys win over caller fields (never a TypeError)
        merged = {**fields, **extra, "name": name, "seconds": dt}
        reg.log_event("span", **merged)


class phase:
    """One span of the program, as a context manager: a
    ``record_function`` range while a profiler is active, and an NVTX
    range where ``on_card`` (the tensors live on a CUDA device; a build
    of torch without CUDA has no NVTX). A class, not a generator: with
    no profiler active an enter and exit is a flag check and, on the
    card, an NVTX push and pop."""
    __slots__ = ("name", "on_card", "_range")

    def __init__(self, name: str, on_card: bool):
        self.name = name
        self.on_card = on_card
        self._range = None

    def __enter__(self):
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.on_card:
            torch.cuda.nvtx.range_push(self.name)

    def __exit__(self, *exc):
        if self.on_card:
            torch.cuda.nvtx.range_pop()
        if self._range is not None:
            self._range.__exit__(*exc)


def profile(fn, *args, trace_dir: str | None = None,
            registry: MetricsRegistry | None = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under ``torch.profiler.profile``
    (CPU activity, and CUDA activity where a card is there), synchronise
    the card so the trace covers the real device work, and export a
    Chrome/Perfetto trace into ``trace_dir``.

    Returns ``(result, trace_path)``; the trace (``trace.json``) carries
    the engine's ``kpynq/*`` phase ranges around the kernels they
    launched. ``trace_dir=None`` creates one under the system temp dir.
    Also logged as a ``profile`` event in the registry so the export
    names the artifact path.
    """
    from torch.profiler import ProfilerActivity

    if trace_dir is None:
        trace_dir = tempfile.mkdtemp(prefix="kpynq_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        out = fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    path = os.path.join(str(trace_dir), "trace.json")
    prof.export_chrome_trace(path)
    (registry or default_registry()).log_event(
        "profile", trace_dir=str(trace_dir), trace=path, seconds=dt,
        fn=getattr(fn, "__name__", repr(fn)))
    return out, path
