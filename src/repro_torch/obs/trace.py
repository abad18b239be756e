"""Phase tracing: wall-clock spans + profiler traces (port of
``repro.obs.trace``).

Two granularities:

* **Device phases** — the engine's loop body runs its phases inside
  :func:`phase` ranges (``kpynq/candidate_pass``,
  ``kpynq/move_and_bounds``, ``kpynq/ring_write``): a
  ``torch.profiler.record_function`` range, and on the card an NVTX
  range as well, so any profiler view of a fit attributes kernels to
  engine phases. They stand where the reference has
  ``jax.named_scope``. :func:`profile` runs a callable under
  ``torch.profiler`` and exports a Chrome/Perfetto trace (open at
  https://ui.perfetto.dev).
* **Host spans** — :func:`span` is a context manager timing a host
  region into a registry histogram + event (used by ``tune.autotune``
  around each measured candidate).
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

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


@contextlib.contextmanager
def phase(name: str, on_card: bool):
    """One engine phase: a ``record_function`` range, plus an NVTX
    range where ``on_card`` (the tensors live on a CUDA device; a build
    of torch without CUDA has no NVTX)."""
    import torch
    with torch.profiler.record_function(name):
        if on_card:
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


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
    import torch
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
