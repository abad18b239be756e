"""repro_torch.obs — observability for the port's engine (port of
``repro.obs``).

Three layers:

* :mod:`repro_torch.obs.ring` — the device-resident per-iteration
  telemetry ring: layout constants, shard-ring reduction, summaries,
  the live-drain listener registry. The device side lives in
  ``repro_torch.core.engine`` (``EngineCarry.ring``); this module owns
  the host-side semantics.
* :mod:`repro_torch.obs.trace` — phase tracing: ``record_function`` /
  NVTX device phases (annotated in the engine), :func:`profile` for
  Perfetto traces, :func:`span` for host wall-clock spans.
* :mod:`repro_torch.obs.metrics` — the metrics registry
  (counter/gauge/histogram + JSONL event log) with Prometheus-text and
  JSONL exporters, published by the fit driver and the serving path.

This package imports nothing from ``repro_torch.core`` so the engine
can import it without cycles.
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      ObsConfig, default_registry, normalize_obs,
                      provenance, reset_default_registry)
from .ring import (N_COUNTERS, RING_COLUMNS, add_ring_listener,
                   caps_from_ring, format_ring_table, reduce_shard_rings,
                   remove_ring_listener, shard_skew, summarize_ring)
from .trace import profile, span

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "ObsConfig",
    "default_registry", "normalize_obs", "provenance",
    "reset_default_registry",
    "N_COUNTERS", "RING_COLUMNS", "add_ring_listener", "caps_from_ring",
    "format_ring_table", "reduce_shard_rings", "remove_ring_listener",
    "shard_skew", "summarize_ring",
    "profile", "span",
]
