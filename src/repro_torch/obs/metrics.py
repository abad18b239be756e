"""Metrics registry + exporters: counters, gauges, histograms, events
(port of ``repro.obs.metrics``).

The instrumentation substrate shared by the fit driver, the autotuner
and the serving engine. Design goals, in order:

1. **Zero cost when unused.** Nothing here touches torch; a registry
   is plain host python. The device-side telemetry (the per-iteration
   ring, :mod:`repro_torch.obs.ring`) is drained once at fit exit and
   only then published here.
2. **Two export formats.** ``to_prometheus()`` emits the Prometheus
   text exposition format (scrape-able as-is); ``export_jsonl()``
   writes the event log one JSON object per line.
3. **One registry, many publishers.** ``engine.fit(obs=...)``,
   ``KMeans(obs=...)``, the serving index and engine all write into the
   same structure, so a single export shows the whole run.
"""
from __future__ import annotations

import dataclasses
import json
import time


def _sanitize(name: str) -> str:
    """Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = []
    for i, ch in enumerate(name):
        if ch.isalnum() or ch in "_:":
            out.append(ch)
        else:
            out.append("_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def _fmt_labels(labels: dict | None) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_sanitize(k)}="{v}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    """Monotone counter (``inc`` only)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: dict | None = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        self.value += float(v)

    def _sample_lines(self):
        return [f"{_sanitize(self.name)}{_fmt_labels(self.labels)} "
                f"{self.value:g}"]


class Gauge:
    """Point-in-time value (``set``; ``inc`` for convenience)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: dict | None = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += float(v)

    def _sample_lines(self):
        return [f"{_sanitize(self.name)}{_fmt_labels(self.labels)} "
                f"{self.value:g}"]


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations <= its upper bound; ``+Inf`` is the total)."""

    kind = "histogram"
    DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                       0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self, name: str, help: str = "",
                 labels: dict | None = None, buckets=None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        self.bucket_counts = [0] * len(self.buckets)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.bucket_counts[i] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def _sample_lines(self):
        base = _sanitize(self.name)
        lines = []
        for ub, c in zip(self.buckets, self.bucket_counts):
            lbl = _fmt_labels({**self.labels, "le": f"{ub:g}"})
            lines.append(f"{base}_bucket{lbl} {c}")
        lbl = _fmt_labels({**self.labels, "le": "+Inf"})
        lines.append(f"{base}_bucket{lbl} {self.count}")
        lines.append(f"{base}_sum{_fmt_labels(self.labels)} {self.sum:g}")
        lines.append(f"{base}_count{_fmt_labels(self.labels)} "
                     f"{self.count}")
        return lines


class MetricsRegistry:
    """Named metrics + a JSONL event log.

    ``counter``/``gauge``/``histogram`` are get-or-create (re-requesting
    the same name returns the same instance; a kind mismatch raises —
    the usual registry contract). ``labels`` distinguish instances of
    one name, so per-dataset / per-shard series coexist.
    """

    def __init__(self):
        self._metrics: dict = {}
        self.events: list[dict] = []

    # -- get-or-create -----------------------------------------------------

    def _get(self, cls, name, help, labels, **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, help, labels, **kw)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "",
                labels: dict | None = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: dict | None = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: dict | None = None, buckets=None) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def metrics(self) -> list:
        return list(self._metrics.values())

    # -- event log ---------------------------------------------------------

    def log_event(self, event: str, **fields) -> dict:
        evt = {"event": event, "ts": time.time(), **fields}
        self.events.append(evt)
        return evt

    # -- exporters ---------------------------------------------------------

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one HELP/TYPE header per
        metric name, then its samples)."""
        lines = []
        seen_headers = set()
        for m in self._metrics.values():
            base = _sanitize(m.name)
            if base not in seen_headers:
                seen_headers.add(base)
                if m.help:
                    lines.append(f"# HELP {base} {m.help}")
                lines.append(f"# TYPE {base} {m.kind}")
            lines.extend(m._sample_lines())
        return "\n".join(lines) + ("\n" if lines else "")

    def export_prometheus(self, path) -> str:
        text = self.to_prometheus()
        with open(path, "w") as fh:
            fh.write(text)
        return str(path)

    def export_jsonl(self, path) -> str:
        """Event log, one JSON object per line (append-safe format;
        the file is rewritten whole each call)."""
        with open(path, "w") as fh:
            for evt in self.events:
                fh.write(json.dumps(evt, default=_json_default) + "\n")
        return str(path)

    def to_dict(self) -> dict:
        out = {}
        for m in self._metrics.values():
            key = m.name if not m.labels else \
                m.name + _fmt_labels(m.labels)
            if isinstance(m, Histogram):
                out[key] = {"count": m.count, "sum": m.sum,
                            "mean": m.mean}
            else:
                out[key] = m.value
        return out


def _json_default(o):
    try:
        import numpy as np
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, np.generic):
            return o.item()
    except ImportError:
        pass
    return str(o)


_default_registry: MetricsRegistry | None = None


def default_registry() -> MetricsRegistry:
    """The process-global registry (spans and drivers without an
    explicit ``obs=`` land here)."""
    global _default_registry
    if _default_registry is None:
        _default_registry = MetricsRegistry()
    return _default_registry


def reset_default_registry() -> MetricsRegistry:
    """Swap in a fresh global registry (tests; benchmark isolation)."""
    global _default_registry
    _default_registry = MetricsRegistry()
    return _default_registry


# --------------------------------------------------------------------------
# observability configuration (what drivers accept as ``obs=``)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ObsConfig:
    """Per-call observability switches.

    ring : record the device-resident per-iteration telemetry ring
        (:mod:`repro_torch.obs.ring`; drained once at fit exit).
    live_drain : additionally hand each ring row, as the iteration
        that wrote it ends, to the listeners registered with
        :func:`repro_torch.obs.ring.add_ring_listener` — for watching a
        long fit converge live. The row rides the loop's per-iteration
        read of its exit scalars (no read of its own), so
        ``host_syncs`` is unchanged; the listeners run on the host
        each iteration — leave it off for benchmarking.
    registry : where drivers publish their exit metrics/events
        (``None`` = the process-global :func:`default_registry`).
    """
    ring: bool = True
    live_drain: bool = False
    registry: MetricsRegistry | None = None

    def resolve_registry(self) -> MetricsRegistry:
        return self.registry or default_registry()


def normalize_obs(obs) -> ObsConfig | None:
    """Coerce a driver's ``obs=`` argument: ``None``/``False`` =
    disabled, ``True`` = defaults, a :class:`MetricsRegistry` =
    defaults publishing there, an :class:`ObsConfig` = itself."""
    if obs is None or obs is False:
        return None
    if obs is True:
        return ObsConfig()
    if isinstance(obs, MetricsRegistry):
        return ObsConfig(registry=obs)
    if isinstance(obs, ObsConfig):
        return obs
    raise TypeError(f"obs must be None, bool, MetricsRegistry or "
                    f"ObsConfig, got {type(obs).__name__}")


# --------------------------------------------------------------------------
# provenance (an attribution block for measurement records)
# --------------------------------------------------------------------------

def provenance() -> dict:
    """Attribution block for measurement records: git sha, torch
    version, device platform (``cuda`` or ``cpu``), the card's name,
    device count, timestamp. Every field degrades gracefully (no git /
    no card -> placeholders), so stamping can never fail a run."""
    rec = {"timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
           "git_sha": "unknown", "torch_version": "unknown",
           "platform": "unknown", "device_name": "unknown",
           "device_count": 0}
    try:
        import subprocess
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10)
        if sha.returncode == 0:
            rec["git_sha"] = sha.stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain"], capture_output=True,
            text=True, timeout=10)
        if dirty.returncode == 0:
            rec["git_dirty"] = bool(dirty.stdout.strip())
    except Exception:
        pass
    try:
        import torch
        rec["torch_version"] = torch.__version__
        if torch.cuda.is_available():
            rec["platform"] = "cuda"
            rec["device_name"] = torch.cuda.get_device_name()
            rec["device_count"] = torch.cuda.device_count()
        else:
            rec["platform"] = "cpu"
            rec["device_name"] = "cpu"
            rec["device_count"] = 1
    except Exception:
        pass
    return rec
