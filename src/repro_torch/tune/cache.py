"""Persistent per-(platform, N, K, D) tuning cache (port of
``repro.tune.cache``).

One JSON file maps problem signatures to their measured-best
:class:`~repro_torch.core.engine.EngineConfig` plus the measurements
that justified it, in the reference's format and ``VERSION``. The port
has a file and a variable of its own, so it never writes the JAX
package's cache: ``~/.cache/repro_torch_kmeans_tune.json``, or
``$REPRO_TORCH_KMEANS_TUNE_CACHE``, or an explicit
``TuneCache(path=...)``.

The cache is loaded once per instance and written through on every
store. A corrupt or version-mismatched file is treated as empty
(tuning is always safe to redo: it never changes results, only
wall-clock). One instance may be used from several threads (the serving
thread and the caller may both store): a lock guards the entries, and
each write goes through a temporary file named by process and thread,
renamed over the cache in one step.
"""
from __future__ import annotations

import json
import os
import threading

from ..core.engine import EngineConfig

ENV_VAR = "REPRO_TORCH_KMEANS_TUNE_CACHE"
VERSION = 1


def default_path() -> str:
    env = os.environ.get(ENV_VAR)
    if env:
        return os.path.expanduser(env)
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "repro_torch_kmeans_tune.json")


class TuneCache:
    """Disk-backed signature -> tuned-config map (see module docstring).

    ``path=None`` resolves :func:`default_path` at construction time
    (so the env var is honoured per instance, not per import).
    """

    def __init__(self, path: str | None = None):
        self.path = path if path is not None else default_path()
        self._entries: dict | None = None        # lazy-loaded
        self._lock = threading.RLock()

    # -- persistence -------------------------------------------------------

    def load(self, reload: bool = False) -> dict:
        with self._lock:
            if self._entries is not None and not reload:
                return self._entries
            self._entries = {}
            try:
                with open(self.path) as fh:
                    payload = json.load(fh)
                if isinstance(payload, dict) and \
                        payload.get("version") == VERSION:
                    self._entries = dict(payload.get("entries", {}))
            except (FileNotFoundError, ValueError, OSError):
                pass
            return self._entries

    def save(self) -> None:
        with self._lock:
            payload = {"version": VERSION, "entries": self.load()}
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            # never leave a torn JSON behind for the next process: write
            # a temporary of this process and thread, then rename it
            tmp = f"{self.path}.{os.getpid()}.{threading.get_ident()}.tmp"
            try:
                with open(tmp, "w") as fh:
                    json.dump(payload, fh, indent=2, sort_keys=True)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

    # -- access ------------------------------------------------------------

    def entry(self, sig: str) -> dict | None:
        """Raw cache record (config + measurements) or None."""
        return self.load().get(sig)

    def lookup(self, sig: str) -> EngineConfig | None:
        e = self.entry(sig)
        if not e or "config" not in e:
            return None
        return EngineConfig.from_dict(e["config"])

    def store(self, sig: str, config, *, persist: bool = True,
              **meta) -> None:
        """Store ``config`` (an ``EngineConfig`` or ``ServeConfig``);
        ``persist=False`` keeps it in memory only (the ranks of a mesh
        but the one that writes the file)."""
        with self._lock:
            self.load()[sig] = {"config": config.to_dict(), **meta}
            if persist:
                self.save()

    def drop(self, sig: str) -> None:
        with self._lock:
            if self.load().pop(sig, None) is not None:
                self.save()

    def clear(self) -> None:
        with self._lock:
            self._entries = {}
            self.save()

    def signatures(self) -> list:
        return sorted(self.load())


_default: TuneCache | None = None


def default_cache() -> TuneCache:
    """Process-wide cache singleton (what ``engine.fit`` consults)."""
    global _default
    if _default is None:
        _default = TuneCache()
    return _default


def set_default_cache(cache: TuneCache | str | None) -> TuneCache:
    """Replace the process-wide cache (tests, measuring scripts).
    Accepts a TuneCache, a path, or None to re-resolve the default."""
    global _default
    if isinstance(cache, str):
        cache = TuneCache(cache)
    _default = cache
    return default_cache()
