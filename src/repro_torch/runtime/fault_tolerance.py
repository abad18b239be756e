"""Fault-tolerant driver: restart on failure, stragglers, chaos (port of
``repro.runtime.fault_tolerance``, single device).

* :class:`ResilientLoop` drives (step fn, pipeline, checkpointer); on an
  injected failure it restores the last good checkpoint and replays.
  The pipeline is (seed, step)-deterministic, so replay is bit for bit
  the uninterrupted run: there is no data-loader state to recover.
* :class:`StragglerWatchdog`: a step-time EWMA; a step slower than
  ``threshold`` times the EWMA is flagged.
* :class:`FailureInjector`: deterministic chaos for tests.

``ElasticController`` (re-targeting a sharded train state's checkpoint
onto another mesh) belongs to the sharded train state, ROADMAP Queue 1
item 11.5. The k-means stream's elastic path needs none of it: it is
``StreamingKMeans.restore(d, mesh=...)`` over host state that is the
same on every rank.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .._unported import ITEM_11_5
from ..checkpoint.checkpoint import (restore_checkpoint, save_checkpoint,
                                     tree_flatten)


class InjectedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Raise InjectedFailure at the listed global steps (once each)."""
    fail_at: tuple = ()
    seen: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at and step not in self.seen:
            self.seen.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")


class StragglerWatchdog:
    def __init__(self, threshold: float = 3.0, alpha: float = 0.3,
                 on_straggler: Optional[Callable] = None):
        self.threshold = threshold
        self.alpha = alpha
        self.ewma: float | None = None
        self.events: list[dict] = []
        self.on_straggler = on_straggler

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = (self.ewma is not None
                        and dt > self.threshold * self.ewma)
        if is_straggler:
            evt = {"step": step, "dt": dt, "ewma": self.ewma}
            self.events.append(evt)
            if self.on_straggler:
                self.on_straggler(evt)
        # the EWMA leaves outliers out, so one straggler does not mask
        # the next
        if not is_straggler:
            self.ewma = dt if self.ewma is None else \
                (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler

    def observe_shards(self, step: int, times) -> list[int]:
        """Per-shard variant: flag the shards whose step time (or
        per-shard work) exceeds ``threshold`` times the cross-shard
        median at this step; returns their indices, and each event
        carries its shard. The EWMA tracks the median (one observation a
        step), so ``observe`` and ``observe_shards`` can share a
        watchdog."""
        times = np.asarray(times, np.float64)
        med = float(np.median(times))
        flagged: list[int] = []
        if med > 0:
            for s, dt in enumerate(times):
                if dt > self.threshold * med:
                    evt = {"step": step, "shard": int(s),
                           "dt": float(dt), "median": med}
                    self.events.append(evt)
                    flagged.append(int(s))
                    if self.on_straggler:
                        self.on_straggler(evt)
            self.ewma = med if self.ewma is None else \
                (1 - self.alpha) * self.ewma + self.alpha * med
        return flagged


def _state_device(state):
    """The device of ``state``'s first tensor leaf (``None``, which
    means ``cuda``, when it holds none)."""
    for leaf in tree_flatten(state)[0]:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


class ResilientLoop:
    """Checkpoint/restart training driver.

    The default save and restore treat ``state`` as a fixed-structure
    nested state of tensors (:func:`save_checkpoint` /
    :func:`restore_checkpoint`, restored onto the device of its first
    tensor). Drivers whose state is richer (``repro_torch.streaming``'s
    resilient layer: a float64 host ledger, a bound cache whose
    structure changes between checkpoints, host scalars) pass their own:

    * ``save_fn(state, step) -> Thread | None`` replaces the default
      write (return the async writer thread, or ``None`` when the save
      was synchronous);
    * ``restore_fn(state) -> (state, step)`` replaces the default
      restore.

    Only :class:`InjectedFailure` is recovered: any other error, a CUDA
    fault included, propagates.
    """

    def __init__(self, step_fn, pipeline, ckpt_dir, *,
                 ckpt_every: int = 50, injector: FailureInjector | None = None,
                 watchdog: StragglerWatchdog | None = None,
                 max_restarts: int = 8, async_ckpt: bool = True,
                 save_fn=None, restore_fn=None):
        self.step_fn = step_fn
        self.pipeline = pipeline
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.injector = injector
        self.watchdog = watchdog or StragglerWatchdog()
        self.max_restarts = max_restarts
        self.async_ckpt = async_ckpt
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.restarts = 0
        self.metrics_log: list[dict] = []

    def _save(self, state, step: int):
        if self.save_fn is not None:
            return self.save_fn(state, step)
        return save_checkpoint(self.ckpt_dir, step, state,
                               async_=self.async_ckpt)

    def _restore(self, state):
        if self.restore_fn is not None:
            return self.restore_fn(state)
        return restore_checkpoint(self.ckpt_dir, state,
                                  device=_state_device(state))

    def run(self, state, n_steps: int, *, state_shardings=None,
            start_step: int | None = None):
        if state_shardings is not None:
            raise NotImplementedError(
                f"ResilientLoop.run(state_shardings=...) is not ported "
                f"yet: {ITEM_11_5}")
        if start_step is not None:
            step = int(start_step)
        else:
            step = int(state.step) if hasattr(state, "step") else 0
        anchor = self._save(state, step)              # step anchor
        if anchor is not None:
            anchor.join()
        pending = None
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                if self.injector:
                    self.injector.check(step)
                batch = self.pipeline.global_batch(step)
                state, metrics = self.step_fn(state, batch)
                # float() waits for the device, as block_until_ready does
                values = {k: float(v) for k, v in (metrics or {}).items()}
                dt = time.perf_counter() - t0
                self.watchdog.observe(step, dt)
                self.metrics_log.append({"step": step, "dt": dt, **values})
                step += 1
                if step % self.ckpt_every == 0:
                    if pending is not None:
                        pending.join()
                    pending = self._save(state, step)
            except InjectedFailure:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                if pending is not None:
                    pending.join()
                    pending = None
                state, step = self._restore(state)
        if pending is not None:
            pending.join()
        return state
