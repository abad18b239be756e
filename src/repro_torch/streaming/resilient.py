"""Fault-tolerant streaming fits: checkpoint, restore, replay (port of
``repro.streaming.resilient``).

The glue between three pieces:

* :class:`repro_torch.streaming.StreamingKMeans`, which snapshots and
  restores its full stream state (centroids, EMA counts, float64 drift
  ledger, per-shard bound cache, reseed reservoir, stats);
* :mod:`repro_torch.checkpoint`: atomic async saves with validated,
  corruption-tolerant restore;
* :class:`repro_torch.runtime.ResilientLoop`, the restart-on-failure
  driver with its ``FailureInjector`` chaos hooks.

The recovery contract is replay, not approximation. The stream source
speaks the deterministic ``global_batch(step)`` protocol
(:class:`repro_torch.data.PointStream` regenerates shard ``s`` bit for
bit), so after a failure the loop restores the newest complete
checkpoint and re-runs the batches the dead run saw after it. Every
replayed step runs the same kernels on bit-identical inputs (the
checkpoint restores every input bit for bit, the float64 ledger
included, which never passes through a tensor), and the kernels sum in
a fixed order (``centroid_update`` has no atomics), so the centroids,
counts, ledger and bound cache land bit for bit on an uninterrupted
run's. Only :class:`StreamStats` differs: replayed work is counted
(``replayed_batches``, ``restores``, ``ckpt_saves``).

Sharded (``StreamingKMeans(mesh=...)``): every rank of the mesh runs
the loop with the same stream and the same injector. Rank 0 of the mesh
writes the checkpoints into a directory every rank reads, and the ranks
wait at a barrier on the mesh's group before the fit looks for an
existing checkpoint and, after each save has been joined, before any
rank restores; so every rank restores the same step. Bit parity holds
for the same mesh. Elasticity rides on the same files: a checkpoint
taken under one mesh restores under any other or none
(:meth:`StreamingKMeans.restore`), where another partition of the
reduction makes it numerical parity, not bit parity.

Observability: with ``obs`` on the estimator, recovery is visible as
``ckpt_saves_total``, ``ckpt_save_seconds``, ``ckpt_last_step``,
``restore_total``, ``restore_step`` and ``replay_batches_total``, and as
``ckpt_save`` and ``restore`` events in the registry's log.
"""
from __future__ import annotations

import time

from ..checkpoint.checkpoint import available_steps
from ..runtime.fault_tolerance import ResilientLoop


class _TrackingPipeline:
    """``global_batch`` passthrough that remembers the step it served:
    the step function needs the schedule index to count replays, and
    the ``ResilientLoop`` protocol does not pass it."""

    def __init__(self, stream):
        self.stream = stream
        self.last_step = 0

    def global_batch(self, step: int):
        self.last_step = step
        return self.stream.global_batch(step)


def fit_stream_resilient(skm, stream, *, ckpt_dir, epochs: int = 1,
                         max_batches: int | None = None,
                         ckpt_every: int = 8, injector=None,
                         watchdog=None, max_restarts: int = 8,
                         async_ckpt: bool = True, resume: bool = True):
    """Drive ``skm`` over ``stream`` with checkpoint/restore-replay
    fault tolerance (see the module docstring for the contract).

    ``stream`` must provide ``global_batch(step)`` and ``__len__``
    (batches an epoch). ``ckpt_every`` is in batches; saves are async by
    default (the writer is joined before the next save and at exit).
    ``resume=True`` picks up an existing checkpoint directory. Failures
    beyond ``max_restarts`` re-raise.
    """
    if not (hasattr(stream, "global_batch") and hasattr(stream, "__len__")):
        raise ValueError(
            "resilient fit needs a deterministic global_batch(step) "
            "stream with a known length (e.g. repro_torch.data.PointStream);"
            " got " + type(stream).__name__)
    n_steps = max(int(epochs), 1) * len(stream)
    if max_batches is not None:
        n_steps = min(n_steps, int(max_batches))
    reg = skm._obs.resolve_registry() if skm._obs is not None else None

    start = 0
    skm._barrier()         # a checkpoint from before is there for all
    if resume and available_steps(ckpt_dir):
        start = skm.restore_state(ckpt_dir, fallback=True)
        if reg is not None:
            reg.counter("restore_total", "stream-state restores").inc()
            reg.gauge("restore_step",
                      "schedule step of the last restore").set(start)
            reg.log_event("restore", step=start, reason="resume")
    pipe = _TrackingPipeline(stream)
    high_water = start

    def step_fn(state, batch):
        nonlocal high_water
        step = pipe.last_step
        if step < high_water:
            skm.stats_.replayed_batches += 1
            if reg is not None:
                reg.counter("replay_batches_total",
                            "batches re-run after a restore").inc()
        else:
            high_water = step + 1
        skm.partial_fit(batch["points"], shard_id=batch["shard_id"],
                        sample_weight=batch.get("sample_weight"))
        return skm, {}

    def save_fn(state, step):
        if not skm.initialized:
            return None        # nothing to save during the cold start
        t0 = time.perf_counter()
        thread = skm.save(ckpt_dir, step, async_=async_ckpt)
        if reg is not None:
            reg.counter("ckpt_saves_total",
                        "stream-state checkpoints written").inc()
            reg.gauge("ckpt_last_step",
                      "schedule step of the last checkpoint").set(step)
            reg.histogram(
                "ckpt_save_seconds",
                "state snapshot (plus write when sync)").observe(
                time.perf_counter() - t0)
            reg.log_event("ckpt_save", step=step,
                          cache_entries=len(skm._cache),
                          async_=bool(async_ckpt))
        return thread

    def restore_fn(state):
        # the loop joined rank 0's writer: the newest save is published
        skm._barrier()
        if available_steps(ckpt_dir):
            step = skm.restore_state(ckpt_dir, fallback=True)
            reason = "failure"
        else:
            # died before the first complete checkpoint: a cold restart;
            # replaying the deterministic stream from step 0 reproduces
            # the original cold start bit for bit
            skm.reset_state()
            skm.stats_.restores += 1
            step, reason = 0, "failure-before-first-checkpoint"
        if reg is not None:
            reg.counter("restore_total", "stream-state restores").inc()
            reg.gauge("restore_step",
                      "schedule step of the last restore").set(step)
            reg.log_event("restore", step=step, reason=reason)
        return skm, step

    loop = ResilientLoop(step_fn, pipe, ckpt_dir, ckpt_every=ckpt_every,
                         injector=injector, watchdog=watchdog,
                         max_restarts=max_restarts, async_ckpt=async_ckpt,
                         save_fn=save_fn, restore_fn=restore_fn)
    loop.run(skm, n_steps, start_step=start)
    if skm.initialized:
        # terminal sync save, so a later resume continues exactly here
        skm.save(ckpt_dir, n_steps, async_=False)
        if reg is not None:
            reg.counter("ckpt_saves_total",
                        "stream-state checkpoints written").inc()
            reg.gauge("ckpt_last_step",
                      "schedule step of the last checkpoint").set(n_steps)
    return skm
