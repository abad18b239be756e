"""The port's fault-tolerant runtime (``repro_torch.runtime``) against
the JAX package's, on the CPU.

* ``FailureInjector`` and ``StragglerWatchdog`` (``observe`` and
  ``observe_shards``) fed the same steps and step times: the same raises,
  the same events and the same EWMA bits.
* ``ResilientLoop``'s default path (``save_checkpoint`` /
  ``restore_checkpoint`` of the whole state) on a toy state, a step
  counter and an f32 vector updated from a seeded ``global_batch``, with
  the same failures injected: the final state bit for bit the
  reference's (the update is one add and one multiply, which round the
  same in both packages) and the uninterrupted run's.

The reference's four train-step cases wait for the LM training port
(ROADMAP Queue 1 item 11.1); its straggler case is here.
"""
from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import FailureInjector as JaxInjector
from repro.runtime import InjectedFailure as JaxInjectedFailure
from repro.runtime import ResilientLoop as JaxLoop
from repro.runtime import StragglerWatchdog as JaxWatchdog
from repro_torch.runtime import (FailureInjector, InjectedFailure,
                                 ResilientLoop, StragglerWatchdog)

State = namedtuple("State", "step w")
DIM = 16


def test_straggler_watchdog_flags_slow_steps():
    wd = StragglerWatchdog(threshold=2.0)
    flags = [wd.observe(i, dt) for i, dt in
             enumerate([1.0, 1.1, 0.9, 5.0, 1.0, 1.05])]
    assert flags == [False, False, False, True, False, False]
    assert len(wd.events) == 1 and wd.events[0]["step"] == 3
    # EWMA not polluted by the straggler
    assert wd.ewma < 1.2


def _dts(seed, n=40):
    rng = np.random.default_rng(seed)
    dts = rng.lognormal(0.0, 0.2, n)
    dts[rng.choice(n, 4, replace=False)] *= rng.uniform(3, 9, 4)
    return [float(x) for x in dts]


@pytest.mark.parametrize("threshold,alpha,seed", [(3.0, 0.3, 0), (2.0, 0.1, 1),
                                                  (1.5, 0.5, 2)])
def test_watchdog_matches_reference(threshold, alpha, seed):
    seen, jseen = [], []
    wd = StragglerWatchdog(threshold, alpha, on_straggler=seen.append)
    jwd = JaxWatchdog(threshold, alpha, on_straggler=jseen.append)
    rng = np.random.default_rng(seed + 10)
    for step, dt in enumerate(_dts(seed)):
        if step % 3 == 2:        # per-shard times, one slow shard or none
            times = rng.lognormal(0.0, 0.1, 8)
            if step % 2:
                times[rng.integers(8)] *= 6.0
            assert wd.observe_shards(step, times) == \
                jwd.observe_shards(step, times)
        else:
            assert wd.observe(step, dt) == jwd.observe(step, dt)
        assert wd.ewma == jwd.ewma                   # the same bits
    assert wd.events == jwd.events and seen == jseen
    assert any("shard" in e for e in wd.events)
    assert any("ewma" in e for e in wd.events)


def test_failure_injector_matches_reference():
    inj, jinj = FailureInjector((2, 5, 5)), JaxInjector((2, 5, 5))
    for step in (0, 2, 2, 5, 3, 5, 7):
        raised = jraised = False
        try:
            inj.check(step)
        except InjectedFailure:
            raised = True
        try:
            jinj.check(step)
        except JaxInjectedFailure:
            jraised = True
        assert raised == jraised, step
    assert inj.seen == jinj.seen == {2, 5}


class _Pipe:
    def global_batch(self, step):
        x = np.random.default_rng((3, step)).standard_normal(DIM)
        return {"x": x.astype(np.float32)}


def _torch_step(state, batch):
    w = (state.w + torch.from_numpy(batch["x"])) * 0.5
    return State(state.step + 1, w), {"w0": w[0]}


def _jax_step(state, batch):
    w = (state.w + jnp.asarray(batch["x"])) * 0.5
    return State(state.step + 1, w), {"w0": w[0]}


def _run(loop_cls, injector_cls, state, step_fn, ckpt_dir, fail_at,
         async_ckpt):
    loop = loop_cls(step_fn, _Pipe(), ckpt_dir, ckpt_every=4,
                    injector=injector_cls(fail_at), async_ckpt=async_ckpt)
    return loop, loop.run(state, 14)


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_resilient_loop_default_path_matches_reference(tmp_path, async_ckpt):
    t0 = State(torch.tensor(0, dtype=torch.int32), torch.zeros(DIM))
    j0 = State(jnp.int32(0), jnp.zeros((DIM,), jnp.float32))
    fail_at = (5, 11)
    loop, got = _run(ResilientLoop, FailureInjector, t0, _torch_step,
                     tmp_path / "t", fail_at, async_ckpt)
    jloop, want = _run(JaxLoop, JaxInjector, j0, _jax_step, tmp_path / "j",
                       fail_at, async_ckpt)
    _, clean = _run(ResilientLoop, FailureInjector, t0, _torch_step,
                    tmp_path / "c", (), async_ckpt)
    assert loop.restarts == jloop.restarts == 2
    assert int(got.step) == int(want.step) == 14
    assert got.w.dtype == torch.float32
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))
    np.testing.assert_array_equal(got.w.numpy(), clean.w.numpy())
    # replayed steps are logged again, as in the reference
    assert [m["step"] for m in loop.metrics_log] == \
        [m["step"] for m in jloop.metrics_log]
    assert [m["w0"] for m in loop.metrics_log] == \
        [m["w0"] for m in jloop.metrics_log]


def test_only_injected_failures_are_recovered(tmp_path):
    def broken(state, batch):
        raise RuntimeError("CUDA error: an illegal memory access")

    t0 = State(torch.tensor(0, dtype=torch.int32), torch.zeros(DIM))
    loop = ResilientLoop(broken, _Pipe(), tmp_path, async_ckpt=False)
    with pytest.raises(RuntimeError, match="illegal memory"):
        loop.run(t0, 4)
    assert loop.restarts == 0
    # the restart budget: the same step failing again re-raises
    loop = ResilientLoop(_torch_step, _Pipe(), tmp_path / "b", ckpt_every=4,
                         injector=FailureInjector((3,)), max_restarts=0,
                         async_ckpt=False)
    with pytest.raises(InjectedFailure):
        loop.run(t0, 8)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1 item 11.5"):
        loop.run(t0, 8, state_shardings=object())
