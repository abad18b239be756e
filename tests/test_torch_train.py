"""The port's LM training (``repro_torch.train``, ``.optim.adamw``,
``models.loss_fn``, ``models.layers.cross_entropy_chunked``, the two
LM kernels' backward) against the JAX package's, on the CPU.

Reduced configs (fp32) with JAX's weights carried across
(``convert.lm_params_from_numpy`` / ``train_state_from_numpy``); the
same numpy batches (``TokenPipeline``) go through both packages. JAX's
steps are jitted once per module. On the CPU the port's kernels take
their plain versions, and autograd differentiates them.

Tolerances, each stated against the largest |value| of JAX's output
(or of the leaf): the loss and cross-entropy 1e-5 (fp32 sums in
another order); gradients 1e-4 of each leaf's scale (a layer stack's
backward in fp32, summation orders apart); AdamW leaf for leaf 1e-6 on
the same inputs; a whole train step's updated leaves 1e-4 (the update
divides by sqrt(v), which carries the gradients' differences); the
backward formulas of the kernels 1e-5 against autograd and against
``jax.vjp`` of the reference's oracles.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.checkpoint import load_checkpoint_arrays as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_config as jax_config
from repro.data import TokenPipeline as JaxPipeline
from repro.kernels.ref import flash_attention_ref, ssd_intra_ref
from repro.models.layers import cross_entropy_chunked as jax_ce
from repro.optim import adamw as jadamw
from repro.train.steps import init_train_state as jax_init_state
from repro.train.steps import make_train_step as jax_make_step
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.checkpoint import tree_flatten
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.data import TokenPipeline
from repro_torch.models import loss_fn
from repro_torch.models.layers import cross_entropy_chunked
from repro_torch.optim import adamw
from repro_torch.runtime import (FailureInjector, InjectedFailure,
                                 ResilientLoop)
from repro_torch.train import (init_train_state, loss_and_grads,
                               make_train_step)

fla = importlib.import_module("repro_torch.kernels.flash_attention")
ssd = importlib.import_module("repro_torch.kernels.ssd_intra")

# dense, ssm, hybrid, MLA, MoE (top-2 and top-1)
ARCHS = ["qwen2-7b", "mamba2-780m", "hymba-1.5b", "minicpm3-4b",
         "qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"]
CPU = dict(device="cpu")


def _reduced(cfg):
    """The reduced config; a MoE one at ample capacity (``n_experts /
    moe_top_k``), where no pair drops: the reference's overflow is faulty
    (ROADMAP.md Queue 3 item 12, held in ``tests/test_torch_moe.py``)."""
    cfg = cfg.reduced()
    if cfg.family == "moe":
        cfg = dataclasses.replace(
            cfg, moe_capacity_factor=cfg.n_experts / cfg.moe_top_k)
    return cfg


def _scaled(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-12)


def state_cfg(arch):
    return _reduced(get_config(arch))


def _batch(cfg, seed=0, step=0, b=2, s=32):
    return TokenPipeline(cfg, batch=b, seq=s, seed=seed).global_batch(step)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_fns():
    """JAX's loss, value-and-grad and train step, jitted once per config."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = _reduced(jax_config(arch))
            cache[arch] = dict(
                cfg=jcfg,
                loss=jax.jit(lambda p, b: jm.loss_fn(p, b, jcfg)),
                grad=jax.jit(jax.value_and_grad(
                    lambda p, b: jm.loss_fn(p, b, jcfg))),
                step=jax.jit(jax_make_step(jcfg)))
        return cache[arch]

    return get


@pytest.fixture(scope="module")
def states():
    """JAX's fresh train state per config (numpy leaves) and the
    port's copy of it."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = _reduced(jax_config(arch))
            jstate = jax_init_state(jax.random.PRNGKey(0), jcfg)
            cfg = state_cfg(arch)
            npstate = jax.tree.map(np.asarray, jstate)
            cache[arch] = (jstate, train_state_from_numpy(npstate, cfg,
                                                          **CPU))
        return cache[arch]

    return get


# -- cross-entropy and the loss -----------------------------------------------

@pytest.mark.parametrize("s,chunk,masked", [(64, 32, False), (64, 32, True),
                                            (48, 1000, False),
                                            (96, 40, True)])
def test_cross_entropy_chunked_matches_jax(s, chunk, masked):
    rng = np.random.default_rng(s + chunk)
    b, d, v = 2, 16, 70
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    head = rng.standard_normal((d, v)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.7).astype(np.float32) if masked else None
    want = jax_ce(jnp.asarray(hidden), jnp.asarray(head),
                  jnp.asarray(labels), chunk=chunk,
                  mask=None if mask is None else jnp.asarray(mask))
    got = cross_entropy_chunked(
        torch.from_numpy(hidden), torch.from_numpy(head),
        torch.from_numpy(labels), chunk=chunk,
        mask=None if mask is None else torch.from_numpy(mask))
    assert _scaled(got, want) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch, jax_fns, states):
    fns = jax_fns(arch)
    jstate, state = states(arch)
    batch = _batch(state_cfg(arch))
    want = fns["loss"](jstate.params, batch)
    got = loss_fn(state.params, _torch_batch(batch), state_cfg(arch))
    assert _scaled(got, want) <= 1e-5



@pytest.mark.parametrize("arch", ARCHS)
def test_autograd_gradients_match_jax_grad(arch, jax_fns, states):
    fns = jax_fns(arch)
    jstate, state = states(arch)
    cfg = state_cfg(arch)
    batch = _batch(cfg, seed=1)
    jloss, jgrads = fns["grad"](jstate.params, batch)
    loss, grads = loss_and_grads(state.params, _torch_batch(batch), cfg)
    assert _scaled(loss, jloss) <= 1e-5
    got, _, paths = tree_flatten(grads)
    want = jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    for g, w, p in zip(got, want, paths):
        assert _scaled(g, w) <= 1e-4, (p, _scaled(g, w))


def test_remat_changes_no_value(states):
    """``remat="full"`` (recompute each layer in the backward pass) and
    ``remat="none"`` give the same loss and gradients bit for bit."""
    _, state = states("hymba-1.5b")
    cfg = state_cfg("hymba-1.5b")
    batch = _torch_batch(_batch(cfg, seed=2))
    a = loss_and_grads(state.params, batch, cfg)
    b = loss_and_grads(state.params, batch,
                       dataclasses.replace(cfg, remat="none"))
    assert torch.equal(a[0], b[0])
    for x, y in zip(tree_flatten(a[1])[0], tree_flatten(b[1])[0]):
        assert torch.equal(x, y)


# -- AdamW -------------------------------------------------------------------

def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "n": {"u": (3, 4, 2), "s": (7,)}}

    def draw(scale=1.0, positive=False):
        def leaf(shp):
            a = rng.standard_normal(shp).astype(np.float32) * scale
            return np.abs(a) if positive else a
        return jax.tree.map(leaf, shapes, is_leaf=lambda x: isinstance(x,
                                                                       tuple))
    return draw(), draw(0.3), draw(0.1), draw(0.01, positive=True)


@pytest.mark.parametrize("step,clip", [(0, 1.0), (57, 1.0), (150, 1e3),
                                       (20_000, 0.5)])
def test_adamw_update_matches_jax(step, clip):
    params, grads, m, v = _opt_tree(step)
    cfg = adamw.AdamWConfig(warmup_steps=100, decay_steps=1000,
                            clip_norm=clip)
    jcfg = jadamw.AdamWConfig(*cfg)
    jp, jm_, jv, jmet = jax.jit(
        lambda g, m_, v_, p, s: jadamw.adamw_update(g, m_, v_, p, s, jcfg))(
        grads, m, v, params, jnp.int32(step))
    t = lambda tree: jax.tree.map(torch.from_numpy, tree)  # noqa: E731
    p, m2, v2, met = adamw.adamw_update(
        t(grads), t(m), t(v), t(params),
        torch.tensor(step, dtype=torch.int32), cfg)
    for got, want in ((p, jp), (m2, jm_), (v2, jv)):
        for a, b in zip(tree_flatten(got)[0], jax.tree.leaves(want)):
            assert _scaled(a, b) <= 1e-6
    for key in ("grad_norm", "lr"):
        assert _scaled(met[key], jmet[key]) <= 1e-6, key


def test_cosine_lr_matches_jax():
    cfg = adamw.AdamWConfig(warmup_steps=10, decay_steps=100)
    jcfg = jadamw.AdamWConfig(*cfg)
    steps = np.array([0, 1, 9, 10, 11, 55, 99, 100, 5000], np.int32)
    want = np.asarray(jax.jit(lambda s: jadamw.cosine_lr(s, jcfg))(steps))
    got = adamw.cosine_lr(torch.from_numpy(steps), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


# -- one train step ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, jax_fns, states):
    fns = jax_fns(arch)
    jstate, state = states(arch)
    cfg = state_cfg(arch)
    batch = _batch(cfg, seed=3, step=5)
    jnew, jmet = fns["step"](jstate, batch)
    new, met = make_train_step(cfg)(state, batch)
    assert int(new.step) == int(jnew.step) == 1
    for key, tol in (("loss", 1e-5), ("grad_norm", 1e-4), ("lr", 1e-6)):
        assert _scaled(met[key], jmet[key]) <= tol, key
    got, _, paths = tree_flatten(new)
    want = jax.tree.leaves(jnew)
    assert len(got) == len(want)
    for g, w, p in zip(got, want, paths):
        assert _scaled(g, w) <= 1e-4, (p, _scaled(g, w))
    # the step is functional: the state it was given is unchanged
    again, met2 = make_train_step(cfg)(state, batch)
    assert torch.equal(met["loss"], met2["loss"])
    for a, b in zip(tree_flatten(new)[0], tree_flatten(again)[0]):
        assert torch.equal(a, b)


def test_init_train_state_shapes_and_moments():
    cfg = state_cfg("hymba-1.5b")
    state = init_train_state(cfg, torch.Generator().manual_seed(0), **CPU)
    jshapes = jax.eval_shape(lambda k: jax_init_state(k, jax_config(
        "hymba-1.5b").reduced()), jax.random.PRNGKey(0))
    got, _, _ = tree_flatten(state)
    want = jax.tree.leaves(jshapes)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert [str(g.dtype).split(".")[-1] for g in got] == \
        [str(w.dtype) for w in want]
    assert all(not bool(x.any()) for x in tree_flatten(state.m)[0])


# -- the kernels' backward formulas ------------------------------------------

def _gqa_inputs(b, s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kv, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("b,s,h,kv,d", [(2, 13, 4, 2, 8), (1, 33, 6, 3, 16),
                                        (1, 20, 2, 2, 32)])
def test_flash_attention_bwd_plain_matches_autograd_and_jax(b, s, h, kv, d):
    q, k, v, do = _gqa_inputs(b, s, h, kv, d, s * h)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = fla.flash_attention_gqa_plain(tq, tk, tv)
    auto = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    got = fla.flash_attention_gqa_bwd_plain(tq.detach(), tk.detach(),
                                            tv.detach(), o.detach(),
                                            torch.from_numpy(do))
    rep = h // kv

    def ref(q_, k_, v_):          # the reference's oracle, heads repeated
        kh = jnp.repeat(k_.swapaxes(1, 2), rep, axis=1)
        vh = jnp.repeat(v_.swapaxes(1, 2), rep, axis=1)
        return flash_attention_ref(q_.swapaxes(1, 2), kh, vh).swapaxes(1, 2)

    _, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    for g, a, w in zip(got, auto, jgrads):
        assert _scaled(g, a.numpy()) <= 1e-5
        assert _scaled(g, w) <= 1e-5


@pytest.mark.parametrize("bsz,nc,q,h,g,n,p", [(2, 3, 8, 4, 1, 8, 32),
                                              (1, 2, 16, 4, 2, 16, 16),
                                              (1, 1, 20, 3, 3, 4, 8)])
def test_ssd_intra_bwd_plain_matches_autograd_and_jax(bsz, nc, q, h, g, n, p):
    rng = np.random.default_rng(q * h)
    C, B = (rng.standard_normal((bsz, nc, q, g, n)).astype(np.float32)
            for _ in range(2))
    x, dy = (rng.standard_normal((bsz, nc, q, h, p)).astype(np.float32)
             for _ in range(2))
    cum = np.cumsum(-np.logaddexp(rng.standard_normal((bsz, nc, q, h)), 0.0),
                    axis=2).astype(np.float32)
    tin = [torch.from_numpy(a).requires_grad_(True) for a in (C, B, x, cum)]
    y = ssd.ssd_intra_chunks_plain(*tin)
    auto = torch.autograd.grad(y, tin, torch.from_numpy(dy))
    got = ssd.ssd_intra_chunks_bwd_plain(*(t.detach() for t in tin),
                                         torch.from_numpy(dy))
    rep = h // g

    def ref(C_, B_, x_, cum_):    # the reference's oracle, one cell a head
        cells = lambda t: t.transpose(0, 1, 3, 2, 4).reshape(  # noqa: E731
            -1, q, t.shape[-1])
        Ch, Bh = (jnp.repeat(t, rep, axis=3) for t in (C_, B_))
        out = ssd_intra_ref(cells(Ch), cells(Bh), cells(x_),
                            cum_.transpose(0, 1, 3, 2).reshape(-1, q))
        return out.reshape(bsz, nc, h, q, p).transpose(0, 1, 3, 2, 4)

    _, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (C, B, x, cum)))
    jgrads = vjp(jnp.asarray(dy))
    for gr, a, w in zip(got, auto, jgrads):
        assert _scaled(gr, a.numpy()) <= 1e-5
        assert _scaled(gr, w) <= 1e-5


def test_ssd_function_refuses_a_chunk_before_its_forward():
    """No chunk is refused any more: the backward kernel has a route for
    chunks over ``Q_CELL`` rows (a tiled one, held on the card by the
    ``cuda`` tests). Here the plain route of the autograd Function at a
    ragged Q = 200 against ``jax.vjp`` of the reference's oracle, within
    1e-5 of each gradient's scale."""
    assert not hasattr(ssd, "MAX_Q_BWD")
    q, h, g, n, p = 200, 4, 2, 8, 16
    assert q > ssd.Q_CELL
    rng = np.random.default_rng(q)
    C, B = (rng.standard_normal((1, 1, q, g, n)).astype(np.float32)
            for _ in range(2))
    x, dy = (rng.standard_normal((1, 1, q, h, p)).astype(np.float32)
             for _ in range(2))
    cum = np.cumsum(-np.logaddexp(rng.standard_normal((1, 1, q, h)), 0.0)
                    * 0.1, axis=2).astype(np.float32)
    tin = [torch.from_numpy(a).requires_grad_(True) for a in (C, B, x, cum)]
    y = ssd.ssd_intra_chunks_plain_vjp(*tin)
    assert y.shape == x.shape
    got = torch.autograd.grad(y, tin, torch.from_numpy(dy))
    rep = h // g

    def ref(C_, B_, x_, cum_):    # the reference's oracle, one cell a head
        cells = lambda t: t.transpose(0, 1, 3, 2, 4).reshape(  # noqa: E731
            -1, q, t.shape[-1])
        Ch, Bh = (jnp.repeat(t, rep, axis=3) for t in (C_, B_))
        out = ssd_intra_ref(cells(Ch), cells(Bh), cells(x_),
                            cum_.transpose(0, 1, 3, 2).reshape(-1, q))
        return out.reshape(1, 1, h, q, p).transpose(0, 1, 3, 2, 4)

    _, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (C, B, x, cum)))
    for gr, w in zip(got, vjp(jnp.asarray(dy))):
        assert _scaled(gr, w) <= 1e-5


# -- the resilient training loop (tests/test_fault_tolerance.py's four) ------

@pytest.fixture(scope="module")
def tiny_setup():
    cfg = get_config("phi4-mini-3.8b").reduced()
    step_fn = make_train_step(cfg)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), **CPU)
    pipeline = TokenPipeline(cfg, batch=2, seq=32, seed=0)
    return cfg, step_fn, state, pipeline


def _run(tmp_path, step_fn, state, pipeline, n, fail_at=()):
    loop = ResilientLoop(step_fn, pipeline, tmp_path, ckpt_every=4,
                         injector=FailureInjector(fail_at),
                         async_ckpt=False)
    final = loop.run(state, n)
    return loop, final


def test_failure_recovery_reaches_end(tmp_path, tiny_setup):
    cfg, step_fn, state, pipeline = tiny_setup
    loop, final = _run(tmp_path / "a", step_fn, state, pipeline, 12,
                       fail_at=(6, 9))
    assert loop.restarts == 2
    assert int(final.step) == 12


def test_recovery_is_bitwise_deterministic(tmp_path, tiny_setup):
    """Replay after a failure gives the clean run's final params bit for
    bit ((seed, step) data and the checkpointed state)."""
    cfg, step_fn, state, pipeline = tiny_setup
    _, clean = _run(tmp_path / "clean", step_fn, state, pipeline, 10)
    _, failed = _run(tmp_path / "failed", step_fn, state, pipeline, 10,
                     fail_at=(7,))
    for a, b in zip(tree_flatten(clean.params)[0],
                    tree_flatten(failed.params)[0]):
        assert torch.equal(a, b)


def test_too_many_failures_raises(tmp_path, tiny_setup):
    cfg, step_fn, state, pipeline = tiny_setup
    loop = ResilientLoop(step_fn, pipeline, tmp_path / "b", ckpt_every=4,
                         injector=FailureInjector((3, 3)), max_restarts=0,
                         async_ckpt=False)
    loop.injector.seen = set()
    with pytest.raises(InjectedFailure):
        loop.run(state, 8)


def test_loss_decreases_on_learnable_data(tmp_path):
    """A tiny model on a learnable cycle corpus learns: the last losses
    average under half the first ones."""
    cfg = get_config("musicgen-medium").reduced()
    seq = [0]
    for _ in range(20000):
        seq.append((seq[-1] * 7 + 3) % cfg.vocab)
    corpus = np.asarray(seq, dtype=np.int32)
    pipeline = TokenPipeline(cfg, batch=4, seq=64, seed=0, corpus=corpus)
    opt = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=10, decay_steps=80)
    step_fn = make_train_step(cfg, opt)
    state = init_train_state(cfg, torch.Generator().manual_seed(1), **CPU)
    loop = ResilientLoop(step_fn, pipeline, tmp_path / "lrn",
                         ckpt_every=1000, async_ckpt=False)
    loop.run(state, 80)
    losses = [m["loss"] for m in loop.metrics_log]
    assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:5])


# -- bf16 train-state checkpoints across the packages -------------------------

@pytest.fixture(scope="module")
def bf16_states():
    jcfg = dataclasses.replace(jax_config("qwen2-7b").reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(),
                              dtype="bfloat16")
    jstate = jax_init_state(jax.random.PRNGKey(3), jcfg)
    # a state past step 0: moments and params moved by one JAX step
    jstate, _ = jax.jit(jax_make_step(jcfg))(
        jstate, JaxPipeline(jcfg, batch=2, seq=16, seed=0).global_batch(0))
    return jstate, cfg


def _words(a):
    """A leaf's bits: bf16 (numpy's, or the stored |V2) as uint16."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def test_port_restores_jax_bf16_train_state(tmp_path, bf16_states):
    jstate, cfg = bf16_states
    jax_save(tmp_path, 1, jstate)
    like = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                  **CPU)
    got, step = restore_checkpoint(tmp_path, like, **CPU)
    assert step == 1
    leaves, _, paths = tree_flatten(got)
    want = jax.tree.leaves(jstate)
    assert any(x.dtype == torch.bfloat16 for x in leaves)
    for g, w, p in zip(leaves, want, paths):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), p
        bits = g.view(torch.int16) if g.dtype == torch.bfloat16 else g
        np.testing.assert_array_equal(_words(bits.numpy()), _words(w),
                                      err_msg=p)


def test_jax_reads_port_bf16_train_state(tmp_path, bf16_states):
    """The port's save of the same state is the reference's own files:
    the same manifest, and leaves the reference's loader reads back as
    JAX's bits (its ``restore_checkpoint`` refuses a bf16 leaf of its
    own files as of the port's too: ROADMAP Queue 3)."""
    jstate, cfg = bf16_states
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                   **CPU)
    save_checkpoint(tmp_path / "port", 1, state)
    jax_save(tmp_path / "jax", 1, jstate)
    _, pman, pleaves = jax_load(tmp_path / "port")
    _, jman, jleaves = jax_load(tmp_path / "jax")
    assert pman == jman
    assert any(m["dtype"] == "bfloat16" for m in pman["leaves"])
    for a, b, w in zip(pleaves, jleaves, jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_words(a), _words(b))
        np.testing.assert_array_equal(_words(a), _words(w))


def test_lm_params_round_trip_in_bf16(tmp_path, bf16_states):
    """A bf16 parameter tree saved and restored by the port is the same
    bits, and carries JAX's bits (``lm_params_from_numpy``)."""
    jstate, cfg = bf16_states
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jstate.params),
                                  cfg, **CPU)
    save_checkpoint(tmp_path, 2, params)
    back, _ = restore_checkpoint(tmp_path, params, **CPU)
    for a, b in zip(tree_flatten(params)[0], tree_flatten(back)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
