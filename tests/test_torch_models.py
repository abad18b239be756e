"""The port's LM serving path against the JAX package's.

Reduced configs (``get_config(arch).reduced()``, fp32) with JAX's
weights (``repro.models.init_params``) carried across by
``repro_torch.convert.lm_params_from_numpy``; the same numpy tokens go
through both packages' ``forward``, ``prefill_forward`` and
``decode_step``. On the CPU the port's kernels take their plain
versions.

Tolerances: fp32 within 1e-4 of the largest |value| of the JAX output
(summation order differs); bf16 within 3e-2 (JAX rounds the bf16
scores and probabilities to bf16, the port's attention keeps them in
fp32, as the Pallas kernel does); the port's own decode continuation
within 2e-2, as ``tests/test_models.py`` holds JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs import get_config as jax_config
from repro.models.mamba import ssd_chunked as jax_ssd_chunked
from repro_torch import models as tm
from repro_torch.configs import get_config, list_configs
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models.mamba import ssd_chunked
from repro_torch.train import make_prefill_step, make_serve_step

ARCHS = ["qwen2-7b", "mamba2-780m", "hymba-1.5b", "minicpm3-4b",
         "qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"]
SUPPORTED = ARCHS + ["phi4-mini-3.8b", "mistral-nemo-12b",
                     "musicgen-medium", "llava-next-mistral-7b"]


def _ample(cfg):
    """A MoE config at ample capacity (``n_experts / moe_top_k``): no
    pair drops, so a token's output does not hang on the batch's other
    tokens (the reference's overflow is faulty, ROADMAP.md Queue 3 item
    12, and is held in ``tests/test_torch_moe.py``)."""
    if cfg.family != "moe":
        return cfg
    return dataclasses.replace(
        cfg, moe_capacity_factor=cfg.n_experts / cfg.moe_top_k)


def _configs(arch, dtype="float32"):
    return (_ample(dataclasses.replace(jax_config(arch).reduced(),
                                       dtype=dtype)),
            _ample(dataclasses.replace(get_config(arch).reduced(),
                                       dtype=dtype)))


def _params(jcfg, cfg, seed):
    jparams = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) + 1e-9
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of scale > {tol}"


def _pad1(cache, s):
    """Pad the sequence axis of the k/v leaves by one position."""
    def pad(leaf):
        if leaf.ndim >= 3 and leaf.shape[2] == s:
            width = [(0, 0)] * leaf.ndim
            width[2] = (0, 1)
            return jnp.pad(leaf, width)
        return leaf
    return jax.tree.map(pad, cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, cfg = _configs(arch)
    jparams, params = _params(jcfg, cfg, seed=0)
    toks = _tokens(cfg, 2, 21, seed=1)
    want = jm.forward(jparams, jnp.asarray(toks), jcfg)
    got = tm.forward(params, torch.from_numpy(toks), cfg)
    _close(got, want, 1e-4, f"{arch} hidden states")


@pytest.mark.parametrize("arch", SUPPORTED)
def test_prefill_matches_jax(arch):
    jcfg, cfg = _configs(arch)
    jparams, params = _params(jcfg, cfg, seed=2)
    toks = _tokens(cfg, 2, 19, seed=3)
    vis = None
    if cfg.n_vision_tokens:
        vis = np.random.default_rng(4).standard_normal(
            (2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    want_lg, want_cache = jm.prefill_forward(
        jparams, jnp.asarray(toks), jcfg,
        vision_embeds=None if vis is None else jnp.asarray(vis))
    got_lg, got_cache = make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(toks)}
        | ({} if vis is None else {"vision_embeds": torch.from_numpy(vis)}))
    assert got_lg.dtype == torch.float32
    _close(got_lg, want_lg, 1e-4, f"{arch} prefill logits")
    assert set(got_cache) == set(want_cache)
    for k in want_cache:
        _close(got_cache[k], want_cache[k], 1e-4, f"{arch} cache {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(arch):
    jcfg, cfg = _configs(arch)
    jparams, params = _params(jcfg, cfg, seed=5)
    b, s = 2, 11
    toks = _tokens(cfg, b, s + 2, seed=6)
    _, jcache = jm.prefill_forward(jparams, jnp.asarray(toks[:, :s]), jcfg)
    jcache = _pad1(_pad1(jcache, s), s + 1)
    cache = lm_cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg,
                                device="cpu")
    serve = make_serve_step(cfg)
    for pos in (s, s + 1):            # two steps from the prefilled cache
        tok = toks[:, pos:pos + 1]
        want_lg, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok),
                                         pos, jcfg)
        got_lg, cache = serve(params, cache, torch.from_numpy(tok), pos)
        _close(got_lg, want_lg, 1e-4, f"{arch} decode logits at {pos}")
        assert set(cache) == set(jcache)
        for k in jcache:
            _close(cache[k], jcache[k], 1e-4, f"{arch} cache {k} at {pos}")


def test_hymba_bf16_matches_jax():
    jcfg, cfg = _configs("hymba-1.5b", dtype="bfloat16")
    jparams, params = _params(jcfg, cfg, seed=7)
    assert params["embed"].dtype == torch.bfloat16
    assert params["layers"]["mamba"]["A_log"].dtype == torch.float32
    b, s = 2, 19
    toks = _tokens(cfg, b, s + 1, seed=8)
    want_lg, jcache = jm.prefill_forward(jparams, jnp.asarray(toks[:, :s]),
                                         jcfg)
    got_lg, cache = tm.prefill_forward(params, torch.from_numpy(toks[:, :s]),
                                       cfg)
    _close(got_lg, want_lg, 3e-2, "bf16 prefill logits")
    for k in jcache:
        assert cache[k].dtype == (torch.float32 if k == "ssm"
                                  else torch.bfloat16), k
        _close(cache[k], jcache[k], 3e-2, f"bf16 cache {k}")
    jcache = _pad1(jcache, s)
    cache = lm_cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg,
                                device="cpu")
    tok = toks[:, s:s + 1]
    want_lg, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok), s,
                                     jcfg)
    got_lg, cache = tm.decode_step(params, cache, torch.from_numpy(tok), s,
                                   cfg)
    _close(got_lg, want_lg, 3e-2, "bf16 decode logits")
    for k in jcache:
        _close(cache[k], jcache[k], 3e-2, f"bf16 decode cache {k}")


@pytest.mark.parametrize("s,h,g,chunk", [(13, 4, 1, 8), (16, 4, 2, 8),
                                         (29, 6, 2, 8), (5, 4, 1, 8)],
                         ids=["ragged", "groups2", "ragged-groups2",
                              "shorter-than-chunk"])
def test_ssd_chunked_matches_jax(s, h, g, chunk):
    rng = np.random.default_rng(s * h + g)
    b, p, n = 2, 16, 8
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    B, C = (rng.standard_normal((b, s, g, n)).astype(np.float32)
            for _ in range(2))
    D = rng.standard_normal(h).astype(np.float32)
    args = (x, dt, A, B, C, D)
    want_y, want_st = jax_ssd_chunked(*(jnp.asarray(a) for a in args),
                                      chunk=chunk, return_state=True)
    got_y, got_st = ssd_chunked(*(torch.from_numpy(a) for a in args),
                                chunk=chunk, return_state=True)
    _close(got_y, want_y, 1e-4, "y")
    _close(got_st, want_st, 1e-4, "final state")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_decode_continuation(arch):
    cfg = _ample(get_config(arch).reduced())
    params = tm.init_params(cfg, torch.Generator().manual_seed(4),
                            device="cpu")
    b, s = 2, 8
    toks = torch.from_numpy(_tokens(cfg, b, s + 1, seed=5))
    logits_pf, cache = tm.prefill_forward(params, toks[:, :s], cfg)
    full = tm.init_cache(cfg, b, s + 1, device="cpu")
    for k, v in cache.items():        # the prefill covers [0, s)
        if k in ("ssm", "conv"):
            full[k] = v
        else:                         # k, v or MLA's latents kvc, kpe
            full[k][:, :, :s] = v
    lg_dec, _ = tm.decode_step(params, full, toks[:, s:s + 1], s, cfg)
    h = tm.forward(params, toks, cfg)
    logits_train = h @ params["lm_head"]
    scale = float(logits_train.abs().max()) + 1e-9
    err_pf = float((logits_pf[:, 0] - logits_train[:, s - 1]).abs().max())
    err_dec = float((lg_dec[:, 0] - logits_train[:, s]).abs().max())
    assert err_pf / scale < 2e-2, (arch, err_pf / scale)
    assert err_dec / scale < 2e-2, (arch, err_dec / scale)


def test_init_params_follows_the_reference_layout():
    cfg = get_config("hymba-1.5b").reduced()
    params = tm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    jparams = jm.init_params(jax.random.PRNGKey(0),
                             jax_config("hymba-1.5b").reduced())
    flat = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    assert len(flat) == len(jax.tree.leaves(params))
    mb = params["layers"]["mamba"]
    jmb = jparams["layers"]["mamba"]
    for name in ("A_log", "dt_bias", "D", "out_norm"):  # deterministic
        np.testing.assert_allclose(mb[name].numpy(), np.asarray(jmb[name]),
                                   rtol=1e-6)
    # normal draws: same shapes, the reference's std (fan_in^-1/2)
    w = params["layers"]["attn"]["wq"]
    assert tuple(w.shape) == tuple(jparams["layers"]["attn"]["wq"].shape)
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1


@pytest.mark.parametrize("arch,item", [("hybrid-int8", "Queue 3 item 11")])
def test_unsupported_configs_raise(arch, item):
    """A hybrid config with the int8 cache is refused, as the
    reference's path for it is faulty (it prefills unquantized k and v
    into int8 and reads them back unscaled)."""
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(),
                              kv_cache_dtype="int8")
    gen = torch.Generator().manual_seed(0)
    # each names its ROADMAP item
    with pytest.raises(NotImplementedError, match=f"{item}\\)"):
        tm.init_params(cfg, gen, device="cpu")
    with pytest.raises(NotImplementedError, match=f"{item}\\)"):
        tm.init_cache(cfg, 1, 4, device="cpu")
    # the shape tree is data and stays available
    assert tm.param_shapes(cfg)["layers"]["ln1"] == (cfg.n_layers,
                                                     cfg.d_model)


def test_moe_decode_matches_with_ample_capacity():
    """The port's counterpart of the reference's test of the same name:
    every position decoded one token at a time from an empty cache
    against the training forward's logits, at a capacity where nothing
    drops."""
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                              moe_capacity_factor=100.0)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    b, s = 2, 12
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=3))
    logits_train = tm.forward(params, toks, cfg) @ params["lm_head"]
    cache = tm.init_cache(cfg, b, s, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = tm.decode_step(params, cache, toks[:, t:t + 1], t, cfg)
        outs.append(lg[:, 0])
    err = float((logits_train - torch.stack(outs, 1)).abs().max())
    assert err < 1e-3, err


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "hymba-1.5b"])
def test_init_params_scales_in_place_to_the_same_bits(arch):
    """``init_params`` scales each normal draw in place (one fp32 copy
    of a leaf, which lets 8 layers of qwen3-moe-235b-a22b be drawn on
    one card): the same bits as the draw scaled out of place."""
    cfg = get_config(arch).reduced()
    params = tm.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    gen = torch.Generator().manual_seed(3)
    from repro_torch.models.transformer import flatten_with_path
    for path, leaf in flatten_with_path(params):
        name = path.split("/")[-1]
        if name in ("A_log", "dt_bias", "D") or "norm" in name or \
                name in ("ln1", "ln2", "mix_na", "mix_nm"):
            continue
        shape = tuple(leaf.shape)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = 0.02 if name in ("embed", "lm_head") else fan_in ** -0.5
        want = (torch.randn(shape, generator=gen) * std).to(leaf.dtype)
        assert torch.equal(leaf, want), path


def test_moe_layout_follows_the_reference():
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    params = tm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    jparams = jm.init_params(jax.random.PRNGKey(0),
                             jax_config("qwen3-moe-235b-a22b").reduced())
    assert "mlp" not in params["layers"]
    for name, leaf in params["layers"]["moe"].items():
        assert tuple(leaf.shape) == \
            tuple(jparams["layers"]["moe"][name].shape), name


def test_configs_match_the_reference():
    from repro.configs import list_configs as jax_list
    assert list_configs() == jax_list()
    for arch in list_configs():
        for full in (False, True):
            got = get_config(arch) if full else get_config(arch).reduced()
            want = jax_config(arch) if full else jax_config(arch).reduced()
            assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
            assert got.padded_vocab == want.padded_vocab
            assert str(got.compute_dtype).split(".")[-1] == \
                str(want.compute_dtype)


def test_param_conversion_rejects_wrong_trees():
    jcfg, cfg = _configs("qwen2-7b")
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    del tree["lm_head"]
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_numpy(tree, cfg, device="cpu")
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    tree["final_norm"] = tree["final_norm"][:-1]
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_numpy(tree, cfg, device="cpu")
