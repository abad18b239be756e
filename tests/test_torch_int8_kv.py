"""The port's int8 KV cache (``kv_cache_dtype="int8"``) against the JAX
package's.

``quantize_kv``/``dequantize_kv`` on the same numpy inputs give JAX's
bits. A reduced qwen2-7b (fp32) with JAX's weights carried across
(``convert.lm_params_from_numpy``) prefills and decodes two steps into
the int8 cache beside JAX's: the int8 values may lie one step apart,
since torch's and XLA's fp32 projections can round a value to either
side of a .5 boundary before it is quantized; the scales agree within
1e-5 relative and the logits within 1e-3 of their scale. The
reference's own check holds too: decoding with the int8 cache stays
within 5e-2 of the native forward's logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs import get_config as jax_config
from repro.models.attention import dequantize_kv as jax_dequantize
from repro.models.attention import quantize_kv as jax_quantize
from repro_torch import models as tm
from repro_torch.configs import get_config
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models.attention import dequantize_kv, quantize_kv
from repro_torch.train import make_prefill_step, make_serve_step

ARCH = "qwen2-7b"
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _configs():
    return (dataclasses.replace(jax_config(ARCH).reduced(),
                                kv_cache_dtype="int8"),
            dataclasses.replace(get_config(ARCH).reduced(),
                                kv_cache_dtype="int8"))


def _values(shape, scale, seed):
    """Normal draws times ``scale``, with a zero row and a row of a
    repeated value (a scale of 1e-8, and a max that hits 127 exactly)."""
    rng = np.random.default_rng(seed)
    t = (rng.standard_normal(shape) * scale).astype(np.float32)
    t[0, 0, 0] = 0.0
    t[0, -1, -1] = 0.75
    return t


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,scale", [((2, 7, 3, 16), 1.0),
                                         ((1, 33, 4, 128), 40.0),
                                         ((3, 5, 1, 8), 1e-3)])
def test_quantize_kv_matches_jax_bit_for_bit(shape, scale, dtype):
    tdt, jdt = DTYPES[dtype]
    t = _values(shape, scale, seed=len(shape) + shape[1])
    q, s = quantize_kv(torch.from_numpy(t).to(tdt))
    jq, js = jax_quantize(jnp.asarray(t, jdt))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == shape and s.shape == shape[:-1]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = dequantize_kv(q, s, tdt)
    jback = jax_dequantize(jq, js, jdt)
    assert back.dtype == tdt
    np.testing.assert_array_equal(back.float().numpy(),
                                  np.asarray(jback, np.float32))


def _cache_close(got, want, what):
    """int8 leaves within one step (returns how many are one apart);
    fp32 scales within 1e-5 relative."""
    want = np.asarray(want)
    if want.dtype == np.int8:
        assert got.dtype == torch.int8, what
        diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert int(diff.max()) <= 1, f"{what}: {int(diff.max())} steps apart"
        return int((diff == 1).sum())
    assert got.dtype == torch.float32, what
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, err_msg=what)
    return 0


def _logits_close(got, want, what):
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.numpy() - want).max()) / float(np.abs(want).max())
    assert err <= 1e-3, f"{what}: {err:.3g} of scale"


def test_int8_prefill_and_decode_match_jax():
    jcfg, cfg = _configs()
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                  device="cpu")
    b, s = 2, 13
    toks = np.random.default_rng(1).integers(0, cfg.vocab,
                                             (b, s + 2)).astype(np.int32)
    want_lg, jcache = jm.prefill_forward(jparams, jnp.asarray(toks[:, :s]),
                                         jcfg)
    got_lg, pcache = make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(toks[:, :s])})
    _logits_close(got_lg, want_lg, "prefill logits")
    assert set(pcache) == set(jcache) == {"k", "v", "k_scale", "v_scale"}
    apart = {k: _cache_close(pcache[k], jcache[k], f"prefill {k}")
             for k in jcache}
    # JAX's cache, padded by two positions, carried across: the two
    # decode steps then start from the same cache on both sides
    jcache = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 2)] +
                          [(0, 0)] * (a.ndim - 3)), jcache)
    cache = lm_cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg,
                                device="cpu")
    assert cache["k"].dtype == torch.int8
    assert cache["k_scale"].dtype == torch.float32
    serve = make_serve_step(cfg)
    for pos in (s, s + 1):
        tok = toks[:, pos:pos + 1]
        want_lg, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok),
                                         pos, jcfg)
        got_lg, cache = serve(params, cache, torch.from_numpy(tok), pos)
        _logits_close(got_lg, want_lg, f"decode logits at {pos}")
        for k in jcache:
            apart[k] += _cache_close(cache[k], jcache[k],
                                     f"cache {k} at {pos}")
    # the values one step apart, out of the int8 values compared
    total = sum(int(np.asarray(jcache[k]).size) for k in ("k", "v"))
    assert apart["k"] + apart["v"] <= total // 100, (apart, total)


def test_int8_cache_leaves_and_refusals():
    """The int8 cache's leaves; MLA and ssm configs ignore the setting as
    the reference does; a hybrid config with it is refused by name."""
    _, cfg = _configs()
    cache = tm.init_cache(cfg, 2, 9, device="cpu")
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        "k": ((cfg.n_layers, 2, 9, kv, dh), torch.int8),
        "v": ((cfg.n_layers, 2, 9, kv, dh), torch.int8),
        "k_scale": ((cfg.n_layers, 2, 9, kv), torch.float32),
        "v_scale": ((cfg.n_layers, 2, 9, kv), torch.float32)}
    for arch, keys in (("minicpm3-4b", {"kvc", "kpe"}),
                       ("mamba2-780m", {"ssm", "conv"})):
        other = dataclasses.replace(get_config(arch).reduced(),
                                    kv_cache_dtype="int8")
        assert set(tm.init_cache(other, 1, 4, device="cpu")) == keys
    hybrid = dataclasses.replace(get_config("hymba-1.5b").reduced(),
                                 kv_cache_dtype="int8")
    with pytest.raises(NotImplementedError, match="Queue 3 item 11"):
        tm.init_cache(hybrid, 1, 4, device="cpu")


def test_int8_kv_cache_decode_close_to_native():
    """``tests/test_models.py``'s check on the port: decoding every
    position with the int8 cache stays within 5e-2 of the native
    forward's logits."""
    _, cfg8 = _configs()
    cfg = dataclasses.replace(cfg8, kv_cache_dtype="native")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    b, s = 2, 12
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (b, s)).astype(np.int32))
    h = tm.forward(params, toks, cfg)
    lt = h @ params["lm_head"]
    cache = tm.init_cache(cfg8, b, s, device="cpu")
    assert cache["k"].dtype == torch.int8
    outs = []
    for t in range(s):
        lg, cache = tm.decode_step(params, cache, toks[:, t:t + 1], t, cfg8)
        outs.append(lg[:, 0])
    ld = torch.stack(outs, 1)
    rel = float((lt - ld).abs().max()) / float(lt.abs().max())
    assert rel < 0.05, rel
