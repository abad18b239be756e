"""The training forward's L and the backward given it, on the CPU.

The model's attention forward saves each query row's logsumexp L of its
scaled causal scores, and its backward rebuilds P = exp(scores - L)
from it rather than recomputing L. Here the plain versions of both, on
numpy inputs made from a seed, against JAX: L against
``jax.nn.logsumexp`` of the reference's masked, scaled scores (rtol and
atol 1e-5), and the backward given that L against ``jax.vjp`` of the
reference attention (fp32, each gradient within 1e-5 of its largest
|value|, the existing backward test's bound). Then the backward's
route: chosen by dtype and head dim alone, as the forward's, and its
checks raise before any kernel is reached.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref

fla = importlib.import_module("repro_torch.kernels.flash_attention")

# (b, s, h, kv, d): grouped heads, one query head a kv head, a ragged S
SHAPES = [(2, 13, 4, 2, 8), (1, 33, 6, 3, 16), (1, 20, 2, 2, 32),
          (1, 70, 5, 1, 64)]


def _inputs(b, s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kv, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v, do


def _jax_lse(q, k):
    """logsumexp over keys j <= i of q_i . k_j / sqrt(D), (B, H, S)."""
    rep = q.shape[2] // k.shape[2]
    qh = jnp.asarray(q).swapaxes(1, 2)
    kh = jnp.repeat(jnp.asarray(k).swapaxes(1, 2), rep, axis=1)
    s = q.shape[1]
    sc = jnp.einsum("bhid,bhjd->bhij", qh, kh) / np.sqrt(q.shape[-1])
    sc = jnp.where(jnp.tril(jnp.ones((s, s), bool)), sc, -jnp.inf)
    return jax.nn.logsumexp(sc, axis=-1)


def _scaled(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.numpy() - want).max()) / \
        (float(np.abs(want).max()) + 1e-12)


@pytest.mark.parametrize("b,s,h,kv,d", SHAPES)
def test_plain_lse_matches_jax_logsumexp(b, s, h, kv, d):
    q, k, v, _ = _inputs(b, s, h, kv, d, s + d)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = fla.flash_attention_gqa_lse_plain(tq, tk, tv)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(_jax_lse(q, k)),
                               rtol=1e-5, atol=1e-5)
    # the output is the plain forward's, and the CPU entry point with L
    # gives both
    assert torch.equal(out, fla.flash_attention_gqa_plain(tq, tk, tv))
    out2, lse2 = fla.flash_attention_gqa_with_lse(tq, tk, tv)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)


@pytest.mark.parametrize("b,s,h,kv,d,vd", [
    pytest.param(*shape, None, id="-".join(map(str, shape)))
    for shape in SHAPES] + [
    # MLA's (minicpm3-4b's, cut to size): KV = H, q.k 96, v and dO
    # zero-padded from 64 as models/attention.py pads them
    pytest.param(1, 130, 4, 4, 96, 64, id="mla-1-130-4-4-96-v64")])
def test_plain_bwd_given_lse_matches_jax_grad(b, s, h, kv, d, vd):
    q, k, v, do = _inputs(b, s, h, kv, d, s * h)
    if vd is not None:
        v[..., vd:] = 0.0
        do[..., vd:] = 0.0
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fla.flash_attention_gqa_lse_plain(tq, tk, tv)
    got = fla.flash_attention_gqa_bwd_plain(tq, tk, tv, o, tdo, lse)
    rep = h // kv

    def ref(q_, k_, v_):          # the reference's oracle, heads repeated
        kh = jnp.repeat(k_.swapaxes(1, 2), rep, axis=1)
        vh = jnp.repeat(v_.swapaxes(1, 2), rep, axis=1)
        return flash_attention_ref(q_.swapaxes(1, 2), kh, vh).swapaxes(1, 2)

    _, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, g, w, x in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(do)),
                             (tq, tk, tv)):
        assert g.shape == x.shape and g.dtype == torch.float32, name
        assert _scaled(g, w) <= 1e-5, (name, _scaled(g, w))
    # the CPU wrapper takes the plain version with the L it is given
    for g, w in zip(fla.flash_attention_gqa_bwd(tq, tk, tv, o, tdo, lse),
                    got):
        assert torch.equal(g, w)
    if vd is not None:          # the padded columns carry no gradient
        assert bool((got[2][..., vd:] == 0).all())


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 16, "ffma"), (torch.bfloat16, 32, "ffma"),
    (torch.bfloat16, 100, "ffma"), (torch.float32, 64, "ffma"),
    (torch.float32, 128, "ffma"), (torch.float32, 8, "ffma"),
    (torch.bfloat16, 96, "tc"), (torch.bfloat16, 80, "ffma"),
    (torch.float32, 96, "ffma")])
@pytest.mark.parametrize("b,s,h,kv", [(1, 5, 2, 2), (2, 70, 10, 2)])
def test_bwd_route_by_dtype_and_head_dim(dtype, d, route, b, s, h, kv):
    """The backward takes the forward's route, from dtype and head dim
    alone (the batch, sequence and heads do not enter it); on the CPU
    it runs no kernel, and forcing the tensor-core route where the
    dtype or head dim does not take it raises before any launch."""
    assert fla.route_for(dtype, d) == route
    q = torch.zeros((b, s, h, d), dtype=dtype)
    k = torch.zeros((b, s, kv, d), dtype=dtype)
    o, lse = fla.flash_attention_gqa_with_lse(q, k, k)
    f = fla.flash_attention_gqa_bwd
    counts = (f.launches, f.launches_tc, f.launches_ffma)
    grads = fla.flash_attention_gqa_bwd(q, k, k, o, q, lse)
    assert [g.shape for g in grads] == [q.shape, k.shape, k.shape]
    assert (f.launches, f.launches_tc, f.launches_ffma) == counts
    if route == "ffma":
        with pytest.raises(ValueError, match="tensor-core"):
            fla.launch_gqa_bwd(q, k, k, o, q, lse, "tc")
    with pytest.raises(ValueError, match="no route"):
        fla.launch_gqa_bwd(q, k, k, o, q, lse, "sdpa")


def test_bwd_launch_needs_the_forwards_lse():
    """The kernels take L from the forward, shaped (B, H, S) in fp32:
    a missing or misshapen L raises before any launch."""
    q = torch.zeros((1, 9, 4, 16))
    k = torch.zeros((1, 9, 2, 16))
    lse = torch.zeros((1, 4, 9))
    for bad in (None, lse[:, :, :8], lse.to(torch.float64),
                lse.transpose(1, 2)):
        with pytest.raises(ValueError, match="lse"):
            fla.launch_gqa_bwd(q, k, k, q, q, bad, "ffma")
