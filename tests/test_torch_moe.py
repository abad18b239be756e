"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) and an independent numpy oracle.

Reduced qwen3-moe-235b-a22b (4 experts, top-2) and llama4-scout-17b-a16e
(4 experts, top-1), fp32 unless stated, the same numpy weights and
inputs in both packages.

- At ample capacity (``n_experts / moe_top_k``: nothing can drop) the
  outputs agree within 1e-5 of scale and the gradients of x and of every
  MoE leaf within 1e-4 (fp32 sums in another order).
- At the configs' 1.25, with experts that overflow, both packages are
  held to a float64 numpy oracle that keeps each expert's first
  ``capacity`` pairs and drops the rest. The port matches it everywhere.
  JAX matches it everywhere but at the first token of each overflowing
  expert, where it equals the oracle less that token's contribution from
  that expert: its buffer write sends each dropped pair's zero row to
  slot 0 of the expert, over the first kept token (ROADMAP.md Queue 3
  item 12).
- Ties (integer inputs, duplicated router columns) go to the lower
  expert id, as ``jax.lax.top_k`` sends them.
- In bf16 the two packages' expert choices agree on at least 95% of the
  (token, k) entries, and the outputs within 3e-2 of scale on the
  tokens whose choices agree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.moe import moe_ffn as jax_moe_ffn
from repro_torch.configs import get_config
from repro_torch.models import moe

ARCHS = ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"]
LEAVES = ("router", "w_gate", "w_up", "w_down")


def _configs(arch, factor=None, dtype="float32"):
    """JAX's and the port's reduced config; ``factor`` None: ample."""
    out = []
    for c in (jax_config(arch).reduced(), get_config(arch).reduced()):
        f = c.n_experts / c.moe_top_k if factor is None else factor
        out.append(dataclasses.replace(c, moe_capacity_factor=f, dtype=dtype))
    return out


def _weights(cfg, seed):
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    p = {"router": rng.standard_normal((d, e)) * d ** -0.5,
         "w_gate": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_up": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_down": rng.standard_normal((e, f, d)) * f ** -0.5}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _inputs(cfg, b, s, seed, skew=0.0):
    """x (B, S, D); ``skew`` adds one shared direction to every token,
    so that tokens crowd the same experts."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model))
    return (x + skew * rng.standard_normal(cfg.d_model)).astype(np.float32)


def _run_jax(x, p, jcfg, dtype=jnp.float32):
    return np.asarray(jax_moe_ffn(jnp.asarray(x, dtype),
                                  {k: jnp.asarray(v, dtype)
                                   for k, v in p.items()}, jcfg),
                      np.float32)


def _run_port(x, p, cfg, dtype=torch.float32):
    tp = {k: torch.from_numpy(v).to(dtype) for k, v in p.items()}
    return moe.moe_ffn(torch.from_numpy(x).to(dtype), tp, cfg).float().numpy()


def _rel(got, want):
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-30)


def _oracle(x, p, cfg):
    """float64 numpy: (out (T, D), per-pair contributions {(t, e): row},
    experts (T, k) in top-k order, capacity). Each expert keeps its first
    ``capacity`` pairs in token order and drops the rest."""
    t = x.shape[0] * x.shape[1]
    xf = x.reshape(t, -1).astype(np.float64)
    e, k = cfg.n_experts, cfg.moe_top_k
    logits = xf @ p["router"].astype(np.float64)
    experts = np.argsort(-logits, axis=1, kind="stable")[:, :k]
    # the inputs are drawn so that no choice hangs on a rounding
    srt = -np.sort(-logits, axis=1)
    gap = srt[:, k - 1] - srt[:, k] if k < e else np.inf
    assert np.all(gap > 1e-4), "a near-tie at the top-k boundary"
    top = np.take_along_axis(logits, experts, 1)
    gates = np.exp(top - top.max(1, keepdims=True))
    gates /= gates.sum(1, keepdims=True)
    cap = int(cfg.moe_capacity_factor * t * k / e) + 1
    seen = np.zeros(e, np.int64)
    contrib = {}
    for tok in range(t):
        for j in range(k):
            ex = experts[tok, j]
            seen[ex] += 1
            if seen[ex] > cap:
                continue
            h = xf[tok]
            g = h @ p["w_gate"][ex].astype(np.float64)
            u = h @ p["w_up"][ex].astype(np.float64)
            y = (g / (1 + np.exp(-g)) * u) @ p["w_down"][ex].astype(np.float64)
            contrib[(tok, ex)] = gates[tok, j] * y
    out = np.zeros_like(xf)
    for (tok, _), row in contrib.items():
        out[tok] += row
    return out, contrib, experts, cap


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b,s,seed", [(2, 16, 0), (1, 7, 1), (3, 5, 2)])
def test_moe_ffn_matches_jax_at_ample_capacity(arch, b, s, seed):
    jcfg, cfg = _configs(arch)
    p = _weights(cfg, seed)
    x = _inputs(cfg, b, s, seed + 10)
    want = _run_jax(x, p, jcfg)
    got = _run_port(x, p, cfg)
    assert got.shape == want.shape == x.shape
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_overflow_drops_as_the_oracle_and_jax_zeroes_a_kept_row(arch):
    jcfg, cfg = _configs(arch, factor=1.25)
    p = _weights(cfg, 3)
    b, s = 2, 16
    x = _inputs(cfg, b, s, 4, skew=1.5)
    out, contrib, experts, cap = _oracle(x, p, cfg)
    assert cap == moe.capacity(cfg, b * s)
    counts = np.bincount(experts.reshape(-1), minlength=cfg.n_experts)
    over = np.flatnonzero(counts > cap)
    assert over.size, "no expert overflowed: the case shows nothing"
    want = out.reshape(x.shape)
    got = _run_port(x, p, cfg)
    assert _rel(got, want) <= 1e-5
    # JAX: the oracle less each overflowing expert's first token's part
    jx = _run_jax(x, p, jcfg)
    firsts = [(int(np.flatnonzero((experts == ex).any(1))[0]), ex)
              for ex in over]
    less = out.copy()
    for tok, ex in firsts:
        less[tok] -= contrib[(tok, ex)]
    assert _rel(jx, less.reshape(x.shape)) <= 1e-5
    # and it differs from the oracle at those tokens alone
    err = np.abs(jx - want).reshape(-1, x.shape[-1]).max(1)
    scale = float(np.abs(want).max())
    assert set(np.flatnonzero(err > 1e-5 * scale)) == {t for t, _ in firsts}


@pytest.mark.parametrize("arch", ARCHS)
def test_ties_go_to_the_lower_expert_as_jax(arch):
    """Integer inputs make every logit exact in fp32, in any summation
    order; router columns 2 and 3 repeat 0 and 1, so every token has
    exact ties and the top-k boundary falls between equal logits."""
    jcfg, cfg = _configs(arch)
    rng = np.random.default_rng(5)
    d = cfg.d_model
    router = rng.integers(-2, 3, (d, cfg.n_experts)).astype(np.float32)
    router[:, 2:4] = router[:, 0:2]
    x = rng.integers(-3, 4, (64, d)).astype(np.float32)
    logits = x @ router
    want = np.asarray(jax.lax.top_k(jnp.asarray(logits), cfg.moe_top_k)[1])
    gates, got = moe.route(torch.from_numpy(x), torch.from_numpy(router),
                           cfg)
    np.testing.assert_array_equal(got.numpy(), want)
    lower = np.argsort(-logits, axis=1, kind="stable")[:, :cfg.moe_top_k]
    np.testing.assert_array_equal(got.numpy(), lower)
    assert float(gates.sum(1).sub(1).abs().max()) <= 1e-6
    # and through the whole FFN
    p = _weights(cfg, 6)
    p["router"] = router
    xs = x[None, :16]
    assert _rel(_run_port(xs, p, cfg), _run_jax(xs, p, jcfg)) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_choices_and_outputs_agree_with_jax(arch):
    jcfg, cfg = _configs(arch, dtype="bfloat16")
    p = _weights(cfg, 7)
    x = _inputs(cfg, 4, 64, 8)
    t, k = 4 * 64, cfg.moe_top_k
    xb = jnp.asarray(x, jnp.bfloat16).reshape(t, -1)
    jlog = jnp.einsum("td,de->te", xb, jnp.asarray(p["router"], jnp.bfloat16))
    jexp = np.asarray(jax.lax.top_k(jlog.astype(jnp.float32), k)[1])
    _, texp = moe.route(torch.from_numpy(x).to(torch.bfloat16).reshape(t, -1),
                        torch.from_numpy(p["router"]).to(torch.bfloat16), cfg)
    texp = texp.numpy()
    same_entry = (np.sort(jexp, 1) == np.sort(texp, 1))
    assert same_entry.mean() >= 0.95, same_entry.mean()
    agree = same_entry.all(1)
    want = _run_jax(x, p, jcfg, jnp.bfloat16).reshape(t, -1)
    got = _run_port(x, p, cfg, torch.bfloat16).reshape(t, -1)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want)[agree].max()) / scale <= 3e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch):
    jcfg, cfg = _configs(arch)
    p = _weights(cfg, 9)
    x = _inputs(cfg, 2, 12, 10)
    r = np.random.default_rng(11).standard_normal(x.shape).astype(np.float32)

    def jloss(xx, pp):
        return jnp.sum(jax_moe_ffn(xx, pp, jcfg) * r)
    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), {k_: jnp.asarray(v) for k_, v in p.items()})
    tx = torch.from_numpy(x).requires_grad_()
    tp = {k_: torch.from_numpy(v).requires_grad_() for k_, v in p.items()}
    (moe.moe_ffn(tx, tp, cfg) * torch.from_numpy(r)).sum().backward()
    want = {"x": np.asarray(jgx)} | {k_: np.asarray(jgp[k_]) for k_ in LEAVES}
    got = {"x": tx.grad.numpy()} | {k_: tp[k_].grad.numpy() for k_ in LEAVES}
    for name in want:
        assert got[name].shape == want[name].shape, name
        if not np.abs(want[name]).max():
            # top-1: the one gate's softmax is 1, the router gets nothing
            assert not np.abs(got[name]).max(), name
            continue
        assert _rel(got[name], want[name]) <= 1e-4, name


@pytest.mark.parametrize("t,k,e,cap", [(32, 2, 4, 21), (32, 2, 4, 5),
                                       (9, 1, 4, 1), (5, 8, 16, 3)])
def test_plan_is_a_one_to_one_map_of_kept_pairs(t, k, e, cap):
    """Every buffer slot holds at most one pair and every kept pair one
    slot, the two maps inverse; each expert keeps its first ``cap``
    pairs in token order; ``order`` lists each token's experts
    ascending."""
    rng = np.random.default_rng(t * k + cap)
    experts = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    slot, pair, order = moe.plan(torch.from_numpy(experts), e, cap)
    slot, pair, order = slot.numpy(), pair.numpy(), order.numpy()
    seen = np.zeros(e, np.int64)
    for tok in range(t):
        for j in range(k):
            ex = experts[tok, j]
            if seen[ex] < cap:
                assert slot[tok, j] == ex * cap + seen[ex]
                assert pair[slot[tok, j]] == tok * k + j
            else:
                assert slot[tok, j] == -1
            seen[ex] += 1
    assert (pair >= 0).sum() == (slot >= 0).sum() == np.minimum(seen,
                                                                cap).sum()
    np.testing.assert_array_equal(np.take_along_axis(experts, order, 1),
                                  np.sort(experts, 1))
