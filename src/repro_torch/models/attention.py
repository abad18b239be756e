"""Grouped-query attention (port of the GQA half of
``repro.models.attention``).

Prefill and training attention is the ``flash_attention`` kernel
(``kernels.flash_attention_gqa``): queries in (B, S, H, D), keys and
values in (B, S, KV, D) as the projections leave them, fp32 softmax,
causal over absolute positions. The reference's query chunking
(``q_chunk``, ``unroll_chunks``, ``causal_slice``) and its sharding
constraints (``attn_cp``) only bound memory or place data on a mesh;
the kernel never forms the (S, S) scores, so the port accepts those
knobs and ignores them. Decode reads a KV cache in the compute dtype;
MLA and the int8 KV cache are not ported yet
(``transformer.check_supported`` raises for them).
"""
from __future__ import annotations

import math

import torch

from .. import kernels
from .layers import apply_rope


def _qkv(x, p, cfg, positions):
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).view(b, s, h, dh)
    k = (x @ p["wk"].to(x.dtype)).view(b, s, kv, dh)
    v = (x @ p["wv"].to(x.dtype)).view(b, s, kv, dh)
    if cfg.qkv_bias:
        q = q + p["bq"].view(h, dh).to(x.dtype)
        k = k + p["bk"].view(kv, dh).to(x.dtype)
        v = v + p["bv"].view(kv, dh).to(x.dtype)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v.contiguous())


def gqa_train(x, p, cfg, positions, return_kv: bool = False):
    """x: (B, S, D) -> (B, S, D); p: the layer's attn params.
    ``return_kv=True`` also returns (k, v), each (B, S, KV, Dh): the
    prefill cache."""
    b, s, _ = x.shape
    q, k, v = _qkv(x, p, cfg, positions)
    out = kernels.flash_attention_gqa(q, k, v)               # (B, S, H, Dh)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"].to(x.dtype)
    if return_kv:
        return out, k, v
    return out


def gqa_decode(x, p, cfg, cache_k, cache_v, pos: int):
    """x: (B, 1, D); cache_k/v: (B, Smax, KV, Dh); pos: the position of
    x. Writes this token's k and v into the caches **in place** (the
    reference returns updated copies) and returns
    (out (B, 1, D), cache_k, cache_v). Scores are taken in the compute
    dtype and softmaxed in fp32 over positions [0, pos], as the
    reference's mask leaves them."""
    b = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = int(pos)
    posv = torch.full((b, 1), pos, device=x.device)
    q, k, v = _qkv(x, p, cfg, posv)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    k_full = cache_k[:, :pos + 1].to(x.dtype)               # (B, T, KV, Dh)
    v_full = cache_v[:, :pos + 1].to(x.dtype)
    qg = q.view(b, kv, h // kv, dh)
    scores = torch.einsum("bkrd,btkd->bkrt", qg, k_full).float()
    scores = scores * (1.0 / math.sqrt(dh))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkrt,btkd->bkrd", probs, v_full)
    out = out.reshape(b, 1, h * dh) @ p["wo"].to(x.dtype)
    return out, cache_k, cache_v
