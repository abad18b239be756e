"""Attention: grouped-query attention (GQA, MHA) and multi-head latent
attention (MLA) (port of ``repro.models.attention``).

Prefill and training attention is the ``flash_attention`` kernel
(``kernels.flash_attention_gqa``): queries in (B, S, H, D), keys and
values in (B, S, KV, D) as the projections leave them, fp32 softmax,
causal over absolute positions. The reference's query chunking
(``q_chunk``, ``unroll_chunks``, ``causal_slice``) and its sharding
constraints (``attn_cp``) only bound memory or place data on a mesh;
the kernel never forms the (S, S) scores, so the port accepts those
knobs and ignores them. MLA attends through the same kernel with
KV = H: V is zero-padded to the q.k width (``nope + rope``), so the
kernel's scale 1/sqrt(width) is the reference's, and the padded output
columns, exactly 0, are sliced off.

Decode is plain torch over positions [0, pos], writing the new token's
cache entries in place: GQA reads a KV cache in the compute dtype, or
the int8 cache (:func:`quantize_kv`, values and a scale per token and
head) that ``kv_cache_dtype="int8"`` selects; MLA reads its latent
cache (``kvc``, ``kpe``) and expands it each step, as the reference does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def quantize_kv(t):
    """Per-(token, head) int8 quantization, JAX's arithmetic step for
    step: t (B, S, KV, Dh) -> (int8 values, fp32 scales (B, S, KV)). The
    scale is max|t| / 127 + 1e-8; each value is divided by it (not
    multiplied by its reciprocal), rounded half to even and clipped to
    +-127, so equal fp32 inputs give the reference's bits."""
    tf = t.float()
    scale = tf.abs().amax(dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def gqa_decode(x, p, cfg, cache_k, cache_v, pos: int, cache_scales=None):
    """x: (B, 1, D); cache_k/v: (B, Smax, KV, Dh); pos: the position of
    x. Writes this token's k and v into the caches **in place** (the
    reference returns updated copies) and returns
    (out (B, 1, D), cache_k, cache_v). Scores are taken in the compute
    dtype and softmaxed in fp32 over positions [0, pos], as the
    reference's mask leaves them.

    ``cache_scales=(k_scale, v_scale)``, each (B, Smax, KV) fp32, takes
    int8 caches: the token's k and v are quantized (:func:`quantize_kv`)
    and written with their scales in place, [0, pos] is dequantized to
    the compute dtype, and the scales come back as a fourth item."""
    b = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = int(pos)
    posv = torch.full((b, 1), pos, device=x.device)
    q, k, v = _qkv(x, p, cfg, posv)
    if cache_scales is not None:
        ks, vs = cache_scales
        for cache, scales, t in ((cache_k, ks, k), (cache_v, vs, v)):
            tq, ts = quantize_kv(t)
            cache[:, pos] = tq[:, 0]
            scales[:, pos] = ts[:, 0]
        k_full = dequantize_kv(cache_k[:, :pos + 1], ks[:, :pos + 1],
                               x.dtype)
        v_full = dequantize_kv(cache_v[:, :pos + 1], vs[:, :pos + 1],
                               x.dtype)
    else:
        cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
        cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
        k_full = cache_k[:, :pos + 1].to(x.dtype)           # (B, T, KV, Dh)
        v_full = cache_v[:, :pos + 1].to(x.dtype)
    qg = q.view(b, kv, h // kv, dh)
    scores = torch.einsum("bkrd,btkd->bkrt", qg, k_full).float()
    scores = scores * (1.0 / math.sqrt(dh))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkrt,btkd->bkrd", probs, v_full)
    out = out.reshape(b, 1, h * dh) @ p["wo"].to(x.dtype)
    if cache_scales is not None:
        return out, cache_k, cache_v, (ks, vs)
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------

def _mla_qkv(x, p, cfg, positions):
    """The projections of MLA's training and decode: q (B, S, H, nope +
    rope), rope on its last ``rope`` columns only; the latent kv_c
    (B, S, kv_lora_rank); the shared key rope part k_pe (B, S, rope)."""
    m = cfg.mla
    b, s, _ = x.shape
    q_c = x @ p["w_dq"].to(x.dtype)
    q = (q_c @ p["w_uq"].to(x.dtype)).view(b, s, cfg.n_heads,
                                           m.nope_dim + m.rope_dim)
    q = torch.cat([q[..., :m.nope_dim],
                   apply_rope(q[..., m.nope_dim:], positions,
                              cfg.rope_theta)], dim=-1)
    kv_c = x @ p["w_dkv"].to(x.dtype)
    k_pe = x @ p["w_kr"].to(x.dtype)
    k_pe = apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q, kv_c, k_pe


def _mla_attend(kv_c, k_pe, p, cfg):
    """Keys (B, S, H, nope + rope), each head's nope part expanded from
    the latent and the rope part shared, and values (B, S, H, v_dim)."""
    m = cfg.mla
    b, s, _ = kv_c.shape
    h = cfg.n_heads
    kv = (kv_c @ p["w_ukv"].to(kv_c.dtype)).view(b, s, h,
                                                 m.nope_dim + m.v_dim)
    k = torch.cat([kv[..., :m.nope_dim],
                   k_pe[:, :, None, :].expand(b, s, h, m.rope_dim)], dim=-1)
    return k, kv[..., m.nope_dim:]


def mla_train(x, p, cfg, positions, return_kv: bool = False):
    """x: (B, S, D) -> (B, S, D) through ``kernels.flash_attention_gqa``
    with KV = H and V zero-padded to the q.k width: the kernel's scale
    is then the reference's 1/sqrt(nope + rope), and the padded output
    columns (exactly 0) are sliced off. ``return_kv=True`` also returns
    the prefill's latent cache (kv_c (B, S, r), k_pe (B, S, rope))."""
    b, s, _ = x.shape
    m = cfg.mla
    q, kv_c, k_pe = _mla_qkv(x, p, cfg, positions)
    k, v = _mla_attend(kv_c, k_pe, p, cfg)
    v = F.pad(v, (0, m.nope_dim + m.rope_dim - m.v_dim))
    out = kernels.flash_attention_gqa(q, k, v)[..., :m.v_dim]
    out = out.reshape(b, s, cfg.n_heads * m.v_dim) @ p["wo"].to(x.dtype)
    if return_kv:
        return out, kv_c, k_pe
    return out


def mla_decode(x, p, cfg, cache_kvc, cache_kpe, pos: int):
    """x: (B, 1, D); the latent caches kvc (B, Smax, r) and kpe
    (B, Smax, rope). Writes this token's entries **in place** and
    attends over positions [0, pos], keys and values expanded from the
    latents as the reference does; returns (out, cache_kvc, cache_kpe)."""
    b = x.shape[0]
    m = cfg.mla
    pos = int(pos)
    posv = torch.full((b, 1), pos, device=x.device)
    q, kv_c, k_pe = _mla_qkv(x, p, cfg, posv)
    cache_kvc[:, pos] = kv_c[:, 0].to(cache_kvc.dtype)
    cache_kpe[:, pos] = k_pe[:, 0].to(cache_kpe.dtype)
    k, v = _mla_attend(cache_kvc[:, :pos + 1].to(x.dtype),
                       cache_kpe[:, :pos + 1].to(x.dtype), p, cfg)
    scores = torch.einsum("bihd,bjhd->bhij", q, k).float()
    scores = scores * (1.0 / math.sqrt(m.nope_dim + m.rope_dim))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhij,bjhd->bihd", probs, v)
    out = out.reshape(b, 1, cfg.n_heads * m.v_dim) @ p["wo"].to(x.dtype)
    return out, cache_kvc, cache_kpe
