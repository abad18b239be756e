"""Config-driven decoder (port of ``repro.models.transformer``:
parameters, forward, the training loss, prefill, decode).

Parameters are a plain dict tree with per-layer leaves stacked on a
leading ``n_layers`` axis, the reference's layout, so that its weights
carry across one to one (``repro_torch.convert``); the layers run in a
Python loop over that axis, each leaf unbound once a pass (the
gradient of ``unbind`` is one ``stack``, where a ``select`` per layer
would build a zero tensor of the whole stack per layer). Every config
without MLA or MoE is supported: dense, vlm (with ``vision_embeds``),
audio, ssm and hybrid. MLA, MoE and the int8 KV cache raise
``NotImplementedError``, each naming its ROADMAP.md item.

``cfg.remat == "full"`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``, non-reentrant) instead of keeping its
activations, as the reference's ``jax.checkpoint(nothing_saveable)``
does: the same values, less memory.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from .attention import gqa_decode, gqa_train
from .layers import cross_entropy_chunked, rms_norm, swiglu
from .mamba import mamba_mixer_decode, mamba_mixer_train

# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run."""
    def not_ported(what, item):
        return NotImplementedError(f"{cfg.name}: {what} is not ported yet "
                                   f"(ROADMAP.md, Queue 1 item 11.{item})")
    if cfg.mla is not None:
        raise not_ported("MLA attention", 2)
    if cfg.family == "moe" or cfg.n_experts:
        raise not_ported("the MoE FFN", 3)
    if cfg.kv_cache_dtype != "native":
        raise not_ported(f"kv_cache_dtype={cfg.kv_cache_dtype!r}", 4)


def _layer_shapes(cfg: ArchConfig) -> dict:
    """Per-layer parameter shapes (without the stacked L axis)."""
    d = cfg.d_model
    s: dict = {"ln1": (d,)}
    if cfg.family != "ssm":
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        if cfg.mla is not None:
            m = cfg.mla
            s["attn"] = {
                "w_dq": (d, m.q_lora_rank),
                "w_uq": (m.q_lora_rank, h * (m.nope_dim + m.rope_dim)),
                "w_dkv": (d, m.kv_lora_rank),
                "w_kr": (d, m.rope_dim),
                "w_ukv": (m.kv_lora_rank, h * (m.nope_dim + m.v_dim)),
                "wo": (h * m.v_dim, d),
            }
        else:
            s["attn"] = {"wq": (d, h * dh), "wk": (d, kv * dh),
                         "wv": (d, kv * dh), "wo": (h * dh, d)}
            if cfg.qkv_bias:
                s["attn"].update({"bq": (h * dh,), "bk": (kv * dh,),
                                  "bv": (kv * dh,)})
    if cfg.family in ("ssm", "hybrid"):
        m = cfg.ssm
        gn = m.n_groups * m.d_state
        conv_ch = m.d_inner + 2 * gn
        s["mamba"] = {
            # z + xBC fused; dt separate (n_heads may be odd)
            "in_proj": (d, 2 * m.d_inner + 2 * gn),
            "dt_proj": (d, m.n_heads),
            "conv_w": (m.conv_width, conv_ch),
            "dt_bias": (m.n_heads,),
            "A_log": (m.n_heads,),
            "D": (m.n_heads,),
            "out_norm": (m.d_inner,),
            "out_proj": (m.d_inner, d),
        }
    if cfg.family == "hybrid":
        s["mix_na"] = (d,)
        s["mix_nm"] = (d,)
    if cfg.d_ff:
        s["ln2"] = (d,)
        if cfg.family == "moe":
            s["moe"] = {"router": (d, cfg.n_experts),
                        "w_gate": (cfg.n_experts, d, cfg.d_ff),
                        "w_up": (cfg.n_experts, d, cfg.d_ff),
                        "w_down": (cfg.n_experts, cfg.d_ff, d)}
        else:
            s["mlp"] = {"w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
                        "w_down": (cfg.d_ff, d)}
    return s


FP32_LEAVES = ("A_log", "dt_bias", "D")
_ONES_LEAVES = ("ln1", "ln2", "out_norm", "mix_na", "mix_nm", "final_norm")


def _map_shapes(fn, tree):
    return {k: _map_shapes(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def param_shapes(cfg: ArchConfig) -> dict:
    """Full-model parameter shape tree (stacked layers)."""
    layer = _map_shapes(lambda shp: (cfg.n_layers, *shp), _layer_shapes(cfg))
    tree = {"embed": (cfg.padded_vocab, cfg.d_model), "layers": layer,
            "final_norm": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (cfg.d_model, cfg.padded_vocab)
    return tree


def leaf_dtype(path: str, cfg: ArchConfig) -> torch.dtype:
    """The dtype of the leaf at ``path`` ("layers/mamba/A_log")."""
    if path.split("/")[-1] in FP32_LEAVES:
        return torch.float32
    return cfg.compute_dtype


def flatten_with_path(tree, prefix=""):
    """[(path, leaf)] in the tree's insertion order."""
    out = []
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out += flatten_with_path(v, p)
        else:
            out.append((p, v))
    return out


def rebuild(tree, leaves: dict, prefix=""):
    """``tree``'s structure with the leaves of ``leaves`` (by path)."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out[k] = rebuild(v, leaves, p) if isinstance(v, dict) else leaves[p]
    return out


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> dict:
    """Materialise parameters on ``device`` (``None``: ``cuda``).

    The deterministic leaves are the reference's (norms and ``D`` ones,
    ``A_log`` the log of a 1..16 linspace, ``dt_bias`` -4.6); the
    others are normal draws from ``generator`` (on its own device),
    std 0.02 for the embeddings and fan_in^-1/2 otherwise. The draws
    are not JAX's: two packages agree only in distribution, so parity
    tests carry JAX's weights across (``convert.lm_params_from_numpy``).
    """
    check_supported(cfg)
    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    leaves = {}
    for path, shape in flatten_with_path(shapes):
        name = path.split("/")[-1]
        dt = leaf_dtype(path, cfg)
        if name in _ONES_LEAVES or name == "D":
            leaf = torch.ones(shape, dtype=dt, device=dev)
        elif name == "A_log":
            lin = torch.linspace(1.0, 16.0, shape[-1], device=dev)
            leaf = torch.log(lin).expand(shape).contiguous()
        elif name == "dt_bias":
            leaf = torch.full(shape, -4.6, dtype=torch.float32, device=dev)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            std = 0.02 if name in ("embed", "lm_head") else fan_in ** -0.5
            leaf = torch.randn(shape, generator=generator,
                               device=generator.device)
            leaf = (leaf * std).to(device=dev, dtype=dt)
        leaves[path] = leaf
    return rebuild(shapes, leaves)


def _layers(tree: dict, n: int) -> list:
    """The per-layer trees of a stacked tree, each leaf unbound once."""
    flat = flatten_with_path(tree)
    parts = {path: leaf.unbind(0) for path, leaf in flat}
    return [rebuild(tree, {path: parts[path][i] for path, _ in flat})
            for i in range(n)]


def _embed(params, tokens, cfg: ArchConfig, vision_embeds=None):
    b, s = tokens.shape
    dt = cfg.compute_dtype
    # F.embedding's gradient on the card sums each row in a fixed
    # order; an indexing gather's is an atomic index_put_
    x = F.embedding(tokens.long(), params["embed"]).to(dt)
    if vision_embeds is not None and cfg.n_vision_tokens:
        nv = cfg.n_vision_tokens
        vis = torch.zeros_like(x)
        vis[:, :nv] = vision_embeds.to(dt)
        keep = (torch.arange(s, device=x.device) < nv)[None, :, None]
        x = torch.where(keep, vis, x)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    return x, positions


def _ffn(x, lp, cfg: ArchConfig):
    if cfg.d_ff:
        h2 = rms_norm(x, lp["ln2"])
        x = x + swiglu(h2, lp["mlp"]["w_gate"], lp["mlp"]["w_up"],
                       lp["mlp"]["w_down"])
    return x


def _logits(params, h, cfg: ArchConfig):
    lm_head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return (h @ lm_head.to(cfg.compute_dtype)).float()


# ---------------------------------------------------------------------------
# forward (the hidden states of every position)
# ---------------------------------------------------------------------------


def _layer_train(x, lp, cfg: ArchConfig, positions):
    h = rms_norm(x, lp["ln1"])
    if cfg.family == "ssm":
        x = x + mamba_mixer_train(h, lp["mamba"], cfg)
    elif cfg.family == "hybrid":
        attn_out = gqa_train(h, lp["attn"], cfg, positions)
        mamba_out = mamba_mixer_train(h, lp["mamba"], cfg)
        x = x + 0.5 * (rms_norm(attn_out, lp["mix_na"]) +
                       rms_norm(mamba_out, lp["mix_nm"]))
    else:
        x = x + gqa_train(h, lp["attn"], cfg, positions)
    return _ffn(x, lp, cfg)


def forward(params, tokens, cfg: ArchConfig, vision_embeds=None):
    """tokens: (B, S) int -> final hidden states (B, S, D). Where
    autograd records and ``cfg.remat == "full"``, each layer is
    recomputed in the backward pass rather than kept."""
    check_supported(cfg)
    x, positions = _embed(params, tokens, cfg, vision_embeds)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for lp in _layers(params["layers"], cfg.n_layers):
        if remat:
            # the layer draws no random numbers: no RNG state to keep
            x = checkpoint(_layer_train, x, lp, cfg, positions,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer_train(x, lp, cfg, positions)
    return rms_norm(x, params["final_norm"])


def loss_fn(params, batch, cfg: ArchConfig):
    """Mean next-token cross-entropy of ``batch`` (``tokens``,
    ``labels``, optional ``loss_mask`` and ``vision_embeds``, tensors on
    the parameters' device), chunked by ``cfg.loss_chunk``."""
    h = forward(params, batch["tokens"], cfg,
                vision_embeds=batch.get("vision_embeds"))
    lm_head = (params["embed"].T if cfg.tie_embeddings
               else params["lm_head"])
    return cross_entropy_chunked(h, lm_head, batch["labels"],
                                 chunk=cfg.loss_chunk,
                                 mask=batch.get("loss_mask"))


# ---------------------------------------------------------------------------
# prefill (serving: populate the cache in one parallel pass)
# ---------------------------------------------------------------------------


def _layer_prefill(x, lp, cfg: ArchConfig, positions):
    cache = {}
    h = rms_norm(x, lp["ln1"])
    if cfg.family == "ssm":
        out, st, cv = mamba_mixer_train(h, lp["mamba"], cfg,
                                        return_state=True)
        x = x + out
        cache.update(ssm=st, conv=cv)
    elif cfg.family == "hybrid":
        attn_out, k, v = gqa_train(h, lp["attn"], cfg, positions,
                                   return_kv=True)
        mamba_out, st, cv = mamba_mixer_train(h, lp["mamba"], cfg,
                                              return_state=True)
        x = x + 0.5 * (rms_norm(attn_out, lp["mix_na"]) +
                       rms_norm(mamba_out, lp["mix_nm"]))
        cache.update(k=k, v=v, ssm=st, conv=cv)
    else:
        out, k, v = gqa_train(h, lp["attn"], cfg, positions, return_kv=True)
        x = x + out
        cache.update(k=k, v=v)
    return _ffn(x, lp, cfg), cache


def prefill_forward(params, tokens, cfg: ArchConfig, vision_embeds=None):
    """Parallel prefill: (B, S) tokens -> (last-token logits (B, 1, V)
    fp32, the per-layer cache stacked on L covering positions [0, S))."""
    check_supported(cfg)
    x, positions = _embed(params, tokens, cfg, vision_embeds)
    caches = []
    for lp in _layers(params["layers"], cfg.n_layers):
        x, c = _layer_prefill(x, lp, cfg, positions)
        caches.append(c)
    cache = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
    h = rms_norm(x[:, -1:], params["final_norm"])
    return _logits(params, h, cfg), cache


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Per-layer decode cache, stacked on L, zeros on ``device``
    (``None``: ``cuda``). Attention archs: k, v (L, B, max_len, KV, Dh)
    in the compute dtype; ssm archs: the (H, N, P) fp32 state and the
    conv ring (W-1 inputs)."""
    check_supported(cfg)
    dev = resolve_device(device)
    L = cfg.n_layers
    dt = cfg.compute_dtype
    cache: dict = {}
    if cfg.family != "ssm":
        kv, dh = cfg.n_kv_heads, cfg.head_dim
        cache["k"] = torch.zeros((L, batch, max_len, kv, dh), dtype=dt,
                                 device=dev)
        cache["v"] = torch.zeros((L, batch, max_len, kv, dh), dtype=dt,
                                 device=dev)
    if cfg.family in ("ssm", "hybrid"):
        m = cfg.ssm
        cache["ssm"] = torch.zeros((L, batch, m.n_heads, m.d_state,
                                    m.head_dim), dtype=torch.float32,
                                   device=dev)
        cache["conv"] = torch.zeros(
            (L, batch, m.conv_width - 1,
             m.d_inner + 2 * m.n_groups * m.d_state), dtype=dt, device=dev)
    return cache


def _layer_decode(x, lp, cl, cfg: ArchConfig, pos: int):
    new = {}
    h = rms_norm(x, lp["ln1"])
    if cfg.family in ("ssm", "hybrid"):
        mamba_out, new["ssm"], new["conv"] = mamba_mixer_decode(
            h, lp["mamba"], cfg, cl["ssm"], cl["conv"])
    if cfg.family == "ssm":
        x = x + mamba_out
    else:
        attn_out, _, _ = gqa_decode(h, lp["attn"], cfg, cl["k"], cl["v"], pos)
        if cfg.family == "hybrid":
            x = x + 0.5 * (rms_norm(attn_out, lp["mix_na"]) +
                           rms_norm(mamba_out, lp["mix_nm"]))
        else:
            x = x + attn_out
    return _ffn(x, lp, cfg), new


def decode_step(params, cache, tokens, pos, cfg: ArchConfig):
    """One serving step: tokens (B, 1) at position ``pos`` -> (logits
    (B, 1, V) fp32, cache). The cache is updated **in place** (this
    token's k and v written at ``pos``, the ssm state and conv ring
    replaced) and returned; the reference returns a new one."""
    check_supported(cfg)
    pos = int(pos)
    x = F.embedding(tokens.long(), params["embed"]).to(cfg.compute_dtype)
    for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
        cl = {k: v[i] for k, v in cache.items()}
        x, new = _layer_decode(x, lp, cl, cfg, pos)
        for k, v in new.items():
            cache[k][i] = v
    h = rms_norm(x, params["final_norm"])
    return _logits(params, h, cfg), cache
