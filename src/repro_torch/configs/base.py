"""Architecture config schema and registry (port of ``repro.configs.base``).

Every architecture is one frozen :class:`ArchConfig` in this package;
``reduced()`` derives the CPU test variant (same family and topology,
tiny widths). The fields are the reference's, so a config carries
across by name; the sharding and analysis knobs (``attn_cp``,
``causal_slice``, ``unroll_layers``, ``unroll_chunks``, ``batch_2d``,
``serve_tp_params``) are kept for that reason and change no value in
the port. ``remat="full"`` makes training recompute each layer in the
backward pass instead of keeping its activations
(``models.transformer.forward``), which changes memory and time, never
a value.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    nope_dim: int
    rope_dim: int
    v_dim: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_inner: int
    n_heads: int
    head_dim: int
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    rope_theta: float = 1e4
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    # variants
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # frontend stubs
    n_vision_tokens: int = 0    # vlm: precomputed patch embeds per sample
    # execution (chunk sizes and the knobs below do not change values)
    q_chunk: int = 1024
    loss_chunk: int = 1024
    remat: str = "full"
    unroll_layers: bool = False
    unroll_chunks: bool = False
    attn_cp: bool = False
    batch_2d: bool = False
    serve_tp_params: bool = False
    causal_slice: bool = False
    kv_cache_dtype: str = "native"  # 'native' | 'int8'
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (padded ids never
        appear in labels)."""
        return -(-self.vocab // 256) * 256

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU tests."""
        scale = {}
        scale["n_layers"] = min(self.n_layers, 2)
        scale["d_model"] = 64
        n_h = max(min(self.n_heads, 4), 1)
        n_kv = max(min(self.n_kv_heads, n_h), 1)
        if n_h % n_kv:
            n_kv = 1
        scale["n_heads"] = n_h
        scale["n_kv_heads"] = n_kv
        scale["head_dim"] = 16
        scale["d_ff"] = 128 if self.d_ff else 0
        scale["vocab"] = 256
        if self.n_experts:
            scale["n_experts"] = min(self.n_experts, 4)
            scale["moe_top_k"] = min(self.moe_top_k, 2)
        if self.mla is not None:
            scale["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                     nope_dim=8, rope_dim=8, v_dim=8)
        if self.ssm is not None:
            scale["ssm"] = SSMConfig(d_state=8, d_inner=128, n_heads=4,
                                     head_dim=32, n_groups=1,
                                     conv_width=self.ssm.conv_width,
                                     chunk=8)
        if self.n_vision_tokens:
            scale["n_vision_tokens"] = 8
        scale["q_chunk"] = 32
        scale["loss_chunk"] = 32
        scale["dtype"] = "float32"
        return dataclasses.replace(self, **scale)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from . import _load_all
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from . import _load_all
    _load_all()
    return sorted(_REGISTRY)
