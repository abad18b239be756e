"""Qwen3-MoE 235B-A22B [moe] — 128 experts, top-8."""
from .base import ArchConfig, MLAConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936, rope_theta=1e6,
    n_experts=128, moe_top_k=8,
))
