"""Llama-4 Scout 17B-active 16-expert [moe] — early-fusion frontend stubbed."""
from .base import ArchConfig, MLAConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048, rope_theta=5e5,
    n_experts=16, moe_top_k=1,
))
