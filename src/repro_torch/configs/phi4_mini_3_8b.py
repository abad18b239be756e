"""Phi-4-mini 3.8B [dense] — RoPE + SwiGLU + GQA."""
from .base import ArchConfig, MLAConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=200064, rope_theta=1e4,
))
