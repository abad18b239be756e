"""Qwen2-7B [dense] — GQA with QKV bias."""
from .base import ArchConfig, MLAConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab=152064, rope_theta=1e6, qkv_bias=True,
))
