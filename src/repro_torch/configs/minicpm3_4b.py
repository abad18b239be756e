"""MiniCPM3-4B [dense] — MLA (multi-head latent attention)."""
from .base import ArchConfig, MLAConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=6400, vocab=73448, rope_theta=1e4,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  nope_dim=64, rope_dim=32, v_dim=64),
))
