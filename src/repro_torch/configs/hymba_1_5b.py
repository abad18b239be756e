"""Hymba-1.5B [hybrid] — parallel attention + Mamba heads per layer."""
from .base import ArchConfig, MLAConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001, rope_theta=1e4,
    ssm=SSMConfig(d_state=16, d_inner=3200, n_heads=25, head_dim=128,
                  n_groups=1, conv_width=4, chunk=128),
))
