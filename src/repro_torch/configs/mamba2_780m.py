"""Mamba2-780m [ssm] — attention-free SSD (state-space duality)."""
from .base import ArchConfig, MLAConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280, rope_theta=1e4,
    ssm=SSMConfig(d_state=128, d_inner=3072, n_heads=48, head_dim=64,
                  n_groups=1, conv_width=4, chunk=128),
))
