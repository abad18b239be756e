"""MusicGen-medium [audio] — decoder-only over EnCodec tokens (frontend stubbed\nto a single codebook stream; RoPE replaces sinusoidal PE — noted in DESIGN.md)."""
from .base import ArchConfig, MLAConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab=2048, rope_theta=1e4,
))
