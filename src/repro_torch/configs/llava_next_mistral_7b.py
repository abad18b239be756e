"""LLaVA-NeXT (1.6) Mistral-7B backbone [vlm] — anyres tiling frontend stubbed."""
from .base import ArchConfig, MLAConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000, rope_theta=1e6,
    n_vision_tokens=576,  # one 24x24 CLIP grid per sample (anyres stub)
))
