"""AdamW and its schedule, and gradient compression (port of
``repro.optim``)."""
from .adamw import (AdamWConfig, adamw_update, cosine_lr, global_norm,
                    init_moments)
from .compression import (compress_psum, dequantize_int8, init_residual,
                          quantize_int8)

__all__ = ["AdamWConfig", "adamw_update", "cosine_lr", "global_norm",
           "init_moments", "quantize_int8", "dequantize_int8",
           "compress_psum", "init_residual"]
