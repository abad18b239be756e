"""Gradient compression (port of ``repro.optim``; the AdamW optimizer
and its schedules are not ported yet, ROADMAP Queue 1 item 11)."""
from .compression import (compress_psum, dequantize_int8, init_residual,
                          quantize_int8)

__all__ = ["quantize_int8", "dequantize_int8", "compress_psum",
           "init_residual"]
