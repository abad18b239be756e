"""The LM serving path (port of ``repro.models``): config-driven
decoder parameters, forward, prefill and decode."""
from .transformer import (decode_step, forward, init_cache, init_params,
                          param_shapes, prefill_forward)

__all__ = ["init_params", "param_shapes", "forward", "decode_step",
           "init_cache", "prefill_forward"]
