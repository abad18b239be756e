"""The LM (port of ``repro.models``): config-driven decoder
parameters, forward, the training loss, prefill and decode."""
from .transformer import (decode_step, forward, init_cache, init_params,
                          loss_fn, param_shapes, prefill_forward)

__all__ = ["init_params", "param_shapes", "forward", "loss_fn",
           "decode_step", "init_cache", "prefill_forward"]
