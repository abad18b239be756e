"""Step functions of the LM serving path (port of ``repro.train``)."""
from .steps import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
