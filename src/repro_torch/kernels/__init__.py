"""Hand-written CUDA kernels of the port, each module with its kernel's
wrapper, its plain PyTorch version and a launch counter
(``grouped_assign.grouped_assign.launches``). Built at first use
(``_build``); callers look the wrappers up on their modules."""
from .ops import build_group_block_mask

__all__ = ["build_group_block_mask"]
