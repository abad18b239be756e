"""Hand-written CUDA kernels of the port and their glue (the
counterpart of ``repro.kernels``).

Each kernel module holds its kernel's wrapper, its plain PyTorch
version and a launch counter on the wrapper
(``repro_torch.kernels.grouped_assign.launches``). The package exports
the wrappers under the names ``repro.kernels`` uses, so the package
attribute ``grouped_assign`` is the function; reach a module itself
with ``importlib.import_module("repro_torch.kernels.grouped_assign")``.
Kernels are built at first use (``_build``). Callers in the port call
them through this package (``kernels.grouped_assign(...)``), so that a
check can swap a wrapper for its plain version in one place. The LM
kernels have a second wrapper each for the model's own layout
(``flash_attention_gqa``, ``ssd_intra_chunks``), counted on the entry
point's wrapper (``flash_attention.launches``, ``ssd_intra.launches``).
"""
from .bounds_upkeep import bounds_upkeep, own_dists
from .candidate_tail import candidate_mask, candidate_tail
from .centroid_update import centroid_update
from .distance import pairwise_sq_dists
from .filtered_assign import filtered_assign
from .flash_attention import flash_attention, flash_attention_gqa
from .grouped_assign import grouped_assign
from .ops import (build_block_mask, build_group_block_mask, compact_indices,
                  filtered_assign_auto)
from .ssd_intra import ssd_intra, ssd_intra_chunks

__all__ = ["pairwise_sq_dists", "filtered_assign", "centroid_update",
           "bounds_upkeep", "build_block_mask", "build_group_block_mask",
           "candidate_mask", "candidate_tail",
           "compact_indices", "filtered_assign_auto", "grouped_assign",
           "flash_attention", "flash_attention_gqa", "own_dists",
           "ssd_intra", "ssd_intra_chunks"]
