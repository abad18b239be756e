"""Architecture registry: one module per architecture (data only), and
the paper's k-means problems (``kpynq``)."""
from .base import ArchConfig, MLAConfig, SSMConfig, get_config, list_configs
from .kpynq import KMeansProblem, paper_suite, production, smoke

_LOADED = False

ARCH_MODULES = [
    "llava_next_mistral_7b", "llama4_scout_17b_a16e", "qwen3_moe_235b_a22b",
    "mistral_nemo_12b", "minicpm3_4b", "qwen2_7b", "phi4_mini_3_8b",
    "musicgen_medium", "hymba_1_5b", "mamba2_780m",
]


def _load_all():
    global _LOADED
    if _LOADED:
        return
    import importlib
    for mod in ARCH_MODULES:
        importlib.import_module(f"{__name__}.{mod}")
    _LOADED = True


__all__ = ["ArchConfig", "MLAConfig", "SSMConfig", "get_config",
           "list_configs", "ARCH_MODULES", "KMeansProblem", "paper_suite",
           "production", "smoke"]
