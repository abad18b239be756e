"""KPynq K-means in PyTorch and CUDA for NVIDIA Hopper.

The counterpart of the JAX package ``repro``: the same filtered Yinyang
fit and predict, with the candidate pass (``kernels.grouped_assign``)
and the centroid sums (``kernels.centroid_update``) as CUDA kernels
written for ``sm_90a``, the engine's compact backend, and the
``repro.kernels`` entry point (``kernels.pairwise_sq_dists``,
``kernels.filtered_assign`` and their glue); observability
(``obs``: the fit's telemetry ring, metrics, profiler ranges and
traces), autotuning (``tune``: a per-card cache of measured engine and
serve configurations), and the k-means serving index (``serve``:
``CentroidIndex`` and the micro-batching ``ServeEngine``), streaming
with checkpoints, and the sharded batch fit on ``torch.distributed``
(``core.distributed_yinyang``); and the LM
serving path (``configs``, ``models``, ``train``: prefill and decode of
every config without MLA or MoE) on the ``kernels.flash_attention`` and
``kernels.ssd_intra`` kernels. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; the kernels are built with ``nvcc`` at
first use, so importing this package needs neither a card nor a
compiler.
"""
from .core.api import KMeans, NotFittedError
from .core.engine import EngineConfig, EngineStats, fit as engine_fit
from .core.compact import yinyang_compact
from .core.kmeans import KMeansResult, lloyd, yinyang
from .device import resolve_device
from .obs import MetricsRegistry, ObsConfig
from .serve import CentroidIndex, ServeEngine
from .tune import ServeConfig, autotune, autotune_serve, get_or_tune

__all__ = ["KMeans", "NotFittedError", "EngineConfig", "EngineStats",
           "engine_fit", "KMeansResult", "lloyd", "yinyang",
           "yinyang_compact", "resolve_device", "MetricsRegistry",
           "ObsConfig", "CentroidIndex", "ServeEngine", "ServeConfig",
           "autotune", "autotune_serve", "get_or_tune"]
