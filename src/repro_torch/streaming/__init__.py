"""Streaming / mini-batch K-means (port of ``repro.streaming``).

``StreamingKMeans.partial_fit`` feeds point shards through the engine's
two-level-filtered candidate pass with triangle-inequality bounds
carried across batches (see ``estimator.py``). ``fit_stream_resilient``
(checkpoints and replay) is ROADMAP Queue 1 item 7b.
"""
from .estimator import StreamingKMeans
from .state import (BoundCache, DriftLedger, ShardBounds, StreamStats,
                    inflate_bounds)

__all__ = [
    "StreamingKMeans", "StreamStats", "ShardBounds", "DriftLedger",
    "BoundCache", "inflate_bounds",
]
