"""Streaming / mini-batch K-means (port of ``repro.streaming``).

``StreamingKMeans.partial_fit`` feeds point shards through the engine's
two-level-filtered candidate pass with triangle-inequality bounds
carried across batches (see ``estimator.py``); ``fit_stream_resilient``
checkpoints the stream state and replays the stream after a failure
(see ``resilient.py``).
"""
from .estimator import StreamingKMeans
from .resilient import fit_stream_resilient
from .state import (BoundCache, DriftLedger, ShardBounds, StreamStats,
                    inflate_bounds)

__all__ = [
    "StreamingKMeans", "StreamStats", "ShardBounds", "DriftLedger",
    "BoundCache", "inflate_bounds", "fit_stream_resilient",
]
