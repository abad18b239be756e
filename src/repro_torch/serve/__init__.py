"""K-means as a live index: batched low-latency centroid serving (port
of ``repro.serve``).

* :class:`CentroidIndex` — double-buffered epoch swap: fitters
  ``publish()`` new centroids (group tables rebuilt or reused on the
  drift ledger's word), servers ``acquire()`` immutable snapshots.
  Serving never blocks on fitting, and a query batch sees exactly one
  epoch.
* :class:`ServeEngine` — request micro-batching: pow2 bucket padding
  with reused pad buffers, one snapshot per batch, the batched exact
  assign (``engine.make_serve_assign``: ``fused``, ``grouped`` or the
  ``kernel`` backend), metrics on the shared registry.

Quick start::

    from repro_torch.serve import CentroidIndex, ServeEngine

    index = CentroidIndex(km.cluster_centers_)       # on cuda
    with ServeEngine(index) as eng:
        labels, epoch = eng.assign(queries)
"""
from .engine import ServeEngine, ServeResult
from .index import CentroidIndex, CentroidSnapshot

__all__ = ["CentroidIndex", "CentroidSnapshot", "ServeEngine",
           "ServeResult"]
