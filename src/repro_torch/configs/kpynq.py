"""The paper's own workload: K-means problem configs (the port's copy of
``repro.configs.kpynq``; data only).

``paper_suite`` spans the scale range of the six UCI datasets of the
paper's table (it evaluates on "large-size, high-dimension" data but
does not name the six; these cover the usual UCI clustering picks from
small, Iris-like, to large, US Census- or KDD-cup-like).
``production`` is the multi-pod-scale problem of the mesh dry-run.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KMeansProblem:
    name: str
    n_points: int
    n_dims: int
    k: int
    n_groups: int | None = None      # None -> K // 10 heuristic
    max_iters: int = 50
    tol: float = 1e-4


# UCI-like ladder (size x dimensionality spread, as in the paper's table)
paper_suite = [
    KMeansProblem("uci-small",   n_points=4_096,     n_dims=16,  k=32),
    KMeansProblem("uci-medium",  n_points=32_768,    n_dims=32,  k=64),
    KMeansProblem("uci-wide",    n_points=32_768,    n_dims=128, k=64),
    KMeansProblem("uci-large",   n_points=262_144,   n_dims=64,  k=128),
    KMeansProblem("uci-xlarge",  n_points=1_048_576, n_dims=32,  k=256),
    KMeansProblem("uci-highk",   n_points=262_144,   n_dims=32,  k=1024),
]

# Multi-pod scale: points sharded over every chip of the production mesh.
production = KMeansProblem("kpynq-production", n_points=16_777_216,
                           n_dims=128, k=4096, max_iters=20)

smoke = KMeansProblem("kpynq-smoke", n_points=2_048, n_dims=8, k=16,
                      max_iters=10)
