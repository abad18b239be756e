"""KPynq core in PyTorch: distances, reference loops, engine, API and
the sharded fit."""
from .distributed import distributed_yinyang, make_mesh

__all__ = ["distributed_yinyang", "make_mesh"]
