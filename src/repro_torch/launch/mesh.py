"""Meshes over the ranks of a ``torch.distributed`` world (port of
``repro.launch.mesh``).

Functions, not module constants: importing this module touches no
process group. The production shapes are the reference's:

  single pod : 16 x 16 = 256 ranks, axes ("data", "model")
  multi-pod  : 2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model")

"model" carries the tensor-parallel shards of the partition rules,
"data" data parallelism and the FSDP shards of the parameters and
moments, "pod" data parallelism alone. A mesh is a ``DeviceMesh`` of
device type ``cuda`` unless the caller asks for the CPU: a DTensor's
local tensor lives on its mesh's device type (``DTensor.from_local``
moves a CUDA shard onto the CPU under a ``cpu`` mesh), so ranks that
share a card over ``gloo`` need a ``cuda`` mesh all the same.
:class:`AbstractMesh` has a mesh's shape and axis names and no ranks,
for the dry run, which needs no process group.
"""
from __future__ import annotations

import math
import os

import torch

from ..device import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


class AbstractMesh:
    """A mesh's shape and axis names, with ``DeviceMesh``'s accessors
    (``shape``, ``ndim``, ``mesh_dim_names``, ``size``) and no ranks."""

    def __init__(self, shape, names):
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} and axes {names} differ "
                             f"in length")
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(names)
        self.ndim = len(self.shape)

    def size(self, mesh_dim: int | None = None) -> int:
        return math.prod(self.shape) if mesh_dim is None \
            else self.shape[mesh_dim]

    def __repr__(self):
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def _world_size() -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs torch.distributed."
                           "init_process_group first")
    return dist.get_world_size()


def _mesh(shape, names, device):
    from torch.distributed.device_mesh import init_device_mesh
    world = _world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs a world "
                         f"of {math.prod(shape)} ranks; this world has "
                         f"{world}")
    dev_type = resolve_device(device).type
    if dev_type == "cuda" and "LOCAL_RANK" not in os.environ \
            and not torch.cuda.is_initialized():
        # no launcher chose a card: rank r takes card r % count, as
        # init_device_mesh would guess with a warning
        import torch.distributed as dist
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The 16 x 16 (or 2 x 16 x 16) mesh over a world of exactly that
    many ranks; raises naming the size in any other world."""
    shape, names = PRODUCTION[multi_pod]
    return _mesh(shape, names, device)


def make_host_mesh(device=None):
    """(world x 1) over the current world's ranks, axes ("data",
    "model"): data parallelism alone."""
    return _mesh((_world_size(), 1), ("data", "model"), device)


def production_shape(multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's shape without its ranks (the dry run's)."""
    return AbstractMesh(*PRODUCTION[multi_pod])


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch (or point set) is sharded over."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def axis_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def n_chips(mesh) -> int:
    return mesh.size()
