"""Sharded tensors of a train state: DTensors built from each rank's own
slice, gathered back whole, and the collectives they need.

A leaf of a sharded state is a ``torch.distributed.tensor.DTensor``
whose placements come from the partition rules
(``launch.sharding.named``). The port moves its values with its own
collectives instead of DTensor's: under ``gloo`` DTensor's
``full_tensor()`` of a CUDA shard crashed the rank (torch 2.11), and
its reductions sum in an order the port does not choose. Here

* a shard is cut from the full tensor by :func:`local_slices`,
  ``torch.chunk``'s rule applied mesh dimension by mesh dimension (the
  rule DTensor itself uses for uneven sizes): mesh dimension 0 cuts
  first, so where two mesh axes shard one tensor dimension the first is
  the major one, as in a JAX ``PartitionSpec``;
* the collectives that move a tensor's slices are point-to-point
  (:func:`exchange`): raw bytes (any dtype; bit for bit), through the
  host under ``gloo``, which is how several ranks share one card (NCCL
  refuses two ranks on one GPU). At 64 MiB from every rank to every
  other through the host, ``gloo``'s point-to-point moved 1.9x the
  bytes a second of its ``all_gather`` between two ranks and 1.6x over
  four on an H100 machine (``chip_smoke.py`` phase 25);
* :func:`gather_full` gathers the shards, innermost mesh dimension
  first; :func:`gather_to_root` sends each distinct shard to one rank
  (a checkpoint's writer) once; :func:`reduce_to_shard` sends each peer
  only its own slice of a gradient (or of a loss) and adds what it gets
  in coordinate order, and :func:`shard_sums` adds small values
  (``core.distributed._gather``) in a fixed order, so every run adds in
  the same order.
"""
from __future__ import annotations

import itertools
import math

import torch


def _dtensor_types():
    # imported at first use: ``torch.distributed.tensor`` takes about a
    # second to import, and most of the port never needs it
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    return DTensor, Partial, Replicate, Shard


def is_dtensor(x) -> bool:
    return isinstance(x, _dtensor_types()[0])


def local_tensor(x):
    """A DTensor's local shard; anything else as it is."""
    return x.to_local() if is_dtensor(x) else x


def chunk_bounds(size: int, parts: int, index: int) -> tuple[int, int]:
    """``[start, stop)`` of chunk ``index`` of ``size`` cut into
    ``parts`` by ``torch.chunk``'s rule (chunks of ``ceil(size /
    parts)``; trailing chunks may be short or empty)."""
    chunk = -(-size // parts)
    start = min(index * chunk, size)
    return start, min(start + chunk, size)


def local_slices(shape, mesh_shape, coord, placements) -> tuple:
    """The slices of a tensor of ``shape`` that the rank at mesh
    coordinate ``coord`` holds under ``placements`` (one a mesh
    dimension)."""
    _, Partial, _, Shard = _dtensor_types()
    lo, hi = [0] * len(shape), list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Partial):
            raise ValueError("a Partial placement has no slice")
        if isinstance(p, Shard):
            a, b = chunk_bounds(hi[p.dim] - lo[p.dim], mesh_shape[i],
                                coord[i])
            lo[p.dim], hi[p.dim] = lo[p.dim] + a, lo[p.dim] + b
    return tuple(slice(a, b) for a, b in zip(lo, hi))


def local_shape(shape, mesh_shape, coord, placements) -> tuple:
    return tuple(s.stop - s.start
                 for s in local_slices(shape, mesh_shape, coord, placements))


def _coordinate(mesh):
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return coord


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def from_local(local: torch.Tensor, mesh, placements, shape):
    """A DTensor of global ``shape`` over this rank's ``local`` shard
    (no communication)."""
    DTensor = _dtensor_types()[0]
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def shard_of(full, mesh, placements, device=None):
    """This rank's slice of ``full`` (a tensor or a numpy array, the
    same on every rank) as a DTensor, its local shard on ``device``
    (``None``: ``full``'s device): a copy that does not keep ``full``
    alive, or ``full`` itself where the rank holds all of it on its
    device."""
    full = torch.as_tensor(full)
    sl = local_slices(full.shape, mesh.shape, _coordinate(mesh), placements)
    part = full[sl]
    dev = full.device if device is None else torch.device(device)
    if part.device != dev:
        local = part.to(dev, copy=True).contiguous()
    elif part.numel() == full.numel():
        local = full.contiguous()
    else:
        local = part.clone(memory_format=torch.contiguous_format)
    return from_local(local, mesh, placements, full.shape)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def exchange(sends: dict, recvs: dict, device) -> dict:
    """Point-to-point on the default group, as raw bytes (exact for
    every dtype): ``sends`` {global rank: tensor}, ``recvs`` {global
    rank: (shape, dtype)}; returns {global rank: tensor on ``device``}.
    Under ``gloo`` the bytes go through the host; empty tensors are not
    sent. Every pair's sends and receives are posted together
    (``torch.distributed.batch_isend_irecv``) and waited for."""
    import torch.distributed as dist
    nccl = dist.get_backend() == "nccl"
    stage = torch.device("cuda", torch.cuda.current_device()) if nccl \
        else torch.device("cpu")
    ops, bufs = [], {}
    for r, t in sends.items():
        if t.numel():
            ops.append(dist.P2POp(dist.isend, _bytes(t).to(stage), r))
    for r, (shape, dtype) in recvs.items():
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        buf = torch.empty(n, dtype=torch.uint8, device=stage)
        bufs[r] = (buf, shape, dtype)
        if n:
            ops.append(dist.P2POp(dist.irecv, buf, r))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return {r: b.to(device).view(dtype).reshape(shape)
            for r, (b, shape, dtype) in bufs.items()}


def gather_full(x):
    """The full tensor of DTensor ``x`` on every rank of its mesh, on
    the local shard's device (a collective: every rank of the mesh
    calls it); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    _, Partial, _, Shard = _dtensor_types()
    mesh, placements = x.device_mesh, tuple(x.placements)
    coord = _coordinate(mesh)
    out = x.to_local()
    for i in reversed(range(mesh.ndim)):
        p = placements[i]
        if isinstance(p, Partial):
            raise ValueError("gather_full takes Shard and Replicate "
                             "placements")
        if not isinstance(p, Shard):
            continue
        # the extent mesh dimensions 0..i-1 left this rank's block
        sl = local_slices(x.shape, mesh.shape, coord, placements[:i])[p.dim]
        extent, n = sl.stop - sl.start, mesh.shape[i]
        peers = _peers(mesh, coord, (i,))
        shapes = {}
        for c, r in peers:
            a, b = chunk_bounds(extent, n, c[i])
            shape = list(out.shape)
            shape[p.dim] = b - a
            shapes[r] = (tuple(shape), out.dtype)
        me = int(mesh.mesh[tuple(coord)])
        got = exchange({r: out for _, r in peers if r != me},
                       {r: v for r, v in shapes.items() if r != me},
                       out.device)
        out = torch.cat([out if r == me else got[r] for _, r in peers],
                        dim=p.dim)
    return out


def _peers(mesh, coord, dims) -> list:
    """``[(coordinate, global rank)]`` of the ranks whose coordinates
    differ from ``coord`` on mesh dimensions ``dims`` alone (``coord``
    among them), in the lexicographic order of those dimensions."""
    out = []
    for combo in itertools.product(*(range(mesh.shape[i]) for i in dims)):
        c = list(coord)
        for i, v in zip(dims, combo):
            c[i] = v
        out.append((tuple(c), int(mesh.mesh[tuple(c)])))
    return out


def gather_to_root(x, root: int = 0):
    """DTensor ``x`` whole on the host of global rank ``root``, ``None``
    on the other ranks (a collective: every rank of the mesh calls it).
    Each distinct shard is sent once (a replicated shard by the rank at
    coordinate 0 of the replicating mesh dimensions)."""
    import torch.distributed as dist
    _, _, _, Shard = _dtensor_types()
    mesh, pl = x.device_mesh, tuple(x.placements)
    coord = _coordinate(mesh)
    holders = [(c, r) for c, r in _peers(mesh, coord, range(mesh.ndim))
               if all(c[i] == 0 for i, p in enumerate(pl)
                      if not isinstance(p, Shard))]
    me, local = dist.get_rank(), x.to_local()
    if me != root:
        if any(r == me for _, r in holders):
            exchange({root: local}, {}, local.device)
        return None
    got = exchange({}, {r: (local_shape(x.shape, mesh.shape, c, pl), x.dtype)
                        for c, r in holders if r != root}, "cpu")
    full = torch.empty(x.shape, dtype=x.dtype)
    for c, r in holders:
        full[local_slices(x.shape, mesh.shape, c, pl)] = \
            local.cpu() if r == root else got[r]
    return full


def reduce_to_shard(g: torch.Tensor, mesh, mesh_dims, placements):
    """This rank's slice, under ``placements``, of the mean of ``g``
    over the ranks along ``mesh_dims`` (a collective): each rank sends
    each peer only the peer's slice, and adds the slices it gets in the
    peers' coordinate order, in fp32, dividing once by their count: the
    same bits on every rank and in every run. Along no ranks (or one)
    it is ``g``'s slice in ``g``'s dtype: ``g`` itself where the slice
    is whole, else a copy that does not keep ``g`` alive."""
    import torch.distributed as dist
    coord = _coordinate(mesh)
    mine = g[local_slices(g.shape, mesh.shape, coord, placements)]
    peers = _peers(mesh, coord, tuple(mesh_dims))
    if len(peers) == 1:
        return g if mine.numel() == g.numel() else mine.clone()
    me = dist.get_rank()
    got = exchange(
        {r: g[local_slices(g.shape, mesh.shape, c, placements)]
         for c, r in peers if r != me},
        {r: (tuple(mine.shape), g.dtype) for _, r in peers if r != me},
        g.device)
    acc = None
    for _, r in peers:
        part = (mine if r == me else got[r]).float()
        acc = part if acc is None else acc + part
    return acc / len(peers)


def shard_sums(values: torch.Tensor, mesh, placements_list) -> list:
    """Each leaf's total over its distinct shards: ``values`` (L,) holds
    this rank's per-leaf partials (a collective: every rank of the mesh
    calls it); leaf ``l``'s total adds, in coordinate order, the
    partials of the ranks at coordinate 0 of the mesh dimensions where
    ``placements_list[l]`` replicates. The same bits on every rank; on a
    mesh of one rank each total is that rank's partial."""
    from .core import distributed
    _, _, _, Shard = _dtensor_types()
    out = values
    for i in reversed(range(mesh.ndim)):
        out = distributed._gather(out[None], mesh.get_group(i),
                                  mesh.shape[i])
    totals = []
    for leaf, pl in enumerate(placements_list):
        idx = tuple(slice(None) if isinstance(p, Shard) else 0 for p in pl)
        sel = out[idx + (leaf,)].reshape(-1)
        tot = sel[0]
        for v in sel[1:]:
            tot = tot + v
        totals.append(tot)
    return totals


def placements_of(mesh, spec) -> tuple:
    """The DTensor placements of a partition spec (one entry a tensor
    dimension: ``None``, an axis name, or a tuple of names, major
    first) on ``mesh``: ``Shard(d)`` on each mesh dimension that tensor
    dimension ``d`` names, ``Replicate()`` on the others. Raises where
    DTensor cannot express the spec: an axis the mesh lacks, one axis
    on two tensor dimensions, or a tuple not in the mesh's order."""
    _, _, Replicate, Shard = _dtensor_types()
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, which mesh "
                                 f"{names} lacks")
            i = names.index(a)
            if isinstance(out[i], Shard):
                raise ValueError(f"spec {spec} shards two dimensions over "
                                 f"axis {a!r}")
            out[i] = Shard(d)
            idx.append(i)
        if idx != sorted(idx):
            # DTensor cuts mesh dimensions in mesh order, so a tensor
            # dimension's axes must come major first in that order
            raise ValueError(f"spec {spec} lists axes {axes} against the "
                             f"mesh's order {names}")
    return tuple(out)


def local_nbytes(shape, dtype, mesh_shape, coord, placements) -> int:
    """Bytes of one rank's shard (the dry run's per-rank memory)."""
    return math.prod(local_shape(shape, mesh_shape, coord, placements)) * \
        torch.empty((), dtype=dtype).element_size()


def replicated(mesh) -> tuple:
    """The placements of a tensor every rank of ``mesh`` holds whole."""
    return (_dtensor_types()[2](),) * mesh.ndim
