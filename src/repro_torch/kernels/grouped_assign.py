"""Group-granular block-skip nearest-centroid search: the CUDA kernel,
its plain version and a launch counter.

Replaces the Pallas kernel ``repro/kernels/grouped_assign.py``
(``grouped_assign`` -> ``_grouped_assign_kernel``), the engine's
candidate pass on the accelerator. ``csrc/grouped_assign.cu`` holds the
kernel and the note on its design, its tie rules and its bound; its
launch refuses a shape the kernel cannot take (``cudaErrorInvalidValue``,
raised here as ``RuntimeError``), so this module keeps no copy of the
kernel's layout. The first kernel of the port stays in the same source
as a yardstick, reached only through :func:`grouped_assign_simple`.
"""
from __future__ import annotations

import ctypes

import torch

from ..obs.trace import phase
from . import _build

NAME = "grouped_assign"


def grouped_assign_plain(x, c_grouped, ids, block_mask, *,
                         tile_n: int = 256, x2=None, c2g=None):
    """Plain PyTorch version (from ``repro.kernels.ref.grouped_assign_ref``
    with the norms taken as given, as the kernel takes them).

    Returns ``(best (N,), idx (N,) i32, gmin (N, G), garg (N, G) i32,
    gmin2 (N, G))``; skipped blocks read (inf, -1, inf) and fully
    skipped rows (inf, -1)."""
    n, d = x.shape
    g, lmax = ids.shape
    xf = x.float()
    if x2 is None:
        x2 = torch.sum(xf * xf, dim=-1)
    cf = c_grouped.float().reshape(g * lmax, d)
    if c2g is None:
        c2g = torch.sum(cf * cf, dim=-1).reshape(g, lmax)
    live = torch.repeat_interleave(block_mask.bool(), tile_n, dim=0)[:n]
    cross = (xf @ cf.T).reshape(n, g, lmax)
    d2 = torch.clamp_min(x2[:, None, None] - 2.0 * cross + c2g[None], 0.0)
    inf = torch.tensor(float("inf"), device=x.device)
    d2 = torch.where((ids >= 0)[None], d2, inf)
    d2 = torch.where(live[:, :, None], d2, inf)
    gmin, slot = torch.min(d2, dim=2)            # first slot wins ties
    ids_l = ids.long()
    garg = torch.gather(ids_l[None].expand(n, g, lmax), 2,
                        slot[..., None])[..., 0]
    gmin2 = torch.scatter(d2, 2, slot[..., None], float("inf")).amin(dim=2)
    best, bg = torch.min(gmin, dim=1)            # first group wins ties
    idx = torch.gather(garg, 1, bg[:, None])[:, 0]
    idx = torch.where(torch.isfinite(best), idx, -1)
    garg = torch.where(live, garg, -1)
    return (best, idx.int(), gmin, garg.int(), gmin2)


def _check(x, c_grouped, ids, block_mask, tile_n, x2, c2g):
    n, d = x.shape
    g, lmax = ids.shape
    if c_grouped.shape != (g, lmax, d):
        raise ValueError(f"grouped_assign: c_grouped must be "
                         f"{(g, lmax, d)}, got {tuple(c_grouped.shape)}")
    gn = -(-n // tile_n)
    if block_mask.shape != (gn, g) or block_mask.dtype != torch.bool:
        raise ValueError(f"grouped_assign: block_mask must be bool "
                         f"{(gn, g)}, got {block_mask.dtype} "
                         f"{tuple(block_mask.shape)}")
    if x2.shape != (n,) or c2g.shape != (g, lmax):
        raise ValueError("grouped_assign: x2 must be (N,), c2g (G, Lmax)")
    floats = (x, c_grouped, x2, c2g)
    if any(t.dtype != torch.float32 for t in floats) or \
            ids.dtype != torch.int32:
        raise TypeError("grouped_assign: float32 x/c_grouped/x2/c2g and "
                        "int32 ids expected")
    tensors = floats + (ids, block_mask)
    if any(t.device != x.device for t in tensors):
        raise ValueError("grouped_assign: all inputs must share a device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("grouped_assign: inputs must be contiguous")
    if not 32 <= tile_n <= 1024:
        raise ValueError(f"grouped_assign: tile_n must be in [32, 1024], "
                         f"got {tile_n}")


def _launch(simple, x, c_grouped, ids, block_mask, tile_n, x2, c2g):
    """Launch ``csrc/grouped_assign.cu``'s kernel, or with ``simple`` its
    first kernel, on the card; the norms are computed where not given."""
    if x2 is None:
        x2 = torch.sum(x * x, dim=-1)
    if c2g is None:
        c2g = torch.sum(c_grouped * c_grouped, dim=-1)
    _check(x, c_grouped, ids, block_mask, tile_n, x2, c2g)
    n, d = x.shape
    g, lmax = ids.shape
    dev = x.device
    best = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    gmin = torch.empty((n, g), dtype=torch.float32, device=dev)
    garg = torch.empty((n, g), dtype=torch.int32, device=dev)
    gmin2 = torch.empty((n, g), dtype=torch.float32, device=dev)
    if n == 0:
        return best, idx, gmin, garg, gmin2
    ptrs = [t.data_ptr() for t in (x, x2, c_grouped, c2g, ids, block_mask,
                                   best, idx, gmin, garg, gmin2)]
    if simple:
        fn = _build.entry(NAME, "grouped_assign_simple_launch",
                          [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 +
                          [ctypes.c_void_p])
        extra = []
    else:
        fn = _build.entry(NAME, "grouped_assign_launch",
                          [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 +
                          [ctypes.c_void_p])
        ints = _build.entry(NAME, "grouped_assign_scratch_ints",
                            [ctypes.c_int, ctypes.c_int])(g, lmax)
        scratch = torch.empty((ints,), dtype=torch.int32, device=dev)
        extra = [scratch.data_ptr(), ints]
    with _build.on_device(dev):
        rc = fn(*ptrs, *extra, n, d, g, lmax, tile_n, _build.stream_ptr(dev))
    _build.check(NAME, rc)
    return best, idx, gmin, garg, gmin2


def points(d: int, g: int) -> int:
    """Points a lane of the kernel takes at (D, G): 8, 4, 2 or 1, or 0
    for a shape the launch refuses (the .cu's ``grouped_assign_points``,
    which the launch itself uses)."""
    return _build.entry(NAME, "grouped_assign_points",
                        [ctypes.c_int, ctypes.c_int])(d, g)


def grouped_assign(x, c_grouped, ids, block_mask, *, tile_n: int = 256,
                   x2=None, c2g=None):
    """Group-block-skipping nearest-centroid search with per-group stats.

    x: (N, D) f32; c_grouped: (G, Lmax, D) f32 group-bucketed centroids;
    ids: (G, Lmax) int32 centroid id per slot (-1 = pad); block_mask:
    (ceil(N/tile_n), G) bool, True where the group must be scored for
    that point tile; ``x2`` (N,) / ``c2g`` (G, Lmax): precomputed
    squared norms (``None`` computes them).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    :func:`grouped_assign_plain`. Same returns as the plain version.
    Entry to return is one ``kpynq/grouped_assign`` span."""
    with phase("kpynq/grouped_assign", x.is_cuda):
        if not x.is_cuda:
            return grouped_assign_plain(x, c_grouped, ids, block_mask,
                                        tile_n=tile_n, x2=x2, c2g=c2g)
        out = _launch(False, x, c_grouped, ids, block_mask, tile_n, x2,
                      c2g)
        _build.count_launch(grouped_assign)
        return out


def grouped_assign_simple(x, c_grouped, ids, block_mask, *,
                          tile_n: int = 256, x2=None, c2g=None):
    """The port's first ``grouped_assign`` kernel (one thread per point,
    every slot of a 32-slot chunk computed), kept as the yardstick the
    kernel is held to bit for bit and timed against. CUDA tensors only;
    no path of the port calls it, and it counts no launch."""
    if not x.is_cuda:
        raise ValueError("grouped_assign_simple: CUDA tensors expected")
    return _launch(True, x, c_grouped, ids, block_mask, tile_n, x2, c2g)


grouped_assign.launches = 0
