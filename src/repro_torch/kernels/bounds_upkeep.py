"""The per-point bound upkeep of a move and the own-distance refresh: the
CUDA kernels, their plain versions and their counters.

Replaces no TPU kernel. In the JAX package this is the array code of
``repro.core.engine.move_and_bounds`` after the drift, which XLA fuses;
in the port it is the tail of :func:`repro_torch.core.engine.
move_and_bounds`. ``csrc/bounds_upkeep.cu`` does it in one pass over the
points; see the note there for the design, the fixed order of the
refresh's dot and the bound.

:func:`own_dists` is the refresh alone, over every row it is given, in
the kernel's order on the card: the compact pass's in-pass refresh runs
it, so the refresh gives the same bits in the move and in the pass.

A CUDA tensor always launches the kernel: every input float32 (labels
int32), contiguous and on one device, and ``x2`` given where the
refresh runs; inputs that do not fit raise ``ValueError``. A CPU tensor
always takes the plain version and counts nothing.
"""
from __future__ import annotations

import ctypes

import torch

from ..obs.trace import phase
from . import _build

NAME = "bounds_upkeep"
THREADS = 256                    # csrc/bounds_upkeep.cu's kThreads
WARPS = THREADS // 32
SM_SMEM = 233_472                # bytes of shared memory an SM gives blocks
SMEM_LIMIT = 232_448             # bytes of shared memory a block can use
BLOCK_RESERVED = 1_024           # bytes the card keeps back for each block
BLOCKS_PER_SM = 8                # blocks the plan leaves room for on an SM


def head_floats(g: int) -> int:
    """Floats of a block's shared memory before its run of lower bounds
    (the .cu's ``head_floats``): the group drift padded to 16 bytes, and
    a count a warp."""
    return -(-g // 4) * 4 + WARPS


def plan(g: int) -> tuple[int, int]:
    """``(rows, smem)``: the points a block takes at G groups, and its
    bytes of shared memory. As many rows as one thread each
    (``THREADS``) and a multiple of 4 (so every block's run of the N x G
    table starts on 16 bytes) while ``BLOCKS_PER_SM`` blocks fit an SM;
    past that, as many as fit one block. Raises ``ValueError`` where
    not even one row fits."""
    per_block = SM_SMEM // BLOCKS_PER_SM - BLOCK_RESERVED
    head = 4 * head_floats(g)
    rows = min(THREADS, (per_block - head) // (4 * g))
    if rows < 4:
        rows = min(THREADS, (SMEM_LIMIT - head) // (4 * g))
    else:
        rows -= rows % 4
    if rows < 1:
        raise ValueError(f"bounds_upkeep: G={g} needs more shared memory "
                         f"than a block has")
    return rows, head + 4 * rows * g


def bounds_upkeep_plain(points, x2, new_c, new_c2, assignments, ub, lb,
                        drift, group_drift, *, refresh: bool = True):
    """Plain PyTorch version: ``(ub_t (N,), lb_dec (N, G), need (N,)
    bool, tightened int64)``. Without ``x2`` the refresh takes the
    direct form ``||x - c_a||``."""
    a = assignments.long()
    ub = ub + drift[a]
    lb_dec = torch.clamp_min(lb - group_drift[None, :], 0.0)
    glb = torch.min(lb_dec, dim=1).values
    maybe = ub > glb
    if not refresh:
        return ub, lb_dec, maybe, maybe.sum()
    if x2 is None:
        from ..core.distances import rowwise_dists
        d_own = rowwise_dists(points, new_c[a])
    else:
        d_own = own_dists_plain(points, x2, new_c, new_c2, assignments)
    ub_t = torch.where(maybe, d_own, ub)
    return ub_t, lb_dec, ub_t > glb, maybe.sum()


def own_dists_plain(points, x2, c, c2, labels):
    """Plain PyTorch version of :func:`own_dists`: the expanded form
    ``sqrt(max(x2 - 2 x.c_a + c2_a, 0))`` of each row to its label's
    centroid."""
    a = labels.long()
    return torch.sqrt(torch.clamp_min(
        x2 - 2.0 * torch.sum(points * c[a], dim=-1) + c2[a], 0.0))


def _check_tensors(name, floats, labels):
    """float32 ``floats`` and int32 ``labels``, contiguous, all on the
    device of the first; else ``ValueError``."""
    dev = floats[0].device
    tensors = floats + [labels]
    if any(t.dtype != torch.float32 for t in floats) or \
            labels.dtype != torch.int32:
        raise ValueError(f"{name}: float32 inputs and int32 labels "
                         f"expected")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all inputs must share a device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def own_dists(points, x2, c, c2, labels):
    """(N,) distances of the rows of ``points`` (N, D) to ``c[labels]``
    in the expanded form, given ``x2`` (N,), ``c2`` (K,) and int32
    ``labels`` in [0, K): on the card the kernel's refresh over every
    row (its order, its bits), counted in ``own_dists.launches``; a CPU
    tensor takes :func:`own_dists_plain`. Raises ``ValueError`` on the
    card where the inputs do not fit the kernel."""
    if not points.is_cuda:
        return own_dists_plain(points, x2, c, c2, labels)
    if points.dim() != 2 or c.dim() != 2 or c.shape[1] != points.shape[1]:
        raise ValueError(f"own_dists: points (N, D) and c (K, D) expected, "
                         f"got {tuple(points.shape)} and {tuple(c.shape)}")
    n, d = points.shape
    if x2.shape != (n,) or labels.shape != (n,) or \
            c2.shape != (c.shape[0],):
        raise ValueError("own_dists: x2 and labels must be (N,), c2 (K,)")
    _check_tensors("own_dists", [points, x2, c, c2], labels)
    out = torch.empty((n,), dtype=torch.float32, device=points.device)
    fn = _build.entry(NAME, "bounds_upkeep_own_launch",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 +
                      [ctypes.c_void_p])
    with _build.on_device(points.device):
        rc = fn(points.data_ptr(), x2.data_ptr(), c.data_ptr(),
                c2.data_ptr(), labels.data_ptr(), out.data_ptr(), n, d,
                c.shape[0], _build.stream_ptr(points.device))
    _build.check(NAME, rc)
    _build.count_launch(own_dists)
    return out


def _check(points, x2, new_c, new_c2, assignments, ub, lb, drift,
           group_drift, refresh):
    """Raise ``ValueError`` where the kernel cannot take these inputs."""
    if lb.dim() != 2 or lb.shape[1] < 1:
        raise ValueError(f"bounds_upkeep: lb must be (N, G) with G >= 1, "
                         f"got {tuple(lb.shape)}")
    n, g = lb.shape
    k = drift.shape[0]
    if ub.shape != (n,) or assignments.shape != (n,) or \
            group_drift.shape != (g,) or drift.shape != (k,):
        raise ValueError("bounds_upkeep: ub and assignments must be (N,), "
                         "drift (K,), group_drift (G,)")
    floats = [lb, ub, drift, group_drift]
    if refresh:
        if x2 is None:
            raise ValueError("bounds_upkeep: the refresh on the card needs "
                             "x2")
        if points.dim() != 2 or points.shape[0] != n or \
                new_c.shape != (k, points.shape[1]) or \
                x2.shape != (n,) or new_c2.shape != (k,):
            raise ValueError("bounds_upkeep: points (N, D), x2 (N,), "
                             "new_c (K, D) and new_c2 (K,) expected")
        floats += [points, x2, new_c, new_c2]
    _check_tensors("bounds_upkeep", floats, assignments)


def bounds_upkeep(points, x2, new_c, new_c2, assignments, ub, lb, drift,
                  group_drift, *, refresh: bool = True):
    """The bounds after a move, and the own-distance refresh.

    points (N, D), x2 (N,) or None, new_c (K, D), new_c2 (K,), int32
    assignments (N,), ub (N,), lb (N, G), drift (K,), group_drift (G,).
    Returns ``(ub_t, lb_dec, need, tightened)`` as
    :func:`bounds_upkeep_plain` does; ``refresh=False`` returns the
    drift-inflated ``ub`` and the *maybe* mask as ``need``.

    On the card the kernel runs, and inputs it cannot take raise
    ``ValueError``; a CPU tensor takes the plain version. Entry to
    return is one ``kpynq/bounds_upkeep`` span."""
    args = (points, x2, new_c, new_c2, assignments, ub, lb, drift,
            group_drift)
    on_card = lb.is_cuda
    with phase("kpynq/bounds_upkeep", on_card):
        if not on_card:
            return bounds_upkeep_plain(*args, refresh=refresh)
        _check(*args, refresh)
        return _launch(*args, refresh)


def _launch(points, x2, new_c, new_c2, assignments, ub, lb, drift,
            group_drift, refresh):
    """Launch ``csrc/bounds_upkeep.cu``'s kernel on the card."""
    n, g = lb.shape
    k = drift.shape[0]
    d = points.shape[1] if refresh else 0
    rows, smem = plan(g)
    dev = lb.device
    ub_t = torch.empty((n,), dtype=torch.float32, device=dev)
    lb_dec = torch.empty((n, g), dtype=torch.float32, device=dev)
    need = torch.empty((n,), dtype=torch.bool, device=dev)
    tightened = torch.empty((), dtype=torch.int64, device=dev)

    def ptr(t):
        return t.data_ptr() if refresh else None

    fn = _build.entry(NAME, "bounds_upkeep_launch",
                      [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 +
                      [ctypes.c_void_p])
    with _build.on_device(dev):
        rc = fn(ptr(points), ptr(x2), ptr(new_c), ptr(new_c2),
                assignments.data_ptr(), ub.data_ptr(), lb.data_ptr(),
                drift.data_ptr(), group_drift.data_ptr(), ub_t.data_ptr(),
                lb_dec.data_ptr(), need.data_ptr(), tightened.data_ptr(),
                n, d, k, g, rows, smem, int(refresh),
                _build.stream_ptr(dev))
    _build.check(NAME, rc)
    _build.count_launch(bounds_upkeep)
    return ub_t, lb_dec, need, tightened


bounds_upkeep.launches = 0
own_dists.launches = 0
