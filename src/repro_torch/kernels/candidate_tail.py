"""The candidate pass's group filter and tail: the CUDA kernels, their
plain versions and their counters.

Replaces no TPU kernel. In the JAX package this is the array code of
``repro.core.engine.pallas_candidate_pass`` and ``_finish_pass`` around
the ``grouped_assign`` kernel, which XLA fuses; in the port it is the
work of :func:`repro_torch.core.engine.kernel_candidate_pass` around
``kernels.grouped_assign``. ``csrc/candidate_tail.cu`` holds two
kernels, and the note on their design and their bound:

- :func:`candidate_mask`, before ``grouped_assign``: the filter decisions
  ``need & (lb < ub_t)`` straight into the (ceil(N / tile_n), G) block
  mask, with no (N, G) table of them;
- :func:`candidate_tail`, after it: the reassignment, the tightened
  upper bound and the lower bounds (the computed groups refreshed, the
  old group capped), one pass over the rows.

Neither adds a float, so both give their plain versions' bits.

A CUDA tensor always launches the kernel: bool ``need``, float32 bounds
and distances, int32 labels, ids and groups, contiguous and on one
device; inputs that do not fit raise ``ValueError``. A CPU tensor always
takes the plain version and counts nothing. Entry to return of each is a
``kpynq/candidate_tail`` span.
"""
from __future__ import annotations

import ctypes

import torch

from ..obs.trace import phase
from . import _build
from .ops import build_group_block_mask

NAME = "candidate_tail"
SMEM_LIMIT = 232_448             # bytes of shared memory a block can use


def mask_smem(tile_n: int, g: int) -> int:
    """Bytes of shared memory a block of the mask kernel takes (the .cu's
    ``mask_smem``): a float a row of the tile, a byte a group."""
    return 4 * tile_n + g


def candidate_mask_plain(need, lb, ub_t, *, tile_n: int = 256):
    """Plain PyTorch version of :func:`candidate_mask`: the (N, G) filter
    decisions, then ``build_group_block_mask``."""
    group_need = need[:, None] & (lb < ub_t[:, None])
    return build_group_block_mask(group_need, tile_n=tile_n)


def candidate_tail_plain(best2, idx, gmin, garg, gmin2, assignments, ub_t,
                         lb, need, groups):
    """Plain PyTorch version of :func:`candidate_tail`: the candidate
    pass's arithmetic after ``grouped_assign``, ending in the engine's
    ``_finish_pass``, the tail the oracle and compact passes share."""
    from ..core.engine import _finish_pass
    group_need = need[:, None] & (lb < ub_t[:, None])
    best_d = torch.sqrt(best2)
    new_a = torch.where(best_d < ub_t, idx, assignments)
    # the group argmin collides with the new assignment iff it came from
    # that group; then the second min is the min excluding it
    lb_comp = torch.sqrt(torch.where(garg == new_a[:, None], gmin2, gmin))
    return _finish_pass(best_d, idx, lb_comp, assignments, ub_t, lb, groups,
                        group_need)


_MASK_DTYPES = (torch.bool, torch.float32, torch.float32)
_TAIL_DTYPES = (torch.float32, torch.int32, torch.float32, torch.int32,
                torch.float32, torch.int32, torch.float32, torch.float32,
                torch.bool, torch.int32)


def _check_tensors(name, tensors, dtypes):
    """Each tensor of its dtype in ``dtypes``, contiguous, all on one
    device; else ``ValueError``. Once a pass on the loop's path, so it
    reads each tensor as few times as it can."""
    if tuple(t.dtype for t in tensors) != dtypes:
        raise ValueError(f"{name}: dtypes {dtypes} expected, got "
                         f"{tuple(t.dtype for t in tensors)}")
    dev = tensors[0].device
    if any(t.device != dev or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous, on one "
                         f"device")


def _check_rows(name, need, lb, ub_t):
    if lb.dim() != 2 or lb.shape[1] < 1:
        raise ValueError(f"{name}: lb must be (N, G) with G >= 1, got "
                         f"{tuple(lb.shape)}")
    n = lb.shape[0]
    if need.shape != (n,) or ub_t.shape != (n,):
        raise ValueError(f"{name}: need and ub_t must be (N,)")


def candidate_mask(need, lb, ub_t, *, tile_n: int = 256):
    """(ceil(N / tile_n), G) bool block mask for ``grouped_assign``: block
    (t, g) is live iff a row i of point tile t has ``need[i]`` and
    ``lb[i, g] < ub_t[i]``. need (N,) bool, lb (N, G), ub_t (N,).

    On the card the kernel runs (counted in ``candidate_mask.launches``),
    and inputs it cannot take raise ``ValueError``; a CPU tensor takes
    :func:`candidate_mask_plain`."""
    on_card = lb.is_cuda
    with phase("kpynq/candidate_tail", on_card):
        if not on_card:
            return candidate_mask_plain(need, lb, ub_t, tile_n=tile_n)
        _check_rows("candidate_mask", need, lb, ub_t)
        _check_tensors("candidate_mask", (need, lb, ub_t), _MASK_DTYPES)
        n, g = lb.shape
        if tile_n < 1 or mask_smem(tile_n, g) > SMEM_LIMIT:
            raise ValueError(f"candidate_mask: tile_n={tile_n} at G={g} "
                             f"needs more shared memory than a block has")
        mask = torch.empty((-(-n // tile_n), g), dtype=torch.bool,
                           device=lb.device)
        fn = _build.entry(NAME, "candidate_tail_mask_launch",
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 +
                          [ctypes.c_void_p])
        with _build.on_device(lb.device):
            rc = fn(need.data_ptr(), lb.data_ptr(), ub_t.data_ptr(),
                    mask.data_ptr(), n, g, tile_n,
                    _build.stream_ptr(lb.device))
        _build.check(NAME, rc)
        _build.count_launch(candidate_mask)
        return mask


def candidate_tail(best2, idx, gmin, garg, gmin2, assignments, ub_t, lb,
                   need, groups):
    """The candidate pass after ``grouped_assign``.

    ``grouped_assign``'s outputs best2 (N,), int32 idx (N,), gmin, int32
    garg and gmin2 (N, G); the pass's int32 assignments (N,), ub_t (N,),
    lb (N, G), bool need (N,) and int32 groups (K,). Returns
    ``(new_assign (N,) int32, new_ub (N,), new_lb (N, G))``, new tensors,
    as :func:`candidate_tail_plain` does.

    On the card the kernel runs (counted in ``candidate_tail.launches``),
    and inputs it cannot take raise ``ValueError``; a CPU tensor takes
    the plain version."""
    args = (best2, idx, gmin, garg, gmin2, assignments, ub_t, lb, need,
            groups)
    on_card = lb.is_cuda
    with phase("kpynq/candidate_tail", on_card):
        if not on_card:
            return candidate_tail_plain(*args)
        _check_rows("candidate_tail", need, lb, ub_t)
        n, g = lb.shape
        if best2.shape != (n,) or idx.shape != (n,) or \
                assignments.shape != (n,) or groups.dim() != 1 or \
                any(t.shape != (n, g) for t in (gmin, garg, gmin2)):
            raise ValueError("candidate_tail: best2, idx and assignments "
                             "must be (N,), gmin, garg and gmin2 (N, G), "
                             "groups (K,)")
        _check_tensors("candidate_tail", args, _TAIL_DTYPES)
        dev = lb.device
        new_assign = torch.empty((n,), dtype=torch.int32, device=dev)
        new_ub = torch.empty((n,), dtype=torch.float32, device=dev)
        new_lb = torch.empty((n, g), dtype=torch.float32, device=dev)
        fn = _build.entry(NAME, "candidate_tail_launch",
                          [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 +
                          [ctypes.c_void_p])
        with _build.on_device(dev):
            rc = fn(*(t.data_ptr() for t in args), new_assign.data_ptr(),
                    new_ub.data_ptr(), new_lb.data_ptr(), n,
                    groups.shape[0], g, _build.stream_ptr(dev))
        _build.check(NAME, rc)
        _build.count_launch(candidate_tail)
        return new_assign, new_ub, new_lb


candidate_mask.launches = 0
candidate_tail.launches = 0
