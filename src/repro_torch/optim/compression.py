"""Error-feedback int8 compression for a data-parallel all-reduce (port
of ``repro.optim.compression``).

Each rank quantises its own contribution to int8 with a per-tensor
absmax scale, the ranks all-reduce the dequantised fp32 values, and the
quantisation residual is carried into the next step (error feedback: the
bias is corrected rather than accumulated). The distributed k-means
fit's ``Reducer(compress=True)`` uses the same quantiser on its (K, D)
partial sums, without the residual.
"""
from __future__ import annotations

import torch

from ..checkpoint.checkpoint import tree_flatten, tree_unflatten


def quantize_int8(x: torch.Tensor):
    """``(q int8, scale f32 scalar)`` with ``scale = max|x| / 127 +
    1e-12`` and ``q = clip(round(x / scale), -127, 127)`` (round half
    to even, as ``jnp.round``)."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_psum(tree, residual, group=None):
    """Error-feedback compressed SUM all-reduce over ``group`` (a
    ``torch.distributed`` process group; ``None`` is the default group).
    ``tree`` and ``residual`` are tensors or dicts/lists/tuples of them
    with one structure, flattened in ``jax.tree.flatten``'s order.
    Returns ``(summed tree fp32, new residual tree)``."""
    import torch.distributed as dist
    leaves, treedef, _ = tree_flatten(tree)
    summed, new_res = [], []
    for x, r in zip(leaves, tree_flatten(residual)[0]):
        xf = x.float() + r
        q, scale = quantize_int8(xf)
        deq = dequantize_int8(q, scale)
        new_res.append(xf - deq)
        dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
        summed.append(deq)
    return tree_unflatten(treedef, summed), tree_unflatten(treedef, new_res)


def init_residual(tree):
    """Zero fp32 residuals shaped like ``tree``'s leaves."""
    leaves, treedef, _ = tree_flatten(tree)
    return tree_unflatten(treedef, [
        torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for x in leaves])
