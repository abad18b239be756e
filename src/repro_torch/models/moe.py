"""Token-choice top-k MoE with a sort-based dispatch (port of
``repro.models.moe``).

``moe_ffn`` routes each token to its top ``k`` experts, packs the
(token, k) pairs into an (E, capacity, D) buffer sorted by expert, runs
the batched expert SwiGLU over the buffer and adds each token's kept
contributions back. Its parts are small functions (``route``,
``capacity``, ``plan``, the dispatch and combine Functions) so that a
caller can reach the routing: ``moe_ffn`` looks ``route`` up in this
module at every call, so replacing ``moe.route`` swaps it for every
layer.

The reference's semantics, kept exactly:

- logits ``(x @ router).float()`` in the compute dtype; the top ``k``
  with ties to the lower expert id, as ``jax.lax.top_k`` breaks them (a
  stable descending sort: ``torch.topk`` breaks ties otherwise); the
  softmax of the ``k`` gates in fp32;
- the pairs flattened token-major, stably sorted by expert; each expert
  keeps its first ``capacity`` pairs and drops the rest. The
  reference's buffer write sends a dropped pair's zero row to slot 0
  of its expert, where it overwrites the expert's first kept token
  (ROADMAP.md Queue 3 item 12); the port only drops;
- each token's kept ``y * gate`` added from zero in the compute dtype,
  in ascending expert id, the order of the reference's scatter-add over
  its sorted pairs.

Every buffer slot belongs to at most one pair, so the dispatch and the
combine are gathers both ways: forward and backward, no scatter-add,
``index_add_`` or atomic accumulation, and two passes give the same
bits on the card. A token's gradient sums its ``k`` slots' in the
combine's order.
"""
from __future__ import annotations

import torch

from .layers import swiglu


def route(xf, router, cfg):
    """xf (T, D) in the compute dtype -> (gates (T, k) fp32, experts
    (T, k) int64), both in descending order of the logits."""
    logits = (xf @ router.to(xf.dtype)).float()
    top, experts = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = cfg.moe_top_k
    return torch.softmax(top[:, :k], dim=-1), experts[:, :k]


def capacity(cfg, t: int) -> int:
    """Pairs each expert keeps for ``t`` tokens (the reference's float
    arithmetic, in its order)."""
    return int(cfg.moe_capacity_factor * t * cfg.moe_top_k / cfg.n_experts) + 1


@torch.no_grad()
def plan(experts, n_experts: int, cap: int):
    """experts (T, k) -> (``slot`` (T, k): each pair's buffer row,
    ``expert * cap + position``, or -1 where dropped; ``pair`` (E * cap,):
    the flat pair ``t * k + j`` in each row, or -1 where empty; ``order``
    (T, k): each token's ``j`` in ascending expert id)."""
    t, k = experts.shape
    flat = experts.reshape(-1)
    idx = torch.arange(t * k, device=flat.device)
    by_expert = torch.sort(flat, stable=True).indices
    se = flat[by_expert]
    starts = torch.searchsorted(
        se, torch.arange(n_experts, device=flat.device, dtype=se.dtype))
    pos = idx - starts[se]
    keep = pos < cap
    sorted_slot = torch.where(keep, se * cap + pos, -1)
    slot = torch.empty_like(flat)
    slot[by_expert] = sorted_slot             # a permutation: one write each
    # dropped pairs write a spare row, cut off (no host sync for a mask)
    pair = torch.full((n_experts * cap + 1,), -1, dtype=flat.dtype,
                      device=flat.device)
    pair[torch.where(keep, sorted_slot, n_experts * cap)] = by_expert
    pair = pair[:-1]
    order = torch.sort(experts, dim=1).indices
    return slot.view(t, k), pair, order


def _gather(src, idx):
    """src (N, D), idx (...) with -1 for none -> (..., D), zero rows at
    -1."""
    rows = src.index_select(0, idx.clamp(min=0).reshape(-1))
    rows = rows.view(*idx.shape, src.shape[-1])
    return rows.masked_fill((idx < 0).unsqueeze(-1), 0)


def _sum_in_order(rows, order):
    """rows (T, k, D) -> (T, D): each token's k rows added from zero in
    ``order``, rounded to the rows' dtype after every add."""
    t, k, d = rows.shape
    rows = torch.gather(rows, 1, order.unsqueeze(-1).expand(t, k, d))
    out = torch.zeros((t, d), dtype=rows.dtype, device=rows.device)
    for j in range(k):
        out = out + rows[:, j]
    return out


class _Dispatch(torch.autograd.Function):
    """buf[s] = x[token of slot s], zero for an empty slot; a token's
    gradient is the sum of its kept slots', in ``order``."""

    @staticmethod
    def forward(ctx, xf, slot, pair, order):
        ctx.save_for_backward(slot, order)
        k = slot.shape[1]
        return _gather(xf, torch.where(pair >= 0, pair // k, -1))

    @staticmethod
    def backward(ctx, grad):
        slot, order = ctx.saved_tensors
        return _sum_in_order(_gather(grad, slot), order), None, None, None


class _Combine(torch.autograd.Function):
    """out[t] = the sum over token t's kept pairs of ``y[slot] *
    gate`` (the gate cast to y's dtype), from zero in ``order``."""

    @staticmethod
    def forward(ctx, y, gates, slot, pair, order):
        ctx.save_for_backward(y, gates, slot, pair)
        rows = _gather(y, slot) * gates.to(y.dtype).unsqueeze(-1)
        return _sum_in_order(rows, order)

    @staticmethod
    def backward(ctx, grad):
        y, gates, slot, pair = ctx.saved_tensors
        k = slot.shape[1]
        # each slot feeds one pair: its gradient is that token's, scaled
        live = pair >= 0
        g_slot = gates.reshape(-1)[pair.clamp(min=0)].to(y.dtype)
        grad_y = _gather(grad, torch.where(live, pair // k, -1)) * \
            g_slot.unsqueeze(-1)
        grad_gates = (grad.unsqueeze(1) * _gather(y, slot)).sum(-1)
        return grad_y, grad_gates.to(gates.dtype), None, None, None


def moe_ffn(x, p, cfg):
    """x: (B, S, D) -> (B, S, D). p: {'router': (D, E), 'w_gate'/'w_up':
    (E, D, F), 'w_down': (E, F, D)}."""
    b, s, d = x.shape
    e, t = cfg.n_experts, b * s
    xf = x.reshape(t, d)
    gates, experts = route(xf, p["router"], cfg)
    cap = capacity(cfg, t)
    slot, pair, order = plan(experts, e, cap)
    buf = _Dispatch.apply(xf, slot, pair, order).view(e, cap, d)
    # each expert's SwiGLU on its rows: batched products, silu(g) * u in
    # the compute dtype
    y = swiglu(buf, p["w_gate"], p["w_up"], p["w_down"]).reshape(e * cap, d)
    return _Combine.apply(y, gates, slot, pair, order).view(b, s, d)
