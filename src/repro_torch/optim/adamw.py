"""AdamW with fp32 moments over (possibly bf16) params (port of
``repro.optim.adamw``), on nested dicts of tensors.

No master fp32 copy: params stay in their storage dtype, and the update
is computed in fp32 and cast back, as in the reference. The arithmetic
and its order are the reference's: clip by the global norm, the cosine
schedule with linear warm-up, bias correction, and decay only on
leaves of two or more dimensions. ``torch.optim.AdamW`` computes
something else (decoupled decay applied before the step, no clip), so
it is not used. Plain torch, as the reference is plain ``jnp``.
Functional: a step returns new tensors and leaves its inputs as they
were, so a state can be stepped twice, or kept for a replay.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..checkpoint.checkpoint import tree_flatten


class AdamWConfig(NamedTuple):
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    lr_min: float = 3e-5
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_lr(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """The fp32 learning rate at ``step`` (an int32 tensor): linear
    warm-up to ``lr_peak``, then a cosine down to ``lr_min``."""
    warm = cfg.lr_peak * (step + 1) / cfg.warmup_steps
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * \
        (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def init_moments(params):
    """fp32 zeros shaped as each leaf: ``(m, v)``."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return _map(zeros, params), _map(zeros, params)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, over the leaves in the reference's order (dicts
    by sorted key), of each leaf's sum of squares in fp32."""
    leaves = tree_flatten(tree)[0]
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def adamw_update(grads, m, v, params, step, cfg: AdamWConfig, gnorm=None):
    """Returns ``(new_params, new_m, new_v, {"grad_norm", "lr"})``;
    ``step`` is the int32 step tensor of the update (0 for the first).
    ``gnorm``: the gradient's global norm where ``grads`` holds a shard
    of it (the sharded step's), else :func:`global_norm` of ``grads``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)
    lr = cosine_lr(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** (step.float() + 1)
    bc2 = 1 - b2 ** (step.float() + 1)

    def upd(g, m_, v_, p):
        g = g.float() * scale
        nm = b1 * m_ + (1 - b1) * g
        nv = b2 * v_ + (1 - b2) * g * g
        step_ = (nm / bc1) / (torch.sqrt(nv / bc2) + cfg.eps)
        pf = p.float()
        if p.dim() >= 2:
            step_ = step_ + cfg.weight_decay * pf
        return (pf - lr * step_).to(p.dtype), nm, nv

    out = _map(upd, grads, m, v, params)
    pick = lambda i: _map(lambda o: o[i], out)  # noqa: E731
    return pick(0), pick(1), pick(2), {"grad_norm": gnorm, "lr": lr}
