"""Step functions: train, prefill and decode (port of
``repro.train.steps``).

A train step is ``(state, batch) -> (state, metrics)``: the loss and
its gradient by autograd (through the hand-written forward and
backward kernels of attention and the SSD intra-chunk term on the
card), then AdamW. It is functional: the state it is given is left as
it was, so a step can be run twice from one state, and replays after
a restore land on the same bits. ``batch`` is ``TokenPipeline``'s numpy
dict, as ``ResilientLoop`` hands it over; the step moves it to the
state's device. Prefill and decode run under ``torch.no_grad``:
serving keeps no autograd state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import ArchConfig
from ..data import to_device
from ..device import resolve_device
from ..models import decode_step, init_params, loss_fn, prefill_forward
from ..models.transformer import flatten_with_path, rebuild
from ..optim.adamw import AdamWConfig, adamw_update, init_moments


class TrainState(NamedTuple):
    step: torch.Tensor        # int32 scalar, on the params' device
    params: dict
    m: dict
    v: dict


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     device=None) -> TrainState:
    """Fresh parameters (``models.init_params``) and fp32 zero moments
    on ``device`` (``None``: ``cuda``), at step 0."""
    dev = resolve_device(device)
    params = init_params(cfg, generator, device=dev)
    m, v = init_moments(params)
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev),
                      params, m, v)


def loss_and_grads(params: dict, batch: dict, cfg: ArchConfig):
    """``(loss, grads)`` of :func:`models.loss_fn` at ``params`` on a
    batch of tensors; ``grads`` has the tree and dtypes of ``params``."""
    flat = flatten_with_path(params)
    live = {p: leaf.detach().requires_grad_(True) for p, leaf in flat}
    with torch.enable_grad():
        loss = loss_fn(rebuild(params, live), batch, cfg)
        grads = torch.autograd.grad(loss, [live[p] for p, _ in flat])
    return loss.detach(), rebuild(params, {p: g for (p, _), g
                                           in zip(flat, grads)})


def make_train_step(cfg: ArchConfig, opt: AdamWConfig = AdamWConfig()):
    def train_step(state: TrainState, batch: dict):
        b = to_device(batch, state.step.device)
        loss, grads = loss_and_grads(state.params, b, cfg)
        del b
        with torch.no_grad():
            new_p, new_m, new_v, metrics = adamw_update(
                grads, state.m, state.v, state.params, state.step, opt)
        metrics["loss"] = loss
        return TrainState(state.step + 1, new_p, new_m, new_v), metrics

    return train_step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params: dict, batch: dict):
        with torch.no_grad():
            return prefill_forward(params, batch["tokens"], cfg,
                                   vision_embeds=batch.get("vision_embeds"))

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    def serve_step(params: dict, cache: dict, tokens: torch.Tensor, pos):
        with torch.no_grad():
            return decode_step(params, cache, tokens, pos, cfg)

    return serve_step
