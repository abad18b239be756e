"""Step functions: prefill and decode (port of the serving half of
``repro.train.steps``). Training (``TrainState``, ``make_train_step``)
is not ported yet (ROADMAP.md, Queue 1 item 11.1).

Each step runs under ``torch.no_grad``: serving keeps no
autograd state.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models import decode_step, prefill_forward


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
