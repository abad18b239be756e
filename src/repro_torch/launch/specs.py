"""Inputs of every (arch x shape) dry-run cell on the ``meta`` device
(port of ``repro.launch.specs``).

Nothing here allocates: where the reference builds its full-size
stand-ins with ``jax.eval_shape`` over the real init functions, the
port builds ``meta`` tensors of the same shapes and dtypes, the
parameters from ``models.transformer.param_shapes`` and ``leaf_dtype``
(``init_params`` draws from a generator, which a ``meta`` tensor
refuses) and the decode cache from ``init_cache`` itself.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..models import init_cache
from ..models.transformer import flatten_with_path, leaf_dtype, param_shapes
from ..train.steps import TrainState
from .mesh import axis_size, batch_axes
from .sharding import (P, batch_pspecs, cache_pspecs, param_pspecs,
                       train_state_pspecs)

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

META = torch.device("meta")


def meta_params(cfg: ArchConfig) -> dict:
    """The parameter tree of ``cfg`` as ``meta`` tensors."""
    out: dict = {}
    for path, shape in flatten_with_path(param_shapes(cfg)):
        node = out
        *parents, name = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = torch.empty(shape, dtype=leaf_dtype(path, cfg),
                                 device=META)
    return out


def meta_train_state(cfg: ArchConfig) -> TrainState:
    """``train.init_train_state``'s structure on ``meta``: the params,
    fp32 moments, an int32 step."""
    params = meta_params(cfg)

    def moments(tree):
        return {k: moments(v) if isinstance(v, dict) else
                torch.empty(v.shape, dtype=torch.float32, device=META)
                for k, v in tree.items()}

    return TrainState(torch.empty((), dtype=torch.int32, device=META),
                      params, moments(params), moments(params))


def _batch_specs(cfg: ArchConfig, b: int, s: int) -> dict:
    spec = {
        "tokens": torch.empty((b, s), dtype=torch.int32, device=META),
        "labels": torch.empty((b, s), dtype=torch.int32, device=META),
    }
    if cfg.n_vision_tokens:
        spec["vision_embeds"] = torch.empty(
            (b, cfg.n_vision_tokens, cfg.d_model), dtype=cfg.compute_dtype,
            device=META)
    return spec


def input_specs(cfg: ArchConfig, shape_name: str, mesh):
    """Returns (args: tuple of ``meta`` tensor trees, in_specs: the
    matching spec trees, out_specs or None, kind). ``mesh``: a
    ``DeviceMesh`` or a ``mesh.AbstractMesh``."""
    info = SHAPES[shape_name]
    return cell_inputs(cfg, info["kind"], info["batch"], info["seq"], mesh)


def cell_inputs(cfg: ArchConfig, kind: str, b: int, s: int, mesh):
    """:func:`input_specs` of a cell of ``kind`` at batch ``b`` and
    sequence ``s`` (a ``SHAPES`` entry, or :func:`reduced_cell`'s)."""
    bax = batch_axes(mesh)

    if kind == "train":
        state = meta_train_state(cfg)
        batch = _batch_specs(cfg, b, s)
        in_specs = (train_state_pspecs(cfg), batch_pspecs(cfg, mesh))
        out_specs = (train_state_pspecs(cfg), None)
        return (state, batch), in_specs, out_specs, kind

    params = meta_params(cfg)
    pspecs = param_pspecs(cfg, serve_tp=getattr(cfg, "serve_tp_params",
                                                False))

    if kind == "prefill":
        batch = {"tokens": torch.empty((b, s), dtype=torch.int32,
                                       device=META)}
        bspecs = {"tokens": P(bax, None)}
        if cfg.n_vision_tokens:
            batch["vision_embeds"] = torch.empty(
                (b, cfg.n_vision_tokens, cfg.d_model),
                dtype=cfg.compute_dtype, device=META)
            bspecs["vision_embeds"] = P(bax, None, None)
        cspecs = cache_pspecs(cfg, mesh, batch=b)
        out_specs = ((P(bax, None, "model"), cspecs)
                     if _data_par(mesh, bax) <= b else (None, cspecs))
        return (params, batch), (pspecs, bspecs), out_specs, kind

    # decode
    cache = init_cache(cfg, b, s, device=META)
    cspecs = cache_pspecs(cfg, mesh, batch=b)
    dpar = _data_par(mesh, bax)
    tok_spec = P(bax, None) if b >= dpar else P(None, None)
    args = (params, cache,
            torch.empty((b, 1), dtype=torch.int32, device=META),
            torch.empty((), dtype=torch.int32, device=META))
    in_specs = (pspecs, cspecs, tok_spec, P())
    logits_spec = (P(bax, None, "model") if b >= dpar
                   else P(None, None, "model"))
    out_specs = (logits_spec, cspecs)
    return args, in_specs, out_specs, kind


def _data_par(mesh, bax) -> int:
    n = 1
    for a in bax:
        n *= axis_size(mesh, a)
    return n


def reduced_cell(cfg: ArchConfig, shape_name: str):
    """Tiny analogue of a cell for CPU integration tests."""
    info = SHAPES[shape_name]
    scale = dataclasses.replace(cfg.reduced())
    return scale, dict(kind=info["kind"], seq=128, batch=4)
