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

:func:`make_sharded_train_step` is the step over a mesh, the
counterpart of ``jax.jit(step, in_shardings=(state_sh, batch_sh),
out_shardings=(state_sh, None))``: the state's leaves are DTensors in
the partition rules' placements (``launch.sharding``), each rank
gathers the parameters whole, computes the loss and its gradient on
its own rows of the batch (so the kernels see plain CUDA tensors), and
updates its own shards. Compute is replicated over the mesh axes that
do not cut the batch ('model').
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..checkpoint.checkpoint import tree_flatten, tree_unflatten
from ..configs.base import ArchConfig
from ..data import to_device
from ..device import resolve_device
from ..dtensor import (from_local, gather_full, local_slices, local_tensor,
                       reduce_to_shard, replicated, shard_sums)
from ..models import decode_step, init_params, loss_fn, prefill_forward
from ..models.transformer import flatten_with_path, rebuild
from ..optim.adamw import AdamWConfig, adamw_update, init_moments


class TrainState(NamedTuple):
    step: torch.Tensor        # int32 scalar, on the params' device
    params: dict
    m: dict
    v: dict


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     device=None, shardings=None) -> TrainState:
    """Fresh parameters (``models.init_params``) and fp32 zero moments
    on ``device`` (``None``: ``cuda``), at step 0. ``shardings`` (a
    ``TrainState`` of ``launch.sharding.NamedSharding``): the state as
    DTensors in those placements instead, each rank keeping its own
    shards of parameters drawn whole from ``generator`` (so every rank
    must seed it alike) and zero moments made as shards."""
    dev = resolve_device(device)
    params = init_params(cfg, generator, device=dev)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if shardings is None:
        m, v = init_moments(params)
        return TrainState(step, params, m, v)
    from ..launch.sharding import shard_tree    # it imports this module
    params = shard_tree(params, shardings.params)

    def zeros(p):
        return from_local(torch.zeros(p.to_local().shape, dtype=torch.float32,
                                      device=dev),
                          p.device_mesh, p.placements, p.shape)

    m, v = (shard_tree(_map_leaves(zeros, params), sh)
            for sh in (shardings.m, shardings.v))
    return TrainState(shard_tree(step, shardings.step), params, m, v)


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


def _map_leaves(fn, tree):
    leaves, treedef, _ = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


def make_sharded_train_step(cfg: ArchConfig, state_shardings,
                            batch_shardings,
                            opt: AdamWConfig = AdamWConfig()):
    """The train step over a mesh: ``(state, batch) -> (state,
    metrics)`` on every rank of it (a collective). ``state_shardings``
    (``launch.sharding.named(mesh, train_state_pspecs(cfg))``) places
    the state's leaves, input and output alike; ``batch_shardings``
    (``named(mesh, batch_pspecs(cfg, mesh))``) cuts ``batch``, the
    global numpy batch every rank is handed, into the rank's rows.

    A step: the state is put in place (``sharding.shard_tree``: a full
    state is cut locally, so every rank must hold the same one); each
    parameter is gathered whole; ``loss_and_grads`` runs on the rank's
    rows; each rank gets its shard of each gradient leaf's fp32 mean
    over the mesh dimensions that cut the batch, each peer sending only
    that shard, added in coordinate order (``dtensor.reduce_to_shard``;
    a batch on one rank keeps the gradient's dtype), and the loss its
    mean the same way; the global norm adds each leaf's
    distinct shards' sums of squares in coordinate order
    (``dtensor.shard_sums``), then the leaves in :func:`global_norm`'s
    order; AdamW runs on the rank's shards of the gradient, parameters
    and moments. Nothing is added in an order that changes from run to run,
    so a step from one state gives the same bits every time, and on a
    mesh of one rank it gives the unsharded step's bits. ``metrics``
    (``loss``, ``grad_norm``, ``lr``) are plain tensors, the same on
    every rank."""
    from torch.distributed.tensor import Shard

    from ..launch.sharding import shard_tree    # it imports this module

    tok = batch_shardings["tokens"]
    mesh = tok.mesh
    # the mesh dimensions that cut the batch's rows
    data_dims = [i for i, p in enumerate(tok.placements)
                 if isinstance(p, Shard)]
    shards = 1
    for i in data_dims:
        shards *= mesh.shape[i]
    p_shardings = tree_flatten(state_shardings.params)[0]

    def train_step(state: TrainState, batch: dict):
        state = shard_tree(state, state_shardings)
        rows = len(batch["tokens"])
        if rows % shards:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{shards} data-parallel ranks")
        coord = mesh.get_coordinate()
        mine = {k: v[local_slices(v.shape, mesh.shape, coord,
                                  batch_shardings[k].placements)]
                for k, v in batch.items()}
        step_t = local_tensor(state.step)
        b = to_device(mine, step_t.device)
        full = _map_leaves(gather_full, state.params)
        loss, grads = loss_and_grads(full, b, cfg)
        del full, b
        leaves, treedef, _ = tree_flatten(grads)
        del grads
        squares, g_local = [], []
        for i, sh in enumerate(p_shardings):
            g = reduce_to_shard(leaves[i], mesh, data_dims, sh.placements)
            leaves[i] = None
            squares.append(torch.sum(torch.square(g.float())))
            g_local.append(g)
            del g
        gnorm = torch.sqrt(sum(shard_sums(
            torch.stack(squares), mesh,
            [sh.placements for sh in p_shardings])))
        with torch.no_grad():
            new_p, new_m, new_v, metrics = adamw_update(
                tree_unflatten(treedef, g_local),
                _map_leaves(local_tensor, state.m),
                _map_leaves(local_tensor, state.v),
                _map_leaves(local_tensor, state.params), step_t, opt,
                gnorm=gnorm)
        metrics["loss"] = reduce_to_shard(loss, mesh, data_dims,
                                          replicated(mesh))

        def wrap(new, old):
            flat_old = tree_flatten(old)[0]
            return tree_unflatten(treedef, [
                from_local(x, sh.mesh, sh.placements, o.shape)
                for x, o, sh in zip(tree_flatten(new)[0], flat_old,
                                    p_shardings)])

        st = state_shardings.step
        new_step = from_local(step_t + 1, st.mesh, st.placements, ())
        return TrainState(new_step, wrap(new_p, state.params),
                          wrap(new_m, state.m), wrap(new_v, state.v)), metrics

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
