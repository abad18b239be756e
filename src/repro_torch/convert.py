"""Carry fitted state and weights across from the JAX package.

A JAX ``KMeansResult`` whose fields went through ``np.asarray`` holds
plain numpy arrays; :func:`kmeans_state_from_numpy` turns it into the
port's :class:`~repro_torch.core.kmeans.KMeansResult` on a device, and
``KMeans.from_state`` wraps that into a fitted estimator.

An LM's parameter tree, a prefill cache and a train state, leaves as
numpy arrays (bf16 leaves as the numpy ``bfloat16`` type that
``np.asarray`` of a JAX array gives), become the port's with
:func:`lm_params_from_numpy`, :func:`lm_cache_from_numpy` and
:func:`train_state_from_numpy`. Each
leaf goes through float32, which holds every bf16 value exactly, so
nothing here needs the package that defines that numpy type.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import ArchConfig
from .core.kmeans import KMeansResult
from .device import resolve_device
from .models.transformer import (check_supported, flatten_with_path,
                                 leaf_dtype, param_shapes, rebuild)
from .train.steps import TrainState


def kmeans_state_from_numpy(result, device=None) -> KMeansResult:
    """``result``: any object with numpy-convertible ``centroids``,
    ``assignments``, ``n_iters``, ``distance_evals`` and ``inertia``."""
    dev = resolve_device(device)
    evals = np.rint(np.asarray(result.distance_evals, np.float64))
    return KMeansResult(
        torch.tensor(np.asarray(result.centroids, np.float32), device=dev),
        torch.tensor(np.asarray(result.assignments, np.int32), device=dev),
        int(np.asarray(result.n_iters)),
        torch.tensor(int(evals), dtype=torch.int64, device=dev),
        torch.tensor(float(np.asarray(result.inertia, np.float32)),
                     dtype=torch.float32, device=dev))


def _leaf(a, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dev, dtype)


def lm_params_from_numpy(tree: dict, cfg: ArchConfig, device=None) -> dict:
    """JAX's parameter tree for ``cfg`` (``repro.models.init_params``),
    leaves as numpy arrays, -> the port's tree on ``device`` (``None``:
    ``cuda``), each leaf cast to ``cfg``'s dtype for it. Raises
    ``ValueError`` where a path or a shape differs from
    :func:`~repro_torch.models.param_shapes`."""
    check_supported(cfg)
    dev = resolve_device(device)
    shapes = dict(flatten_with_path(param_shapes(cfg)))
    given = dict(flatten_with_path(tree))
    if set(given) != set(shapes):
        raise ValueError(f"parameter paths differ from {cfg.name}'s: "
                         f"missing {sorted(set(shapes) - set(given))}, "
                         f"extra {sorted(set(given) - set(shapes))}")
    leaves = {}
    for path, shape in shapes.items():
        if tuple(np.shape(given[path])) != tuple(shape):
            raise ValueError(f"{path}: shape {np.shape(given[path])}, "
                             f"{cfg.name} has {shape}")
        leaves[path] = _leaf(given[path], leaf_dtype(path, cfg), dev)
    return rebuild(param_shapes(cfg), leaves)


def lm_cache_from_numpy(tree: dict, cfg: ArchConfig, device=None) -> dict:
    """A prefill or decode cache of JAX's (``k``, ``v``, ``k_scale``,
    ``v_scale``, ``kvc``, ``kpe``, ``ssm``, ``conv`` stacked on L),
    leaves as numpy arrays, -> the port's on ``device`` (``None``:
    ``cuda``): int8 ``k``/``v`` (the int8 cache) kept int8, ``ssm`` and
    the scales in float32, the others in ``cfg``'s compute dtype."""
    check_supported(cfg)
    dev = resolve_device(device)
    known = ("k", "v", "k_scale", "v_scale", "kvc", "kpe", "ssm", "conv")
    if not set(tree) <= set(known):
        raise ValueError(f"unknown cache leaves {sorted(set(tree) - set(known))}")

    def leaf(name, a):
        if np.asarray(a).dtype == np.int8:
            return torch.from_numpy(np.array(a, np.int8)).to(dev)
        fp32 = name in ("ssm", "k_scale", "v_scale")
        return _leaf(a, torch.float32 if fp32 else cfg.compute_dtype, dev)

    return {k: leaf(k, a) for k, a in tree.items()}


def train_state_from_numpy(state, cfg: ArchConfig, device=None):
    """JAX's ``TrainState`` (``repro.train.steps``: step, params, m, v),
    leaves as numpy arrays, -> the port's
    :class:`~repro_torch.train.TrainState` on ``device`` (``None``:
    ``cuda``): params as :func:`lm_params_from_numpy` casts them, the
    moments in float32 on the same tree, the step an int32 scalar."""
    dev = resolve_device(device)
    params = lm_params_from_numpy(state.params, cfg, device=dev)
    shapes = param_shapes(cfg)

    def moments(tree):
        given = dict(flatten_with_path(tree))
        return rebuild(shapes, {p: _leaf(given[p], torch.float32, dev)
                                for p, _ in flatten_with_path(shapes)})

    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=dev)
    return TrainState(step, params, moments(state.m), moments(state.v))
