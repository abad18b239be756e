"""Partition rules: the specs of parameters, moments, batches and decode
caches, and their DTensor placements (port of
``repro.launch.sharding``; the rules are a copy, not an import).

The 2D(+pod) strategy:
  * 'model' — tensor/expert parallel: attention heads and head
    projections, the MLP hidden dim, the MoE expert axis, the vocab dim
    of embed/lm_head.
  * 'data'  — data parallel for activations and FSDP for the non-TP dim
    of every large parameter (ZeRO-3 style).
  * 'pod'   — pure data parallel across pods.

Rules are by leaf name (the param tree is flat enough that names are
unambiguous), so new layer types compose by adding a name entry.

A spec is a :class:`PartitionSpec`: a tuple with one entry a tensor
dimension, ``None``, an axis name, or a tuple of names listed major
first. :func:`named` turns a tree of specs into a tree of
:class:`NamedSharding` (a mesh and one DTensor placement a mesh
dimension); :func:`shard_tree` puts a tree of tensors in those
placements. The port's sharded step
(``train.make_sharded_train_step``) gathers the parameters whole on
every rank and computes on the rank's rows: compute is replicated over
'model', and the placements shard the state's memory.
"""
from __future__ import annotations

import dataclasses

from ..checkpoint.checkpoint import tree_flatten, tree_unflatten
from ..dtensor import gather_full, is_dtensor, placements_of, shard_of
from ..models.transformer import param_shapes
from ..train.steps import TrainState
from .mesh import axis_size, batch_axes


class PartitionSpec(tuple):
    """One entry a tensor dimension: ``None``, an axis name, or a tuple
    of axis names (major first). A tuple of one name is that name, and
    an empty one ``None``, as JAX's ``PartitionSpec`` normalises them."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, tuple):
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec

# leaf name -> spec WITHOUT the stacked layer axis
_RULES = {
    # embeddings / head
    "embed": P("model", "data"),
    "lm_head": P("data", "model"),
    "final_norm": P(None),
    # attention (GQA)
    "wq": P("data", "model"), "wk": P("data", "model"),
    "wv": P("data", "model"), "wo": P("model", "data"),
    "bq": P("model"), "bk": P("model"), "bv": P("model"),
    # attention (MLA)
    "w_dq": P("data", None), "w_uq": P(None, "model"),
    "w_dkv": P("data", None), "w_kr": P("data", None),
    "w_ukv": P(None, "model"),
    # dense MLP
    "w_gate": P("data", "model"), "w_up": P("data", "model"),
    "w_down": P("model", "data"),
    # MoE (expert axis leads)
    "router": P("data", None),
    "moe/w_gate": P("model", "data", None),
    "moe/w_up": P("model", "data", None),
    "moe/w_down": P("model", None, "data"),
    # mamba
    "in_proj": P("data", "model"), "dt_proj": P("data", None),
    "conv_w": P(None, "model"),
    "out_proj": P("model", "data"), "out_norm": P("model"),
    "A_log": P(None), "dt_bias": P(None), "D": P(None),
    # norms / scales
    "ln1": P(None), "ln2": P(None), "mix_na": P(None), "mix_nm": P(None),
}


def _rule_for(path: str) -> P:
    name = path.split("/")[-1]
    parent = "/".join(path.split("/")[-2:])
    if parent in _RULES:
        return _RULES[parent]
    if name in _RULES:
        return _RULES[name]
    raise KeyError(f"no partition rule for param {path!r}")


def param_pspecs(cfg, *, serve_tp: bool = False) -> dict:
    """Spec tree matching ``models.transformer.param_shapes(cfg)``.

    ``serve_tp=True`` drops the FSDP ('data') dim from every rule:
    inference has no optimizer state to shard."""
    def strip_data(spec):
        return P(*(None if a == "data" else a for a in spec))

    def walk(tree, prefix="", stacked=False):
        out = {}
        for k, v in tree.items():
            p = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = walk(v, p, stacked=stacked or k == "layers")
            else:
                spec = _rule_for(p)
                if serve_tp:
                    spec = strip_data(spec)
                if stacked:                      # leading L axis unsharded
                    spec = P(None, *spec)
                out[k] = spec
        return out

    return walk(param_shapes(cfg))


def train_state_pspecs(cfg):
    """TrainState(step, params, m, v): the moments shard like params."""
    pp = param_pspecs(cfg)
    return TrainState(step=P(), params=pp, m=pp, v=pp)


def batch_pspecs(cfg, mesh) -> dict:
    b = batch_axes(mesh)
    if getattr(cfg, "batch_2d", False):
        b = b + ("model",)
    spec = {"tokens": P(b, None), "labels": P(b, None)}
    if cfg.n_vision_tokens:
        spec["vision_embeds"] = P(b, None, None)
    return spec


def cache_pspecs(cfg, mesh, *, batch: int) -> dict:
    """Decode-cache specs. Large-batch decode shards batch on the data
    axes and sequence on 'model' (context parallel); a batch smaller
    than the data parallelism shards sequence over every axis."""
    b = batch_axes(mesh)
    data_par = 1
    for a in b:
        data_par *= axis_size(mesh, a)
    if batch >= data_par:
        bspec, sspec = b, "model"
    else:
        bspec, sspec = None, (*b, "model")
    spec: dict = {}
    if cfg.family != "ssm":
        if cfg.mla is not None:
            spec["kvc"] = P(None, bspec, sspec, None)
            spec["kpe"] = P(None, bspec, sspec, None)
        else:
            spec["k"] = P(None, bspec, sspec, None, None)
            spec["v"] = P(None, bspec, sspec, None, None)
            if getattr(cfg, "kv_cache_dtype", "native") == "int8":
                spec["k_scale"] = P(None, bspec, sspec, None)
                spec["v_scale"] = P(None, bspec, sspec, None)
    if cfg.family in ("ssm", "hybrid"):
        # head_dim (not heads) on 'model': head counts may be odd (25)
        spec["ssm"] = P(None, bspec, None, None, "model")
        spec["conv"] = P(None, bspec, None, "model")
    return spec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: ``placements`` holds one DTensor placement a
    mesh dimension (:func:`~repro_torch.dtensor.placements_of`)."""
    mesh: object
    spec: PartitionSpec
    placements: tuple


def _map_specs(fn, tree):
    """``fn`` over the specs of a tree of dicts and named tuples."""
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(_map_specs(fn, v) for v in tree))
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def named(mesh, spec_tree):
    """The tree of :class:`NamedSharding` of ``spec_tree`` on
    ``mesh``."""
    return _map_specs(
        lambda s: NamedSharding(mesh, s, placements_of(mesh, s)), spec_tree)


def place(x, sharding: NamedSharding, device=None):
    """``x`` as a DTensor under ``sharding``. A full tensor (or numpy
    array) is cut locally, with no communication, so every rank must
    hold the same one; a DTensor already in place is kept; a DTensor
    elsewhere is gathered and cut again (a collective). ``device``:
    where the shard lives (``None``: ``x``'s device)."""
    if len(sharding.spec) > len(x.shape):
        raise ValueError(f"spec {sharding.spec} has more entries than the "
                         f"tensor's {len(x.shape)} dimensions")
    if is_dtensor(x) and x.device_mesh == sharding.mesh \
            and tuple(x.placements) == sharding.placements:
        return x
    return shard_of(gather_full(x), sharding.mesh, sharding.placements,
                    device=device)


def shard_tree(tree, shardings, device=None):
    """:func:`place` over ``tree`` and ``shardings`` (a tree of
    :class:`NamedSharding` of ``tree``'s structure)."""
    leaves, treedef, _ = tree_flatten(tree)
    shs = tree_flatten(shardings)[0]
    if len(shs) != len(leaves):
        raise ValueError(f"{len(shs)} shardings for {len(leaves)} leaves")
    return tree_unflatten(treedef, [place(x, sh, device)
                                    for x, sh in zip(leaves, shs)])
