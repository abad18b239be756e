"""The port's partition rules (``repro_torch.launch.sharding``) and their
DTensor placements (``repro_torch.dtensor``), on the CPU.

* Every spec tree the rules give (parameters, ``serve_tp``, the train
  state, the batch with and without ``batch_2d``, the decode cache at a
  large and a small batch) equals ``repro.launch.sharding``'s, leaf for
  leaf, for every config on the 16 x 16 and 2 x 16 x 16 meshes.
* The ports of ``tests/test_sharding.py``: every parameter has a rule
  and its sharded dims divide on the production mesh; ``serve_tp``
  strips 'data'; the moments' specs mirror the parameters'; the cache
  shards batch or sequence by the batch size; ``batch_2d`` adds 'model'.
* Placements: a spec's ``Shard``/``Replicate`` per mesh dim, the orders
  DTensor cannot express refused, and the slices a rank holds under
  ``torch.chunk``'s rule.
"""
import dataclasses

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JaxP
from torch.distributed.tensor import Replicate, Shard

import repro.launch.sharding as jsh
from repro.configs import get_config as jax_config
from repro.configs import list_configs
from repro_torch.checkpoint.checkpoint import tree_flatten
from repro_torch.configs import get_config
from repro_torch.dtensor import (chunk_bounds, local_nbytes, local_shape,
                                 local_slices, placements_of)
from repro_torch.launch.mesh import AbstractMesh, batch_axes, production_shape
from repro_torch.launch.sharding import (P, batch_pspecs, cache_pspecs,
                                         named, param_pspecs,
                                         train_state_pspecs)
from repro_torch.models.transformer import flatten_with_path, param_shapes

MESHES = {"16x16": False, "2x16x16": True}


def _jax_mesh(multi_pod):
    m = production_shape(multi_pod)
    return jax.sharding.AbstractMesh(m.shape, m.mesh_dim_names)


def _flat(tree):
    """[(path, spec as a tuple)] of a spec tree of either package."""
    out = []

    def walk(node, path):
        if isinstance(node, (JaxP, P)):
            out.append((path, tuple(node)))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        else:                                   # a TrainState
            for f, v in zip(type(node)._fields, node):
                walk(v, f"{path}.{f}")
    walk(tree, "")
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_configs())
def test_spec_trees_equal_jax(arch, mesh):
    multi = MESHES[mesh]
    pm, jm = production_shape(multi), _jax_mesh(multi)
    cfg, jcfg = get_config(arch), jax_config(arch)
    pairs = [(param_pspecs(cfg), jsh.param_pspecs(jcfg)),
             (param_pspecs(cfg, serve_tp=True),
              jsh.param_pspecs(jcfg, serve_tp=True)),
             (train_state_pspecs(cfg), jsh.train_state_pspecs(jcfg)),
             (batch_pspecs(cfg, pm), jsh.batch_pspecs(jcfg, jm))]
    wide = dataclasses.replace(cfg, batch_2d=True)
    pairs.append((batch_pspecs(wide, pm), jsh.batch_pspecs(
        dataclasses.replace(jcfg, batch_2d=True), jm)))
    for b in (1, 16, 128):
        pairs.append((cache_pspecs(cfg, pm, batch=b),
                      jsh.cache_pspecs(jcfg, jm, batch=b)))
    int8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    pairs.append((cache_pspecs(int8, pm, batch=128), jsh.cache_pspecs(
        dataclasses.replace(jcfg, kv_cache_dtype="int8"), jm, batch=128)))
    for got, want in pairs:
        assert _flat(got) == _flat(want)
    # and every spec has its placements on the mesh's shape
    named(pm, train_state_pspecs(cfg))


@pytest.mark.parametrize("arch", list_configs())
def test_every_param_has_rule_and_divides(arch):
    cfg = get_config(arch)
    sizes = {"data": 16, "model": 16}
    specs = dict(_flat(param_pspecs(cfg)))
    shapes = dict((f"/{p}", s) for p, s in flatten_with_path(
        param_shapes(cfg)))
    assert specs and specs.keys() == shapes.keys()
    for path, spec in specs.items():
        shape = shapes[path]
        assert len(spec) <= len(shape)
        for dim, axis in zip(shape, spec):
            if axis is None:
                continue
            par = 1
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                par *= sizes[a]
            assert dim % par == 0, f"{arch}: {path} dim {dim} by {par}"


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-moe-235b-a22b",
                                  "mamba2-780m", "hymba-1.5b",
                                  "minicpm3-4b"])
def test_serve_tp_strips_data_axis(arch):
    for _, spec in _flat(param_pspecs(get_config(arch), serve_tp=True)):
        assert "data" not in [a for e in spec if e is not None
                              for a in (e if isinstance(e, tuple) else (e,))]


def test_train_state_specs_mirror_params():
    ts = train_state_pspecs(get_config("phi4-mini-3.8b"))
    assert ts.step == P()
    assert _flat(ts.params) == _flat(ts.m) == _flat(ts.v)


def test_cache_specs_batch_vs_seq_sharding():
    mesh = production_shape()
    cfg = get_config("qwen2-7b")
    big = cache_pspecs(cfg, mesh, batch=128)
    small = cache_pspecs(cfg, mesh, batch=1)
    assert big["k"][1] is not None                # batch dim sharded
    assert small["k"][1] is None                  # seq over every axis
    assert small["k"][2] == ("data", "model")


def test_batch_2d_extends_axes():
    cfg = get_config("hymba-1.5b")
    mesh = AbstractMesh((1, 1), ("data", "model"))
    assert batch_axes(mesh) == ("data",)
    assert batch_pspecs(cfg, mesh)["tokens"] == P("data", None)
    wide = batch_pspecs(dataclasses.replace(cfg, batch_2d=True), mesh)
    assert wide["tokens"] == P(("data", "model"), None)


def test_placements_of_specs():
    mesh = production_shape(True)                 # (pod, data, model)
    assert placements_of(mesh, P("model", "data")) == \
        (Replicate(), Shard(1), Shard(0))
    assert placements_of(mesh, P(None, ("pod", "data"), "model")) == \
        (Shard(1), Shard(1), Shard(2))
    assert placements_of(mesh, P()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        placements_of(mesh, P(("data", "pod")))
    with pytest.raises(ValueError, match="two dimensions"):
        placements_of(mesh, P("data", "data"))
    with pytest.raises(ValueError, match="lacks"):
        placements_of(AbstractMesh((4,), ("data",)), P("model"))


@pytest.mark.parametrize("size,parts", [(10, 4), (7, 8), (32001, 16),
                                        (0, 3), (128, 128)])
def test_chunks_follow_torch_chunk(size, parts):
    x = torch.arange(size)
    chunks = list(torch.chunk(x, parts)) if size else []
    for i in range(parts):
        a, b = chunk_bounds(size, parts, i)
        want = chunks[i] if i < len(chunks) else x[:0]
        assert torch.equal(x[a:b], want)


def test_local_slices_tile_the_tensor():
    """Every element is held by exactly the ranks of the replicated mesh
    dims, across two mesh axes sharding one dim and uneven sizes."""
    mesh = AbstractMesh((3, 2), ("data", "model"))
    shape = (7, 5, 2)
    pl = placements_of(mesh, P(("data", "model"), None))
    pl2 = placements_of(mesh, P("model", "data"))
    for pls, copies in ((pl, 1), (pl2, 1),
                        (placements_of(mesh, P(None, "model")), 3)):
        seen = torch.zeros(shape, dtype=torch.int64)
        total = 0
        for c in [(i, j) for i in range(3) for j in range(2)]:
            sl = local_slices(shape, mesh.shape, c, pls)
            seen[sl] += 1
            total += local_nbytes(shape, torch.float32, mesh.shape, c, pls)
            assert local_shape(shape, mesh.shape, c, pls) == \
                tuple(seen[sl].shape)
        assert bool((seen == copies).all())
        assert total == copies * 7 * 5 * 2 * 4


def test_named_shardings_follow_the_state():
    mesh = AbstractMesh((4, 2), ("data", "model"))
    cfg = get_config("hymba-1.5b")
    sh = named(mesh, train_state_pspecs(cfg))
    leaves = tree_flatten(sh)[0]
    assert len(leaves) == 1 + 3 * len(flatten_with_path(param_shapes(cfg)))
    assert sh.params["embed"].placements == (Shard(1), Shard(0))
    assert sh.step.placements == (Replicate(), Replicate())
    # the stacked layer axis is never sharded
    assert sh.params["layers"]["attn"]["wq"].placements == (Shard(1),
                                                            Shard(2))
