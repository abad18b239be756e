"""Dry run of every (arch x shape x mesh) cell on the ``meta`` device
(port of ``repro.launch.dryrun``).

For each cell, one rank of the production mesh (16 x 16, or 2 x 16 x
16) under the port's strategy (``train.make_sharded_train_step``: the
sharded inputs gathered whole, the rank's rows of the batch computed,
compute replicated over 'model'):

* ``memory``: the bytes of one rank's shards of the state (or the
  parameters and the decode cache) and of the batch, from the
  placements on a mesh of that shape (``mesh.AbstractMesh``: no process
  group). Rank (0, ..., 0) holds the largest shard of every leaf
  (``torch.chunk``'s first chunk is the longest), so its bytes are the
  per-rank peak of the inputs;
* ``flops``: the step on the rank's rows, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` on ``meta`` tensors,
  where the LM kernels' wrappers take their plain routes;
* ``bytes``: the operand and output bytes of every operator that is not
  a view, summed by a dispatch mode over the same run;
* ``collective``: the bytes one rank receives: each parameter (and, at
  decode, the rank's rows of the cache) gathered whole, and in training
  the rank's shard of each gradient leaf from each data-parallel peer
  (``dtensor.reduce_to_shard``);
* ``roofline``: ``roofline.analysis.roofline`` of those three.

Eager execution runs every loop body (layers, query and loss chunks,
SSD chunks) and counts each run, so the reference's accounting at one
and two layers (``analysis_cfg``, ``corrected_cost``, which made up for
XLA costing a while-loop body once) has no counterpart.

The k-means cell runs ``core.distributed``'s dense sharded fit on one
rank's shard of the production problem (points over every mesh axis)
in a world of one rank on the CPU, every iteration (``tol=0``), under
the same counters, with each all-reduce's bytes read at the fit's
``engine._all_reduce``.

Records go to ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both [--force]
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import get_config, list_configs
from ..configs.kpynq import production as KMEANS_PRODUCTION
from ..core import distributed as cd
from ..core import engine
from ..dtensor import local_nbytes, local_slices, placements_of
from ..roofline.analysis import PEAK_FLOPS, roofline
from ..train.steps import loss_and_grads, make_prefill_step, make_serve_step
from .mesh import n_chips, production_shape
from .sharding import PartitionSpec
from .specs import SHAPES, cell_inputs

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor operand and output of each
    operator that is not a view."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def _pairs(tree, specs):
    """``[(tensor, spec)]`` of a tree of tensors and its spec tree."""
    if isinstance(specs, PartitionSpec):
        return [(tree, specs)]
    if isinstance(specs, dict):
        return [p for k in specs for p in _pairs(tree[k], specs[k])]
    return [p for t, s in zip(tree, specs) for p in _pairs(t, s)]


def _zero(mesh):
    return (0,) * mesh.ndim


def rank_bytes(tree, specs, mesh) -> int:
    """The bytes of rank (0, ..., 0)'s shards of ``tree``."""
    return sum(local_nbytes(t.shape, t.dtype, mesh.shape, _zero(mesh),
                            placements_of(mesh, s))
               for t, s in _pairs(tree, specs))


def _rows(x, spec, mesh):
    """Rank (0, ..., 0)'s rows (dim 0) of ``x`` under ``spec``."""
    return x[local_slices(x.shape, mesh.shape, _zero(mesh),
                          placements_of(mesh, spec))[0]]


def _gathered(tree, specs, mesh) -> int:
    """Bytes a rank receives to hold ``tree`` whole."""
    return sum(t.numel() * t.element_size() for t, _ in _pairs(tree, specs)) \
        - rank_bytes(tree, specs, mesh)


def cell_cost(cfg, kind: str, batch: int, seq: int, mesh) -> dict:
    """One rank's memory, FLOPs, bytes and collective bytes of a cell
    (see the module's docstring), its step run on ``meta``."""
    args, in_specs, _, kind = cell_inputs(cfg, kind, batch, seq, mesh)
    flops, nbytes = FlopCounterMode(display=False), ByteCounter()
    if kind == "train":
        state, batch_t = args
        sspec, bspec = in_specs
        mine = {k: _rows(v, bspec[k], mesh) for k, v in batch_t.items()}
        dp = batch // len(mine["tokens"])
        with flops, nbytes:
            loss_and_grads(state.params, mine, cfg)
        memory = rank_bytes(state, sspec, mesh) + rank_bytes(batch_t, bspec,
                                                             mesh)
        # the parameters gathered whole; from each data-parallel peer the
        # rank's own shard of each gradient leaf
        coll = _gathered(state.params, sspec.params, mesh) + \
            (dp - 1) * rank_bytes(state.params, sspec.params, mesh)
    elif kind == "prefill":
        params, batch_t = args
        pspec, bspec = in_specs
        mine = {k: _rows(v, bspec[k], mesh) for k, v in batch_t.items()}
        with flops, nbytes:
            make_prefill_step(cfg)(params, mine)
        memory = rank_bytes(params, pspec, mesh) + rank_bytes(batch_t, bspec,
                                                              mesh)
        coll = _gathered(params, pspec, mesh)
    else:
        params, cache, tokens, _ = args
        pspec, cspec, tspec, _ = in_specs
        tok = _rows(tokens, tspec, mesh)
        rows = len(tok)
        cache_mine = {k: v[:, :rows] for k, v in cache.items()}
        with flops, nbytes:     # the last position: attention over all
            make_serve_step(cfg)(params, cache_mine, tok, seq - 1)
        memory = rank_bytes(params, pspec, mesh) + rank_bytes(cache, cspec,
                                                              mesh)
        coll = _gathered(params, pspec, mesh) + \
            sum(t.numel() * t.element_size() for t in
                tree_leaves(cache_mine)) - rank_bytes(cache, cspec, mesh)
    return {"kind": kind, "flops": float(flops.get_total_flops()),
            "bytes": float(nbytes.bytes), "coll": float(max(coll, 0)),
            "memory_bytes": memory}


def run_cell(arch: str, shape: str, multi_pod: bool, *, force=False,
             cfg_override=None, tag: str = "") -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    out_path = RESULTS / f"{arch}__{shape}__{mesh_name}{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    t0 = time.time()
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "tag": tag}
    try:
        cfg = cfg_override or get_config(arch)
        mesh = production_shape(multi_pod)
        info = SHAPES[shape]
        cost = cell_cost(cfg, info["kind"], info["batch"], info["seq"], mesh)
        rl = roofline({"flops": cost["flops"], "bytes accessed": cost["bytes"]},
                      cost["coll"], n_chips(mesh), cfg=cfg, kind=cost["kind"],
                      batch=info["batch"], seq=info["seq"])
        rec.update(ok=True, kind=cost["kind"], seconds=time.time() - t0,
                   cost=cost, roofline=rl)
    except Exception as e:
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    RESULTS.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1, default=str))
    status = "OK" if rec.get("ok") else f"FAIL ({rec.get('error', '')[:80]})"
    print(f"[dryrun] {arch:26s} {shape:12s} {mesh_name:8s} "
          f"{time.time() - t0:6.1f}s  {status}", flush=True)
    return rec


def kmeans_cost(prob, chips: int, *, compress: bool = False) -> dict:
    """One rank's FLOPs, bytes and all-reduced bytes of the dense sharded
    fit of ``prob`` over ``chips`` ranks: the fit itself on one rank's
    shard, in a world of one rank (see the module's docstring)."""
    n = -(-prob.n_points // chips)
    gen = torch.Generator().manual_seed(0)
    pts = torch.randn((n, prob.n_dims), generator=gen)
    init = pts[:prob.k].clone()
    reduced = []
    all_reduce = engine._all_reduce

    def counted(x, group, op=None):
        reduced.append(x.numel() * x.element_size())
        return all_reduce(x, group, op)

    flops, nbytes = FlopCounterMode(display=False), ByteCounter()
    engine._all_reduce = counted
    try:
        with cd.one_rank_world("gloo"):
            mesh = cd.make_mesh(1)
            with flops, nbytes:
                r = cd.distributed_yinyang(
                    pts, init, mesh, n_groups=prob.n_groups,
                    max_iters=prob.max_iters, tol=0.0, backend="dense",
                    compress=compress, tune="off", device="cpu")
    finally:
        engine._all_reduce = all_reduce
    # a ring all-reduce sends 2 (n - 1) / n of its payload a rank
    coll = 2.0 * (chips - 1) / chips * sum(reduced)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(nbytes.bytes), "coll": coll,
            "n_iters": int(r.n_iters), "rows": n}


def run_kmeans_cell(multi_pod: bool, *, force=False, tag: str = "",
                    compress: bool = False) -> dict:
    """The paper's own workload on the production mesh: the dense
    sharded fit with the points over every chip."""
    prob = KMEANS_PRODUCTION
    mesh_name = "2x16x16" if multi_pod else "16x16"
    out_path = RESULTS / f"kpynq-kmeans__fit__{mesh_name}{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    t0 = time.time()
    rec = {"arch": "kpynq-kmeans", "shape": "fit", "mesh": mesh_name,
           "tag": tag}
    try:
        chips = n_chips(production_shape(multi_pod))
        cost = kmeans_cost(prob, chips, compress=compress)
        rl = roofline({"flops": cost["flops"], "bytes accessed": cost["bytes"]},
                      cost["coll"], chips)
        # useful work: one dense assignment pass an iteration
        mf = 2.0 * prob.n_points * prob.k * prob.n_dims * prob.max_iters \
            / chips
        t_star = max(rl["t_compute_s"], rl["t_memory_s"],
                     rl["t_collective_s"])
        rl["model_flops_per_device"] = mf
        rl["useful_flops_ratio"] = mf / cost["flops"] if cost["flops"] else 0
        rl["roofline_fraction"] = (mf / PEAK_FLOPS) / t_star if t_star else 0
        rec.update(ok=True, kind="kmeans", seconds=time.time() - t0,
                   cost=cost, roofline=rl)
    except Exception as e:
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    RESULTS.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1, default=str))
    print(f"[dryrun] {'kpynq-kmeans':26s} {'fit':12s} {mesh_name:8s} "
          f"{time.time() - t0:6.1f}s  "
          f"{'OK' if rec.get('ok') else 'FAIL (' + rec.get('error', '')[:60] + ')'}",
          flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = list_configs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_ok = n_fail = 0
    if args.arch in ("all", "kpynq-kmeans"):
        for mp in meshes:
            rec = run_kmeans_cell(mp, force=args.force)
            n_ok += bool(rec.get("ok"))
            n_fail += not rec.get("ok")
        if args.arch == "kpynq-kmeans":
            print(f"[dryrun] done: {n_ok} ok, {n_fail} failed")
            raise SystemExit(1 if n_fail else 0)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, force=args.force)
                n_ok += bool(rec.get("ok"))
                n_fail += not rec.get("ok")
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
