"""End-to-end training launcher (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --reduced --steps 200 --batch 8 --seq 256 [--device cpu] [--world N]

``--reduced`` runs the family-faithful tiny config; omit it to train
the full config. The state is sharded over a mesh by the partition
rules (``launch.sharding``; ``--production-mesh``: the 16 x 16 mesh,
which needs a world of 256 ranks, else the (world x 1) host mesh) and
stepped by ``train.make_sharded_train_step`` inside the fault-tolerant
loop (checkpoint, restart, straggler watchdog), whatever the scale.

The ranks: under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` in the
environment) each process is one, on card ``LOCAL_RANK``, joined over
NCCL where the machine has a card for each of its ``LOCAL_WORLD_SIZE``
ranks (``gloo`` with ``--device cpu`` or where ranks share a card);
otherwise ``--world N`` ranks are
started on this machine by ``core.distributed.spawn_world`` (over
NCCL where there is a card for each, else over ``gloo``, which lets
ranks share a card), and a world of 1 (the default) runs in this
process. Runs on ``cuda`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import get_config
from ..core.distributed import one_rank_world, spawn_world
from ..data import TokenPipeline
from ..optim.adamw import AdamWConfig
from ..runtime.fault_tolerance import FailureInjector, ResilientLoop
from ..train.steps import init_train_state, make_sharded_train_step
from .mesh import make_host_mesh, make_production_mesh
from .sharding import batch_pspecs, named, train_state_pspecs

# a launcher's world runs as long as its training does
WORLD_TIMEOUT_S = 7 * 24 * 3600.0


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--fail-at", default="",
                    help="comma-separated steps for failure injection")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda)")
    ap.add_argument("--world", type=int, default=1,
                    help="ranks to start on this machine (not under "
                         "torchrun)")
    return ap


def _backend(device, ranks_here: int) -> str:
    """NCCL where each of the ``ranks_here`` ranks on this machine has a
    card of its own, else ``gloo`` (``--device cpu``, or ranks sharing a
    card)."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    return "nccl" if ranks_here <= torch.cuda.device_count() else "gloo"


def _torchrun_ranks(env) -> tuple[int, int]:
    """``(local rank, ranks on this machine)`` from torchrun's
    environment: a world over several machines puts only
    ``LOCAL_WORLD_SIZE`` of its ranks on this one's cards."""
    return (int(env.get("LOCAL_RANK", 0)),
            int(env.get("LOCAL_WORLD_SIZE", env["WORLD_SIZE"])))


def train(args, rank: int, local_rank: int):
    """One rank's run in an initialised world (``local_rank``: its
    place among the ranks on this machine); returns the loop."""
    dev = torch.device(args.device) if args.device is not None else \
        torch.device("cuda", local_rank % max(torch.cuda.device_count(), 1))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = (make_production_mesh(device=dev) if args.production_mesh
            else make_host_mesh(device=dev))
    opt = AdamWConfig(lr_peak=args.lr, warmup_steps=min(50, args.steps // 4),
                      decay_steps=args.steps)
    state_sh = named(mesh, train_state_pspecs(cfg))
    batch_sh = named(mesh, batch_pspecs(cfg, mesh))
    step_fn = make_sharded_train_step(cfg, state_sh, batch_sh, opt)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = init_train_state(cfg, gen, device=dev, shardings=state_sh)
    pipeline = TokenPipeline(cfg, args.batch, args.seq, seed=args.seed)
    injector = None
    if args.fail_at:
        injector = FailureInjector(
            tuple(int(s) for s in args.fail_at.split(",")))
    loop = ResilientLoop(step_fn, pipeline, args.ckpt_dir,
                         ckpt_every=args.ckpt_every, injector=injector)
    t0 = time.time()
    loop.run(state, args.steps, state_shardings=state_sh)
    wall = time.time() - t0
    if rank == 0:
        losses = [m["loss"] for m in loop.metrics_log]
        n = max(len(losses) // 10, 1)
        print(f"[train] arch={cfg.name} steps={args.steps} wall={wall:.1f}s "
              f"({wall / max(args.steps, 1) * 1e3:.1f} ms/step) "
              f"restarts={loop.restarts} "
              f"stragglers={len(loop.watchdog.events)}")
        print(f"[train] loss first10={np.mean(losses[:n]):.4f} "
              f"last10={np.mean(losses[-n:]):.4f}", flush=True)
    return loop


def _rank(rank, world, args):
    """A rank that ``spawn_world`` started."""
    loop = train(args, rank, rank)
    return [m["loss"] for m in loop.metrics_log]


def main(argv=None):
    args = _parser().parse_args(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:     # torchrun
        local, here = _torchrun_ranks(os.environ)
        backend = _backend(args.device, here)
        if backend == "nccl":
            torch.cuda.set_device(local)
        dist.init_process_group(backend)
        try:
            return train(args, dist.get_rank(), local)
        finally:
            dist.destroy_process_group()
    if args.world > 1:
        return spawn_world(_rank, args.world, args=(args,),
                           backend=_backend(args.device, args.world),
                           timeout=WORLD_TIMEOUT_S)
    with one_rank_world(_backend(args.device, 1), timeout=WORLD_TIMEOUT_S):
        return train(args, 0, 0)


if __name__ == "__main__":
    main()
