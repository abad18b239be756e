"""The paper's workload end to end on the port: the UCI-like suite, the
compact engine with its telemetry ring, the streaming fit, a weighted
fit, predict, and the sharded fit on ``torch.distributed``.

  PYTHONPATH=src python -m repro_torch.examples.kmeans_clustering \
      [--scale 0.1] [--device cpu] [--world N]

For each problem of ``configs.kpynq.paper_suite`` (cut to ``--scale``
of its points) it reports the work reduction of the multi-level filter
(Yinyang) and of the point-level filter alone (Hamerly) against
Lloyd's, all from the same k-means++ seeds. ``--world`` ranks (default:
every card over NCCL, or 2 ``gloo`` ranks on the CPU; 0 skips it) run
the sharded fit, held to the single-device compact fit.

Streaming decay: ``StreamingKMeans(decay=1.0)`` (used here) is pure
count weighting, converging to the batch fit on stationary data;
``decay < 1`` forgets with a horizon of about 1 / (1 - decay) batches.
"""
import argparse

import numpy as np
import torch

from repro_torch import KMeans, engine_fit, lloyd, yinyang, yinyang_compact
from repro_torch.configs import paper_suite
from repro_torch.core.distributed import (distributed_yinyang, make_mesh,
                                          spawn_world)
from repro_torch.core.init import kmeans_plusplus
from repro_torch.data import PointStream, make_points
from repro_torch.device import resolve_device
from repro_torch.obs import ObsConfig
from repro_torch.obs.ring import format_ring_table
from repro_torch.streaming import StreamingKMeans


def sharded_rank(rank, world, points, init, device):
    """One rank of the sharded fit: its rows of ``points`` from
    ``init``; returns the fit's inertia."""
    mesh = make_mesh(world)
    # None: rank r on card r % count
    res = distributed_yinyang(points, init, mesh, max_iters=40, tune="off",
                              device=None if device == "cuda" else device)
    return float(res.inertia)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--max-datasets", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)  # noqa

    print(f"{'dataset':12s} {'N':>9s} {'D':>4s} {'K':>5s} "
          f"{'iters':>5s} {'work_red':>9s} {'hamerly':>8s}")
    for prob in paper_suite[:args.max_datasets]:
        n = max(int(prob.n_points * args.scale), 1024)
        pts_np, _, _ = make_points(n, prob.n_dims, prob.k, seed=0)
        pts = torch.from_numpy(pts_np).to(dev)
        init = kmeans_plusplus(gen(1), pts, prob.k)
        r_l = lloyd(pts, init, prob.max_iters, prob.tol)
        r_y = yinyang(pts, init, max_iters=prob.max_iters, tol=prob.tol)
        r_h = yinyang(pts, init, n_groups=1, max_iters=prob.max_iters,
                      tol=prob.tol)
        wr = float(r_l.distance_evals) / float(r_y.distance_evals)
        wh = float(r_l.distance_evals) / float(r_h.distance_evals)
        print(f"{prob.name:12s} {n:9d} {prob.n_dims:4d} {prob.k:5d} "
              f"{int(r_y.n_iters):5d} {wr:8.1f}x {wh:7.1f}x")

    # compaction mode
    n = max(int(327_680 * args.scale), 4096)
    pts_np, _, _ = make_points(n, 32, 256, seed=0)
    pts = torch.from_numpy(pts_np).to(dev)
    init = kmeans_plusplus(gen(1), pts, 256)
    r_c = yinyang_compact(pts, init, max_iters=40)
    print(f"\ncompaction mode: iters={int(r_c.n_iters)} "
          f"evals={float(r_c.distance_evals):.3g} "
          f"inertia={float(r_c.inertia):.1f}")

    # observability: the same problem through the engine with the
    # telemetry ring on (per-iteration filter efficiency, drained once
    # at the end; the same bits with the ring on or off)
    _, stats = engine_fit(pts, init, max_iters=40, backend="compact",
                          tune="off", return_stats=True, obs=ObsConfig(),
                          device=dev)
    print("\nper-iteration filter efficiency (telemetry ring):")
    print(format_ring_table(stats.ring, stats.n_points, max_rows=12))
    print(f"telemetry: {stats.telemetry()}")

    # streaming: the same points as 2048-point shards through
    # partial_fit; epochs 2+ revisit shards, whose carried bounds skip
    # most of the distance work
    stream = PointStream(shard_size=2048, data=pts_np)
    skm = StreamingKMeans(256, seed=1, init_size=4096, device=dev)
    skm.fit_stream(stream, epochs=3)
    st = skm.stats_
    gap = skm.inertia_of(pts_np) / float(r_c.inertia) - 1.0
    print(f"streaming fit: batches={st.batches} "
          f"cache_hits={st.cache_hits} reseeds={st.reseeds} "
          f"work_red={st.points_seen * 256 / max(st.distance_evals, 1):.1f}x "
          f"inertia gap vs batch: {gap * 100:+.2f}%")

    # weighted clustering: the first blob weighted 5x
    km = KMeans(n_clusters=8, engine="auto", seed=1, device=dev)
    sub = np.asarray(pts_np[:8192])
    w = np.where(np.arange(len(sub)) < 1024, 5.0, 1.0).astype(np.float32)
    km.fit(sub, sample_weight=w)
    print(f"weighted fit: inertia={km.inertia_:.1f} "
          f"score(training)={km.score(sub, sample_weight=w):.1f}")

    # predict: the tiled assignment, against transform's argmin
    labels = km.predict(sub)
    print(f"predict (tiled): {len(labels)} labels, "
          f"first tile matches transform argmin: "
          f"{bool((labels[:100] == km.transform(sub[:100]).argmin(1)).all())}")

    # the sharded fit on torch.distributed
    world = args.world
    if world is None:
        world = torch.cuda.device_count() if dev.type == "cuda" else 2
    if world:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        one = engine_fit(pts, init, max_iters=40, backend="compact",
                         tune="off", device=dev)
        inertias = spawn_world(sharded_rank, world, backend=backend,
                               args=(pts_np, init.cpu().numpy(), dev.type))
        rel = abs(inertias[0] - float(one.inertia)) / float(one.inertia)
        print(f"distributed ({world} ranks over {backend}): "
              f"inertia={inertias[0]:.1f} matches single-device: "
              f"{rel < 1e-4}")
    return r_c


if __name__ == "__main__":
    main()
