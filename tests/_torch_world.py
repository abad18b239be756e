"""The ranks' side of ``tests/test_torch_distributed.py`` (and of one
``cuda`` test in ``tests/test_torch_cuda.py``): functions that
``repro_torch.core.distributed.spawn_world`` runs in each rank of a
``gloo`` world. They import torch and the port only (a rank never loads
JAX); each returns plain numpy/python values."""
import os

import numpy as np
import torch

KW = dict(max_iters=40, tol=1e-5, device="cpu")


def _res(r):
    return dict(assignments=r.assignments.cpu().numpy(),
                n_iters=int(r.n_iters), evals=int(r.distance_evals),
                inertia=float(r.inertia), centroids=r.centroids.cpu().numpy())


def _raises(fn, exc):
    """The message of the ``exc`` that ``fn()`` raises, or None."""
    try:
        fn()
    except exc as e:
        return str(e)
    return None


def sharded_fits(rank, world, inputs_path, cache_path):
    """Every sharded case of the test file, in one world. Rank 0 returns
    all results; every rank returns its own compact parity fit, so the
    test can check that the ranks agree."""
    from repro_torch import tune
    from repro_torch.core import distributed_yinyang, make_mesh
    from repro_torch.core.engine import EngineConfig
    from repro_torch.obs import MetricsRegistry
    from repro_torch.runtime import StragglerWatchdog

    os.environ[tune.ENV_VAR] = cache_path
    tune.set_default_cache(None)
    x = dict(np.load(inputs_path))
    mesh = make_mesh(world)
    out = {}

    def fit(name, pts, init, **kw):
        out[name] = _res(distributed_yinyang(pts, init, mesh,
                                             **{**KW, **kw}))

    for backend in ("dense", "compact"):
        for compress in (False, True):
            fit(f"parity/{backend}/{compress}", x["p_pts"], x["p_init"],
                backend=backend, compress=compress)
    # stats, obs and a watchdog on: the result must not move a bit
    reg, dog = MetricsRegistry(), StragglerWatchdog(threshold=1.5)
    r, st = distributed_yinyang(x["p_pts"], x["p_init"], mesh,
                                backend="compact", return_stats=True,
                                obs=reg, watchdog=dog, **KW)
    out["stats"] = dict(
        fit=_res(r), shard_rings=st.shard_rings, ring=st.ring,
        init_evals=st.init_evals, shard_skew=st.shard_skew,
        host_syncs=st.host_syncs, caps=st.caps_history,
        events=[e["event"] for e in reg.events],
        metrics=sorted(m.name for m in reg.metrics()),
        watchdog_events=len(dog.events))
    # uneven N (sentinel rows) and the all-survivor shard
    fit("uneven/compact", x["u_pts"], x["u_init"], backend="compact")
    out["uneven/dense_error"] = _raises(
        lambda: distributed_yinyang(x["u_pts"], x["u_init"], mesh,
                                    backend="dense", **KW), ValueError)
    for backend in ("dense", "compact"):
        fit(f"survivor/{backend}", x["s_pts"], x["s_init"], backend=backend)
    # weights: ones against none, integer weights, uneven with weights
    ones = np.ones(len(x["w_pts"]), np.float32)
    for backend in ("dense", "compact"):
        fit(f"weights/none/{backend}", x["w_pts"], x["w_init"],
            backend=backend)
        fit(f"weights/ones/{backend}", x["w_pts"], x["w_init"],
            backend=backend, sample_weight=ones)
    fit("weights/int", x["w_pts"], x["w_init"], backend="compact",
        sample_weight=x["w"])
    fit("weights/uneven", x["w_pts"][:4001], x["wu_init"],
        backend="compact", sample_weight=x["w"][:4001])
    # tuning: the stored |s8 entry (put there before the world started)
    tkw = dict(KW, max_iters=30)
    out["tune/off"] = _res(distributed_yinyang(
        x["w_pts"], x["w_init"], mesh, tune="off", **tkw))
    r, st = distributed_yinyang(x["w_pts"], x["w_init"], mesh, tune="auto",
                                return_stats=True, **tkw)
    out["tune/auto"] = _res(r)
    out["tune/config"] = EngineConfig.from_dict(st.config)
    r, st = distributed_yinyang(x["p_pts"], x["p_init"], mesh, tune="force",
                                return_stats=True, **dict(KW, max_iters=3))
    sig = tune.signature(len(x["p_pts"]) // world, x["p_init"].shape[0],
                         x["p_pts"].shape[1], platform="cpu", shards=world)
    out["tune/force_entry"] = (sig, tune.default_cache().entry(sig),
                               EngineConfig.from_dict(st.config))
    out["mesh_error"] = _raises(lambda: make_mesh(world + 1), ValueError)
    if rank:
        return {"parity/compact/False": out["parity/compact/False"]}
    return out


def pair_world(rank, world, trees, residuals, inputs_path):
    """A world of 2: ``optim.compress_psum`` of this rank's tree and
    residual, and the integer-weighted compact fit."""
    from repro_torch.core import distributed_yinyang, make_mesh
    from repro_torch.optim import compress_psum
    tree = {k: torch.from_numpy(v) for k, v in trees[rank].items()}
    res = {k: torch.from_numpy(v) for k, v in residuals[rank].items()}
    summed, new_res = compress_psum(tree, res)
    x = dict(np.load(inputs_path))
    fit = distributed_yinyang(x["w_pts"], x["w_init"], make_mesh(world),
                              backend="compact", sample_weight=x["w"], **KW)
    return {"compress_psum": ({k: v.numpy() for k, v in summed.items()},
                              {k: v.numpy() for k, v in new_res.items()}),
            "weights/int": _res(fit)}


def card_pair(rank, world, pts, init):
    """A compact sharded fit on the card (``device=None``: rank r on
    ``cuda:(r % count)``), with this rank's ``centroid_update``
    launches."""
    import importlib
    from repro_torch.core import distributed_yinyang, make_mesh
    cu = importlib.import_module("repro_torch.kernels.centroid_update")
    before = cu.centroid_update.launches
    r = distributed_yinyang(pts, init, make_mesh(world), backend="compact",
                            max_iters=40, tol=1e-5)
    out = _res(r)
    out["device"] = str(r.centroids.device)
    out["launches"] = cu.centroid_update.launches - before
    return out


def failing_rank(rank, world, pid_dir):
    """Records its pid; rank 1 raises while rank 0 waits in a barrier
    that rank 1 never reaches."""
    import torch.distributed as dist
    with open(os.path.join(pid_dir, f"pid{rank}"), "w") as fh:
        fh.write(str(os.getpid()))
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def late_rank(rank, world, pid_dir):
    """Records its pid and sleeps far past any deadline a test sets,
    outside every collective."""
    import time
    with open(os.path.join(pid_dir, f"pid{rank}"), "w") as fh:
        fh.write(str(os.getpid()))
    time.sleep(120)


# -- the sharded stream (tests/test_torch_distributed_stream.py) -------------

def _fixed_seeds(skm, seeds):
    """Make ``skm`` seed with the given (K, D) centroids (JAX's k-means++
    draw, made in the test process) whatever its buffer."""
    skm._seed_centroids = lambda points, weights: torch.from_numpy(
        np.array(seeds, np.float32))
    return skm


def _stream_run(skm, stream, epochs, pts_all, weights=False, start=0,
                stop=None):
    """Drive ``skm`` over ``stream``'s global batches ``[start, stop)``
    (default: ``epochs`` passes) and record what the tests compare."""
    stop = epochs * len(stream) if stop is None else stop
    first = None
    for step in range(start, stop):
        b = stream.global_batch(step)
        w = np.ones(len(b["points"]), np.float32) if weights else None
        skm.partial_fit(b["points"], shard_id=b["shard_id"],
                        sample_weight=w)
        if first is None and skm.initialized:
            first = (skm.labels_.copy(), skm.stats_.distance_evals)
    return dict(stats=skm.stats_.to_dict(), first_labels=first[0],
                first_evals=first[1], centroids=skm.cluster_centers_.copy(),
                counts=skm.counts_.copy(),
                ledger=(skm._ledger.centroid.copy(),
                        skm._ledger.group.copy()),
                inertia=float(skm.inertia_of(pts_all)))


def _one_batch(mesh, x):
    """One first visit and one revisit through
    ``make_stream_update_sharded``/``make_stream_bounds_sharded`` on this
    rank's rows of the inputs ``x['b_*']``; assignments gathered."""
    from repro_torch.core import distributed as dist_
    from repro_torch.core import engine
    rank, shards = dist_.mesh_rank(mesh), dist_._mesh_shards(mesh, ("data",))
    group = dist_._group(mesh, ("data",))
    pts = x["b_pts"]
    n = len(pts) // shards
    sl = slice(rank * n, (rank + 1) * n)
    k, g = x["b_init"].shape[0], int(x["b_g"])
    t = {key: torch.from_numpy(np.array(x[key])) for key in
         ("b_pts", "b_init", "b_counts", "b_groups", "b_assign", "b_ub",
          "b_lb")}
    members, gsize = engine.build_group_tables(x["b_groups"], g, "cpu")
    decay = float(x["b_decay"])
    out = {}

    def run(name, cap_n, cap_g, assign, ub_t, lb, need, gmax):
        upd = dist_.make_stream_update_sharded(
            mesh, ("data",), k=k, n_groups=g, cap_n=cap_n, cap_g=cap_g)
        o = upd(t["b_pts"][sl], t["b_init"], t["b_counts"], decay,
                t["b_groups"], members, gsize, assign, ub_t, lb, need,
                gmax=gmax)
        out[name] = dict(
            assignments=dist_._gather(o.assignments, group, shards).numpy(),
            pairs=int(o.pairs), gmax=int(o.gmax),
            centroids=o.centroids.numpy(), counts=o.counts.numpy(),
            batch_cost=float(o.batch_cost))

    run("first", n, g, torch.zeros((n,), dtype=torch.int32),
        torch.full((n,), float("inf")), torch.zeros((n, g)),
        torch.ones((n,), dtype=torch.bool), g)
    bounds = dist_.make_stream_bounds_sharded(mesh)
    ub_t, need, n_cand, tight, gmax = bounds(
        t["b_pts"][sl], t["b_init"], t["b_assign"][sl], t["b_ub"][sl],
        t["b_lb"][sl])
    cap_n = engine._bucket_cap(n_cand, 1, n)
    run("revisit", cap_n, int(x["b_capg"]), t["b_assign"][sl], ub_t,
        t["b_lb"][sl], need, gmax)
    out["revisit"].update(n_cand=n_cand, tightened=tight, cap_n=cap_n)
    return out


def sharded_streams(rank, world, inputs_path):
    """The world of 8: the 997-point stream sharded under the reference's
    cap rule, as the port is, and with weights of 1.0; and one batch
    through the sharded step factories."""
    from _torch_cap import _reference_left_at
    from repro_torch.core import engine, make_mesh
    from repro_torch.data import PointStream
    from repro_torch.streaming import StreamingKMeans
    x = dict(np.load(inputs_path))
    mesh = make_mesh(world)
    stream = PointStream(**STREAM)
    pts_all = np.concatenate([stream.shard(i) for i in range(len(stream))])

    def sharded(**kw):
        skm = _fixed_seeds(StreamingKMeans(8, seed=3, mesh=mesh,
                                           device="cpu"), x["seeds"])
        return _stream_run(skm, stream, 3, pts_all, **kw)

    out = {}
    own_left_at = engine._left_at
    engine._left_at = _reference_left_at
    try:
        out["cap"] = sharded()
    finally:
        engine._left_at = own_left_at
    out["own"] = sharded()
    out["ones"] = sharded(weights=True)
    out["batch"] = _one_batch(mesh, x)
    return out


STREAM = dict(shard_size=997, n_shards=4, n_dims=16, k=8, seed=3)
GROW = dict(shard_size=256, n_shards=4, n_dims=8, k=8, seed=11)
SHRINK = dict(shard_size=256, n_shards=4, n_dims=8, k=8, seed=13)


def elastic_world(rank, world, inputs_path, jax_ckpt, tmp):
    """The world of 4: a 1-rank mesh against the local stream, a rank
    outside the mesh, the reference's elastic grow and shrink (and the
    same-mesh crash recovery), a JAX 2-shard checkpoint restored into 4
    ranks, and the sharded tuning search through distributed_yinyang."""
    import torch.distributed as dist
    from repro_torch import tune
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import distributed as dist_
    from repro_torch.core import distributed_yinyang, make_mesh
    from repro_torch.core.engine import EngineConfig
    from repro_torch.data import PointStream
    from repro_torch.runtime import FailureInjector
    from repro_torch.streaming import StreamingKMeans
    x = dict(np.load(inputs_path))
    m1, m2, m4 = make_mesh(1), make_mesh(2), make_mesh(4)
    out = {}

    # (5) a 1-rank mesh is the local stream, bit for bit
    if rank == 0:
        stream = PointStream(**STREAM)
        pts_all = np.concatenate([stream.shard(i) for i in range(4)])
        out["mesh1"] = _stream_run(_fixed_seeds(StreamingKMeans(
            8, seed=3, mesh=m1, device="cpu"), x["seeds"]), stream, 3,
            pts_all)
        out["local"] = _stream_run(_fixed_seeds(StreamingKMeans(
            8, seed=3, device="cpu"), x["seeds"]), stream, 3, pts_all)
    # a rank outside the mesh is refused by name
    if rank >= 2:
        out["outside"] = [
            _raises(lambda: distributed_yinyang(
                x["t_pts"], x["t_init"], m2, device="cpu"), ValueError),
            _raises(lambda: StreamingKMeans(8, mesh=m2, device="cpu"),
                    ValueError),
            _raises(lambda: dist_.make_stream_bounds_sharded(m2),
                    ValueError)]
    dist.barrier()

    # (7) grow: a 2-rank resilient stream with one failure, then its
    # step-8 checkpoint restored into 4 ranks and into one device
    writes = []
    save = ckpt.save_checkpoint

    def counting_save(*a, **kw):
        writes.append(a[1])
        return save(*a, **kw)

    ckpt.save_checkpoint = counting_save
    grow = PointStream(**GROW)
    g_pts = np.concatenate([grow.shard(i) for i in range(4)])
    d_grow = os.path.join(tmp, "grow")
    if rank < 2:
        full = StreamingKMeans(8, seed=1, mesh=m2, device="cpu")
        full.fit_stream(grow, epochs=3)
        rec = StreamingKMeans(8, seed=1, mesh=m2, device="cpu")
        rec.fit_stream(grow, epochs=3, resilient=True, ckpt_dir=d_grow,
                       ckpt_every=4, injector=FailureInjector(fail_at=(9,)))
        out["grow/full"] = (full.cluster_centers_, full.counts_,
                            float(full.inertia_of(g_pts)))
        out["grow/recovered"] = (rec.cluster_centers_, rec.counts_,
                                 rec.stats_.to_dict())
    out["grow/writes"] = list(writes)
    ckpt.save_checkpoint = save
    dist.barrier()
    sk4, step = StreamingKMeans.restore(d_grow, step=8, mesh=m4,
                                        device="cpu")
    _stream_run(sk4, grow, 3, g_pts, start=8, stop=12)
    out["grow/4"] = (step, float(sk4.inertia_of(g_pts)),
                     sk4.stats_.to_dict(), sk4.cluster_centers_)
    if rank == 0:
        sk1, _ = StreamingKMeans.restore(d_grow, step=8, device="cpu")
        _stream_run(sk1, grow, 3, g_pts, start=8, stop=12)
        out["grow/1"] = float(sk1.inertia_of(g_pts))

    # (7) shrink: a 4-rank checkpoint restored into 2 ranks
    shrink = PointStream(**SHRINK)
    s_pts = np.concatenate([shrink.shard(i) for i in range(4)])
    d_shrink = os.path.join(tmp, "shrink")
    full = StreamingKMeans(8, seed=2, mesh=m4, device="cpu")
    full.fit_stream(shrink, epochs=3)
    out["shrink/full"] = float(full.inertia_of(s_pts))
    StreamingKMeans(8, seed=2, mesh=m4, device="cpu").fit_stream(
        shrink, epochs=2, resilient=True, ckpt_dir=d_shrink, ckpt_every=4)
    if rank < 2:
        sk2, step = StreamingKMeans.restore(d_shrink, mesh=m2, device="cpu")
        _stream_run(sk2, shrink, 3, s_pts, start=8, stop=12)
        out["shrink/2"] = (step, float(sk2.inertia_of(s_pts)))

    # (8) JAX's 2-shard checkpoint, continued by 4 ranks of the port
    skj, step = StreamingKMeans.restore(jax_ckpt, step=8, mesh=m4,
                                        device="cpu")
    _stream_run(skj, grow, 3, g_pts, start=8, stop=12)
    out["jax_ckpt/4"] = (step, float(skj.inertia_of(g_pts)))

    # (9) the sharded search through distributed_yinyang, on a miss of |s4
    os.environ[tune.ENV_VAR] = os.path.join(tmp, "tune.json")
    tune.set_default_cache(None)
    searches = []
    autotune = tune.autotune

    def counting_autotune(*a, **kw):
        searches.append(kw.get("shards"))
        return autotune(*a, **kw)

    tune.autotune = counting_autotune
    kw = dict(max_iters=20, tol=1e-5, device="cpu")
    r_off = distributed_yinyang(x["t_pts"], x["t_init"], m4, tune="off",
                                **kw)
    _, st = distributed_yinyang(x["t_pts"], x["t_init"], m4, tune="force",
                                return_stats=True, **kw)
    distributed_yinyang(x["t_pts"], x["t_init"], m4, tune="force", **kw)
    r_auto, st_auto = distributed_yinyang(
        x["t_pts"], x["t_init"], m4, tune="auto", return_stats=True, **kw)
    tune.autotune = autotune
    sig = tune.signature(len(x["t_pts"]) // 4, x["t_init"].shape[0],
                         x["t_pts"].shape[1], platform="cpu", shards=4)
    out["tune"] = dict(
        searches=searches, sig=sig, entry=tune.default_cache().entry(sig),
        force=EngineConfig.from_dict(st.config),
        auto=EngineConfig.from_dict(st_auto.config),
        labels_off=r_off.assignments.numpy(),
        labels_auto=r_auto.assignments.numpy())
    return out


def card_stream(mesh):
    """Three epochs of a 6-shard stream on the card (``device=None``),
    sharded over ``mesh`` or on one device; with this rank's
    ``centroid_update`` launches."""
    import importlib
    from repro_torch.data import PointStream
    from repro_torch.streaming import StreamingKMeans
    cu = importlib.import_module("repro_torch.kernels.centroid_update")
    ps = PointStream(shard_size=4096, n_shards=6, n_dims=16, k=32, seed=3)
    pts = np.concatenate([ps.shard(s) for s in range(ps.n_shards)])
    skm = StreamingKMeans(32, n_groups=4, seed=0, tune="off", mesh=mesh)
    skm._seed_centroids = lambda p, w: p[::128][:32].clone()
    before = cu.centroid_update.launches
    first = None
    for sid, batch in ps.batches(3):
        skm.partial_fit(batch, shard_id=sid)
        if first is None:
            first = skm.labels_.copy()
    return dict(stats=skm.stats_.to_dict(), first=first,
                device=str(skm._centroids.device),
                launches=cu.centroid_update.launches - before,
                centroids=skm.cluster_centers_, counts=skm.counts_,
                inertia=float(skm.inertia_of(pts)))


def card_stream_pair(rank, world):
    """:func:`card_stream` sharded over a mesh of the world."""
    from repro_torch.core import make_mesh
    return card_stream(make_mesh(world))
