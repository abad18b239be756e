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
    out["tune/force_error"] = _raises(
        lambda: distributed_yinyang(x["p_pts"], x["p_init"], mesh,
                                    tune="force", **KW),
        NotImplementedError)
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
