"""The port's streaming K-means (``repro_torch.streaming``, the engine's
``stream_bounds``/``stream_step``/``EMA_UPDATE`` and
``KMeans.partial_fit``) against the JAX package's, on the CPU.

``jax.random`` cannot be reproduced, so each port estimator is handed
JAX's starting centroids: its seeding method draws JAX's k-means++ over
the very buffer it was given (:func:`_jax_seeds`). What must agree, and
how closely:

* one ``stream_bounds`` and one ``stream_step`` on the same inputs:
  labels, pair count, ``gmax``, ``batch_counts``, the candidate and
  tightening counts exactly; centroids, counts, bounds, drift and the
  batch cost to rtol 1e-5 (atol 1e-5; sums run in another order than
  XLA's);
* whole streams over a few shards and three epochs: the first epoch's
  labels exactly (batch by batch), cache hits and misses, reseeds and
  drift resets equal, centroids and counts to 1e-4, ``distance_evals``
  to the 5e-2 of ``test_engine_fit_matches_jax`` (another summation
  order flips a few of the pass's ``changed`` comparisons, ROADMAP
  Queue 3 item 1), with the port under the reference's cap rule
  (``tests/_torch_cap.py``); the port as it is gives the same labels,
  centroids and counts bit for bit with no more evals.

Bound soundness, the reference's Hypothesis property, runs as fixed
parametrised cases, also through the estimator after drift, reseeds,
drift resets and adopted centroids.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KMeans as JaxKMeans
from repro.core import engine as jengine
from repro.core import kmeans_plusplus as jax_kmeans_plusplus
from repro.core.kmeans import group_centroids as jax_group_centroids
from repro.data import PointStream as JaxPointStream
from repro.data import make_points
from repro.obs import MetricsRegistry as JaxRegistry
from repro.serve import CentroidIndex as JaxIndex
from repro.streaming import StreamingKMeans as JaxStreamingKMeans
from repro_torch import KMeans, NotFittedError, tune
from repro_torch.core import engine
from repro_torch.checkpoint import save_checkpoint
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import CentroidIndex
from repro_torch.data import PointStream
from repro_torch.streaming import StreamingKMeans, inflate_bounds
from repro_torch.streaming.estimator import _fetch_step
from _torch_cap import reference_cap

EVALS_RTOL = 5e-2
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _tmp_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(tune.ENV_VAR, str(tmp_path / "tune.json"))
    tune.set_default_cache(None)
    yield
    tune.set_default_cache(None)


def _jax_seeds(est):
    """Make ``est`` seed with JAX's k-means++ draw over its own buffer
    (the call JAX's estimator makes, with its ``PRNGKey(seed)``)."""
    def seed(points, weights):
        init = jax_kmeans_plusplus(
            jax.random.PRNGKey(est.seed), jnp.asarray(points.numpy()),
            est.n_clusters,
            weights=None if weights is None else jnp.asarray(
                weights.numpy()))
        return torch.from_numpy(np.asarray(init))
    est._seed_centroids = seed
    return est


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


# -- one step against JAX's --------------------------------------------------

def _step_inputs(n, d, k, g, seed):
    pts, _, _ = make_points(n, d, k, seed=seed)
    init = np.asarray(jax_kmeans_plusplus(jax.random.PRNGKey(seed + 1),
                                          jnp.asarray(pts), k))
    groups_np = np.asarray(jax_group_centroids(jnp.asarray(init), g))
    counts = np.random.default_rng(seed).uniform(0, 20, k).astype(np.float32)
    counts[0] = 0.0                     # a centroid with no carried mass
    return pts, init, groups_np, counts


def _tables(groups_np, g):
    members, gsize = engine.build_group_tables(groups_np, g, "cpu")
    jm, jg = jengine.build_group_tables(groups_np, g)
    return (torch.from_numpy(groups_np.astype(np.int32)), members, gsize,
            jnp.asarray(groups_np.astype(np.int32)), jm, jg)


def _run_step(pts, cents, counts, decay, tabs, assign, ub, lb, need, w, *,
              k, g, cap_n, cap_g, gmax):
    groups, members, gsize, jgroups, jm, jgs = tabs
    t = engine.stream_step(
        torch.from_numpy(pts), torch.from_numpy(cents),
        torch.from_numpy(counts), decay, groups, members, gsize,
        torch.from_numpy(assign), torch.from_numpy(ub), torch.from_numpy(lb),
        torch.from_numpy(need), None if w is None else torch.from_numpy(w),
        core=engine.PassCore(backend="compact", k=k, n_groups=g,
                             cap_n=cap_n, cap_g=cap_g), gmax=gmax)
    j = jengine.stream_step(
        jnp.asarray(pts), jnp.asarray(cents), jnp.asarray(counts),
        jnp.float32(decay), jgroups, jm, jgs, jnp.asarray(assign),
        jnp.asarray(ub), jnp.asarray(lb), jnp.asarray(need),
        None if w is None else jnp.asarray(w),
        core=jengine.PassCore(backend="compact", k=k, n_groups=g,
                              cap_n=cap_n, cap_g=cap_g))
    return t, j


def _assert_step_equal(t, j, pts, cents, a_old, groups_np):
    """Labels, pairs, ``gmax`` and ``batch_counts`` exactly; centroids,
    counts, drift and the batch cost to rtol 1e-5. The bounds are square
    roots of the expanded form ``x2 - 2 x.c + c2``, whose error is
    relative to the norms (a point that is its own centroid's seed
    lands at 0 on one side and at 1e-2 on the other): as in
    ``test_torch_engine.assert_pass_bounds``, the pass's distances
    (``ub`` less the drift) are compared in squares to 1e-5 of the
    norms, and a lower bound, clamped at 0 after the drift, to the
    square root of that; it may also differ where the two sides'
    ``changed`` flag differs for a point whose best candidate is its own
    centroid (ROADMAP Queue 3 item 1)."""
    a_new = t.assignments.numpy()
    np.testing.assert_array_equal(a_new, np.asarray(j.assignments))
    assert int(t.pairs) == int(float(j.pairs))
    assert int(t.gmax) == int(j.gmax)
    np.testing.assert_array_equal(t.batch_counts.numpy(),
                                  np.asarray(j.batch_counts))
    for a, b in ((t.centroids, j.centroids), (t.counts, j.counts),
                 (t.drift, j.drift), (t.gdrift, j.gdrift)):
        _close(a.numpy(), b)
    _close(float(t.batch_cost), float(j.batch_cost))
    atol2 = 1e-5 * (float((pts * pts).sum(1).max())
                    + float((cents * cents).sum(1).max()))
    dt = t.ub.numpy() - t.drift.numpy()[a_new]
    dj = np.asarray(j.ub) - np.asarray(j.drift)[a_new]
    np.testing.assert_allclose(dt ** 2, dj ** 2, rtol=0, atol=atol2)
    lt, lj = t.lb.numpy(), np.asarray(j.lb)
    np.testing.assert_array_equal(np.isinf(lt), np.isinf(lj))
    flip = np.zeros(lt.shape, bool)
    kept = np.nonzero(a_new == a_old)[0]
    flip[kept, groups_np[a_old[kept]]] = True
    fin = np.isfinite(lt)
    close = ~fin | (np.abs(np.where(fin, lt, 0) - np.where(fin, lj, 0))
                    <= np.sqrt(atol2))
    assert (close | flip).all()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n,d,k,g", [(600, 8, 16, 4), (513, 5, 64, 16)])
def test_stream_bounds_and_step_match_jax(n, d, k, g, weighted):
    """A first visit (vacuous bounds, every point a candidate), then a
    revisit of the same shard on bounds carried from it, loosened so a
    third of the points stay candidates: ``stream_bounds`` and
    ``stream_step`` on both sides."""
    pts, init, groups_np, counts = _step_inputs(n, d, k, g, seed=3)
    tabs = _tables(groups_np, g)
    w = None if not weighted else np.random.default_rng(1).uniform(
        0.5, 2.0, n).astype(np.float32)
    decay = 0.9
    t1, j1 = _run_step(
        pts, init, counts, decay, tabs, np.zeros(n, np.int32),
        np.full(n, np.inf, np.float32), np.zeros((n, g), np.float32),
        np.ones(n, bool), w, k=k, g=g, cap_n=n, cap_g=g, gmax=g)
    _assert_step_equal(t1, j1, pts, init, np.zeros(n, np.int32), groups_np)

    # the revisit, from JAX's carry on both sides
    cents, cnt = np.asarray(j1.centroids), np.asarray(j1.counts)
    assign = np.asarray(j1.assignments)
    ub_c = np.asarray(j1.ub) * 1.05 + 0.05
    lb_c = np.asarray(j1.lb) * 0.7
    tb = engine.stream_bounds(torch.from_numpy(pts), torch.from_numpy(cents),
                              torch.from_numpy(assign), torch.from_numpy(ub_c),
                              torch.from_numpy(lb_c))
    jb = jengine.stream_bounds(jnp.asarray(pts), jnp.asarray(cents),
                               jnp.asarray(assign), jnp.asarray(ub_c),
                               jnp.asarray(lb_c))
    _close(tb[0].numpy(), jb[0])
    np.testing.assert_array_equal(tb[1].numpy(), np.asarray(jb[1]))
    assert int(tb[2]) == int(jb[2]) and int(tb[3]) == int(float(jb[3]))
    n_cand = int(tb[2])
    assert 0 < n_cand < n
    gmax = int(engine.pending_gmax(tb[1], tb[0], torch.from_numpy(lb_c)))
    cap_n = engine._bucket_cap(n_cand, 1, n)
    cap_g = engine._bucket_cap(max(int(j1.gmax) // 4, 1), 1, g)
    t2, j2 = _run_step(pts, cents, cnt, decay, tabs, assign,
                       np.asarray(jb[0]), lb_c, np.asarray(jb[1]), w, k=k,
                       g=g, cap_n=cap_n, cap_g=cap_g, gmax=gmax)
    _assert_step_equal(t2, j2, pts, cents, assign, groups_np)


def test_stream_step_empty_group_drift_is_finite():
    """An empty group's drift is ``-inf`` from ``segment_max``; left
    unclamped it would poison the cumulative drift ledger (inf - inf =
    NaN on the next inflation). ``EMA_UPDATE`` clamps it."""
    rng = np.random.default_rng(0)
    k, g, b, d = 4, 2, 32, 3
    pts = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    groups_np = np.zeros((k,), np.int64)            # group 1 is EMPTY
    members, gsize = engine.build_group_tables(groups_np, g, "cpu")
    core = engine.PassCore(backend="compact", k=k, n_groups=g,
                           cap_n=b, cap_g=g)
    out = engine.stream_step(
        pts, c, torch.zeros(k), 1.0, torch.zeros(k, dtype=torch.int32),
        members, gsize, torch.zeros(b, dtype=torch.int32),
        torch.full((b,), float("inf")), torch.zeros((b, g)),
        torch.ones(b, dtype=torch.bool), core=core)
    assert bool(torch.isfinite(out.gdrift).all())
    assert bool((out.gdrift >= 0).all())
    # the batch rule keeps the -inf (a vacuous bound there)
    mv = engine.move_and_bounds(pts, c, out.assignments, out.ub, out.lb,
                                torch.zeros(k, dtype=torch.int32), k=k,
                                n_groups=g)
    assert float(mv.gdrift[1]) == float("-inf")


@pytest.mark.parametrize("decay", [1.0, 0.9, 0.25])
def test_ema_update_matches_jax(decay):
    rng = np.random.default_rng(7)
    k, d = 12, 5
    sums = rng.standard_normal((k, d)).astype(np.float32) * 10
    counts = rng.integers(0, 5, k).astype(np.float32)
    cents = rng.standard_normal((k, d)).astype(np.float32)
    carry = rng.uniform(0, 3, k).astype(np.float32)
    carry[:3] = 0.0                       # with counts[i] == 0: kept
    counts[:2] = 0.0
    got = engine.EMA_UPDATE.apply(
        torch.from_numpy(sums), torch.from_numpy(counts),
        torch.from_numpy(cents), torch.from_numpy(carry),
        torch.tensor(decay, dtype=torch.float32))
    want = jengine.EMA_UPDATE.apply(
        jnp.asarray(sums), jnp.asarray(counts), jnp.asarray(cents),
        jnp.asarray(carry), jnp.float32(decay))
    _close(got[0].numpy(), want[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0][:2].numpy(), cents[:2])
    assert engine.EMA_UPDATE.clamp_gdrift
    assert not engine.CONVERGENCE_UPDATE.clamp_gdrift


def _old_move_and_bounds(points, centroids, assignments, ub, lb, groups, *,
                         k, n_groups, weights=None, x2=None, refresh=True):
    """``move_and_bounds`` as it was before the update rules took
    carried counts: the batch fit's yardstick."""
    from repro_torch.core.kmeans import (centroid_sums, centroids_from_sums,
                                         segment_max)
    from repro_torch.core.distances import row_norms_sq, rowwise_dists
    a = assignments.long()
    sums, bcounts = centroid_sums(points, assignments, k, weights=weights)
    new_c = centroids_from_sums(sums, bcounts, centroids)
    new_c2 = row_norms_sq(new_c)
    drift = torch.sqrt(torch.sum((new_c - centroids) ** 2, dim=-1))
    group_drift = segment_max(drift, groups, n_groups)
    shift = torch.max(drift)
    ub = ub + drift[a]
    lb_dec = torch.clamp_min(lb - group_drift[None, :], 0.0)
    glb = torch.min(lb_dec, dim=1).values
    maybe = ub > glb
    if refresh:
        if x2 is None:
            d_own = rowwise_dists(points, new_c[a])
        else:
            d_own = torch.sqrt(torch.clamp_min(
                x2 - 2.0 * torch.sum(points * new_c[a], dim=-1)
                + new_c2[a], 0.0))
        ub_t = torch.where(maybe, d_own, ub)
        need = ub_t > glb
    else:
        ub_t, need = ub, maybe
    return (new_c, new_c2, bcounts, ub_t, lb_dec, need, shift, maybe.sum(),
            drift, group_drift)


@pytest.mark.parametrize("refresh", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("x2", [False, True])
def test_convergence_update_is_the_old_move_bit_for_bit(refresh, weighted,
                                                        x2):
    rng = np.random.default_rng(11)
    n, d, k, g = 700, 6, 20, 5
    pts = torch.from_numpy(make_points(n, d, k, seed=4)[0])
    cents = pts[::35][:k].clone()
    groups = torch.from_numpy((np.arange(k) % g).astype(np.int32))
    groups[g:2 * g] = 0                   # group sizes differ
    assign = torch.from_numpy(rng.integers(0, k - 1, n).astype(np.int32))
    ub = torch.from_numpy(rng.uniform(0, 5, n).astype(np.float32))
    lb = torch.from_numpy(rng.uniform(0, 5, (n, g)).astype(np.float32))
    kw = dict(k=k, n_groups=g, refresh=refresh,
              weights=torch.from_numpy(rng.uniform(0.5, 2, n).astype(
                  np.float32)) if weighted else None,
              x2=(pts * pts).sum(1) if x2 else None)
    want = _old_move_and_bounds(pts, cents, assign, ub, lb, groups, **kw)
    for got in (engine.move_and_bounds(pts, cents, assign, ub, lb, groups,
                                       **kw),
                engine.move_and_bounds(pts, cents, assign, ub, lb, groups,
                                       update=engine.CONVERGENCE_UPDATE,
                                       counts=torch.ones(k), decay=0.5,
                                       **kw)):
        for a, b in zip(got[:10], want):
            assert torch.equal(a, b)
        assert torch.equal(got.batch_counts, want[2])


def test_fetch_step_keeps_every_bit():
    b, g, k = 5, 3, 4
    ub = torch.tensor([0.0, -0.0, float("inf"), 1e-40, 3.25])
    lb = torch.tensor([[float("inf"), 2.0, 1e-45]] * b)
    lb[1, 1] = float("nan")
    out = engine.StreamStepOut(
        torch.zeros((k, 2)), torch.zeros(k),
        torch.tensor([0, 3, 2, 1, 3], dtype=torch.int32), ub, lb,
        torch.tensor((1 << 40) + 3), torch.tensor(2, dtype=torch.int64),
        torch.arange(k, dtype=torch.float32) / 3, torch.ones(g) * 0.1,
        torch.tensor([2.0, 0.0, 1.5, 7.0]), torch.tensor(12.5))
    nas, ub_h, lb_h, pairs, gmax, drift, gdrift, bc, cost = _fetch_step(
        out, b, g)
    np.testing.assert_array_equal(nas, out.assignments.numpy())
    assert ub_h.tobytes() == ub.numpy().tobytes()
    assert lb_h.tobytes() == lb.numpy().tobytes()
    assert (pairs, gmax, cost) == ((1 << 40) + 3, 2, 12.5)
    for h, t in ((drift, out.drift), (gdrift, out.gdrift),
                 (bc, out.batch_counts)):
        assert h.tobytes() == t.numpy().tobytes()


# -- whole streams against JAX's ---------------------------------------------

def _pair(k, **kw):
    j = JaxStreamingKMeans(k, tune="off", **kw)
    t = _jax_seeds(StreamingKMeans(k, tune="off", **CPU, **kw))
    return j, t


STREAMS = [
    # k, d, true k, groups, decay, weighted, extra estimator arguments;
    # "outliers": the cold start sees a far cluster that never returns,
    # whose centroids die and are re-seeded
    (16, 8, 16, None, 1.0, False, {}),
    (12, 6, 6, 4, 0.9, False, {"reseed_patience": 1, "outliers": True}),
    (16, 16, 16, 1, 1.0, True, {}),
    (12, 4, 6, 3, 0.8, False, {"drift_reset_factor": 0.02}),
]


@pytest.mark.parametrize("k,d,true_k,g,decay,weighted,extra", STREAMS)
def test_stream_matches_jax(k, d, true_k, g, decay, weighted, extra):
    extra = dict(extra)
    outliers = extra.pop("outliers", False)
    kw = dict(shard_size=256, n_shards=5, n_dims=d, k=true_k, seed=7)
    ps, js = PointStream(**kw), JaxPointStream(**kw)
    j, t = _pair(k, n_groups=g, decay=decay, seed=2, **extra)
    # t runs under the reference's cap rule (tests/_torch_cap.py), own
    # as the port is
    own = _jax_seeds(StreamingKMeans(k, tune="off", n_groups=g,
                                     decay=decay, seed=2, **CPU, **extra))
    sched = [(s, ps.shard(s)) for s in range(ps.n_shards)]
    if outliers:
        far = ps.shard(0).copy()
        far[:96] += 60.0
        sched = [(99, far)] + sched
    first = True
    for epoch in range(3):
        for sid, pts in sched if epoch == 0 else sched[-ps.n_shards:]:
            w = np.random.default_rng(sid).uniform(0.5, 2.0, 256).astype(
                np.float32) if weighted else None
            j.partial_fit(pts, shard_id=sid, sample_weight=w)
            with reference_cap():
                t.partial_fit(pts, shard_id=sid, sample_weight=w)
            own.partial_fit(pts, shard_id=sid, sample_weight=w)
            np.testing.assert_array_equal(own.labels_, t.labels_)
            if epoch == 0:
                np.testing.assert_array_equal(t.labels_, j.labels_)
                if first:           # the first batch: its pairs too
                    assert t.stats_.distance_evals == \
                        j.stats_.distance_evals
                    first = False
    st, sj = t.stats_, j.stats_
    for f in ("batches", "points_seen", "cache_hits", "cache_misses",
              "reseeds", "drift_resets", "init_batches"):
        assert getattr(st, f) == getattr(sj, f), f
    assert st.cache_hits == 2 * ps.n_shards - st.drift_resets
    assert abs(st.distance_evals - sj.distance_evals) <= \
        EVALS_RTOL * sj.distance_evals
    _close(t.cluster_centers_, j.cluster_centers_, rtol=1e-4, atol=1e-4)
    _close(t.counts_, j.counts_, rtol=1e-4, atol=1e-4)
    _close(t._ledger.centroid, j._ledger.centroid, rtol=1e-3, atol=1e-4)
    # a sum of upper bounds, each a point's exact distance or its carried
    # bound by the same filter comparisons that move distance_evals
    _close(t.ewa_inertia_, j.ewa_inertia_, rtol=1e-2)
    pts = np.concatenate([ps.shard(s) for s in range(ps.n_shards)])
    np.testing.assert_array_equal(t.predict(pts), j.predict(pts))
    _close(t.inertia_of(pts), j.inertia_of(pts), rtol=1e-4)
    if outliers:
        assert st.reseeds > 0
    if extra.get("drift_reset_factor"):
        assert st.drift_resets > 0
    # the port's own cap: the same stream bit for bit, no more work
    np.testing.assert_array_equal(own.cluster_centers_, t.cluster_centers_)
    np.testing.assert_array_equal(own.counts_, t.counts_)
    assert own.stats_.distance_evals <= st.distance_evals


def test_fit_stream_sources_match_jax():
    """A PointStream, a list of ``(shard_id, array)`` pairs and a
    generator of dicts with weights drive the same batches."""
    kw = dict(shard_size=128, n_shards=3, n_dims=4, k=4, seed=1)
    ps, js = PointStream(**kw), JaxPointStream(**kw)
    j, t = _pair(4, seed=0)
    j.fit_stream(js, epochs=2)
    t.fit_stream(ps, epochs=2)
    pairs = [(s, ps.shard(s)) for s in range(3)]
    j.fit_stream(pairs, epochs=2)
    t.fit_stream(pairs, epochs=2)
    rng = np.random.default_rng(0)
    ws = [rng.uniform(0.5, 2, 128).astype(np.float32) for _ in range(3)]

    def gen():
        for s in range(3):
            yield {"points": ps.shard(s), "shard_id": s,
                   "sample_weight": ws[s]}
    j.fit_stream(gen(), epochs=3)         # generators run once
    t.fit_stream(gen(), epochs=3)
    assert t.stats_.to_dict()["batches"] == j.stats_.batches == 15
    assert (t.stats_.cache_hits, t.stats_.cache_misses) == \
        (j.stats_.cache_hits, j.stats_.cache_misses)
    _close(t.cluster_centers_, j.cluster_centers_, rtol=1e-4, atol=1e-4)


def test_kmeans_partial_fit_matches_jax(monkeypatch):
    monkeypatch.setattr(StreamingKMeans, "_seed_centroids",
                        lambda self, p, w: torch.from_numpy(np.asarray(
                            jax_kmeans_plusplus(jax.random.PRNGKey(self.seed),
                                                jnp.asarray(p.numpy()),
                                                self.n_clusters))))
    pts, _, _ = make_points(1024, 8, 8, seed=2)
    jk, tk = JaxKMeans(n_clusters=8, seed=1), KMeans(n_clusters=8, seed=1,
                                                     **CPU)
    for sid in range(4):
        for _ in range(2):                   # every shard twice
            jk.partial_fit(pts[sid * 256:(sid + 1) * 256], shard_id=sid)
            tk.partial_fit(pts[sid * 256:(sid + 1) * 256], shard_id=sid)
            np.testing.assert_array_equal(tk.labels_,
                                          np.asarray(jk.labels_))
            assert tk.n_iter_ == jk.n_iter_
            assert abs(tk.distance_evals_ - jk.distance_evals_) <= \
                EVALS_RTOL * jk.distance_evals_
            _close(tk.inertia_, jk.inertia_, rtol=1e-4)
            _close(tk.cluster_centers_, jk.cluster_centers_, rtol=1e-4,
                   atol=1e-4)
    assert tk.n_iter_ == 8 and tk._stream.stats_.cache_hits == 4
    np.testing.assert_array_equal(tk.predict(pts), np.asarray(
        jk.predict(pts)))
    tk.fit(pts)                               # a batch fit supersedes it
    assert tk._stream is None and tk.labels_.shape == (1024,)


# -- the reference's single-device tests, ported -----------------------------

def test_stream_parity_with_batch_engine():
    pts, _, _ = make_points(4096, 16, 16, seed=0)
    init = KMeans(16, seed=1, **CPU)._init_centroids(torch.from_numpy(pts))
    r_b = engine.fit(pts, init, max_iters=50, tol=1e-4, backend="compact",
                     **CPU)
    stream = PointStream(shard_size=512, data=pts)
    skm = StreamingKMeans(16, seed=1, **CPU).fit_stream(stream, epochs=6)
    ratio = skm.inertia_of(pts) / float(r_b.inertia)
    assert ratio < 1.05
    # bound carry engaged: epochs 2+ hit the cache and the filtered pass
    # did well under dense mini-batch work
    assert skm.stats_.cache_hits >= stream.n_shards
    dense_equiv = skm.stats_.batches * 512 * 16
    assert skm.stats_.distance_evals < 0.8 * dense_equiv


def test_point_stream_prefetch_protocol():
    ps = PointStream(shard_size=64, n_shards=3, n_dims=4, k=2, seed=0)
    b = ps.global_batch(4)
    assert b["shard_id"] == 1
    np.testing.assert_array_equal(b["points"], ps.shard(1))
    # fit_stream takes the (step, dict) item shape
    skm = StreamingKMeans(2, init_size=64, **CPU)
    skm.fit_stream([(s, ps.global_batch(s)) for s in range(3)])
    assert skm.cluster_centers_.shape == (2, 4)
    assert skm.stats_.cache_misses >= 1


def test_not_fitted_before_first_partial_fit():
    skm = StreamingKMeans(8, **CPU)
    for attr in ("cluster_centers_", "counts_", "labels_"):
        with pytest.raises(NotFittedError):
            getattr(skm, attr)
    with pytest.raises(NotFittedError):
        skm.predict(np.zeros((4, 3), np.float32))
    with pytest.raises(NotFittedError):
        skm.inertia_of(np.zeros((4, 3), np.float32))
    with pytest.raises(NotFittedError):
        skm.adopt_centroids(np.zeros((8, 3), np.float32))


def test_cold_start_buffers_then_initializes():
    rng = np.random.default_rng(0)
    skm = StreamingKMeans(4, init_size=100, **CPU)
    skm.partial_fit(rng.standard_normal((40, 3)).astype(np.float32))
    assert not skm.initialized and skm.stats_.init_batches == 1
    with pytest.raises(NotFittedError):
        skm.cluster_centers_
    skm.partial_fit(rng.standard_normal((70, 3)).astype(np.float32))
    assert skm.initialized
    # buffered batches were replayed through the real step
    assert skm.stats_.batches == 2 and skm.stats_.points_seen == 110
    assert skm.cluster_centers_.shape == (4, 3)
    assert skm.predict(np.zeros((5, 3), np.float32)).shape == (5,)


def test_short_stream_flushes_into_an_init():
    rng = np.random.default_rng(1)
    skm = StreamingKMeans(4, init_size=1000, **CPU)
    skm.fit_stream([rng.standard_normal((30, 2)).astype(np.float32)
                    for _ in range(2)])
    assert skm.initialized and skm.stats_.batches == 2
    with pytest.raises(ValueError):
        StreamingKMeans(50, init_size=1000, **CPU).fit_stream(
            [np.zeros((10, 2), np.float32)])


def test_kmeans_api_partial_fit_delegates():
    pts, _, _ = make_points(1024, 8, 8, seed=2)
    km = KMeans(n_clusters=8, seed=1, **CPU)
    with pytest.raises(NotFittedError):
        km.labels_
    for sid in range(4):
        km.partial_fit(pts[sid * 256:(sid + 1) * 256], shard_id=sid)
    assert km.cluster_centers_.shape == (8, 8)
    assert km.n_iter_ == 4                     # batches, for the stream path
    assert km.predict(pts[:16]).shape == (16,)
    # a fresh batch fit supersedes the stream state
    km.fit(pts)
    assert km.labels_.shape == (1024,)


def test_decay_bounds_effective_counts():
    stream = PointStream(shard_size=256, n_shards=6, n_dims=4, k=4, seed=1)
    skm = StreamingKMeans(4, decay=0.9, seed=0, **CPU).fit_stream(
        stream, epochs=3)
    # decayed horizon: total effective count <= B/(1-decay) + one batch
    assert skm.counts_.sum() <= 256 / (1 - 0.9) + 256
    assert np.isfinite(skm.cluster_centers_).all()
    with pytest.raises(ValueError):
        StreamingKMeans(4, decay=0.0, **CPU)


def test_reseed_records_drift_and_keeps_bounds_valid():
    stream = PointStream(shard_size=256, n_shards=4, n_dims=4, k=4, seed=5)
    skm = StreamingKMeans(4, seed=0, **CPU).fit_stream(stream, epochs=2)
    before = skm.stats_.reseeds
    ledger_before = skm._ledger.centroid.copy()
    held = skm._centroids
    assert skm._far                       # reservoir populated by batches
    # patience is epoch-scaled: reseed_patience full passes unfed
    skm._since_hit[0] = skm.reseed_patience * len(skm._shards_seen)
    skm._maybe_reseed()
    assert skm.stats_.reseeds == before + 1
    assert skm._ledger.centroid[0] > ledger_before[0]
    assert not torch.equal(held, skm._centroids)   # a new tensor
    # the stream continues on the cached bounds (the reseed entered the
    # ledger as drift)
    skm.fit_stream(stream, epochs=1)
    assert np.isfinite(skm.inertia_of(stream.shard(0)))
    _assert_cache_valid(skm, stream)


def test_adopt_centroids_keeps_cached_bounds_valid():
    """Warm handover: adopted centroids enter the ledger as drift, so
    the stream continues on the old bound cache without violating a
    single triangle-inequality bound."""
    stream = PointStream(shard_size=256, n_shards=4, n_dims=8, k=8, seed=5)
    skm = StreamingKMeans(8, seed=2, **CPU).fit_stream(stream, epochs=2)
    led_before = skm._ledger.centroid.copy()
    rng = np.random.default_rng(0)
    skm.adopt_centroids(skm.cluster_centers_
                        + rng.standard_normal((8, 8)).astype(np.float32))
    assert np.all(skm._ledger.centroid >= led_before)
    _assert_cache_valid(skm, stream)
    hits_before = skm.stats_.cache_hits
    skm.fit_stream(stream, epochs=1)
    assert skm.stats_.cache_hits > hits_before   # the cache survived
    pts = np.concatenate([stream.shard(i) for i in range(4)])
    assert np.isfinite(skm.inertia_of(pts))
    with pytest.raises(ValueError):
        skm.adopt_centroids(np.zeros((7, 8), np.float32))


def _assert_cache_valid(skm, stream, tol=1e-3):
    """Every cached entry, inflated by the ledger, bounds the true
    distances to the current centroids: ub from above, each group's lb
    from below (the minimum without the assigned centroid)."""
    c = skm.cluster_centers_.astype(np.float64)
    groups = skm._groups_np
    assert len(skm._cache)
    for sid, e in skm._cache._d.items():
        x = stream.shard(sid).astype(np.float64)
        ub, lb = inflate_bounds(e, skm._ledger.centroid, skm._ledger.group)
        d = np.linalg.norm(x[:, None] - c[None], axis=-1)
        rows = np.arange(len(x))
        assert np.all(ub >= d[rows, e.assignments] - tol)
        d[rows, e.assignments] = np.inf
        for j in range(skm._g):
            if np.any(groups == j):
                assert np.all(lb[:, j] <= d[:, groups == j].min(1) + tol)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_cached_bounds_stay_valid_through_drift_reseeds_and_resets(seed):
    stream = PointStream(shard_size=128, n_shards=4, n_dims=4, k=5,
                         seed=seed)
    skm = StreamingKMeans(9, n_groups=3, seed=seed, decay=0.8,
                          drift_reset_factor=0.05, reseed_patience=1, **CPU)
    rng = np.random.default_rng(seed)
    for epoch in range(4):
        skm.fit_stream(stream, epochs=1)
        _assert_cache_valid(skm, stream)
        if epoch == 1:
            skm._since_hit[:2] = len(skm._shards_seen)
            skm._maybe_reseed()
            _assert_cache_valid(skm, stream)
        if epoch == 2:
            skm.adopt_centroids(skm.cluster_centers_ + 0.5 * rng.standard_normal(
                skm.cluster_centers_.shape).astype(np.float32))
            _assert_cache_valid(skm, stream)
    assert skm.stats_.reseeds >= 2 and skm.stats_.drift_resets > 0


def test_stream_obs_publishes_the_reference_metrics():
    kw = dict(shard_size=128, n_shards=3, n_dims=4, k=4, seed=0)
    rj, rt = JaxRegistry(), MetricsRegistry()
    j = JaxStreamingKMeans(4, seed=0, tune="off", obs=rj)
    t = _jax_seeds(StreamingKMeans(4, seed=0, tune="off", obs=rt, **CPU))
    j.fit_stream(JaxPointStream(**kw), epochs=2)
    t.fit_stream(PointStream(**kw), epochs=2)
    assert sorted(m.name for m in rt.metrics()) == \
        sorted(m.name for m in rj.metrics())
    ev_t = [e for e in rt.events if e["event"] == "stream_batch"]
    ev_j = [e for e in rj.events if e["event"] == "stream_batch"]
    assert len(ev_t) == len(ev_j) == 6
    for a, b in zip(ev_t, ev_j):
        assert set(a) == set(b)
        for f in ("batch", "size", "shard", "n_cand", "cache_hit",
                  "reseeds"):
            assert a[f] == b[f], f
    assert rt.counter("stream_points_total").value == 6 * 128


def test_attach_index_republishes_into_a_port_index():
    kw = dict(shard_size=128, n_shards=4, n_dims=4, k=4, seed=1)
    ps, js = PointStream(**kw), JaxPointStream(**kw)
    j, t = _pair(4, seed=0)
    idx, jidx = CentroidIndex(**CPU), JaxIndex()
    t.attach_index(idx, every=3)           # not live yet: nothing to publish
    j.attach_index(jidx, every=3)
    assert idx.publishes == 0
    t.fit_stream(ps, epochs=3)
    j.fit_stream(js, epochs=3)
    assert idx.publishes == jidx.publishes == 4    # batches 3, 6, 9, 12
    assert (idx.rebuilds, idx.reuses) == (jidx.rebuilds, jidx.reuses)
    snap = idx.acquire()
    np.testing.assert_array_equal(snap.centroids.numpy(),
                                  t.cluster_centers_)
    # attaching to a live estimator publishes at once; None detaches
    idx2 = CentroidIndex(**CPU)
    t.attach_index(idx2)
    assert idx2.publishes == 1
    t.attach_index(None)
    t.fit_stream(ps, epochs=1)
    assert idx.publishes == 4 and idx2.publishes == 1


def test_later_items_raise_with_their_roadmap_items(tmp_path):
    # item 7b has landed: its calls raise the reference's errors
    skm = StreamingKMeans(2, **CPU)
    with pytest.raises(NotFittedError):
        skm.save(tmp_path, 0)
    save_checkpoint(tmp_path, 1, [np.zeros(3)], meta={"format": "other"})
    with pytest.raises(ValueError, match="not a stream-state checkpoint"):
        skm.restore_state(tmp_path)
    with pytest.raises(ValueError, match="not a stream-state checkpoint"):
        StreamingKMeans.restore(tmp_path, **CPU)
    with pytest.raises(ValueError, match="global_batch"):
        skm.fit_stream([], resilient=True, ckpt_dir=tmp_path)
    # item 9b has landed: a mesh is validated, and the axes alone build
    # a single-device estimator
    with pytest.raises(ValueError, match="1-D mesh"):
        StreamingKMeans(2, mesh=object(), **CPU)
    with pytest.raises(ValueError, match="1-D mesh"):
        StreamingKMeans(2, mesh=object(), mesh_axes=("model",), **CPU)
    skm = StreamingKMeans(2, mesh_axes=("data",), **CPU)
    assert skm.mesh is None and skm.mesh_axes == ("data",)
    assert skm.partial_fit(np.eye(4, dtype=np.float32)).initialized
    if not torch.cuda.is_available():         # the default device
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamingKMeans(2)


def test_reset_state_returns_to_a_cold_start():
    stream = PointStream(shard_size=64, n_shards=2, n_dims=3, k=2, seed=0)
    skm = StreamingKMeans(2, seed=0, **CPU).fit_stream(stream, epochs=2)
    first = skm.cluster_centers_.copy()
    skm.reset_state()
    assert not skm.initialized and len(skm._cache) == 0
    assert skm.stats_.batches == 0 and skm.ewa_inertia_ is None
    skm.fit_stream(stream, epochs=2)
    np.testing.assert_array_equal(skm.cluster_centers_, first)
