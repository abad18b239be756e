"""The port's compact backend against the JAX package's.

``engine.fit(..., backend="compact")``, ``compact_candidate_pass``,
``KMeans(engine="compact")`` and ``yinyang_compact`` on the CPU against
their JAX counterparts on the same numpy points and the same starting
centroids (JAX's k-means++ draw, or the port estimator's own draw fed to
JAX), with ``tune="off"`` on the JAX side. These are the compact cases
of ``tests/test_engine.py``, each at both settings of
``refresh_in_pass`` where the case is a whole fit.

What must agree, and how closely:

* labels and ``n_iters``: exactly;
* inertia: rtol 1e-5 (sums in another order than XLA's);
* ``distance_evals``: exactly for one pass on the same inputs, rtol
  5e-2 over a whole fit (ROADMAP Queue 3 item 1: that fit runs the
  port with the reference's cap rule, and the port as it is is held to
  it bit for bit with no more evals, ``tests/_torch_cap.py``), exactly
  where no filter decision compares two roundings of one distance (the
  zero-candidate fit);
* ``caps_history`` and the group-gather decisions: exactly, in every
  whole-fit case here. These are the cases where the per-iteration
  candidate counts agree closely enough with JAX's that every bucket
  exit falls on the same iteration. A count that differs by a few
  points can move an exit; then the caps would differ without either
  side being wrong, and such a case would hold the caps to its own
  Lloyd instead.

One case parts from JAX in ``n_iters``: at N = 6000, D = 16, K = 32 the
torch and XLA Lloyd loops themselves part at iteration 3 over a point
whose two nearest centroids tie to 7e-6 of their distance, and the fits
converge one iteration apart (10 against 11) to the same labels. The
test shows that tie and holds each side's compact fit to its own
Lloyd's ``n_iters`` there (ROADMAP Queue 3 item 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import kmeans as jkmeans
from repro.core import kmeans_plusplus, yinyang_compact as j_yinyang_compact
from repro.data import make_points
from repro_torch.core import engine, kmeans
from repro_torch.core.api import KMeans
from repro_torch.core.compact import yinyang_compact
from test_torch_engine import assert_pass_bounds
from _torch_cap import assert_same_fit_less_work, reference_cap

EVALS_RTOL = 5e-2
SHAPES = [               # tests/test_engine.py's, plus D=33
    (1000, 8, 12, 3),     # N % tile_n != 0
    (513, 5, 7, 2),       # ragged everything
    (768, 4, 8, 1),       # one group = Hamerly
    (2048, 12, 16, 16),   # one group per centroid: the group branch
    (1500, 33, 20, 4),    # D not a multiple of 8 or 32
]
REFRESH = [False, True]


def _dataset(n, d, k, seed=0):
    pts, _, _ = make_points(n, d, k, seed=seed)
    init = kmeans_plusplus(jax.random.PRNGKey(seed + 1), jnp.asarray(pts), k)
    return pts, np.array(init)


def _fits(pts, init, refresh_in_pass=False, **kw):
    """The same compact fit in both packages: ``(r_t, s_t, r_j, s_j)``."""
    r_j, s_j = jengine.fit(
        jnp.asarray(pts), jnp.asarray(init), backend="compact", tune="off",
        return_stats=True,
        config=jengine.EngineConfig(refresh_in_pass=refresh_in_pass), **kw)
    r_t, s_t = engine.fit(
        pts, init, backend="compact", device="cpu", return_stats=True,
        config=engine.EngineConfig(refresh_in_pass=refresh_in_pass), **kw)
    return r_t, s_t, r_j, s_j


def _assert_labels(r_t, r_j):
    np.testing.assert_array_equal(r_t.assignments.numpy(),
                                  np.asarray(r_j.assignments))
    np.testing.assert_allclose(float(r_t.inertia), float(r_j.inertia),
                               rtol=1e-5)


def _assert_parity(r_t, r_j, exact_evals=False):
    assert int(r_t.n_iters) == int(r_j.n_iters)
    _assert_labels(r_t, r_j)
    ev_t, ev_j = int(r_t.distance_evals), float(r_j.distance_evals)
    if exact_evals:
        assert ev_t == ev_j
    else:
        assert abs(ev_t - ev_j) <= EVALS_RTOL * ev_j, (ev_t, ev_j)


def _assert_same_buckets(s_t, s_j):
    assert s_t.backend == s_j.backend == "compact"
    assert s_t.caps_history == s_j.caps_history
    assert s_t.use_groups == s_j.use_groups
    assert s_t.bucket_switches == s_j.bucket_switches
    assert s_t.x2_evals == s_j.x2_evals == 1


@pytest.mark.parametrize("refresh_in_pass", REFRESH)
@pytest.mark.parametrize("n,d,k,g", SHAPES)
def test_compact_fit_matches_jax(n, d, k, g, refresh_in_pass):
    pts, init = _dataset(n, d, k)
    kw = dict(n_groups=g, max_iters=50, tol=1e-5, min_cap=64)
    with reference_cap():
        r_ref, s_ref, r_j, s_j = _fits(pts, init, refresh_in_pass, **kw)
    _assert_parity(r_ref, r_j)
    _assert_same_buckets(s_ref, s_j)
    r_t, s_t = engine.fit(
        pts, init, backend="compact", device="cpu", return_stats=True,
        config=engine.EngineConfig(refresh_in_pass=refresh_in_pass), **kw)
    assert_same_fit_less_work(r_t, r_ref)
    # one read of the exit scalars per iteration and the group table;
    # with the refresh in the pass, one gmax read per pass that may take
    # the group branch
    extra = s_t.host_syncs - (r_t.n_iters + 1)
    assert extra == 0 if not refresh_in_pass else extra >= 0


def test_compact_zero_candidate_iterations():
    # tight, far-apart blobs: after the first assignment the filters
    # drop every candidate while the centroids still drift
    pts, _ = _dataset(600, 6, 4, seed=3)
    centers = np.array([[0.0] * 6, [100.0] * 6, [-100.0] * 6, [200.0] * 6],
                       np.float32)
    pts = (pts * 0.01 + centers[np.arange(600) % 4]).astype(np.float32)
    r_t, s_t, r_j, s_j = _fits(pts, centers + 0.5, n_groups=2,
                               max_iters=20, tol=1e-6, min_cap=64)
    assert r_t.n_iters > 1
    _assert_parity(r_t, r_j, exact_evals=True)
    _assert_same_buckets(s_t, s_j)


def _lloyd_pair(pts, init, **kw):
    return (kmeans.lloyd(torch.from_numpy(pts), torch.from_numpy(init),
                         **kw),
            jkmeans.lloyd(jnp.asarray(pts), jnp.asarray(init), **kw))


@pytest.mark.parametrize("refresh_in_pass", REFRESH)
def test_compact_large_path(refresh_in_pass):
    # large enough for the bucketed driver, with at least two buckets
    pts, init = _dataset(6000, 16, 32)
    kw = dict(max_iters=50, tol=1e-5)
    r_t, s_t, r_j, s_j = _fits(pts, init, refresh_in_pass, n_groups=3,
                               min_cap=256, **kw)
    _assert_labels(r_t, r_j)
    _assert_same_buckets(s_t, s_j)
    assert len(s_t.caps_history) >= 2
    ev_t, ev_j = int(r_t.distance_evals), float(r_j.distance_evals)
    assert abs(ev_t - ev_j) <= EVALS_RTOL * ev_j
    # n_iters: each side's compact fit takes its own Lloyd's count ...
    l_t, l_j = _lloyd_pair(pts, init, **kw)
    assert r_t.n_iters == l_t.n_iters and int(r_j.n_iters) == int(l_j.n_iters)
    np.testing.assert_array_equal(l_t.assignments.numpy(),
                                  r_t.assignments.numpy())
    # ... and the two Lloyd loops part at iteration 3, at a tie
    a_t, a_j = _lloyd_pair(pts, init, max_iters=3, tol=0.0)
    c_t, c_j = _lloyd_pair(pts, init, max_iters=2, tol=0.0)
    assert torch.equal(c_t.assignments, torch.from_numpy(
        np.asarray(c_j.assignments)))
    apart = np.nonzero(a_t.assignments.numpy()
                       != np.asarray(a_j.assignments))[0]
    assert len(apart) >= 1
    c64 = c_t.centroids.double().numpy()
    for i in apart:
        d2 = ((pts[i].astype(np.float64) - c64) ** 2).sum(1)
        pair = d2[[int(a_t.assignments[i]), int(a_j.assignments[i])]]
        assert abs(pair[0] - pair[1]) <= 1e-5 * pair.min()
    assert (r_t.n_iters, int(r_j.n_iters)) == (10, 11)


def test_compact_group_bucket_spill_is_exact():
    """A cap_g the data exceeds: the pass must spill to the dense
    branch, never drop a surviving group."""
    pts, init = _dataset(6000, 8, 24)
    r_t, s_t, r_j, s_j = _fits(pts, init, n_groups=8, max_iters=40,
                               tol=1e-5, max_bucket_switches=1)
    _assert_parity(r_t, r_j)
    _assert_same_buckets(s_t, s_j)
    l_t, _ = _lloyd_pair(pts, init, max_iters=40, tol=1e-5)
    np.testing.assert_array_equal(r_t.assignments.numpy(),
                                  l_t.assignments.numpy())


def test_compact_work_reduction():
    pts, init = _dataset(6000, 16, 32)
    r_t, _, r_j, _ = _fits(pts, init, max_iters=50, tol=1e-5)
    l_t, _ = _lloyd_pair(pts, init, max_iters=50, tol=1e-5)
    assert int(r_t.distance_evals) < 0.6 * int(l_t.distance_evals)
    ev_j = float(r_j.distance_evals)
    assert abs(int(r_t.distance_evals) - ev_j) <= EVALS_RTOL * ev_j


@pytest.mark.parametrize("algorithm", ["yinyang", "hamerly"])
def test_compact_through_kmeans_api(algorithm):
    pts, _ = _dataset(1500, 8, 8)
    km = KMeans(n_clusters=8, algorithm=algorithm, engine="compact", seed=1,
                device="cpu").fit(pts)
    ref = KMeans(n_clusters=8, engine=None, seed=1, device="cpu").fit(pts)
    np.testing.assert_array_equal(km.labels_, ref.labels_)
    np.testing.assert_allclose(km.inertia_, ref.inertia_, rtol=1e-5)
    assert km.stats_.backend == "compact"
    # the estimator's own starting centroids, fed to JAX's engine
    init = km._init_centroids(torch.from_numpy(pts)).numpy()
    r_j = jengine.fit(jnp.asarray(pts), jnp.asarray(init),
                      n_groups=1 if algorithm == "hamerly" else None,
                      backend="compact", tune="off")
    np.testing.assert_array_equal(km.labels_, np.asarray(r_j.assignments))
    assert km.n_iter_ == int(r_j.n_iters)
    np.testing.assert_allclose(km.inertia_, float(r_j.inertia), rtol=1e-5)


def test_yinyang_compact_matches_jax():
    pts, init = _dataset(4000, 12, 24, seed=7)
    r_t = yinyang_compact(torch.from_numpy(pts), torch.from_numpy(init),
                          max_iters=40, tol=1e-5)
    r_j = j_yinyang_compact(jnp.asarray(pts), jnp.asarray(init),
                            max_iters=40, tol=1e-5)
    _assert_parity(r_t, r_j)
    l_t, _ = _lloyd_pair(pts, init, max_iters=40, tol=1e-5)
    np.testing.assert_allclose(float(r_t.inertia), float(l_t.inertia),
                               rtol=1e-5)


@pytest.mark.parametrize("refresh_ub", [False, True])
@pytest.mark.parametrize("use_groups,cap_g,branch", [
    (False, 2, "dense"),
    (True, 2, "group"),           # cap_g >= this pass's gmax (2)
    (True, 1, "dense"),           # gmax > cap_g: the spill
])
def test_one_compact_pass_counts_exactly(use_groups, cap_g, branch,
                                         refresh_ub):
    """One compact pass on the same pending state as JAX's: the pair
    count is exact (``n_rows * K`` in the dense branch, ``sum(gneed *
    gsize)`` in the group branch), and so are gmax and the labels."""
    n, k, g = 1000, 32, 8
    pts, init = _dataset(n, 4, k, seed=2)
    pj = jnp.asarray(pts)
    groups = jkmeans.group_centroids(jnp.asarray(init), g)
    members, gsize = jengine.build_group_tables(np.asarray(groups), g)
    carry = jengine._init_carry(pj, jnp.asarray(init), groups, n_groups=g)
    core = jengine.PassCore(backend="oracle", k=k, n_groups=g)
    carry, _, _ = jengine._loop_body(core, pj, None, groups, members,
                                     gsize)((carry, jnp.int32(0),
                                             jnp.int32(0)))
    need = np.asarray(carry.need)
    cap_n = 1 << int(need.sum() - 1).bit_length()
    kw = dict(cap_n=cap_n, cap_g=cap_g, n_groups=g, use_groups=use_groups,
              refresh_ub=refresh_ub)
    a_j, ub_j, lb_j, pairs_j, gmax_j = jengine.compact_candidate_pass(
        pj, carry.centroids, carry.assignments, carry.ub, carry.lb, groups,
        members, gsize, carry.need, x2=carry.x2, c2=carry.c2, **kw)
    t = {f: torch.from_numpy(np.array(getattr(carry, f))) for f in
         ("centroids", "assignments", "ub", "lb", "x2", "need", "c2")}
    t_members, t_gsize = engine.build_group_tables(np.array(groups), g,
                                                   "cpu")
    a_t, ub_t, lb_t, pairs_t, gmax_t = engine.compact_candidate_pass(
        torch.from_numpy(pts), t["centroids"], t["assignments"], t["ub"],
        t["lb"], torch.from_numpy(np.array(groups)), t_members, t_gsize,
        t["need"], x2=t["x2"], c2=t["c2"], **kw)
    assert int(gmax_t) == int(gmax_j) == 2
    assert (branch == "group") == (use_groups and int(gmax_t) <= cap_g)
    # the count each branch must give, from the pass's own gneed
    ub_c = np.asarray(carry.ub)
    if refresh_ub:
        c = np.asarray(carry.centroids)[np.asarray(carry.assignments)]
        ub_c = np.sqrt(np.maximum(np.asarray(carry.x2) - 2 * (pts * c).sum(1)
                                  + np.asarray(carry.c2)[
                                      np.asarray(carry.assignments)], 0))
    gneed = need[:, None] & (np.asarray(carry.lb) < ub_c[:, None])
    want = gneed.any(1).sum() * k if branch == "dense" else \
        (gneed * np.asarray(gsize)[None, :]).sum()
    assert int(pairs_t) == int(float(pairs_j)) == int(want) > 0
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert_pass_bounds(ub_t, lb_t, ub_j, lb_j, a_t, carry.assignments,
                       groups, atol=1e-5 * float(t["x2"].max()
                                                 + t["c2"].max()))
