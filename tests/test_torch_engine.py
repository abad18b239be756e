"""The port's engine and reference loops against the JAX package's.

Same numpy points, same starting centroids (JAX's k-means++ draw, fed
to both sides), on the CPU: JAX runs with ``tune="off"`` and its Pallas
kernel in interpret mode; the port's kernel backend takes the plain
version of ``grouped_assign`` there.

What must agree, and how closely:

* assignments and ``n_iters``: exactly;
* inertia and centroids: rtol 1e-5 (sums and dot products run in
  another order than XLA's);
* ``distance_evals``: exactly for one candidate pass on the same
  inputs, and within rtol 5e-2 across a whole fit (the largest gap seen
  in this file is 2.3%). A whole fit cannot match to the unit: the
  reference's ``changed = best_d < ub_t`` compares the candidate pass's
  distance with the own-distance refresh, two roundings of one number
  when the best candidate is the current centroid, and a True caps that
  group's lower bound, which changes later filter decisions. Another
  summation order flips some of these (ROADMAP, Queue 3 item 1). The
  port caps only where the point moved, so a whole fit runs twice
  (``tests/_torch_cap.py``): with the reference's rule, held to JAX as
  above, and as it is, the same fit bit for bit with no more evals. The
  Lloyd loop and the zero-candidate fits have no such comparison and
  match exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import kmeans as jkmeans
from repro.core import kmeans_plusplus
from repro.data import make_points
from repro_torch.core import engine, kmeans
from repro_torch.data import make_points as torch_make_points
from _torch_cap import assert_same_fit_less_work, reference_cap

BACKENDS = [("oracle", "oracle"), ("pallas", "kernel"), ("lloyd", "lloyd")]
SHAPES = [               # tests/test_engine.py's, plus D=33
    (1000, 8, 12, 3),     # N % tile_n != 0; JAX's fused path (N <= 1024)
    (513, 5, 7, 2),       # ragged everything
    (768, 4, 8, 1),       # one group = Hamerly
    (2048, 12, 16, 16),   # one group per centroid; JAX's bucketed path
    (1500, 33, 20, 4),    # D not a multiple of 8 or 32
]
EVALS_RTOL = 5e-2


def _dataset(n, d, k, seed=0):
    pts, _, _ = make_points(n, d, k, seed=seed)
    init = kmeans_plusplus(jax.random.PRNGKey(seed + 1), jnp.asarray(pts), k)
    return pts, np.asarray(init)


def _assert_parity(r_t, r_j, exact_evals=False):
    assert int(r_t.n_iters) == int(r_j.n_iters)
    np.testing.assert_array_equal(r_t.assignments.numpy(),
                                  np.asarray(r_j.assignments))
    np.testing.assert_allclose(float(r_t.inertia), float(r_j.inertia),
                               rtol=1e-5)
    np.testing.assert_allclose(r_t.centroids.numpy(),
                               np.asarray(r_j.centroids), rtol=1e-5,
                               atol=1e-5)
    ev_t, ev_j = int(r_t.distance_evals), float(r_j.distance_evals)
    if exact_evals:
        assert ev_t == ev_j
    else:
        assert abs(ev_t - ev_j) <= EVALS_RTOL * ev_j, (ev_t, ev_j)


def test_make_points_is_the_same_draw():
    for a, b in zip(torch_make_points(300, 7, 5, seed=4),
                    make_points(300, 7, 5, seed=4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("jb,tb", BACKENDS)
@pytest.mark.parametrize("n,d,k,g", SHAPES)
def test_engine_fit_matches_jax(jb, tb, n, d, k, g):
    pts, init = _dataset(n, d, k)
    r_j = jengine.fit(jnp.asarray(pts), jnp.asarray(init), n_groups=g,
                      max_iters=50, tol=1e-5, backend=jb, tune="off",
                      interpret=True)
    kw = dict(n_groups=g, max_iters=50, tol=1e-5, backend=tb, device="cpu")
    with reference_cap():
        r_ref = engine.fit(pts, init, **kw)
    _assert_parity(r_ref, r_j, exact_evals=tb == "lloyd")
    r_t, stats = engine.fit(pts, init, return_stats=True, **kw)
    assert_same_fit_less_work(r_t, r_ref)
    assert stats.backend == tb
    # group table fetch + one shift read per iteration (lloyd: per iter)
    assert stats.host_syncs == r_t.n_iters + (tb != "lloyd")


@pytest.mark.parametrize("jb,tb", BACKENDS)
def test_engine_zero_candidate_iterations(jb, tb):
    # tight, far-apart blobs: after the first assignment the filters
    # drop every candidate while the centroids still drift
    pts, _ = _dataset(600, 6, 4, seed=3)
    centers = np.array([[0.0] * 6, [100.0] * 6, [-100.0] * 6, [200.0] * 6],
                       np.float32)
    pts = (pts * 0.01 + centers[np.arange(600) % 4]).astype(np.float32)
    init = centers + 0.5
    r_j = jengine.fit(jnp.asarray(pts), jnp.asarray(init), n_groups=2,
                      max_iters=20, tol=1e-6, backend=jb, tune="off",
                      interpret=True)
    r_t = engine.fit(pts, init, n_groups=2, max_iters=20, tol=1e-6,
                     backend=tb, device="cpu")
    assert r_t.n_iters > 1
    _assert_parity(r_t, r_j, exact_evals=True)


@pytest.mark.parametrize("g", [1, 3])
def test_reference_loops_match_jax(g):
    pts, init = _dataset(1000, 8, 12)
    pj, ij = jnp.asarray(pts), jnp.asarray(init)
    pt, it = torch.tensor(pts), torch.tensor(init)
    _assert_parity(kmeans.yinyang(pt, it, n_groups=g, max_iters=50,
                                  tol=1e-5),
                   jkmeans.yinyang(pj, ij, n_groups=g, max_iters=50,
                                   tol=1e-5))
    _assert_parity(kmeans.lloyd(pt, it, max_iters=50, tol=1e-5),
                   jkmeans.lloyd(pj, ij, max_iters=50, tol=1e-5),
                   exact_evals=True)
    w = np.random.default_rng(g).random(1000).astype(np.float32) + 0.5
    _assert_parity(kmeans.yinyang(pt, it, n_groups=g, max_iters=50,
                                  tol=1e-5, weights=torch.from_numpy(w)),
                   jkmeans.yinyang(pj, ij, n_groups=g, max_iters=50,
                                   tol=1e-5, weights=jnp.asarray(w)))


def test_group_centroids_match_jax():
    _, init = _dataset(2000, 12, 40, seed=5)
    for g in (1, 4, 7, 40, 50):
        np.testing.assert_array_equal(
            kmeans.group_centroids(torch.from_numpy(init), g).numpy(),
            np.asarray(jkmeans.group_centroids(jnp.asarray(init), g)))


def test_one_candidate_pass_counts_exactly():
    """One kernel candidate pass on the same pending state as JAX's
    ``pallas_candidate_pass``: the pair count (pad rows of the ragged
    tail tile included) and the assignments are exact."""
    n, k, g = 1000, 24, 4
    pts, init = _dataset(n, 6, k, seed=2)
    pj = jnp.asarray(pts)
    groups = jkmeans.group_centroids(jnp.asarray(init), g)
    members, gsize = jengine.build_group_tables(np.asarray(groups), g)
    carry = jengine._init_carry(pj, jnp.asarray(init), groups, n_groups=g)
    core = jengine.PassCore(backend="pallas", k=k, n_groups=g,
                            interpret=True)
    # one JAX body gives a real pending state (need, decayed bounds)
    carry, _, _ = jengine._loop_body(core, pj, None, groups, members,
                                     gsize)((carry, jnp.int32(0),
                                             jnp.int32(0)))
    a_j, ub_j, lb_j, pairs_j = jengine.pallas_candidate_pass(
        pj, carry.centroids, carry.assignments, carry.ub, carry.lb, groups,
        members, gsize, carry.need, n_groups=g, interpret=True,
        x2=carry.x2, c2=carry.c2)
    t = {f: torch.from_numpy(np.array(getattr(carry, f))) for f in
         ("centroids", "assignments", "ub", "lb", "x2", "need", "c2")}
    tg = torch.from_numpy(np.array(groups))
    t_members, t_gsize = engine.build_group_tables(np.array(groups), g,
                                                   "cpu")
    a_t, ub_t, lb_t, pairs_t = engine.kernel_candidate_pass(
        torch.from_numpy(pts), t["centroids"], t["assignments"], t["ub"],
        t["lb"], tg, t_members, t_gsize, t["need"], x2=t["x2"], c2=t["c2"])
    assert int(pairs_t) == int(float(pairs_j)) > 0
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert_pass_bounds(ub_t, lb_t, ub_j, lb_j, a_t, carry.assignments,
                       groups, atol=1e-5 * float(t["x2"].max()
                                                 + t["c2"].max()))


def assert_pass_bounds(ub_t, lb_t, ub_j, lb_j, a_new, a_old, groups, *,
                       atol):
    """The bounds one candidate pass leaves, port against JAX. They are
    square roots of the expanded form, whose error is relative to the
    norms: squares are compared, ``atol`` 1e-5 of the norms. Lower
    bounds may also differ where the two sides' ``changed`` flag differs
    for a point whose best candidate is its own centroid: there one
    side caps the old group's bound at ub_t (ROADMAP, Queue 3)."""
    np.testing.assert_allclose(ub_t.numpy() ** 2, np.asarray(ub_j) ** 2,
                               rtol=0, atol=atol)
    lb_j, lb_t = np.asarray(lb_j), lb_t.numpy()
    a_old = np.asarray(a_old)
    flip = np.zeros(lb_j.shape, bool)
    rows = np.nonzero(a_new.numpy() == a_old)[0]
    flip[rows, np.asarray(groups)[a_old[rows]]] = True
    both = np.isfinite(lb_j) & np.isfinite(lb_t)
    close = np.zeros(lb_j.shape, bool)
    close[both] = np.abs(lb_t[both] ** 2 - lb_j[both] ** 2) <= atol
    close |= lb_t == lb_j
    assert (close | flip).all()


def test_backend_resolution():
    pts, init = _dataset(512, 8, 16)
    assert 512 * 16 <= engine.AUTO_LLOYD_MAX_WORK
    _, st = engine.fit(pts, init, backend="auto", max_iters=5,
                       device="cpu", return_stats=True)
    assert st.backend == "lloyd"
    big, big_init = _dataset(4500, 8, 32)
    _, st = engine.fit(big, big_init, backend="auto", max_iters=3,
                       device="cpu", return_stats=True)
    assert st.backend == "kernel"
    _, st = engine.fit(pts, init, backend="pallas", max_iters=3,
                       device="cpu", return_stats=True)
    assert st.backend == "kernel"
    _, st = engine.fit(pts, init, backend="compact", max_iters=3,
                       device="cpu", return_stats=True)
    assert st.backend == "compact"
    # the ladder runs only inside the sharded fit: fit refuses it, as
    # the reference's does
    with pytest.raises(ValueError):
        jengine.fit(pts, init, backend="ladder")
    with pytest.raises(ValueError, match="ladder"):
        engine.fit(pts, init, backend="ladder", device="cpu")
    with pytest.raises(ValueError):
        engine.fit(pts, init, backend="nope", device="cpu")
    # tune="force" runs the search now (tests/test_torch_tune.py); an
    # unknown mode is refused
    with pytest.raises(ValueError):
        engine.fit(pts, init, tune="sometimes", device="cpu")
    cfg = engine.EngineConfig.from_dict(jengine.EngineConfig().to_dict())
    assert cfg == engine.EngineConfig()


def test_assign_matches_dense_argmin_across_tiles():
    pts, init = _dataset(3000, 8, 24, seed=2)
    r = engine.fit(pts, init, max_iters=20, backend="kernel", device="cpu")
    c = r.centroids.numpy()
    d_ref = np.linalg.norm(pts[:, None] - c[None], axis=-1)
    ref = d_ref.argmin(1)
    for tile in (512, 1024, 4096):        # 3000 is ragged against each
        labels, dists = engine.assign(pts, c, tile_n=tile, device="cpu")
        np.testing.assert_array_equal(labels.numpy(), ref)
        np.testing.assert_allclose(dists.numpy(), d_ref[np.arange(3000), ref],
                                   atol=1e-3)
    groups, members, gsize = engine.build_assign_tables(r.centroids, 3)
    labels, _ = engine.assign(pts, c, groups=groups, members=members,
                              gsize=gsize, device="cpu")
    np.testing.assert_array_equal(labels.numpy(), ref)
