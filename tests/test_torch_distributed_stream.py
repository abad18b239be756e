"""The port's sharded stream (``StreamingKMeans(mesh=...)``,
``repro_torch.core.distributed.make_stream_bounds_sharded`` /
``make_stream_update_sharded``, ``Reducer.max``), its elastic restores
and the sharded tuning search, held against the JAX reference on the
CPU.

The numpy inputs and JAX's k-means++ seeds are made here. Three
module-scoped runs use them: the JAX reference in a subprocess under 8
forced CPU devices (its sharded stream, its sharded step factories on one
batch, and a 2-shard resilient stream whose checkpoints the port
continues), the port in a world of 8 ``gloo`` ranks
(``_torch_world.sharded_streams``) beside it, and then the port in a
world of 4 (``_torch_world.elastic_world``). The stream is
``PointStream(997, 4 shards, D 16, K 8, seed 3)`` over 3 epochs: every
batch pads, as 997 is not a multiple of 8.

Tolerances. Against JAX's sharded stream, with the port under the
reference's cap rule (``tests/_torch_cap.py``): ``StreamStats`` equal
but ``distance_evals`` within 2%, the first batch's labels and pairs
equal, the counts' sum exact, counts atol 8, centroids atol 1e-3 and
``inertia_of`` rtol 1e-4 (the reference's
``test_sharded_streaming_matches_local``); the port as it is runs the
same stream bit for bit with no more evals. Within the port: weights of
1.0 and none, every rank, and a 1-rank mesh against the local stream
bit for bit. The step factories on one batch: pairs, ``gmax`` and the
candidate counts exact, centroids atol 1e-6 plus four float32 roundings
of their magnitude (the all-reduce sums in another order). Elastic restores: inertia
within 2% of the uninterrupted run, the reference's bound.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_world
from repro.core import kmeans_plusplus
from repro.core.kmeans import group_centroids as jgroup_centroids
from repro.data import PointStream as JaxPointStream
from repro.data import make_points
from repro_torch.core.distributed import spawn_world
from repro_torch.core.engine import EngineConfig
from repro_torch.data import PointStream
from repro_torch.streaming import StreamingKMeans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM = _torch_world.STREAM
STAT_FIELDS = ("batches", "points_seen", "cache_hits", "cache_misses",
               "drift_resets", "reseeds", "init_batches", "sharded_batches",
               "ckpt_saves", "restores", "replayed_batches")


def _inputs():
    x = {}
    stream = JaxPointStream(**STREAM)
    # JAX's estimator seeds from its first batch with PRNGKey(seed)
    x["seeds"] = np.asarray(kmeans_plusplus(
        jax.random.PRNGKey(3), jnp.asarray(stream.shard(0)), 8))
    # one batch of 1000 points (8 x 125) for the step factories, with
    # carried bounds: exact ones, loosened
    pts, _, _ = make_points(1000, 8, 32, seed=5)
    init = np.asarray(kmeans_plusplus(jax.random.PRNGKey(6),
                                      jnp.asarray(pts), 32))
    g = 4
    groups = np.asarray(jgroup_centroids(jnp.asarray(init), g))
    d = np.sqrt(((pts[:, None, :].astype(np.float64)
                  - init[None].astype(np.float64)) ** 2).sum(-1))
    moved = (init + np.random.default_rng(2).normal(
        0, 0.3, init.shape)).astype(np.float32)
    assign = d.argmin(1)
    lb = np.full((len(pts), g), np.inf)
    for j in range(g):
        dj = np.where((groups[None, :] == j)
                      & (np.arange(32)[None, :] != assign[:, None]), d,
                      np.inf)
        lb[:, j] = dj.min(1)
    x.update(b_pts=pts, b_init=moved, b_g=np.asarray(g),
             b_groups=groups.astype(np.int32),
             b_counts=np.random.default_rng(4).uniform(
                 0, 20, 32).astype(np.float32),
             b_assign=assign.astype(np.int32),
             b_ub=(d[np.arange(len(pts)), assign] * 1.05 + 0.05).astype(
                 np.float32),
             b_lb=(np.where(np.isinf(lb), 1e30, lb) * 0.7).astype(
                 np.float32),
             b_decay=np.asarray(0.9, np.float32), b_capg=np.asarray(2))
    # the sharded search: 4 ranks of 512 points
    x["t_pts"], _, _ = make_points(2048, 16, 24, seed=0)
    x["t_init"] = np.asarray(kmeans_plusplus(jax.random.PRNGKey(1),
                                             jnp.asarray(x["t_pts"]), 24))
    return x


JAX_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import engine, kmeans_plusplus
from repro.core.distributed import (make_mesh, make_stream_bounds_sharded,
                                    make_stream_update_sharded)
from repro.data import PointStream
from repro.streaming import StreamingKMeans

x = dict(np.load(sys.argv[1]))
out = {}

# the sharded stream, batch by batch
stream = PointStream(**STREAM)
pts_all = np.concatenate([stream.shard(i) for i in range(4)])
out["seeds"] = np.asarray(kmeans_plusplus(
    jax.random.PRNGKey(3), jnp.asarray(stream.shard(0)), 8))
skm = StreamingKMeans(8, seed=3, mesh=make_mesh(8))
for step in range(3 * len(stream)):
    b = stream.global_batch(step)
    skm.partial_fit(b["points"], shard_id=b["shard_id"])
    if step == 0:
        out["s/first_labels"] = np.asarray(skm.labels_)
        out["s/first_evals"] = np.asarray(skm.stats_.distance_evals)
for f, v in skm.stats_.to_dict().items():
    out["s/stats/" + f] = np.asarray(v)
out["s/centroids"] = np.asarray(skm.cluster_centers_)
out["s/counts"] = np.asarray(skm.counts_)
out["s/inertia"] = np.asarray(skm.inertia_of(pts_all))

# the step factories on one batch: a first visit, then a revisit
mesh = make_mesh(8)
k, g, n = 32, int(x["b_g"]), len(x["b_pts"]) // 8
members, gsize = engine.build_group_tables(x["b_groups"], g)
args = (x["b_pts"], x["b_init"], x["b_counts"], jnp.float32(x["b_decay"]),
        x["b_groups"], members, gsize)
nb = len(x["b_pts"])

def keep(name, o):
    out[name + "/assignments"] = np.asarray(o.assignments)
    out[name + "/pairs"] = np.asarray(float(o.pairs))
    out[name + "/gmax"] = np.asarray(int(o.gmax))
    out[name + "/centroids"] = np.asarray(o.centroids)
    out[name + "/counts"] = np.asarray(o.counts)
    out[name + "/batch_cost"] = np.asarray(float(o.batch_cost))

upd = make_stream_update_sharded(mesh, ("data",), k=k, n_groups=g,
                                 cap_n=n, cap_g=g)
keep("b/first", upd(*args, np.zeros(nb, np.int32),
                    np.full(nb, np.inf, np.float32),
                    np.zeros((nb, g), np.float32), np.ones(nb, bool)))
ub_t, need, n_cand, n_tight = make_stream_bounds_sharded(mesh)(
    x["b_pts"], x["b_init"], x["b_assign"], x["b_ub"], x["b_lb"])
cap_n = engine._bucket_cap(int(n_cand), 1, n)
out["b/revisit/n_cand"] = np.asarray(int(n_cand))
out["b/revisit/tightened"] = np.asarray(float(n_tight))
out["b/revisit/cap_n"] = np.asarray(cap_n)
upd = make_stream_update_sharded(mesh, ("data",), k=k, n_groups=g,
                                 cap_n=cap_n, cap_g=int(x["b_capg"]))
keep("b/revisit", upd(*args, x["b_assign"], ub_t, x["b_lb"], need))

# a 2-shard resilient stream whose checkpoints the port continues
grow = PointStream(**GROW)
g_pts = np.concatenate([grow.shard(i) for i in range(4)])
full = StreamingKMeans(8, seed=1, mesh=make_mesh(2))
full.fit_stream(grow, epochs=3)
out["e/inertia"] = np.asarray(full.inertia_of(g_pts))
StreamingKMeans(8, seed=1, mesh=make_mesh(2)).fit_stream(
    grow, epochs=3, resilient=True, ckpt_dir=sys.argv[3], ckpt_every=4)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("stream_inputs") / "inputs.npz")
    x = _inputs()
    np.savez(path, **x)
    return path, x


@pytest.fixture(scope="module")
def jax_run(inputs, tmp_path_factory):
    """The reference's subprocess, started and left running while the
    port's world of 8 runs."""
    tmp = tmp_path_factory.mktemp("stream_jax")
    path, ckpt = str(tmp / "ref.npz"), str(tmp / "ckpt")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    script = (f"STREAM = {STREAM!r}\nGROW = {_torch_world.GROW!r}\n"
              + textwrap.dedent(JAX_REFERENCE))
    proc = subprocess.Popen(
        [sys.executable, "-c", script, inputs[0], path, ckpt], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, path, ckpt
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def world8(inputs, jax_run):
    return spawn_world(_torch_world.sharded_streams, 8,
                       args=(inputs[0],), timeout=240)


@pytest.fixture(scope="module")
def ref(inputs, jax_run, world8):
    proc, path, _ = jax_run
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def world4(inputs, jax_run, ref, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("stream_world4"))
    ranks = spawn_world(_torch_world.elastic_world, 4,
                        args=(inputs[0], jax_run[2], tmp), timeout=300)
    return ranks, tmp


@pytest.fixture(scope="module")
def local_stream(inputs):
    """The port's single-device stream from the same seeds, under the
    reference's cap rule and as it is."""
    from _torch_cap import reference_cap
    stream = PointStream(**STREAM)
    pts_all = np.concatenate([stream.shard(i) for i in range(4)])

    def run():
        skm = _torch_world._fixed_seeds(
            StreamingKMeans(8, seed=3, device="cpu"), inputs[1]["seeds"])
        return _torch_world._stream_run(skm, stream, 3, pts_all)

    with reference_cap():
        cap = run()
    return {"cap": cap, "own": run()}


def _same_stream(a, b):
    """Two port streams bit for bit: centroids, counts, the ledger,
    labels and ``inertia_of``."""
    np.testing.assert_array_equal(a["centroids"], b["centroids"])
    np.testing.assert_array_equal(a["counts"], b["counts"])
    for x, y in zip(a["ledger"], b["ledger"]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a["first_labels"], b["first_labels"])
    assert a["inertia"] == b["inertia"]


def _held(got, want_stats, want, *, sharded_batches):
    """``got`` (the port under the reference's cap) against a stream
    with ``want_stats`` and ``want``'s results, at the reference's
    tolerances."""
    for f in STAT_FIELDS:
        w = sharded_batches if f == "sharded_batches" else want_stats[f]
        assert got["stats"][f] == w, f
    np.testing.assert_allclose(got["stats"]["distance_evals"],
                               want_stats["distance_evals"], rtol=2e-2)
    np.testing.assert_array_equal(got["first_labels"], want["first_labels"])
    assert got["first_evals"] == want["first_evals"]
    assert got["counts"].sum() == want["counts"].sum()
    np.testing.assert_allclose(got["counts"], want["counts"], atol=8)
    np.testing.assert_allclose(got["centroids"], want["centroids"],
                               atol=1e-3)
    np.testing.assert_allclose(got["inertia"], want["inertia"], rtol=1e-4)


# -- (1) against JAX's sharded stream ------------------------------------------

def test_seeds_and_stream_are_jaxs(inputs, ref):
    np.testing.assert_array_equal(ref["seeds"], inputs[1]["seeds"])
    js, ps = JaxPointStream(**STREAM), PointStream(**STREAM)
    for s in range(4):
        np.testing.assert_array_equal(js.shard(s), ps.shard(s))


def test_sharded_stream_matches_jax_sharded(ref, world8):
    got = world8[0]["cap"]
    want_stats = {f: ref["s/stats/" + f].item()
                  for f in STAT_FIELDS + ("distance_evals",)}
    assert want_stats["sharded_batches"] == 12
    want = dict(first_labels=ref["s/first_labels"],
                first_evals=float(ref["s/first_evals"]),
                counts=ref["s/counts"], centroids=ref["s/centroids"],
                inertia=float(ref["s/inertia"]))
    _held(got, want_stats, want, sharded_batches=12)


def test_sharded_stream_as_it_is_is_the_same_stream(world8):
    own, cap = world8[0]["own"], world8[0]["cap"]
    _same_stream(own, cap)
    assert own["stats"]["distance_evals"] <= cap["stats"]["distance_evals"]


# -- (2) against the port's local stream ---------------------------------------

@pytest.mark.parametrize("rule", ["cap", "own"])
def test_sharded_stream_matches_local_stream(world8, local_stream, rule):
    local = local_stream[rule]
    assert local["stats"]["sharded_batches"] == 0
    _held(world8[0][rule], local["stats"], local, sharded_batches=12)


# -- (3) and (4): weights of 1.0, and every rank -------------------------------

def test_uniform_weights_equal_none_bit_for_bit(world8):
    ones, own = world8[0]["ones"], world8[0]["own"]
    _same_stream(ones, own)
    assert ones["stats"] == own["stats"]


def test_every_rank_holds_the_same_stream(world8):
    for r in world8[1:]:
        for case in ("cap", "own", "ones"):
            _same_stream(r[case], world8[0][case])
            assert r[case]["stats"] == world8[0][case]["stats"]


# -- (5) a 1-rank mesh ---------------------------------------------------------

def test_one_rank_mesh_is_the_local_stream_bit_for_bit(world4):
    r0 = world4[0][0]
    _same_stream(r0["mesh1"], r0["local"])
    st1, st = r0["mesh1"]["stats"], r0["local"]["stats"]
    assert st1["sharded_batches"] == 12 and st["sharded_batches"] == 0
    assert {**st1, "sharded_batches": 0} == st


# -- (6) the step factories on one batch ----------------------------------------

@pytest.mark.parametrize("visit", ["first", "revisit"])
def test_step_factories_match_jax(ref, world8, visit):
    got = world8[0]["batch"][visit]
    pre = f"b/{visit}/"
    np.testing.assert_array_equal(got["assignments"],
                                  ref[pre + "assignments"])
    assert got["pairs"] == int(ref[pre + "pairs"])
    assert got["gmax"] == int(ref[pre + "gmax"])
    # atol 1e-6, and a few roundings of the magnitude: gloo sums the
    # ranks' partial sums in another order than XLA's psum
    np.testing.assert_allclose(got["centroids"], ref[pre + "centroids"],
                               atol=1e-6, rtol=4 * np.finfo(np.float32).eps)
    np.testing.assert_allclose(got["counts"], ref[pre + "counts"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["batch_cost"], ref[pre + "batch_cost"],
                               rtol=1e-5)
    if visit == "revisit":
        assert got["n_cand"] == int(ref[pre + "n_cand"])
        assert got["tightened"] == int(ref[pre + "tightened"])
        assert got["cap_n"] == int(ref[pre + "cap_n"])
    for r in world8[1:]:
        np.testing.assert_array_equal(r["batch"][visit]["centroids"],
                                      got["centroids"])


# -- (7) the reference's elastic scenarios --------------------------------------

def test_same_mesh_recovery_is_bit_for_bit_with_rank_0_writing(world4):
    ranks, _ = world4
    for r in ranks[:2]:
        c, n, _ = r["grow/full"]
        rc, rn, st = r["grow/recovered"]
        np.testing.assert_array_equal(rc, c)
        np.testing.assert_array_equal(rn, n)
        assert st["restores"] == 1 and st["replayed_batches"] == 1
    assert ranks[0]["grow/writes"] and not any(
        r["grow/writes"] for r in ranks[1:])


@pytest.mark.parametrize("into", [4, 1])
def test_elastic_grow_2_to_4(world4, into):
    ranks, _ = world4
    want = ranks[0]["grow/full"][2]
    if into == 1:
        got = [ranks[0]["grow/1"]]
    else:
        got = []
        for r in ranks:
            step, inertia, st, cents = r["grow/4"]
            assert step == 8 and st["cache_hits"] >= 8
            assert st["sharded_batches"] >= 4
            np.testing.assert_array_equal(cents, ranks[0]["grow/4"][3])
            got.append(inertia)
    for g in got:
        assert abs(g - want) / want < 0.02, (g, want)


def test_elastic_shrink_4_to_2(world4):
    ranks, _ = world4
    want = ranks[0]["shrink/full"]
    for r in ranks[:2]:
        step, got = r["shrink/2"]
        assert step == 8
        assert abs(got - want) / want < 0.02, (got, want)


# -- (8) across the packages ----------------------------------------------------

def test_jax_two_shard_checkpoint_continues_on_four_ranks(ref, world4):
    want = float(ref["e/inertia"])
    for r in world4[0]:
        step, got = r["jax_ckpt/4"]
        assert step == 8
        assert abs(got - want) / want < 0.02, (got, want)


# -- (9) the sharded search through distributed_yinyang ----------------------------------

def test_sharded_search_through_distributed_yinyang(world4):
    ranks, tmp = world4
    t = ranks[0]["tune"]
    assert t["sig"].endswith("|s4")
    assert t["searches"] == [4]             # force on a miss, once
    assert t["entry"]["config"]["backend"] == "compact"
    assert "lloyd_ms" not in t["entry"] and t["entry"]["shards"] == 4
    assert t["force"] == t["auto"] == EngineConfig.from_dict(
        t["entry"]["config"])
    for r in ranks[1:]:
        assert r["tune"]["force"] == t["force"]
        assert r["tune"]["searches"] == [4]
    np.testing.assert_array_equal(t["labels_auto"], t["labels_off"])
    # one rank wrote the file, and it holds the winner
    from repro_torch import tune
    assert tune.TuneCache(os.path.join(tmp, "tune.json")).lookup(
        t["sig"]) == t["force"]


def test_a_rank_outside_the_mesh_is_refused(world4):
    ranks, _ = world4
    for r in ranks[2:]:
        assert r["outside"] == ["this rank is not in the mesh"] * 3
