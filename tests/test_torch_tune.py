"""The port's autotuner (``repro_torch.tune``) against the JAX
package's, on the CPU.

Tuning changes wall-clock, never results. Held here: the cache
round-trips configs by signature in a file and variable of the port's
own, and no key of the port's can match one of the JAX package's; the
search, driven by the same measurement stub, measures the same configs
in the same order and picks the same winner as JAX's ``autotune``
(the port's ``kernel`` where JAX has ``pallas``); every tuned
configuration gives labels, ``n_iters`` and inertia bit-identical to the
default's, and the labels equal the JAX package's on the same inputs;
``||x||^2`` is computed once per fit; the compact pass's gather/GEMM
decision follows the tuned crossover. Every test keeps its cache under
``tmp_path``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tune as jtune
from repro.core import EngineConfig as JaxEngineConfig
from repro.core import engine as jengine
from repro.core import kmeans_plusplus
from repro.data import make_points
from repro_torch import KMeans, tune
from repro_torch.core import engine
from repro_torch.core.engine import EngineConfig
from repro_torch.core.kmeans import lloyd


@pytest.fixture(autouse=True)
def tmp_cache(tmp_path, monkeypatch):
    """A fresh cache under tmp_path, installed as the process default
    (fit(tune=...) consults the default) and named by the port's
    variable."""
    monkeypatch.setenv(tune.ENV_VAR, str(tmp_path / "tune.json"))
    cache = tune.set_default_cache(None)
    assert cache.path == str(tmp_path / "tune.json")
    yield cache
    tune.set_default_cache(None)


def _dataset(n, d, k, seed=0):
    pts, _, _ = make_points(n, d, k, seed=seed)
    init = kmeans_plusplus(jax.random.PRNGKey(seed + 1), jnp.asarray(pts), k)
    return pts, np.asarray(init)


def _fit(pts, init, **kw):
    return engine.fit(pts, init, device="cpu", **kw)


# -- cache ------------------------------------------------------------------

def test_cache_round_trip(tmp_path):
    path = str(tmp_path / "t.json")
    cache = tune.TuneCache(path)
    sig = tune.signature(3000, 32, 16, platform="cpu")
    cfg = EngineConfig(backend="compact", min_cap=512, down_g=0,
                       refresh_in_pass=True)
    cache.store(sig, cfg, ms=4.2)
    cache2 = tune.TuneCache(path)
    assert cache2.lookup(sig) == cfg
    assert cache2.entry(sig)["ms"] == 4.2
    assert tune.signature(2500, 32, 16, platform="cpu") == sig
    for other in (tune.signature(3000, 64, 16, "cpu"),
                  tune.signature(3000, 32, 8, "cpu"),
                  tune.signature(9000, 32, 16, "cpu"),
                  tune.signature(3000, 32, 16, "NVIDIA_H100_80GB_HBM3")):
        assert cache2.lookup(other) is None
    cache2.drop(sig)
    assert cache2.lookup(sig) is None
    assert tune.TuneCache(path).lookup(sig) is None   # drop persisted
    # the JAX package's format and version: its reader takes the file
    cache.store(sig, cfg)
    assert jtune.TuneCache(path).entry(sig)["config"] == cfg.to_dict()


def test_cache_tolerates_corrupt_file(tmp_path):
    path = str(tmp_path / "t.json")
    with open(path, "w") as fh:
        fh.write("{not json")
    cache = tune.TuneCache(path)
    assert cache.lookup("anything") is None
    cache.store("sig", EngineConfig())          # and can still write
    assert tune.TuneCache(path).lookup("sig") == EngineConfig()


def test_config_dict_round_trip_tolerates_unknown_keys():
    cfg = EngineConfig(backend="compact", chunk=1024)
    d = cfg.to_dict()
    d["knob_from_the_future"] = 7
    assert EngineConfig.from_dict(d) == cfg
    # the same fields as the JAX package's
    assert set(cfg.to_dict()) == set(JaxEngineConfig().to_dict())


def test_env_var_and_default_path_are_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.setenv(tune.ENV_VAR, str(tmp_path / "custom.json"))
    assert tune.TuneCache().path == str(tmp_path / "custom.json")
    assert tune.ENV_VAR == "REPRO_TORCH_KMEANS_TUNE_CACHE" != jtune.ENV_VAR
    monkeypatch.delenv(tune.ENV_VAR)
    monkeypatch.setenv(jtune.ENV_VAR, str(tmp_path / "jax.json"))
    assert tune.default_path().endswith(".cache/repro_torch_kmeans_tune.json")
    assert tune.default_path() != jtune.default_path()


def test_ports_keys_never_match_jax_keys():
    for plat in ("cpu", "gpu", "tpu"):
        jsig = jtune.signature(3000, 32, 16, platform=plat)
        assert tune.signature(3000, 32, 16, platform=plat) != jsig
        assert not jsig.startswith("torch|")
        assert tune.serve_signature(32, 16, platform=plat) != \
            jtune.serve_signature(32, 16, platform=plat)
    assert tune.signature(3000, 32, 16, platform="cpu") == \
        "torch|cpu|n4096|k32|d16"
    assert tune.platform_name("cpu") == "cpu"
    assert tune.signature(3000, 32, 16) == tune.signature(
        3000, 32, 16, tune.platform_name(
            "cuda" if torch.cuda.is_available() else "cpu"))


def test_sharded_keys_raise_not_implemented(tmp_path):
    # the sharded keys are the reference's (|sS, n per shard); the
    # sharded search under a stub measure stores under |s4 and leaves
    # the single-device key alone (the reference's test_tune.py:345);
    # its default measure needs a world
    pts, init = _dataset(512, 8, 16)
    sig = tune.signature(512, 16, 8, "cpu", shards=4)
    assert sig == "torch|cpu|n512|k16|d8|s4"
    assert sig.split("|", 1)[1] == jtune.signature(512, 16, 8, "cpu",
                                                   shards=4)
    assert tune.signature(512, 16, 8, "cpu", shards=1) == \
        "torch|cpu|n512|k16|d8"
    assert tune.lookup(n=512, k=16, d=8, shards=4) is None
    cache = tune.TuneCache(path=str(tmp_path / "t.json"))
    seen = []

    def measure(cfg):
        seen.append(cfg.backend)
        return 1.0 + 0.1 * (cfg.min_cap != 256)

    best = tune.autotune(pts, init, shards=4, platform="cpu", cache=cache,
                         measure=measure)
    assert set(seen) == {"compact"} and best.backend == "compact"
    assert cache.signatures() == [sig]
    assert "lloyd_ms" not in cache.entry(sig)
    assert cache.entry(sig)["shards"] == 4
    assert tune.TuneCache(path=cache.path).lookup(sig) == best
    assert cache.lookup(tune.signature(512, 16, 8, "cpu")) is None
    with pytest.raises(RuntimeError, match="init_process_group"):
        tune.sharded_timing_measure(pts, init, 4, device="cpu")


# -- search -----------------------------------------------------------------

def _stub_measure(costs):
    calls = []

    def measure(cfg):
        calls.append(cfg)
        return costs(cfg)
    measure.calls = calls
    return measure


def _costs(cfg):
    if cfg.backend == "lloyd":
        return 5.0
    # optimum: compact, min_cap=512, down_g=0, refresh_in_pass=True
    return (3.0 + abs(cfg.min_cap - 512) / 1000.0
            + (0.5 if cfg.down_g else 0.0)
            + (0.0 if cfg.refresh_in_pass else 0.25)
            + (0.0 if cfg.backend == "compact" else 0.1)
            + abs(cfg.tile_n - 128) / 1000.0)


def _same_search(port_calls, jax_calls):
    back = {"pallas": "kernel"}
    want = [{**c.to_dict(), "backend": back.get(c.backend, c.backend)}
            for c in jax_calls]
    assert [c.to_dict() for c in port_calls] == want


@pytest.mark.parametrize("platform,jax_platform", [
    ("cpu", "cpu"), ("NVIDIA_H100_80GB_HBM3", "tpu")])
def test_search_matches_jax_under_the_same_stub(tmp_path, platform,
                                                jax_platform):
    pts, init = _dataset(3000, 16, 32)
    cache = tune.TuneCache(str(tmp_path / "a.json"))
    m_t = _stub_measure(_costs)
    best = tune.autotune(pts, init, cache=cache, measure=m_t,
                         platform=platform)
    m_j = _stub_measure(lambda c: _costs(EngineConfig.from_dict(
        {**c.to_dict(), "backend": {"pallas": "kernel"}.get(c.backend,
                                                            c.backend)})))
    best_j = jtune.autotune(jnp.asarray(pts), jnp.asarray(init),
                            cache=jtune.TuneCache(str(tmp_path / "j.json")),
                            measure=m_j, platform=jax_platform)
    _same_search(m_t.calls, m_j.calls)
    _same_search([best], [best_j])
    assert best.backend == "compact" and best.min_cap == 512
    assert best.down_g == 0 and best.refresh_in_pass is True
    if platform != "cpu":
        assert m_t.calls[1].backend == "kernel"   # the card's grid
    sig = tune.signature(3000, 32, 16, platform)
    assert cache.lookup(sig) == best
    assert cache.entry(sig)["lloyd_ms"] == pytest.approx(5000.0)
    # deterministic: a second search measures the same sequence
    m2 = _stub_measure(_costs)
    tune.autotune(pts, init, cache=tune.TuneCache(str(tmp_path / "b.json")),
                  measure=m2, platform=platform)
    assert [c.to_dict() for c in m2.calls] == \
        [c.to_dict() for c in m_t.calls]


def test_candidate_backends():
    assert tune.candidate_backends("cpu") == ("compact", "lloyd")
    assert tune.candidate_backends("NVIDIA_H100_80GB_HBM3") == \
        ("kernel", "compact", "lloyd")


def test_search_backend_grid_can_pick_lloyd(tmp_path):
    pts, init = _dataset(1000, 8, 8)
    best = tune.autotune(
        pts, init, cache=tune.TuneCache(str(tmp_path / "c.json")),
        platform="cpu", measure=_stub_measure(
            lambda cfg: 1.0 if cfg.backend == "lloyd" else 9.0))
    assert best.backend == "lloyd"


def test_get_or_tune_prefers_cache_hit(tmp_path):
    pts, init = _dataset(1000, 8, 8)
    cache = tune.TuneCache(str(tmp_path / "d.json"))
    pinned = EngineConfig(backend="compact", chunk=4096)
    cache.store(tune.signature(1000, 8, 8, "cpu"), pinned)
    m = _stub_measure(lambda cfg: 1.0)
    assert tune.get_or_tune(pts, init, cache=cache, measure=m,
                            device="cpu") == pinned
    assert m.calls == []                       # no measurement happened


def test_timing_measure_times_real_fits():
    pts, init = _dataset(600, 4, 6)
    measure = tune.timing_measure(pts, init, max_iters=5, repeats=1,
                                  device="cpu")
    assert 0.0 < measure(EngineConfig(backend="compact")) < 60.0


# -- fit integration: tuning never changes results --------------------------

TUNED_VARIANTS = [
    EngineConfig(backend="compact", min_cap=128, chunk=1024,
                 group_gather_factor=2, down_n=4, down_g=2),
    EngineConfig(backend="compact", min_cap=512, down_n=0, down_g=0,
                 refresh_in_pass=True),
    EngineConfig(backend="kernel", tile_n=128),
    EngineConfig(backend="kernel", tile_n=512),
]


@pytest.mark.parametrize("n,d,k,g", [
    (1000, 8, 12, 3),     # N % tile_n != 0
    (513, 5, 7, 2),       # ragged everything
    (768, 4, 8, 1),       # single group = Hamerly
    (2048, 12, 16, 16),   # one group per centroid
])
def test_tuned_configs_bit_identical_on_engine_matrix(n, d, k, g):
    pts, init = _dataset(n, d, k)
    base = _fit(pts, init, n_groups=g, max_iters=50, tol=1e-5,
                backend="compact", min_cap=64, tune="off")
    r_l = lloyd(torch.from_numpy(pts), torch.from_numpy(init), 50, 1e-5)
    r_j = jengine.fit(jnp.asarray(pts), jnp.asarray(init), n_groups=g,
                      max_iters=50, tol=1e-5, backend="compact", min_cap=64,
                      tune="off")
    np.testing.assert_array_equal(base.assignments.numpy(),
                                  np.asarray(r_j.assignments))
    assert int(base.n_iters) == int(r_j.n_iters)
    for cfg in TUNED_VARIANTS:
        r = _fit(pts, init, n_groups=g, max_iters=50, tol=1e-5, config=cfg,
                 tune="off")
        assert torch.equal(r.assignments, base.assignments)
        assert float(r.inertia) == float(base.inertia)
        assert int(r.n_iters) == int(base.n_iters)
        assert torch.equal(r.assignments, r_l.assignments)


def test_fit_tune_auto_consults_default_cache(tmp_cache):
    pts, init = _dataset(4200, 8, 48)          # big enough to skip lloyd
    marker = EngineConfig(backend="compact", min_cap=128, down_n=0,
                          down_g=0)
    tmp_cache.store(tune.signature(4200, 48, 8, "cpu"), marker)
    r_t, st = _fit(pts, init, max_iters=30, tune="auto", return_stats=True)
    assert st.config == marker.to_dict() and st.backend == "compact"
    r_off, st_off = _fit(pts, init, max_iters=30, tune="off",
                         return_stats=True)
    assert st_off.backend == "kernel"          # the port's untuned auto
    assert torch.equal(r_t.assignments, r_off.assignments)
    assert float(r_t.inertia) == float(r_off.inertia)
    assert int(r_t.n_iters) == int(r_off.n_iters)


def test_cached_pallas_entry_resolves_to_kernel(tmp_cache):
    pts, init = _dataset(4200, 8, 48)
    tmp_cache.store(tune.signature(4200, 48, 8, "cpu"),
                    EngineConfig(backend="pallas", tile_n=128))
    _, st = _fit(pts, init, max_iters=5, tune="auto", return_stats=True)
    assert st.backend == "kernel" and st.config["tile_n"] == 128


def test_fit_tune_force_uses_cache_hit_without_search(tmp_cache,
                                                      monkeypatch):
    pts, init = _dataset(900, 6, 9)
    tmp_cache.store(tune.signature(900, 9, 6, "cpu"),
                    EngineConfig(backend="lloyd"))
    monkeypatch.setattr(tune.search, "autotune", None)   # must not run
    r, st = _fit(pts, init, max_iters=20, tune="force", return_stats=True)
    assert st.backend == "lloyd"
    r_ref = jengine.fit(jnp.asarray(pts), jnp.asarray(init), max_iters=20,
                        backend="lloyd", tune="off")
    np.testing.assert_array_equal(r.assignments.numpy(),
                                  np.asarray(r_ref.assignments))


def test_fit_tune_force_searches_once_on_a_miss(tmp_cache, monkeypatch):
    pts, init = _dataset(2100, 6, 40)
    searched = []

    def stub_timing(points, init_c, **kw):
        searched.append(kw["device"])
        return lambda cfg: 1.0 if cfg.backend == "compact" else 2.0
    monkeypatch.setattr(tune.search, "timing_measure", stub_timing)
    r, st = _fit(pts, init, max_iters=20, tune="force", return_stats=True)
    assert len(searched) == 1 and st.backend == "compact"
    assert tmp_cache.lookup(tune.signature(2100, 40, 6, "cpu")) == \
        EngineConfig(backend="compact")
    r2, st2 = _fit(pts, init, max_iters=20, tune="force", return_stats=True)
    assert len(searched) == 1 and st2.config == st.config
    assert torch.equal(r.assignments, r2.assignments)


def test_explicit_kwargs_override_tuned_config(tmp_cache):
    pts, init = _dataset(4200, 8, 48)
    tmp_cache.store(tune.signature(4200, 48, 8, "cpu"),
                    EngineConfig(backend="compact", min_cap=1024))
    _, st = _fit(pts, init, max_iters=10, tune="auto", min_cap=64,
                 backend="compact", return_stats=True)
    assert st.config["min_cap"] == 64
    # an explicit config beats the cache entry
    _, st2 = _fit(pts, init, max_iters=10, tune="auto",
                  config=EngineConfig(backend="oracle"), return_stats=True)
    assert st2.backend == "oracle" and st2.config["min_cap"] == 256


def test_kmeans_api_tune_validation_and_passthrough(tmp_cache):
    with pytest.raises(ValueError):
        KMeans(n_clusters=4, tune="sometimes", device="cpu")
    with pytest.raises(ValueError):
        _fit(*_dataset(300, 4, 4), tune="sometimes")
    pts, _ = _dataset(1500, 8, 8)
    km = KMeans(n_clusters=8, engine="compact", seed=1, tune="off",
                device="cpu").fit(pts)
    km2 = KMeans(n_clusters=8, engine="compact", seed=1, tune="auto",
                 device="cpu").fit(pts)
    np.testing.assert_array_equal(km.labels_, km2.labels_)


# -- norm-carry contract ----------------------------------------------------

def test_x2_computed_exactly_once_per_fit(monkeypatch):
    n, d, k = 5003, 11, 40
    pts, init = _dataset(n, d, k)
    real = engine.row_norms_sq
    full_n_calls = []

    def counting(x):
        if x.ndim == 1 or x.shape[0] == n:
            full_n_calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(engine, "row_norms_sq", counting)
    for backend in ("compact", "kernel"):
        full_n_calls.clear()
        _, st = _fit(pts, init, max_iters=30, tol=1e-5, backend=backend,
                     tune="off", return_stats=True)
        assert full_n_calls.count((n, d)) == 1, full_n_calls
        assert st.n_iters > 2 and st.x2_evals == 1


# -- the tuned gather-vs-GEMM crossover -------------------------------------

def test_use_groups_decision_follows_tuned_crossover():
    for ggf, want in ((2, True), (8, False)):
        kw = dict(cap_n=512, cap_g=4, l_max=3, k=24, chunk=2048,
                  group_gather_factor=ggf)
        assert engine.use_groups_decision(**kw) is want
        assert jengine.use_groups_decision(**kw) is want
    assert not engine.use_groups_decision(
        cap_n=4096, cap_g=4, l_max=3, k=24, chunk=2048,
        group_gather_factor=2)

    pts, init = _dataset(6000, 8, 24)
    results = {}
    for ggf in (2, 8):
        cfg = EngineConfig(backend="compact", group_gather_factor=ggf)
        r, st = _fit(pts, init, n_groups=8, max_iters=40, tol=1e-5,
                     config=cfg, tune="off", return_stats=True)
        _, st_j = jengine.fit(jnp.asarray(pts), jnp.asarray(init),
                              n_groups=8, max_iters=40, tol=1e-5,
                              config=JaxEngineConfig(
                                  backend="compact", group_gather_factor=ggf),
                              tune="off", return_stats=True)
        assert len(st.use_groups) == len(st.caps_history)
        assert st.use_groups == st_j.use_groups
        results[ggf] = (r, st)
    assert not any(results[8][1].use_groups)
    assert any(results[2][1].use_groups)
    assert torch.equal(results[2][0].assignments, results[8][0].assignments)
    assert float(results[2][0].inertia) == float(results[8][0].inertia)
