"""The rest of the port's k-means surface against the JAX package's, on
the CPU: ``configs.kpynq``, ``TokenPipeline`` and ``PrefetchingLoader``
(``repro_torch.data``), ``core.integrations`` and the four examples
(``repro_torch.examples``).

``cluster_kv_cache`` runs both packages' plain Yinyang fits from JAX's
per-head k-means++ seeds (handed to the port as ``inits``), on keys
drawn as blobs so that no point sits at a near-tie between two
centroids: centroids, value means and counts within rtol 1e-5 (fp32
sums in another order). ``clustered_attention_scores`` on the same
inputs within rtol 1e-5. ``kmeans_router_init`` runs both packages'
fits from JAX's k-means++ seeds (``init``) over JAX's embeddings:
routers within 1e-6. Batches and configs are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import kpynq as jax_kpynq
from repro.core.init import kmeans_plusplus as jax_kmeans_plusplus
import repro.models as jax_models
from repro.core.integrations import cluster_kv_cache as jax_cluster_kv
from repro.core.integrations import kmeans_router_init as jax_router_init
from repro.core.integrations import \
    clustered_attention_scores as jax_clustered_scores
from repro.data import TokenPipeline as JaxPipeline
from repro_torch import configs
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import integrations
from repro_torch.data import PointStream, PrefetchingLoader, TokenPipeline
from repro_torch.examples import (expert_bootstrap, kmeans_clustering,
                                  quickstart, serve_kmeans)
from repro_torch.streaming import StreamingKMeans


def test_paper_suite_equal_field_for_field():
    assert [dataclasses.asdict(p) for p in configs.paper_suite] == \
        [dataclasses.asdict(p) for p in jax_kpynq.paper_suite]
    for name in ("production", "smoke"):
        assert dataclasses.asdict(getattr(configs, name)) == \
            dataclasses.asdict(getattr(jax_kpynq, name))
    assert [f.name for f in dataclasses.fields(configs.KMeansProblem)] == \
        [f.name for f in dataclasses.fields(jax_kpynq.KMeansProblem)]


# -- token batches ------------------------------------------------------------

CORPUS = (np.arange(10_000, dtype=np.int64) * 7919 % 251).astype(np.int32)


@pytest.mark.parametrize("arch,corpus", [
    ("qwen2-7b", False), ("qwen2-7b", True), ("hymba-1.5b", False),
    ("llava-next-mistral-7b", False)])
def test_token_pipeline_matches_jax(arch, corpus):
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    kw = dict(batch=3, seq=24, seed=5, corpus=CORPUS if corpus else None)
    mine, ref = TokenPipeline(cfg, **kw), JaxPipeline(jcfg, **kw)
    for step in (0, 1, 7, 1000):
        got, want = mine.global_batch(step), ref.global_batch(step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == np.asarray(want[key]).dtype, key
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))


def test_pipeline_deterministic_per_step():
    cfg = get_config("qwen2-7b").reduced()
    p1 = TokenPipeline(cfg, batch=4, seq=32, seed=9)
    p2 = TokenPipeline(cfg, batch=4, seq=32, seed=9)
    for step in (0, 5, 1000):
        a, b = p1.global_batch(step), p2.global_batch(step)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
    assert not np.array_equal(p1.global_batch(0)["tokens"],
                              p1.global_batch(1)["tokens"])


def test_labels_are_shifted_tokens():
    cfg = get_config("qwen2-7b").reduced()
    p = TokenPipeline(cfg, batch=2, seq=16, seed=0,
                      corpus=np.arange(10_000, dtype=np.int32) % cfg.vocab)
    b = p.global_batch(3)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# -- the prefetch thread -------------------------------------------------------

def test_prefetching_loader_orders_steps():
    cfg = get_config("musicgen-medium").reduced()
    p = TokenPipeline(cfg, batch=2, seq=8, seed=1)
    loader = PrefetchingLoader(p, device="cpu", start_step=0, depth=2)
    steps = [next(loader)[0] for _ in range(5)]
    loader.close()
    assert steps == [0, 1, 2, 3, 4]


def test_prefetching_loader_batches_and_close():
    """From ``start_step``, each batch is the pipeline's as tensors on
    the device; ``close()`` stops the thread."""
    cfg = get_config("qwen2-7b").reduced()
    p = TokenPipeline(cfg, batch=2, seq=8, seed=4)
    loader = PrefetchingLoader(p, device="cpu", start_step=3, depth=3)
    for want_step in (3, 4, 5, 6):
        step, batch = next(loader)
        assert step == want_step
        for key, arr in p.global_batch(step).items():
            assert isinstance(batch[key], torch.Tensor)
            assert batch[key].device.type == "cpu"
            np.testing.assert_array_equal(batch[key].numpy(), arr)
    loader.close()
    assert not loader.thread.is_alive()


def test_prefetched_stream_fits_as_the_direct_one():
    """A PointStream epoch through the loader into ``fit_stream`` gives
    the directly fed epoch's centroids bit for bit."""
    stream = PointStream(512, n_shards=6, n_dims=8, k=8, seed=2)
    kw = dict(seed=0, init_size=1024, device="cpu")
    direct = StreamingKMeans(8, **kw).fit_stream(
        [stream.global_batch(i) for i in range(6)])
    loader = PrefetchingLoader(stream, device="cpu")
    items = [next(loader) for _ in range(6)]
    loader.close()
    fed = StreamingKMeans(8, **kw).fit_stream(items)
    np.testing.assert_array_equal(fed.cluster_centers_,
                                  direct.cluster_centers_)
    assert fed.stats_.cache_hits == direct.stats_.cache_hits


# -- KV-cache clustering -------------------------------------------------------

def _kv(s, h, dh, blobs, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((h, blobs, dh)).astype(np.float32) * 6
    pick = rng.integers(0, blobs, (s, h))
    keys = np.stack([centers[i][pick[:, i]] for i in range(h)], axis=1)
    keys = keys + rng.standard_normal((s, h, dh)).astype(np.float32) * 0.5
    vals = rng.standard_normal((s, h, dh)).astype(np.float32)
    return keys.astype(np.float32), vals


@pytest.mark.parametrize("s,h,dh,k,seed", [(256, 2, 16, 8, 0),
                                           (300, 3, 32, 12, 1)])
def test_cluster_kv_cache_matches_jax(s, h, dh, k, seed):
    keys, vals = _kv(s, h, dh, k, seed)
    jk, jv = jnp.asarray(keys), jnp.asarray(vals)
    want = jax_cluster_kv(jk, jv, k, seed=seed)
    inits = np.stack([np.asarray(jax_kmeans_plusplus(
        jax.random.PRNGKey(seed + head), jk[:, head], k))
        for head in range(h)])
    got = integrations.cluster_kv_cache(torch.from_numpy(keys),
                                        torch.from_numpy(vals), k,
                                        inits=inits)
    for name, g, w in zip(("centroids", "values", "counts"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert float(got[2].sum()) == s * h
    q = np.random.default_rng(seed + 9).standard_normal((h, dh)).astype(
        np.float32)
    ws = jax_clustered_scores(jnp.asarray(q), want[0], want[2], 0.25)
    gs = integrations.clustered_attention_scores(
        torch.from_numpy(q), torch.from_numpy(np.array(want[0])),
        torch.from_numpy(np.array(want[2])), 0.25)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-7)


def test_cluster_kv_cache_own_seeds_and_router():
    keys, vals = _kv(200, 2, 8, 4, 3)
    c, v, n = integrations.cluster_kv_cache(torch.from_numpy(keys),
                                            torch.from_numpy(vals), 4, seed=3)
    assert tuple(c.shape) == tuple(v.shape) == (4, 2, 8)
    assert tuple(n.shape) == (4, 2) and float(n.sum()) == 400
    again = integrations.cluster_kv_cache(torch.from_numpy(keys),
                                          torch.from_numpy(vals), 4, seed=3)
    assert torch.equal(c, again[0])
    # the router bootstrap refuses a config without experts, as the
    # reference does
    with pytest.raises(ValueError, match="only applies to MoE"):
        integrations.kmeans_router_init({}, get_config("qwen2-7b").reduced(),
                                        None)


# -- the MoE router bootstrap --------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("seed", [0, 3])
def test_kmeans_router_init_matches_jax(arch, seed):
    """Both packages' Yinyang fits from JAX's k-means++ seeds (handed to
    the port as ``init``) over JAX's embeddings of the same tokens: every
    layer's router within 1e-6 (fp32 sums in another order), every other
    leaf untouched."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jparams = jax_models.init_params(jax.random.PRNGKey(seed), jcfg)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (4, 128))
    toks = toks.astype(np.int32)
    want = jax_router_init(jparams, jcfg, jnp.asarray(toks), seed=seed)
    embeds = jnp.take(jparams["embed"], jnp.asarray(toks).reshape(-1),
                      axis=0).astype(jnp.float32)
    init = np.array(jax_kmeans_plusplus(jax.random.PRNGKey(seed), embeds,
                                        jcfg.n_experts))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                  device="cpu")
    got = integrations.kmeans_router_init(params, cfg, torch.from_numpy(toks),
                                          init=init)
    router = got["layers"]["moe"]["router"]
    assert tuple(router.shape) == (cfg.n_layers, cfg.d_model, cfg.n_experts)
    np.testing.assert_allclose(router.numpy(),
                               np.asarray(want["layers"]["moe"]["router"]),
                               rtol=0, atol=1e-6)
    assert got["layers"]["moe"]["w_gate"] is params["layers"]["moe"]["w_gate"]
    assert got["embed"] is params["embed"]
    # its own k-means++ seeds: unit columns (but for the + 1e-6 over
    # centroid norms of about 0.05), the same on a second call
    own = integrations.kmeans_router_init(params, cfg, torch.from_numpy(toks),
                                          seed=seed)["layers"]["moe"]["router"]
    np.testing.assert_allclose(own.norm(dim=1).numpy(), 1.0, atol=1e-4)
    assert torch.equal(own, integrations.kmeans_router_init(
        params, cfg, torch.from_numpy(toks), seed=seed)["layers"]["moe"]
        ["router"])


# -- the examples --------------------------------------------------------------

def test_quickstart_example_on_cpu(capsys):
    km, ref = quickstart.main(["--device", "cpu", "--n", "20000"])
    assert km.distance_evals_ < ref.distance_evals_
    assert "OK" in capsys.readouterr().out


def test_kmeans_clustering_example_on_cpu(capsys):
    kmeans_clustering.main(["--device", "cpu", "--scale", "0.01",
                            "--max-datasets", "2", "--world", "2"])
    out = capsys.readouterr().out
    assert "uci-medium" in out and "telemetry:" in out
    assert "matches single-device: True" in out


def test_expert_bootstrap_example_on_cpu(capsys):
    (ent_rand, load_rand), (ent_km, load_km) = expert_bootstrap.main(
        ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "random router: entropy=" in out and "kmeans router" in out
    for ent, load in ((ent_rand, load_rand), (ent_km, load_km)):
        assert 0.0 < ent <= np.log(4) + 1e-9 and 1.0 <= load <= 4.0


def test_serve_example_on_cpu(capsys):
    served, epochs = serve_kmeans.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert served > 0 and len(epochs) > 1
    assert "pts/s" in out and "epoch ->" in out
