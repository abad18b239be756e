"""The port's kernel entry point against the JAX package's.

``repro_torch.kernels`` against ``repro.kernels`` on the same numpy
inputs: ``pairwise_sq_dists`` and ``filtered_assign`` (on the CPU each
takes its plain version) against the Pallas kernels run with
``interpret=True`` and against ``repro.kernels.ref``, and the glue
(``build_block_mask``, ``compact_indices``, ``filtered_assign_auto``)
against JAX's. The CUDA kernels themselves are held against the plain
versions by the ``cuda``-marked tests in ``test_torch_cuda.py``.

Tolerances are those of ``tests/test_kernels.py``: rtol 1e-5 in fp32
and 5e-2 in bf16 (atol ten times that) for distances, rtol/atol 1e-5
for minima; argmin ids, masks, indices and counts exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels as tk
from repro.kernels import (build_block_mask, compact_indices,
                           filtered_assign, filtered_assign_auto,
                           pairwise_sq_dists)
from repro.kernels.ref import filtered_assign_ref, pairwise_sq_dists_ref
from repro_torch.kernels import ref as tref
from test_torch_cuda import BS_TILES, CU_SHAPES, SMALL_TILES, fa_inputs

DTYPES = [(jnp.float32, torch.float32, 1e-5),
          (jnp.bfloat16, torch.bfloat16, 5e-2)]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("tile_n,tile_k", BS_TILES)
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n,d,k", CU_SHAPES)
def test_pairwise_sq_dists_matches_jax(n, d, k, jdt, tdt, tol, tile_n,
                                       tile_k):
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    before = tk.pairwise_sq_dists.launches
    got = tk.pairwise_sq_dists(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(c).to(tdt), tile_n=tile_n,
                               tile_k=tile_k)
    assert tk.pairwise_sq_dists.launches == before   # plain on the CPU
    assert got.dtype == torch.float32 and got.shape == (n, k)
    jx, jc = jnp.asarray(x).astype(jdt), jnp.asarray(c).astype(jdt)
    for want in (pairwise_sq_dists(jx, jc, tile_n=tile_n, tile_k=tile_k,
                                   interpret=True),
                 pairwise_sq_dists_ref(jx, jc)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=tol,
                                   atol=tol * 10)


@pytest.mark.parametrize("n,d,k,tile_n,tile_k,density", [
    (n, d, k, tn, tk, p) for n, d, k in CU_SHAPES for tn, tk in BS_TILES
    for p in (0.0, 0.35, 1.0)] + [
    # fewer points per tile than centroids per staged chunk of the kernel
    (130, 7, 17, tn, tk, p) for tn, tk in SMALL_TILES for p in (0.35, 1.0)])
def test_filtered_assign_matches_jax(n, d, k, density, tile_n, tile_k):
    x, c, mask = fa_inputs(n, d, k, tile_n, tile_k, density, seed=n * k + 1)
    before = tk.filtered_assign.launches
    best, idx = tk.filtered_assign(torch.from_numpy(x), torch.from_numpy(c),
                                   torch.from_numpy(mask), tile_n=tile_n,
                                   tile_k=tile_k)
    assert tk.filtered_assign.launches == before     # plain on the CPU
    assert best.dtype == torch.float32 and idx.dtype == torch.int32
    jx, jc, jm = jnp.asarray(x), jnp.asarray(c), jnp.asarray(mask)
    for wb, wi in (filtered_assign(jx, jc, jm, tile_n=tile_n, tile_k=tile_k,
                                   interpret=True),
                   filtered_assign_ref(jx, jc, jm, tile_n, tile_k)):
        wb, wi = np.asarray(wb), np.asarray(wi)
        finite = np.isfinite(wb)
        assert (np.isfinite(best.numpy()) == finite).all()
        np.testing.assert_allclose(best.numpy()[finite], wb[finite],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(idx.numpy(), wi)
    assert ((idx.numpy() == -1) == ~np.isfinite(best.numpy())).all()


@pytest.mark.parametrize("tile_n,tile_k", BS_TILES)
def test_filtered_assign_takes_norms_as_given(tile_n, tile_k):
    # the norms are used as given, so scaled norms change the result in
    # both packages alike
    n, d, k = 1000, 48, 300
    x, c, mask = fa_inputs(n, d, k, tile_n, tile_k, 0.35, seed=5)
    x2 = (x * x).sum(-1) * 1.5
    c2 = (c * c).sum(-1) * 0.5
    best, idx = tk.filtered_assign(
        torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(mask),
        tile_n=tile_n, tile_k=tile_k, x2=torch.from_numpy(x2),
        c2=torch.from_numpy(c2))
    wb, wi = filtered_assign(jnp.asarray(x), jnp.asarray(c),
                             jnp.asarray(mask), tile_n=tile_n, tile_k=tile_k,
                             interpret=True, x2=jnp.asarray(x2),
                             c2=jnp.asarray(c2))
    wb = np.asarray(wb)
    finite = np.isfinite(wb)
    np.testing.assert_allclose(best.numpy()[finite], wb[finite], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))


def test_filtered_assign_ties_go_to_the_lowest_index():
    # duplicated centroids across and within blocks: the first copy wins
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, 5)).astype(np.float32)
    base = rng.standard_normal((6, 5)).astype(np.float32)
    c = np.concatenate([base, base[::-1], base]).astype(np.float32)
    for tile_k in (4, 8, 16):
        mask = np.ones((-(-300 // 64), -(-18 // tile_k)), bool)
        _, idx = tk.filtered_assign(torch.from_numpy(x), torch.from_numpy(c),
                                    torch.from_numpy(mask), tile_n=64,
                                    tile_k=tile_k)
        _, want = filtered_assign(jnp.asarray(x), jnp.asarray(c),
                                  jnp.asarray(mask), tile_n=64,
                                  tile_k=tile_k, interpret=True)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
        assert idx.numpy().max() < 6


@pytest.mark.parametrize("tile_n,tile_k", [(64, 4), (64, 8), (32, 16)])
def test_filtered_assign_dead_duplicate_does_not_win(tile_n, tile_k):
    # centroid 1 is copied to the last block; centroid 1's block is dead
    # for every tile, so the copy in the live block wins, at the distance
    # the dead one would tie at
    rng = np.random.default_rng(7)
    x = rng.standard_normal((200, 6)).astype(np.float32)
    c = rng.standard_normal((40, 6)).astype(np.float32)
    c[39] = c[1]
    x[:100] = c[1] + 1e-3 * x[:100]          # half the points near it
    mask = np.ones((-(-200 // tile_n), -(-40 // tile_k)), bool)
    mask[:, 1 // tile_k] = False
    best, idx = tk.filtered_assign(torch.from_numpy(x), torch.from_numpy(c),
                                   torch.from_numpy(mask), tile_n=tile_n,
                                   tile_k=tile_k)
    wb, wi = filtered_assign(jnp.asarray(x), jnp.asarray(c),
                             jnp.asarray(mask), tile_n=tile_n, tile_k=tile_k,
                             interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    np.testing.assert_allclose(best.numpy(), np.asarray(wb), rtol=1e-5,
                               atol=1e-5)
    assert (idx.numpy()[:100] == 39).all()
    assert not (idx.numpy() == 1).any()


@pytest.mark.parametrize("n,k,g,tile_n,tile_k", [
    (600, 96, 4, 256, 32),        # tests/test_kernels.py's case
    (1000, 300, 7, 256, 128),
    (130, 17, 3, 64, 16),
    (513, 77, 8, 64, 8),
])
def test_build_block_mask_matches_jax(n, k, g, tile_n, tile_k):
    rng = np.random.default_rng(n + g)
    need = rng.random((n, g)) < 0.002
    groups = rng.integers(0, g, size=k).astype(np.int32)
    got = tk.build_block_mask(torch.from_numpy(need),
                              torch.from_numpy(groups), tile_n=tile_n,
                              tile_k=tile_k)
    want = build_block_mask(jnp.asarray(need), jnp.asarray(groups),
                            tile_n=tile_n, tile_k=tile_k)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,p,capacity", [
    (777, 0.2, 777),              # tests/test_kernels.py's case
    (777, 0.2, 256),              # roomier than the count
    (1000, 0.5, 256),             # count past the capacity: dropped
    (64, 0.0, 16),                # nothing to keep
])
def test_compact_indices_matches_jax(n, p, capacity):
    mask = np.random.default_rng(n).random(n) < p
    idx, valid, count = tk.compact_indices(torch.from_numpy(mask),
                                           capacity=capacity)
    j_idx, j_valid, j_count = compact_indices(jnp.asarray(mask),
                                              capacity=capacity)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    assert int(count) == int(j_count) == int(mask.sum())
    assert idx.dtype == torch.int32


@pytest.mark.parametrize("tile_n,tile_k", BS_TILES)
@pytest.mark.parametrize("p", [0.0, 0.05, 1.0])
def test_filtered_assign_auto_matches_jax(p, tile_n, tile_k):
    rng = np.random.default_rng(11)
    n, d, k, g = 500, 24, 64, 4
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    groups = (np.arange(k) % g).astype(np.int32)
    need = rng.random((n, g)) < p
    best, idx, dens = tk.filtered_assign_auto(
        torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(need),
        torch.from_numpy(groups), tile_n=tile_n, tile_k=tile_k)
    wb, wi, wd = filtered_assign_auto(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(need),
        jnp.asarray(groups), tile_n=tile_n, tile_k=tile_k, interpret=True)
    wb = np.asarray(wb)
    finite = np.isfinite(wb)
    np.testing.assert_allclose(best.numpy()[finite], wb[finite], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    assert float(dens) == float(wd)
    if p == 1.0:                  # every block live: the dense argmin
        d2 = tref.pairwise_sq_dists_ref(torch.from_numpy(x),
                                        torch.from_numpy(c))
        np.testing.assert_array_equal(idx.numpy(),
                                      torch.argmin(d2, 1).numpy())
        assert float(dens) == 1.0


def test_package_exports_the_reference_names():
    for name in ("pairwise_sq_dists", "filtered_assign",
                 "filtered_assign_auto", "build_block_mask",
                 "compact_indices", "grouped_assign", "centroid_update",
                 "build_group_block_mask"):
        assert callable(getattr(tk, name)), name
        assert name in tk.__all__
    assert hasattr(tk.pairwise_sq_dists, "launches")
    assert hasattr(tk.filtered_assign, "launches")
