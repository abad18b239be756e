"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper takes its kernel's plain version, so these
tests hold the plain versions against the Pallas kernels run with
``interpret=True`` and against ``repro.kernels.ref``. The CUDA kernels
themselves are held against the plain versions by the ``cuda``-marked
tests in ``test_torch_cuda.py`` (and by ``chip_smoke.py``), which skip
where there is no card. Inputs are made with numpy.

Tolerances: float outputs rtol 1e-5 / atol 1e-5 (the sums and dot
products run in another order than XLA's); ids and counts exact.
"""
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kmeans import centroid_sums as jax_centroid_sums
from repro.kernels import (build_group_block_mask as jax_block_mask,
                           centroid_update as jax_centroid_update,
                           grouped_assign as jax_grouped_assign)
from repro.kernels.ref import grouped_assign_ref
from repro_torch.kernels import _build, build_group_block_mask
from test_torch_cuda import (CU_SHAPES, GA_CASES, GA_LAYOUT_CASES,
                             assert_outputs, ga_inputs, ga_params)

# the package exports the wrappers under the kernels' names: the
# modules themselves, with the plain versions, come from importlib
cu = importlib.import_module("repro_torch.kernels.centroid_update")
fa = importlib.import_module("repro_torch.kernels.filtered_assign")
ga = importlib.import_module("repro_torch.kernels.grouped_assign")
psd = importlib.import_module("repro_torch.kernels.distance")


@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("n,d,k,g,tile_n,layout",
                         ga_params(GA_CASES + GA_LAYOUT_CASES))
def test_grouped_assign_plain_matches_pallas(n, d, k, g, tile_n, layout,
                                             density):
    x, c_grouped, members, mask = ga_inputs(n, d, k, g, tile_n, density,
                                             seed=n + k, layout=layout)
    if layout == "holes":       # -1 inside rows, and a group of none
        inner = (members[:, :-1] < 0) & (members[:, 1:] >= 0)
        assert inner.any() and (members < 0).all(1).any()
    got = ga.grouped_assign(torch.from_numpy(x),
                            torch.from_numpy(c_grouped),
                            torch.from_numpy(members),
                            torch.from_numpy(mask), tile_n=tile_n)
    got = [t.numpy() for t in got]
    jargs = (jnp.asarray(x), jnp.asarray(c_grouped), jnp.asarray(members),
             jnp.asarray(mask))
    assert_outputs(got, jax_grouped_assign(*jargs, tile_n=tile_n,
                                            interpret=True))
    assert_outputs(got, grouped_assign_ref(*jargs, tile_n))
    assert got[1].dtype == np.int32 and got[3].dtype == np.int32


def test_grouped_assign_cpu_takes_plain_and_counts_no_launch():
    x, c_grouped, members, mask = ga_inputs(300, 5, 11, 3, 256, 0.7, 1)
    args = [torch.from_numpy(a) for a in (x, c_grouped, members, mask)]
    before = ga.grouped_assign.launches
    got = ga.grouped_assign(*args)
    want = ga.grouped_assign_plain(*args)
    assert ga.grouped_assign.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_grouped_assign_ties_go_to_first_slot_and_earlier_group():
    # centroids 0 and 2 are the same point, in groups 0 and 1: the
    # global winner is id 0 (earlier group); inside group 1, ids 2 and 3
    # tie and id 2 (first slot) wins
    c = np.array([[1.0, 0.0], [5.0, 5.0], [1.0, 0.0], [1.0, 0.0]],
                 np.float32)
    members = np.array([[0, 1], [2, 3]], np.int32)
    x = np.zeros((3, 2), np.float32)
    mask = np.ones((1, 2), bool)
    best, idx, gmin, garg, gmin2 = ga.grouped_assign(
        torch.from_numpy(x), torch.from_numpy(c[members]),
        torch.from_numpy(members), torch.from_numpy(mask), tile_n=256)
    assert idx.tolist() == [0, 0, 0]
    assert garg[:, 1].tolist() == [2, 2, 2]
    assert gmin2[:, 1].tolist() == [1.0, 1.0, 1.0]


def test_grouped_assign_wrapper_keeps_no_copy_of_the_kernel_layout():
    """The wrapper sizes nothing from the .cu's layout: the scratch
    comes from the library's own ``grouped_assign_scratch_ints``, and
    the launch refuses a shape it cannot take."""
    for stale in ("SLOTS", "SMEM_LIMIT", "_smem_bytes"):
        assert not hasattr(ga, stale)
    src = (_build.CSRC / "grouped_assign.cu").read_text()
    assert "int grouped_assign_scratch_ints(int g, int lmax)" in src
    assert "int grouped_assign_simple_launch(" in src
    launch = src[src.index("int grouped_assign_launch("):]
    launch = launch[:launch.index("\n}\n")]
    assert "scratch_ints < grouped_assign_scratch_ints(g, lmax)" in launch
    assert "return (int)cudaErrorInvalidValue;" in launch
    wrapper = Path(ga.__file__).read_text()
    assert "grouped_assign_scratch_ints" in wrapper


@pytest.mark.parametrize("n,d,k", CU_SHAPES)
def test_centroid_update_plain_matches_pallas(n, d, k):
    rng = np.random.default_rng(n + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    a = rng.integers(-1, k, size=n).astype(np.int32)     # -1: no cluster
    sums, counts = cu.centroid_update(torch.from_numpy(x),
                                      torch.from_numpy(a), k)
    s_ref, c_ref = jax_centroid_update(jnp.asarray(x), jnp.asarray(a), k=k,
                                       interpret=True)
    np.testing.assert_allclose(sums.numpy(), np.asarray(s_ref), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))


@pytest.mark.parametrize("n,d,k", CU_SHAPES)
def test_centroid_update_weighted_matches_segment_sum(n, d, k):
    rng = np.random.default_rng(n * d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    a = rng.integers(0, k, size=n).astype(np.int32)
    w = rng.random(n).astype(np.float32)
    sums, counts = cu.centroid_update(torch.from_numpy(x),
                                      torch.from_numpy(a), k,
                                      torch.from_numpy(w))
    s_ref, c_ref = jax_centroid_sums(jnp.asarray(x), jnp.asarray(a), k,
                                     weights=jnp.asarray(w))
    np.testing.assert_allclose(sums.numpy(), np.asarray(s_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(counts.numpy(), np.asarray(c_ref), rtol=1e-5)


def test_centroid_update_unit_weights_bit_identical():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((777, 9)).astype(np.float32))
    a = torch.from_numpy(rng.integers(-1, 13, size=777).astype(np.int32))
    s0, c0 = cu.centroid_update(x, a, 13)
    s1, c1 = cu.centroid_update(x, a, 13, torch.ones(777))
    assert torch.equal(s0, s1) and torch.equal(c0, c1)


# every shape the first kernel took (its check: (32 K + K) * 4 bytes of
# shared memory at most 232,448, so K <= 1760), from one row to
# uci-xlarge and uci-highk
PLAN_SHAPES = CU_SHAPES + [(1, 5, 3), (0, 4, 2), (3000, 32, 256),
                           (100_003, 33, 1024), (1 << 20, 32, 256),
                           (262_144, 32, 1024), (65_536, 128, 1024),
                           (1000, 32, 1760), (77, 1, 1760)]


@pytest.mark.parametrize("n,d,k", PLAN_SHAPES)
def test_centroid_update_plan_fits_and_covers(n, d, k):
    p = cu.plan(n, d, k)
    assert p == cu.plan(n, d, k)             # a function of the shapes
    assert p.smem == 4 * p.warps * p.warp_floats <= 232_448
    assert p.warp_floats % 4 == 0            # 16-byte aligned warps
    # the .cu's warp_floats_needed: x ring, accumulator, counts, labels
    # and weights
    assert p.warp_floats >= cu.STAGES * p.stage_rows * (p.tile + 2) \
        + k * p.tile + k
    assert 1 <= p.warps <= 8 and 1 <= p.tile <= 32
    if p.warps > 1:                          # two blocks an SM
        assert 2 * (p.smem + cu.BLOCK_RESERVED) <= cu.SM_SMEM
    assert p.d_tiles * p.tile >= d > (p.d_tiles - 1) * p.tile
    assert p.chunks * p.rows_per_chunk >= n
    assert (p.chunks - 1) * p.rows_per_chunk < max(n, 1)   # none empty
    assert p.warps * p.rows_per_warp >= p.rows_per_chunk


def test_centroid_update_plan_constants_match_the_kernel_source():
    src = (Path(cu.__file__).parent / "csrc" / "centroid_update.cu") \
        .read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kStages"]), int(consts["kGroup"])) == \
        (cu.STAGES, cu.GROUP)


def test_centroid_update_plan_takes_every_k_the_first_kernel_took():
    for k in list(range(1, 1761, 29)) + [1760]:
        assert cu.plan(1 << 20, 32, k).smem <= cu.SMEM_LIMIT
    assert cu.plan(1 << 20, 32, 256).chunks == cu.TARGET_BLOCKS
    with pytest.raises(ValueError, match="shared memory"):
        cu.plan(10, 4, 40_000)


@pytest.mark.parametrize("n,tile_n", [(600, 256), (512, 256), (130, 64)])
def test_group_block_mask_matches_jax(n, tile_n):
    need = np.random.default_rng(n).random((n, 5)) < 0.01
    got = build_group_block_mask(torch.from_numpy(need), tile_n=tile_n)
    want = jax_block_mask(jnp.asarray(need), tile_n=tile_n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kernel_sources_export_the_wrappers_entry_points():
    """Each wrapper binds ``<name>_launch`` and ``<name>_error_string``
    from ``csrc/<name>.cu``; the build keys on the source's hash."""
    assert set(_build.sources()) == {"centroid_update", "filtered_assign",
                                     "flash_attention", "flash_attention_bwd",
                                     "grouped_assign", "pairwise_sq_dists",
                                     "ssd_intra", "ssd_intra_bwd"}
    for name in _build.sources():
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert f"int {name}_launch(" in text
        assert f"const char* {name}_error_string(int code)" in text
        path = _build.library_path(name)
        assert path.name == f"lib{name}.so" and path.parent.parent == \
            _build.BUILD_ROOT
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.mark.parametrize("name", ["filtered_assign", "pairwise_sq_dists",
                                  "grouped_assign"])
def test_redesigned_sources_keep_their_first_kernel(name):
    """The kernels redesigned for the card keep the port's first kernel
    in the same source, exported beside the launch as the yardstick."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    assert f"int {name}_launch(" in text
    assert f"int {name}_simple_launch(" in text
    if name != "grouped_assign":
        # both kernels form the distance with the one expression
        assert text.count("fmaxf(xx - 2.0f * acc + c2, 0.0f)") == 1
        assert text.count("sq_dist(") >= 3


@pytest.mark.parametrize("simple,args", [
    (fa.filtered_assign_simple,
     (torch.zeros(8, 4), torch.zeros(3, 4), torch.ones(1, 1, dtype=torch.bool))),
    (psd.pairwise_sq_dists_simple, (torch.zeros(8, 4), torch.zeros(3, 4))),
], ids=["filtered_assign", "pairwise_sq_dists"])
def test_first_kernels_take_cuda_tensors_only(simple, args):
    with pytest.raises(ValueError, match="CUDA tensors expected"):
        simple(*args)


def test_filtered_assign_wrapper_keeps_no_copy_of_the_kernel_layout():
    """The launch picks its variant itself, from the shape alone, and
    launches no other kernel: the wrapper passes the shape and asks the
    library's ``filtered_assign_variant`` which variant that is."""
    for stale in ("THREADS", "LANE_PAIRS", "MIN_TILE_N", "MERGE_FLOATS",
                  "SMEM_LIMIT", "smem_bytes"):
        assert not hasattr(fa, stale)
    src = (_build.CSRC / "filtered_assign.cu").read_text()
    assert "int filtered_assign_variant(int d, int k, int tile_n, " \
        "int tile_k,\n" in src
    launch = src[src.index("int filtered_assign_launch("):]
    launch = launch[:launch.index("\n}\n")]
    assert "int tile_k, void* stream) {" in launch      # no variant given
    assert "variant_for(d, k, tile_n, tile_k, &points, &stages)" in launch
    assert "return (int)cudaErrorInvalidValue;" in launch
    assert "simple" not in launch and "kMinTileN" not in src
    wrapper = Path(fa.__file__).read_text()
    assert "filtered_assign_variant" in wrapper


@pytest.mark.parametrize("shape", [(32, 256, 256, 128), (32, 1024, 64, 8),
                                   (33, 77, 4, 8)])
def test_filtered_assign_variant_asks_the_library(monkeypatch, shape):
    """``variant`` hands the library the shape and nothing else, and
    returns the pair the library writes."""
    seen = []

    def entry(name, symbol, argtypes, restype=None):
        def fn(*args):
            seen.append((name, symbol, args[:4]))
            args[4]._obj.value, args[5]._obj.value = 64, 2
            return 1
        return fn
    monkeypatch.setattr(_build, "entry", entry)
    assert fa.variant(*shape) == (64, 2)
    assert seen == [("filtered_assign", "filtered_assign_variant", shape)]
