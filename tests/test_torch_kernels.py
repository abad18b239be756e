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
from repro_torch.core import engine
from repro_torch.core.kmeans import segment_max
from repro_torch.kernels import _build, build_group_block_mask
from test_torch_cuda import (BU_CPU_CASES, CT_CASES, CU_SHAPES, GA_CASES,
                             GA_LAYOUT_CASES, assert_outputs, bu_inputs,
                             bu_params, ct_inputs, ct_params, ct_pass,
                             ga_inputs, ga_params)

# the package exports the wrappers under the kernels' names: the
# modules themselves, with the plain versions, come from importlib
bu = importlib.import_module("repro_torch.kernels.bounds_upkeep")
ct = importlib.import_module("repro_torch.kernels.candidate_tail")
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
    assert set(_build.sources()) == {"bounds_upkeep", "candidate_tail",
                                     "centroid_update", "filtered_assign",
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
    returns the three values the library writes."""
    seen = []

    def entry(name, symbol, argtypes, restype=None):
        def fn(*args):
            seen.append((name, symbol, args[:4]))
            args[4]._obj.value, args[5]._obj.value = 64, 2
            args[6]._obj.value = 32
            return 1
        return fn
    monkeypatch.setattr(_build, "entry", entry)
    assert fa.variant(*shape) == (64, 2, 32)
    assert seen == [("filtered_assign", "filtered_assign_variant", shape)]


def _frozen_upkeep(points, x2, new_c, new_c2, assignments, ub, lb, drift,
                   group_drift, refresh):
    """The bounds' upkeep and refresh of ``engine.move_and_bounds`` as
    they were written before they became one call, kept as they were:
    the CPU's yardstick."""
    a = assignments.long()
    ub = ub + drift[a]
    lb_dec = torch.clamp_min(lb - group_drift[None, :], 0.0)
    glb = torch.min(lb_dec, dim=1).values
    maybe = ub > glb
    if refresh:
        if x2 is None:
            diff = points.float() - new_c[a].float()
            d_own = torch.sqrt(torch.clamp_min(torch.sum(diff * diff,
                                                         dim=-1), 0.0))
        else:
            d_own = torch.sqrt(torch.clamp_min(
                x2 - 2.0 * torch.sum(points * new_c[a], dim=-1)
                + new_c2[a], 0.0))
        ub_t = torch.where(maybe, d_own, ub)
        need = ub_t > glb
    else:
        ub_t, need = ub, maybe
    return ub_t, lb_dec, need, maybe.sum()


@pytest.mark.parametrize("refresh,x2", [(True, True), (True, False),
                                        (False, True), (False, False)],
                         ids=["refresh", "refresh-direct", "no", "no-no-x2"])
@pytest.mark.parametrize("n,d,k,g,gdrift", bu_params(BU_CPU_CASES))
def test_bounds_upkeep_on_cpu_is_the_old_arithmetic(n, d, k, g, gdrift,
                                                    refresh, x2):
    """A CPU tensor takes the plain version, bit for bit the arithmetic
    the move had before, and counts no launch."""
    args = list(bu_inputs(n, d, k, g, seed=n + g, gdrift=gdrift))
    if not x2:
        args[1] = None
    before = bu.bounds_upkeep.launches
    got = bu.bounds_upkeep(*args, refresh=refresh)
    assert bu.bounds_upkeep.launches == before
    want = _frozen_upkeep(*args, refresh)
    for name, a, b in zip(("ub_t", "lb_dec", "need", "tightened"), got,
                          want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert 0 < int(want[3]) < n


@pytest.mark.parametrize("n,d,k,g", BU_CPU_CASES)
def test_own_dists_on_cpu_is_the_compact_pass_arithmetic(n, d, k, g):
    """On the CPU ``own_dists`` is the expression the compact pass's
    in-pass refresh had before, bit for bit, and the refresh's own
    arithmetic inside ``bounds_upkeep_plain``; it counts no launch."""
    points, x2, c, c2, labels = bu_inputs(n, d, k, g, seed=n)[:5]
    before = bu.own_dists.launches
    got = bu.own_dists(points, x2, c, c2, labels)
    assert bu.own_dists.launches == before
    a = labels.long()
    want = torch.sqrt(torch.clamp_min(
        x2 - 2.0 * torch.sum(points * c[a], dim=-1) + c2[a], 0.0))
    assert torch.equal(got, want)


@pytest.mark.parametrize("refresh", [True, False], ids=["refresh", "no"])
@pytest.mark.parametrize("rule", ["batch", "ema"])
@pytest.mark.parametrize("with_x2", [True, False], ids=["x2", "no-x2"])
def test_move_and_bounds_on_cpu_keeps_its_bits(rule, refresh, with_x2):
    """``engine.move_and_bounds`` on the CPU against the move written out
    with the frozen upkeep: every field bit for bit, for the batch rule
    (an empty group's -inf drift) and the stream's EMA (clamped), with
    sentinel rows (ub 0, lb +inf) among the points."""
    rng = np.random.default_rng(3)
    n, d, k, g = 2000, 8, 40, 6
    pts = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    cents = pts[::50][:k].clone()
    groups = torch.from_numpy((np.arange(k) % (g - 1)).astype(np.int32))
    assign = torch.from_numpy(rng.integers(0, k, n).astype(np.int32))
    ub = torch.from_numpy(rng.uniform(0, 3, n).astype(np.float32))
    lb = torch.from_numpy(rng.uniform(0, 3, (n, g)).astype(np.float32))
    ub[::97], lb[::97] = 0.0, float("inf")
    x2 = (pts * pts).sum(1) if with_x2 else None
    update = engine.CONVERGENCE_UPDATE if rule == "batch" \
        else engine.EMA_UPDATE
    counts = torch.from_numpy(rng.uniform(0, 4, k).astype(np.float32))
    decay = torch.tensor(0.9)
    got = engine.move_and_bounds(pts, cents, assign, ub, lb, groups, k=k,
                                 n_groups=g, update=update, counts=counts,
                                 decay=decay, x2=x2, refresh=refresh)
    sums, bcounts = cu.centroid_update(pts, assign, k)
    new_c, new_counts = update.apply(sums, bcounts, cents, counts, decay)
    new_c2 = (new_c * new_c).sum(-1)
    drift = torch.sqrt(torch.sum((new_c - cents) ** 2, dim=-1))
    gdrift = segment_max(drift, groups, g)
    if update.clamp_gdrift:
        gdrift = torch.clamp_min(gdrift, 0.0)
    assert (float(gdrift[-1]) == 0.0) if rule == "ema" \
        else (float(gdrift[-1]) == float("-inf"))
    ub_t, lb_dec, need, tightened = _frozen_upkeep(
        pts, x2, new_c, new_c2, assign, ub, lb, drift, gdrift, refresh)
    want = engine.MoveOut(new_c, new_c2, new_counts, ub_t, lb_dec, need,
                          torch.max(drift), tightened, drift, gdrift,
                          bcounts)
    for name in engine.MoveOut._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("g,rows", [(1, 256), (6, 256), (25, 256),
                                    (102, 64), (1024, 4), (20_000, 1)])
def test_bounds_upkeep_plan_follows_the_groups(g, rows):
    """Points a block, a function of G alone: one a thread, a multiple
    of 4 (each block's run of the N x G table starts on 16 bytes) while
    eight blocks fit an SM; past that as many as one block holds."""
    got, smem = bu.plan(g)
    assert got == rows
    assert smem == 4 * (bu.head_floats(g) + rows * g)
    if rows >= 4:
        assert rows % 4 == 0 and bu.BLOCKS_PER_SM * (
            smem + bu.BLOCK_RESERVED) <= bu.SM_SMEM
    assert smem <= bu.SMEM_LIMIT


def test_bounds_upkeep_plan_refuses_a_row_too_wide():
    with pytest.raises(ValueError, match="shared memory"):
        bu.plan(60_000)


def test_bounds_upkeep_source_keeps_its_contract():
    """The kernels' names stay outside the rooflines' patterns of the
    other two k-means kernels; the refresh's dot rounds each product
    before it adds it (no fused multiply-add); no float is added
    atomically, only the int64 count; the blocks an SM and the depth the
    registers were tuned for are fixed in the source, not build
    settings."""
    src = (_build.CSRC / "bounds_upkeep.cu").read_text()
    names = re.findall(r"__global__ void __launch_bounds__\([\w, ]+\)\n"
                       r"(\w+)\(", src)
    assert names == ["bu_upkeep_kernel", "bu_own_kernel"]
    for pattern in (r"\b(cu_partial|cu_reduce)\b",
                    r"\b(ga_kernel|ga_plan_kernel)\b"):
        assert not re.search(pattern, src)
    assert "fmaf(" not in src and "__fmaf" not in src
    assert "__fadd_rn(acc[q], __fmul_rn(xv.x, cv.x))" in src
    assert "__fmul_rn(__ldg(xr + j), __ldg(cr + j))" in src
    assert re.findall(r"atomicAdd\((\w+), \(unsigned long long\)", src) == \
        ["tightened"]
    assert src.count("atomicAdd(") == 1
    assert "#ifndef" not in src and "#define" not in src
    assert "constexpr int kMinBlocks = 4;" in src
    assert "constexpr int kDepth = 4;" in src


def _frozen_tail(best2, idx, gmin, garg, gmin2, assignments, ub_t, lb, need,
                 groups):
    """The candidate pass after ``grouped_assign`` as
    ``engine.kernel_candidate_pass`` and ``_finish_pass`` wrote it before
    it became one call, kept as it was (``min_at`` and ``_left_at``
    written out): the CPU's yardstick."""
    group_need = need[:, None] & (lb < ub_t[:, None])
    best_d = torch.sqrt(best2)
    changed = best_d < ub_t
    new_a = torch.where(changed, idx, assignments)
    lb_comp = torch.sqrt(torch.where(garg == new_a[:, None], gmin2, gmin))
    a = assignments.long()
    new_assign = torch.where(changed, idx.long(), a)
    new_ub = torch.minimum(ub_t, best_d)
    new_lb = torch.where(group_need, lb_comp, lb)
    moved = changed & (new_assign != a)
    cap = torch.where(moved, ub_t, float("inf"))
    cols = groups.long()[a][:, None]
    cur = torch.gather(new_lb, 1, cols)
    new_lb = new_lb.scatter(1, cols, torch.minimum(cur, cap[:, None]))
    return new_assign.int(), new_ub, new_lb


@pytest.mark.parametrize("n,d,k,g,tile_n", ct_params(CT_CASES))
def test_candidate_mask_on_cpu_is_the_old_arithmetic(n, d, k, g, tile_n):
    """A CPU tensor takes the plain version: the block mask of the group
    filter as the pass formed it, as JAX's ``build_group_block_mask``
    forms it, with every tile of no pending row dead; no launch."""
    x, c, labels, groups, ub, lb, need = ct_inputs(n, d, k, g, tile_n,
                                                   seed=n + g)
    before = ct.candidate_mask.launches
    got = ct.candidate_mask(need, lb, ub, tile_n=tile_n)
    assert ct.candidate_mask.launches == before
    group_need = need[:, None] & (lb < ub[:, None])
    assert got.dtype == torch.bool
    assert torch.equal(got, build_group_block_mask(group_need,
                                                   tile_n=tile_n))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_block_mask(jnp.asarray(
            group_need.numpy()), tile_n=tile_n)))
    pending = torch.nn.functional.pad(need, (0, (-n) % tile_n))
    dead = ~pending.reshape(-1, tile_n).any(1)
    assert dead.any() and not got[dead].any() and got.any()


@pytest.mark.parametrize("n,d,k,g,tile_n", ct_params(CT_CASES))
def test_candidate_tail_on_cpu_is_the_old_arithmetic(n, d, k, g, tile_n):
    """A CPU tensor takes the plain version, bit for bit the arithmetic
    the pass had before, and counts no launch. The states hold every case
    the kernel must take as the pass did: rows not pending in a live tile
    that move all the same, fully skipped rows (best inf, idx -1), group
    minima whose argmin is the new label (the second minimum taken) and
    ties, -1 slots, G above 32 and N off a multiple of the tile."""
    x, c, labels, groups, ub, lb, need = ct_inputs(n, d, k, g, tile_n,
                                                   seed=n + g)
    mask, args = ct_pass(x, c, labels, groups, ub, lb, need, g, tile_n)
    before = ct.candidate_tail.launches
    got = ct.candidate_tail(*args)
    assert ct.candidate_tail.launches == before
    want = _frozen_tail(*args)
    for name, a, b in zip(("new_assign", "new_ub", "new_lb"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    best2, idx, gmin, garg = args[:4]
    live = torch.repeat_interleave(mask.any(1), tile_n)[:n]
    moved = got[0] != labels
    assert bool((~need & live & moved).any())
    assert bool(((idx == -1) & torch.isinf(best2)).any())
    group_need = need[:, None] & (lb < ub[:, None])
    assert bool((group_need & (garg == got[0][:, None])).any())
    assert bool((moved & (got[1] < ub)).any())


@pytest.mark.parametrize("n,d,k,g,tile_n", ct_params(CT_CASES[:3]))
def test_kernel_candidate_pass_on_cpu_keeps_its_bits(n, d, k, g, tile_n):
    """``engine.kernel_candidate_pass`` on the CPU against the pass
    written out with the old mask and the frozen tail: labels, bounds and
    the pair count bit for bit."""
    x, c, labels, groups, ub, lb, need = ct_inputs(n, d, k, g, tile_n,
                                                   seed=n)
    members, gsize = engine.build_group_tables(groups.numpy(), g, "cpu")
    got = engine.kernel_candidate_pass(
        x, c, labels, ub, lb, groups, members, gsize, need, tile_n=tile_n,
        x2=(x * x).sum(-1), c2=(c * c).sum(-1))
    group_need = need[:, None] & (lb < ub[:, None])
    mask = build_group_block_mask(group_need, tile_n=tile_n)
    _, args = ct_pass(x, c, labels, groups, ub, lb, need, g, tile_n,
                      mask=mask, assign=ga.grouped_assign_plain)
    want = _frozen_tail(*args) + (
        tile_n * (mask.long() * gsize[None, :]).sum(),)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_candidate_tail_source_keeps_its_contract():
    """The kernels' names stay outside the rooflines' patterns of the
    other k-means kernels; the root is IEEE's and no value is added, let
    alone atomically; the mask's shared memory is the wrapper's
    ``mask_smem``."""
    src = (_build.CSRC / "candidate_tail.cu").read_text()
    names = re.findall(r"__global__ void __launch_bounds__\([\w, ]+\)\n"
                       r"(\w+)\(", src)
    assert names == ["ct_mask_kernel", "ct_tail_kernel"]
    for pattern in (r"\b(cu_partial|cu_reduce)\b",
                    r"\b(ga_kernel|ga_plan_kernel)\b",
                    r"\b(bu_upkeep_kernel|bu_own_kernel)\b"):
        assert not re.search(pattern, src)
    assert "__fsqrt_rn(" in src and "sqrtf(" not in src
    assert not re.search(r"\batomic\w*\(", src) and "#define" not in src
    assert "int mask_smem(int tile_n, int g) { return 4 * tile_n + g; }" \
        in src
    assert ct.mask_smem(256, 25) == 4 * 256 + 25
