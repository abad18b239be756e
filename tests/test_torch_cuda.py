"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false. This file imports neither JAX
nor the JAX package, so it also runs on a machine with a card and no
JAX: ``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest`` because ``conftest.py``
sets up the JAX package's tuning cache). It also holds the kernel cases
that ``test_torch_kernels.py`` runs against the Pallas kernels on the
CPU.

Tolerances: float outputs rtol 1e-5 / atol 1e-5 (attention in bf16:
3e-2, one bf16 rounding of the same fp32 result, as
``tests/test_kernels.py`` has it; the LM prefill: 1e-4 of the logits'
scale), sums atol 1e-3 (the
card adds in another order than the CPU); squared distances of the
expanded form within 1e-5 of the norms they come from, bf16 inputs as
fp32 (both sides widen the same bf16 values); ids, pair counts and
counts exact; ``bounds_upkeep`` bit for bit but a refreshed upper
bound, whose square is such a squared distance; repeat and
uniform-weight fits bit-identical. An argmin
id may differ from the plain version's only at a tie: both ids'
distances within the distance tolerance of each other.
"""
import importlib

import numpy as np
import pytest
import torch

import repro_torch.kernels as kernels
from repro_torch.core import engine
from repro_torch.data import make_points

# the package exports the wrappers under the kernels' names: the
# modules themselves, with the plain versions, come from importlib
bu = importlib.import_module("repro_torch.kernels.bounds_upkeep")
ct = importlib.import_module("repro_torch.kernels.candidate_tail")
cu = importlib.import_module("repro_torch.kernels.centroid_update")
fa = importlib.import_module("repro_torch.kernels.filtered_assign")
ga = importlib.import_module("repro_torch.kernels.grouped_assign")
psd = importlib.import_module("repro_torch.kernels.distance")
fla = importlib.import_module("repro_torch.kernels.flash_attention")
ssd = importlib.import_module("repro_torch.kernels.ssd_intra")

GA_CASES = [  # the shapes of tests/test_kernels.py::test_grouped_assign_*
    (300, 7, 17, 4, 128),         # ragged N/K, partial skip
    (512, 16, 64, 8, 256),        # aligned
    (1000, 12, 40, 5, 256),       # ragged tail tile
    (130, 3, 6, 6, 64),           # tiny
]
# (n, d, k, g, tile_n, layout) of the membership table (ga_inputs):
# groups of one slot, and -1 slots inside rows as well as at their tail
# (with a group of no member), which the kernel masks wherever they sit
GA_LAYOUT_CASES = [
    (300, 7, 17, 17, 128, "one"),
    (1000, 12, 40, 5, 256, "holes"),
    (130, 3, 6, 6, 64, "holes"),
]


def ga_params(cases):
    """``pytest.param``s of (n, d, k, g, tile_n, layout) cases; the
    GA_CASES keep their plain ids and the table layout "tail"."""
    return [pytest.param(*c, "tail", id="-".join(map(str, c)))
            if len(c) == 5 else pytest.param(*c, id="-".join(map(str, c)))
            for c in cases]


CU_SHAPES = [(256, 16, 128), (1000, 48, 300), (130, 7, 17), (512, 128, 128)]
# tile pairs of benchmarks/filter_efficiency.py for the block-skip
# kernels, which take the shapes of CU_SHAPES (tests/test_kernels.py's)
BS_TILES = [(256, 128), (64, 16)]
# tiles of fewer points than a block of the kernel owns (64), and than
# the centroid slots a chunk stages
SMALL_TILES = [(16, 128), (4, 8)]
# tests/test_kernels.py::test_flash_attention's (b, h, s, d, block_q,
# block_k)
FA_CASES = [(2, 3, 128, 32, 64, 32), (1, 2, 256, 64, 256, 64),
            (1, 1, 64, 16, 16, 64)]
# the model's attention launch (b, s, h, kv, d): grouped heads, ragged
# S, hymba-1.5b's 25/5 heads of 64, and a head dim of 128
GQA_CASES = [(2, 100, 4, 2, 16), (1, 77, 6, 3, 64), (2, 128, 4, 1, 128),
             (1, 300, 25, 5, 64)]
# the tensor-core attention kernel's sequence lengths: one row, a
# ragged tile either side of 64, several tiles, one past 2048
TC_SEQS = [1, 63, 65, 300, 2049]
# centroid_update's determinism shapes: CU_SHAPES, one row, fewer rows
# than one chunk of uci-xlarge's plan (3,972), K = 1024 at a ragged N,
# and uci-xlarge itself
CU_DET_SHAPES = CU_SHAPES + [(1, 5, 3), (3000, 32, 256),
                             (100_003, 33, 1024), (1 << 20, 32, 256)]
# ssd_intra cells (g, q, n, p): tests/test_kernels.py::test_ssd_intra's
# three, the reduced configs' chunk, hymba-1.5b's and mamba2-780m's
# cells, Q = 256 with N and P off every power of two, and hymba-1.5b's
# cell at a Q that is not a multiple of the kernel's 32-row blocks
SSD_CASES = [(4, 32, 16, 32), (2, 128, 8, 64), (1, 16, 128, 16),
             (5, 8, 8, 32), (3, 128, 16, 128), (2, 128, 128, 64),
             (2, 256, 33, 100), (3, 100, 16, 128)]
# bounds_upkeep's (n, d, k, g): uci-xlarge's and uci-highk's shapes, a
# ragged N at a D off a multiple of 4, one group (Hamerly) at D 7, and
# a tiny case; BU_CPU_CASES are the CPU's share of them
BU_CASES = [(1 << 20, 32, 256, 25), (1 << 18, 32, 1024, 102),
            (100_003, 33, 77, 7), (4099, 7, 40, 1), (130, 3, 6, 6)]
BU_CPU_CASES = [(3001, 32, 256, 25), (1030, 32, 1024, 102),
                (4099, 7, 40, 1), (130, 3, 6, 6)]

# candidate_tail's (n, d, k, g, tile_n): uci-xlarge's and uci-highk's
# groups at an N off a multiple of the tile, G above 32 at a tile of 64,
# one group (Hamerly), and a tiny case at tiles of 32 and of 33 (a tile
# whose run of the N x G table does not start on 16 bytes)
CT_CASES = [(3001, 32, 256, 25, 256), (1030, 32, 1024, 102, 256),
            (1000, 12, 160, 40, 64), (4099, 7, 40, 1, 256),
            (130, 3, 6, 6, 32), (130, 3, 7, 7, 33)]


def ct_params(cases):
    return [pytest.param(*c, id="-".join(map(str, c))) for c in cases]


def bu_params(cases):
    """(n, d, k, g, gdrift) params: every group-drift rule, "empty" only
    where there is a second group."""
    return [pytest.param(*c, gd, id="-".join(map(str, c + (gd,))))
            for c in cases for gd in ("max", "empty", "clamped")
            if gd != "empty" or c[3] > 1]


def attn_inputs(b, s, h, kv, d, seed):
    """q (b, s, h, d), k and v (b, s, kv, d), standard normal fp32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kv, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def ssd_inputs(g, q, n, p, seed, steep=False):
    """c, b (g, q, n), x (g, q, p) standard normal; cum (g, q) a
    cumulative sum of negative log-decays. ``steep`` decays fast enough
    that exp(cum_i - cum_j) above the diagonal overflows fp32."""
    rng = np.random.default_rng(seed)
    c, b = (rng.standard_normal((g, q, n)).astype(np.float32)
            for _ in range(2))
    x = rng.standard_normal((g, q, p)).astype(np.float32)
    z = rng.standard_normal((g, q))
    step = np.logaddexp(z, 0.0) * (40.0 if steep else 1.0) + \
        (5.0 if steep else 0.0)
    return c, b, x, np.cumsum(-step, axis=1).astype(np.float32)


def _members(groups, g):
    lmax = max(int(np.bincount(groups, minlength=g).max()), 1)
    members = np.full((g, lmax), -1, np.int32)
    for gg in range(g):
        ids = np.nonzero(groups == gg)[0]
        members[gg, :len(ids)] = ids
    return members


def ga_inputs(n, d, k, g, tile_n, density, seed, layout="tail"):
    """Points, grouped centroids, the (G, Lmax) membership table and a
    block mask. ``layout``: "tail" as ``engine.build_group_tables``
    lays it out (ascending ids, -1 pads at the tail); "one" one slot a
    group (g == k); "holes" each group's ids spread over a row 3 slots
    wider, -1 between and around them, plus one group of no member."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    if layout == "one":
        assert g == k
        members = np.arange(k, dtype=np.int32)[:, None]
    else:
        members = _members(rng.integers(0, g, size=k), g)
    if layout == "holes":
        wide = np.full((g + 1, members.shape[1] + 3), -1, np.int32)
        for gg, row in enumerate(members):
            ids = row[row >= 0]
            at = np.sort(rng.choice(wide.shape[1], len(ids), replace=False))
            wide[gg, at] = ids
        members = wide
    c_grouped = c[np.maximum(members, 0)]
    mask = rng.random((-(-n // tile_n), members.shape[0])) < density
    return x, c_grouped, members, mask


def bu_inputs(n, d, k, g, seed, gdrift="max"):
    """``bounds_upkeep``'s inputs after a move, as CPU tensors in its
    argument order: points, x2, new_c, new_c2, int32 labels, ub, lb,
    drift, group_drift. Points lie near their old centroid and the
    bounds straddle each other, so the rows split into *maybe* and not,
    and refreshed rows into pending and not; every 97th row is a sharded
    fit's sentinel (ub 0, lb +inf). ``gdrift``: "max" of the members'
    drifts, "empty" a last group with no member (-inf, the batch fit's
    rule; g > 1), "clamped" at 0 (the stream's rule)."""
    rng = np.random.default_rng(seed)
    c = (rng.standard_normal((k, d)) * 3).astype(np.float32)
    new_c = (c + rng.standard_normal((k, d)) * 0.05).astype(np.float32)
    labels = rng.integers(0, k, n).astype(np.int32)
    x = (c[labels] + rng.standard_normal((n, d)) * 0.5).astype(np.float32)
    ub = rng.uniform(0, 4, n).astype(np.float32)
    lb = (rng.uniform(0, 4, (n, 1))
          + rng.uniform(0, 1, (n, g))).astype(np.float32)
    ub[::97] = 0.0
    lb[::97] = np.inf
    x, c, new_c, ub, lb = (torch.from_numpy(v) for v in (x, c, new_c, ub,
                                                          lb))
    drift = torch.sqrt(torch.sum((new_c - c) ** 2, dim=-1))
    groups = torch.arange(k) % (g - 1 if gdrift == "empty" else g)
    group_drift = torch.full((g,), float("-inf")).scatter_reduce_(
        0, groups, drift, "amax")
    if gdrift == "clamped":
        group_drift = torch.clamp_min(group_drift, 0.0)
    return (x, torch.sum(x * x, dim=-1), new_c,
            torch.sum(new_c * new_c, dim=-1), torch.from_numpy(labels), ub,
            lb, drift, group_drift)


def ct_inputs(n, d, k, g, tile_n, seed):
    """A candidate pass's inputs, as CPU tensors: points (N, D), centroids
    (K, D), int32 labels (N,) and groups (K,), ub_t (N,), lb (N, G) and
    bool need (N,). The bounds hold the exact distances: ub_t is the
    distance to the label loosened by up to 25%, lb each group's least
    distance past the label tightened by up to 40%, so rows are
    candidates in some groups and some move. Groups differ in size (the
    tables pad with -1); centroid K/2 repeats centroid 0 in its group
    where K/2 >= G, and K/3 repeats centroid 1 (ties); every third tile from the second
    has no pending row (fully skipped rows); every 97th row is a sharded
    fit's sentinel (ub 0, lb +inf, not pending)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    groups = rng.integers(0, g, k).astype(np.int32)
    groups[:g] = np.arange(g)
    if k // 2 >= g:
        c[k // 2], groups[k // 2] = c[0], groups[0]
    c[k // 3] = c[1]
    labels = rng.integers(0, k, n).astype(np.int32)
    dist = np.sqrt(((x[:, None, :].astype(np.float64) - c[None]) ** 2)
                   .sum(-1))
    rows = np.arange(n)
    ub = dist[rows, labels] * rng.uniform(1.0, 1.25, n)
    dist[rows, labels] = np.inf
    lb = np.stack([dist[:, groups == gg].min(1) for gg in range(g)], 1)
    lb = lb * rng.uniform(0.6, 1.0, (n, g))
    need = rng.random(n) < 0.5
    for t in range(1, -(-n // tile_n), 3):
        need[t * tile_n:(t + 1) * tile_n] = False
    ub[::97], lb[::97], need[::97] = 0.0, np.inf, False
    return (torch.from_numpy(x), torch.from_numpy(c),
            torch.from_numpy(labels), torch.from_numpy(groups),
            torch.from_numpy(ub.astype(np.float32)),
            torch.from_numpy(lb.astype(np.float32)), torch.from_numpy(need))


def ct_pass(x, c, labels, groups, ub, lb, need, g, tile_n, *,
            mask=None, assign=None):
    """The block mask (``kernels.candidate_mask`` unless given) and the
    arguments of ``kernels.candidate_tail`` after ``assign`` (default
    ``kernels.grouped_assign``) on the candidate pass's inputs, as
    ``engine.kernel_candidate_pass`` forms them."""
    members, _ = engine.build_group_tables(groups.cpu().numpy(), g,
                                           x.device)
    if mask is None:
        mask = kernels.candidate_mask(need, lb, ub, tile_n=tile_n)
    mem_s = members.clamp_min(0).long()
    c2 = torch.sum(c * c, dim=-1)
    outs = (assign or kernels.grouped_assign)(
        x, c[mem_s].contiguous(), members, mask, tile_n=tile_n,
        x2=torch.sum(x * x, dim=-1), c2g=c2[mem_s].contiguous())
    return mask, tuple(outs) + (labels, ub, lb, need, groups)


def fa_inputs(n, d, k, tile_n, tile_k, density, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    mask = rng.random((-(-n // tile_n), -(-k // tile_k))) < density
    return x, c, mask


def assert_outputs(got, want):
    for name, a, b in zip(("best", "idx", "gmin", "garg", "gmin2"),
                          got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        if a.dtype.kind == "f":
            finite = np.isfinite(b)
            assert (np.isfinite(a) == finite).all(), name
            np.testing.assert_allclose(a[finite], b[finite], rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("n,d,k,g,tile_n,layout", ga_params(
    GA_CASES + GA_LAYOUT_CASES + [
        (4099, 128, 1024, 1, 256),    # Hamerly: one group of 1024 slots
        (2000, 33, 300, 30, 256),
        # groups wider than the centroids a block stages at once, with
        # -1 slots inside them; tiles of 32 and 1024 points
        (2000, 64, 700, 3, 256, "holes"),
        (2000, 33, 300, 30, 32),
        (5000, 16, 64, 8, 1024),
        # D too wide for 8 points a lane (4 here), and for 2 (1 here,
        # the centroids in three batches)
        (600, 192, 100, 20, 256),
        (300, 700, 100, 4, 32)]))
def test_grouped_assign_kernel_matches_plain(n, d, k, g, tile_n, layout,
                                             density):
    """The kernel against the plain version, and bit for bit against
    the port's first kernel (``grouped_assign_simple``) on the same
    inputs."""
    _need_card()
    x, c_grouped, members, mask = ga_inputs(n, d, k, g, tile_n, density,
                                             seed=n, layout=layout)
    args = [torch.from_numpy(a).cuda() for a in (x, c_grouped, members,
                                                 mask)]
    before = ga.grouped_assign.launches
    got = ga.grouped_assign(*args, tile_n=tile_n)
    torch.cuda.synchronize()
    assert ga.grouped_assign.launches == before + 1
    want = ga.grouped_assign_plain(*args, tile_n=tile_n)
    assert_outputs([t.cpu().numpy() for t in got],
                    [t.cpu().numpy() for t in want])
    first = ga.grouped_assign_simple(*args, tile_n=tile_n)
    assert ga.grouped_assign.launches == before + 1
    for name, a, b in zip(("best", "idx", "gmin", "garg", "gmin2"), got,
                          first):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("d,g,want", [
    (32, 25, 8), (128, 1, 8), (33, 30, 8), (192, 20, 4), (700, 4, 1),
    (20_000, 1, 0)])
def test_grouped_assign_points_a_lane_follow_the_shape(d, g, want):
    """The launch's variant is a function of (D, G) alone: 8 points a
    lane where a batch of staged slots fits beside them, fewer for wide
    D, and 0 (the launch refuses) where not even one point does."""
    _need_card()
    assert ga.points(d, g) == want
    if want == 0:
        x = torch.zeros((64, d), device="cuda")
        with pytest.raises(RuntimeError, match="invalid argument"):
            ga.grouped_assign(x, torch.zeros((g, 1, d), device="cuda"),
                              torch.zeros((g, 1), dtype=torch.int32,
                                          device="cuda"),
                              torch.ones((1, g), dtype=torch.bool,
                                         device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", CU_SHAPES + [(100_003, 33, 1024)])
def test_centroid_update_kernel_matches_plain(n, d, k):
    _need_card()
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    a = torch.from_numpy(rng.integers(-1, k, size=n).astype(np.int32))
    w = torch.from_numpy(rng.random(n).astype(np.float32))
    for weights in (None, w):
        wc = None if weights is None else weights.cuda()
        s, c = cu.centroid_update(x.cuda(), a.cuda(), k, wc)
        s_ref, c_ref = cu.centroid_update_plain(x, a, k, weights)
        np.testing.assert_allclose(s.cpu().numpy(), s_ref.numpy(),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(c.cpu().numpy(), c_ref.numpy(),
                                   rtol=1e-5)
    s1, c1 = cu.centroid_update(x.cuda(), a.cuda(), k,
                                torch.ones(n, device="cuda"))
    s0, c0 = cu.centroid_update(x.cuda(), a.cuda(), k)
    assert torch.equal(s0, s1) and torch.equal(c0, c1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", CU_DET_SHAPES)
def test_centroid_update_kernel_is_deterministic(n, d, k):
    _need_card()
    rng = np.random.default_rng(n + k)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    a = torch.from_numpy(rng.integers(-1, k, size=n).astype(np.int32))
    xc, ac = x.cuda(), a.cuda()
    first = cu.centroid_update(xc, ac, k)
    for again in (cu.centroid_update(xc, ac, k),
                  cu.centroid_update(xc, ac, k, torch.ones(n, device="cuda"))):
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])
    s_ref, c_ref = cu.centroid_update_plain(x, a, k)
    np.testing.assert_allclose(first[0].cpu().numpy(), s_ref.numpy(),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(first[1].cpu().numpy(), c_ref.numpy())
    none = cu.centroid_update(xc, torch.full_like(ac, -1), k)
    assert not bool(none[0].any()) and not bool(none[1].any())


def _bu_counts():
    return kernels.bounds_upkeep.launches


@pytest.mark.cuda
@pytest.mark.parametrize("refresh", [True, False], ids=["refresh", "no"])
@pytest.mark.parametrize("n,d,k,g,gdrift", bu_params(BU_CASES))
def test_bounds_upkeep_kernel_matches_plain(n, d, k, g, gdrift, refresh):
    """The kernel against the plain version on the same inputs: bit for
    bit in ``lb_dec`` and ``tightened``, in ``ub_t`` and ``need`` on every
    row the refresh did not touch and, with the refresh off, on every
    row. A refreshed ``ub_t`` is the expanded form's distance in another
    summation order: its square within 1e-5 of ``||x||^2 + ||c_a||^2``,
    and ``need`` equal wherever the plain ``ub_t`` stands farther from
    ``glb`` than the square root of that. The kernel gives its own bits
    again on a second call."""
    _need_card()
    args = [t.cuda() for t in bu_inputs(n, d, k, g, seed=n + g,
                                        gdrift=gdrift)]
    before = _bu_counts()
    got = kernels.bounds_upkeep(*args, refresh=refresh)
    torch.cuda.synchronize()
    assert _bu_counts() == before + 1
    want = bu.bounds_upkeep_plain(*args, refresh=refresh)
    ub_t, lb_dec, need, tightened = got
    assert torch.equal(lb_dec, want[1])
    assert tightened.dtype == torch.int64 and torch.equal(tightened, want[3])
    assert need.dtype == torch.bool
    again = kernels.bounds_upkeep(*args, refresh=refresh)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if not refresh:
        assert torch.equal(ub_t, want[0]) and torch.equal(need, want[2])
        return
    ub_p, _, maybe, _ = bu.bounds_upkeep_plain(*args, refresh=False)
    assert 0 < int(maybe.sum()) < n
    kept = ~maybe
    assert torch.equal(ub_t[kept], want[0][kept])
    assert torch.equal(need[kept], want[2][kept])
    x2, c2, a = args[1], args[3], args[4].long()
    tol = 1e-5 * (x2 + c2[a])
    assert bool((((ub_t ** 2 - want[0] ** 2).abs() <= tol) | kept).all())
    glb = want[1].min(dim=1).values
    clear = (want[0] - glb).abs() > tol.sqrt()
    assert bool((need == want[2])[clear].all())
    assert bool((maybe & ~want[2]).any()) and bool((maybe & want[2]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k,g", BU_CASES)
def test_own_dists_kernel_is_the_refresh_of_bounds_upkeep(n, d, k, g):
    """``own_dists`` on the card gives, row for row, the bits of the
    refresh inside ``bounds_upkeep`` (one order in both places), and
    the plain version's distances within the expanded form's
    tolerance."""
    _need_card()
    args = [t.cuda() for t in bu_inputs(n, d, k, g, seed=n + 1)]
    points, x2, c, c2, labels = args[:5]
    before = bu.own_dists.launches
    got = kernels.own_dists(points, x2, c, c2, labels)
    assert bu.own_dists.launches == before + 1
    ub_t = kernels.bounds_upkeep(*args, refresh=True)[0]
    maybe = bu.bounds_upkeep_plain(*args, refresh=False)[2]
    assert torch.equal(got[maybe], ub_t[maybe])
    want = bu.own_dists_plain(points, x2, c, c2, labels)
    tol = 1e-5 * (x2 + c2[labels.long()])
    assert bool(((got ** 2 - want ** 2).abs() <= tol).all())


@pytest.mark.cuda
def test_compact_fit_on_card_keeps_its_labels_with_the_refresh_in_the_pass():
    """The refresh in the move or in the compact pass gives the same bits,
    so the compact fit's labels and ``n_iters`` do not follow
    ``refresh_in_pass``, a knob of dispatch only (``chip_smoke.py``
    phase 16 holds the sharded fit's tuned config to the same)."""
    _need_card()
    pts, _, _ = make_points(30_000, 32, 64, seed=11)
    init = pts[:: 30_000 // 64][:64].copy()
    fits = [engine.fit(pts, init, n_groups=6, tol=1e-5, max_iters=40,
                       backend="compact", tune="off", device="cuda",
                       config=engine.EngineConfig(refresh_in_pass=rip))
            for rip in (False, True)]
    assert fits[0].n_iters == fits[1].n_iters
    assert torch.equal(fits[0].assignments, fits[1].assignments)


@pytest.mark.cuda
def test_bounds_upkeep_routes_by_its_input():
    """On the card the kernel takes every call: without ``x2`` where the
    refresh is off; inputs it cannot take (no ``x2`` with the refresh,
    int64 labels, a strided ``lb``, fp64 ``ub``) raise ``ValueError``
    and launch nothing, in ``bounds_upkeep`` and in ``own_dists``."""
    _need_card()
    args = [t.cuda() for t in bu_inputs(4099, 32, 256, 25, seed=5)]
    before = _bu_counts()
    kernels.bounds_upkeep(*args[:1], None, *args[2:], refresh=False)
    assert _bu_counts() == before + 1
    odd = {
        "no x2": (1, None),
        "int64 labels": (4, args[4].long()),
        "lb not contiguous": (6, args[6].t().contiguous().t()),
        "fp64 ub": (5, args[5].double()),
    }
    for name, (at, value) in odd.items():
        call = list(args)
        call[at] = value
        before = _bu_counts()
        with pytest.raises(ValueError):
            kernels.bounds_upkeep(*call, refresh=True)
        assert _bu_counts() == before, name
    points, x2, c, c2, labels = args[:5]
    before = bu.own_dists.launches
    for call in ((points, x2, c, c2, labels.long()),
                 (points.double(), x2, c, c2, labels),
                 (points.t().contiguous().t(), x2, c, c2, labels)):
        with pytest.raises(ValueError):
            kernels.own_dists(*call)
    assert bu.own_dists.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("backend,refresh_in_pass", [
    ("kernel", False), ("oracle", False), ("compact", False),
    ("compact", True)])
def test_fit_on_card_upkeeps_the_bounds_in_one_launch_a_move(
        backend, refresh_in_pass):
    """Each move of a fit on the card is one ``bounds_upkeep`` launch;
    the fit run twice, and with uniform weights of 1.0, gives the same
    bits."""
    _need_card()
    pts, _, _ = make_points(20_000, 32, 128, seed=9)
    init = pts[:: 20_000 // 128][:128].copy()
    kw = dict(n_groups=13, tol=1e-5, max_iters=30, backend=backend,
              tune="off", device="cuda", config=engine.EngineConfig(
                  refresh_in_pass=refresh_in_pass))
    before = _bu_counts()
    first = engine.fit(pts, init, **kw)
    assert _bu_counts() == before + first.n_iters
    again = engine.fit(pts, init, **kw)
    ones = engine.fit(pts, init, sample_weight=np.ones(20_000, np.float32),
                      **kw)
    for r in (again, ones):
        assert r.n_iters == first.n_iters
        for name in ("centroids", "assignments", "distance_evals",
                     "inertia"):
            assert torch.equal(getattr(r, name), getattr(first, name)), name


def _ct_counts():
    # the modules' wrappers: a test may swap the package's for the plain
    # versions
    return ct.candidate_mask.launches, ct.candidate_tail.launches


def _off16(t):
    """A contiguous copy of ``t`` one element past a 16-byte boundary, so
    that the kernels walk it by elements, not 16 bytes at a time."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["on16", "off16"])
@pytest.mark.parametrize("n,d,k,g,tile_n", ct_params(CT_CASES))
def test_candidate_kernels_match_plain(n, d, k, g, tile_n, aligned):
    """Both kernels against their plain versions on the same inputs, bit
    for bit (no value of either is a sum), one launch each, and the same
    bits again on a second call; with the N x G tables off 16 bytes too,
    where the kernels take them an element at a time."""
    _need_card()
    x, c, labels, groups, ub, lb, need = (
        t.cuda() for t in ct_inputs(n, d, k, g, tile_n, seed=n + g))
    if not aligned:
        lb = _off16(lb)
    before = _ct_counts()
    mask = kernels.candidate_mask(need, lb, ub, tile_n=tile_n)
    torch.cuda.synchronize()
    assert _ct_counts()[0] == before[0] + 1
    assert mask.dtype == torch.bool
    assert torch.equal(mask, ct.candidate_mask_plain(need, lb, ub,
                                                     tile_n=tile_n))
    _, args = ct_pass(x, c, labels, groups, ub, lb, need, g, tile_n,
                      mask=mask)
    if not aligned:
        args = tuple(_off16(a) if a.dim() == 2 else a for a in args)
    got = kernels.candidate_tail(*args)
    torch.cuda.synchronize()
    assert _ct_counts()[1] == before[1] + 1
    want = ct.candidate_tail_plain(*args)
    for name, a, b in zip(("new_assign", "new_ub", "new_lb"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    again = kernels.candidate_tail(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(kernels.candidate_mask(need, lb, ub, tile_n=tile_n),
                       mask)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(1 << 20, 256), (1 << 18, 1024)],
                         ids=["uci-xlarge", "uci-highk"])
def test_candidate_kernels_match_plain_on_fit_states(n, k):
    """Both kernels bit for bit against their plain versions on the
    pending passes of a kernel-backend fit at the paper suite's
    uci-xlarge and uci-highk shapes (D 32, G = K / 10), after 1, 2, 4
    and 8 iterations."""
    _need_card()
    from repro_torch.core.kmeans import group_centroids
    d, g = 32, k // 10
    pts = torch.from_numpy(make_points(n, d, k, seed=5)[0]).cuda()
    init = pts[:: n // k][:k].clone()
    groups = group_centroids(init, g)
    members, gsize = engine.build_group_tables(groups.cpu().numpy(), g,
                                               pts.device)
    core = engine.PassCore(backend="kernel", k=k, n_groups=g)
    body = engine._loop_body(core, pts, None, groups, members, gsize)
    carry = engine._init_carry(pts, init, groups, n_groups=g)
    for it in range(1, 9):
        carry = body(carry)
        if it not in (1, 2, 4, 8):
            continue
        mask = kernels.candidate_mask(carry.need, carry.lb, carry.ub)
        assert torch.equal(mask, ct.candidate_mask_plain(
            carry.need, carry.lb, carry.ub)), it
        assert bool(mask.any()), it
        _, args = ct_pass(pts, carry.centroids, carry.assignments, groups,
                          carry.ub, carry.lb, carry.need, g, 256, mask=mask)
        got = kernels.candidate_tail(*args)
        want = ct.candidate_tail_plain(*args)
        for name, a, b in zip(("new_assign", "new_ub", "new_lb"), got,
                              want):
            assert torch.equal(a, b), (it, name)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,g", [(30_000, 128, 13), (1 << 18, 1024, 102)])
def test_kernel_fit_on_card_keeps_its_bits_with_the_plain_candidate_pass(
        monkeypatch, n, k, g):
    """A kernel-backend fit launches each candidate kernel once a pass
    (``n_iters`` bodies and the epilogue), and gives the labels,
    ``n_iters``, ``distance_evals``, inertia and centroids of the same
    fit with both swapped for their plain versions, bit for bit."""
    _need_card()
    pts, _, _ = make_points(n, 32, k, seed=12)
    init = pts[:: n // k][:k].copy()
    kw = dict(n_groups=g, tol=1e-5, max_iters=25, backend="kernel",
              tune="off", device="cuda")
    before = _ct_counts()
    first = engine.fit(pts, init, **kw)
    after = _ct_counts()
    passes = first.n_iters + 1
    assert after == (before[0] + passes, before[1] + passes)
    monkeypatch.setattr(kernels, "candidate_mask", ct.candidate_mask_plain)
    monkeypatch.setattr(kernels, "candidate_tail", ct.candidate_tail_plain)
    plain = engine.fit(pts, init, **kw)
    assert _ct_counts() == after
    assert plain.n_iters == first.n_iters
    for name in ("centroids", "assignments", "distance_evals", "inertia"):
        assert torch.equal(getattr(plain, name), getattr(first, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["obs", "unit-weights"])
def test_kernel_fit_on_card_keeps_its_bits_with_obs_or_unit_weights(variant):
    """With the candidate kernels on the path, a kernel-backend fit gives
    the same bits with obs on as off, and with weights of 1.0 as with
    none, and a second fit repeats the first."""
    _need_card()
    from repro_torch.obs import MetricsRegistry, ObsConfig
    pts, _, _ = make_points(1 << 17, 32, 256, seed=13)
    init = pts[:: (1 << 17) // 256][:256].copy()
    kw = dict(n_groups=25, tol=1e-5, max_iters=30, backend="kernel",
              tune="off", device="cuda")
    first = engine.fit(pts, init, **kw)
    if variant == "obs":
        other = engine.fit(pts, init, obs=ObsConfig(
            registry=MetricsRegistry()), **kw)
    else:
        other = engine.fit(pts, init, sample_weight=np.ones(
            1 << 17, np.float32), **kw)
    again = engine.fit(pts, init, **kw)
    for r in (other, again):
        assert r.n_iters == first.n_iters
        for name in ("centroids", "assignments", "distance_evals",
                     "inertia"):
            assert torch.equal(getattr(r, name), getattr(first, name)), name


@pytest.mark.cuda
def test_candidate_kernels_refuse_what_they_cannot_take():
    """Inputs the kernels cannot take (a need that is not bool, a strided
    or fp64 table, int64 labels or groups, a misshapen ub, a tensor on
    another device) raise ``ValueError`` and launch nothing."""
    _need_card()
    x, c, labels, groups, ub, lb, need = (
        t.cuda() for t in ct_inputs(1000, 12, 160, 40, 64, seed=3))
    mask, args = ct_pass(x, c, labels, groups, ub, lb, need, 40, 64)
    before = _ct_counts()
    for call in ((need.to(torch.uint8), lb, ub),
                 (need, lb.t().contiguous().t(), ub),
                 (need, lb, ub.double()),
                 (need, lb, ub[:-1]),
                 (need, lb, ub.cpu())):
        with pytest.raises(ValueError):
            kernels.candidate_mask(*call, tile_n=64)
    odd = {1: args[1].long(), 3: args[3].t().contiguous().t(),
           4: args[4].double(), 5: args[5].long(), 8: args[8].int(),
           9: args[9].long()}
    for at, value in odd.items():
        call = list(args)
        call[at] = value
        with pytest.raises(ValueError):
            kernels.candidate_tail(*call)
    assert _ct_counts() == before


@pytest.mark.cuda
def test_kernel_fit_on_card_matches_cpu_and_repeats():
    _need_card()
    pts, _, _ = make_points(4096, 16, 64, seed=3)
    init = pts[:: 4096 // 64][:64].copy()
    kw = dict(n_groups=6, tol=1e-5, backend="kernel")
    before = (ga.grouped_assign.launches, cu.centroid_update.launches)
    r_gpu = engine.fit(pts, init, device="cuda", **kw)
    assert ga.grouped_assign.launches > before[0]
    assert cu.centroid_update.launches > before[1]
    r_cpu = engine.fit(pts, init, device="cpu", **kw)
    np.testing.assert_array_equal(r_gpu.assignments.cpu().numpy(),
                                  r_cpu.assignments.numpy())
    assert r_gpu.n_iters == r_cpu.n_iters
    np.testing.assert_allclose(float(r_gpu.inertia), float(r_cpu.inertia),
                               rtol=1e-5)
    again = engine.fit(pts, init, device="cuda", **kw)
    ones = engine.fit(pts, init, device="cuda",
                      sample_weight=np.ones(4096, np.float32), **kw)
    for r in (again, ones):
        assert torch.equal(r.centroids, r_gpu.centroids)
        assert torch.equal(r.assignments, r_gpu.assignments)
        assert float(r.inertia) == float(r_gpu.inertia)


def _stream_on_card(weighted, plain):
    """Three epochs of a 6-shard stream on the card, with both k-means
    kernels swapped for their plain versions when ``plain``; the first
    batch's labels, the estimator and the kernels' launches."""
    from repro_torch.data import PointStream
    from repro_torch.streaming import StreamingKMeans
    ps = PointStream(shard_size=4096, n_shards=6, n_dims=16, k=32, seed=3)
    skm = StreamingKMeans(32, n_groups=4, seed=0, tune="off", device="cuda")
    skm._seed_centroids = lambda p, w: p[::128][:32].clone()
    saved = kernels.centroid_update, kernels.grouped_assign
    if plain:
        kernels.centroid_update = cu.centroid_update_plain
        kernels.grouped_assign = ga.grouped_assign_plain
    before = (cu.centroid_update.launches, ga.grouped_assign.launches)
    try:
        first = None
        for _ in range(3):
            for s in range(ps.n_shards):
                w = np.random.default_rng(s).uniform(0.5, 2, 4096).astype(
                    np.float32) if weighted else None
                skm.partial_fit(ps.shard(s), shard_id=s, sample_weight=w)
                if first is None:
                    first = skm.labels_.copy()
        pts = np.concatenate([ps.shard(s) for s in range(ps.n_shards)])
        labels = skm.predict(pts)
        inertia = skm.inertia_of(pts)
    finally:
        kernels.centroid_update, kernels.grouped_assign = saved
    launched = (cu.centroid_update.launches - before[0],
                ga.grouped_assign.launches - before[1])
    return skm, first, labels, inertia, launched


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_stream_on_card_matches_plain_route(weighted):
    _need_card()
    k_est, k_first, k_lab, k_in, k_launched = _stream_on_card(weighted,
                                                              False)
    p_est, p_first, p_lab, p_in, p_launched = _stream_on_card(weighted, True)
    # a launch a batch of centroid_update, grouped_assign in predict
    # and inertia_of; none through the plain route
    assert k_launched[0] >= k_est.stats_.batches and k_launched[1] >= 2
    assert p_launched == (0, 0)
    np.testing.assert_array_equal(k_first, p_first)
    for f in ("batches", "cache_hits", "cache_misses", "reseeds",
              "drift_resets"):
        assert getattr(k_est.stats_, f) == getattr(p_est.stats_, f), f
    assert k_est.stats_.cache_hits == 12
    # past the first batch the two summation orders part at boundary
    # points (ROADMAP Queue 3 item 2): the whole stream is held by its
    # inertia and its labels
    np.testing.assert_allclose(k_in, p_in, rtol=1e-3)
    assert (k_lab != p_lab).mean() < 1e-3


@pytest.mark.cuda
def test_resilient_stream_on_card_replays_bit_for_bit(tmp_path):
    """A crash off the checkpoint lattice on the card: the restore and
    the replayed batch land bit for bit on the uninterrupted stream
    (``centroid_update`` sums in a fixed order, with no atomics)."""
    _need_card()
    from repro_torch.data import PointStream
    from repro_torch.runtime import FailureInjector
    from repro_torch.streaming import StreamingKMeans
    ps = PointStream(shard_size=4096, n_shards=6, n_dims=16, k=32, seed=3)

    def estimator():
        return StreamingKMeans(32, n_groups=4, seed=0, tune="off",
                               device="cuda")

    clean = estimator().fit_stream(ps, epochs=3)
    skm = estimator()
    before = cu.centroid_update.launches
    skm.fit_stream(ps, epochs=3, resilient=True, ckpt_dir=tmp_path,
                   ckpt_every=4, injector=FailureInjector(fail_at=(9,)))
    launched = cu.centroid_update.launches - before
    assert skm.stats_.restores == 1 and skm.stats_.replayed_batches == 1
    assert launched >= 3 * ps.n_shards + 1       # the replay launched too
    assert skm._centroids.device.type == "cuda"
    assert torch.equal(skm._centroids, clean._centroids)
    assert torch.equal(skm._counts, clean._counts)
    np.testing.assert_array_equal(skm._ledger.centroid,
                                  clean._ledger.centroid)
    np.testing.assert_array_equal(skm._ledger.group, clean._ledger.group)


def _norm_atol(x, c):
    x, c = x.float(), c.float()
    return 1e-5 * float((x * x).sum(1).max() + (c * c).sum(1).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,k", CU_SHAPES + [(100_003, 33, 77)])
def test_pairwise_sq_dists_kernel_matches_plain(n, d, k, dtype):
    _need_card()
    rng = np.random.default_rng(n + k)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    x, c = x.to("cuda", dtype), c.to("cuda", dtype)
    before = kernels.pairwise_sq_dists.launches
    got = kernels.pairwise_sq_dists(x, c)
    torch.cuda.synchronize()
    assert kernels.pairwise_sq_dists.launches == before + 1
    want = psd.pairwise_sq_dists_plain(x, c)
    assert got.shape == (n, k) and got.dtype == torch.float32
    assert bool((got >= 0).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=_norm_atol(x, c))
    # bit for bit the port's first kernel, which counts no launch
    first = psd.pairwise_sq_dists_simple(x, c)
    torch.cuda.synchronize()
    assert kernels.pairwise_sq_dists.launches == before + 1
    assert torch.equal(got, first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,offset,slice_cols", [
    (torch.float32, 200, 0, 0), (torch.float32, 130, 0, 0),
    (torch.bfloat16, 160, 0, 0), (torch.float32, 32, 1, 256),
    (torch.bfloat16, 32, 1, 256)], ids=["f32-wide", "f32-odd-wide",
                                        "bf16-wide", "f32-offset",
                                        "bf16-offset"])
def test_pairwise_sq_dists_first_kernel_route_matches_plain(dtype, d,
                                                            offset,
                                                            slice_cols):
    """The inputs the kernel does not take, a D too wide for a slice and
    an x not on 16 bytes, reach the first kernel through the entry point:
    one counted launch, the first kernel's bits, the plain version's
    values."""
    _need_card()
    n, k = 3000, 256
    rng = np.random.default_rng(d + offset)
    flat = torch.from_numpy(
        rng.standard_normal(n * d + offset).astype(np.float32))
    x = flat.to("cuda", dtype)[offset:].view(n, d)
    c = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    c = c.to("cuda", dtype)
    assert psd.slice_cols(k, d, dtype) == slice_cols
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    before = kernels.pairwise_sq_dists.launches
    got = kernels.pairwise_sq_dists(x, c)
    first = psd.pairwise_sq_dists_simple(x, c)
    torch.cuda.synchronize()
    assert kernels.pairwise_sq_dists.launches == before + 1
    assert torch.equal(got, first)
    want = psd.pairwise_sq_dists_plain(x, c)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=_norm_atol(x, c))


@pytest.mark.cuda
@pytest.mark.parametrize("tile_n,tile_k",
                         BS_TILES + [(64, 8)] + SMALL_TILES)
@pytest.mark.parametrize("density", [0.0, 0.35, 1.0])
@pytest.mark.parametrize("n,d,k", CU_SHAPES)
def test_filtered_assign_kernel_matches_plain(n, d, k, density, tile_n,
                                              tile_k):
    _need_card()
    x, c, mask = (torch.from_numpy(a).cuda() for a in
                  fa_inputs(n, d, k, tile_n, tile_k, density, seed=n * k))
    before = kernels.filtered_assign.launches
    best, idx = kernels.filtered_assign(x, c, mask, tile_n=tile_n,
                                        tile_k=tile_k)
    torch.cuda.synchronize()
    assert kernels.filtered_assign.launches == before + 1
    wbest, widx = fa.filtered_assign_plain(x, c, mask, tile_n=tile_n,
                                           tile_k=tile_k)
    # bit for bit the port's first kernel, which counts no launch
    fbest, fidx = fa.filtered_assign_simple(x, c, mask, tile_n=tile_n,
                                            tile_k=tile_k)
    torch.cuda.synchronize()
    assert kernels.filtered_assign.launches == before + 1
    assert torch.equal(best, fbest) and torch.equal(idx, fidx)
    fin = torch.isfinite(wbest)
    assert torch.equal(torch.isfinite(best), fin)
    assert torch.equal(idx == -1, ~fin)
    atol = _norm_atol(x, c)
    np.testing.assert_allclose(best[fin].cpu().numpy(),
                               wbest[fin].cpu().numpy(), rtol=1e-5,
                               atol=atol)
    bad = (idx != widx).nonzero()[:, 0]
    if len(bad):                  # only at ties of the two ids
        dd = ((x[bad, None, :].double() - c[torch.stack(
            [idx[bad], widx[bad]], 1).long()].double()) ** 2).sum(-1)
        assert bool(((dd[:, 0] - dd[:, 1]).abs() <= 2 * atol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dead", [False, True], ids=["live", "dead"])
@pytest.mark.parametrize("tile_n,tile_k", BS_TILES + [(64, 8)])
def test_filtered_assign_kernel_ties(tile_n, tile_k, dead):
    """A copy of centroid 3 at 200, in a later block: with both blocks
    live the lower index wins; with 3's block dead the copy wins and 3
    never enters. The kernel agrees with the first kernel bit for bit and
    with the plain version's ids."""
    _need_card()
    rng = np.random.default_rng(11)
    c = torch.from_numpy(rng.standard_normal((256, 32)).astype(np.float32))
    c[200] = c[3]
    x = c[3] + 1e-3 * torch.from_numpy(
        rng.standard_normal((4096, 32)).astype(np.float32))
    x, c = x.cuda().contiguous(), c.cuda()
    mask = torch.ones((-(-4096 // tile_n), -(-256 // tile_k)),
                      dtype=torch.bool, device="cuda")
    if dead:
        mask[:, 3 // tile_k] = False
    kw = dict(tile_n=tile_n, tile_k=tile_k)
    assert fa.variant(32, 256, tile_n, tile_k)[0] > 0   # the new kernel
    best, idx = kernels.filtered_assign(x, c, mask, **kw)
    fbest, fidx = fa.filtered_assign_simple(x, c, mask, **kw)
    _, widx = fa.filtered_assign_plain(x, c, mask, **kw)
    assert torch.equal(best, fbest) and torch.equal(idx, fidx)
    assert torch.equal(idx, widx)
    win, lose = (200, 3) if dead else (3, 200)
    assert int((idx == win).sum()) > 4000
    assert not bool((idx == lose).any())


# (D, K, tile_n, tile_k): the reference's filter study at uci-xlarge and
# uci-highk, the test shapes, wide D, and tiles under a block's points
VARIANT_SHAPES = [(32, 256, 256, 128), (32, 1024, 256, 128),
                  (32, 1024, 64, 16), (32, 1024, 64, 8), (32, 256, 64, 8),
                  (16, 128, 256, 128), (48, 300, 64, 16), (7, 17, 64, 16),
                  (128, 128, 64, 16), (128, 1024, 256, 128), (33, 77, 32, 8),
                  (33, 77, 1024, 32), (33, 77, 16, 128), (33, 77, 4, 8),
                  (700, 64, 256, 128), (5, 1760, 128, 1),
                  (256, 1024, 256, 128), (256, 256, 64, 16),
                  (700, 256, 64, 16)]
# the stages where three do not fit beside the point tile; every other
# shape takes three, the wide D in slices of 32 columns
VARIANT_STAGES = {(128, 128, 64, 16): 2}
WIDE_D = 172        # above it at 256 x 128 rows stage in slices


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,tile_n,tile_k", VARIANT_SHAPES)
def test_filtered_assign_variant_is_a_function_of_the_shape(d, k, tile_n,
                                                           tile_k):
    """The launch's variant comes from the shape alone: 256 points a
    block for tiles of 256 or more, else 64, the small tiles too; a D
    too wide for whole rows walks D in slices of 32 (the variant's third
    item), and no D is refused."""
    _need_card()
    points, stages, d_slice = fa.variant(d, k, tile_n, tile_k)
    assert (points, stages, d_slice) == fa.variant(d, k, tile_n, tile_k)
    want = VARIANT_STAGES.get((d, k, tile_n, tile_k), 3)
    assert stages == want
    assert points == (256 if tile_n >= 256 else 64)
    assert d_slice == (32 if d > WIDE_D else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d,tile_n,tile_k", [
    (256, 256, 128), (256, 64, 16), (700, 256, 128), (700, 64, 16),
    (257, 64, 16)])
def test_filtered_assign_wide_d_matches_first_kernel(d, tile_n, tile_k):
    """A D too wide for whole rows in shared memory: the sliced kernel
    launches (no refusal), bit for bit the first kernel where that kernel
    takes the shape, the norms it forms slice by slice those the
    wrapper's chain gives, and the plain version's minima (rtol 1e-5)
    and ids but at ties."""
    _need_card()
    n, k = 3000, 300
    assert fa.variant(d, k, tile_n, tile_k)[2] == 32
    x, c, mask = (torch.from_numpy(a).cuda() for a in
                  fa_inputs(n, d, k, tile_n, tile_k, 0.6, seed=d + tile_n))
    kw = dict(tile_n=tile_n, tile_k=tile_k)
    before = kernels.filtered_assign.launches
    best, idx = kernels.filtered_assign(x, c, mask, **kw)
    gbest, gidx = kernels.filtered_assign(x, c, mask, x2=fa._norms(x), **kw)
    torch.cuda.synchronize()
    assert kernels.filtered_assign.launches == before + 2
    assert torch.equal(best, gbest) and torch.equal(idx, gidx)
    # of these shapes the first kernel takes D 256 and 257 at 64 x 16
    assert fa.simple_takes(d, tile_n, tile_k) == (tile_n == 64 and d < 700)
    if fa.simple_takes(d, tile_n, tile_k):
        fbest, fidx = fa.filtered_assign_simple(x, c, mask, **kw)
        assert torch.equal(best, fbest) and torch.equal(idx, fidx)
    wbest, widx = fa.filtered_assign_plain(x, c, mask, **kw)
    fin = torch.isfinite(wbest)
    assert torch.equal(torch.isfinite(best), fin)
    assert torch.equal(idx == -1, ~fin)
    atol = _norm_atol(x, c)
    np.testing.assert_allclose(best[fin].cpu().numpy(),
                               wbest[fin].cpu().numpy(), rtol=1e-5,
                               atol=atol)
    bad = (idx != widx).nonzero()[:, 0]
    if len(bad):                  # only at ties of the two ids
        dd = ((x[bad, None, :].double() - c[torch.stack(
            [idx[bad], widx[bad]], 1).long()].double()) ** 2).sum(-1)
        assert bool(((dd[:, 0] - dd[:, 1]).abs() <= 2 * atol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d,k", [(32, 256), (32, 1024)])
@pytest.mark.parametrize("tile_n,tile_k", [(256, 128), (64, 16), (64, 8)])
def test_reference_tile_pairs_take_the_new_filtered_assign_kernel(
        d, k, tile_n, tile_k):
    _need_card()
    assert fa.variant(d, k, tile_n, tile_k)[0] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1000, 32), (4099, 33), (7, 128)])
def test_filtered_assign_norms_on_card(n, d):
    """Norms the wrapper computes where none are given: one fmaf chain a
    row, within fp32 rounding of torch's, and what both kernels take."""
    _need_card()
    rng = np.random.default_rng(n + d)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    x = x.cuda()
    got = fa._norms(x)
    want = torch.sum(x.double() ** 2, dim=-1).float()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5)
    c = x[:17].contiguous()
    mask = torch.ones((-(-n // 64), -(-c.shape[0] // 16)), dtype=torch.bool,
                      device="cuda")
    given = kernels.filtered_assign(x, c, mask, tile_n=64, tile_k=16,
                                    x2=got)
    own = kernels.filtered_assign(x, c, mask, tile_n=64, tile_k=16)
    assert torch.equal(given[0], own[0]) and torch.equal(given[1], own[1])


@pytest.mark.cuda
def test_block_skip_entry_point_on_card_matches_cpu():
    _need_card()
    rng = np.random.default_rng(4)
    n, d, k, g = 4099, 16, 96, 6
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    groups = (np.arange(k) % g).astype(np.int32)
    need = rng.random((n, g)) < 0.1
    args = [torch.from_numpy(a) for a in (x, c, need, groups)]
    before = kernels.filtered_assign.launches
    got = kernels.filtered_assign_auto(*[a.cuda() for a in args],
                                       tile_n=64, tile_k=16)
    assert kernels.filtered_assign.launches == before + 1
    want = kernels.filtered_assign_auto(*args, tile_n=64, tile_k=16)
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())
    # the density is a mean of the same mask, summed in another order
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)
    idx, valid, count = kernels.compact_indices(args[2][:, 0].cuda(),
                                                capacity=512)
    w_idx, w_valid, w_count = kernels.compact_indices(args[2][:, 0],
                                                      capacity=512)
    assert torch.equal(idx.cpu(), w_idx) and torch.equal(valid.cpu(),
                                                         w_valid)
    assert int(count) == int(w_count)


@pytest.mark.cuda
@pytest.mark.parametrize("refresh_in_pass", [False, True])
def test_compact_fit_on_card_matches_cpu(refresh_in_pass):
    _need_card()
    pts, _, _ = make_points(6000, 8, 24, seed=3)
    init = pts[:: 6000 // 24][:24].copy()
    kw = dict(n_groups=8, tol=1e-5, backend="compact",
              config=engine.EngineConfig(refresh_in_pass=refresh_in_pass),
              return_stats=True)
    r_gpu, s_gpu = engine.fit(pts, init, device="cuda", **kw)
    r_cpu, s_cpu = engine.fit(pts, init, device="cpu", **kw)
    np.testing.assert_array_equal(r_gpu.assignments.cpu().numpy(),
                                  r_cpu.assignments.numpy())
    assert r_gpu.n_iters == r_cpu.n_iters
    np.testing.assert_allclose(float(r_gpu.inertia), float(r_cpu.inertia),
                               rtol=1e-5)
    assert len(s_gpu.caps_history) >= 2


ATTN_DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)]


def _route_counts():
    return {"tc": kernels.flash_attention.launches_tc,
            "ffma": kernels.flash_attention.launches_ffma}


def _moved(before):
    """The one route whose launch count moved by one since ``before``."""
    moved = {r: n - before[r] for r, n in _route_counts().items()}
    assert sorted(moved.values()) == [0, 1], moved
    return max(moved, key=moved.get)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("s", TC_SEQS)
def test_flash_attention_tc_entry_point_matches_plain(s, d):
    _need_card()
    q, k, v = (torch.from_numpy(a).transpose(1, 2).contiguous()
               .to("cuda", torch.bfloat16)
               for a in attn_inputs(2, s, 3, 3, d, s + d))
    routes = _route_counts()
    got = kernels.flash_attention(q, k, v, block_q=s, block_k=s)
    torch.cuda.synchronize()
    assert _moved(routes) == "tc"
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    want = fla.flash_attention_plain(q, k, v)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=3e-2,
                               atol=3e-2)
    assert fla.row_rel_err(got, want) <= fla.ROW_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("rep", [1, 4, 5])
@pytest.mark.parametrize("s", TC_SEQS)
def test_flash_attention_tc_gqa_matches_plain(s, rep, d):
    _need_card()
    q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16)
               for a in attn_inputs(2, s, 2 * rep, 2, d, s * rep + d))
    routes = _route_counts()
    got = kernels.flash_attention_gqa(q, k, v)
    torch.cuda.synchronize()
    assert _moved(routes) == "tc"
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    want = fla.flash_attention_gqa_plain(q, k, v)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=3e-2,
                               atol=3e-2)
    assert fla.row_rel_err(got, want) <= fla.ROW_REL_TOL


def _mla_inputs(b, s, h, seed, v_dim=64, d=96):
    """MLA's launch in bf16 on the card: q, k (b, s, h, d) and v, dO
    at v_dim zero-padded to d, as ``models/attention.py`` pads them."""
    q, k, v, do = _gqa_grad_inputs(b, s, h, h, d, torch.bfloat16, seed)
    v, do = (torch.nn.functional.pad(t[..., :v_dim], (0, d - v_dim))
             for t in (v, do))
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h", [(1, 130, 4), (2, 300, 40)])
def test_flash_attention_tc_mla_keeps_padded_columns_zero(b, s, h):
    """MLA (q.k 96, v zero-padded from 64) on the tensor cores: the
    output's padded columns are exactly 0 on both forward launches, and
    so are dV's where dO's are; the rest within the plain version's
    tolerances; two backward calls give the same bits."""
    _need_card()
    q, k, v, do = _mla_inputs(b, s, h, s + h)
    assert fla.route_for(q.dtype, q.shape[-1]) == "tc"
    routes, bwd = _route_counts(), _bwd_counts()
    out = kernels.flash_attention_gqa(q, k, v)
    o, lse = fla.flash_attention_gqa_with_lse(q, k, v)
    grads = fla.flash_attention_gqa_bwd(q, k, v, o, do, lse)
    again = fla.flash_attention_gqa_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    assert _route_counts() == dict(routes, tc=routes["tc"] + 2)
    assert _bwd_counts() == dict(bwd, all=bwd["all"] + 2, tc=bwd["tc"] + 2)
    for t in (out, o, grads[2]):
        assert bool((t[..., 64:] == 0).all())
    assert torch.equal(out, o)
    want = fla.flash_attention_gqa_plain(q, k, v)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=3e-2,
                               atol=3e-2)
    assert fla.row_rel_err(out, want) <= fla.ROW_REL_TOL
    plain = fla.flash_attention_gqa_bwd_plain(q, k, v, o, do)
    for name, g, w, a in zip(("dq", "dk", "dv"), grads, plain, again):
        assert torch.equal(g, a), name
        assert _scaled_err(g, w) <= 3e-2, (name, _scaled_err(g, w))
        rows = fla.row_rel_err(g, w, fla.BWD_ROW_FLOOR)
        assert rows <= fla.BWD_ROW_REL_TOL, (name, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [48, 80, 112])
def test_flash_attention_tc_launches_refuse_other_head_dims(d):
    """The tensor-core entry points take d 64, 96 and 128 alone: at any
    other d (here with rows on 16 bytes, so the wrapper's own checks
    pass) both C launches return an error, never the 128-wide instance,
    and no count moves."""
    _need_card()
    q, k, v, do = _gqa_grad_inputs(1, 70, 2, 2, d, torch.bfloat16, d)
    o, lse = fla.flash_attention_gqa_with_lse(q, k, v)     # FFMA
    routes, bwd = _route_counts(), _bwd_counts()
    with pytest.raises(RuntimeError, match="failed to launch"):
        fla._launch(q, k, v, torch.empty_like(q), 1, 70, 2, 2, (0, 1, 2),
                    "tc")
    with pytest.raises(RuntimeError, match="failed to launch"):
        fla._bwd_launch(q, k, v, o, do, lse, "tc")
    assert _route_counts() == routes and _bwd_counts() == bwd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", ATTN_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,s,d,bq,bk", FA_CASES)
def test_flash_attention_kernel_matches_plain(b, h, s, d, bq, bk, dtype,
                                              tol):
    _need_card()
    q, k, v = (torch.from_numpy(a).transpose(1, 2).contiguous()
               .to("cuda", dtype) for a in attn_inputs(b, s, h, h, d, s + d))
    before = kernels.flash_attention.launches
    routes = _route_counts()
    got = kernels.flash_attention(q, k, v, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    assert _moved(routes) == fla.route_for(dtype, d)
    assert got.shape == q.shape and got.dtype == dtype
    want = fla.flash_attention_plain(q, k, v)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    if fla.route_for(dtype, d) == "tc":
        assert fla.row_rel_err(got, want) <= fla.ROW_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", ATTN_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,kv,d", GQA_CASES)
def test_flash_attention_gqa_kernel_matches_plain(b, s, h, kv, d, dtype,
                                                  tol):
    _need_card()
    q, k, v = (torch.from_numpy(a).to("cuda", dtype)
               for a in attn_inputs(b, s, h, kv, d, s * h))
    before = kernels.flash_attention.launches
    routes = _route_counts()
    got = kernels.flash_attention_gqa(q, k, v)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    assert _moved(routes) == fla.route_for(dtype, d)
    assert got.shape == q.shape and got.dtype == dtype
    want = fla.flash_attention_gqa_plain(q, k, v)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    if fla.route_for(dtype, d) == "tc":
        assert fla.row_rel_err(got, want) <= fla.ROW_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("steep", [False, True], ids=["decay", "steep"])
@pytest.mark.parametrize("g,q,n,p", SSD_CASES)
def test_ssd_intra_kernel_matches_plain(g, q, n, p, steep):
    _need_card()
    args = [torch.from_numpy(a).cuda()
            for a in ssd_inputs(g, q, n, p, seed=g * q + n, steep=steep)]
    before = kernels.ssd_intra.launches
    got = kernels.ssd_intra(*args)
    torch.cuda.synchronize()
    assert kernels.ssd_intra.launches == before + 1
    assert bool(torch.isfinite(got).all())
    want = ssd.ssd_intra_plain(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(16, 128), (128, 64)])
def test_ssd_intra_keeps_16_warps_resident(n, p):
    """hymba-1.5b's (N = 16, P = 128) and mamba2-780m's (N = 128,
    P = 64) cells: the launch's kernel keeps at least 16 warps an SM."""
    _need_card()
    assert ssd.resident_warps(n, p) >= 16


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,nc,q,h,g,n,p", [
    (2, 3, 8, 4, 1, 8, 32), (1, 2, 16, 4, 2, 16, 16),
    (2, 2, 128, 25, 1, 16, 128)])
def test_ssd_intra_chunks_kernel_matches_plain(bsz, nc, q, h, g, n, p):
    _need_card()
    rng = np.random.default_rng(q * h)
    C, B = (torch.from_numpy(rng.standard_normal(
        (bsz, nc, q, g, n)).astype(np.float32)).cuda() for _ in range(2))
    x = torch.from_numpy(rng.standard_normal(
        (bsz, nc, q, h, p)).astype(np.float32)).cuda()
    cum = torch.from_numpy(np.cumsum(-np.logaddexp(rng.standard_normal(
        (bsz, nc, q, h)), 0.0), axis=2).astype(np.float32)).cuda()
    before = kernels.ssd_intra.launches
    got = kernels.ssd_intra_chunks(C, B, x, cum)
    torch.cuda.synchronize()
    assert kernels.ssd_intra.launches == before + 1
    want = ssd.ssd_intra_chunks_plain(C, B, x, cum)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_hymba_prefill_on_card_matches_cpu():
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill_forward
    cfg = get_config("hymba-1.5b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 37)))
    before = (kernels.flash_attention.launches, kernels.ssd_intra.launches)
    on_card = prefill_forward(
        _to_cuda(params), tokens.cuda(), cfg)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before[0] + cfg.n_layers
    assert kernels.ssd_intra.launches == before[1] + cfg.n_layers
    on_cpu = prefill_forward(params, tokens, cfg)
    for got, want in [(on_card[0], on_cpu[0])] + [
            (on_card[1][k], on_cpu[1][k]) for k in on_cpu[1]]:
        scale = float(want.abs().max()) + 1e-9
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale


def _to_cuda(tree):
    return {k: _to_cuda(v) if isinstance(v, dict) else v.cuda()
            for k, v in tree.items()}


# -- observability, serving: on the card -----------------------------------

def _fp64_labels_or_tie(q, c, labels):
    """Labels against argmin of the fp64 distance matrix; a differing
    label only at an fp32 near-tie (relative gap of the two best under
    1e-5). Returns the count of ties."""
    d2 = ((q.double()[:, None, :] - c.double()[None]) ** 2).sum(-1)
    ref = d2.argmin(1)
    bad = (labels.long() != ref).nonzero()[:, 0]
    if len(bad):
        two = d2[bad].topk(2, dim=1, largest=False).values
        assert bool((two[:, 1] - two[:, 0] <= 1e-5 * two[:, 1]).all())
        got = d2[bad, labels[bad].long()]
        assert bool((got - two[:, 0] <= 1e-5 * two[:, 1]).all())
    return len(bad)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fused", "grouped", "kernel"])
def test_serve_backends_on_card_match_fp64_oracle(backend):
    _need_card()
    from repro_torch.core.distances import row_norms_sq
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((8192, 32)).astype(
        np.float32)).cuda()
    c = torch.from_numpy(rng.standard_normal((256, 32)).astype(
        np.float32)).cuda()
    groups, members, gsize = engine.build_assign_tables(c, 25)
    fn = engine.make_serve_assign((256, 25), backend=backend)
    q0 = q.clone()
    before = kernels.grouped_assign.launches
    labels = fn(q, c, row_norms_sq(c), groups, members, gsize)
    torch.cuda.synchronize()
    assert kernels.grouped_assign.launches - before == (
        1 if backend == "kernel" else 0)
    assert torch.equal(q, q0)
    assert _fp64_labels_or_tie(q, c, labels) <= 8


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["kernel", "compact"])
def test_float64_ring_reconciles_exactly_at_2_18_points(backend):
    _need_card()
    from repro_torch.obs import MetricsRegistry, ObsConfig
    from repro_torch.obs.ring import COL_EVALS
    pts, _, _ = make_points(1 << 18, 32, 256, seed=0)
    init = pts[:: (1 << 18) // 256][:256].copy()
    kw = dict(max_iters=20, tol=1e-4, backend=backend, tune="off",
              device="cuda", return_stats=True)
    r0, s0 = engine.fit(pts, init, **kw)
    r1, s1 = engine.fit(pts, init, obs=ObsConfig(registry=MetricsRegistry()),
                        **kw)
    assert torch.equal(r0.assignments, r1.assignments)
    assert float(r0.inertia) == float(r1.inertia)
    assert s0.host_syncs == s1.host_syncs
    assert s1.ring.shape == (int(r1.n_iters) + 1, 8)
    # one kernel pass scores ~6.7e7 pairs here, above 2^24
    assert s1.ring[:, COL_EVALS].max() > 2 ** 24 or backend == "compact"
    assert s1.init_evals + s1.ring[:, COL_EVALS].sum() == \
        int(r1.distance_evals)


FIRST_LAUNCH_FROM_SERVE_THREAD = r"""
import numpy as np, torch
import repro_torch.kernels as kernels
from repro_torch.core import engine
from repro_torch.kernels import _build
from repro_torch.serve import CentroidIndex, ServeEngine
from repro_torch.tune import ServeConfig
rng = np.random.default_rng(0)
c = rng.standard_normal((64, 16)).astype(np.float32)
q = rng.standard_normal((3000, 16)).astype(np.float32)
idx = CentroidIndex(c, device="cuda")    # its tables use centroid_update
assert "grouped_assign" not in _build._LIBS
cfg = ServeConfig(backend="kernel", min_bucket=256, max_batch=1024)
with ServeEngine(idx, config=cfg, tune="off") as eng:
    futs = [eng.submit(q[lo:lo + 500]) for lo in range(0, 3000, 500)]
    # the caller touches the same kernel while the thread serves
    mine, _ = engine.assign(q, c, device="cuda")
    labels = np.concatenate([f.result(timeout=600).labels for f in futs])
    batches = eng.batches
x, cc = torch.from_numpy(q).double(), torch.from_numpy(c).double()
ref = ((x[:, None] - cc[None]) ** 2).sum(-1).argmin(1).numpy()
print("mismatch", int((labels != ref).sum()), "caller",
      int((mine.cpu().numpy() != ref).sum()), "batches", batches,
      "launches", kernels.grouped_assign.launches)
assert kernels.grouped_assign.launches == batches + 1
"""


@pytest.mark.cuda
def test_serve_thread_makes_the_first_kernel_launch():
    _need_card()
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", FIRST_LAUNCH_FROM_SERVE_THREAD],
        cwd=root, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    words = out.stdout.split()
    assert int(words[words.index("mismatch") + 1]) <= 3
    assert int(words[words.index("caller") + 1]) <= 3


@pytest.mark.cuda
def test_sharded_fit_in_a_gloo_world_on_the_card():
    """A world of 2 ``gloo`` ranks shares the card (NCCL takes one rank a
    card) and runs a compact sharded fit; gloo adds the two ranks'
    partial sums as one ``a + b``. Held bit for bit against the
    single-device compact fit whose ``centroid_update`` sums the two
    halves on the card apart and adds them so, and against the plain
    single-device compact fit: the same ``n_iters`` within one, inertia
    within 1e-5 and labels apart on at most 1e-3 of the points (another
    summation order may part a fit, ROADMAP Queue 3 item 2)."""
    _need_card()
    import _torch_world
    from repro_torch.core.distributed import spawn_world
    pts, _, _ = make_points(8192, 16, 32, seed=5)
    init = pts[:: 8192 // 32][:32].copy()
    ranks = spawn_world(_torch_world.card_pair, 2, args=(pts, init),
                        timeout=600)
    got = ranks[0]
    assert got["device"] == "cuda:0"
    assert all(r["launches"] >= r["n_iters"] for r in ranks)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["centroids"], got["centroids"])
    kw = dict(backend="compact", tune="off", max_iters=40, tol=1e-5,
              device="cuda")
    n = len(pts)
    kernel = kernels.centroid_update

    def halves(points, labels, k, weights=None):
        if points.shape[0] != n:            # group_centroids' calls
            return kernel(points, labels, k, weights)
        a = kernel(points[:n // 2].contiguous(), labels[:n // 2].contiguous(),
                   k, None if weights is None else weights[:n // 2])
        b = kernel(points[n // 2:].contiguous(), labels[n // 2:].contiguous(),
                   k, None if weights is None else weights[n // 2:])
        return a[0] + b[0], a[1] + b[1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "centroid_update", halves)
        two = engine.fit(pts, init, **kw)
    np.testing.assert_array_equal(got["assignments"],
                                  two.assignments.cpu().numpy())
    assert got["n_iters"] == two.n_iters
    np.testing.assert_array_equal(got["centroids"],
                                  two.centroids.cpu().numpy())
    one = engine.fit(pts, init, **kw)
    assert abs(got["n_iters"] - one.n_iters) <= 1
    np.testing.assert_allclose(got["inertia"], float(one.inertia), rtol=1e-5)
    assert (got["assignments"] != one.assignments.cpu().numpy()).mean() \
        <= 1e-3


@pytest.mark.cuda
def test_sharded_stream_in_a_gloo_world_on_the_card():
    """A world of 2 ``gloo`` ranks shares the card and streams the
    6-shard stream of ``_stream_on_card`` for 3 epochs (``device=None``:
    rank r on ``cuda:(r % count)``): the ranks agree bit for bit, each
    launches ``centroid_update`` at least once a batch, and the stream
    is held against the single-device stream on the card by its counts'
    sum (exact), inertia (rtol 1e-3) and first labels (all but 1e-3;
    another partition of the sums may part a near-tie, ROADMAP Queue 3
    item 2)."""
    _need_card()
    import _torch_world
    from repro_torch.core.distributed import spawn_world
    ranks = spawn_world(_torch_world.card_stream_pair, 2, timeout=600)
    got = ranks[0]
    assert got["device"] == "cuda:0"
    assert got["stats"]["sharded_batches"] == 18
    assert all(r["launches"] >= 18 for r in ranks)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["centroids"], got["centroids"])
        assert r["stats"] == got["stats"]
    local = _torch_world.card_stream(None)
    assert local["stats"]["cache_hits"] == got["stats"]["cache_hits"] == 12
    assert got["counts"].sum() == local["counts"].sum()
    np.testing.assert_allclose(got["inertia"], local["inertia"], rtol=1e-3)
    assert (got["first"] != local["first"]).mean() <= 1e-3


# -- the LM kernels' backward, and training, on the card ---------------------
#
# Tolerances: each gradient within 1e-4 (fp32) or 3e-2 (bf16) of the
# largest |value| of the plain version's, the forward's tolerances (the
# kernels sum in another order than the plain version); a gradient of
# the kernels against central finite differences of the fp32 forward
# kernel within 1e-2 of the largest |gradient| (step 1e-2: the
# difference's own error, O(step^2) and fp32 rounding over the step,
# is about 1e-4 of the scale); two identical backward calls bit for bit.

# the model's attention launch (b, s, h, kv, d): GQA_CASES (ragged S,
# grouped heads, hymba's 25/5 heads of 64, a head dim of 128), a head
# dim of 100, one query head a kv head, and the tensor-core backward's
# head dims 64, 96 and 128 (in bf16) at S of three rows, one 64-row
# tile, one past it, two tiles and two past, and 16 tiles, with groups
# of 1 and of 5 query heads (hymba-1.5b's); at 96 (MLA's q.k) also
# minicpm3-4b's 40 heads, KV = H, at a ragged S
GQA_BWD_CASES = GQA_CASES + [(1, 65, 2, 2, 100), (2, 64, 3, 3, 32),
                             (2, 3, 5, 1, 64), (1, 64, 5, 1, 64),
                             (2, 65, 2, 2, 64), (1, 130, 5, 1, 128),
                             (2, 130, 3, 3, 128), (1, 1024, 10, 2, 64),
                             (1, 1024, 2, 2, 128), (2, 3, 2, 2, 96),
                             (1, 65, 4, 2, 96), (1, 130, 40, 40, 96),
                             (1, 1024, 5, 1, 96)]
# ssd_intra_chunks (bsz, nc, q, h, g, n, p): the reduced configs' cell,
# two groups, hymba-1.5b's cell (25 heads, one group), mamba2-780m's
# (N 128, P 64), a Q that is not a multiple of the 32-row tiles, and
# hymba-1.5b's cells at 500 cells, 1,000 blocks: more than one wave of
# the card's 264 slots (two blocks an SM)
SSD_BWD_CASES = [(2, 3, 8, 4, 1, 8, 32), (1, 2, 16, 4, 2, 16, 16),
                 (2, 2, 128, 25, 1, 16, 128), (1, 2, 128, 4, 1, 128, 64),
                 (1, 3, 100, 6, 3, 16, 128), (2, 10, 128, 25, 1, 16, 128),
                 # chunks over 128 rows: the wide route's tiles, ragged
                 # ones and ones whose rows are not on 16 bytes
                 (1, 2, 256, 25, 1, 16, 128), (1, 2, 200, 6, 1, 128, 64),
                 (1, 1, 300, 4, 2, 8, 16), (1, 1, 257, 3, 3, 5, 7)]


def _scaled_err(got, want):
    want = want.float()
    return float((got.float() - want).abs().max()) / \
        (float(want.abs().max()) + 1e-12)


def _gqa_grad_inputs(b, s, h, kv, d, dtype, seed):
    q, k, v = (torch.from_numpy(a).to("cuda", dtype)
               for a in attn_inputs(b, s, h, kv, d, seed))
    do = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (b, s, h, d)).astype(np.float32)).to("cuda", dtype)
    return q, k, v, do


def _bwd_counts():
    f = fla.flash_attention_gqa_bwd
    return {"all": f.launches, "tc": f.launches_tc, "ffma": f.launches_ffma}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,kv,d", GQA_BWD_CASES)
def test_flash_attention_gqa_bwd_kernel_matches_plain(b, s, h, kv, d, dtype,
                                                      tol):
    _need_card()
    q, k, v, do = _gqa_grad_inputs(b, s, h, kv, d, dtype, s * h + d)
    o, lse = fla.flash_attention_gqa_with_lse(q, k, v)
    before = _bwd_counts()
    got = fla.flash_attention_gqa_bwd(q, k, v, o, do, lse)
    again = fla.flash_attention_gqa_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    route = fla.route_for(dtype, d)
    assert _bwd_counts() == {key: n + 2 * (key in ("all", route))
                             for key, n in before.items()}
    want = fla.flash_attention_gqa_bwd_plain(q, k, v, o, do)
    # the tensor-core route's inputs through the FFMA route forced
    ffma = fla.launch_gqa_bwd(q, k, v, o, do, lse, "ffma") \
        if route == "tc" else got
    for name, g, w, a, f, x in zip(("dq", "dk", "dv"), got, want, again,
                                   ffma, (q, k, v)):
        assert g.shape == x.shape and g.dtype == dtype, name
        assert bool(torch.isfinite(g).all()), name
        assert _scaled_err(g, w) <= tol, (name, _scaled_err(g, w))
        assert _scaled_err(f, w) <= tol, (name, _scaled_err(f, w))
        # every query's and key's row, small late ones too
        for t in (g, f):
            rows = fla.row_rel_err(t, w, fla.BWD_ROW_FLOOR)
            assert rows <= fla.BWD_ROW_REL_TOL, (name, rows)
        assert torch.equal(g, a), name


@pytest.mark.cuda
def test_flash_attention_gqa_bwd_matches_finite_differences():
    _need_card()
    q, k, v, do = _gqa_grad_inputs(1, 11, 4, 2, 8, torch.float32, 3)
    o, lse = fla.flash_attention_gqa_with_lse(q, k, v)
    grads = fla.flash_attention_gqa_bwd(q, k, v, o, do, lse)
    rng = np.random.default_rng(4)
    eps = 1e-2
    for which, g in enumerate(grads):
        scale = float(g.abs().max())
        for flat in rng.choice(g.numel(), 6, replace=False):
            args = [q.clone(), k.clone(), v.clone()]
            idx = np.unravel_index(flat, g.shape)
            args[which][idx] += eps
            up = float((kernels.flash_attention_gqa(*args) * do).sum())
            args[which][idx] -= 2 * eps
            dn = float((kernels.flash_attention_gqa(*args) * do).sum())
            fd = (up - dn) / (2 * eps)
            assert abs(fd - float(g[idx])) <= 1e-2 * scale, (which, idx)


@pytest.mark.cuda
def test_flash_attention_function_launches_the_backward_kernel():
    """With a gradient asked of q, the model's launch goes through the
    Function: one forward launch (writing L), one backward launch on the
    tensor cores (bf16 at d 64), grads the kernel's given the forward's
    L; under no_grad it is the serving launch alone."""
    _need_card()
    q, k, v, do = _gqa_grad_inputs(2, 70, 4, 2, 64, torch.bfloat16, 9)
    fwd, bwd = kernels.flash_attention.launches, _bwd_counts()
    qg = q.clone().requires_grad_(True)
    out = kernels.flash_attention_gqa(qg, k, v)
    (dq,) = torch.autograd.grad(out, qg, do)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == fwd + 1
    assert _bwd_counts() == dict(bwd, all=bwd["all"] + 1,
                                 tc=bwd["tc"] + 1)
    o, lse = fla.flash_attention_gqa_with_lse(q, k, v)
    assert torch.equal(o, out.detach())
    assert torch.equal(dq, fla.flash_attention_gqa_bwd(q, k, v, o, do,
                                                       lse)[0])
    with torch.no_grad():
        kernels.flash_attention_gqa(qg, k, v)
    assert kernels.flash_attention.launches == fwd + 3
    assert fla.flash_attention_gqa_bwd.launches == bwd["all"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.bfloat16, 32),
                                     (torch.float32, 64),
                                     (torch.bfloat16, 96)],
                         ids=["bf16-64-tc", "bf16-128-tc", "bf16-32-ffma",
                              "f32-64-ffma", "bf16-96-tc"])
def test_flash_attention_forward_writes_the_plain_lse(dtype, d):
    """Both forward kernels write each row's logsumexp in natural-log
    units, the plain version's L within 1e-3 (bf16 inputs: the
    tensor-core kernel's exponentials are ex2.approx) or 1e-4 (fp32:
    the scores summed in another order),
    and the same output as the serving launch, bit for bit."""
    _need_card()
    q, k, v, _ = _gqa_grad_inputs(2, 130, 4, 2, d, dtype, d)
    route = fla.route_for(dtype, d)
    counts = (kernels.flash_attention.launches_tc,
              kernels.flash_attention.launches_ffma)
    o, lse = fla.flash_attention_gqa_with_lse(q, k, v)
    assert (kernels.flash_attention.launches_tc,
            kernels.flash_attention.launches_ffma) == (
        counts[0] + (route == "tc"), counts[1] + (route == "ffma"))
    want_o, want = fla.flash_attention_gqa_lse_plain(q, k, v)
    assert lse.shape == (2, 4, 130) and lse.dtype == torch.float32
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    assert float((lse - want).abs().max()) <= tol
    assert torch.equal(o, kernels.flash_attention_gqa(q, k, v))


def _ssd_grad_inputs(bsz, nc, q, h, g, n, p, seed):
    rng = np.random.default_rng(seed)
    C, B = (torch.from_numpy(rng.standard_normal(
        (bsz, nc, q, g, n)).astype(np.float32)).cuda() for _ in range(2))
    x, dy = (torch.from_numpy(rng.standard_normal(
        (bsz, nc, q, h, p)).astype(np.float32)).cuda() for _ in range(2))
    cum = torch.from_numpy(np.cumsum(-np.logaddexp(rng.standard_normal(
        (bsz, nc, q, h)), 0.0) * 0.1, axis=2).astype(np.float32)).cuda()
    return C, B, x, cum, dy


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,nc,q,h,g,n,p", SSD_BWD_CASES)
def test_ssd_intra_chunks_bwd_kernel_matches_plain(bsz, nc, q, h, g, n, p):
    _need_card()
    C, B, x, cum, dy = _ssd_grad_inputs(bsz, nc, q, h, g, n, p, q * h + n)
    before = ssd.ssd_intra_chunks_bwd.launches
    got = ssd.ssd_intra_chunks_bwd(C, B, x, cum, dy)
    again = ssd.ssd_intra_chunks_bwd(C, B, x, cum, dy)
    torch.cuda.synchronize()
    assert ssd.ssd_intra_chunks_bwd.launches == before + 2
    want = ssd.ssd_intra_chunks_bwd_plain(C, B, x, cum, dy)
    for name, gr, w, a, t in zip(("dC", "dB", "dx", "dcum"), got, want,
                                 again, (C, B, x, cum)):
        assert gr.shape == t.shape and gr.dtype == torch.float32, name
        assert _scaled_err(gr, w) <= 1e-4, (name, _scaled_err(gr, w))
        assert torch.equal(gr, a), name


@pytest.mark.cuda
def test_ssd_intra_chunks_bwd_matches_finite_differences():
    _need_card()
    C, B, x, cum, dy = _ssd_grad_inputs(1, 2, 20, 4, 2, 8, 16, 5)
    grads = ssd.ssd_intra_chunks_bwd(C, B, x, cum, dy)
    rng = np.random.default_rng(6)
    eps = 1e-2
    for which, g in enumerate(grads):
        scale = float(g.abs().max())
        for flat in rng.choice(g.numel(), 6, replace=False):
            args = [C.clone(), B.clone(), x.clone(), cum.clone()]
            idx = np.unravel_index(flat, g.shape)
            args[which][idx] += eps
            up = float((kernels.ssd_intra_chunks(*args) * dy).sum())
            args[which][idx] -= 2 * eps
            dn = float((kernels.ssd_intra_chunks(*args) * dy).sum())
            fd = (up - dn) / (2 * eps)
            assert abs(fd - float(g[idx])) <= 1e-2 * scale, (which, idx)


@pytest.mark.cuda
def test_sharded_step_on_a_one_rank_nccl_mesh_is_the_unsharded_step():
    """The sharded step (``make_sharded_train_step``) in a world of one
    rank over NCCL, on the trivial mesh, from the state of the unsharded
    step: parameters, moments, loss and grad_norm the same bits (no
    collective may change a value), the kernels launched as the
    unsharded step launches them."""
    _need_card()
    import dataclasses

    from repro_torch.checkpoint.checkpoint import tree_flatten
    from repro_torch.configs import get_config
    from repro_torch.core.distributed import one_rank_world
    from repro_torch.data import TokenPipeline
    from repro_torch.dtensor import gather_full
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (batch_pspecs, named,
                                             train_state_pspecs)
    from repro_torch.train import (init_train_state, make_sharded_train_step,
                                   make_train_step)
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(),
                              dtype="bfloat16")
    state = init_train_state(cfg, torch.Generator("cuda").manual_seed(0))
    batch = TokenPipeline(cfg, batch=2, seq=64, seed=0).global_batch(0)
    want, wm = make_train_step(cfg)(state, batch)
    before = (fla.flash_attention_gqa_bwd.launches,
              ssd.ssd_intra_chunks_bwd.launches)
    with one_rank_world("nccl"):
        mesh = make_host_mesh()
        step = make_sharded_train_step(cfg, named(mesh, train_state_pspecs(
            cfg)), named(mesh, batch_pspecs(cfg, mesh)))
        got, gm = step(state, batch)
        full = [gather_full(x) for x in tree_flatten(got)[0]]
    torch.cuda.synchronize()
    assert fla.flash_attention_gqa_bwd.launches == before[0] + cfg.n_layers
    assert ssd.ssd_intra_chunks_bwd.launches == before[1] + cfg.n_layers
    for key in ("loss", "grad_norm", "lr"):
        assert torch.equal(gm[key], wm[key]), key
    for a, b in zip(full, tree_flatten(want)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-780m", "qwen2-7b"])
def test_train_step_on_card_matches_cpu_and_repeats(arch):
    """A reduced config's train step (remat on) on the card against the
    same step on the CPU (plain versions): loss and grad_norm within
    1e-4, every updated leaf within 1e-4 of its scale; two steps from
    one state on the card give the same bits; the backward kernels ran
    once a layer."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.train import init_train_state, make_train_step
    cfg = get_config(arch).reduced()
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    batch = TokenPipeline(cfg, batch=2, seq=40, seed=0).global_batch(0)
    step = make_train_step(cfg)
    cpu_state, cpu_m = step(state, batch)
    card = state._replace(step=state.step.cuda(),
                          params=_to_cuda(state.params),
                          m=_to_cuda(state.m), v=_to_cuda(state.v))
    before = (fla.flash_attention_gqa_bwd.launches,
              ssd.ssd_intra_chunks_bwd.launches)
    one, m1 = step(card, batch)
    torch.cuda.synchronize()
    attn = cfg.family != "ssm"
    ssm = cfg.family in ("ssm", "hybrid")
    assert fla.flash_attention_gqa_bwd.launches == \
        before[0] + attn * cfg.n_layers
    assert ssd.ssd_intra_chunks_bwd.launches == before[1] + ssm * cfg.n_layers
    two, m2 = step(card, batch)
    for key in ("loss", "grad_norm"):
        assert abs(float(m1[key]) - float(cpu_m[key])) <= \
            1e-4 * abs(float(cpu_m[key])), key
        assert torch.equal(m1[key], m2[key]), key
    from repro_torch.checkpoint.checkpoint import tree_flatten
    for a, b, c in zip(tree_flatten(one)[0], tree_flatten(two)[0],
                       tree_flatten(cpu_state)[0]):
        assert torch.equal(a, b)
        if a.is_floating_point():
            assert _scaled_err(a.cpu(), c) <= 1e-4


# -- the MoE FFN on the card ---------------------------------------------------

def _moe_case(arch, seed, dtype, device):
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()       # capacity factor 1.25: drops
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    shapes = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
              "w_down": (e, f, d)}
    p = {k: torch.from_numpy((rng.standard_normal(s) * s[-2] ** -0.5)
                             .astype(np.float32)).to(device, dtype)
         .requires_grad_() for k, s in shapes.items()}
    # one shared direction crowds the tokens onto some experts
    x = rng.standard_normal((2, 24, d)) + 1.5 * rng.standard_normal(d)
    x = torch.from_numpy(x.astype(np.float32)).to(device, dtype)
    r = torch.from_numpy(rng.standard_normal((2, 24, d)).astype(np.float32))
    return cfg, x.requires_grad_(), p, r.to(device, dtype)


def _moe_pass(cfg, x, p, r):
    from repro_torch.models.moe import moe_ffn
    for t in (x, *p.values()):
        t.grad = None
    out = moe_ffn(x, p, cfg)
    (out * r).sum().backward()
    return out.detach(), {"x": x.grad} | {k: t.grad for k, t in p.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama4-scout-17b-a16e"])
def test_moe_ffn_on_card_matches_cpu(arch):
    """fp32, experts overflowing at the config's capacity: the output
    within 1e-5 of the CPU's scale, every gradient within 1e-4 (sums in
    another order)."""
    _need_card()
    cpu_out, cpu_grads = _moe_pass(*_moe_case(arch, 0, torch.float32, "cpu"))
    out, grads = _moe_pass(*_moe_case(arch, 0, torch.float32, "cuda"))
    assert _scaled_err(out.cpu(), cpu_out) <= 1e-5
    for name, g in grads.items():
        if not cpu_grads[name].abs().max():      # top-1: the router's
            assert not g.abs().max(), name
            continue
        assert _scaled_err(g.cpu(), cpu_grads[name]) <= 1e-4, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama4-scout-17b-a16e"])
def test_moe_ffn_on_card_repeats_bit_for_bit(arch, dtype):
    """Two forward-and-backward passes on the same inputs give the same
    bits: no scatter-add or atomic accumulation on the path."""
    _need_card()
    case = _moe_case(arch, 1, dtype, "cuda")
    out1, g1 = _moe_pass(*case)
    g1 = {k: v.clone() for k, v in g1.items()}
    out2, g2 = _moe_pass(*case)
    assert torch.equal(out1, out2)
    for name in g1:
        assert torch.equal(g1[name], g2[name]), name
