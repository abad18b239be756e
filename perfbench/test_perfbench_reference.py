"""The generator, the plain reference and the comparison, on the CPU at
tiny sizes, by their own arithmetic."""
import pytest
import torch

from perfbench import compare, generator, reference

CPU = torch.device("cpu")
BIG_SEED = 2 ** 64 + 12345


def _points(seed, n=512, d=4, centres=8, spread=8.0):
    return generator.make_points(n, d, n_centres=centres, spread=spread,
                                 cluster_std=1.0, seed=seed, device=CPU)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, BIG_SEED])
def test_generator_repeats_from_the_seed(seed):
    a, b = _points(seed), _points(seed)
    assert a.dtype == torch.float32 and a.shape == (512, 4)
    assert torch.equal(a, b)
    assert not torch.equal(a, _points(seed + 1))
    r1 = generator.initial_rows(512, 16, seed=seed, restart=3, device=CPU)
    r2 = generator.initial_rows(512, 16, seed=seed, restart=3, device=CPU)
    assert torch.equal(r1, r2)
    assert len(set(r1.tolist())) == 16
    assert not torch.equal(r1, generator.initial_rows(
        512, 16, seed=seed, restart=4, device=CPU))
    assert not torch.equal(r1, generator.initial_rows(
        512, 16, seed=seed, restart=3, device=CPU, stream="warmup"))


@pytest.mark.parametrize("seed", [3, BIG_SEED])
def test_rotation_keeps_distances_and_moves_every_coordinate(seed):
    q = generator.rotation(8, seed=seed)
    assert torch.equal(q, generator.rotation(8, seed=seed))
    assert torch.allclose(q.T @ q, torch.eye(8, dtype=torch.float64),
                          atol=1e-12)
    x = _points(seed, n=256, d=8)
    y = generator.rotate(x, q)
    assert y.dtype == torch.float32
    assert torch.allclose(torch.cdist(y.double(), y.double()),
                          torch.cdist(x.double(), x.double()),
                          rtol=1e-5, atol=1e-4)
    assert bool((y != x).all())
    assert not torch.equal(y, generator.rotate(
        x, generator.rotation(8, seed=seed + 1)))


def test_generator_follows_the_blob_recipe():
    x = generator.make_points(20000, 2, n_centres=1, spread=0.0,
                              cluster_std=3.0, seed=5, device=CPU)
    assert abs(float(x.mean())) < 0.1
    assert abs(float(x.std()) - 3.0) < 0.1


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -(1.0 + 3 * 2 ** -12), 3.0], dtype=torch.float32)
    got = reference.tf32_round(x)
    want = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                         -(1.0 + 2 ** -10), 3.0])
    assert torch.equal(got, want)


def test_reference_fit_on_a_line():
    # two clusters on a line; from C0 = (0, 1) the first move takes the
    # centroids to the means of {0, 1} and {9, 10, 11}, then stops
    x = torch.tensor([[0.0], [1.0], [9.0], [10.0], [11.0]])
    fit = reference.fit(x, torch.tensor([[0.0], [1.0]]), max_iters=10,
                        tol=1e-4)
    assert fit.labels.tolist() == [0, 0, 1, 1, 1]
    assert torch.allclose(fit.centroids, torch.tensor([[0.5], [10.0]],
                                                      dtype=torch.float64))
    assert fit.n_iters == 3     # moves 1 and 2 shift, move 3 reads 0
    assert fit.inertia == pytest.approx(0.25 * 2 + 2.0)


def test_reference_stops_at_max_iters_and_keeps_empty_clusters():
    x = torch.tensor([[0.0], [1.0], [9.0], [10.0]])
    init = torch.tensor([[0.0], [10.0], [100.0]])
    fit = reference.fit(x, init, max_iters=1, tol=0.0)
    assert fit.n_iters == 1
    assert fit.centroids[2].item() == 100.0      # never won a point
    assert fit.labels.tolist() == [0, 0, 1, 1]


def test_ties_go_to_the_lower_index():
    labels, _ = reference.nearest(torch.tensor([[1.0]]),
                                  torch.tensor([[0.0], [2.0]]))
    assert labels.tolist() == [0]


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_precisions_agree_on_separated_blobs(precision):
    x = _points(3, n=2048, d=8, centres=6, spread=20.0)
    init = x[generator.initial_rows(2048, 6, seed=3, restart=0, device=CPU)]
    exact = reference.fit(x, init, max_iters=30, tol=1e-4)
    got = reference.fit(x, init, max_iters=30, tol=1e-4,
                        precision=precision)
    assert torch.equal(got.labels, exact.labels)
    assert got.inertia == pytest.approx(exact.inertia, rel=1e-3)


def test_reference_fit_is_a_lloyd_fixed_point_when_converged():
    x = _points(4, n=4096, d=4, centres=5, spread=30.0)
    init = x[generator.initial_rows(4096, 5, seed=4, restart=0, device=CPU)]
    fit = reference.fit(x, init, max_iters=100, tol=1e-9)
    assert fit.n_iters < 100
    means = reference.centroid_means(x, fit.labels, fit.centroids)
    assert torch.allclose(means, fit.centroids, atol=1e-9)
    again, _ = reference.nearest(x, fit.centroids)
    assert torch.equal(again, fit.labels)


def _answer(fit):
    return compare.Answer(fit.centroids.float(), fit.labels.int(),
                          fit.n_iters, fit.inertia)


def test_the_reference_reads_zero_against_itself():
    x = _points(8, n=2048, d=4, centres=8)
    init = x[generator.initial_rows(2048, 8, seed=8, restart=0, device=CPU)]
    fit = reference.fit(x, init, max_iters=20, tol=1e-4)
    got = compare.readings(x, _answer(fit), fit)
    assert got["labels_off_ref"] == 0.0 and got["n_iters_gap"] == 0.0
    assert got["inertia_gap"] < 1e-6
    assert got["label_gap"] < 1e-6


def test_label_gap_reads_a_wrong_label_and_a_bad_one():
    x = torch.tensor([[0.0, 0.0], [10.0, 0.0]])
    c = torch.tensor([[0.0, 0.0], [10.0, 0.0]])
    assert compare.label_gap(x, c, torch.tensor([0, 1])) == 0.0
    # the first point labelled 1: 100 farther over |x|^2 + |c_0|^2 = 0
    assert compare.label_gap(x, c, torch.tensor([1, 1])) == float("inf")
    x = x + 1.0
    gap = compare.label_gap(x, c, torch.tensor([1, 1]))
    assert gap == pytest.approx((82.0 - 2.0) / (2.0 + 0.0))
    assert compare.label_gap(x, c, torch.tensor([0, 2])) == float("inf")


def test_move_gap_reads_centroids_off_their_means():
    x = torch.tensor([[0.0], [2.0], [10.0], [12.0]])
    labels = torch.tensor([0, 0, 1, 1])
    good = torch.tensor([[1.0], [11.0]])
    assert compare.move_gap(x, good, labels) == 0.0
    off = torch.tensor([[1.5], [11.5]])
    # each mean 0.5 away; the points lie 1.5, 0.5, 1.5 and 0.5 away
    rms = ((2 * 2.25 + 2 * 0.25) / 4) ** 0.5
    assert compare.move_gap(x, off, labels) == pytest.approx(0.5 / rms)


def test_passes_and_nan():
    assert compare.passes(1.0, 1.0)
    assert not compare.passes(1.1, 1.0)
    assert not compare.passes(float("nan"), 1.0)
