"""The comparison that decides ``correct``: a sound rehearsal passes, and
with the timed path broken underneath, or with the control in the
program's place, the run comes out not correct. The look for a card is
skipped: everything else is the run's own path, on the CPU at a small
size."""
import pytest
import torch

from perfbench import bench, faults, reference
from repro_torch.core import engine
from repro_torch.core.kmeans import KMeansResult

CPU = torch.device("cpu")
SMALL = {"n_points": 8192, "k": 32, "n_groups": 3}
CELLS = ["uci-xlarge.fit-blobs", "uci-highk.fit-overlap"]
# The cells' move_gap limits hold the card's centroid_update kernel to
# the accuracy of its sums at the cells' sizes (PERF.md). The port's CPU
# route sums in plain float32; at SMALL its sound fits read up to 5.8e-7,
# and the faults read 1e-3 and more.
CPU_ROUTE = {"move_gap": 2e-6}


def _run(cell, seed=2 ** 33 + 1, size=SMALL, seconds=0.3):
    result, _ = bench.run_cell(cell, seed=seed, seconds=seconds,
                               trace=False, started=0.0, device=CPU,
                               config_override=size,
                               limits_override=CPU_ROUTE)
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    assert _run(cell)["correct"] is True


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, fault):
    with faults.FAULTS[fault]():
        result = _run(cell)
    assert result["correct"] is False
    assert result["failed"] >= 1


def _control_fit(points, init, *, max_iters, tol, return_stats, **_):
    """The reference in TF32 in the program's place."""
    got = reference.fit(points, init, max_iters=max_iters, tol=tol,
                        precision="tf32")
    res = KMeansResult(got.centroids.float(), got.labels.int(), got.n_iters,
                       torch.tensor(0, dtype=torch.int64),
                       torch.tensor(got.inertia))
    return (res, engine.EngineStats()) if return_stats else res


def test_the_control_is_not_correct(monkeypatch):
    # a size at which TF32's distances move labels; the chip's readings
    # at the cells' own sizes are in PERF.md
    monkeypatch.setattr(engine, "fit", _control_fit)
    result = _run("uci-xlarge.fit-blobs",
                  size={"n_points": 32768, "k": 256, "n_groups": 25},
                  seconds=0.1)
    assert result["correct"] is False
    assert result["checks"]["label_gap"]["value"] > \
        result["checks"]["label_gap"]["limit"]
