"""The roofline counts, the share and its refusal past 100%, and the
trace's arithmetic on a made-up trace."""
import json
from types import SimpleNamespace

import pytest

from perfbench import bench, rooflines, tracing
from perfbench.rooflines import centroid_update, grouped_assign

XLARGE = json.loads((bench.HERE / "configs" / "uci-xlarge.json").read_text())
HBM = 3.35e12
FP32 = 6.7e13
PEAKS = {"hbm_bytes_per_s": HBM, "fp32_flops_per_s": FP32}


def test_centroid_update_bound_at_uci_xlarge():
    # PERF.md's bound of the kernel at uci-xlarge: 0.0413 ms
    ms = centroid_update.launch_bytes(XLARGE) / HBM * 1e3
    assert round(ms, 4) == 0.0413


def test_grouped_assign_count_follows_its_formula():
    cfg = {"n_points": 1000, "n_dims": 8, "k": 40, "n_groups": 4}
    want = 1000 * 8 * 4 + 40 * 8 * 4 + 1000 * 8 + 2 * 1000 * 4 * 4
    assert grouped_assign.launch_bytes(cfg) == want
    cfg["n_groups"] = 5
    assert grouped_assign.launch_bytes(cfg) == want + 2 * 1000 * 4


def _trace(kernel_us, launch_in=True, window=(0.0, 1000.0)):
    """A trace with one candidate-pass range and a ga launch inside."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW,
         "ts": window[0], "dur": window[1] - window[0]},
        {"ph": "X", "cat": "user_annotation", "name": "kpynq/candidate_pass",
         "ts": 10.0, "dur": 50.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 20.0 if launch_in else 200.0, "dur": 2.0,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 21.0, "dur": 2.0, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::"
         "ga_plan_kernel(int const*, int, int, int*, int*)",
         "ts": 100.0, "dur": 1.0, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel",
         "name": "void (anonymous namespace)::ga_kernel<8>(float const*)",
         "ts": 101.0, "dur": kernel_us, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 600.0,
         "dur": 300.0},
    ]
    return tracing.parse(events, calls=1)


def _reading(trace, peaks=PEAKS, traced=()):
    return bench.Reading(XLARGE, [], trace, list(traced), peaks)


def _fit(evals, n_iters=50):
    return SimpleNamespace(distance_evals=evals, n_iters=n_iters)


def test_share_of_the_roofline():
    bound_us = grouped_assign.launch_bytes(XLARGE) / HBM * 1e6
    tr = _trace(kernel_us=4 * bound_us - 1.0)
    assert rooflines.share(_reading(tr), "grouped_assign") == \
        pytest.approx(25.0)


def test_grouped_assign_pairs_leave_out_the_init_and_the_moves():
    n, k = XLARGE["n_points"], XLARGE["k"]
    fit = _fit(n * k + 3 * n * k + 7 * n, n_iters=7)
    assert grouped_assign.pass_pairs(XLARGE, fit) == 3 * n * k
    assert grouped_assign.pass_pairs(XLARGE, _fit(n * k, 7)) == 0


def test_the_larger_of_bytes_and_operations_bounds_the_kernel():
    n, k, d = (XLARGE[key] for key in ("n_points", "k", "n_dims"))
    bytes_s = grouped_assign.launch_bytes(XLARGE) / HBM
    # one traced launch whose fit scored pairs worth twice its bytes' time
    pairs = round(2 * bytes_s * FP32 / (2 * d))
    traced = [_fit(n * k + 50 * n + pairs)]
    least, by = rooflines.least_s(_reading(None, traced=traced),
                                  "grouped_assign", 1)
    assert by == "operations"
    assert least == pytest.approx(2 * bytes_s, rel=1e-9)
    tr = _trace(kernel_us=4 * least * 1e6 - 1.0)   # and 1 us of plan
    assert rooflines.share(_reading(tr, traced=traced),
                           "grouped_assign") == pytest.approx(25.0, rel=1e-3)
    # few pairs: the bytes bound it
    least, by = rooflines.least_s(_reading(None, traced=[_fit(n * k)]),
                                  "grouped_assign", 1)
    assert (least, by) == (pytest.approx(bytes_s), "bytes")
    least, by = rooflines.least_s(_reading(None), "centroid_update", 1)
    assert by == "bytes"


def test_a_share_over_100_percent_fails_the_run():
    bound_us = grouped_assign.launch_bytes(XLARGE) / HBM * 1e6
    tr = _trace(kernel_us=bound_us / 2)
    with pytest.raises(RuntimeError, match="grouped_assign_roofline"):
        rooflines.share(_reading(tr), "grouped_assign")
    # and by operations: the bytes alone would read 80%
    n, k, d = (XLARGE[key] for key in ("n_points", "k", "n_dims"))
    tr = _trace(kernel_us=bound_us / 0.8)
    pairs = round(2 * bound_us * 1e-6 * FP32 / (2 * d))
    with pytest.raises(RuntimeError, match="grouped_assign_roofline"):
        rooflines.share(_reading(tr, traced=[_fit(n * k + 50 * n + pairs)]),
                        "grouped_assign")


def test_no_launch_or_no_peaks_reads_nothing():
    tr = _trace(kernel_us=500.0, launch_in=False)
    assert rooflines.share(_reading(tr), "grouped_assign") is None
    assert rooflines.share(_reading(_trace(500.0), None),
                           "grouped_assign") is None
    assert rooflines.share(_reading(None), "centroid_update") is None


def test_busy_idle_and_breakdown():
    tr = _trace(kernel_us=99.0)
    assert tr.busy_s() == pytest.approx(100e-6)
    assert tr.window_s == pytest.approx(1e-3)
    ops = tr.launched_in("kpynq/candidate_pass")
    assert [o.name.split("::")[1][:9] for o in ops] == ["ga_plan_k",
                                                        "ga_kernel"]
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["(anonymous namespace)::ga_kernel<8>",
                                   pytest.approx(99e-6)]
    gaps = dict(bd["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(800e-6)
    assert sum(gaps.values()) == pytest.approx(900e-6)
    idle = bench.reader("device.idle_share")(_reading(tr))
    assert idle == pytest.approx(90.0)
    ms = bench.reader("candidate_pass.device_ms")(_reading(tr))
    assert ms == pytest.approx(0.1)
    assert bench.reader("move_and_bounds.device_ms")(_reading(tr)) is None


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError):
        tracing.parse([], calls=1)


def test_short_names():
    assert tracing.short_name("void (anonymous namespace)::ga_kernel<8>"
                              "(float const*, int)") == \
        "(anonymous namespace)::ga_kernel<8>"
    assert tracing.short_name("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH (Device -> Pageable)"
