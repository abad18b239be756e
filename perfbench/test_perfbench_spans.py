"""The readers of the program's spans on a made-up trace: the five
metrics' values, the window's clipping, nothing read where the trace
holds no device operation, and the seven older readers unmoved by the
new ranges nested inside and around the ones they read."""
from types import SimpleNamespace

import pytest

from perfbench import bench, tracing

CONFIG = {"n_points": 1000, "n_dims": 8, "k": 40, "n_groups": 4}
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 6.7e13}
NEW = ("engine.host_read_ms", "candidate_pass.host_ms",
       "move_and_bounds.host_ms", "kernels.launch_host_us",
       "device.idle_in_fit_share")
OLD = ("engine.host_syncs", "filter.evals_vs_lloyd",
       "candidate_pass.device_ms", "move_and_bounds.device_ms",
       "grouped_assign_roofline", "centroid_update_roofline",
       "device.idle_share")
# the spans this PR's program adds; the older ranges are the rest
ADDED = ("kpynq/fit", "kpynq/init", "kpynq/host_read", "kpynq/epilogue",
         "kpynq/grouped_assign", "kpynq/centroid_update")


def _range(name, ts, end):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": end - ts}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1.0, "args": {"correlation": corr}}


def _kernel(corr, name, ts, end):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
            "dur": end - ts, "args": {"correlation": corr}}


GA = "void (anonymous namespace)::ga_kernel<8>(float const*)"
CU_P = "void (anonymous namespace)::cu_partial<4>(float const*)"
CU_R = "void (anonymous namespace)::cu_reduce(float const*)"


def _events(with_spans=True, devices=True):
    """One fit in a window of 1000 us: an init, a pass and a move, the
    exit read, an epilogue; its kernels; then the driver's own copy."""
    ranges = [
        _range("kpynq/fit", 100, 900),
        _range("kpynq/init", 110, 200),
        _range("kpynq/centroid_update", 120, 130),
        _range("kpynq/host_read", 150, 160),
        _range("kpynq/candidate_pass", 200, 300),
        _range("kpynq/grouped_assign", 210, 230),
        _range("kpynq/move_and_bounds", 300, 400),
        _range("kpynq/centroid_update", 310, 314),
        _range("kpynq/host_read", 400, 450),
        _range("kpynq/epilogue", 450, 600),
        _range("kpynq/candidate_pass", 460, 500),
        _range("kpynq/grouped_assign", 465, 471),
    ]
    if not with_spans:
        ranges = [r for r in ranges if r["name"] not in ADDED]
    events = [_range(tracing.WINDOW, 0, 1000)] + ranges + [
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 401,
         "dur": 48},
        _launch(1, 220), _launch(2, 312), _launch(3, 313), _launch(4, 468),
        _launch(5, 920)]
    if devices:
        events += [
            _kernel(1, GA, 230, 330), _kernel(2, CU_P, 320, 370),
            _kernel(3, CU_R, 370, 380), _kernel(4, GA, 480, 520),
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
             "ts": 950, "dur": 30, "args": {"correlation": 5}}]
    return events


def _reading(events, window=None):
    if window is not None:
        events = [dict(e, ts=window[0], dur=window[1] - window[0])
                  if e["name"] == tracing.WINDOW else e for e in events]
    fit = SimpleNamespace(host_syncs=3, n_iters=1,
                          distance_evals=40 * 1000 + 5000)
    return bench.Reading(CONFIG, [fit], tracing.parse(events, calls=1),
                         [fit], PEAKS)


def _read(metric, reading):
    return bench.reader(metric)(reading)


def test_the_five_readers():
    r = _reading(_events())
    assert _read("engine.host_read_ms", r) == pytest.approx(0.060)
    assert _read("candidate_pass.host_ms", r) == pytest.approx(0.140)
    assert _read("move_and_bounds.host_ms", r) == pytest.approx(0.100)
    # spans of 20, 10, 4 and 6 us
    assert _read("kernels.launch_host_us", r) == pytest.approx(10.0)
    # 150 + 40 us busy of the fit's 800; the driver's copy is outside
    assert _read("device.idle_in_fit_share", r) == \
        pytest.approx(100 * (1 - 190 / 800))
    assert _read("device.idle_share", r) == \
        pytest.approx(100 * (1 - 220 / 1000))


def test_the_readers_clip_to_the_window():
    r = _reading(_events(), window=(0, 425))
    assert _read("engine.host_read_ms", r) == pytest.approx(0.035)
    assert _read("candidate_pass.host_ms", r) == pytest.approx(0.100)
    assert _read("device.idle_in_fit_share", r) == \
        pytest.approx(100 * (1 - 150 / 325))
    assert _read("kernels.launch_host_us", r) == pytest.approx(34 / 3)


def test_a_nested_range_of_one_name_counts_once():
    events = _events() + [_range("kpynq/host_read", 152, 158)]
    r = _reading(events)
    assert _read("engine.host_read_ms", r) == pytest.approx(0.060)


@pytest.mark.parametrize("metric", NEW)
def test_no_device_operation_reads_nothing(metric):
    r = _reading(_events(devices=False))
    assert _read(metric, r) is None
    assert _read(metric, bench.Reading(CONFIG, [], None, [], None)) is None


def test_no_span_reads_nothing():
    r = _reading(_events(with_spans=False))
    for metric in ("engine.host_read_ms", "kernels.launch_host_us",
                   "device.idle_in_fit_share"):
        assert _read(metric, r) is None


@pytest.mark.parametrize("metric", OLD)
def test_older_readers_read_the_same_with_the_new_spans(metric):
    with_spans = _read(metric, _reading(_events()))
    assert with_spans is not None
    assert with_spans == _read(metric, _reading(_events(with_spans=False)))
