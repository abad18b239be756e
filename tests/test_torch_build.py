"""The kernel build and the launch counters under threads, on the CPU.

The serving thread and the caller may touch a kernel first at the same
time: ``_build.load`` must run ``nvcc`` once, into a temporary named by
process and thread, and hand both threads the same library. A stub
``nvcc`` (a script that logs its call, waits and writes an empty file)
and a stub loader stand in for the toolkit, which this machine lacks.
"""
import os
import sys
import threading

from repro_torch.kernels import _build


def test_two_threads_build_a_kernel_once(tmp_path, monkeypatch):
    log = tmp_path / "nvcc.log"
    stub = tmp_path / "nvcc"
    stub.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        f"open({str(log)!r}, 'a').write(out + '\\n')\n"
        "time.sleep(0.5)\n"
        "open(out, 'w').close()\n")
    stub.chmod(0o755)
    opened = []

    class StubLib:
        def __init__(self, path):
            opened.append(path)
            self.grouped_assign_error_string = lambda rc: b""
            self.grouped_assign_points = lambda d, g: 8

    monkeypatch.setattr(_build, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_ENTRIES", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", StubLib)

    start = threading.Barrier(2)
    got = [None, None]

    def first_touch(i):
        start.wait()
        got[i] = _build.entry("grouped_assign", "grouped_assign_points",
                              [], None)

    threads = [threading.Thread(target=first_touch, args=(i,))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    builds = log.read_text().splitlines()
    assert len(builds) == 1, builds              # one nvcc, not two
    assert f".{os.getpid()}." in builds[0] and builds[0].endswith(".tmp")
    assert len(opened) == 1 and got[0] is got[1]
    assert _build.library_path("grouped_assign").exists()
    assert not list(_build.library_path("grouped_assign").parent.glob(
        "*.tmp"))


def test_launch_counts_stay_exact_across_threads():
    def wrapper():
        pass
    wrapper.launches = 0
    wrapper.launches_tc = 0

    def bump():
        for _ in range(20_000):
            _build.count_launch(wrapper)
            _build.count_launch(wrapper, "launches_tc")

    threads = [threading.Thread(target=bump) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrapper.launches == wrapper.launches_tc == 80_000
