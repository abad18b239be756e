"""The run as the driver sees it, rehearsed on the CPU in a process of
its own: the result line's keys, the look at the modules loaded, the
files a run leaves, and the refusals without a card or without the
program."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import bench

ROOT = bench.ROOT
SMALL = {"n_points": 8192, "k": 32, "n_groups": 3}
BASE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]

# runs bench.main with the card and the configuration's size swapped for
# the CPU and a small size, then reports what the process loaded
REHEARSAL = """
import json, sys, torch
sys.path[:0] = [{root!r}, {src!r}]
from perfbench import bench
bench.card = lambda chips: torch.device("cpu")
_files = bench.cell_files
def small(sp, name, root=bench.ROOT):
    files = _files(sp, name, root)
    cfg = json.loads(files["config"].read_text())
    cfg.update({small!r})
    path = bench.Path({tmp!r}) / "config.json"
    path.write_text(json.dumps(cfg))
    files["config"] = path
    return files
bench.cell_files = small
rc = bench.main({argv!r}, 0.0)
print("LOADED " + json.dumps(bench.forbidden_modules()))
sys.exit(rc)
"""


def _rehearse(tmp_path, cell, trace):
    work = tmp_path / "work"
    tmpdir = tmp_path / "tmpdir"
    work.mkdir()
    tmpdir.mkdir()
    code = REHEARSAL.format(root=str(ROOT), src=str(ROOT / "src"),
                            small=SMALL, tmp=str(work),
                            argv=["--workload", cell, "--seed",
                                  str(2 ** 40 + 3), "--seconds", "0.5",
                                  "--trace", str(trace)])
    env = dict(os.environ, TMPDIR=str(tmpdir), BENCH_RUN="ignored")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    return out, tmpdir


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_prints_the_contract_line(tmp_path, trace):
    out, tmpdir = _rehearse(tmp_path, "uci-xlarge.fit-blobs", trace)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "LOADED []"          # no jax, no repro
    result = json.loads(lines[-2])
    want = BASE_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == want
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    # a rehearsal reports no time and no device metric
    sources = {m["name"]: m["source"] for m in
               bench.spec()["per_layer"] + bench.spec()["end_to_end"]}
    assert all(sources[name] == "program_counter"
               for name in result["metrics"])
    assert bool(result["metrics"]) == bool(trace)
    for name, check in result["checks"].items():
        assert set(check) == {"value", "limit"}
    err = out.stderr.strip().splitlines()
    assert len(err) >= len(result["checks"])
    for line, name in zip(err[-len(result["checks"]):], result["checks"]):
        assert line.startswith(f"check {name}: ")
    if trace:
        for key in ("device_ops", "idle_gaps"):
            assert len(result["breakdown"][key]) <= 10
    # the tuning cache and the trace lived under TMPDIR and are gone
    assert [p.name for p in tmpdir.iterdir()
            if p.name.startswith("perfbench")] == []


def test_without_a_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "uci-xlarge.fit-blobs", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=str(ROOT), env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "no card" in out.stderr


def test_alone_the_benchmark_gives_no_result(tmp_path):
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", lone)
    shutil.copytree(ROOT / "perfbench", lone / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "uci-xlarge.fit-blobs", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=str(lone), capture_output=True, text=True,
        timeout=300, env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode != 0
    assert out.stdout == ""


def test_forbidden_modules_by_whole_top_level_name():
    names = ["repro_torch", "repro_torch.core", "jax.numpy", "repro",
             "repro.core.engine", "jaxlib", "flax.linen", "jaxtyping",
             "reprolib"]
    assert bench.forbidden_modules(names) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core.engine"]
