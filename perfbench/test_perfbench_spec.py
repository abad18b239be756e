"""``BENCHMARK.json`` against the benchmark's contract, and every cell's
files found by name."""
import importlib
import json
import re

import pytest

from perfbench import bench

SPEC = bench.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
ROOFLINE = re.compile(r"^(\w+)_roofline$")


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_text_ok(w) for w in SPEC["command"])
    named = [w for w in SPEC["command"] if "/" in w]
    assert all(any(w.startswith(p + "/") for p in SPEC["paths"])
               for w in named)
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51


def test_run_seconds_fits_a_full_check_of_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in SPEC[group]:
            assert NAME.match(item["name"]), item["name"]
            names.append((group, item["name"]))
    assert len(set(n for _, n in names)) == len(names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _text_ok(w["why"]) and w["chips"] in (1, 4)
    for c in SPEC["configs"]:
        assert _text_ok(c["source"]) and _text_ok(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in SPEC["per_layer"]:
        assert _text_ok(m["layer"])
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                           "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                           "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_bounds():
    by = {m["name"]: m for m in SPEC["end_to_end"]}
    assert by["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_every_config_used_and_its_file_under_paths():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        cfg = json.loads((bench.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_pairs_unique_and_four_chip_cells_rare():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    files = bench.cell_files(SPEC, cell)
    for key in ("config", "traffic", "driver", "limits"):
        assert files[key].is_file(), (cell, key)
    for path in files["layers"]:
        assert path.is_file(), path
    limits = json.loads(files["limits"].read_text())
    assert limits and all(isinstance(v, (int, float)) and v >= 0
                          for v in limits.values())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_it_must(cell):
    e2e = {m["name"] for m in SPEC["end_to_end"] if bench.applies(m, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = [m for m in SPEC["per_layer"] if bench.applies(m, cell)]
    assert layers
    for m in layers:
        assert m["moves"] in e2e, (cell, m["name"])


def test_every_per_layer_metric_has_a_reader():
    for m in SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]))
        hit = ROOFLINE.match(m["name"])
        if hit:
            assert m["unit"] == "%"
            mod = importlib.import_module(f"perfbench.rooflines.{hit[1]}")
            for attr in ("KERNELS", "LAUNCH", "RANGE", "launch_bytes"):
                assert hasattr(mod, attr)


def test_traffic_files_name_a_driver():
    for w in SPEC["workloads"]:
        t = json.loads((bench.HERE / "traffic" /
                        f"{w['traffic']}.json").read_text())
        assert (bench.HERE / "drivers" / f"{t['driver']}.py").is_file()
        assert isinstance(t["params"], dict)
