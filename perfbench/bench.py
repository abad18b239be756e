"""The harness: one cell of ``BENCHMARK.json``, run and reported.

Everything that belongs to one cell is found by name: the configuration
file that ``BENCHMARK.json`` names, ``traffic/<mix>.json`` (the driver
in ``drivers/`` it names and the driver's parameters),
``limits/<cell>.json`` (the limit of each number the comparison reads)
and ``layers/<metric>.py`` for each per-layer metric (a ``read(run)``
that returns a number, or None where it finds nothing to read). Later
cells, mixes and metrics are new files and new entries, not edits.

A run: the card is looked for first (none, or fewer than the cell asks
for: exit 2, no result); the driver makes the inputs from the seed,
warms up, measures for ``--seconds`` and checks its answers; then the
modules loaded are looked at (JAX or the JAX package: exit 3, no
result); the checks go to standard error as the last lines, and one
JSON line to standard output.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
from dataclasses import dataclass
from pathlib import Path

from . import compare

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TUNE_CACHE_VAR = "REPRO_TORCH_KMEANS_TUNE_CACHE"


@dataclass
class Cell:
    """What a driver is given."""
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object          # torch.device
    started: float          # time.perf_counter() at the process's start


@dataclass
class Reading:
    """What a per-layer reader is given."""
    config: dict
    fits: list              # the driver's records, one a fit
    trace: object           # tracing.Trace or None
    traced: list            # the records of the fits inside the trace
    peaks: dict | None      # the card's row of peaks.json, or None


class NoCard(RuntimeError):
    pass


def spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _entry(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_files(sp: dict, name: str, root: Path = ROOT) -> dict:
    """The files of one cell, found by name."""
    wl = _entry(sp["workloads"], name, "workload")
    cfg = _entry(sp["configs"], wl["config"], "configuration")
    traffic = HERE / "traffic" / f"{wl['traffic']}.json"
    driver = json.loads(traffic.read_text())["driver"]
    layers = [HERE / "layers" / f"{m['name']}.py" for m in sp["per_layer"]
              if applies(m, name)]
    return {"config": root / cfg["file"], "traffic": traffic,
            "driver": HERE / "drivers" / f"{driver}.py",
            "limits": HERE / "limits" / f"{name}.json", "layers": layers}


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules of JAX or of the JAX package, by whole top-level
    name (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def reader(metric: str):
    path = HERE / "layers" / f"{metric}.py"
    spec_ = importlib.util.spec_from_file_location(
        f"perfbench.layers.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod.read


def load_driver(path: Path):
    """The driver module of a traffic mix, from its file."""
    spec_ = importlib.util.spec_from_file_location(
        f"perfbench.drivers.{path.stem}", path)
    driver = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(driver)
    return driver


def card(chips: int):
    """The first card, after checking there are ``chips`` of them."""
    import torch
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, "
                     f"{torch.cuda.device_count()} found")
    return torch.device("cuda", 0)


def peaks_for(kind: str) -> dict | None:
    return json.loads((HERE / "peaks.json").read_text())["cards"].get(kind)


def run_cell(name: str, *, seed: int, seconds: float, trace: bool,
             started: float, device=None, config_override: dict | None = None,
             limits_override: dict | None = None,
             root: Path = ROOT) -> tuple[dict, dict]:
    """Run one cell: ``(result line as a dict, with checks last; notes
    for standard error)``. ``device`` None looks for the card; a CPU
    device is a rehearsal, which reports no device metric (nor any
    time). The overrides replace entries of the configuration and of
    the limits, for rehearsals at other sizes or on other routes."""
    import torch
    sp = spec(root)
    wl = _entry(sp["workloads"], name, "workload")
    files = cell_files(sp, name, root)
    dev = card(wl["chips"]) if device is None else device
    rehearsal = dev.type != "cuda"
    cfg = {**json.loads(files["config"].read_text()),
           **(config_override or {})}
    driver = load_driver(files["driver"])
    cell = Cell(name, cfg, json.loads(files["traffic"].read_text()),
                {**json.loads(files["limits"].read_text()),
                 **(limits_override or {})}, seed, seconds,
                trace, dev, started)
    out = driver.run(cell)

    kind = "CPU rehearsal" if rehearsal else torch.cuda.get_device_name(dev)
    device_line = {"platform": "cpu" if rehearsal else "gpu", "kind": kind,
                   "count": 0 if rehearsal else wl["chips"],
                   "memory_peak_bytes": int(out["memory_peak_bytes"])}
    metrics = {}
    result = {"correct": out["failed"] == 0 and all(
        compare.passes(v, lim) for v, lim in out["checks"].values()),
        "attempted": out["attempted"], "failed": out["failed"],
        "metrics": metrics, "device": device_line}
    if not trace:
        if not rehearsal:
            for m in sp["end_to_end"]:
                if applies(m, name):
                    metrics[m["name"]] = {
                        "value": out["end_to_end"][m["name"]],
                        "unit": m["unit"]}
    else:
        tr = out["trace"]
        reading = Reading(cfg, out["fits"], tr, out["traced"],
                          None if rehearsal else peaks_for(kind))
        for m in sp["per_layer"]:
            if not applies(m, name):
                continue
            if rehearsal and m["source"] == "device_trace":
                continue
            value = reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if not rehearsal:
            device_line["busy_s"] = tr.busy_s()
            device_line["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out["checks"].items()}
    return result, {**out["notes"], "compiled": out["compiled"]}


def main(argv: list[str], started: float) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's tuning cache: a path under TMPDIR that holds nothing,
    # so the program's defaults run and no stored winner decides
    scratch = Path(tempfile.mkdtemp(prefix="perfbench-"))
    os.environ[TUNE_CACHE_VAR] = str(scratch / "tune_cache.json")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        result, notes = run_cell(args.workload, seed=args.seed,
                                 seconds=args.seconds,
                                 trace=bool(args.trace), started=started)
    except NoCard as exc:
        print(f"perfbench: no card to run on: {exc}", file=sys.stderr)
        return 2
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"perfbench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    checks = {k: (v["value"], v["limit"]) for k, v in result["checks"].items()}
    print(f"perfbench: {json.dumps(notes)}", file=sys.stderr)
    for line in compare.check_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
