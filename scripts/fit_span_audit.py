"""Audit the program's spans in a traced run of one benchmark cell, on
the card, and the host cost of one span.

    python3 scripts/fit_span_audit.py --workload uci-xlarge.fit-blobs \
        --seed 9100000101 [--seconds 20] [--out chiprun_out/audit.json]

Runs the cell as ``perfbench/run.py --trace 1`` does, keeps its trace
and prints one JSON line:

* ``fit_self_share``: each traced ``kpynq/fit`` span's self time (its
  length less the union of the ``kpynq/*`` spans inside it) over its
  length, in %;
* ``launched_outside_fit``: the device operations launched in the
  window but outside every ``kpynq/fit`` span, by name and count (the
  driver's own copies and reads of a fit's answers);
* ``idle_gaps``: the window's longest idle gaps by what the host was
  doing (``Trace.breakdown``), ``idle_by_span``: all of them summed by
  the innermost ``kpynq/*`` span (``none`` outside every span), in ms,
  and ``metrics``: every per-layer reader's value;
* ``phase_us``: one ``phase`` enter and exit in us, with the profiler
  off and active, on the card (NVTX) and off it, beside a bare
  ``record_function`` range, each the mean of many.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import bench, spans, tracing  # noqa: E402

REPEAT = 20_000


def phase_us() -> dict:
    """Mean us of one enter and exit of ``phase`` (profiler off and
    active, ``on_card`` False and True) and of a bare
    ``record_function`` range."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.obs.trace import phase

    def mean_us(enter) -> float:
        t0 = time.perf_counter()
        for _ in range(REPEAT):
            with enter():
                pass
        return (time.perf_counter() - t0) / REPEAT * 1e6

    card = torch.cuda.is_available()
    cases = {"phase": lambda: phase("kpynq/probe", False),
             "record_function": lambda: record_function("kpynq/probe")}
    if card:
        cases["phase_on_card"] = lambda: phase("kpynq/probe", True)
    out = {f"{name}_off": mean_us(fn) for name, fn in cases.items()}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card
                                     else [])
    with profile(activities=acts):
        out.update({f"{name}_on": mean_us(fn) for name, fn in cases.items()})
    return out


def audit(tr: tracing.Trace) -> dict:
    fits = spans.clipped(tr, "kpynq/fit")
    inner = spans.union(
        s for name in tr.ranges if name.startswith("kpynq/")
        and name != "kpynq/fit" for s in spans.clipped(tr, name))
    selfs = []
    for fs, fe in fits:
        covered = sum(max(0.0, min(e, fe) - max(s, fs)) for s, e in inner)
        selfs.append(100.0 * (1.0 - covered / (fe - fs)))
    gaps = tr.breakdown(top=None)["idle_gaps"]
    by_span: dict[str, float] = {}
    for name, seconds in gaps:
        key = name.split(": ")[0] if name.startswith("kpynq/") else "none"
        by_span[key] = by_span.get(key, 0.0) + seconds * 1e3
    lo, hi = tr.window
    outside: dict[str, int] = {}
    for o in tr.ops:
        if o.launched is None or not lo <= o.launched <= hi:
            continue
        if not any(fs <= o.launched <= fe for fs, fe in fits):
            key = tracing.short_name(o.name)
            outside[key] = outside.get(key, 0) + 1
    return {"fits_ms": [(fe - fs) / 1e3 for fs, fe in fits],
            "fit_self_share": selfs,
            "launched_outside_fit": outside,
            "untied_ops": sum(o.launched is None for o in tr.ops),
            "window_ms": (hi - lo) / 1e3, "busy_ms": tr.busy_s() * 1e3,
            "idle_gaps": gaps[:12], "idle_by_span": by_span}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    kept = []
    profile = tracing.profile

    def keep(*a, **kw):
        tr = profile(*a, **kw)
        kept.append(tr)
        return tr

    tracing.profile = keep
    # as perfbench/run.py: an empty tuning cache, so the defaults run
    os.environ[bench.TUNE_CACHE_VAR] = os.path.join(
        tempfile.mkdtemp(prefix="span-audit-"), "tune_cache.json")
    result, _ = bench.run_cell(args.workload, seed=args.seed,
                               seconds=args.seconds, trace=True,
                               started=time.perf_counter())
    line = {"workload": args.workload, "seed": args.seed,
            "correct": result["correct"], "metrics": {
                k: v["value"] for k, v in result["metrics"].items()},
            **audit(kept[0]), "phase_us": phase_us()}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
