"""The readings that the limits of ``limits/<cell>.json`` are set from,
on the card at the cell's own size (not part of a benchmark run).

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,... \
        [--restarts 1] [--control-seeds 3] [--fault-seeds 3] \
        [--refs float64,float32] [--out FILE]

For each seed it makes a data set of the cell's recipe from that seed
(a cloud of its own, wider than the runs, which all fit the cloud of
the traffic's ``data_seed`` in a frame of the run's seed), runs the
program's fit from ``--restarts`` initial centroids drawn from (seed,
restart) through the cell's driver's own call (``fit`` of
``drivers/<driver>.py``), and reads every number of
:mod:`perfbench.compare` against
the float64 reference. On the first ``--control-seeds`` seeds it reads
the same numbers of the control, the reference in TF32 put in the
program's place; on the first ``--fault-seeds`` seeds, those of the
program with each fault of :mod:`perfbench.faults` planted. A reference
in another precision (``--refs``) is also read as a witness beside the
program, and every fit is judged against each reference. One
JSON line a reading, then the largest reading of the program and the
smallest of the control for each number.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from perfbench import bench, compare, faults, generator, reference  # noqa


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--restarts", type=int, default=1)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=0)
    ap.add_argument("--refs", default="float64",
                    help="precisions of the references judged against")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    os.environ[bench.TUNE_CACHE_VAR] = str(
        Path(tempfile.mkdtemp(prefix="perfbench-")) / "tune_cache.json")
    sys.path.insert(0, str(bench.ROOT / "src"))
    import torch
    from repro_torch.core import engine

    sp = bench.spec()
    files = bench.cell_files(sp, args.workload)
    wl = bench._entry(sp["workloads"], args.workload, "workload")
    driver = bench.load_driver(files["driver"])
    dev = bench.card(wl["chips"])
    cfg = json.loads(files["config"].read_text())
    mix = json.loads(files["traffic"].read_text())["params"]
    n, d, k = cfg["n_points"], cfg["n_dims"], cfg["k"]
    out = open(args.out, "a") if args.out else None
    rows_seen: dict[str, dict[str, list]] = {}

    def emit(side, seed, restart, numbers, seconds):
        line = {"cell": args.workload, "side": side, "seed": seed,
                "restart": restart, "seconds": seconds, **numbers}
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        for name, value in numbers.items():
            rows_seen.setdefault(side, {}).setdefault(name, []).append(
                value)

    def judge(answer, refs):
        got = compare.readings(points, answer)
        for prec, ref in refs.items():
            tag = "" if prec == "float64" else f"@{prec}"
            got.update({f"{key}{tag}": value for key, value
                        in compare.against(ref, answer).items()})
        got["n_iters"] = answer.n_iters
        return got

    def program_answer():
        return driver.fit(engine, points, cfg, init, dev)[0]

    for i, seed in enumerate(seeds):
        points = generator.make_points(
            n, d, n_centres=max(1, round(mix["centres_per_k"] * k)),
            spread=mix["spread"], cluster_std=mix["cluster_std"],
            seed=seed, device=dev)
        for r in range(args.restarts):
            init = points[generator.initial_rows(n, k, seed=seed, restart=r,
                                                 device=dev)]
            t0 = time.perf_counter()
            ref = {prec: reference.fit(points, init,
                                       max_iters=cfg["max_iters"],
                                       tol=cfg["tol"], precision=prec)
                   for prec in args.refs.split(",")}
            t_ref = time.perf_counter() - t0
            emit("program", seed, r, judge(program_answer(), ref), t_ref)
            for prec, fit in ref.items():
                if prec != "float64":
                    emit(f"witness:{prec}", seed, r, judge(compare.Answer(
                        fit.centroids.cpu(), fit.labels.cpu(), fit.n_iters,
                        fit.inertia), ref), 0.0)
            if i < args.control_seeds:
                t0 = time.perf_counter()
                ctl = reference.fit(points, init, max_iters=cfg["max_iters"],
                                    tol=cfg["tol"], precision="tf32")
                answer = compare.Answer(ctl.centroids.cpu(), ctl.labels.cpu(),
                                        ctl.n_iters, ctl.inertia)
                emit("control", seed, r, judge(answer, ref),
                     time.perf_counter() - t0)
            if i < args.fault_seeds and r == 0:
                for name, plant in faults.FAULTS.items():
                    with plant():
                        answer = program_answer()
                    emit(f"fault:{name}", seed, r, judge(answer, ref), 0.0)
        del points
        torch.cuda.empty_cache()
    summary = {side: {name: (max if side == "program" else min)(vals)
                      for name, vals in by.items()}
               for side, by in rows_seen.items()}
    print(json.dumps({"summary": summary, "cell": args.workload}))
    if out:
        out.write(json.dumps({"summary": summary,
                              "cell": args.workload}) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
