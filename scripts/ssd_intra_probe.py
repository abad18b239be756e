#!/usr/bin/env python3
"""Where ``ssd_intra``'s time goes at hymba-1.5b's prefill.

    python3 scripts/ssd_intra_probe.py [--out probe.json]

On one card, for the cells of the model's SSD launch at hymba-1.5b's
prefill (B = 2, S = 2048: 32 chunks x 25 heads, Q = 128, N = 16,
P = 128):

1. the kernel's device time (``torch.profiler``) against the number of
   cells, at 1 to 6 cells an SM and at 32 chunks of 8, 16, 24 and 25
   heads (the prefill's 800): the entry point's contiguous cells, where
   the cost of a last, partly filled wave of blocks shows, and the
   model's chunk launch, whose rows of x and y lie H x P floats apart;
2. the device time of copies of ``csrc/ssd_intra.cu`` with parts of the
   work taken out (the decay's exp, the scores' dot product, the product
   with x, the copies inside the j-loop, the stores), built beside the
   kernel and timed in turns with it; their outputs are wrong by design;
3. the wrapper's host time a call, and the kernel timed by CUDA events
   over 5 back-to-back calls (as ``chip_smoke.py`` times every kernel)
   and over 50.

Prints one JSON object. Needs a card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "ssd_intra_probe"

# (text in csrc/ssd_intra.cu, what replaces it): each takes one part out
CUTS = {
    "exp": ("sc[k][m] * expf(cum_i[li] - cum_j[lj])",
            "sc[k][m] * (cum_i[li] - cum_j[lj])"),
    "dot": ("for (int nn = 0; nn < n4; nn += 4) {",
            "for (int nn = 0; nn < 0; nn += 4) {"),
    "product": ("for (int jj = jlo; jj < jhi; jj += 2) {",
                "for (int jj = jlo; jj < jlo; jj += 2) {"),
    "loop_copies": ("if (jb + kStages - 1 < njb) load_jb(jb + kStages - 1);",
                    ""),
    # a store only where an accumulator holds one value: none, but the
    # compiler must still form them all
    "stores": ("if (row >= q || col >= p) continue;",
               "if (row >= q || col >= p || acc[k][4 * h] != 1.2345f) "
               "continue;"),
}
VARIANTS = {
    "kernel": (),
    "no_exp": ("exp",),
    "no_dot": ("dot",),
    "no_product": ("product",),
    "no_loop_copies": ("loop_copies",),
    "no_stores": ("stores",),
    "copies_and_stores_only": ("exp", "dot", "product"),
    "product_only": ("exp", "dot", "loop_copies", "stores"),
}


def build_variants(build) -> dict:
    src = (build.CSRC / "ssd_intra.cu").read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cuts in VARIANTS.items():
        text = src
        for cut in cuts:
            old, new = CUTS[cut]
            if text.count(old) != 1:
                sys.exit(f"ssd_intra_probe: {old!r} is not once in the "
                         f"kernel's source")
            text = text.replace(old, new)
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             str(OUT_DIR / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"ssd_intra_probe: nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT_DIR / f"lib{name}.so"))
        lib.ssd_intra_error_string.argtypes = [ctypes.c_int]
        lib.ssd_intra_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("ssd_intra_probe: needs a card")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def cells_of(g):
        c, b = randn(g, 128, 16), randn(g, 128, 16)
        cum = torch.cumsum(-torch.nn.functional.softplus(randn(g, 128)), 1)
        return c, b, randn(g, 128, 128), cum

    def dev_ms(fn):
        # the profiler now and then returns no kernel at all: ask again
        for _ in range(3):
            ms = sum(cs.device_ms_by_kernel(fn, calls=20).values())
            if ms > 0:
                return ms
        return None

    report = {"card": cs.nvidia_smi_line()}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    heads = (8, 16, 24, 25)
    waves = {}
    for g in sorted({sms * k for k in range(1, 7)} | {32 * h for h in heads}):
        t = cells_of(g)
        waves[g] = dev_ms(lambda: kernels.ssd_intra(*t))
        del t
    report["ms_by_cells"] = waves
    chunked = {}
    for h in heads:
        t = (randn(2, 16, 128, 1, 16), randn(2, 16, 128, 1, 16),
             randn(2, 16, 128, h, 128),
             torch.cumsum(-torch.nn.functional.softplus(
                 randn(2, 16, 128, h)), 2))
        chunked[32 * h] = dev_ms(lambda: kernels.ssd_intra_chunks(*t))
        del t
    report["ms_by_cells_chunk_launch"] = chunked

    # the model's launch at the prefill: (b, nc, Q, G, N), (b, nc, Q, H, P)
    C, B = randn(2, 16, 128, 1, 16), randn(2, 16, 128, 1, 16)
    x = randn(2, 16, 128, 25, 128)
    cum = torch.cumsum(-torch.nn.functional.softplus(randn(2, 16, 128, 25)),
                       2)

    def call():
        return kernels.ssd_intra_chunks(C, B, x, cum)

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    report["host_us_a_call"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    report["events_ms"] = {"5 calls": cs.median_ms(call),
                           "50 calls": cs.median_ms(call, inner=50)}
    report["device_ms"] = dev_ms(call)

    # the port's own build beside the copies, the same source rebuilt
    kept = _build.load("ssd_intra")
    libs = {"built by _build": kept, **build_variants(_build)}
    turns = {name: [] for name in libs}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            _build._LIBS["ssd_intra"] = libs[name]
            turns[name].append(dev_ms(call))
    _build._LIBS["ssd_intra"] = kept
    report["device_ms_in_turns"] = turns
    line = json.dumps(report)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
