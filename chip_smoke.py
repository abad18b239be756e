#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out report.json]

Phases, each of which fails the run (non-zero exit) on any fault, in
the order they run:

1. build every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc``, one
   compiler process per source, all at once; log ``-Xptxas -v``
   (registers, shared memory, spills) of every kernel in full (all six
   have been redesigned for this card), and count the ``HGMMA``
   instructions in the built ``flash_attention`` library
   (``cuobjdump -sass``; none where ``cuobjdump`` exists fails the run);
2. ``grouped_assign`` and ``centroid_update`` against their plain
   versions on the card at the main path's shapes, uci-highk's group
   shape, Hamerly at D = 128, K = 1024, and a ragged N at mask
   densities 0, 0.3 and 1; ``grouped_assign`` also at a group a
   centroid, with -1 slots inside the rows (Hamerly too) and at tiles of
   32 and 1024 points, and in every case bit for bit against the port's
   first kernel (``grouped_assign_simple``) on the same inputs; times of
   the kernel, the plain version and the library call, beside the least
   time the card could take; ``grouped_assign`` at uci-xlarge timed in
   turns against the first kernel (first, kernel, kernel, first),
   ``centroid_update`` in turns (plain, ``index_add_``, kernel, kernel,
   ``index_add_``, plain) and its two passes apart under
   ``torch.profiler``;
2b. ``pairwise_sq_dists`` (uci-xlarge in fp32 and bf16, a ragged
   N = 100,003, D = 33, K = 77; D = 200 and an x at a 4-byte offset,
   which the entry point sends to the first kernel, its route checked)
   and ``filtered_assign`` (uci-highk and uci-xlarge, tiles 256x128,
   64x16 and 64x8, mask densities 0, 0.35 and 1; the ragged input at
   tiles 16x128 and 4x8, fewer points per tile than a block of the new
   kernel owns) against their plain versions: minima within rtol 1e-5 (atol 1e-5 of
   the norms), argmin ids equal but at fp32 ties, which are counted;
   in every case (and in 4b and 4c) each kernel bit for bit
   (``torch.equal``) against the port's first kernel on the same inputs
   (``pairwise_sq_dists_simple``, ``filtered_assign_simple``), the
   variant each launch took logged (every ``filtered_assign`` case
   takes the new kernel, which refuses what it cannot take); ties on
   the card at those tiles (a duplicate centroid in a later live block
   loses to the lower index; with the lower one's block dead the
   duplicate wins and the dead one never enters); the uci-highk cases
   with every block live, and uci-xlarge in both dtypes, timed in turns
   against the first kernel (first, new, new, first: ``earlier_ms``),
   and beside ``pairwise_sq_dists``'s bytes bound a write floor, the
   time of ``fill_`` on an output of the same size;
3. the main path at the paper suite's ``uci-xlarge`` problem
   (N = 2^20, D = 32, K = 256, G = 25): ``KMeans(algorithm="yinyang",
   engine="auto").fit`` and ``predict`` on the same points, with every
   kernel's launch count reset just before and read just after; then
   the same fit with ``grouped_assign`` swapped for the port's first
   kernel, which must give the same labels, ``n_iters`` and
   ``distance_evals``; the block-skip kernels must not launch there;
4. the same fit with every kernel swapped for its plain PyTorch version,
   on the card: in lockstep pass by pass, then as whole fits (``n_iters``
   equal, inertia within rtol 1e-5);
4b. ``filtered_assign`` on the block masks that fit really makes
   (``build_block_mask`` of the pass's group filter at iteration 5, at
   the last pass, and at iteration 5 of a Hamerly fit), at the three
   tile pairs, against its plain version;
4c. the block-skip entry point as a user calls it
   (``repro_torch.kernels.pairwise_sq_dists`` and
   ``filtered_assign_auto`` on the fitted uci-xlarge state), counts
   reset just before and read just after, each kernel timed at those
   inputs in turns against its first kernel;
5. determinism: two kernel fits bit-identical, and weights of 1.0
   bit-identical to no weights;
6. a small fit on the card against the same fit on the CPU;
8. ``engine.fit(..., backend="compact")`` at uci-xlarge, counts reset
   and read around it: ``n_iters`` and inertia (rtol 1e-5) as the
   kernel backend's;
9. a converging fit, uci-wide (N = 32,768, D = 128, K = 64): the
   ``kernel``, ``compact`` and ``oracle`` backends give the same
   ``n_iters`` and the same labels but at fp32 ties;
7. one kernel fit under ``torch.profiler``: device busy time by kernel
   and the device's idle share;
2c. ``flash_attention`` and ``ssd_intra`` against their plain versions
   (after phase 7, so the LM's allocations follow the k-means ones): the
   entry points at the reference's contract and at hymba-1.5b's heads,
   the model's attention launch at hymba-1.5b's prefill (B = 2,
   S = 2048, 25/5 heads of 64, bf16), at a ragged S and in fp32, the
   model's SSD launch at hymba-1.5b's prefill and mamba2-780m's cell
   (Q = 128, N = 128, P = 64), also with decays that overflow above the
   diagonal, and both cells at Q = 100; the SSD kernel keeps at least 16
   warps resident an SM at both cells' widths (the CUDA occupancy
   calculator); the path's shapes timed by CUDA events, as every
   kernel (``ssd_intra`` also by its device time under
   ``torch.profiler``, ``device_ms``), beside the bound and, for
   attention, ``scaled_dot_product_attention``; attention in bf16 at
   head dims 64 and 128 takes the tensor-core kernel, fp32 the FFMA one
   (each case checks which launch counter moved), the prefill's shape
   in both dtypes; the tensor-core kernel timed in turns against the
   FFMA kernel on the same bf16 inputs (FFMA, tensor cores, tensor
   cores, FFMA);
10. hymba-1.5b serving at full width and depth (32 layers, d_model
   1600, bf16 weights from a seeded generator on the card): 2 prompts
   of 2048 tokens through ``make_prefill_step``, then 32 greedy decode
   steps through ``make_serve_step``, counts reset just before and read
   just after (32 launches of each LM kernel, all 32 attention launches
   on the tensor cores and none on FFMA); the same prefill with
   both LM kernels swapped for their plain versions, and the first
   decode step against a prefill of one more token: in bf16 each within
   3e-2 of the logits' max abs, or within 1.5 times the farthest that
   two other correct attentions (PyTorch's SDPA, and one in float64)
   land from the plain route, whichever is larger (over 32 random bf16
   layers any two correct attentions part by about 3e-2); with the
   same weights in fp32 each within 1e-4; prefill and decode times,
   tokens/s, peak memory, one traced prefill and one traced decode
   step.

The last lines are a ``kernels`` JSON line, the card's name and power
limit from ``nvidia-smi``, and ``{"ok": true, "device": {...}}``. The
script exits non-zero, printing no result, where CUDA is missing or the
port's sources are not beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# uci-xlarge and uci-wide of the paper suite (repro/configs/kpynq.py),
# copied
XLARGE = dict(n=1 << 20, d=32, k=256, max_iters=50, tol=1e-4)
WIDE = dict(n=32_768, d=128, k=64, max_iters=50, tol=1e-4)
# the LM serving path: hymba-1.5b at full width and depth, 2 prompts
SERVE = dict(arch="hymba-1.5b", batch=2, prompt=2048, steps=32)
# device peaks by card name: (bytes/s, fp32 FLOP/s without tensor
# cores, dense bf16 tensor-core FLOP/s), from NVIDIA's data sheets; SXM
# figures unless the name says otherwise
PEAKS = {"H100 PCIe": (2.0e12, 51.2e12, 756e12),
         "H100 NVL": (3.9e12, 60.0e12, 835e12),
         "H200": (4.8e12, 67.0e12, 989e12),
         "H100": (3.35e12, 67.0e12, 989e12)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0 and out.stdout.strip() != "",
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def hgmma_count(lib: Path):
    """``HGMMA`` instructions (Hopper's warpgroup products) in a built
    library's SASS; fails the run if there are none. Returns None, and
    says so, where the toolkit has no ``cuobjdump``."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        log("sass: no cuobjdump on this machine; HGMMA not counted")
        return None
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {lib.name} failed: "
          f"{out.stderr.strip()[:500]}")
    count = sum("HGMMA" in line for line in out.stdout.splitlines())
    log(f"sass: {count} HGMMA instructions in {lib.name}")
    check(count > 0, f"no HGMMA instruction in {lib.name}: the tensor-core "
          f"attention kernel did not compile to wgmma")
    return count


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    fail(f"no peak figures for card {name!r}")


def sync() -> None:
    import torch
    torch.cuda.synchronize()


def median_ms(fn, reps: int = 7, inner: int = 5) -> float:
    """Median over ``reps`` CUDA-event timings, after a warm-up call, of
    ``inner`` back-to-back calls each (per call): back to back, the
    host's launch work overlaps the previous call's device time."""
    import torch
    fn()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def device_ms_by_kernel(fn, calls: int = 10) -> dict:
    """Device ms a call of each kernel ``fn`` launches, over ``calls``
    calls under ``torch.profiler`` (after one warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync()
    return {ev.key: ev.self_device_time_total / 1e3 / calls
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total}


def roof(nbytes: float, flops: float, bw: float, peak: float):
    """(least ms, "bytes" or "operations"): the larger of the two."""
    t_b, t_f = nbytes / bw * 1e3, flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def kernel_module(name: str):
    return importlib.import_module(f"repro_torch.kernels.{name}")


# a wrapper's own count, and for flash_attention each kernel's as well
ROUTE_COUNTS = {"launches_tc": "tc", "launches_ffma": "ffma"}


def reset_launches(wrappers) -> None:
    for fn in wrappers.values():
        fn.launches = 0
        for attr in ROUTE_COUNTS:
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def read_launches(wrappers) -> dict:
    """``{name: launches}``, and ``{"name.tc": ..., "name.ffma": ...}``
    for a wrapper with one counter per kernel."""
    counts = {}
    for nm, fn in wrappers.items():
        counts[nm] = fn.launches
        for attr, route in ROUTE_COUNTS.items():
            if hasattr(fn, attr):
                counts[f"{nm}.{route}"] = getattr(fn, attr)
    return counts


@contextlib.contextmanager
def lm_route(attention, ssd_chunks):
    """Swap the model's two LM kernel launches (attention, SSD) in the
    package, where the model looks them up."""
    import repro_torch.kernels as kernels
    saved = kernels.flash_attention_gqa, kernels.ssd_intra_chunks
    kernels.flash_attention_gqa, kernels.ssd_intra_chunks = attention, \
        ssd_chunks
    try:
        yield
    finally:
        kernels.flash_attention_gqa, kernels.ssd_intra_chunks = saved


def plain_route():
    fla, ssd = kernel_module("flash_attention"), kernel_module("ssd_intra")
    return lm_route(fla.flash_attention_gqa_plain, ssd.ssd_intra_chunks_plain)


def sdpa_gqa(q, k, v):
    """PyTorch's causal attention in the model's (B, S, H, D) layout: a
    yardstick of what another correct attention gives, never the
    port's."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True).transpose(1, 2)


def exact_gqa(q, k, v):
    """Causal attention in float64, rounded once to q's dtype: the most
    exact correct attention, a yardstick like :func:`sdpa_gqa`."""
    import torch
    rep = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).double()
    kh, vh = (t.transpose(1, 2).repeat_interleave(rep, 1).double()
              for t in (k, v))
    s = q.shape[1]
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    sc = (qh @ kh.transpose(-1, -2) / math.sqrt(q.shape[-1])).masked_fill(
        ~causal, -math.inf)
    return (torch.softmax(sc, -1) @ vh).transpose(1, 2).to(q.dtype)


def lm_kernel_phase(dev, gen, bw, fp32, bf16, cfg, batch, prompt):
    """Phase 2c: the LM kernels against their plain versions, at the
    shapes ``cfg`` gives them for ``batch`` prompts of ``prompt``
    tokens. Returns the timed entries of the serving path's shapes
    (attention, SSD)."""
    import torch
    import torch.nn.functional as F

    import repro_torch.kernels as kernels
    from repro_torch.configs import get_config
    fla, ssd = kernel_module("flash_attention"), kernel_module("ssd_intra")

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def routes():
        return (kernels.flash_attention.launches_tc,
                kernels.flash_attention.launches_ffma)

    def attn_case(label, q, k, v, entry_point=False, timed=False):
        route = fla.route_for(q.dtype, q.shape[-1])
        before = routes()
        if entry_point:
            got = kernels.flash_attention(q, k, v)
            want = fla.flash_attention_plain(q, k, v)
        else:
            got = kernels.flash_attention_gqa(q, k, v)
            want = fla.flash_attention_gqa_plain(q, k, v)
        sync()
        moved = tuple(a - b for a, b in zip(routes(), before))
        check(moved == ((1, 0) if route == "tc" else (0, 1)),
              f"flash_attention {label}: launches on (tensor cores, FFMA) "
              f"moved by {moved}, not once on {route}")
        # fp32: summation order; bf16: one rounding of the same result
        tol = 1e-5 if q.dtype == torch.float32 else 3e-2
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape
              and bool((diff <= tol + tol * want.float().abs()).all()),
              f"flash_attention {label}: differs from the plain version "
              f"by {err:.3g} (rtol = atol = {tol})")
        entry = dict(case=label, q=list(q.shape), kv=list(k.shape),
                     dtype=str(q.dtype), route=route, max_abs_err=err,
                     tol=tol)
        if route == "tc":
            # and row by row, where 3e-2 of an element can hide a fault
            rows = fla.row_rel_err(got, want)
            check(rows <= fla.ROW_REL_TOL,
                  f"flash_attention {label}: a row differs from the plain "
                  f"version by {rows:.3g} of its norm (bound "
                  f"{fla.ROW_REL_TOL})")
            entry.update(row_rel_err=rows, row_tol=fla.ROW_REL_TOL)
        del got, diff
        if timed:
            b, s, h, d = q.shape
            kvh = k.shape[2]
            nbytes = q.element_size() * (2 * b * s * h * d + 2 * b * s * kvh * d)
            # QK^T and P.V over the causal half: s(s+1)/2 pairs a head
            flops = 4.0 * d * b * h * s * (s + 1) / 2
            peak = fp32 if q.dtype == torch.float32 else bf16
            bound_ms, by = roof(nbytes, flops, bw, peak)
            lib = sdpa_gqa(q, k, v)
            entry["library_vs_plain_max_abs"] = float(
                (lib.float() - want.float()).abs().max())
            del lib

            def new():
                return kernels.flash_attention_gqa(q, k, v)
            turns = {"new": []}
            if route == "tc":
                # the earlier route, the FFMA kernel, on the same inputs
                def old():
                    return fla.launch_gqa(q, k, v, "ffma")
                ffma = old()
                sync()
                off = (ffma.float() - want.float()).abs()
                entry["ffma_max_abs_err"] = float(off.max())
                check(bool((off <= tol + tol * want.float().abs()).all()),
                      f"flash_attention {label}: the FFMA kernel differs "
                      f"from the plain version")
                del ffma, off
                turns["ffma"] = [median_ms(old)]
                turns["new"] += [median_ms(new), median_ms(new)]
                turns["ffma"].append(median_ms(old))
                entry["ffma_ms"] = statistics.mean(turns["ffma"])
            else:
                turns["new"].append(median_ms(new))
            entry.update(
                ms=statistics.mean(turns["new"]), turns_ms=turns,
                plain_ms=median_ms(
                    lambda: fla.flash_attention_gqa_plain(q, k, v), reps=3,
                    inner=1),
                bound_ms=bound_ms, bound_by=by,
                library_ms=median_ms(lambda: sdpa_gqa(q, k, v)))
        del want
        log(f"flash_attention {label}: {json.dumps(entry)}")
        return entry

    def ssd_case(label, args, chunks=False, timed=False):
        fn = kernels.ssd_intra_chunks if chunks else kernels.ssd_intra
        plain = ssd.ssd_intra_chunks_plain if chunks else ssd.ssd_intra_plain
        got, want = fn(*args), plain(*args)
        # the sum of |terms| bounds what fp32 rounding can move
        abs_sum = plain(*(a.abs() if i < 3 else a for i, a in
                          enumerate(args)))
        sync()
        diff = (got - want).abs()
        err = float(diff.max())
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape
              and bool((diff <= 1e-5 * (1.0 + abs_sum)).all()),
              f"ssd_intra {label}: differs from the plain version by "
              f"{err:.3g} (1e-5 of the sum of |terms|)")
        entry = dict(case=label, shapes=[list(a.shape) for a in args],
                     max_abs_err=err)
        del got, want, diff, abs_sum
        if timed:
            x = args[2]         # (G, Q, P), or (b, nc, Q, H, P)
            q, p = x.shape[2 if chunks else 1], x.shape[-1]
            n = args[0].shape[-1]
            cells = x.numel() // (q * p)
            nbytes = 4 * sum(a.numel() for a in args) + 4 * x.numel()
            flops = cells * q * (q + 1) / 2 * 2.0 * (n + p)
            bound_ms, by = roof(nbytes, flops, bw, fp32)
            # ms by events, as every row of the kernels line; beside it
            # the kernel's own device time under the profiler, which
            # leaves out the host's work before the first call of a timing
            entry.update(ms=median_ms(lambda: fn(*args)),
                         device_ms=device_ms_by_kernel(lambda: fn(*args)),
                         plain_ms=median_ms(lambda: plain(*args), reps=3,
                                            inner=1),
                         bound_ms=bound_ms, bound_by=by, library_ms=None)
        log(f"ssd_intra {label}: {json.dumps(entry)}")
        return entry

    def cum_of(shape, axis, steep=False):
        step = F.softplus(randn(*shape))
        if steep:       # exp(cum_i - cum_j) above the diagonal overflows
            step = step * 40 + 5
        return torch.cumsum(-step, dim=axis)

    b, s = batch, prompt
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bf = torch.bfloat16
    # the entry point, (B, H, S, D) at the reference's contract
    attn_case(f"entry point ({b}, {h}, {s}, {d}) bf16",
              *(randn(b, h, s, d, dtype=bf) for _ in range(3)),
              entry_point=True)
    attn_case("entry point (2, 3, 128, 32) fp32",
              *(randn(2, 3, 128, 32) for _ in range(3)), entry_point=True)
    # the model's launch: the prefill's shape (timed), ragged S, fp32
    q = randn(b, s, h, d, dtype=bf)
    kv = [randn(b, s, kvh, d, dtype=bf) for _ in range(2)]
    attn_main = attn_case(f"{cfg.name} prefill B={b} S={s}", q, *kv,
                          timed=True)
    # the same shape in fp32: the FFMA kernel, the strict parity route
    attn_case(f"{cfg.name} prefill B={b} S={s} fp32",
              *(t.float() for t in (q, *kv)))
    del q, kv
    attn_case(f"ragged S={s + 1} bf16",
              randn(b, s + 1, h, d, dtype=bf),
              *(randn(b, s + 1, kvh, d, dtype=bf) for _ in range(2)))
    attn_case("ragged S=1000 fp32, 28/4 heads of 128",
              randn(1, 1000, 28, 128), randn(1, 1000, 4, 128),
              randn(1, 1000, 4, 128))

    m = cfg.ssm
    nc = s // m.chunk
    ssd_main = ssd_case(
        f"{cfg.name} prefill B={b} S={s} (chunk launch)",
        [randn(b, nc, m.chunk, m.n_groups, m.d_state) for _ in range(2)]
        + [randn(b, nc, m.chunk, m.n_heads, m.head_dim),
           cum_of((b, nc, m.chunk, m.n_heads), 2)], chunks=True, timed=True)
    m2 = get_config("mamba2-780m").ssm
    cells = b * nc * m2.n_heads
    ssd_case("mamba2-780m cells (entry point, timed)",
             [randn(cells, m2.chunk, m2.d_state) for _ in range(2)]
             + [randn(cells, m2.chunk, m2.head_dim),
                cum_of((cells, m2.chunk), 1)], timed=True)
    ssd_case("steep decays, Q=256 N=33 P=100",
             [randn(64, 256, 33) for _ in range(2)]
             + [randn(64, 256, 100), cum_of((64, 256), 1, steep=True)])
    # a Q the kernel's 32-row blocks do not divide, at both cells' widths
    ssd_case(f"{cfg.name} cells Q=100 (chunk launch)",
             [randn(b, 4, 100, m.n_groups, m.d_state) for _ in range(2)]
             + [randn(b, 4, 100, m.n_heads, m.head_dim),
                cum_of((b, 4, 100, m.n_heads), 2)], chunks=True)
    ssd_case("mamba2-780m cells Q=100 (entry point)",
             [randn(256, 100, m2.d_state) for _ in range(2)]
             + [randn(256, 100, m2.head_dim), cum_of((256, 100), 1)])
    # at least 16 warps an SM stay resident at both cells' widths
    for nn_, pp_ in ((m.d_state, m.head_dim), (m2.d_state, m2.head_dim)):
        warps = ssd.resident_warps(nn_, pp_)
        log(f"ssd_intra N={nn_} P={pp_}: {warps} warps resident an SM")
        check(warps >= 16, f"ssd_intra N={nn_} P={pp_}: {warps} warps "
              f"resident an SM, fewer than 16")
    return attn_main, ssd_main


def serve_phase(dev, gen, wrappers, cfg, batch, prompt, steps):
    """Phase 10: the LM serving path of ``cfg``: ``batch`` prompts of
    ``prompt`` tokens, then ``steps`` greedy decode steps. Returns the
    report, with the launches of the main path (prefill + decode)."""
    import torch

    from repro_torch.models import init_params
    from repro_torch.train import make_prefill_step, make_serve_step

    b, s = batch, prompt
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device=dev)
    sync()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"serve: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, ssm d_inner "
        f"{cfg.ssm.d_inner}), {n_params} params, {n_bytes / 2**30:.3f} GiB "
        f"in {cfg.dtype}, made in {time.perf_counter() - t0:.2f} s")
    prefill = make_prefill_step(cfg)
    serve_step = make_serve_step(cfg)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)

    def greedy(logits):
        return logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)

    # the main path: one prefill, then greedy decode steps
    reset_launches(wrappers)
    torch.cuda.reset_peak_memory_stats(dev)
    sync()
    t0 = time.perf_counter()
    logits, pcache = prefill(params, {"tokens": tokens})
    # one position more than the path uses, for the traced step below
    cache = decode_cache(cfg, pcache, s + steps + 1, dev)
    del pcache
    tok = greedy(logits)
    first_tok = tok
    step_ms = []
    for t in range(steps):
        sync()
        t1 = time.perf_counter()
        dlogits, cache = serve_step(params, cache, tok, s + t)
        tok = greedy(dlogits)
        sync()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if t == 0:
            first_dec = dlogits
    path_s = time.perf_counter() - t0
    launches = read_launches(wrappers)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"serve: main path (prefill + {steps} decode steps) "
        f"{path_s:.3f} s; launches {launches}; peak memory "
        f"{peak_gib:.3f} GiB")
    check(tuple(logits.shape) == (b, 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all())
          and bool(torch.isfinite(dlogits).all()),
          "serve: non-finite or misshapen logits")
    for nm in ("flash_attention", "ssd_intra"):
        check(launches[nm] == cfg.n_layers,
              f"serve: {nm} launched {launches[nm]} times on the main path, "
              f"not once per layer ({cfg.n_layers})")
    # bf16 at a head dim of 64: every attention launch on the tensor cores
    check(launches["flash_attention.tc"] == cfg.n_layers
          and launches["flash_attention.ffma"] == 0,
          f"serve: attention ran {launches['flash_attention.tc']} times on "
          f"the tensor cores and {launches['flash_attention.ffma']} on FFMA, "
          f"not {cfg.n_layers} and 0")
    for nm, cnt in launches.items():
        if nm.split(".")[0] not in ("flash_attention", "ssd_intra"):
            check(cnt == 0, f"serve: {nm} launched on the LM path")

    # prefill time: median of 3 after the main path's warm-up call
    pre_ms = []
    for _ in range(3):
        sync()
        t1 = time.perf_counter()
        again, _c = prefill(params, {"tokens": tokens})
        sync()
        pre_ms.append((time.perf_counter() - t1) * 1e3)
        del _c
    check(torch.equal(again, logits), "serve: a repeat prefill differs")

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    # The served dtype, bf16: over 32 layers of random weights the bf16
    # roundings of any two correct attentions part the logits by about
    # 3e-2 of scale (scripts/lm_bf16_floor.py), so the bound is 3e-2 or
    # 1.5 times the farthest that two other correct attentions, PyTorch's
    # SDPA and one in float64, land from the plain route on the same
    # prompts, whichever is larger
    ssd_plain = kernel_module("ssd_intra").ssd_intra_chunks_plain
    with plain_route():
        plain_logits, _c = prefill(params, {"tokens": tokens})
        del _c
    floors = {}
    for nm, attention in (("sdpa", sdpa_gqa), ("float64", exact_gqa)):
        with lm_route(attention, ssd_plain):
            other, _c = prefill(params, {"tokens": tokens})
        floors[nm] = rel(other, plain_logits)
        del _c, other
    plain_err = rel(logits, plain_logits)
    floor = max(floors.values())
    # decode continuation: position s decoded from the cache against the
    # last position of a prefill of s + 1 tokens
    longer, _c = prefill(params, {"tokens": torch.cat([tokens, first_tok],
                                                      1)})
    cont_err = rel(first_dec, longer)
    del _c, longer
    bound = max(1.5 * floor, 3e-2)
    log(f"serve bf16: kernel vs plain prefill logits {plain_err:.4g} of "
        f"scale; SDPA vs plain {floors['sdpa']:.4g}, float64 attention vs "
        f"plain {floors['float64']:.4g}; decode continuation "
        f"{cont_err:.4g}; bound {bound:.4g}")
    check(plain_err <= bound, f"serve: bf16 kernel prefill is "
          f"{plain_err:.3g} of scale from the plain one, beyond {bound:.3g}")
    check(cont_err <= bound, f"serve: bf16 decode continuation "
          f"{cont_err:.3g} of scale, beyond {bound:.3g}")
    del plain_logits

    # the same weights widened to fp32: kernel against plain prefill and
    # the decode continuation, each within 1e-4 of scale
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _widen(params)
    prefill32 = make_prefill_step(cfg32)
    lg32, pc32 = prefill32(params32, {"tokens": tokens})
    with plain_route():
        plain32, _c = prefill32(params32, {"tokens": tokens})
        del _c
    plain_err32 = rel(lg32, plain32)
    cache32 = decode_cache(cfg32, pc32, s + 1, dev)
    del pc32
    tok32 = greedy(lg32)
    dec32, _c = make_serve_step(cfg32)(params32, cache32, tok32, s)
    del _c, cache32
    longer32, _c = prefill32(params32, {"tokens": torch.cat([tokens, tok32],
                                                            1)})
    del _c
    cont_err32 = rel(dec32, longer32)
    log(f"serve fp32: kernel vs plain prefill logits {plain_err32:.4g} of "
        f"scale; decode continuation {cont_err32:.4g}")
    check(plain_err32 <= 1e-4, f"serve: fp32 kernel and plain prefill "
          f"logits differ by {plain_err32:.3g} of scale > 1e-4")
    check(cont_err32 <= 1e-4, f"serve: fp32 decode continuation "
          f"{cont_err32:.3g} of scale > 1e-4")
    del params32, lg32, plain32, dec32, longer32
    prefill_ms = statistics.median(pre_ms)
    decode_ms = statistics.median(step_ms[1:])
    rep = dict(arch=cfg.name, batch=b, prompt=s, steps=steps,
               params=n_params, param_gib=n_bytes / 2**30,
               launches=launches, main_path_s=path_s,
               prefill_ms=pre_ms, prefill_ms_median=prefill_ms,
               prefill_tokens_per_s=b * s / (prefill_ms / 1e3),
               decode_step_ms=step_ms, decode_ms_per_step_median=decode_ms,
               decode_tokens_per_s=b / (decode_ms / 1e3),
               peak_gib=peak_gib, plain_logits_err=plain_err,
               other_attention_logits_err=floors, bf16_bound=bound,
               continuation_err=cont_err,
               plain_logits_err_fp32=plain_err32,
               continuation_err_fp32=cont_err32)
    log(f"serve: prefill {prefill_ms:.2f} ms median of {pre_ms} "
        f"({rep['prefill_tokens_per_s']:.4g} tokens/s); decode "
        f"{decode_ms:.3f} ms per step median ({rep['decode_tokens_per_s']:.4g}"
        f" tokens/s, first step {step_ms[0]:.2f} ms)")
    rep["trace"] = traced(lambda: prefill(params, {"tokens": tokens}),
                          "traced prefill")
    rep["trace_decode"] = traced(
        lambda: serve_step(params, cache, tok, s + steps),
        "traced decode step")
    return rep


def decode_cache(cfg, pcache, max_len, dev):
    """A decode cache of ``max_len`` positions holding a prefill's."""
    from repro_torch.models import init_cache
    some = next(iter(pcache.values()))
    cache = init_cache(cfg, some.shape[1], max_len, device=dev)
    for k_, v_ in pcache.items():
        if k_ in ("k", "v"):
            cache[k_][:, :, :v_.shape[2]] = v_
        else:
            cache[k_].copy_(v_)
    return cache


def _widen(tree):
    return {k: _widen(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# the port's own kernels (csrc/*.cu's __global__ functions), as the
# profiler names them
PORT_KERNEL = re.compile(r"^(void )?(\(anonymous namespace\)|tc|simt)::"
                         r"(ga|ga_plan|ga_simple|cu_partial|cu_reduce|psd|fa|"
                         r"fa_tc|ssd)(_kernel)?[<(]")


def traced(fn, label):
    """Run ``fn`` once under ``torch.profiler``: wall ms, device busy ms,
    the ten kernels with the most device time, and every kernel of the
    port's (``port``), in the top ten or not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms, calls = {}, {}
    for ev in prof.key_averages():
        # device-side events only: a CPU op's entry repeats the time of
        # the kernels it launched
        if ev.device_type != DeviceType.CUDA:
            continue
        t_us = ev.self_device_time_total
        if t_us > 0:
            dev_ms[ev.key] = dev_ms.get(ev.key, 0.0) + t_us / 1e3
            calls[ev.key] = calls.get(ev.key, 0) + ev.count
    busy_ms = sum(dev_ms.values())
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:10]
    if busy_ms > 0:
        log(f"{label}: {wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms, "
            f"idle share {1 - busy_ms / wall_ms:.3f}")
        for key, ms in top:
            log(f"  {ms:9.3f} ms  {calls[key]:6d} calls  {key[:90]}")
    else:
        log(f"{label}: the profiler saw no device time (not measured)")
    port = sorted((kv for kv in dev_ms.items() if PORT_KERNEL.match(kv[0])),
                  key=lambda kv: -kv[1])
    for key, ms in port:
        log(f"  port: {ms:9.3f} ms  {calls[key]:6d} calls  {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                top=[[k_, v_, calls[k_]] for k_, v_ in top],
                port=[[k_, v_, calls[k_]] for k_, v_ in port])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))

    import repro_torch.kernels as kernels
    from repro_torch.core import engine
    from repro_torch.core.api import KMeans
    from repro_torch.core.kmeans import group_centroids
    from repro_torch.data import make_points
    from repro_torch.kernels import _build

    # the package exports each wrapper under its kernel's name; the
    # modules, with the plain versions, come from importlib
    cu_mod = kernel_module("centroid_update")
    ga_mod = kernel_module("grouped_assign")
    psd_mod = kernel_module("distance")
    fa_mod = kernel_module("filtered_assign")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    bw, fp32, bf16 = peaks(name)
    report = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; peaks used for bounds: "
        f"{bw / 1e12:.2f} TB/s, {fp32 / 1e12:.1f} TFLOP/s fp32, "
        f"{bf16 / 1e12:.0f} TFLOP/s bf16")

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    report["build_s"] = build_s
    log(f"build: {len(logs)} sources in {build_s:.2f} s")
    for src, text in logs.items():
        # in full: every kernel has been redesigned for this card
        for line in text.splitlines():
            if "Compile time" not in line:
                log(f"  ptxas {src}: {line.strip()}")
    report["hgmma"] = hgmma_count(_build.library_path("flash_attention"))

    wrappers = {"grouped_assign": kernels.grouped_assign,
                "centroid_update": kernels.centroid_update,
                "pairwise_sq_dists": kernels.pairwise_sq_dists,
                "filtered_assign": kernels.filtered_assign,
                # each counts both its wrappers' launches (the entry
                # point's and the model's)
                "flash_attention": kernels.flash_attention,
                "ssd_intra": kernels.ssd_intra}

    @contextlib.contextmanager
    def plain_versions():
        # the port calls its kernels through the package, so one swap
        # there reaches every caller
        kernels.grouped_assign = ga_mod.grouped_assign_plain
        kernels.centroid_update = cu_mod.centroid_update_plain
        try:
            yield
        finally:
            kernels.grouped_assign = wrappers["grouped_assign"]
            kernels.centroid_update = wrappers["centroid_update"]

    # -- the problem: uci-xlarge ------------------------------------------
    n, d, k = XLARGE["n"], XLARGE["d"], XLARGE["k"]
    t0 = time.perf_counter()
    pts_np, centers_np, blob_np = make_points(n, d, k, seed=0)
    points = torch.from_numpy(pts_np).to(dev)
    sync()
    log(f"data: uci-xlarge N={n} D={d} K={k}, "
        f"{points.numel() * 4 / 2**20:.0f} MiB on the card, made in "
        f"{time.perf_counter() - t0:.2f} s")

    # -- 2. kernels against their plain versions -----------------------------
    def cuda_ms(fn, reps=10):
        fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        sync()
        return start.elapsed_time(stop) / reps

    def bound(nbytes, flops, peak=None):
        return roof(nbytes, flops, bw, peak or fp32)

    gen = torch.Generator(device=dev).manual_seed(7)

    def spread(members):
        """The membership table with each group's ids spread over a row
        3 slots wider, -1 between and around them: -1 inside rows."""
        g_, lm = members.shape
        keys = torch.rand((g_, lm + 3), generator=gen, device=dev)
        wide = torch.full((g_, lm + 3), -1, dtype=torch.int32, device=dev)
        for gg in range(g_):
            ids_ = members[gg][members[gg] >= 0]
            at = keys[gg].argsort()[:len(ids_)].sort().values
            wide[gg, at] = ids_
        return wide

    def ga_case(label, x, centroids, n_groups, density, timed=False,
                tile_n=256, layout="tail"):
        """The kernel against its plain version and, bit for bit,
        against the port's first kernel on the same inputs. ``layout``:
        "tail" as the engine builds the table, "one" a group a centroid,
        "holes" -1 slots inside the rows (``spread``)."""
        cents = centroids.contiguous()
        if layout == "one":
            kk = cents.shape[0]
            members = torch.arange(kk, dtype=torch.int32,
                                   device=dev)[:, None].contiguous()
            gsize = torch.ones(kk, dtype=torch.int64, device=dev)
        else:
            groups, members, gsize = engine.build_assign_tables(cents,
                                                                n_groups)
            if layout == "holes":
                members = spread(members)
        g, lmax = members.shape
        mem_s = members.clamp_min(0).long()
        c_grouped = cents[mem_s].contiguous()
        c2 = (cents * cents).sum(-1)
        c2g = c2[mem_s].contiguous()
        x2 = (x * x).sum(-1)
        gn = -(-x.shape[0] // tile_n)
        mask = (torch.rand((gn, g), generator=gen, device=dev)
                < density).contiguous()
        args = (x, c_grouped, members, mask)
        kw = dict(tile_n=tile_n, x2=x2, c2g=c2g)
        got = kernels.grouped_assign(*args, **kw)
        want = ga_mod.grouped_assign_plain(*args, **kw)
        first = ga_mod.grouped_assign_simple(*args, **kw)
        sync()
        for nm_, a, b in zip(("best", "idx", "gmin", "garg", "gmin2"), got,
                             first):
            check(torch.equal(a, b), f"{label}: {nm_} differs from the "
                  f"first kernel's (grouped_assign_simple) bits")
        del first
        # the expanded form loses bits to cancellation against the norms
        atol = 1e-5 * (float(x2.max()) + float(c2.max()))
        err = 0.0
        for nm_, a, b in zip(("best", "gmin", "gmin2"),
                             (got[0], got[2], got[4]),
                             (want[0], want[2], want[4])):
            fa, fb = torch.isfinite(a), torch.isfinite(b)
            check(torch.equal(fa, fb), f"{label}: {nm_} inf pattern differs")
            if bool(fa.any()):
                err = max(err, float((a[fa] - b[fb]).abs().max()))
        check(err <= atol, f"{label}: float outputs differ by {err:.3g} > "
              f"atol {atol:.3g}")
        ties = 0
        for nm_, ia, ib, va in (("idx", got[1], want[1], want[0]),
                                ("garg", got[3], want[3], want[2])):
            bad = ia != ib
            nbad = int(bad.sum())
            if nbad:
                # a differing id is allowed only at a tie: both ids'
                # exact distances within atol of the reported minimum
                rows = bad.nonzero()[:, 0].long()
                xa = x[rows].double()
                for ids_ in (ia[bad], ib[bad]):
                    check(bool((ids_ >= 0).all()), f"{label}: {nm_} -1 "
                          f"where the plain version found a centroid")
                    dd = ((xa - cents[ids_.long()].double()) ** 2).sum(-1)
                    check(bool(((dd - va[bad].double()).abs()
                                <= 2 * atol).all()),
                          f"{label}: {nm_} differs off a tie")
            ties += nbad
        live = mask.long().repeat_interleave(tile_n, 0)[:x.shape[0]]
        pairs = int((live * gsize[None, :]).sum())
        entry = dict(case=label, n=x.shape[0], d=x.shape[1],
                     k=cents.shape[0], g=g, lmax=lmax, tile_n=tile_n,
                     layout=layout, density=density, max_abs_err=err,
                     atol=atol, tie_diffs=ties, equals_first_kernel=True)
        if timed:
            n_, d_ = x.shape
            nbytes = 4 * (n_ * d_ + n_ + g * lmax * (d_ + 2)) + gn * g \
                + 8 * n_ + 12 * n_ * g
            bound_ms, by = bound(nbytes, 2.0 * d_ * pairs)

            def new():
                return kernels.grouped_assign(*args, **kw)

            def old():
                return ga_mod.grouped_assign_simple(*args, **kw)
            # in turns: the first kernel, the new one, the new, the first
            turns = {"earlier": [cuda_ms(old)]}
            turns["new"] = [cuda_ms(new), cuda_ms(new)]
            turns["earlier"].append(cuda_ms(old))
            entry.update(ms=statistics.mean(turns["new"]),
                         earlier_ms=statistics.mean(turns["earlier"]),
                         turns_ms=turns,
                         plain_ms=cuda_ms(
                             lambda: ga_mod.grouped_assign_plain(*args,
                                                                 **kw),
                             reps=3),
                         bound_ms=bound_ms, bound_by=by, library_ms=None,
                         device_ms=device_ms_by_kernel(new))
        log(f"grouped_assign {label}: {json.dumps(entry)}")
        return entry

    def cu_case(label, x, labels, kk, weights=None, timed=False):
        got = kernels.centroid_update(x, labels, kk, weights)
        want = cu_mod.centroid_update_plain(x, labels, kk, weights)
        absx = cu_mod.centroid_update_plain(x.abs(), labels, kk,
                                            None if weights is None
                                            else weights.abs())[0]
        sync()
        err = float((got[0] - want[0]).abs().max())
        # fp32 sums in two orders: each within N*eps of the abs-sum
        tol = (1e-5 * absx + 1e-6)
        check(bool(((got[0] - want[0]).abs() <= tol).all()),
              f"{label}: sums differ beyond 1e-5 of the abs-sum")
        if weights is None:
            check(torch.equal(got[1], want[1]), f"{label}: counts differ")
        else:
            check(bool(torch.allclose(got[1], want[1], rtol=1e-5)),
                  f"{label}: weighted counts differ beyond rtol 1e-5")
        err = max(err, float((got[1] - want[1]).abs().max()))
        entry = dict(case=label, n=x.shape[0], d=x.shape[1], k=kk,
                     weighted=weights is not None, max_abs_err=err)
        if timed:
            n_, d_ = x.shape
            nbytes = 4 * (n_ * d_ + n_ + kk * d_ + kk) \
                + (4 * n_ if weights is not None else 0)
            bound_ms, by = bound(nbytes, float(n_ * d_ + n_))
            lab64 = labels.long()

            def new():
                return kernels.centroid_update(x, labels, kk, weights)

            def plain():
                return cu_mod.centroid_update_plain(x, labels, kk, weights)

            def library():
                return torch.zeros((kk, d_), device=dev).index_add_(
                    0, lab64, x)
            # in turns: the earlier routes around the kernel
            turns = {"plain": [cuda_ms(plain)], "library": [cuda_ms(library)],
                     "new": [cuda_ms(new), cuda_ms(new)]}
            turns["library"].append(cuda_ms(library))
            turns["plain"].append(cuda_ms(plain))
            entry.update(
                ms=statistics.mean(turns["new"]),
                plain_ms=statistics.mean(turns["plain"]),
                bound_ms=bound_ms, bound_by=by,
                library_ms=statistics.mean(turns["library"]),
                turns_ms=turns, passes_ms=device_ms_by_kernel(new),
                plan=dataclasses.asdict(cu_mod.plan(n_, d_, kk)))
        log(f"centroid_update {label}: {json.dumps(entry)}")
        return entry

    # uci-xlarge: the blob centres as centroids, the true blob labels
    centers = torch.from_numpy(centers_np).to(dev)
    blob = torch.from_numpy(blob_np.astype(np.int32)).to(dev)
    ga_main = ga_case("uci-xlarge all live", points, centers, 25, 1.0,
                      timed=True)
    ga_case("uci-xlarge density 0.3", points, centers, 25, 0.3, timed=True)
    cu_main = cu_case("uci-xlarge", points, blob, k, timed=True)
    cu_case("uci-xlarge weighted", points, blob, k,
            torch.rand(n, generator=gen, device=dev))

    hk_np, hk_c, _ = make_points(262_144, 32, 1024, seed=1)
    hk = torch.from_numpy(hk_np).to(dev)
    hk_cent = hk[:: 262_144 // 1024][:1024].contiguous()
    for dens in (1.0, 0.3):
        ga_case(f"uci-highk K=1024 G=102 density {dens}", hk, hk_cent, 102,
                dens)
    hk_lab = torch.randint(-1, 1024, (262_144,), generator=gen, device=dev,
                           dtype=torch.int32)
    cu_case("uci-highk K=1024 with -1 labels", hk, hk_lab, 1024)

    hm_np, _, _ = make_points(65_536, 128, 1024, seed=2)
    hm = torch.from_numpy(hm_np).to(dev)
    ga_case("hamerly D=128 K=1024 G=1", hm, hm[::64][:1024].contiguous(),
            1, 1.0)
    # groups wider than a batch of staged slots, with -1 inside them
    ga_case("hamerly D=128 K=1024 G=1, -1 inside", hm,
            hm[::64][:1024].contiguous(), 1, 1.0, layout="holes")
    # a group a centroid, -1 inside the rows, and tiles of 32 and 1024
    # points, at uci-xlarge's data and centres
    for dens in (0.0, 0.3, 1.0):
        ga_case(f"uci-xlarge a group a centroid density {dens}", points,
                centers, k, dens, layout="one")
        ga_case(f"uci-xlarge -1 inside rows density {dens}", points,
                centers, 25, dens, layout="holes")
    for tn in (32, 1024):
        ga_case(f"uci-xlarge tile_n={tn} density 0.3", points, centers, 25,
                0.3, tile_n=tn)
    hm_lab = torch.randint(0, 1024, (65_536,), generator=gen, device=dev,
                           dtype=torch.int32)
    cu_case("D=128 K=1024", hm, hm_lab, 1024)

    rg_np, _, _ = make_points(100_003, 33, 77, seed=4)
    rg = torch.from_numpy(rg_np).to(dev)
    rg_cent = rg[:77].contiguous()
    for dens in (0.0, 0.3, 1.0):
        ga_case(f"ragged N=100003 D=33 K=77 G=7 density {dens}", rg, rg_cent,
                7, dens)
    rg_lab = torch.randint(-1, 77, (100_003,), generator=gen, device=dev,
                           dtype=torch.int32)
    cu_case("ragged N=100003 D=33 K=77 weighted, -1 labels", rg, rg_lab, 77,
            torch.rand(100_003, generator=gen, device=dev))

    # -- 2b. the block-skip entry point's kernels ------------------------
    def norm_atol(x, c):
        # the expanded form loses bits to cancellation against the norms
        xf, cf = x.float(), c.float()
        return 1e-5 * (float((xf * xf).sum(1).max())
                       + float((cf * cf).sum(1).max()))

    def tie_rows(label, x, c, ia, ib, atol):
        """Rows whose argmin ids differ; fails unless both ids are real
        and their exact squared distances lie within fp32 rounding of
        each other (2 * atol). Returns the count."""
        bad = (ia != ib).nonzero()[:, 0]
        if len(bad) == 0:
            return 0
        check(bool((ia[bad] >= 0).all() and (ib[bad] >= 0).all()),
              f"{label}: an argmin is -1 where the other found a centroid")
        xa = x[bad].double()
        da = ((xa - c[ia[bad].long()].double()) ** 2).sum(-1)
        db = ((xa - c[ib[bad].long()].double()) ** 2).sum(-1)
        check(bool(((da - db).abs() <= 2 * atol).all()),
              f"{label}: argmin differs off a tie")
        return len(bad)

    def psd_case(label, x, c, timed=False, first_route=False):
        """The kernel against its plain version and, bit for bit, against
        the port's first kernel (``pairwise_sq_dists_simple``);
        ``first_route``: the input is one the launch sends to the first
        kernel (a wide D, an x not on 16 bytes), else the new kernel."""
        n_, d_ = x.shape
        k_ = c.shape[0]
        cols = psd_mod.slice_cols(k_, d_, x.dtype)
        aligned = x.data_ptr() % 16 == 0
        check((cols == 0 or not aligned) == first_route,
              f"{label}: slice_cols {cols}, x on 16 bytes {aligned}: "
              f"{'not ' if first_route else ''}the new kernel's input")
        got = kernels.pairwise_sq_dists(x, c)
        first = psd_mod.pairwise_sq_dists_simple(x, c)
        sync()
        check(torch.equal(got, first), f"{label}: distances differ from the "
              f"first kernel's (pairwise_sq_dists_simple) bits")
        del first
        want = psd_mod.pairwise_sq_dists_plain(x, c)
        sync()
        atol = norm_atol(x, c)
        diff = (got - want).abs()
        err = float(diff.max())
        check(tuple(got.shape) == tuple(want.shape)
              and bool((got >= 0).all()), f"{label}: bad shape or sign")
        check(bool((diff <= 1e-5 * want.abs() + atol).all()),
              f"{label}: distances differ beyond rtol 1e-5, atol {atol:.3g}")
        ties = tie_rows(label, x, c, got.argmin(1), want.argmin(1), atol)
        entry = dict(case=label, n=n_, d=d_, k=k_, dtype=str(x.dtype),
                     slice_cols=cols, x_on_16_bytes=aligned,
                     kernel="first" if first_route else "new",
                     max_abs_err=err, atol=atol, argmin_tie_rows=ties,
                     equals_first_kernel=True)
        del got, want, diff
        if timed:
            es = x.element_size()
            nbytes = es * (n_ * d_ + k_ * d_) + 4 * n_ * k_
            flops = 2.0 * n_ * k_ * d_ + 2.0 * (n_ + k_) * d_
            peak = fp32 if x.dtype == torch.float32 else bf16
            bound_ms, by = bound(nbytes, flops, peak)

            def new():
                return kernels.pairwise_sq_dists(x, c)

            def old():
                return psd_mod.pairwise_sq_dists_simple(x, c)
            # in turns: the first kernel, the new one, the new, the first
            turns = {"earlier": [cuda_ms(old)]}
            turns["new"] = [cuda_ms(new), cuda_ms(new)]
            turns["earlier"].append(cuda_ms(old))
            # what the memory system gives for a write of the same size:
            # the floor under the data sheet's bound, no yardstick
            sink = torch.empty((n_, k_), dtype=torch.float32, device=dev)
            floor_ms = cuda_ms(lambda: sink.fill_(0.0))
            del sink
            entry.update(
                ms=statistics.mean(turns["new"]),
                earlier_ms=statistics.mean(turns["earlier"]), turns_ms=turns,
                plain_ms=cuda_ms(
                    lambda: psd_mod.pairwise_sq_dists_plain(x, c), reps=3),
                bound_ms=bound_ms, bound_by=by, write_floor_ms=floor_ms,
                # returns the square root; fp32 inputs only
                library_ms=cuda_ms(lambda: torch.cdist(
                    x, c, compute_mode="use_mm_for_euclid_dist"))
                if x.dtype == torch.float32 else None)
        log(f"pairwise_sq_dists {label}: {json.dumps(entry)}")
        return entry

    def fa_case(label, x, c, mask, tile_n, tile_k, x2=None, c2=None,
                timed=False):
        """The kernel against its plain version and, bit for bit, against
        the port's first kernel (``filtered_assign_simple``); the variant
        the launch took is logged, and every case must take the new
        kernel."""
        kw = dict(tile_n=tile_n, tile_k=tile_k, x2=x2, c2=c2)
        n_, d_ = x.shape
        k_ = c.shape[0]
        points, stages = fa_mod.variant(d_, k_, tile_n, tile_k)
        check(points > 0, f"{label}: no variant of the kernel takes "
              f"tiles {tile_n}x{tile_k} at D = {d_}")
        got = kernels.filtered_assign(x, c, mask, **kw)
        first = fa_mod.filtered_assign_simple(x, c, mask, **kw)
        want = fa_mod.filtered_assign_plain(x, c, mask, **kw)
        sync()
        check(torch.equal(got[0], first[0]) and torch.equal(got[1], first[1]),
              f"{label}: (best, idx) differ from the first kernel's "
              f"(filtered_assign_simple) bits")
        fin = torch.isfinite(want[0])
        check(torch.equal(torch.isfinite(got[0]), fin)
              and torch.equal(got[1] == -1, ~fin),
              f"{label}: inf / -1 pattern differs")
        atol = norm_atol(x, c)
        err = 0.0
        if bool(fin.any()):
            diff = (got[0][fin] - want[0][fin]).abs()
            err = float(diff.max())
            check(bool((diff <= 1e-5 * want[0][fin].abs() + atol).all()),
                  f"{label}: minima differ beyond rtol 1e-5, "
                  f"atol {atol:.3g}")
        ties = tie_rows(label, x, c, got[1], want[1], atol)
        gn, gk = mask.shape
        rows = torch.full((gn,), tile_n, device=dev)
        rows[-1] = n_ - (gn - 1) * tile_n
        cols = torch.full((gk,), tile_k, device=dev)
        cols[-1] = k_ - (gk - 1) * tile_k
        pairs = int((mask.long() * rows[:, None] * cols[None, :]).sum())
        entry = dict(case=label, n=n_, d=d_, k=k_, tile_n=tile_n,
                     tile_k=tile_k, variant=dict(points=points, stages=stages),
                     density=float(mask.float().mean()), live_pairs=pairs,
                     max_abs_err=err, atol=atol, argmin_tie_rows=ties,
                     equals_first_kernel=True)
        if timed:
            nbytes = 4 * (n_ * d_ + n_ + k_ * d_ + k_) + gn * gk + 8 * n_
            bound_ms, by = bound(nbytes, 2.0 * d_ * pairs)

            def new():
                return kernels.filtered_assign(x, c, mask, **kw)

            def old():
                return fa_mod.filtered_assign_simple(x, c, mask, **kw)
            # in turns: the first kernel, the new one, the new, the first
            turns = {"earlier": [cuda_ms(old)]}
            turns["new"] = [cuda_ms(new), cuda_ms(new)]
            turns["earlier"].append(cuda_ms(old))
            entry.update(
                ms=statistics.mean(turns["new"]),
                earlier_ms=statistics.mean(turns["earlier"]), turns_ms=turns,
                plain_ms=cuda_ms(lambda: fa_mod.filtered_assign_plain(
                    x, c, mask, **kw), reps=3),
                bound_ms=bound_ms, bound_by=by, library_ms=None)
        log(f"filtered_assign {label}: {json.dumps(entry)}")
        return entry

    def fa_ties():
        """Ties on the card at the reference's tile pairs: a duplicate of
        centroid 3 at 200, in a later live block, never wins (the lower
        index does); with 3's block dead, 200 wins and 3 never enters."""
        cents = hk_cent[:256].clone()
        cents[200] = cents[3]
        near = (cents[3] + 1e-3 * torch.randn(
            (8192, cents.shape[1]), generator=gen, device=dev)).contiguous()
        for tn, tk in tiles:
            mask = torch.ones((-(-8192 // tn), -(-256 // tk)),
                              dtype=torch.bool, device=dev)
            for dead in (False, True):
                if dead:
                    mask[:, 3 // tk] = False
                kw = dict(tile_n=tn, tile_k=tk)
                got = kernels.filtered_assign(near, cents, mask, **kw)
                first = fa_mod.filtered_assign_simple(near, cents, mask, **kw)
                want = fa_mod.filtered_assign_plain(near, cents, mask, **kw)
                sync()
                win, lose = (200, 3) if dead else (3, 200)
                label = (f"ties {tn}x{tk}, "
                         f"{'dead' if dead else 'live'} block of 3")
                check(torch.equal(got[1], first[1])
                      and torch.equal(got[0], first[0]),
                      f"{label}: differs from the first kernel's bits")
                check(torch.equal(got[1], want[1]),
                      f"{label}: ids differ from the plain version's")
                won = int((got[1] == win).sum())
                check(won > 4000 and not bool((got[1] == lose).any()),
                      f"{label}: {won} rows to {win}, "
                      f"{int((got[1] == lose).sum())} to {lose}")
                log(f"filtered_assign {label}: {won} of 8192 rows to {win}, "
                    f"none to {lose}, as the first kernel and the plain "
                    f"version")

    def rand_mask(nn, kk, tile_n, tile_k, density):
        return (torch.rand((-(-nn // tile_n), -(-kk // tile_k)),
                           generator=gen, device=dev) < density)

    # the tile pairs the reference's filter study sweeps
    # (benchmarks/filter_efficiency.py)
    tiles = ((256, 128), (64, 16), (64, 8))
    psd_case("uci-xlarge, blob centres", points, centers, timed=True)
    psd_case("uci-xlarge bf16", points.bfloat16(), centers.bfloat16(),
             timed=True)
    psd_case("ragged N=100003 D=33 K=77", rg, rg_cent)
    wide = torch.randn((20_000, 200), generator=gen, device=dev)
    psd_case("wide D=200 (the first kernel's route)", wide, wide[:256] + 0.5,
             first_route=True)
    off = torch.randn((20_000 * 32 + 1,), generator=gen, device=dev)
    psd_case("x at a 4-byte offset (the first kernel's route)",
             off[1:].view(20_000, 32), centers, first_route=True)
    del wide, off
    for tn, tk in tiles:
        for dens in (0.0, 0.35, 1.0):
            # timed where the bound is set: uci-highk, every block live
            fa_case(f"uci-highk {tn}x{tk} density {dens}", hk, hk_cent,
                    rand_mask(262_144, 1024, tn, tk, dens), tn, tk,
                    timed=dens == 1.0)
            fa_case(f"uci-xlarge {tn}x{tk} density {dens}", points, centers,
                    rand_mask(n, k, tn, tk, dens), tn, tk)
    fa_ties()
    # tiles of fewer points than a block of the new kernel owns
    for tn, tk in ((16, 128), (4, 8)):
        for dens in (0.35, 1.0):
            fa_case(f"ragged {tn}x{tk} density {dens}", rg, rg_cent,
                    rand_mask(rg.shape[0], rg_cent.shape[0], tn, tk, dens),
                    tn, tk)

    # -- 3. the main path ------------------------------------------------
    km = KMeans(k, algorithm="yinyang", engine="auto",
                max_iters=XLARGE["max_iters"], tol=XLARGE["tol"], seed=0,
                device=dev)
    reset_launches(wrappers)
    sync()
    t0 = time.perf_counter()
    km.fit(points)
    sync()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = km.predict(points)
    sync()
    predict_s = time.perf_counter() - t0
    launches = read_launches(wrappers)

    res, stats = km.result_, km.stats_
    n_iters = int(res.n_iters)
    evals = int(res.distance_evals)
    work = evals / (n * k * n_iters)
    log(f"fit: backend={stats.backend} {fit_s:.3f} s, n_iters={n_iters}, "
        f"distance_evals={evals}, work vs Lloyd's N*K*iters={work:.4f} "
        f"({1 / work:.2f}x fewer), host_syncs={stats.host_syncs}, "
        f"inertia={float(res.inertia):.6g}")
    log(f"predict: {predict_s:.3f} s, {n / predict_s:.4g} points/s")
    log(f"launches on the main path: {launches}")
    check(stats.backend == "kernel", f"auto resolved to {stats.backend}")
    for nm in ("grouped_assign", "centroid_update"):
        check(launches[nm] >= n_iters, f"{nm} launched {launches[nm]} "
              f"times on the main path, fewer than n_iters={n_iters}")
    for nm in ("pairwise_sq_dists", "filtered_assign"):
        check(launches[nm] == 0, f"{nm} launched {launches[nm]} times on "
              f"the main path, which runs the kernel backend only")
    c_fit = res.centroids
    check(tuple(c_fit.shape) == (k, d) and bool(torch.isfinite(c_fit).all())
          and math.isfinite(float(res.inertia)),
          "fit produced non-finite or misshapen centroids/inertia")
    check(pred.shape == (n,) and pred.min() >= 0 and pred.max() < k,
          "predict labels out of range")
    fit_labels = res.assignments.cpu().numpy()
    mism = np.nonzero(pred != fit_labels)[0]
    if len(mism):
        # allowed only where the two centroids tie to fp32 rounding
        x64 = pts_np[mism].astype(np.float64)
        c64 = c_fit.cpu().numpy().astype(np.float64)
        da = np.linalg.norm(x64 - c64[pred[mism]], axis=1)
        db = np.linalg.norm(x64 - c64[fit_labels[mism]], axis=1)
        check(np.all(np.abs(da - db) <= 1e-4 * np.maximum(da, 1.0)),
              f"predict disagrees with fit labels on {len(mism)} points "
              f"that are not ties")
    log(f"predict vs fit labels: {len(mism)} differ (ties only)")
    # the same fit through the port's first grouped_assign kernel: the
    # kernel gives that one's bits, so the fit must be the same to the
    # label, iteration and pair
    km_first = KMeans(k, algorithm="yinyang", engine="auto",
                      max_iters=XLARGE["max_iters"], tol=XLARGE["tol"],
                      seed=0, device=dev)
    kernels.grouped_assign = ga_mod.grouped_assign_simple
    try:
        sync()
        t0 = time.perf_counter()
        km_first.fit(points)
        sync()
        first_fit_s = time.perf_counter() - t0
    finally:
        kernels.grouped_assign = wrappers["grouped_assign"]
    r_first = km_first.result_
    log(f"fit through the first grouped_assign kernel: {first_fit_s:.3f} s, "
        f"n_iters={int(r_first.n_iters)}, distance_evals="
        f"{int(r_first.distance_evals)}")
    check(torch.equal(r_first.assignments, res.assignments)
          and int(r_first.n_iters) == n_iters
          and int(r_first.distance_evals) == evals,
          "the fit through the first grouped_assign kernel differs from the "
          "main path's in labels, n_iters or distance_evals")
    report["main"] = dict(fit_s=fit_s, predict_s=predict_s, n_iters=n_iters,
                          distance_evals=evals, work_vs_lloyd=work,
                          host_syncs=stats.host_syncs,
                          inertia=float(res.inertia), launches=launches,
                          predict_points_per_s=n / predict_s,
                          first_kernel_fit_s=first_fit_s)

    # -- 4. plain versions on the card: in lockstep, then a whole fit -----
    # In lockstep every pass runs twice on the same carry, once through
    # the kernels and once through their plain versions, and the fit
    # advances on the kernels' result. Two whole fits cannot be held to
    # each other label for label: the fit stops at max_iters before it
    # converges, and one summation order against another moves a
    # centroid by an ulp, flips a boundary point and sets the two
    # trajectories apart (ROADMAP, Queue 3).
    init = km._init_centroids(points)
    n_groups = max(k // 10, 1)
    groups = group_centroids(init, n_groups)
    members, gsize = engine.build_group_tables(groups.cpu().numpy(),
                                               n_groups, dev)
    core = engine.PassCore(backend="kernel", k=k, n_groups=n_groups)
    body = engine._loop_body(core, points, None, groups, members, gsize)
    cond = engine._loop_cond(max_iters=XLARGE["max_iters"],
                             tol=XLARGE["tol"])
    carry = engine._init_carry(points, init, groups, n_groups=n_groups)
    x64 = points.double()
    x2max = float(carry.x2.max())
    lock = dict(passes=0, label_ties=0, lb_flips=0, centroid_err=0.0,
                pairs=0)

    def compare_pass(c):
        args = (points, c.centroids, c.assignments, c.ub, c.lb, c.need,
                groups, members, gsize)
        out_k = core.candidate_pass(*args, x2=c.x2, c2=c.c2)
        # squared distances in the expanded form are good to about 1e-5
        # of the norms they are computed from
        atol2 = 1e-5 * (x2max + float(c.c2.max()))
        with plain_versions():
            out_p = core.candidate_pass(*args, x2=c.x2, c2=c.c2)
        check(int(out_k[3]) == int(out_p[3]),
              f"pass {lock['passes']}: pair counts differ")
        lock["pairs"] += int(out_k[3])
        bad = out_k[0] != out_p[0]
        if bool(bad.any()):
            rows = bad.nonzero()[:, 0]
            cents = c.centroids.double()
            dk = ((x64[rows] - cents[out_k[0][rows].long()]) ** 2).sum(-1)
            dp = ((x64[rows] - cents[out_p[0][rows].long()]) ** 2).sum(-1)
            check(bool(((dk - dp).abs() <= 2 * atol2).all()),
                  f"pass {lock['passes']}: labels differ off a tie")
            lock["label_ties"] += int(bad.sum())
        check(bool(((out_k[1] ** 2 - out_p[1] ** 2).abs() <= atol2).all()),
              f"pass {lock['passes']}: upper bounds differ")
        # lower bounds may differ only where the two `changed` flags of a
        # point that kept its centroid differ (the old group's cap)
        fk, fp = torch.isfinite(out_k[2]), torch.isfinite(out_p[2])
        close = (out_k[2] == out_p[2]) | (fk & fp & (
            (out_k[2] ** 2 - out_p[2] ** 2).abs() <= atol2))
        kept = out_k[0] == c.assignments
        flip = torch.zeros_like(close)
        flip[kept.nonzero()[:, 0], groups.long()[c.assignments.long()][kept]] \
            = True
        check(bool((close | flip).all()),
              f"pass {lock['passes']}: lower bounds differ off a flip")
        lock["lb_flips"] += int((~close).sum())
        lock["passes"] += 1

    shift = math.inf
    t0 = time.perf_counter()
    while cond(carry.iteration, shift):
        compare_pass(carry)
        new_as, new_ub, new_lb, _, _ = core.candidate_pass(
            points, carry.centroids, carry.assignments, carry.ub, carry.lb,
            carry.need, groups, members, gsize, x2=carry.x2, c2=carry.c2)
        mv = [engine.move_and_bounds(points, carry.centroids, new_as,
                                     new_ub, new_lb, groups, k=k,
                                     n_groups=n_groups, x2=carry.x2)]
        with plain_versions():
            mv.append(engine.move_and_bounds(
                points, carry.centroids, new_as, new_ub, new_lb, groups,
                k=k, n_groups=n_groups, x2=carry.x2))
        err = float((mv[0].centroids - mv[1].centroids).abs().max())
        lock["centroid_err"] = max(lock["centroid_err"], err)
        check(err <= 1e-5 * float(mv[1].centroids.abs().max()),
              f"iteration {carry.iteration}: centroid move differs beyond "
              f"rtol 1e-5")
        carry = body(carry)
        shift = float(carry.shift)
        if carry.iteration == 5:
            carry5 = carry
    compare_pass(carry)                                   # the epilogue
    lock_s = time.perf_counter() - t0
    ep_as, ep_evals, ep_inertia = engine._epilogue_pass(
        core, points, None, carry, groups, members, gsize)
    check(torch.equal(ep_as, res.assignments) and int(ep_evals) == evals
          and carry.iteration == n_iters
          and torch.equal(carry.centroids, res.centroids),
          "the lockstep run did not retrace the main fit bit for bit")
    # pairs scored over pairs a pass with every block live would score
    live = lock["pairs"] / (lock["passes"] * -(-n // 256) * 256 * k)
    log(f"lockstep: live (tile, group) blocks carry {live:.4f} of the "
        f"pairs of an all-live pass, over {lock['passes']} passes")
    log(f"lockstep kernel vs plain, {lock['passes']} passes and "
        f"{carry.iteration} moves on the same inputs ({lock_s:.2f} s): "
        f"pair counts equal, labels equal but {lock['label_ties']} ties, "
        f"{lock['lb_flips']} lower bounds apart at self-flips, centroid "
        f"move max err {lock['centroid_err']:.3g}")

    # -- 4b. filtered_assign on the masks a fit really makes -------------
    # build_block_mask of the group_need that kernel_candidate_pass forms,
    # at iteration 5 and for the last pending pass of the fit above, and
    # at iteration 5 of a Hamerly (one group) kernel fit from the same
    # start; the kernel takes the fit's cached norms as the pass does
    def group_need(c):
        return c.need[:, None] & (c.lb < c.ub[:, None])

    groups1 = group_centroids(init, 1)
    members1, gsize1 = engine.build_group_tables(groups1.cpu().numpy(), 1,
                                                 dev)
    body1 = engine._loop_body(
        engine.PassCore(backend="kernel", k=k, n_groups=1), points, None,
        groups1, members1, gsize1)
    hamerly5 = engine._init_carry(points, init, groups1, n_groups=1)
    for _ in range(5):
        hamerly5 = body1(hamerly5)
    real = []
    for label, c, grp in (("yinyang iteration 5", carry5, groups),
                          (f"yinyang last pass (iteration "
                           f"{carry.iteration})", carry, groups),
                          ("hamerly iteration 5", hamerly5, groups1)):
        gneed = group_need(c)
        for tn, tk in tiles:
            mask = kernels.build_block_mask(gneed, grp, tile_n=tn,
                                            tile_k=tk).contiguous()
            real.append(fa_case(f"uci-xlarge {label}, {tn}x{tk}", points,
                                c.centroids, mask, tn, tk, x2=c.x2,
                                c2=c.c2))
    del hamerly5

    # -- 4c. the block-skip entry point, as a user calls it --------------
    # repro_torch.kernels on the fitted uci-xlarge state: the dense
    # squared distances to the fitted centroids, and one block-skip
    # assignment of the filter decisions of the fit's last pending pass
    # at the reference's default tiles
    final_need = group_need(carry)
    reset_launches(wrappers)
    sync()
    t0 = time.perf_counter()
    ep_d2 = kernels.pairwise_sq_dists(points, carry.centroids)
    ep_best, ep_idx, ep_density = kernels.filtered_assign_auto(
        points, carry.centroids, final_need, groups)
    sync()
    entry_s = time.perf_counter() - t0
    entry_launches = read_launches(wrappers)
    log(f"entry point: pairwise_sq_dists + filtered_assign_auto at "
        f"uci-xlarge in {entry_s:.3f} s, block density "
        f"{float(ep_density):.4f}; launches {entry_launches}")
    for nm in ("pairwise_sq_dists", "filtered_assign"):
        check(entry_launches[nm] >= 1, f"{nm} was not launched on the "
              f"entry point's path")
    check(tuple(ep_d2.shape) == (n, k) and bool(torch.isfinite(ep_d2).all())
          and bool((ep_d2 >= 0).all()), "entry point: bad distances")
    live_rows = ep_idx >= 0
    check(torch.equal(live_rows, torch.isfinite(ep_best))
          and bool((ep_idx < k).all()), "entry point: bad argmin")
    # the block-skip min over a row's live blocks is the dense min over
    # the same columns
    live_cols = kernels.build_block_mask(
        final_need, groups, tile_n=256, tile_k=128).repeat_interleave(
        256, 0)[:n].repeat_interleave(128, 1)[:, :k]
    dense_min = torch.where(live_cols, ep_d2, math.inf).min(1).values
    check(torch.equal(torch.isfinite(dense_min), live_rows)
          and bool(((ep_best - dense_min)[live_rows].abs()
                    <= 1e-5 * dense_min[live_rows] + norm_atol(
                        points, carry.centroids)).all()),
          "entry point: block-skip minima disagree with the dense ones")
    del ep_d2, live_cols, dense_min
    psd_main = psd_case("entry point, uci-xlarge fitted centroids", points,
                        carry.centroids, timed=True)
    fa_main = fa_case(
        "entry point, uci-xlarge last pass 256x128", points,
        carry.centroids, kernels.build_block_mask(
            final_need, groups, tile_n=256, tile_k=128).contiguous(),
        256, 128, timed=True)
    report["entry_point"] = dict(seconds=entry_s, launches=entry_launches,
                                 density=float(ep_density),
                                 real_masks=real)

    fit_kw = dict(max_iters=XLARGE["max_iters"], tol=XLARGE["tol"],
                  backend="auto", device=dev)
    t0 = time.perf_counter()
    r_k = engine.fit(points, init, **fit_kw)
    sync()
    kfit_s = time.perf_counter() - t0
    with plain_versions():
        t0 = time.perf_counter()
        r_p = engine.fit(points, init, **fit_kw)
        sync()
        pfit_s = time.perf_counter() - t0
    n_lab = int((r_k.assignments != r_p.assignments).sum())
    ev_k, ev_p = int(r_k.distance_evals), int(r_p.distance_evals)
    c_err = float((r_k.centroids - r_p.centroids).abs().max())
    in_k, in_p = float(r_k.inertia), float(r_p.inertia)
    log(f"whole fits: kernel {kfit_s:.3f} s, plain {pfit_s:.3f} s; "
        f"n_iters {r_k.n_iters}/{r_p.n_iters}, {n_lab} labels differ, "
        f"distance_evals {ev_k}/{ev_p}, centroid max err {c_err:.3g}, "
        f"inertia {in_k:.9g}/{in_p:.9g}")
    check(r_k.n_iters == r_p.n_iters, "kernel and plain n_iters differ")
    check(abs(in_k - in_p) <= 1e-5 * abs(in_p),
          "whole-fit inertia differs beyond rtol 1e-5")
    report["plain"] = dict(lockstep=lock, lockstep_s=lock_s, live_share=live,
                           kernel_fit_s=kfit_s, plain_fit_s=pfit_s,
                           labels_differ=n_lab, evals_kernel=ev_k,
                           evals_plain=ev_p, centroid_err=c_err,
                           inertia_kernel=in_k, inertia_plain=in_p)

    # -- 5. determinism ------------------------------------------------------
    same = (torch.equal(r_k.centroids, res.centroids)
            and torch.equal(r_k.assignments, res.assignments)
            and r_k.n_iters == res.n_iters
            and int(r_k.distance_evals) == evals
            and float(r_k.inertia) == float(res.inertia))
    check(same, "two kernel fits from one init are not bit-identical")
    r_w = engine.fit(points, init, sample_weight=torch.ones(n, device=dev),
                     **fit_kw)
    same_w = (torch.equal(r_w.centroids, r_k.centroids)
              and torch.equal(r_w.assignments, r_k.assignments)
              and r_w.n_iters == r_k.n_iters
              and float(r_w.inertia) == float(r_k.inertia))
    check(same_w, "weights of 1.0 are not bit-identical to no weights")
    log("determinism: repeat fit bit-identical, uniform weights "
        "bit-identical")

    # -- 6. small fit, card against CPU --------------------------------------
    sp, _, _ = make_points(4096, 16, 64, seed=3)
    sinit = torch.from_numpy(sp[:: 4096 // 64][:64].copy())
    s_gpu = engine.fit(sp, sinit, n_groups=6, backend="kernel", tol=1e-5,
                       device=dev)
    s_cpu = engine.fit(sp, sinit, n_groups=6, backend="kernel", tol=1e-5,
                       device="cpu")
    check(np.array_equal(s_gpu.assignments.cpu().numpy(),
                         s_cpu.assignments.numpy())
          and s_gpu.n_iters == s_cpu.n_iters,
          "small fit: card and CPU disagree on labels or n_iters")
    check(abs(float(s_gpu.inertia) - float(s_cpu.inertia))
          <= 1e-5 * float(s_cpu.inertia), "small fit: inertia differs")
    log(f"small fit (N=4096, D=16, K=64): card = CPU in labels and "
        f"n_iters={s_gpu.n_iters}; distance_evals "
        f"{int(s_gpu.distance_evals)}/{int(s_cpu.distance_evals)}")

    # -- 8. the compact backend at uci-xlarge ----------------------------
    reset_launches(wrappers)
    sync()
    t0 = time.perf_counter()
    r_c, s_c = engine.fit(points, init, max_iters=XLARGE["max_iters"],
                          tol=XLARGE["tol"], backend="compact", device=dev,
                          return_stats=True)
    sync()
    cfit_s = time.perf_counter() - t0
    compact_launches = read_launches(wrappers)
    ev_c, in_c = int(r_c.distance_evals), float(r_c.inertia)
    log(f"compact fit: {cfit_s:.3f} s, n_iters={r_c.n_iters}, "
        f"distance_evals={ev_c} ({ev_c / (n * k * r_c.n_iters):.4f} of "
        f"Lloyd's), host_syncs={s_c.host_syncs}, bucket_switches="
        f"{s_c.bucket_switches}, caps_history={s_c.caps_history}, "
        f"use_groups={s_c.use_groups}, inertia {in_c:.9g} (kernel "
        f"{in_k:.9g}), {int((r_c.assignments != r_k.assignments).sum())} "
        f"labels apart from the kernel fit; launches {compact_launches}")
    check(s_c.backend == "compact", "compact fit ran another backend")
    check(compact_launches["centroid_update"] >= r_c.n_iters,
          "the compact fit did not run the centroid_update kernel")
    check(r_c.n_iters == r_k.n_iters, "compact and kernel n_iters differ")
    check(abs(in_c - in_k) <= 1e-5 * abs(in_k),
          "compact and kernel inertia differ beyond rtol 1e-5")
    check(tuple(r_c.centroids.shape) == (k, d)
          and bool(torch.isfinite(r_c.centroids).all()),
          "compact fit: non-finite centroids")
    report["compact"] = dict(fit_s=cfit_s, n_iters=r_c.n_iters,
                             distance_evals=ev_c, inertia=in_c,
                             host_syncs=s_c.host_syncs,
                             bucket_switches=s_c.bucket_switches,
                             caps_history=s_c.caps_history,
                             use_groups=s_c.use_groups,
                             launches=compact_launches)

    # -- 9. a converging fit: kernel, compact and oracle agree -----------
    # uci-wide of the paper suite (N = 32,768, D = 128, K = 64) converges
    # well before max_iters, so its labels do not hang on the summation
    # order of an unfinished trajectory
    wn, wd, wk = WIDE["n"], WIDE["d"], WIDE["k"]
    w_np, _, _ = make_points(wn, wd, wk, seed=0)
    wpts = torch.from_numpy(w_np).to(dev)
    winit = KMeans(wk, seed=0, device=dev)._init_centroids(wpts)
    wfits = {}
    for b in ("kernel", "compact", "oracle"):
        t0 = time.perf_counter()
        wfits[b] = engine.fit(wpts, winit, max_iters=WIDE["max_iters"],
                              tol=WIDE["tol"], backend=b, device=dev)
        sync()
        log(f"uci-wide {b}: {time.perf_counter() - t0:.3f} s, n_iters="
            f"{wfits[b].n_iters}, distance_evals "
            f"{int(wfits[b].distance_evals)}, inertia "
            f"{float(wfits[b].inertia):.9g}")
    wk_fit = wfits["kernel"]
    check(wk_fit.n_iters < WIDE["max_iters"], "uci-wide did not converge")
    w_atol = norm_atol(wpts, wk_fit.centroids)
    conv = {}
    for b in ("compact", "oracle"):
        other = wfits[b]
        check(other.n_iters == wk_fit.n_iters,
              f"uci-wide: {b} n_iters {other.n_iters} != kernel "
              f"{wk_fit.n_iters}")
        check(abs(float(other.inertia) - float(wk_fit.inertia))
              <= 1e-5 * float(wk_fit.inertia),
              f"uci-wide: {b} inertia differs beyond rtol 1e-5")
        conv[b] = tie_rows(f"uci-wide {b}", wpts, wk_fit.centroids,
                           other.assignments, wk_fit.assignments, w_atol)
    log(f"uci-wide: kernel, compact and oracle converge in "
        f"{wk_fit.n_iters} iterations to the same labels, but "
        f"{conv} fp32 ties")
    report["converging"] = dict(
        config="uci-wide", n_iters=wk_fit.n_iters, tie_rows=conv,
        evals={b: int(r.distance_evals) for b, r in wfits.items()})
    del wpts, wfits

    # -- 7. where a fit's time goes: one traced kernel fit ----------------
    report["trace"] = traced(lambda: engine.fit(points, init, **fit_kw),
                             "traced fit")

    # -- 2c. the LM kernels against their plain versions -----------------
    from repro_torch.configs import get_config
    lm_cfg = get_config(SERVE["arch"])
    attn_main, ssd_main = lm_kernel_phase(dev, gen, bw, fp32, bf16, lm_cfg,
                                          SERVE["batch"], SERVE["prompt"])

    # -- 10. the LM serving path: hymba-1.5b at full width and depth -----
    del points
    serve_rep = serve_phase(dev, torch.Generator(device=dev).manual_seed(0),
                            wrappers, lm_cfg, SERVE["batch"], SERVE["prompt"],
                            SERVE["steps"])
    report["serve"] = serve_rep

    def row(nm, entry, source, replaces, path_launches):
        r = {"name": nm, "route": "cuda", "source": source,
             "replaces": replaces, "launches": path_launches[nm],
             "max_abs_err": entry["max_abs_err"], "ms": entry["ms"],
             "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
             "bound_by": entry["bound_by"], "library_ms": entry["library_ms"]}
        if "earlier_ms" in entry:       # the kernel it replaced, in turns
            r["earlier_ms"] = entry["earlier_ms"]
        if "write_floor_ms" in entry:   # fill_ of the output's size
            r["write_floor_ms"] = entry["write_floor_ms"]
        return r

    line = {"kernels": [
        row("grouped_assign", ga_main,
            "src/repro_torch/kernels/csrc/grouped_assign.cu",
            "src/repro/kernels/grouped_assign.py:83", launches),
        row("centroid_update", cu_main,
            "src/repro_torch/kernels/csrc/centroid_update.cu",
            "src/repro/kernels/centroid_update.py:39", launches),
        # launched by the block-skip entry point's path (phase 4c)
        row("pairwise_sq_dists", psd_main,
            "src/repro_torch/kernels/csrc/pairwise_sq_dists.cu",
            "src/repro/kernels/distance.py:35", entry_launches),
        row("filtered_assign", fa_main,
            "src/repro_torch/kernels/csrc/filtered_assign.cu",
            "src/repro/kernels/filtered_assign.py:61", entry_launches),
        # launched by the LM serving path (phase 10)
        row("flash_attention", attn_main,
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:77", serve_rep["launches"]),
        row("ssd_intra", ssd_main,
            "src/repro_torch/kernels/csrc/ssd_intra.cu",
            "src/repro/kernels/ssd_intra.py:44", serve_rep["launches"]),
    ]}
    report["kernels"] = line["kernels"]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    log(json.dumps(line))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
