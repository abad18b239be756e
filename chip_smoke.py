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
11. observability at uci-xlarge: ``KMeans(engine="auto", obs=...)``
   against the same fit with obs off, in turns (off, on, on, off), as
   ``KMeans`` and as ``engine.fit``: equal labels, ``n_iters``,
   ``distance_evals``, inertia bits and ``host_syncs``; the drained
   float64 ring has ``n_iters + 1`` rows and ``init_evals`` plus its
   evals column is ``distance_evals`` exactly; a ``live_drain`` fit
   hands every row to a listener; ``obs.profile`` of a fit writes a
   trace with the ``kpynq/*`` ranges, every ``ga_kernel`` launched
   inside ``kpynq/candidate_pass``; the registry exports
   ``engine_fits_total``;
12. autotuning at uci-xlarge into a fresh cache
   (``REPRO_TORCH_KMEANS_TUNE_CACHE`` points at a new temporary file for
   the whole run, so no cache left on the machine decides anything):
   ``autotune`` with at most 10 measured configs, each logged;
   ``fit(tune="auto")`` runs the stored winner and ``fit(tune="force")``
   does not search again; the kernel backend's ``tile_n`` lattice (128,
   256, 512) gives the same labels, ``n_iters`` and inertia bits
   (``distance_evals`` logged, it counts whole tiles); Lloyd on
   uci-wide converges with phase 9's kernel and compact fits;
13. the fitted uci-xlarge centroids behind ``CentroidIndex`` and a
   ``ServeEngine`` on each backend (``fused``, ``grouped``, ``kernel``):
   2^20 query points in requests of 1 to 4096 points (seeded), from 4
   client threads, with one 20,000-point request the engine splits and
   one request as a CUDA tensor; the index republished midway under the
   rebuild threshold (tables reused) and over it (rebuilt); every
   request's labels equal to argmin of float64 distances to the
   centroids of the epoch it reports, but at fp32 near-ties (phase
   2b's rule: the squared distances within twice 1e-5 of ||x||^2 +
   max ||c||^2, the rounding scale of the expanded form), which are
   counted, with those at a relative distance gap of 1e-5 or more
   apart; ``grouped_assign``
   launched once a batch on ``kernel`` and no port kernel on the
   others; points/s, request latency, a traced batch's idle share, and
   ``autotune_serve`` at K = 256, D = 32;
14. streaming k-means at uci-xlarge (``repro_torch.streaming``): the
   2^20 points as 16 shards of 65,536 through ``StreamingKMeans`` for 3
   epochs (decay 1.0, the cold start from one shard, a
   ``CentroidIndex`` attached with a publish every 4 batches), counts
   reset just before and read just after the stream, ``predict`` and
   ``inertia_of`` (``centroid_update`` at least once a batch,
   ``grouped_assign`` in the last two); epochs 2-3 all cache hits; cold
   and warm points/s and ``distance_evals`` against N*K per epoch; the
   final inertia over a batch fit's from the same seeds (under 1.05x);
   the same stream with both kernels swapped for their plain versions
   (the first batch's labels equal, final inertia within rtol 1e-3);
   65,536 queries through a ``ServeEngine`` on the index, which holds
   the last batch's centroids, against the fp64 yardstick by phase
   13's near-tie rule; a traced warm batch and a traced cold one;
15. the resilient stream (``fit_stream(resilient=True)``,
   ``repro_torch.checkpoint``, ``repro_torch.runtime``) with phase 14's
   arguments, async checkpoints every 8 batches into a temporary
   directory removed afterwards: one run survives a ``FailureInjector``
   failure off the checkpoint lattice, a tear mid-batch through
   ``chaos_hook`` and a crash onto a newest checkpoint whose
   ``shard_0.npz`` was torn (3 restores, batches replayed), counts reset
   just before and read just after it, ``predict`` and ``inertia_of``
   (``centroid_update`` at least once a batch run, replays included);
   its centroids, counts and both drift-ledger arrays bit for bit
   (``torch.equal``, ``np.array_equal``) those of phase 14's
   uninterrupted stream, and again after a ``restore_state`` of its
   terminal checkpoint; a ``StreamingKMeans.restore`` from a 2-epoch
   resilient run's terminal checkpoint streamed on to 3 epochs (1
   restore, 0 replays) and a cold restart from a failure before any
   checkpoint (k-means++ seeding on the card again), both bit for bit;
   the bytes of one checkpoint, the snapshot seconds
   (``ckpt_save_seconds``), the seconds of a restore and the points/s
   against phase 14's;
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

16. the sharded batch fit (``repro_torch.core.distributed_yinyang`` on
   ``torch.distributed``), its worlds started by ``spawn_world`` with a
   deadline, each rank reporting through a file (a rank that fails or
   is late fails the run): (a) a world of 4 ``gloo`` ranks sharing the
   card at uci-xlarge with phase 3's points and init (262,144 points a
   rank), the compact fit the main path (counts reset just before and
   read just after on every rank), compact and dense bit for bit, the
   same ``n_iters`` as phase 3 and inertia within 1e-5 (labels apart and
   the ``distance_evals`` ratio logged), N = 1,048,573 against the
   single-device compact fit, ``compress=True`` within 1% of the
   inertia; (b) the same world at uci-wide: labels those of the
   single-device compact fit, dense and compact and weights of 1.0 and
   none bit for bit; (c) a world of 1 over NCCL at uci-wide: labels,
   ``n_iters`` and ``distance_evals`` those of the single-device compact
   fit, centroids bit for bit; each world's fit seconds beside the
   single-device fit's, ``host_syncs``, one iteration's all-reduce time
   and ``shard_skew``; in (a)'s world the measured sharded search
   (``autotune(shards=4)`` on one shard's worth of the points, one
   round of at most 4 configs, one repeat each): one winner on every
   rank under the ``|s4`` key, adopted by ``tune="auto"`` with the
   labels of the default config's fit.
17. the sharded stream (``StreamingKMeans(mesh=...)``), its worlds
   started by ``spawn_world`` with a deadline: (a) phase 14's stream (16
   shards of 65,536, 3 epochs, decay 1.0, phase 14's seeds) over a world
   of 4 ``gloo`` ranks sharing the card, the main path (counts reset
   just before and read just after it on every rank): 48 sharded
   batches, the counts' sum phase 14's, the first batch's labels phase
   14's but at fp32 near-ties, the final inertia within rtol 1e-3 of
   phase 14's, ``distance_evals`` within 5% of phase 14's, the ranks bit
   for bit alike, ``centroid_update`` at least once a batch a rank;
   points/s an epoch beside phase 14's and one warm batch's time in the
   all-reduces, gathers and ``inflate_bounds``; (b) a world of 1 over
   NCCL: centroids, counts, both ledger arrays and ``distance_evals``
   phase 14's bit for bit; (c) in (a)'s world at 2 epochs, a resilient
   stream on a 2-rank sub-mesh through one ``FailureInjector`` failure
   bit for bit its uninterrupted run, its step-16 checkpoint grown into
   the 4-rank mesh and a 4-rank checkpoint shrunk into the 2-rank mesh,
   each within 2% of its uninterrupted run's inertia.

2d. the backward kernels (``flash_attention_gqa_bwd``,
   ``ssd_intra_chunks_bwd``) against their plain versions, after 2c:
   attention at hymba-1.5b's training shape (B = 2, S = 2048, 25/5
   heads of 64) in bf16 and fp32, at a ragged S in bf16 and at S = 1000
   in fp32 at a head dim of 128; SSD at hymba-1.5b's training cells, at
   Q = 100 and at mamba2-780m's widths (N = 128, P = 64): each gradient
   within 1e-4 (fp32) of the plain version's largest |value|, in bf16
   within 3e-2 or 1.5 times the distance of autograd through
   ``scaled_dot_product_attention`` from the plain version, whichever
   is larger; two calls bit for bit; the training shapes timed by CUDA
   events beside the bound, the plain version and (attention) the
   autograd backward of SDPA;
18. hymba-1.5b training at full width and depth (1.64e9 bf16
   parameters, fp32 moments, ``remat="full"``): 4 steps of 2 x 2048
   tokens from ``TokenPipeline(seed=0)``, counts reset just before and
   read just after (each step: 64 forward launches of each LM kernel,
   the layer's own and its recomputation, all attention on the tensor
   cores, and 32 of each backward kernel); step ms (median of the last
   3), tokens/s and peak memory; (a) the first step through the plain
   route (plain forwards, plain backward formulas) against the kernels'
   in loss and ``grad_norm``, within 3e-2 or 1.5 times the distance of
   a route through SDPA's autograd from the plain one, whichever is
   larger; (b) the first step twice from one state: parameters and
   moments bit for bit; (c) every loss finite;
19. ``ResilientLoop`` over hymba-1.5b at full width, cut to 2 layers
   and 512 tokens (checkpoints of about 2 GB): 8 steps, a checkpoint
   every 4, a failure at step 6; the final parameters and moments the
   uninterrupted run's bit for bit;
20. the rest of the k-means surface: the three examples
   (``repro_torch.examples``) as processes with ``--device cuda``
   (``serve_kmeans --smoke``), each exiting 0; phase 14's stream
   through ``PrefetchingLoader`` into ``fit_stream`` for one epoch,
   bit for bit the directly fed epoch; ``cluster_kv_cache`` over phase
   10's layer-0 KV cache (S = 2048, 5 kv heads of 64, K = 64): counts
   summing to S a head, centroids within 1e-4 of the same call on the
   CPU from the same seeds.

Phases 11-17 run after phase 7, before 2c; 2d, then 18-20, after 10.
The last lines are a ``kernels`` JSON line (each kernel's ``launches``
is the sum of its ``launches_by_path``: the k-means kernels' on the
main fit and predict, phase 13's ``kernel`` backend, phase 14's stream,
phase 15's resilient stream, phase 16's sharded fit and phase 17's
sharded stream, each summed over its ranks; the LM kernels' on phase
10's serving path and phase 18's training steps), the card's name
and power limit from ``nvidia-smi``, and ``{"ok": true, "device":
{...}}``. The
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
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def paper_problem(name: str):
    """A problem of the paper suite (``repro_torch.configs.paper_suite``)
    as the dict the phases read: n, d, k, max_iters, tol."""
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.kpynq import paper_suite
    p = next(p for p in paper_suite if p.name == name)
    return dict(n=p.n_points, d=p.n_dims, k=p.k, max_iters=p.max_iters,
                tol=p.tol)


# uci-xlarge, uci-wide and uci-highk of the paper suite; without the
# repository beside this file there is none, and main() says so
try:
    XLARGE, WIDE, HIGHK = (paper_problem(nm) for nm in
                           ("uci-xlarge", "uci-wide", "uci-highk"))
except ImportError:
    XLARGE = WIDE = HIGHK = None
# the LM serving path: hymba-1.5b at full width and depth, 2 prompts
SERVE = dict(arch="hymba-1.5b", batch=2, prompt=2048, steps=32)
# LM training at hymba-1.5b's full width: phase 18 at full depth, phase
# 19 cut to 2 layers and 512 tokens (checkpoints of about 2 GB)
TRAIN = dict(arch="hymba-1.5b", batch=2, seq=2048, steps=4)
RESILIENT_TRAIN = dict(layers=2, seq=512, steps=8, ckpt_every=4,
                       fail_at=6)
# phase 20: the k-means clusters of phase 10's layer-0 KV cache
KV_CLUSTERS = 64
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


def host_ms(fn, calls: int = 20) -> float:
    """Host ms a call of ``fn`` takes to enqueue its work, without
    waiting for the card (after a warm-up call and a sync): beside an
    events time, it says whether the host or the card sets the pace."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = (time.perf_counter() - t0) * 1e3 / calls
    sync()
    return dt


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


def plain_train_route():
    """Both LM kernels swapped for their plain forwards with their plain
    backward formulas (``*_plain_vjp``): a training step's plain route."""
    fla, ssd = kernel_module("flash_attention"), kernel_module("ssd_intra")
    return lm_route(fla.flash_attention_gqa_plain_vjp,
                    ssd.ssd_intra_chunks_plain_vjp)


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
    report, with the launches of the main path (prefill + decode), and
    the first prompt's layer-0 keys and values (S, KV, Dh)."""
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
    # phase 20's input: the first prompt's layer-0 keys and values
    kv0 = tuple(cache[nm][0, 0, :s].clone() for nm in ("k", "v"))
    return rep, kv0


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


# -- phase 2d: the backward kernels against their plain versions --------------

def rel_err(a, b) -> float:
    """max |a - b| over the largest |b|, in fp32."""
    b = b.float()
    return float((a.float() - b).abs().max()) / (float(b.abs().max())
                                                 + 1e-30)


def lm_backward_phase(dev, gen, bw, fp32, bf16, cfg, batch, seq):
    """Phase 2d: ``flash_attention_gqa_bwd`` and ``ssd_intra_chunks_bwd``
    against their plain versions at the shapes ``cfg``'s training step
    gives them for ``batch`` rows of ``seq`` tokens, and at ragged ones.
    Returns the timed entries of the training shapes (attention, SSD)."""
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.configs import get_config
    fla, ssd = kernel_module("flash_attention"), kernel_module("ssd_intra")

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def attn_case(label, b, s, h, kvh, d, dtype, timed=False):
        q, do = randn(b, s, h, d, dtype=dtype), randn(b, s, h, d, dtype=dtype)
        k, v = (randn(b, s, kvh, d, dtype=dtype) for _ in range(2))
        o = kernels.flash_attention_gqa(q, k, v)
        got = fla.flash_attention_gqa_bwd(q, k, v, o, do)
        again = fla.flash_attention_gqa_bwd(q, k, v, o, do)
        want = fla.flash_attention_gqa_bwd_plain(q, k, v, o, do)
        sync()
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        del again
        errs = {nm: rel_err(g, w) for nm, g, w in zip(("dq", "dk", "dv"),
                                                       got, want)}
        floor = None
        if dtype == torch.float32:
            tol = 1e-4
        else:
            # another correct backward: autograd through SDPA
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            lib = torch.autograd.grad(sdpa_gqa(*leaves), leaves, do)
            floor = max(rel_err(a, w) for a, w in zip(lib, want))
            tol = max(3e-2, 1.5 * floor)
            del lib, leaves
        check(same, f"flash_attention_bwd {label}: two calls differ")
        check(all(bool(torch.isfinite(g).all()) and g.shape == w.shape
                  and g.dtype == dtype for g, w in zip(got, want)),
              f"flash_attention_bwd {label}: non-finite or misshapen grads")
        check(max(errs.values()) <= tol, f"flash_attention_bwd {label}: "
              f"{errs} of the plain version's scale, beyond {tol:.3g}")
        entry = dict(case=label, shape=dict(b=b, s=s, h=h, kv=kvh, d=d),
                     dtype=str(dtype), rel_err=errs, tol=tol,
                     sdpa_rel_err=floor, deterministic=same,
                     max_abs_err=max(float((g.float() - w.float()).abs()
                                           .max())
                                     for g, w in zip(got, want)))
        del got, want
        if timed:
            es = q.element_size()
            # q, o, dO in and dq out; k, v in and dk, dv out
            nbytes = es * (4 * b * s * h * d + 4 * b * s * kvh * d)
            # the five products a backward needs (S again, dV, dP, dQ,
            # dK) over the causal half: 2.5x the forward's
            flops = 5 * 2.0 * d * b * h * s * (s + 1) / 2
            peak = fp32 if dtype == torch.float32 else bf16
            bound_ms, by = roof(nbytes, flops, bw, peak)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = sdpa_gqa(*leaves)

            def new():
                return fla.flash_attention_gqa_bwd(q, k, v, o, do)

            def library():
                return torch.autograd.grad(out, leaves, do,
                                           retain_graph=True)
            turns = {"library": [median_ms(library)],
                     "new": [median_ms(new), median_ms(new)]}
            turns["library"].append(median_ms(library))
            entry.update(
                ms=statistics.mean(turns["new"]), turns_ms=turns,
                plain_ms=median_ms(
                    lambda: fla.flash_attention_gqa_bwd_plain(q, k, v, o,
                                                              do),
                    reps=3, inner=1),
                bound_ms=bound_ms, bound_by=by,
                library_ms=statistics.mean(turns["library"]),
                device_ms=device_ms_by_kernel(new), host_ms=host_ms(new))
            del out, leaves
        log(f"flash_attention_bwd {label}: {json.dumps(entry)}")
        return entry

    def ssd_case(label, bsz, nc, q, h, g, n, p, timed=False):
        C, B = (randn(bsz, nc, q, g, n) for _ in range(2))
        x, dy = (randn(bsz, nc, q, h, p) for _ in range(2))
        step = torch.nn.functional.softplus(randn(bsz, nc, q, h)) * 0.1
        cum = torch.cumsum(-step, dim=2)
        args = (C, B, x, cum, dy)
        got = ssd.ssd_intra_chunks_bwd(*args)
        again = ssd.ssd_intra_chunks_bwd(*args)
        want = ssd.ssd_intra_chunks_bwd_plain(*args)
        sync()
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        del again
        errs = {nm: rel_err(gr, w) for nm, gr, w in
                zip(("dC", "dB", "dx", "dcum"), got, want)}
        check(same, f"ssd_intra_bwd {label}: two calls differ")
        check(all(bool(torch.isfinite(gr).all()) and gr.shape == t.shape
                  for gr, t in zip(got, (C, B, x, cum))),
              f"ssd_intra_bwd {label}: non-finite or misshapen grads")
        check(max(errs.values()) <= 1e-4, f"ssd_intra_bwd {label}: {errs} "
              f"of the plain version's scale, beyond 1e-4")
        entry = dict(case=label, shape=dict(b=bsz, nc=nc, q=q, h=h, g=g,
                                            n=n, p=p),
                     rel_err=errs, tol=1e-4, deterministic=same,
                     max_abs_err=max(float((gr - w).abs().max())
                                     for gr, w in zip(got, want)))
        del got, want
        if timed:
            cells, pairs = bsz * nc * h, q * (q + 1) / 2
            # dS and dx (P-long products), M, dC and dB (N-long) over
            # the causal half of each cell
            flops = cells * pairs * 2.0 * (2 * p + 3 * n)
            nbytes = 4 * 2 * (C.numel() + B.numel() + x.numel()
                              + cum.numel()) + 4 * dy.numel()
            bound_ms, by = roof(nbytes, flops, bw, fp32)

            def new():
                return ssd.ssd_intra_chunks_bwd(*args)
            entry.update(
                ms=median_ms(new), device_ms=device_ms_by_kernel(new),
                host_ms=host_ms(new),
                plain_ms=median_ms(
                    lambda: ssd.ssd_intra_chunks_bwd_plain(*args), reps=3,
                    inner=1),
                bound_ms=bound_ms, bound_by=by, library_ms=None,
                library="none: no single PyTorch call")
        log(f"ssd_intra_bwd {label}: {json.dumps(entry)}")
        return entry

    b, s = batch, seq
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bf = torch.bfloat16
    attn_main = attn_case(f"{cfg.name} training B={b} S={s}", b, s, h, kvh,
                          d, bf, timed=True)
    attn_case(f"{cfg.name} training B={b} S={s} fp32", b, s, h, kvh, d,
              torch.float32)
    attn_case(f"ragged S={s + 1} bf16", 1, s + 1, h, kvh, d, bf)
    attn_case("ragged S=1000 fp32, 28/4 heads of 128", 1, 1000, 28, 4, 128,
              torch.float32)
    m = cfg.ssm
    ssd_main = ssd_case(f"{cfg.name} training B={b} S={s}", b, s // m.chunk,
                        m.chunk, m.n_heads, m.n_groups, m.d_state,
                        m.head_dim, timed=True)
    ssd_case(f"{cfg.name} cells Q=100", b, 4, 100, m.n_heads, m.n_groups,
             m.d_state, m.head_dim)
    m2 = get_config("mamba2-780m").ssm
    ssd_case("mamba2-780m cells", b, 4, m2.chunk, m2.n_heads, m2.n_groups,
             m2.d_state, m2.head_dim)
    return attn_main, ssd_main


# -- phase 18: LM training at full width and depth ---------------------------

def _tree_equal(a, b) -> bool:
    from repro_torch.checkpoint.checkpoint import tree_flatten
    return all(torch_equal(x, y) for x, y in zip(tree_flatten(a)[0],
                                                 tree_flatten(b)[0]))


def torch_equal(x, y) -> bool:
    import torch
    return x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)


def train_phase(dev, gen, wrappers, cfg, batch, seq, steps):
    """Phase 18: ``cfg``'s training at full width and depth, ``steps``
    steps of ``batch`` x ``seq`` tokens from ``TokenPipeline(seed=0)``.
    Returns the report, with the main path's launches."""
    import torch

    from repro_torch.data import TokenPipeline
    from repro_torch.train import init_train_state, make_train_step

    t0 = time.perf_counter()
    state0 = init_train_state(cfg, gen, device=dev)
    sync()
    n_params = sum(t.numel() for t in _leaves(state0.params))
    log(f"train: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model},"
        f" remat {cfg.remat!r}), {n_params} params in {cfg.dtype} with fp32 "
        f"moments, made in {time.perf_counter() - t0:.2f} s")
    pipe = TokenPipeline(cfg, batch=batch, seq=seq, seed=0)
    step = make_train_step(cfg)
    first = pipe.global_batch(0)

    # (b) the first step twice from one state: the same bits
    s1, m1 = step(state0, first)
    s1b, m1b = step(state0, first)
    sync()
    same = _tree_equal(s1, s1b) and torch_equal(m1["loss"], m1b["loss"]) \
        and torch_equal(m1["grad_norm"], m1b["grad_norm"])
    del s1, s1b, m1b
    check(same, "train: the same step from one state gave other bits")

    # (a) the first step through the plain route, and through a second
    # correct route (SDPA's autograd for attention, the plain SSD)
    ssd_vjp = kernel_module("ssd_intra").ssd_intra_chunks_plain_vjp
    with plain_train_route():
        mp = step(state0, first)[1]
    with lm_route(sdpa_gqa, ssd_vjp):
        ms_ = step(state0, first)[1]
    sync()

    def rel(a, b_):
        return abs(float(a) - float(b_)) / abs(float(b_))
    floor = max(rel(ms_[k], mp[k]) for k in ("loss", "grad_norm"))
    bound = max(3e-2, 1.5 * floor)
    errs = {k: rel(m1[k], mp[k]) for k in ("loss", "grad_norm")}
    log(f"train: first step, kernels {float(m1['loss']):.6f} loss "
        f"{float(m1['grad_norm']):.6f} grad_norm; plain route "
        f"{float(mp['loss']):.6f}, {float(mp['grad_norm']):.6f}; SDPA route "
        f"{float(ms_['loss']):.6f}, {float(ms_['grad_norm']):.6f}; kernels "
        f"vs plain {errs}, bound {bound:.4g}")
    check(max(errs.values()) <= bound, f"train: the kernels' first step is "
          f"{errs} from the plain route's, beyond {bound:.3g}")

    # the main path: steps from state0, counts reset just before
    reset_launches(wrappers)
    torch.cuda.reset_peak_memory_stats(dev)
    state = state0
    del state0
    losses, norms, step_ms = [], [], []
    t0 = time.perf_counter()
    for i in range(steps):
        batch_i = pipe.global_batch(i)
        sync()
        t1 = time.perf_counter()
        state, met = step(state, batch_i)
        sync()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    path_s = time.perf_counter() - t0
    launches = read_launches(wrappers)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    check(int(state.step) == steps, "train: the state's step counter")
    check(all(math.isfinite(x) for x in losses + norms),
          f"train: non-finite loss or grad_norm {losses} {norms}")
    per_step = {nm: c / steps for nm, c in launches.items()}
    want = {"flash_attention": 2 * cfg.n_layers,
            "flash_attention.tc": 2 * cfg.n_layers,
            "flash_attention.ffma": 0, "ssd_intra": 2 * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers,
            "ssd_intra_bwd": cfg.n_layers}
    for nm, cnt in per_step.items():
        check(cnt == want.get(nm, 0), f"train: {nm} launched {cnt} times a "
              f"step, not {want.get(nm, 0)}")
    med = statistics.median(step_ms[1:])
    rep = dict(arch=cfg.name, batch=batch, seq=seq, steps=steps,
               params=n_params, remat=cfg.remat, launches=launches,
               launches_per_step=per_step, main_path_s=path_s,
               step_ms=step_ms, step_ms_median_last=med,
               tokens_per_s=batch * seq / (med / 1e3), losses=losses,
               grad_norms=norms, peak_gib=peak_gib,
               first_step=dict(kernels={k: float(m1[k]) for k in errs},
                               plain={k: float(mp[k]) for k in errs},
                               sdpa={k: float(ms_[k]) for k in errs},
                               rel_err=errs, sdpa_rel_err=floor,
                               bound=bound),
               deterministic=same)
    log(f"train: {steps} steps in {path_s:.3f} s, step ms {step_ms} (median "
        f"of the last {steps - 1}: {med:.2f} ms, {rep['tokens_per_s']:.5g} "
        f"tokens/s); losses {losses}; peak memory {peak_gib:.3f} GiB; "
        f"launches a step {per_step}")
    # where a step's time goes: one more step, traced, after the path
    nxt = pipe.global_batch(steps)
    rep["trace"] = traced(lambda: step(state, nxt), "traced train step")
    return rep


# -- phase 19: the resilient training loop ------------------------------------

def resilient_train_phase(dev, gen, cfg, tmpdir, layers, seq, steps,
                          ckpt_every, fail_at):
    """Phase 19: ``ResilientLoop`` over ``cfg`` at full width cut to
    ``layers`` layers and ``seq`` tokens: ``steps`` steps with a
    checkpoint every ``ckpt_every`` and a failure at ``fail_at``, against
    the uninterrupted run bit for bit."""
    from repro_torch.data import TokenPipeline
    from repro_torch.runtime import FailureInjector, ResilientLoop
    from repro_torch.train import init_train_state, make_train_step

    cut = dataclasses.replace(cfg, n_layers=layers)
    state = init_train_state(cut, gen, device=dev)
    pipe = TokenPipeline(cut, batch=2, seq=seq, seed=0)
    step = make_train_step(cut)

    def run(tag, fail):
        loop = ResilientLoop(step, pipe, Path(tmpdir) / tag,
                             ckpt_every=ckpt_every,
                             injector=FailureInjector(fail))
        t0 = time.perf_counter()
        final = loop.run(state, steps)
        sync()
        return loop, final, time.perf_counter() - t0

    _, clean, clean_s = run("clean", ())
    loop, faulted, fault_s = run("fault", (fail_at,))
    ckpt = Path(tmpdir) / "clean" / f"step_{ckpt_every:06d}"
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.iterdir())
    same = _tree_equal(clean, faulted)
    shutil.rmtree(tmpdir, ignore_errors=True)
    rep = dict(layers=layers, seq=seq, steps=steps, ckpt_every=ckpt_every,
               fail_at=fail_at, restarts=loop.restarts,
               checkpoint_bytes=ckpt_bytes, clean_s=clean_s,
               faulted_s=fault_s, bit_for_bit=same,
               losses=[m["loss"] for m in loop.metrics_log])
    log(f"resilient train: {cfg.name} cut to {layers} layers and {seq} "
        f"tokens, {steps} steps, a checkpoint every {ckpt_every} "
        f"({ckpt_bytes / 1e9:.3f} GB), a failure at step {fail_at}: "
        f"{loop.restarts} restart, uninterrupted {clean_s:.2f} s, faulted "
        f"{fault_s:.2f} s, final state bit for bit: {same}")
    check(loop.restarts == 1, "resilient train: no restart happened")
    check(same, "resilient train: the replayed run's final state differs "
          "from the uninterrupted run's")
    return rep


# -- phase 20: the rest of the k-means surface --------------------------------

EXAMPLES = {"quickstart": [], "kmeans_clustering": [],
            "serve_kmeans": ["--smoke"]}


def kmeans_surface_phase(dev, pts_np, k, n_groups, kv0, n_clusters,
                         shard=None, examples=EXAMPLES,
                         example_device="cuda"):
    """Phase 20: the examples as processes, phase 14's stream through
    ``PrefetchingLoader``, and ``cluster_kv_cache`` over ``kv0`` (keys
    and values (S, KV, Dh) on the card) against the same call on the
    CPU from the same seeds."""
    import torch

    from repro_torch.core.init import kmeans_plusplus
    from repro_torch.core.integrations import (cluster_kv_cache,
                                               clustered_attention_scores)
    from repro_torch.data import PointStream, PrefetchingLoader

    shard = shard or STREAM["shard"]
    rep = {}
    # (a) the examples, at once, as a user runs them
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    procs = {nm: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{nm}", "--device",
         example_device, *extra], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for nm, extra in
        examples.items()}
    outs = {}
    try:
        for nm, proc in procs.items():
            outs[nm] = proc.communicate(timeout=600)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rep["examples_s"] = time.perf_counter() - t0
    rep["examples"] = {nm: proc.returncode for nm, proc in procs.items()}
    for nm, out in outs.items():
        tail = out.strip().splitlines()[-3:]
        log(f"example {nm}: exit {procs[nm].returncode}; " + " | ".join(tail))
        check(procs[nm].returncode == 0, f"example {nm} failed:\n"
              f"{out[-3000:]}")

    # (b) phase 14's stream through the prefetch thread, one epoch
    stream = PointStream(shard_size=shard, data=pts_np)
    t0 = time.perf_counter()
    direct = stream_estimator(dev, k, n_groups, shard).fit_stream(stream)
    sync()
    direct_s = time.perf_counter() - t0
    loader = PrefetchingLoader(stream, device=dev)
    t0 = time.perf_counter()
    try:
        fed = stream_estimator(dev, k, n_groups, shard).fit_stream(
            next(loader) for _ in range(stream.n_shards))
        sync()
    finally:
        loader.close()
    fed_s = time.perf_counter() - t0
    same = torch_equal(fed._centroids, direct._centroids) and \
        torch_equal(fed._counts, direct._counts)
    rep["prefetch"] = dict(batches=stream.n_shards, direct_s=direct_s,
                           prefetched_s=fed_s, bit_for_bit=same)
    log(f"prefetch: {stream.n_shards} batches through PrefetchingLoader "
        f"{fed_s:.3f} s, fed directly {direct_s:.3f} s; centroids and "
        f"counts bit for bit: {same}")
    check(same, "prefetch: the prefetched epoch differs from the direct one")

    # (c) the layer-0 KV cache, clustered on the card and on the CPU
    kc, vc = kv0
    s, kvh, _ = kc.shape
    k_cpu, v_cpu = kc.float().cpu(), vc.float().cpu()
    inits = torch.stack([kmeans_plusplus(torch.Generator().manual_seed(hd),
                                         k_cpu[:, hd], n_clusters)
                         for hd in range(kvh)])
    t0 = time.perf_counter()
    card = cluster_kv_cache(kc, vc, n_clusters, inits=inits)
    sync()
    card_s = time.perf_counter() - t0
    cpu = cluster_kv_cache(k_cpu, v_cpu, n_clusters, inits=inits)
    counts_ok = bool((card[2].sum(0) == s).all())
    scale = max(1.0, float(cpu[0].abs().max()))
    cent_err = float((card[0].cpu() - cpu[0]).abs().max())
    val_err = float((card[1].cpu() - cpu[1]).abs().max())
    count_diff = int((card[2].cpu() != cpu[2]).sum())
    probs = clustered_attention_scores(kc[-1].float(), card[0], card[2],
                                       kc.shape[-1] ** -0.5)
    rep["kv_cache"] = dict(s=s, kv_heads=kvh, clusters=n_clusters,
                           seconds=card_s, counts_sum_to_s=counts_ok,
                           centroid_max_abs_diff=cent_err, scale=scale,
                           value_max_abs_diff=val_err,
                           count_slots_differing=count_diff)
    log(f"kv cache: {kvh} heads of {s} keys into {n_clusters} clusters in "
        f"{card_s:.3f} s on the card; counts sum to S: {counts_ok}; "
        f"centroids {cent_err:.3g} from the CPU's (scale {scale:.3g}), "
        f"values {val_err:.3g}, {count_diff} counts differ; scores sum "
        f"{float(probs.sum(-1).max()):.6f}")
    check(counts_ok, "kv cache: counts do not sum to S a head")
    check(cent_err <= 1e-4 * scale, f"kv cache: centroids {cent_err:.3g} "
          f"from the CPU's, beyond 1e-4 of scale {scale:.3g}")
    return rep


# the port's own kernels (csrc/*.cu's __global__ functions), as the
# profiler names them
PORT_KERNEL = re.compile(r"^(void )?(\(anonymous namespace\)|tc|simt)::"
                         r"(ga|ga_plan|ga_simple|cu_partial|cu_reduce|psd|fa|"
                         r"fa_tc|ssd|fa_bwd_pre|fa_bwd_dkdv|fa_bwd_dq|"
                         r"ssd_bwd_cell|ssd_bwd_reduce)(_kernel)?[<(]")


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
    dev_ms, calls, phases = {}, {}, {}
    for ev in prof.key_averages():
        # device-side events only: a CPU op's entry repeats the time of
        # the kernels it launched
        if ev.device_type != DeviceType.CUDA:
            continue
        t_us = ev.self_device_time_total
        if ev.key.startswith("kpynq/"):
            # the engine's phase ranges span the kernels they launched on
            # the device's timeline: their own entries, not busy time
            phases[ev.key] = phases.get(ev.key, 0.0) + t_us / 1e3
        elif t_us > 0:
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
    for key, ms in sorted(phases.items()):
        log(f"  phase range: {ms:9.3f} ms  {key}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                top=[[k_, v_, calls[k_]] for k_, v_ in top],
                port=[[k_, v_, calls[k_]] for k_, v_ in port],
                phases=phases)


# -- phases 11-13: observability, tuning, the k-means serving index ----------

def _quantile(sorted_vals, q):
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


def hist_quantile(hist, q):
    """The upper bound of the registry histogram's bucket that holds
    quantile ``q`` (inf past the last bound)."""
    want = q * hist.count
    for ub, c in zip(hist.buckets, hist.bucket_counts):
        if c >= want:
            return ub
    return math.inf


def ga_inside_candidate_pass(trace_path):
    """``(ga kernels, of them launched inside a kpynq/candidate_pass
    range, the kpynq/* range names seen)`` from a Chrome trace: each
    ``ga_kernel`` is tied to its launch by the trace's correlation id,
    and the launch must fall inside a host-side candidate-pass range."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    ranges = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                    if e.get("name") == "kpynq/candidate_pass"
                    and e.get("cat") == "user_annotation")
    names = sorted({e.get("name") for e in events
                    if str(e.get("name", "")).startswith("kpynq/")})
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
    kernels_ = [e for e in events if e.get("cat") == "kernel"
                and re.search(r"\bga_kernel\b", e.get("name", ""))]
    inside = 0
    for e in kernels_:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is not None and any(lo <= ts <= hi for lo, hi in ranges):
            inside += 1
    return len(kernels_), inside, names


def obs_phase(dev, points, init, fit_kw, trace_dir):
    """Phase 11: the fit with observability on against off at
    uci-xlarge: bits, ``host_syncs``, the drained ring's exact evals, the
    live drain, a profiled fit's ``kpynq/*`` ranges around
    ``ga_kernel``, the registry's export, and the times in turns."""
    import torch

    from repro_torch.core import engine
    from repro_torch.core.api import KMeans
    from repro_torch.obs import (MetricsRegistry, ObsConfig,
                                 add_ring_listener, profile,
                                 remove_ring_listener)
    from repro_torch.obs.ring import COL_EVALS, N_COUNTERS

    k = init.shape[0]
    reg = MetricsRegistry()
    kw = dict(max_iters=fit_kw["max_iters"], tol=fit_kw["tol"])

    def km_fit(on):
        km_ = KMeans(k, algorithm="yinyang", engine="auto", seed=0,
                     obs=ObsConfig(registry=reg) if on else None,
                     device=dev, **kw)
        sync()
        t0 = time.perf_counter()
        km_.fit(points)
        sync()
        return km_, time.perf_counter() - t0

    # in turns: off, on, on, off
    turns = [(on,) + km_fit(on) for on in (False, True, True, False)]
    km_off, km_on = turns[0][1], turns[1][1]
    r_off, r_on = km_off.result_, km_on.result_
    s_off, s_on = km_off.stats_, km_on.stats_
    check(torch.equal(r_off.assignments, r_on.assignments)
          and r_off.n_iters == r_on.n_iters
          and int(r_off.distance_evals) == int(r_on.distance_evals)
          and float(r_off.inertia) == float(r_on.inertia),
          "obs: the fit with obs on differs from the fit with obs off")
    check(s_off.host_syncs == s_on.host_syncs,
          f"obs: host_syncs {s_on.host_syncs} with obs on, "
          f"{s_off.host_syncs} off")
    ring = s_on.ring
    evals = int(r_on.distance_evals)
    check(ring is not None and ring.shape == (r_on.n_iters + 1, N_COUNTERS),
          f"obs: the drained ring is {None if ring is None else ring.shape}"
          f", not ({r_on.n_iters + 1}, {N_COUNTERS})")
    ring_total = int(s_on.init_evals) + int(ring[:, COL_EVALS].sum())
    check(ring_total == evals and float(ring[:, COL_EVALS].sum()).is_integer(),
          f"obs: init_evals + ring evals = {ring_total}, distance_evals "
          f"{evals}")
    log(f"obs: KMeans fits in turns (off, on, on, off) "
        f"{[round(t, 4) for _, _, t in turns]} s; bits, n_iters "
        f"{r_on.n_iters}, distance_evals {evals} and host_syncs "
        f"{s_on.host_syncs} equal; ring {ring.shape} float64, init_evals "
        f"{int(s_on.init_evals)} + ring evals {int(ring[:, COL_EVALS].sum())}"
        f" = distance_evals exactly; largest row {ring[:, COL_EVALS].max():.0f}"
        f" (2^24 = {2 ** 24})")
    # the engine fit alone (phase 4's init), in turns: off, on, on, off
    eturns = []
    for on in (False, True, True, False):
        sync()
        t0 = time.perf_counter()
        engine.fit(points, init, obs=ObsConfig(registry=reg) if on else None,
                   **fit_kw)
        sync()
        eturns.append((on, time.perf_counter() - t0))
    e_off = statistics.mean(t for on, t in eturns if not on)
    e_on = statistics.mean(t for on, t in eturns if on)
    log(f"obs: engine.fit in turns (off, on, on, off) "
        f"{[round(t, 4) for _, t in eturns]} s: off {e_off:.4f}, on "
        f"{e_on:.4f} ({e_on / e_off - 1:+.2%})")

    # the live drain: every iteration's row, from the loop's own read
    rows = []

    def listen(it, row):
        rows.append((it, list(row)))
    add_ring_listener(listen)
    try:
        r_live, s_live = engine.fit(
            points, init, obs=ObsConfig(registry=reg, live_drain=True),
            return_stats=True, **fit_kw)
    finally:
        remove_ring_listener(listen)
    check([it for it, _ in rows] == list(range(r_live.n_iters + 1))
          and all(r == list(s_live.ring[i]) for i, r in rows),
          f"obs: the live drain delivered {len(rows)} rows, not the "
          f"{r_live.n_iters + 1} of the drained ring")
    log(f"obs: live drain delivered {len(rows)} rows, each the drained "
        f"ring's, host_syncs {s_live.host_syncs}")

    # a profiled fit: the kpynq/* ranges around the candidate pass kernel
    (res_p, _), trace = profile(engine.fit, points, init,
                                obs=ObsConfig(registry=reg),
                                return_stats=True, trace_dir=trace_dir,
                                registry=reg, **fit_kw)
    n_ga, inside, names = ga_inside_candidate_pass(trace)
    size_mb = Path(trace).stat().st_size / 2 ** 20
    log(f"obs: profiled fit trace {size_mb:.1f} MB, ranges {names}; "
        f"{inside} of {n_ga} ga_kernel launches inside "
        f"kpynq/candidate_pass")
    for nm in ("kpynq/candidate_pass", "kpynq/move_and_bounds",
               "kpynq/ring_write"):
        check(nm in names, f"obs: no {nm} range in the profiled fit")
    check(n_ga >= res_p.n_iters and inside == n_ga,
          f"obs: {inside} of {n_ga} ga_kernel launches inside "
          f"kpynq/candidate_pass")
    Path(trace).unlink()
    text = reg.to_prometheus()
    check("engine_fits_total" in text, "obs: no engine_fits_total exported")
    fits = sum(m.value for m in reg.metrics()
               if m.name == "engine_fits_total")
    log(f"obs: registry {len(reg.metrics())} metrics, {len(reg.events)} "
        f"events, engine_fits_total {fits:.0f}")
    return dict(km_turns_s=[[on, t] for on, _, t in turns],
                engine_turns_s=[[on, t] for on, t in eturns],
                engine_off_s=e_off, engine_on_s=e_on,
                n_iters=r_on.n_iters, distance_evals=evals,
                host_syncs=s_on.host_syncs, init_evals=int(s_on.init_evals),
                ring_rows=int(ring.shape[0]),
                ring_max_row_evals=float(ring[:, COL_EVALS].max()),
                live_rows=len(rows), trace_mb=size_mb,
                ga_in_candidate_pass=[inside, n_ga], ranges=names,
                engine_fits_total=fits)


def tune_phase(dev, points, init, fit_kw, wide):
    """Phase 12: the measured search at uci-xlarge into the fresh cache,
    ``fit(tune="auto")`` hitting its winner, ``tune="force"`` not
    searching again, the ``tile_n`` lattice bit for bit, and the grid's
    backends on the converging uci-wide cell. ``wide`` is ``(points,
    init, kernel fit, tie counter)`` from phase 9."""
    import torch

    from repro_torch import tune
    from repro_torch.core import engine
    from repro_torch.core.engine import EngineConfig

    n, d = points.shape
    k = init.shape[0]
    cache = tune.default_cache()
    sig = tune.signature(n, k, d, tune.platform_name(dev))
    check(cache.path == os.environ[tune.ENV_VAR] and cache.lookup(sig) is None,
          f"tune: the cache {cache.path} is not the fresh one, or holds "
          f"{sig} already")
    kw = dict(max_iters=fit_kw["max_iters"], tol=fit_kw["tol"])
    measure = tune.timing_measure(points, init, repeats=2, device=dev, **kw)
    measured = []

    def logged(cfg):
        t = measure(cfg)
        measured.append((cfg.to_dict(), t))
        log(f"tune: {cfg.backend:8s} {t * 1e3:9.2f} ms  {cfg.to_dict()}")
        return t
    t0 = time.perf_counter()
    best = tune.autotune(points, init, measure=logged, repeats=2,
                         max_measurements=10, device=dev, **kw)
    tune_s = time.perf_counter() - t0
    entry = cache.entry(sig)
    log(f"tune: {len(measured)} configs in {tune_s:.2f} s; winner "
        f"{best.backend} {entry['ms']:.2f} ms (lloyd {entry['lloyd_ms']:.2f}"
        f" ms) {best.to_dict()}")
    check(len(measured) <= 10 and tune.lookup(
        n=n, k=k, d=d, platform=tune.platform_name(dev)) == best,
          "tune: the winner is not stored under its signature")

    _, s_auto = engine.fit(points, init, tune="auto", return_stats=True,
                           device=dev, **kw)
    check(s_auto.config == best.to_dict(),
          f"tune: fit(tune='auto') ran {s_auto.config}, not the winner")

    def no_search(*a, **k_):
        fail("tune: fit(tune='force') searched again on a cache hit")
    saved = tune.search.autotune
    tune.search.autotune = no_search
    try:
        _, s_force = engine.fit(points, init, tune="force",
                                return_stats=True, device=dev, **kw)
    finally:
        tune.search.autotune = saved
    check(s_force.config == best.to_dict(),
          "tune: fit(tune='force') did not take the stored winner")

    # the kernel backend's tile_n lattice: the same bits
    lattice = {}
    for tn in tune.search.KNOB_LATTICE["tile_n"]:
        sync()
        t1 = time.perf_counter()
        r = engine.fit(points, init, config=EngineConfig(
            backend="kernel", tile_n=tn), tune="off", device=dev, **kw)
        sync()
        lattice[tn] = (r, time.perf_counter() - t1)
    r0 = lattice[256][0]
    for tn, (r, t) in lattice.items():
        log(f"tune: kernel tile_n={tn}: {t:.3f} s, n_iters {r.n_iters}, "
            f"distance_evals {int(r.distance_evals)}, inertia "
            f"{float(r.inertia):.9g}")
        check(torch.equal(r.assignments, r0.assignments)
              and r.n_iters == r0.n_iters
              and float(r.inertia) == float(r0.inertia),
              f"tune: tile_n={tn} changed labels, n_iters or inertia")

    # the grid's backends on the converging cell: Lloyd against phase 9
    wpts, winit, wk_fit, count_ties = wide
    wl = engine.fit(wpts, winit, backend="lloyd", tune="off", device=dev,
                    max_iters=fit_kw["max_iters"], tol=fit_kw["tol"])
    check(wl.n_iters == wk_fit.n_iters, f"tune: uci-wide lloyd n_iters "
          f"{wl.n_iters} != kernel {wk_fit.n_iters}")
    check(abs(float(wl.inertia) - float(wk_fit.inertia))
          <= 1e-5 * float(wk_fit.inertia),
          "tune: uci-wide lloyd inertia differs beyond rtol 1e-5")
    wties = count_ties(wl.assignments)
    log(f"tune: uci-wide lloyd converges with the kernel and compact fits "
        f"in {wl.n_iters} iterations, labels equal but {wties} fp32 ties")
    return dict(signature=sig, winner=best.to_dict(),
                winner_ms=entry["ms"], lloyd_ms=entry["lloyd_ms"],
                measured=[[c, t] for c, t in measured], tune_s=tune_s,
                tile_n={tn: dict(s=t, n_iters=r.n_iters,
                                 distance_evals=int(r.distance_evals))
                        for tn, (r, t) in lattice.items()},
                uci_wide_lloyd_ties=wties)


def exact_labels(queries, cents, chunk=1 << 16):
    """The fp64 yardstick: argmin of the float64 distances to ``cents``
    (ties to the lower index)."""
    import torch
    c = cents.double()
    c2 = (c * c).sum(1)
    labels = []
    for lo in range(0, queries.shape[0], chunk):
        x = queries[lo:lo + chunk].double()
        labels.append(torch.argmin(
            (x * x).sum(1)[:, None] - 2.0 * (x @ c.T) + c2[None], dim=1))
    return torch.cat(labels).cpu().numpy()


def near_ties(x, c64, got, want):
    """Rows whose served label ``got`` is not the yardstick's ``want``,
    measured in float64: ``(rel, norm)``, the relative gap of the two
    distances, ``(d_got - d_want) / d_got``, and the gap of the squared
    distances over phase 2b's fp32 rounding scale, ``1e-5 * (||x||^2 +
    max ||c||^2)`` (the expanded form ``x2 - 2 x.c + c2`` loses bits
    against the norms, not against the distance)."""
    x = x.astype(np.float64)
    d_got = ((x - c64[got]) ** 2).sum(1)
    d_want = ((x - c64[want]) ** 2).sum(1)
    rel = (np.sqrt(d_got) - np.sqrt(d_want)) / np.sqrt(d_got)
    norm = (d_got - d_want) / (1e-5 * ((x * x).sum(1)
                                       + (c64 * c64).sum(1).max()))
    return rel, norm


SERVE_MIX = dict(max_request=4096, clients=4, jumbo=20_000)


def serve_index_phase(dev, wrappers, centroids, queries_np, queries_dev,
                      seed=0):
    """Phase 13: the fitted centroids behind a ``ServeEngine`` on each
    backend: 2^20 query points in a fixed mix (requests of 1 to 4096
    points from a seeded generator, 4 client threads, one jumbo request
    split by the engine, one request as a CUDA tensor), republished
    midway under and over the rebuild threshold; every request's labels
    against its epoch's fp64 yardstick, the launches, points/s and
    latency, a traced batch, and the serve tuner."""
    import threading

    import torch

    from repro_torch import tune
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import CentroidIndex, ServeEngine
    from repro_torch.tune import ServeConfig

    n, d = queries_np.shape
    k = centroids.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    c0 = centroids.to(dev).float()
    scale = float(torch.sqrt((c0 * c0).sum(1).mean()))
    cfg0 = ServeConfig()
    # two republishes: a drift under the rebuild threshold, then over it
    c1 = c0 + 0.01 * scale / math.sqrt(d) * torch.randn(
        c0.shape, generator=gen, device=dev)
    c2 = c1 + 0.3 * scale / math.sqrt(d) * torch.randn(
        c0.shape, generator=gen, device=dev)
    drift1 = (c1 - c0).norm(dim=1).double().cpu().numpy()
    drift2 = drift1 + (c2 - c1).norm(dim=1).double().cpu().numpy()
    epochs = {1: c0, 2: c1, 3: c2}
    t0 = time.perf_counter()
    refs = {ep: exact_labels(queries_dev, c) for ep, c in epochs.items()}
    cents64 = {ep: c.double().cpu().numpy() for ep, c in epochs.items()}
    sync()
    log(f"serve-index: fp64 yardstick labels of 2^{int(math.log2(n))} "
        f"queries for 3 epochs in {time.perf_counter() - t0:.2f} s; "
        f"drifts {drift1.max() / scale:.4f} and {drift2.max() / scale:.4f} "
        f"of the centroids' scale {scale:.4g} (threshold "
        f"{cfg0.rebuild_threshold})")

    # the fixed mix: the jumbo first, the CUDA tensor next, then random
    # sizes to 2^20 points, dealt round-robin to the client threads
    rng = np.random.default_rng(seed)
    reqs = [(0, SERVE_MIX["jumbo"], "jumbo"),
            (SERVE_MIX["jumbo"], 4096, "tensor")]
    lo = SERVE_MIX["jumbo"] + 4096
    while lo < n:
        m = min(int(rng.integers(1, SERVE_MIX["max_request"] + 1)), n - lo)
        reqs.append((lo, m, "host"))
        lo += m
    rest = reqs[2:]
    shares = [rest[i::SERVE_MIX["clients"]]
              for i in range(SERVE_MIX["clients"])]
    out = {}
    for backend in ("fused", "grouped", "kernel"):
        reg = MetricsRegistry()
        index = CentroidIndex(device=dev, obs=reg)
        index.publish(c0, cum_drift=np.zeros(k))
        cfg = ServeConfig(backend=backend)
        results, lat = {}, []
        lat_lock = threading.Lock()
        reset_launches(wrappers)
        publish_cu = 0
        sync()
        with ServeEngine(index, config=cfg, tune="off", obs=reg) as eng:
            t_start = time.perf_counter()

            def submit(lo_, m_, kind):
                block = queries_dev[lo_:lo_ + m_] if kind == "tensor" \
                    else queries_np[lo_:lo_ + m_]
                t_sub = time.perf_counter()
                fut = eng.submit(block)
                return fut, t_sub

            def client(share):
                mine = [(lo_, m_) + submit(lo_, m_, kind)
                        for lo_, m_, kind in share]
                for lo_, m_, fut, t_sub in mine:
                    res = fut.result(timeout=600)
                    with lat_lock:
                        results[(lo_, m_)] = res
                        lat.append(time.perf_counter() - t_sub)

            head = [(lo_, m_) + submit(lo_, m_, kind)
                    for lo_, m_, kind in reqs[:2]]
            threads = [threading.Thread(target=client, args=(s,))
                       for s in shares]
            for t in threads:
                t.start()
            published = []
            # the jumbo's parts may span batches: it reports its first
            # part's epoch, so no publish lands before it is whole
            head[0][2].result(timeout=600)
            for frac, c_new, drift in ((1 / 3, c1, drift1),
                                       (2 / 3, c2, drift2)):
                while eng.points < frac * n and any(t.is_alive()
                                                    for t in threads):
                    time.sleep(0.0005)
                before = wrappers["centroid_update"].launches
                published.append(index.publish(c_new, cum_drift=drift))
                publish_cu += wrappers["centroid_update"].launches - before
            for lo_, m_, fut, t_sub in head:
                results[(lo_, m_)] = fut.result(timeout=600)
                lat.append(time.perf_counter() - t_sub)
            for t in threads:
                t.join()
            wall = time.perf_counter() - t_start
            batches, served = eng.batches, eng.points
            swaps = eng.epoch_swaps
            launches = read_launches(wrappers)
            launches["centroid_update"] -= publish_cu
            # one traced batch: a full bucket through the running engine
            block = queries_np[:cfg.max_batch]
            eng.assign(block)
            trace = traced(lambda: eng.assign(block),
                           f"serve-index {backend}: traced batch of "
                           f"{cfg.max_batch}")
        check(served == n and len(results) == len(reqs),
              f"serve-index {backend}: served {served} points in "
              f"{len(results)} requests, not {n} in {len(reqs)}")
        check(index.rebuilds == 2 and index.reuses == 1,
              f"serve-index {backend}: {index.rebuilds} rebuilds and "
              f"{index.reuses} reuses, not 2 and 1 (publish, reuse, rebuild)")
        # every request against the yardstick of the epoch it reports
        per_epoch, rels, norms = {}, [], []
        for (lo_, m_), res in results.items():
            check(res.labels.shape == (m_,), f"serve-index {backend}: "
                  f"{res.labels.shape} labels for {m_} points")
            ref = refs[res.epoch]
            bad = np.nonzero(res.labels != ref[lo_:lo_ + m_])[0]
            if len(bad):
                rel, norm = near_ties(queries_np[lo_ + bad],
                                      cents64[res.epoch], res.labels[bad],
                                      ref[lo_ + bad])
                rels.append(rel)
                norms.append(norm)
            per_epoch[res.epoch] = per_epoch.get(res.epoch, 0) + m_
        rels = np.concatenate(rels) if rels else np.zeros(0)
        norms = np.concatenate(norms) if norms else np.zeros(0)
        ties = len(rels)
        over_rel = int((rels >= 1e-5).sum())
        tie_note = (f"{ties} labels apart from the fp64 yardstick, "
                    f"{over_rel} of them at a relative distance gap of "
                    f"1e-5 or more (largest {rels.max() if ties else 0:.3g}),"
                    f" largest squared gap {norms.max() if ties else 0:.3g}"
                    f" of phase 2b's fp32 scale")
        log(f"serve-index {backend}: {tie_note}")
        # a mismatch must be an fp32 near-tie: within phase 2b's tie
        # rule, twice the rounding scale of the expanded form
        check(bool(np.all(norms <= 2.0)), f"serve-index {backend}: labels "
              f"differ from the fp64 yardstick off an fp32 near-tie: "
              f"{tie_note}")
        check(set(per_epoch) == {1, 2, 3},
              f"serve-index {backend}: epochs served {sorted(per_epoch)}")
        served_launches = {nm: c for nm, c in launches.items() if c}
        if backend == "kernel":
            check(launches["grouped_assign"] == batches and
                  set(served_launches) == {"grouped_assign"},
                  f"serve-index kernel: launches {served_launches} for "
                  f"{batches} batches")
        else:
            check(not served_launches, f"serve-index {backend}: port "
                  f"kernels launched {served_launches}")
        hist = reg.histogram("serve_latency_seconds")
        lat.sort()
        rep = dict(backend=backend, points=served, requests=len(results),
                   batches=batches, epoch_swaps=swaps, wall_s=wall,
                   points_per_s=served / wall, points_by_epoch=per_epoch,
                   near_ties=ties, near_ties_rel_1e5_or_more=over_rel,
                   near_tie_max_rel=float(rels.max()) if ties else 0.0,
                   near_tie_max_norm=float(norms.max()) if ties else 0.0,
                   launches=launches,
                   publish_centroid_update_launches=publish_cu,
                   latency_p50_s=_quantile(lat, 0.5),
                   latency_p99_s=_quantile(lat, 0.99),
                   hist_p50_le_s=hist_quantile(hist, 0.5),
                   hist_p99_le_s=hist_quantile(hist, 0.99),
                   fill_mean=reg.histogram("serve_batch_fill").mean,
                   trace=trace)
        log(f"serve-index {backend}: {served} points in {len(results)} "
            f"requests, {batches} batches, {wall:.3f} s wall, "
            f"{served / wall:.4g} points/s; latency p50 "
            f"{rep['latency_p50_s'] * 1e3:.2f} ms, p99 "
            f"{rep['latency_p99_s'] * 1e3:.2f} ms (registry histogram: "
            f"p50 <= {rep['hist_p50_le_s']} s, p99 <= "
            f"{rep['hist_p99_le_s']} s); mean fill {rep['fill_mean']:.3f}; "
            f"points by epoch {per_epoch}; {ties} near-ties; serving "
            f"launches {served_launches}, publishes' centroid_update "
            f"{publish_cu}")
        out[backend] = rep

    # the serve tuner into the fresh cache
    grid = []
    t0 = time.perf_counter()
    best = tune.autotune_serve(k=k, d=d, device=dev, grid=grid)
    tsec = time.perf_counter() - t0
    for c_, t_ in grid:
        log(f"serve-tune: {c_.backend:8s} chunk {c_.chunk:5d} "
            f"{t_ * 1e3:8.3f} ms a bucket of {c_.max_batch}")
    check(tune.lookup_serve(k=k, d=d, platform=tune.platform_name(dev))
          == best, "serve-tune: the winner is not stored")
    log(f"serve-tune: winner {best.backend} chunk {best.chunk} "
        f"({len(grid)} candidates, {tsec:.2f} s)")
    out["tune"] = dict(grid=[[c_.to_dict(), t_] for c_, t_ in grid],
                       winner=best.to_dict(), seconds=tsec)
    return out


# -- phase 14: streaming k-means with carried bounds -------------------------

STREAM = dict(shard=65_536, epochs=3, publish_every=4, queries=65_536,
              request=4096)


def stream_estimator(dev, k, n_groups, shard, obs=None):
    """Phases 14 and 15's estimator: decay 1.0, the cold start from one
    shard, seed 0."""
    from repro_torch.streaming import StreamingKMeans
    return StreamingKMeans(k, n_groups=n_groups, decay=1.0,
                           init_size=shard, seed=0, obs=obs, device=dev)


def stream_phase(dev, wrappers, pts_np, plain_versions, fit_kw, k,
                 n_groups, shard=STREAM["shard"], epochs=STREAM["epochs"]):
    """Phase 14: ``StreamingKMeans`` over uci-xlarge's points in shards
    of ``shard`` (16 at full size), ``epochs`` passes, decay 1.0, the
    cold start from one shard, a ``CentroidIndex`` attached (a publish
    every 4 batches): counts reset just before the stream and read just
    after it, ``predict`` and ``inertia_of``; epochs 2+ all cache hits;
    points/s and ``distance_evals`` against N*K per epoch; the final
    inertia over the batch fit's from the same seeds; the same stream
    through the plain versions (first batch's labels equal, inertia
    within 1e-3); the index served against an fp64 yardstick (phase
    13's near-tie rule); one traced warm batch and one traced cold one.
    Returns the report and the stream's final state (centroids, counts
    and both ledger arrays, taken before the traced batches), phase
    15's yardstick."""
    import torch

    from repro_torch.core import engine
    from repro_torch.data import PointStream
    from repro_torch.serve import CentroidIndex, ServeEngine
    from repro_torch.tune import ServeConfig

    n, d = pts_np.shape
    stream = PointStream(shard_size=shard, data=pts_np)
    n_shards = stream.n_shards

    def estimator():
        return stream_estimator(dev, k, n_groups, shard)

    def run(est, index=None):
        """The stream, epoch by epoch: (first batch's labels, per-epoch
        records)."""
        if index is not None:
            est.attach_index(index, every=STREAM["publish_every"])
        first, per_epoch = None, []
        for ep in range(epochs):
            st = est.stats_
            ev0, hits0, miss0 = st.distance_evals, st.cache_hits, \
                st.cache_misses
            t0 = time.perf_counter()
            for sid, pts in stream.batches(1):
                est.partial_fit(pts, shard_id=sid)
                if first is None and est.initialized:
                    first = est.labels_.copy()
            sync()
            dt = time.perf_counter() - t0
            per_epoch.append(dict(
                seconds=dt, points_per_s=n / dt,
                distance_evals=st.distance_evals - ev0,
                evals_vs_nk=(st.distance_evals - ev0) / (n * k),
                cache_hits=st.cache_hits - hits0,
                cache_misses=st.cache_misses - miss0))
        return first, per_epoch

    index = CentroidIndex(device=dev)
    est = estimator()
    reset_launches(wrappers)
    sync()
    first, per_epoch = run(est, index)
    final = dict(centroids=est._centroids.clone(),
                 counts=est._counts.clone(),
                 ledger_centroid=est._ledger.centroid.copy(),
                 ledger_group=est._ledger.group.copy(), first=first,
                 distance_evals=est.stats_.distance_evals)
    t0 = time.perf_counter()
    labels = est.predict(pts_np)
    inertia = est.inertia_of(pts_np)
    sync()
    predict_s = time.perf_counter() - t0
    launches = read_launches(wrappers)
    st = est.stats_
    stats = st.to_dict()
    for ep, rec in enumerate(per_epoch, 1):
        log(f"stream epoch {ep}: {rec['seconds']:.3f} s, "
            f"{rec['points_per_s']:.4g} points/s, distance_evals "
            f"{rec['distance_evals']:.0f} = {rec['evals_vs_nk']:.4f} of "
            f"N*K, cache hits {rec['cache_hits']}, misses "
            f"{rec['cache_misses']}")
    log(f"stream: {st.batches} batches, {st.cache_hits} hits, "
        f"{st.cache_misses} misses, {st.drift_resets} drift resets, "
        f"{st.reseeds} reseeds, distance_evals {st.distance_evals:.0f}, "
        f"inertia {inertia:.9g}, predict + inertia_of {predict_s:.3f} s; "
        f"launches {launches}; index: {index.publishes} publishes, "
        f"{index.rebuilds} rebuilds, {index.reuses} reuses")
    check(st.batches == epochs * n_shards and st.cache_misses == n_shards
          and st.cache_hits == (epochs - 1) * n_shards
          and st.drift_resets == 0,
          f"stream: {st.batches} batches, {st.cache_hits} hits, "
          f"{st.cache_misses} misses, {st.drift_resets} drift resets: "
          f"epochs 2+ are not all cache hits")
    check(launches["centroid_update"] >= st.batches,
          f"stream: centroid_update launched {launches['centroid_update']} "
          f"times for {st.batches} batches")
    check(launches["grouped_assign"] >= 2, "stream: predict and inertia_of "
          "did not launch grouped_assign")
    for nm in ("pairwise_sq_dists", "filtered_assign"):
        check(launches[nm] == 0, f"stream: {nm} launched {launches[nm]}")
    cents = est._centroids
    check(tuple(cents.shape) == (k, d) and bool(torch.isfinite(cents).all())
          and math.isfinite(inertia) and labels.shape == (n,)
          and labels.min() >= 0 and labels.max() < k,
          "stream: non-finite or misshapen centroids, inertia or labels")
    check(index.publishes == st.batches // STREAM["publish_every"],
          f"stream: {index.publishes} publishes for {st.batches} batches")

    # the batch fit from the stream's own seeds
    seeds = est._seed_centroids(torch.from_numpy(stream.shard(0)).to(dev),
                                None)
    t0 = time.perf_counter()
    r_b = engine.fit(torch.from_numpy(pts_np).to(dev), seeds, **fit_kw)
    sync()
    batch_s = time.perf_counter() - t0
    ratio = inertia / float(r_b.inertia)
    log(f"stream inertia {inertia:.9g} over the batch fit's "
        f"{float(r_b.inertia):.9g} from the same seeds ({r_b.n_iters} "
        f"iterations, {batch_s:.3f} s): {ratio:.6f}")
    check(ratio < 1.05, f"stream inertia {ratio:.4f}x the batch fit's")

    # the same stream through the plain versions
    with plain_versions():
        p_est = estimator()
        t0 = time.perf_counter()
        p_first, p_epochs = run(p_est)
        p_inertia = p_est.inertia_of(pts_np)
        sync()
        plain_s = time.perf_counter() - t0
    rel = abs(inertia - p_inertia) / p_inertia
    log(f"stream through the plain versions: {plain_s:.3f} s, first "
        f"batch's labels {'equal' if np.array_equal(first, p_first) else 'DIFFER'}"
        f", inertia {p_inertia:.9g} (rel {rel:.3g}), distance_evals "
        f"{p_est.stats_.distance_evals:.0f}, centroids max err "
        f"{float((p_est._centroids - cents).abs().max()):.3g}")
    check(np.array_equal(first, p_first), "stream: the first batch's labels "
          "differ between the kernels and their plain versions")
    check(rel <= 1e-3, f"stream: inertia of the plain route {rel:.3g} apart")

    # the served index: the last publish is the stream's final centroids
    snap = index.acquire()
    check(torch.equal(snap.centroids, cents), "stream: the index does not "
          "hold the stream's last centroids")
    queries = stream.shard(0)[:STREAM["queries"]]
    ref = exact_labels(torch.from_numpy(queries).to(dev), cents)
    c64 = cents.double().cpu().numpy()
    with ServeEngine(index, config=ServeConfig(backend="kernel"),
                     tune="off") as eng:
        futs = [(lo, eng.submit(queries[lo:lo + STREAM["request"]]))
                for lo in range(0, len(queries), STREAM["request"])]
        served = {lo: f.result(timeout=600) for lo, f in futs}
    got = np.concatenate([served[lo].labels for lo, _ in futs])
    check({r.epoch for r in served.values()} == {snap.epoch},
          "stream: a request was served from another epoch")
    bad = np.nonzero(got != ref)[0]
    norms = near_ties(queries[bad], c64, got[bad], ref[bad])[1] \
        if len(bad) else np.zeros(0)
    log(f"stream index: {len(queries)} queries at epoch {snap.epoch}, "
        f"{len(bad)} labels apart from the fp64 yardstick, largest squared "
        f"gap {norms.max() if len(bad) else 0:.3g} of phase 2b's scale")
    check(bool(np.all(norms <= 2.0)), "stream index: labels differ from the "
          "fp64 yardstick off an fp32 near-tie")

    # where a batch's time goes: a warm batch on the host's clock by
    # function (cProfile), then a warm and a cold one traced
    import cProfile
    import pstats
    est.attach_index(None)
    shard1 = stream.shard(1)
    prof = cProfile.Profile()
    prof.runcall(lambda: (est.partial_fit(shard1, shard_id=1), sync()))
    host = sorted(((fn[2], fn[0].rsplit("/", 1)[-1], fn[1], row[2], row[3])
                   for fn, row in pstats.Stats(prof).stats.items()),
                  key=lambda r: -r[3])[:12]
    log(f"stream: a warm batch's host time by function, "
        f"{pstats.Stats(prof).total_tt * 1e3:.2f} ms (own ms, cumulative "
        f"ms):")
    for name_, file_, line_, own, cum in host:
        log(f"  {own * 1e3:8.3f} {cum * 1e3:8.3f}  {name_} ({file_}:{line_})")
    warm = traced(lambda: est.partial_fit(shard1, shard_id=1),
                  "stream: traced warm batch")
    cold = traced(lambda: est.partial_fit(stream.shard(1),
                                          shard_id="cold"),
                  "stream: traced cold batch")
    return dict(n=n, d=d, k=k, n_groups=n_groups, shard=shard,
                n_shards=n_shards, epochs=per_epoch, stats=stats,
                inertia=inertia, batch_fit_inertia=float(r_b.inertia),
                batch_fit_iters=r_b.n_iters, inertia_ratio=ratio,
                predict_s=predict_s, launches=launches,
                plain=dict(seconds=plain_s, inertia=p_inertia, rel=rel,
                           epochs=p_epochs,
                           distance_evals=p_est.stats_.distance_evals),
                index=dict(publishes=index.publishes,
                           rebuilds=index.rebuilds, reuses=index.reuses,
                           near_ties=len(bad)),
                host_warm=[list(r) for r in host], trace_warm=warm,
                trace_cold=cold), final


# -- phase 15: the resilient stream: checkpoints, restore and replay ---------

# ckpt_every batches a checkpoint; the chaos run's three faults, each at
# a schedule step: a FailureInjector failure off the checkpoint lattice,
# a tear mid-batch (chaos_hook) and a crash onto a torn newest
# checkpoint; the cold restart's failure before any checkpoint
RESILIENT = dict(ckpt_every=8, fail_at=13, tear_at=21, corrupt_at=35,
                 cold_fail_at=5)


def resilient_phase(dev, wrappers, pts_np, k, n_groups, yardstick,
                    stream_pps, shard=STREAM["shard"],
                    epochs=STREAM["epochs"]):
    """Phase 15: ``fit_stream(resilient=True)`` with phase 14's
    arguments (uci-xlarge as shards of ``shard``, ``epochs`` passes),
    async checkpoints every 8 batches into a temporary directory removed
    afterwards. One run survives a ``FailureInjector`` failure off the
    lattice, a tear mid-batch through ``chaos_hook`` and a crash onto a
    newest checkpoint whose ``shard_0.npz`` was torn: 3 restores, batches
    replayed, and centroids, counts and both ledger arrays bit for bit
    ``yardstick`` (phase 14's uninterrupted stream); counts reset just
    before it and read just after it, ``predict`` and ``inertia_of``
    (``centroid_update`` once a batch run, replays included). Then a
    ``StreamingKMeans.restore`` from a 2-epoch resilient run's terminal
    checkpoint streamed on to ``epochs`` (restores 1, replays 0) and a
    cold restart from a failure before any checkpoint, both bit for bit.
    Logs the bytes of one checkpoint, the snapshot seconds
    (``ckpt_save_seconds``), the seconds of one ``restore_state`` and the
    points/s against phase 14's ``stream_pps``."""
    import torch

    from repro_torch.checkpoint import latest_step
    from repro_torch.data import PointStream
    from repro_torch.obs import MetricsRegistry
    from repro_torch.runtime import FailureInjector, InjectedFailure
    from repro_torch.streaming import StreamingKMeans

    n = len(pts_np)
    stream = PointStream(shard_size=shard, data=pts_np)
    n_steps = epochs * stream.n_shards
    every = RESILIENT["ckpt_every"]

    def same_bits(est, label):
        y = yardstick
        gaps = (float((est._centroids - y["centroids"]).abs().max()),
                float((est._counts - y["counts"]).abs().max()),
                float(np.abs(est._ledger.centroid
                             - y["ledger_centroid"]).max()),
                float(np.abs(est._ledger.group - y["ledger_group"]).max()))
        same = (torch.equal(est._centroids, y["centroids"])
                and torch.equal(est._counts, y["counts"])
                and np.array_equal(est._ledger.centroid,
                                   y["ledger_centroid"])
                and np.array_equal(est._ledger.group, y["ledger_group"]))
        log(f"{label}: {'bit for bit' if same else 'NOT bit for bit'} the "
            f"uninterrupted stream (max abs gaps of centroids, counts, "
            f"ledger centroid and group {gaps})")
        check(same, f"{label}: centroids, counts or ledger differ from the "
              f"uninterrupted stream's")

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_resilient_"))
    try:
        # -- the chaos run: three faults, three restores ------------------
        ckpt = root / "chaos"
        fired = {}

        def chaos(est, sid):
            step = est.stats_.batches        # the schedule step under way
            if step == RESILIENT["tear_at"] and "tear" not in fired:
                fired["tear"] = step
                raise InjectedFailure("torn mid-batch")
            if step == RESILIENT["corrupt_at"] and "corrupt" not in fired:
                newest = step // every * every
                t_wait = time.perf_counter()
                while latest_step(ckpt) != newest:   # its writer's publish
                    check(time.perf_counter() - t_wait < 120,
                          f"resilient: step {newest} was never published")
                    time.sleep(0.01)
                (ckpt / f"step_{newest:06d}" / "shard_0.npz").write_bytes(
                    b"torn write")
                fired["corrupt"] = newest
                raise InjectedFailure("crash onto a torn checkpoint")

        reg = MetricsRegistry()
        est = stream_estimator(dev, k, n_groups, shard, obs=reg)
        est.chaos_hook = chaos
        inj = FailureInjector(fail_at=(RESILIENT["fail_at"],))
        reset_launches(wrappers)
        sync()
        t0 = time.perf_counter()
        est.fit_stream(stream, epochs=epochs, resilient=True, ckpt_dir=ckpt,
                       ckpt_every=every, injector=inj)
        sync()
        chaos_s = time.perf_counter() - t0
        est.chaos_hook = None
        labels = est.predict(pts_np)
        inertia = est.inertia_of(pts_np)
        sync()
        launches = read_launches(wrappers)
        st = est.stats_
        replayed = st.replayed_batches
        m = reg.to_dict()
        saves = m["ckpt_save_seconds"]
        step_dir = ckpt / f"step_{n_steps:06d}"
        nbytes = sum(f.stat().st_size for f in step_dir.iterdir())
        runs = n_steps + replayed
        log(f"resilient: {st.restores} restores, {replayed} batches "
            f"replayed, faults {fired} and a failure at step "
            f"{RESILIENT['fail_at']} ({inj.seen}); {m['ckpt_saves_total']:.0f}"
            f" saves; {chaos_s:.3f} s; launches {launches}")
        check(st.restores == 3 and m["restore_total"] == 3,
              f"resilient: {st.restores} restores (registry "
              f"{m['restore_total']}), not 3")
        check(replayed > 0 and m["replay_batches_total"] == replayed,
              f"resilient: {replayed} batches replayed (registry "
              f"{m['replay_batches_total']})")
        check(set(fired) == {"tear", "corrupt"}
              and inj.seen == {RESILIENT["fail_at"]},
              f"resilient: faults fired {fired}, injector {inj.seen}")
        events = {e["event"] for e in reg.events}
        check({"ckpt_save", "restore"} <= events,
              f"resilient: events {sorted(events)}")
        same_bits(est, "resilient stream after 3 faults")
        check(st.batches == n_steps, f"resilient: {st.batches} batches "
              f"committed, not {n_steps}")
        check(launches["centroid_update"] >= runs,
              f"resilient: centroid_update launched "
              f"{launches['centroid_update']} times for {runs} batches run")
        check(launches["grouped_assign"] >= 2, "resilient: predict and "
              "inertia_of did not launch grouped_assign")
        for nm in ("pairwise_sq_dists", "filtered_assign"):
            check(launches[nm] == 0, f"resilient: {nm} launched "
                  f"{launches[nm]}")
        check(labels.shape == (n,) and math.isfinite(inertia),
              "resilient: misshapen labels or non-finite inertia")

        # the terminal checkpoint: its size, and one restore_state of it;
        # then a save's parts: the state's host copy alone, and a
        # synchronous save (the copy and the write)
        t0 = time.perf_counter()
        got_step = est.restore_state(ckpt)
        sync()
        restore_s = time.perf_counter() - t0
        check(got_step == n_steps, f"resilient: LATEST is {got_step}")
        same_bits(est, "the terminal checkpoint restored")
        t0 = time.perf_counter()
        est._pack_state()
        pack_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        est.save(ckpt, n_steps + 1, async_=False)
        sync_save_s = time.perf_counter() - t0
        shutil.rmtree(ckpt)
        pps = n * epochs / chaos_s
        log(f"resilient: one checkpoint {nbytes} bytes ({len(est._cache)} "
            f"cached shards); ckpt_save_seconds (the snapshot of an async "
            f"save) mean {saves['mean'] * 1e3:.2f} ms over {saves['count']}; "
            f"the state's host copy alone {pack_s * 1e3:.2f} ms, a "
            f"synchronous save {sync_save_s * 1e3:.2f} ms; "
            f"restore_state {restore_s * 1e3:.2f} ms; "
            f"{pps:.4g} points/s committed, "
            f"{runs * shard / chaos_s:.4g} run, against phase 14's "
            f"{stream_pps:.4g} ({pps / stream_pps:.3f}x)")

        # -- a resume across estimators -----------------------------------
        ckpt = root / "resume"
        two = epochs - 1
        a = stream_estimator(dev, k, n_groups, shard)
        t0 = time.perf_counter()
        a.fit_stream(stream, epochs=two, resilient=True, ckpt_dir=ckpt,
                     ckpt_every=every)
        sync()
        clean_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        b, got_step = StreamingKMeans.restore(ckpt, device=dev)
        sync()
        restore_cls_s = time.perf_counter() - t0
        check(got_step == two * stream.n_shards,
              f"resume: the terminal checkpoint is at {got_step}")
        for step in range(got_step, n_steps):
            batch = stream.global_batch(step)
            b.partial_fit(batch["points"], shard_id=batch["shard_id"])
        check(b.stats_.restores == 1 and b.stats_.replayed_batches == 0,
              f"resume: {b.stats_.restores} restores, "
              f"{b.stats_.replayed_batches} replayed")
        same_bits(b, f"restored from epoch {two}, streamed to {epochs}")
        clean_pps = n * two / clean_s
        log(f"resume: a {two}-epoch resilient run without faults "
            f"{clean_s:.3f} s, {clean_pps:.4g} points/s "
            f"({clean_pps / stream_pps:.3f}x phase 14's); "
            f"StreamingKMeans.restore {restore_cls_s * 1e3:.2f} ms")
        shutil.rmtree(ckpt)

        # -- a cold restart: the failure lands before any checkpoint ------
        ckpt = root / "cold"
        c = stream_estimator(dev, k, n_groups, shard)
        c.fit_stream(stream, epochs=epochs, resilient=True, ckpt_dir=ckpt,
                     ckpt_every=10 * n_steps,
                     injector=FailureInjector(
                         fail_at=(RESILIENT["cold_fail_at"],)))
        check(c.stats_.restores == 1
              and c.stats_.replayed_batches == RESILIENT["cold_fail_at"],
              f"cold restart: {c.stats_.restores} restores, "
              f"{c.stats_.replayed_batches} replayed")
        same_bits(c, "cold restart from step 0")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(n=n, shard=shard, epochs=epochs, ckpt_every=every,
                faults=dict(RESILIENT, fired=fired), restores=st.restores,
                replayed_batches=replayed, batches_run=runs,
                ckpt_saves=m["ckpt_saves_total"], ckpt_bytes=nbytes,
                ckpt_save_seconds=saves,
                restore_state_s=restore_s, restore_s=restore_cls_s,
                pack_s=pack_s, sync_save_s=sync_save_s,
                seconds=chaos_s, points_per_s=pps,
                clean_points_per_s=clean_pps, stream_points_per_s=stream_pps,
                launches=launches, inertia=inertia)


# -- phase 16: the sharded batch fit on torch.distributed --------------------

SHARDED = dict(world=4, uneven=1_048_573, timeout=240,
               search=dict(max_rounds=1, max_measurements=4, repeats=1))


def sharded_rank(rank, world, job):
    """One rank of a phase 16 world (``spawn_world`` runs it, each rank
    on its share of the card): the fits ``job`` names, each timed with
    the card synchronised around it; the main path (the compact fit at
    uci-xlarge) with the kernels' counts reset just before and read just
    after it. The warm fits also time the fit's own all-reduces: each
    call of ``engine._all_reduce`` (the ``Reducer``'s collective, the
    host copies under gloo included) between two synchronisations of the
    card, which its copy to the host makes anyway. That time includes
    waiting for the slowest rank. Returns rank 0's labels and
    centroids, every rank's numbers."""
    import torch
    import repro_torch.kernels as kernels
    from repro_torch.core import distributed_yinyang, engine, make_mesh
    dev = job["device"] or torch.device(
        "cuda", rank % torch.cuda.device_count())
    mesh = make_mesh(world)
    wrappers = {"grouped_assign": kernels.grouped_assign,
                "centroid_update": kernels.centroid_update}

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)

    out = {}
    all_reduce = engine._all_reduce
    spent = []

    def timed_all_reduce(x, group):
        sync()
        t = time.perf_counter()
        y = all_reduce(x, group)
        sync()
        spent.append(time.perf_counter() - t)
        return y

    def fit(name, pts, init, count=False, time_reduce=False, **kw):
        if count:
            reset_launches(wrappers)
        spent.clear()
        engine._all_reduce = timed_all_reduce if time_reduce else all_reduce
        sync()
        t0 = time.perf_counter()
        try:
            r = distributed_yinyang(pts, init, mesh, device=job["device"],
                                    **kw)
            sync()
        finally:
            engine._all_reduce = all_reduce
        res, st = r if kw.get("return_stats") else (r, None)
        e = dict(seconds=time.perf_counter() - t0, n_iters=res.n_iters,
                 evals=int(res.distance_evals), inertia=float(res.inertia),
                 device=str(res.centroids.device))
        if time_reduce:
            e.update(reduce_s=sum(spent), reduce_calls=len(spent))
        if count:
            e["launches"] = read_launches(wrappers)
        if st is not None:
            e.update(host_syncs=st.host_syncs, caps=st.caps_history,
                     shard_skew=st.shard_skew.tolist(), config=st.config)
        if rank == 0:
            e.update(labels=res.assignments.cpu().numpy(),
                     centroids=res.centroids.cpu().numpy())
        out[name] = e

    if "xlarge" in job:
        pts = np.load(job["xlarge"])
        init = job["xlarge_init"]
        kw = dict(max_iters=XLARGE["max_iters"], tol=XLARGE["tol"])
        fit("compact", pts, init, count=True, backend="compact",
            return_stats=True, **kw)
        fit("compact_warm", pts, init, backend="compact", time_reduce=True,
            **kw)
        fit("dense", pts, init, backend="dense", **kw)
        fit("uneven", pts[:job["uneven"]], init, backend="compact", **kw)
        fit("compress", pts, init, backend="compact", compress=True, **kw)
        if job.get("search"):
            search(rank, world, mesh, pts, init, kw, job, out)
            fit("auto", pts, init, backend="compact", tune="auto",
                return_stats=True, **kw)
        del pts
    if "wide" in job:
        pts = np.load(job["wide"])
        init = job["wide_init"]
        kw = dict(max_iters=WIDE["max_iters"], tol=WIDE["tol"])
        fit("wide/compact", pts, init, backend="compact", return_stats=True,
            **kw)
        # timed again warm: in the world of 1 the first fit is the
        # process's first (cuBLAS and the kernels' libraries load there)
        fit("wide/warm", pts, init, backend="compact", time_reduce=True,
            **kw)
        fit("wide/dense", pts, init, backend="dense", **kw)
        fit("wide/ones", pts, init, backend="compact",
            sample_weight=np.ones(len(pts), np.float32), **kw)
    return out


def search(rank, world, mesh, pts, init, kw, job, out):
    """Phase 16's sharded search in a rank: ``autotune(shards=world)`` on
    one shard's worth of points over the world's mesh, with
    ``SHARDED["search"]``'s budget; every rank returns its winner and
    the entry its cache holds."""
    import torch
    from repro_torch import tune
    one = pts[:len(pts) // world]
    t0 = time.perf_counter()
    cfg = tune.autotune(one, init, shards=world, mesh=mesh,
                        device=job["device"], **kw, **SHARDED["search"])
    seconds = time.perf_counter() - t0
    dev = job["device"] or torch.device("cuda",
                                        rank % torch.cuda.device_count())
    sig = tune.signature(len(one), init.shape[0], one.shape[1],
                         platform=tune.platform_name(dev), shards=world)
    out["search"] = dict(config=cfg.to_dict(), seconds=seconds, sig=sig,
                         entry=tune.default_cache().entry(sig))


def sharded_phase(dev, xl_np, xl_init, main_fit, compact_s, wide_np,
                  wide_init, scratch, *, world=SHARDED["world"],
                  uneven=SHARDED["uneven"], nccl=True, rank_device=None):
    """Phase 16: ``repro_torch.core.distributed_yinyang`` in a world of
    ``world`` ``gloo`` ranks sharing the card, and in a world of 1 over
    NCCL (``nccl=False``: gloo, for a rehearsal on the CPU). Each world
    is started by ``spawn_world`` with a deadline, each rank reports
    through a file, and a rank that fails or is late fails the run.

    (a) uci-xlarge (``xl_np``, phase 3's points and init, G = 25): the
    compact fit is the main path (counts reset just before it and read
    just after it on every rank); compact and dense bit for bit (labels,
    ``n_iters``, inertia); against phase 3's single-device fit
    (``main_fit``) ``n_iters`` equal and inertia within 1e-5, the labels
    apart and the ``distance_evals`` ratio logged; the first ``uneven``
    points against the single-device compact fit on them (``n_iters``
    and inertia as above); ``compress=True`` within 1% of the inertia.
    (b) uci-wide in the same world: labels those of the single-device
    compact fit; dense and compact, and weights of 1.0 and none, bit for
    bit. (c) a world of 1 at uci-wide: labels, ``n_iters`` and
    ``distance_evals`` those of the single-device compact fit, and the
    centroids bit for bit. Logs each world's fit seconds beside the
    single-device fit's (``compact_s`` at uci-xlarge), ``host_syncs``,
    one iteration's all-reduce time and ``shard_skew``. Returns the
    report; its ``launches`` are the main path's, summed over ranks."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core.distributed import spawn_world
    xl_path = str(Path(scratch) / "xlarge.npy")
    wide_path = str(Path(scratch) / "wide.npy")
    np.save(xl_path, xl_np)
    np.save(wide_path, wide_np)
    k, d = xl_init.shape
    init_np = xl_init.cpu().numpy()
    winit_np = wide_init.cpu().numpy()
    wk = dict(max_iters=WIDE["max_iters"], tol=WIDE["tol"],
              backend="compact", device=dev)
    # the single-device yardsticks: uci-xlarge's first `uneven` points,
    # and uci-wide (timed)
    u_fit = engine.fit(torch.from_numpy(xl_np[:uneven]).to(dev), xl_init,
                       max_iters=XLARGE["max_iters"], tol=XLARGE["tol"],
                       backend="compact", device=dev)
    wpts = torch.from_numpy(wide_np).to(dev)
    engine.fit(wpts, wide_init, **wk)                 # warm
    t0 = time.perf_counter()
    w_fit = engine.fit(wpts, wide_init, **wk)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    w_s = time.perf_counter() - t0
    del wpts
    job = dict(device=rank_device, xlarge=xl_path, xlarge_init=init_np,
               uneven=uneven, wide=wide_path, wide_init=winit_np,
               search=True)
    t0 = time.perf_counter()
    ranks = spawn_world(sharded_rank, world, args=(job,),
                        timeout=SHARDED["timeout"])
    world_s = time.perf_counter() - t0
    got = ranks[0]
    rep = dict(world=world, world_seconds=world_s)

    def same_bits(a, b, what):
        check(np.array_equal(a["labels"], b["labels"])
              and a["n_iters"] == b["n_iters"]
              and a["inertia"] == b["inertia"],
              f"phase 16: {what} differ in labels, n_iters or inertia bits")

    # (a) uci-xlarge
    main = got["compact"]
    check(all(r["compact"]["device"] == got["compact"]["device"]
              for r in ranks), "phase 16: ranks on different devices")
    for r in ranks[1:]:
        check(r["compact"]["n_iters"] == main["n_iters"]
              and r["compact"]["inertia"] == main["inertia"],
              "phase 16: the ranks' results differ")
    same_bits(main, got["dense"], "compact and dense (uci-xlarge)")
    same_bits(main, got["compact_warm"], "two compact fits (uci-xlarge)")
    m_labels = main_fit.assignments.cpu().numpy()
    apart = int((main["labels"] != m_labels).sum())
    in1 = float(main_fit.inertia)
    evals_ratio = main["evals"] / float(main_fit.distance_evals)
    log(f"phase 16 (a) world of {world} at uci-xlarge: compact "
        f"{got['compact_warm']['seconds']:.3f} s warm "
        f"({main['seconds']:.3f} s first, the main path; single-device "
        f"compact {compact_s:.3f} s), dense {got['dense']['seconds']:.3f} "
        f"s, the world started and ran every fit in {world_s:.1f} s; "
        f"n_iters {main['n_iters']} (phase 3 {main_fit.n_iters}), "
        f"inertia {main['inertia']:.9g} (phase 3 {in1:.9g}), {apart} labels "
        f"apart from phase 3's, distance_evals {main['evals']} "
        f"({evals_ratio:.4f}x phase 3's), host_syncs {main['host_syncs']}, "
        f"caps {main['caps']}, config {main['config']}")
    check(main["n_iters"] == main_fit.n_iters,
          "phase 16: n_iters differs from phase 3's")
    check(abs(main["inertia"] - in1) <= 1e-5 * in1,
          "phase 16: inertia beyond 1e-5 of phase 3's")
    un = got["uneven"]
    check(un["labels"].shape == (uneven,), "phase 16: uneven labels' shape")
    u_apart = int((un["labels"] != u_fit.assignments.cpu().numpy()).sum())
    log(f"phase 16 (a) uneven N={uneven}: n_iters {un['n_iters']} "
        f"(single {u_fit.n_iters}), inertia {un['inertia']:.9g} (single "
        f"{float(u_fit.inertia):.9g}), {u_apart} labels apart, "
        f"distance_evals {un['evals']} / {int(u_fit.distance_evals)}")
    check(un["n_iters"] == u_fit.n_iters, "phase 16: uneven n_iters differs")
    check(abs(un["inertia"] - float(u_fit.inertia))
          <= 1e-5 * float(u_fit.inertia), "phase 16: uneven inertia differs")
    cz = got["compress"]
    log(f"phase 16 (a) compress=True: inertia {cz['inertia']:.9g} "
        f"({cz['inertia'] / main['inertia']:.6f}x), n_iters {cz['n_iters']}, "
        f"{cz['seconds']:.3f} s")
    check(abs(cz["inertia"] - main["inertia"]) <= 1e-2 * main["inertia"],
          "phase 16: compressed inertia beyond 1% of the fit's")
    # the sharded search: one winner on every rank, under |s<world>,
    # adopted by tune="auto" with the labels of the default config's
    from repro_torch.core.engine import DEFAULT_CONFIG
    srch, auto = got["search"], got["auto"]
    log(f"phase 16 (a) sharded search: {srch['sig']} -> {srch['config']} "
        f"in {srch['seconds']:.2f} s, entry {srch['entry']}; tune='auto' "
        f"after it {auto['seconds']:.3f} s with config {auto['config']}")
    check(srch["sig"].endswith(f"|s{world}") and srch["entry"] is not None
          and srch["entry"]["shards"] == world
          and "lloyd_ms" not in srch["entry"]
          and srch["config"]["backend"] == "compact",
          "phase 16: the sharded search stored no compact |sS entry")
    check(all(r["search"]["config"] == srch["config"] for r in ranks),
          "phase 16: the ranks' search winners differ")
    check(main["config"] == DEFAULT_CONFIG.to_dict(),
          "phase 16: the main fit did not run the default config")
    check(auto["config"] == srch["config"], "phase 16: tune='auto' did "
          "not adopt the search's winner")
    check(np.array_equal(auto["labels"], main["labels"]),
          "phase 16: tune='auto' moved the labels")
    skew = np.asarray(main["shard_skew"])
    ms_iter = got["compact_warm"]["seconds"] * 1e3 / (main["n_iters"] + 1)
    warm = [r["compact_warm"] for r in ranks]
    share = [w["reduce_s"] / w["seconds"] for w in warm]
    ar_ms = max(w["reduce_s"] for w in warm) * 1e3 / (main["n_iters"] + 1)
    log(f"phase 16 the warm fit's own all-reduces (sums and counts each "
        f"iteration, evals and inertia at the end; "
        f"{warm[0]['reduce_calls']} calls a rank): {ar_ms:.3f} ms an "
        f"iteration on the slowest rank, against {ms_iter:.3f} ms an "
        f"iteration of the fit; share of the fit per rank "
        f"{', '.join(f'{s:.1%}' for s in share)}; shard_skew mean "
        f"{skew.mean():.4f} max {skew.max():.4f}")
    launches = {nm: sum(r["compact"]["launches"][nm] for r in ranks)
                for nm in ("grouped_assign", "centroid_update")}
    check(launches["centroid_update"] >= world * main["n_iters"],
          f"phase 16: centroid_update launched {launches['centroid_update']}"
          f" times over {world} ranks, fewer than a launch a rank an "
          f"iteration")
    rep.update(xlarge=dict(
        first_s=main["seconds"], warm_s=got["compact_warm"]["seconds"],
        dense_s=got["dense"]["seconds"], single_compact_s=compact_s,
        n_iters=main["n_iters"], inertia=main["inertia"],
        labels_apart=apart, evals=main["evals"], evals_ratio=evals_ratio,
        host_syncs=main["host_syncs"], caps=main["caps"],
        uneven=dict(n=uneven, labels_apart=u_apart, n_iters=un["n_iters"]),
        compress_inertia_ratio=cz["inertia"] / main["inertia"],
        search=dict(srch, auto_s=auto["seconds"]),
        shard_skew_mean=float(skew.mean()), shard_skew_max=float(skew.max())),
        all_reduce_ms=ar_ms, all_reduce_share=share, iteration_ms=ms_iter,
        launches=launches)

    # (b) uci-wide in the same world
    wc = got["wide/compact"]
    same_bits(wc, got["wide/warm"], "two compact fits (uci-wide)")
    same_bits(wc, got["wide/dense"], "compact and dense (uci-wide)")
    same_bits(wc, got["wide/ones"], "weights of 1.0 and none (uci-wide)")
    w_labels = w_fit.assignments.cpu().numpy()
    wide_share = max(r["wide/warm"]["reduce_s"] / r["wide/warm"]["seconds"]
                     for r in ranks)
    check(np.array_equal(wc["labels"], w_labels) and
          wc["n_iters"] == w_fit.n_iters,
          "phase 16: uci-wide labels or n_iters differ from the "
          "single-device compact fit's")
    log(f"phase 16 (b) world of {world} at uci-wide: "
        f"{got['wide/warm']['seconds']:.3f} s warm (single-device compact "
        f"{w_s:.3f} s), n_iters {wc['n_iters']}, "
        f"labels equal, distance_evals {wc['evals']} / "
        f"{int(w_fit.distance_evals)}, host_syncs {wc['host_syncs']}, the "
        f"warm fit's all-reduces {wide_share:.1%} of it (slowest rank)")
    rep["wide"] = dict(seconds=got["wide/warm"]["seconds"], single_s=w_s,
                       n_iters=wc["n_iters"], evals=wc["evals"],
                       single_evals=int(w_fit.distance_evals),
                       all_reduce_share=wide_share)

    # (c) a world of 1 at uci-wide, over NCCL
    job1 = dict(job)
    del job1["xlarge"]
    t0 = time.perf_counter()
    one = spawn_world(sharded_rank, 1, args=(job1,),
                      backend="nccl" if nccl else "gloo",
                      timeout=SHARDED["timeout"])[0]
    one_world_s = time.perf_counter() - t0
    o = one["wide/compact"]
    o_s = one["wide/warm"]["seconds"]
    one_reduce_s = one["wide/warm"]["reduce_s"]
    cents_equal = bool(np.array_equal(o["centroids"],
                                      w_fit.centroids.cpu().numpy()))
    log(f"phase 16 (c) world of 1 over {'NCCL' if nccl else 'gloo'} at "
        f"uci-wide: {o_s:.3f} s warm, {o['seconds']:.3f} s first "
        f"(single-device {w_s:.3f} s; the world started and ran in "
        f"{one_world_s:.1f} s), "
        f"n_iters {o['n_iters']}, distance_evals {o['evals']} / "
        f"{int(w_fit.distance_evals)}, centroids bit for bit: {cents_equal}"
        f", the warm fit's all-reduces {one_reduce_s * 1e3:.3f} ms in all "
        f"({one_reduce_s / o_s:.1%} of it)")
    check(np.array_equal(o["labels"], w_labels)
          and o["n_iters"] == w_fit.n_iters
          and o["evals"] == int(w_fit.distance_evals),
          "phase 16: the world of 1 differs from the single-device compact "
          "fit in labels, n_iters or distance_evals")
    check(cents_equal, "phase 16: the world of 1's centroids are not the "
          "single-device fit's bits")
    rep["one"] = dict(backend="nccl" if nccl else "gloo",
                      seconds=o_s, first_s=o["seconds"],
                      world_seconds=one_world_s,
                      all_reduce_s=one_reduce_s)
    return rep


# -- phase 17: the sharded stream on torch.distributed ----------------------

# the elastic part's schedule, in batches of phase 14's stream: a
# 2-epoch run, checkpoints every 8, one failure off the lattice, the
# step-16 checkpoint grown into the world's mesh
ELASTIC = dict(epochs=2, ckpt_every=8, fail_at=13, restore_at=16)


def stream_rank(rank, world, job):
    """One rank of a phase 17 world (``spawn_world`` runs it): (a) phase
    14's stream sharded over the world's mesh for ``job["epochs"]``
    epochs, the main path, with the kernels' counts reset just before it
    and read just after it; then one warm batch timed by part (each call
    of the all-reduce, the gathers and ``inflate_bounds`` between two
    card syncs). With ``job["elastic"]`` also (c): a resilient 2-epoch
    stream on a 2-rank sub-mesh through one failure against its
    uninterrupted run, its step-16 checkpoint grown into the world's
    mesh, and (a)'s step-16 checkpoint shrunk into the 2-rank mesh,
    each streamed on to the end of epoch 2. Returns rank 0's labels and
    centroids, every rank's state and numbers."""
    import torch
    import torch.distributed as dist
    import repro_torch.kernels as kernels
    from repro_torch.core import distributed as dist_
    from repro_torch.core import engine, make_mesh
    from repro_torch.data import PointStream
    from repro_torch.runtime import FailureInjector
    from repro_torch.streaming import StreamingKMeans
    from repro_torch.streaming import estimator as est_mod
    dev = job["device"] or torch.device(
        "cuda", rank % torch.cuda.device_count())
    pts = np.load(job["points"])
    shard, k, g = job["shard"], job["k"], job["n_groups"]
    stream = PointStream(shard_size=shard, data=pts)
    per_epoch = len(stream)
    wrappers = {"grouped_assign": kernels.grouped_assign,
                "centroid_update": kernels.centroid_update}
    mesh = make_mesh(world)
    m2 = make_mesh(2) if job["elastic"] else None

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)

    def estimator(m):
        return StreamingKMeans(k, n_groups=g, decay=1.0, init_size=shard,
                               seed=0, mesh=m, device=job["device"])

    def state(skm):
        return dict(centroids=skm._centroids.cpu().numpy(),
                    counts=skm._counts.cpu().numpy(),
                    ledger_centroid=skm._ledger.centroid.copy(),
                    ledger_group=skm._ledger.group.copy(),
                    stats=skm.stats_.to_dict())

    def run(skm, start, stop):
        for step in range(start, stop):
            b = stream.global_batch(step)
            skm.partial_fit(b["points"], shard_id=b["shard_id"])

    ckpt = job["ckpt"]
    out = {}
    # (a) the main path
    skm = estimator(mesh)
    seeded = []
    seed = skm._seed_centroids

    def keep_seeds(points, weights):
        seeded.append(seed(points, weights))
        return seeded[-1]

    skm._seed_centroids = keep_seeds
    reset_launches(wrappers)
    sync()
    first, epochs, two = None, [], None
    for ep in range(job["epochs"]):
        st = skm.stats_
        ev0, hits0 = st.distance_evals, st.cache_hits
        t0 = time.perf_counter()
        for sid, batch in stream.batches(1):
            skm.partial_fit(batch, shard_id=sid)
            if first is None and skm.initialized:
                first = skm.labels_.copy()
        sync()
        dt = time.perf_counter() - t0
        epochs.append(dict(seconds=dt, points_per_s=len(pts) / dt,
                           distance_evals=st.distance_evals - ev0,
                           cache_hits=st.cache_hits - hits0))
        if job["elastic"] and ep == 0:
            # the 4-rank checkpoint the shrink restores (untimed)
            skm.save(os.path.join(ckpt, "shrink"), per_epoch)
        if ep == 1:
            two = skm._centroids.cpu().numpy()
    launches = read_launches(wrappers)
    out["a"] = dict(state(skm), epochs=epochs, launches=launches,
                    device=str(skm._centroids.device))
    if rank == 0:
        out["a"].update(first=first, seeds=seeded[0].cpu().numpy(),
                        two=two)

    # one warm batch by part: every call of each, between two card syncs
    spent = {"all_reduce": [], "gather": [], "inflate_bounds": []}

    def timed(key, fn):
        def wrapped(*a, **kw):
            sync()
            t = time.perf_counter()
            r = fn(*a, **kw)
            sync()
            spent[key].append(time.perf_counter() - t)
            return r
        return wrapped

    saved = engine._all_reduce, dist_._gather, est_mod.inflate_bounds
    engine._all_reduce = timed("all_reduce", saved[0])
    dist_._gather = timed("gather", saved[1])
    est_mod.inflate_bounds = timed("inflate_bounds", saved[2])
    try:
        sync()
        t0 = time.perf_counter()
        skm.partial_fit(stream.shard(1), shard_id=1)
        sync()
        batch_s = time.perf_counter() - t0
    finally:
        engine._all_reduce, dist_._gather, est_mod.inflate_bounds = saved
    out["a"]["warm_batch"] = dict(
        seconds=batch_s, **{f"{k_}_s": sum(v) for k_, v in spent.items()},
        **{f"{k_}_calls": len(v) for k_, v in spent.items()})
    del skm
    if not job["elastic"]:
        return out

    # (c) elastic, at 2 epochs
    n2 = ELASTIC["epochs"] * per_epoch
    grow_dir = os.path.join(ckpt, "grow")
    if rank < 2:
        full = estimator(m2)
        t0 = time.perf_counter()
        run(full, 0, n2)
        sync()
        full_s = time.perf_counter() - t0
        rec = estimator(m2)
        t0 = time.perf_counter()
        rec.fit_stream(stream, epochs=ELASTIC["epochs"], resilient=True,
                       ckpt_dir=grow_dir, ckpt_every=ELASTIC["ckpt_every"],
                       injector=FailureInjector(
                           fail_at=(ELASTIC["fail_at"],)))
        sync()
        rec_s = time.perf_counter() - t0
        out["c/two"] = dict(full=state(full), recovered=state(rec),
                            full_s=full_s, recovered_s=rec_s)
        del full, rec
    dist.barrier()
    t0 = time.perf_counter()
    grown, step = StreamingKMeans.restore(
        grow_dir, step=ELASTIC["restore_at"], mesh=mesh,
        device=job["device"])
    run(grown, step, n2)
    sync()
    out["c/grow"] = dict(state(grown), step=step,
                         seconds=time.perf_counter() - t0)
    del grown
    if rank < 2:
        t0 = time.perf_counter()
        shrunk, step = StreamingKMeans.restore(
            os.path.join(ckpt, "shrink"), mesh=m2, device=job["device"])
        run(shrunk, step, n2)
        sync()
        out["c/shrink"] = dict(state(shrunk), step=step,
                               seconds=time.perf_counter() - t0)
    dist.barrier()
    if rank:
        # the elastic numbers are rank 0's; the other ranks' centroids
        # are only compared with its own
        if "c/two" in out:
            out["c/two"] = out["c/two"]["recovered"]
        for key in ("c/two", "c/grow", "c/shrink"):
            if key in out:
                out[key] = {"centroids": out[key]["centroids"]}
    return out


def _inertia(pts_dev, centroids):
    """Exact inertia of ``centroids`` on the points (the engine's tiled
    assignment, the ``grouped_assign`` kernel)."""
    import torch
    from repro_torch.core import engine
    _, d = engine.assign(pts_dev, torch.from_numpy(centroids).to(
        pts_dev.device), device=pts_dev.device)
    return float(torch.sum(d.double() * d.double()))


def sharded_stream_phase(dev, pts_np, k, n_groups, yard, stream_rep,
                         scratch, *, world=SHARDED["world"], nccl=True,
                         rank_device=None, shard=STREAM["shard"],
                         epochs=STREAM["epochs"]):
    """Phase 17: ``StreamingKMeans(mesh=...)`` on phase 14's stream (16
    shards of 65,536 at full size, 3 epochs, decay 1.0, phase 14's
    seeds), its worlds started by ``spawn_world`` with a deadline.

    (a) A world of ``world`` ``gloo`` ranks sharing the card, the main
    path (counts reset just before and read just after the stream on
    every rank), every batch sharded: the counts' sum phase 14's, the first batch's labels phase 14's but at fp32
    near-ties (phase 13's rule, against the seeds), the final inertia
    within rtol 1e-3 of phase 14's, the ``distance_evals`` ratio within
    5%, the ranks bit for bit alike, ``centroid_update`` at least once
    a batch a rank; points/s an epoch beside phase 14's, and one warm
    batch's time in the all-reduces, gathers and ``inflate_bounds``.
    (b) A world of 1 over NCCL (``nccl=False``: gloo, for a rehearsal on
    the CPU): centroids, counts, both ledger arrays and
    ``distance_evals`` phase 14's bit for bit. (c) In (a)'s world at 2
    epochs: a resilient stream on a 2-rank sub-mesh through one failure
    bit for bit its uninterrupted run; its step-16 checkpoint grown into
    the world's mesh and (a)'s shrunk into the 2-rank mesh, each within
    2% of the uninterrupted run's inertia. ``yard`` is phase 14's final
    state, ``stream_rep`` its report. Returns the report; its
    ``launches`` are (a)'s, summed over ranks."""
    import torch
    from repro_torch.core.distributed import spawn_world
    path = str(Path(scratch) / "stream_points.npy")
    np.save(path, pts_np)
    ckpt = tempfile.mkdtemp(prefix="stream_ckpt_", dir=scratch)
    job = dict(device=rank_device, points=path, shard=shard, k=k,
               n_groups=n_groups, epochs=epochs, elastic=True, ckpt=ckpt)
    t0 = time.perf_counter()
    ranks = spawn_world(stream_rank, world, args=(job,),
                        timeout=SHARDED["timeout"])
    world_s = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    got = ranks[0]["a"]
    rep = dict(world=world, world_seconds=world_s)
    st = got["stats"]
    n_shards = len(pts_np) // shard

    # (a) against phase 14
    check(st["sharded_batches"] == epochs * n_shards == st["batches"],
          f"phase 17: {st['sharded_batches']} sharded batches")
    for r in ranks[1:]:
        a = r["a"]
        check(all(np.array_equal(a[key], got[key]) for key in
                  ("centroids", "counts", "ledger_centroid",
                   "ledger_group")) and a["stats"] == st,
              "phase 17: the ranks' streams differ")
    launches = {nm: sum(r["a"]["launches"][nm] for r in ranks)
                for nm in ("grouped_assign", "centroid_update")}
    per_rank = [r["a"]["launches"]["centroid_update"] for r in ranks]
    check(min(per_rank) >= st["batches"], f"phase 17: centroid_update "
          f"launched {per_rank} times a rank for {st['batches']} batches")
    y_counts = yard["counts"].double().sum().item()
    check(float(got["counts"].astype(np.float64).sum()) == y_counts,
          "phase 17: the counts' sum is not phase 14's")
    pts_dev = torch.from_numpy(pts_np).to(dev)
    inertia = _inertia(pts_dev, got["centroids"])
    y_inertia = stream_rep["inertia"]
    rel = abs(inertia - y_inertia) / y_inertia
    evals_ratio = st["distance_evals"] / stream_rep["stats"]["distance_evals"]
    first = got["first"]
    bad = np.nonzero(first != yard["first"])[0]
    seeds64 = got["seeds"].astype(np.float64)
    x0 = pts_np[:shard]
    norms = near_ties(x0[bad], seeds64, first[bad], yard["first"][bad])[1] \
        if len(bad) else np.zeros(0)
    pps = [e["points_per_s"] for e in got["epochs"]]
    y_pps = [e["points_per_s"] for e in stream_rep["epochs"]]
    wb = got["warm_batch"]
    log(f"phase 17 (a) world of {world} gloo ranks: {st['batches']} "
        f"batches ({st['sharded_batches']} sharded), {st['cache_hits']} "
        f"hits; points/s an epoch {', '.join(f'{p:.4g}' for p in pps)} "
        f"(phase 14: {', '.join(f'{p:.4g}' for p in y_pps)}); inertia "
        f"{inertia:.9g} (phase 14 {y_inertia:.9g}, rel {rel:.3g}); "
        f"distance_evals {st['distance_evals']:.0f} ({evals_ratio:.5f}x "
        f"phase 14's); first batch {len(bad)} labels apart, largest "
        f"squared gap {norms.max() if len(bad) else 0:.3g} of phase 2b's "
        f"scale; launches {launches}; the world started and ran in "
        f"{world_s:.1f} s")
    log(f"phase 17 (a) a warm batch on rank 0: {wb['seconds'] * 1e3:.2f} "
        f"ms; all-reduces {wb['all_reduce_s'] * 1e3:.2f} ms "
        f"({wb['all_reduce_calls']} calls), gathers "
        f"{wb['gather_s'] * 1e3:.2f} ms ({wb['gather_calls']}), "
        f"inflate_bounds {wb['inflate_bounds_s'] * 1e3:.2f} ms "
        f"({wb['inflate_bounds_calls']})")
    check(rel <= 1e-3, f"phase 17: inertia {rel:.3g} from phase 14's")
    check(abs(evals_ratio - 1.0) <= 0.05,
          f"phase 17: distance_evals {evals_ratio:.4f}x phase 14's")
    check(bool(np.all(norms <= 2.0)), "phase 17: the first batch's labels "
          "differ from phase 14's off an fp32 near-tie")
    rep.update(stats=st, epochs=got["epochs"], inertia=inertia,
               inertia_rel=rel, evals_ratio=evals_ratio,
               first_apart=len(bad), warm_batch=[r["a"]["warm_batch"]
                                                 for r in ranks],
               launches=launches, phase14_points_per_s=y_pps)

    # (c) elastic
    two, grow, shrink = ranks[0]["c/two"], ranks[0]["c/grow"], \
        ranks[0]["c/shrink"]
    same = all(np.array_equal(two["full"][key], two["recovered"][key])
               for key in ("centroids", "counts", "ledger_centroid",
                           "ledger_group"))
    rst = two["recovered"]["stats"]
    check(same and np.array_equal(ranks[1]["c/two"]["centroids"],
                                  two["recovered"]["centroids"]),
          "phase 17: the 2-rank resilient stream is not its uninterrupted "
          "run bit for bit, or its ranks differ")
    check(rst["restores"] == 1 and rst["replayed_batches"] ==
          ELASTIC["fail_at"] - ELASTIC["ckpt_every"],
          f"phase 17: {rst['restores']} restores, {rst['replayed_batches']}"
          f" replays")
    for r in ranks[1:]:
        check(np.array_equal(r["c/grow"]["centroids"], grow["centroids"]),
              "phase 17: the grown ranks differ")
    in_two = _inertia(pts_dev, two["full"]["centroids"])
    in_grow = _inertia(pts_dev, grow["centroids"])
    in_a2 = _inertia(pts_dev, got["two"])
    in_shrink = _inertia(pts_dev, shrink["centroids"])
    del pts_dev
    g_rel = abs(in_grow - in_two) / in_two
    s_rel = abs(in_shrink - in_a2) / in_a2
    log(f"phase 17 (c) 2-rank sub-mesh, 2 epochs: {two['full_s']:.2f} s "
        f"uninterrupted, {two['recovered_s']:.2f} s resilient ("
        f"{rst['restores']} restore, {rst['replayed_batches']} replays, "
        f"{rst['ckpt_saves']} saves), bit for bit: {same}; grown 2 -> "
        f"{world} from step {grow['step']}: inertia {in_grow:.9g} against "
        f"{in_two:.9g} (rel {g_rel:.3g}, {grow['seconds']:.2f} s, "
        f"{grow['stats']['cache_hits']} hits); shrunk {world} -> 2 from "
        f"step {shrink['step']}: {in_shrink:.9g} against {in_a2:.9g} (rel "
        f"{s_rel:.3g}, {shrink['seconds']:.2f} s)")
    check(grow["step"] == ELASTIC["restore_at"] and g_rel < 0.02,
          f"phase 17: the grown stream {g_rel:.3g} from its run")
    check(shrink["step"] == n_shards and s_rel < 0.02,
          f"phase 17: the shrunk stream {s_rel:.3g} from its run")
    rep["elastic"] = dict(
        bit_for_bit=same, restores=rst["restores"],
        replayed=rst["replayed_batches"], full_s=two["full_s"],
        recovered_s=two["recovered_s"], grow_rel=g_rel, shrink_rel=s_rel,
        grow_s=grow["seconds"], shrink_s=shrink["seconds"])

    # (b) a world of 1 over NCCL
    job1 = dict(job, elastic=False)
    t0 = time.perf_counter()
    one = spawn_world(stream_rank, 1, args=(job1,),
                      backend="nccl" if nccl else "gloo",
                      timeout=SHARDED["timeout"])[0]["a"]
    one_s = time.perf_counter() - t0
    bits = {key: bool(np.array_equal(one[key], want)) for key, want in (
        ("centroids", yard["centroids"].cpu().numpy()),
        ("counts", yard["counts"].cpu().numpy()),
        ("ledger_centroid", yard["ledger_centroid"]),
        ("ledger_group", yard["ledger_group"]))}
    bits["distance_evals"] = \
        one["stats"]["distance_evals"] == yard["distance_evals"]
    opps = [e["points_per_s"] for e in one["epochs"]]
    log(f"phase 17 (b) world of 1 over {'NCCL' if nccl else 'gloo'}: "
        f"points/s an epoch {', '.join(f'{p:.4g}' for p in opps)}, bit for "
        f"bit phase 14's: {bits}; the world started and ran in {one_s:.1f}"
        f" s")
    check(all(bits.values()), f"phase 17: the world of 1 is not phase 14's "
          f"stream bit for bit: {bits}")
    rep["one"] = dict(backend="nccl" if nccl else "gloo", bits=bits,
                      epochs=one["epochs"], world_seconds=one_s,
                      warm_batch=one["warm_batch"])
    return rep


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
    # a fresh tuning cache for the whole run (phase 12): no cache left on
    # the machine may route a fit or skip the search; removed at exit
    scratch = tempfile.mkdtemp(prefix="chip_smoke_")
    import atexit
    atexit.register(shutil.rmtree, scratch, True)
    os.environ["REPRO_TORCH_KMEANS_TUNE_CACHE"] = str(
        Path(scratch) / "tune.json")

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
                "ssd_intra": kernels.ssd_intra,
                # the model's backward launches (training)
                "flash_attention_bwd":
                    kernel_module("flash_attention").flash_attention_gqa_bwd,
                "ssd_intra_bwd":
                    kernel_module("ssd_intra").ssd_intra_chunks_bwd}

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

    hk_n, hk_k = HIGHK["n"], HIGHK["k"]
    hk_np, hk_c, _ = make_points(hk_n, HIGHK["d"], hk_k, seed=1)
    hk = torch.from_numpy(hk_np).to(dev)
    hk_cent = hk[:: hk_n // hk_k][:hk_k].contiguous()
    for dens in (1.0, 0.3):
        ga_case(f"uci-highk K={hk_k} G={hk_k // 10} density {dens}", hk,
                hk_cent, hk_k // 10, dens)
    hk_lab = torch.randint(-1, hk_k, (hk_n,), generator=gen, device=dev,
                           dtype=torch.int32)
    cu_case(f"uci-highk K={hk_k} with -1 labels", hk, hk_lab, hk_k)

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
                    rand_mask(hk_n, hk_k, tn, tk, dens), tn, tk,
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
    del wfits

    # -- 7. where a fit's time goes: one traced kernel fit ----------------
    report["trace"] = traced(lambda: engine.fit(points, init, **fit_kw),
                             "traced fit")

    # -- 11. observability at uci-xlarge ---------------------------------
    t0 = time.perf_counter()
    report["obs"] = obs_phase(dev, points, init, fit_kw, scratch)
    log(f"phase 11 took {time.perf_counter() - t0:.1f} s")

    # -- 12. autotuning at uci-xlarge, into the fresh cache --------------
    t0 = time.perf_counter()

    def wide_ties(labels):
        return tie_rows("uci-wide lloyd", wpts, wk_fit.centroids, labels,
                        wk_fit.assignments, w_atol)
    report["tune"] = tune_phase(dev, points, init, fit_kw,
                                (wpts, winit, wk_fit, wide_ties))
    del wpts
    log(f"phase 12 took {time.perf_counter() - t0:.1f} s")

    # -- 13. the fitted index behind the serving engine ------------------
    t0 = time.perf_counter()
    report["serve_index"] = serve_index_phase(
        dev, wrappers, torch.from_numpy(km.cluster_centers_), pts_np, points)
    log(f"phase 13 took {time.perf_counter() - t0:.1f} s")
    serve_ga = report["serve_index"]["kernel"]["launches"]["grouped_assign"]

    # -- 14. streaming k-means with carried bounds at uci-xlarge ---------
    t0 = time.perf_counter()
    report["stream"], stream_final = stream_phase(
        dev, wrappers, pts_np, plain_versions, fit_kw, k, max(k // 10, 1))
    log(f"phase 14 took {time.perf_counter() - t0:.1f} s")
    stream_launches = report["stream"]["launches"]
    ep = report["stream"]["epochs"]
    stream_pps = len(pts_np) * len(ep) / sum(r["seconds"] for r in ep)

    # -- 15. the resilient stream: checkpoints, restore and replay -------
    t0 = time.perf_counter()
    report["resilient"] = resilient_phase(
        dev, wrappers, pts_np, k, max(k // 10, 1), stream_final, stream_pps)
    log(f"phase 15 took {time.perf_counter() - t0:.1f} s")
    resilient_launches = report["resilient"]["launches"]

    # -- 16. the sharded batch fit on torch.distributed -------------------
    t0 = time.perf_counter()
    report["sharded"] = sharded_phase(dev, pts_np, init, res, cfit_s, w_np,
                                      winit, scratch)
    log(f"phase 16 took {time.perf_counter() - t0:.1f} s")
    sharded_launches = report["sharded"]["launches"]

    # -- 17. the sharded stream on torch.distributed ---------------------
    t0 = time.perf_counter()
    report["sharded_stream"] = sharded_stream_phase(
        dev, pts_np, k, max(k // 10, 1), stream_final, report["stream"],
        scratch)
    del stream_final
    log(f"phase 17 took {time.perf_counter() - t0:.1f} s")
    sharded_stream_launches = report["sharded_stream"]["launches"]

    # -- 2c. the LM kernels against their plain versions -----------------
    from repro_torch.configs import get_config
    lm_cfg = get_config(SERVE["arch"])
    attn_main, ssd_main = lm_kernel_phase(dev, gen, bw, fp32, bf16, lm_cfg,
                                          SERVE["batch"], SERVE["prompt"])

    # -- 2d. the backward kernels against their plain versions -----------
    t0 = time.perf_counter()
    attn_bwd, ssd_bwd = lm_backward_phase(dev, gen, bw, fp32, bf16, lm_cfg,
                                          TRAIN["batch"], TRAIN["seq"])
    log(f"phase 2d took {time.perf_counter() - t0:.1f} s")

    # -- 10. the LM serving path: hymba-1.5b at full width and depth -----
    del points
    serve_rep, kv0 = serve_phase(
        dev, torch.Generator(device=dev).manual_seed(0), wrappers, lm_cfg,
        SERVE["batch"], SERVE["prompt"], SERVE["steps"])
    report["serve"] = serve_rep

    # -- 18. training at hymba-1.5b's full width and depth ---------------
    t0 = time.perf_counter()
    train_cfg = get_config(TRAIN["arch"])
    report["train"] = train_rep = train_phase(
        dev, torch.Generator(device=dev).manual_seed(1), wrappers, train_cfg,
        TRAIN["batch"], TRAIN["seq"], TRAIN["steps"])
    log(f"phase 18 took {time.perf_counter() - t0:.1f} s")

    # -- 19. the resilient training loop ---------------------------------
    t0 = time.perf_counter()
    report["resilient_train"] = resilient_train_phase(
        dev, torch.Generator(device=dev).manual_seed(2), train_cfg,
        tempfile.mkdtemp(prefix="train_", dir=scratch), **RESILIENT_TRAIN)
    log(f"phase 19 took {time.perf_counter() - t0:.1f} s")

    # -- 20. the rest of the k-means surface -----------------------------
    t0 = time.perf_counter()
    report["kmeans_surface"] = kmeans_surface_phase(
        dev, pts_np, k, max(k // 10, 1), kv0, KV_CLUSTERS)
    del kv0
    log(f"phase 20 took {time.perf_counter() - t0:.1f} s")
    lm_paths = {"lm_serve": serve_rep["launches"],       # phase 10
                "train": train_rep["launches"]}          # phase 18

    def row(nm, entry, source, replaces, by_path):
        """``by_path``: {path: that path's launch counts}; ``launches``
        is their sum."""
        paths = {p_: counts[nm] for p_, counts in by_path.items()}
        r = {"name": nm, "route": "cuda", "source": source,
             "replaces": replaces, "launches": sum(paths.values()),
             "launches_by_path": paths,
             "max_abs_err": entry["max_abs_err"], "ms": entry["ms"],
             "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
             "bound_by": entry["bound_by"], "library_ms": entry["library_ms"]}
        if "earlier_ms" in entry:       # the kernel it replaced, in turns
            r["earlier_ms"] = entry["earlier_ms"]
        if "write_floor_ms" in entry:   # fill_ of the output's size
            r["write_floor_ms"] = entry["write_floor_ms"]
        return r

    kmeans_paths = {"fit": launches,                     # phase 3
                    "serve_index": {"grouped_assign": serve_ga,
                                    "centroid_update": 0},  # phase 13
                    "stream": stream_launches,           # phase 14
                    "resilient_stream": resilient_launches,  # phase 15
                    "sharded": sharded_launches,         # phase 16
                    "sharded_stream": sharded_stream_launches}  # phase 17
    line = {"kernels": [
        row("grouped_assign", ga_main,
            "src/repro_torch/kernels/csrc/grouped_assign.cu",
            "src/repro/kernels/grouped_assign.py:83", kmeans_paths),
        row("centroid_update", cu_main,
            "src/repro_torch/kernels/csrc/centroid_update.cu",
            "src/repro/kernels/centroid_update.py:39", kmeans_paths),
        # launched by the block-skip entry point's path (phase 4c)
        row("pairwise_sq_dists", psd_main,
            "src/repro_torch/kernels/csrc/pairwise_sq_dists.cu",
            "src/repro/kernels/distance.py:35",
            {"entry_point": entry_launches}),
        row("filtered_assign", fa_main,
            "src/repro_torch/kernels/csrc/filtered_assign.cu",
            "src/repro/kernels/filtered_assign.py:61",
            {"entry_point": entry_launches}),
        # launched by the LM serving path (phase 10) and training
        # (phase 18)
        row("flash_attention", attn_main,
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:77", lm_paths),
        row("ssd_intra", ssd_main,
            "src/repro_torch/kernels/csrc/ssd_intra.cu",
            "src/repro/kernels/ssd_intra.py:44", lm_paths),
        # the backward of each: the Pallas kernels have none, so each
        # names the forward it differentiates
        row("flash_attention_bwd", attn_bwd,
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention.py:77",
            {"train": train_rep["launches"]}),
        row("ssd_intra_bwd", ssd_bwd,
            "src/repro_torch/kernels/csrc/ssd_intra_bwd.cu",
            "src/repro/kernels/ssd_intra.py:44",
            {"train": train_rep["launches"]}),
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
