#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out report.json]

Phases, each of which fails the run (non-zero exit) on any fault, in
the order they run:

1. build every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc``, one
   compiler process per source, all at once; log ``-Xptxas -v``
   (registers, shared memory, spills) of every kernel in full (eight
   redesigned for this card, ``bounds_upkeep`` written for it), and
   count the ``HGMMA``
   instructions in the built ``flash_attention`` and
   ``flash_attention_bwd`` libraries (``cuobjdump -sass``; none in
   either where ``cuobjdump`` exists fails the run);
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
2e. ``bounds_upkeep`` (a kernel with no TPU counterpart: the move's
   bound upkeep and own-distance refresh) at uci-xlarge's and
   uci-highk's shapes, with about half the rows refreshed, with every
   row, and with the refresh off, against its plain version: bit for bit
   but a refreshed upper bound (held to the expanded form's tolerance);
   each case timed in turns with the plain version beside N (13 + 8 G)
   bytes at the card's bandwidth, the refreshed rows' X reads on top,
   and its launches counted; ``own_dists`` (the compact pass's in-pass
   refresh) on a compact buffer of the half-refreshed rows at each
   shape, bit for bit against ``bounds_upkeep``'s refresh and within
   the expanded form's tolerance of its plain version, timed in turns
   with it beside the buffer's bytes;
2f. ``candidate_mask`` and ``candidate_tail`` (the candidate pass's group
   filter and tail around ``grouped_assign``, kernels with no TPU
   counterpart) on the pending passes of kernel-backend fits at
   uci-xlarge's and uci-highk's shapes after 2 and 10 iterations, bit
   for bit against their plain versions, one launch a call, each timed
   in turns with its plain version beside its bytes at the card's
   bandwidth (``candidate_tail_phase``);
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
   (``pairwise_sq_dists_simple``, ``filtered_assign_simple``) where the
   first kernel takes the shape, the variant each launch took logged
   (every ``filtered_assign`` case takes the new kernel); at D = 256
   and 700, too wide for whole rows in shared memory, at tiles 256x128
   and 64x16 (N 65,536, K 1024, half the blocks live), the kernel walks
   D in slices of 32, each case timed beside its bound; ties on
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
   kernel's launch count reset just before and read just after
   (``bounds_upkeep`` once a move; ``candidate_mask`` and
   ``candidate_tail`` once a pass of the fit, ``n_iters`` + 1); then
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
   (Q = 128, N = 128, P = 64), MLA's attention launch at minicpm3-4b's
   prefill (40 heads, KV = H, q.k 96, v zero-padded from 64; tensor
   cores), every row held to ``ROW_REL_TOL``, the padded columns of
   the output exactly 0, timed in turns with the FFMA route and beside
   SDPA on the unpadded v, its bound counting v's and o's own width;
   qwen2-7b's and qwen3-moe-235b-a22b's
   launches at their prefills (phases 23 and 24: B = 2, S = 2048, 28/4
   and 64/4 heads of 128, bf16, tensor cores; rows held to
   ``ROW_REL_TOL``, timed); SSD also
   with decays that overflow above the
   diagonal, and both cells at Q = 100; the SSD kernel keeps at least 16
   warps resident an SM at both cells' widths (the CUDA occupancy
   calculator); the path's shapes timed by CUDA events, as every
   kernel (``ssd_intra`` also by its device time under
   ``torch.profiler``, ``device_ms``), beside the bound and, for
   attention, ``scaled_dot_product_attention`` (in turns: SDPA first
   and last); attention in bf16 at
   head dims 64, 96 and 128 takes the tensor-core kernel, fp32 the FFMA one
   (each case checks which launch counter moved), the prefill's shape
   in both dtypes; the tensor-core kernel timed in turns against the
   FFMA kernel on the same bf16 inputs (FFMA, tensor cores, tensor
   cores, FFMA), and the model's launch with each row's logsumexp
   written (the training forward, ``lse_ms``) in turns with the
   serving launch, which writes none;
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
   in fp32 at a head dim of 128, each given the L its forward wrote
   (within 1e-3 in bf16, 1e-4 in fp32, of the plain logsumexp); bf16
   at head dims 64, 96 and 128 takes the tensor-core backward, the rest
   the FFMA one (each case checks which route's counter moved); SSD at
   hymba-1.5b's training cells, at Q = 100 and at mamba2-780m's widths
   (N = 128, P = 64), and at chunks of Q = 256 and a ragged 200 at both
   cells' widths (the wide route: 128 x 128 tiles, partials added in a
   fixed order; each timed); MLA's backward at minicpm3-4b's training
   shape (v padded from 64 to 96, on the tensor cores, dv's padded
   columns exactly 0, SDPA's autograd on the unpadded v as the library
   call, the bound counting v, o, dO and dv at 64): each
   gradient within 1e-4 (fp32) of the plain
   version's largest |value|, in bf16 within 3e-2 or 1.5 times the
   distance of autograd through ``scaled_dot_product_attention`` from
   the plain version, whichever is larger, and every attention row (dq's
   query rows, dk's and dv's key rows) within
   ``flash_attention.BWD_ROW_REL_TOL`` of the plain row's norm, so small
   late rows are checked too; two calls bit for bit; the
   training shapes timed by CUDA events beside the bound, the plain
   version and (attention) the autograd backward of SDPA, the
   tensor-core backward in turns with the FFMA route forced on the same
   inputs (FFMA, SDPA, tensor cores, tensor cores, SDPA, FFMA:
   ``earlier_ms``, the FFMA route held to the same bound), and each
   timed call's device time by kernel under ``torch.profiler`` beside
   the events' (``device_over_events``);
18. hymba-1.5b training at full width and depth (1.64e9 bf16
   parameters, fp32 moments, ``remat="full"``): 4 steps of 2 x 2048
   tokens from ``TokenPipeline(seed=0)``, counts reset just before and
   read just after (each step: 64 forward launches of each LM kernel,
   the layer's own and its recomputation, all attention on the tensor
   cores, and 32 of each backward kernel, attention's all on the
   tensor-core route); step ms (median of the last 3), tokens/s, peak
   memory, and a traced step's busy ms with the device ms of each
   backward kernel; (a) the first step through the plain
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
   CPU from the same seeds;
21. minicpm3-4b serving (MLA) at full width and depth (62 layers,
   d_model 2560, 40 heads, q.k 96, v 64, 4.26e9 bf16 parameters) as
   phase 10 serves hymba-1.5b: 62 attention launches a prefill, all on
   the tensor cores (q.k 96) and none on FFMA; bf16 and fp32 checks
   against the plain route, the decode
   continuation; the latent cache's bytes beside a GQA cache's of 40
   heads of 96;
22. minicpm3-4b training at full width cut to 31 of its 62 layers (22
   bytes a parameter: full depth needs about 94 GB) as phase 18 trains
   hymba-1.5b, 3 steps (the first step's state waits on the host while
   the step runs again from the same state: three do not fit): 186
   forward and 93 backward attention launches, all on the tensor cores
   and none on FFMA;
23. qwen2-7b serving at full width and depth (28 layers, 28/4 heads of
   128, 7.62e9 bf16 parameters) as phase 10 (its bf16 and fp32
   checks), on the tensor-core attention, then the same 32 decode steps
   again from the same prompts
   with ``kv_cache_dtype="int8"`` (its prefill's logits the native
   prefill's bits), fed the native run's tokens: each step's logits
   within 5e-2 of the native's max abs (the reference's bound); decode
   ms a step and the cache's bytes of each;
24. the MoE FFN (``repro_torch.models.moe``): (a) qwen3-moe-235b-a22b
   at full width (d_model 4096, 64/4 heads of 128, 128 experts of d_ff
   1536, top-8, vocab 151,936, capacity factor 1.25) cut to 8 of its 94
   layers (2.115e10 bf16 parameters, 42.3 GB; the whole model does not
   fit one card), served as phase 10: 8 attention launches a prefill,
   all on the tensor cores; the (token, k) pairs dropped at the prefill
   (capacity 321) and at decode (capacity 1); every comparison across
   routes (kernel against plain, SDPA and float64 attention; the decode
   continuation, which runs at ample capacity, 16, where nothing drops)
   replays the first route's expert choices (``RouteTape``) and logs
   the share it would have chosen otherwise, then holds the bf16 bound
   of phase 10; the fp32 check on a cut of 2 layers drawn after the
   bf16 weights are freed; (d) ``kmeans_router_init`` on its embedding
   table from 2 x 2048 sample tokens (128 centroids of 4096): routers in
   bf16, the same every layer, unit columns; entropy and max/mean load
   of the random and the k-means routers; (b) llama4-scout-17b-a16e at
   full width (d_model 5120, 40/8 heads of 128, 16 experts of d_ff
   8192, top-1, vocab 202,048) cut to 4 of 48 layers, 8 decode steps,
   as (a); (c) one MoE layer at qwen3-moe's full width, 2 x 2048 tokens
   in bf16, forward and backward twice: output and the gradients of x
   and the four leaves ``torch.equal``; against fp32 with the bf16
   choices replayed within 3e-2 of scale; ms by CUDA events and a
   pass's device ms, cuBLAS against the rest.
25. the sharded train state (``repro_torch.launch``,
   ``train.make_sharded_train_step``, the parent's cached memory freed
   first): (a) hymba-1.5b at full width cut to 16 of 32 layers (bf16
   parameters from a seeded generator, fp32 moments, ``remat="full"``)
   over a world of 4 ``gloo`` ranks sharing the card, mesh (2, 2)
   ("data", "model"), 3 steps of 2 x 2048 tokens, the main path (the LM
   kernels' counts reset just before and read just after on every
   rank): step 1's loss within 2e-3 and ``grad_norm`` within 1e-2
   (relative) of the parent's single-device step from the same state,
   the same step twice from one state bit for bit, every shard the
   shape DTensor's rule gives, the ranks' losses alike, each step's
   time and its transfers' time, each rank's peak memory; in the same
   world, on phase 19's cut (2 layers, 512 tokens, full width: its
   checkpoints about 2 GB), (b) the state after 2 steps saved (each
   distinct shard sent to rank 0, which writes) and resumed on mesh
   (4, 1) through ``ElasticController``, the saved and the resumed
   state's shards each their slice of the file bit for bit, and the
   parent's unsharded restore of the same checkpoint the file's bits,
   and (c) ``ResilientLoop(state_shardings=...)``, 4 steps, a
   checkpoint every 2, a failure at step 2, bit for bit its
   uninterrupted run; (f) ``python -m repro_torch.examples.train_lm``
   as a process beside that world: it exits 0 and its last loss is
   below its first; (d) a world of 1 over NCCL at full depth: the
   sharded step on the trivial mesh bit for bit phase 18's first step
   from the same state (parameters, moments, loss); (e) ``python -m
   repro_torch.launch.train --arch hymba-1.5b --steps 6 --batch 2
   --seq 512 --fail-at 3`` as a process: it exits 0 and prints its loss
   and ``restarts=1``; (g) ``roofline.model_flops`` of phases 18 and
   22's steps over their median step times and the card's bf16 peak,
   beside the card's name and power limit.

Phases 11-17 run after phase 7, before 2c; 2d, then 18-25, after 10.
The last lines are a ``kernels`` JSON line (each kernel's ``launches``
is the sum of its ``launches_by_path``: the k-means kernels' on the
main fit and predict, phase 13's ``kernel`` backend, phase 14's stream,
phase 15's resilient stream, phase 16's sharded fit and phase 17's
sharded stream, each summed over its ranks; the LM kernels' on the
serving paths of phases 10, 21, 23 and 24 and the training steps of
phases 18, 22 and 25 (a), the last summed over its ranks), the card's
name
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
# phase 21: MLA serving, minicpm3-4b at full width and depth; phase 22:
# its training at full width, cut to 31 of its 62 layers (full depth
# needs about 94 GB at 22 bytes a parameter)
MLA_SERVE = dict(arch="minicpm3-4b", batch=2, prompt=2048, steps=32)
MLA_TRAIN = dict(arch="minicpm3-4b", layers=31, batch=2, seq=2048, steps=3)
# phase 23: qwen2-7b serving at full width and depth, natively and with
# the int8 KV cache from the same prefill
INT8_SERVE = dict(arch="qwen2-7b", batch=2, prompt=2048, steps=32)
# phase 24: the MoE FFN at full width, cut in depth (neither model fits
# one card): qwen3-moe-235b-a22b at 8 of its 94 layers (2.115e10
# parameters, 42.3 GB in bf16) and llama4-scout-17b-a16e at 4 of 48;
# each fp32 check on a cut of 2 layers drawn after the bf16 weights are
# freed
MOE_SERVE = dict(arch="qwen3-moe-235b-a22b", layers=8, batch=2, prompt=2048,
                 steps=32)
SCOUT_SERVE = dict(arch="llama4-scout-17b-a16e", layers=4, batch=2,
                   prompt=2048, steps=8)
MOE_FP32_LAYERS = 2
RESILIENT_TRAIN = dict(layers=2, seq=512, steps=8, ckpt_every=4,
                       fail_at=6)
# phase 25: the sharded train state (repro_torch.launch): hymba-1.5b at
# full width over a world of 4 gloo ranks sharing the card, mesh (2, 2),
# cut to 16 of its 32 layers (8.72e8 parameters: 2.18 GB of shards a
# rank beside its gathered parameters and gradients, 1.74 GB each); the
# elastic resume and the replay on phase 19's cut (2 layers, 512 tokens:
# checkpoints of about 2 GB, where the 16 layers' are 8.7 GB); (d) and
# (e) at full depth, (e) the launcher as a user runs it. The ranks'
# unsharded yardstick steps run one rank at a time (a state and the
# step's new one and fp32 gradients, about 25 GB)
SHARDED_TRAIN = dict(arch="hymba-1.5b", world=4, mesh=(2, 2), layers=16,
                     batch=2, seq=2048, steps=3, seed=9, elastic=(4, 1),
                     save_at=2, timeout=900, rate_bytes=64 << 20,
                     replay=dict(layers=2, seq=512, steps=4, ckpt_every=2,
                                 fail_at=2))
# phase 25 (a)'s bounds, relative: the losses and grad_norms of steps 1-3
# against make_train_step's; the full state after steps 1 and 3, by leaf
# (Frobenius: a parameter's change from the initial state, a moment),
# rowwise_train_step's against make_train_step's, and the sharded state
# against rowwise_train_step's (after step 1, after step 3). Readings
# on an H100 80GB HBM3 at 700 W: losses 4.5e-7, 2.8e-5, 2.0e-5 and
# grad_norms 2.0e-4, 4.7e-4, 4.4e-5 from make_train_step's; rowwise
# against make_train_step moments up to 0.066, changes up to 0.22 (bf16
# gradients of one row against one pass over two; step 1's change is
# under bf16's step for most parameters); sharded against rowwise
# bit for bit after step 1, and after step 3 moments 0.022, changes
# 0.082 (the global norm's sums in another order move step 2's clip by
# an ulp, and some bf16 parameters round the other way). A gradient
# shard on another parameter's shard is off by about 1.4.
SHARDED_BOUNDS = dict(loss=2e-4, grad_norm=2e-3, params=0.5, moments=0.2,
                      rowwise_loss=1e-4, rowwise_params=(1e-6, 0.3),
                      rowwise_moments=(1e-6, 0.1))
LAUNCHER = ["--arch", "hymba-1.5b", "--steps", "6", "--batch", "2", "--seq",
            "512", "--fail-at", "3"]
# phase 20: the k-means clusters of phase 10's layer-0 KV cache
KV_CLUSTERS = 64
# phase 2b: filtered_assign at a D too wide for whole rows in shared
# memory (N points, K centroids, the share of blocks live)
FA_WIDE = dict(n=1 << 16, k=1024, density=0.5)
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
          f"attention kernels did not compile to wgmma")
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
    calls under ``torch.profiler``, after one warm-up call and a
    profiler step of ``calls`` more calls whose records are dropped:
    started cold, the profiler can miss the first calls' kernels, and
    each kernel then reads a whole number of calls short (PERF.md §6).
    A kernel seen a number of times that is not a multiple of ``calls``
    is logged."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            sync()
            prof.step()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            out[ev.key] = ev.self_device_time_total / 1e3 / calls
            if ev.count % calls:
                log(f"device_ms_by_kernel: {ev.key[:60]} seen {ev.count} "
                    f"times in {calls} calls")
    return out


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

    def attn_case(label, q, k, v, entry_point=False, timed=False,
                  library_v=None):
        """``library_v``: the unpadded values of an MLA launch (v zero-
        padded to q.k's width); SDPA takes them as the library call, and
        every row is held to ``ROW_REL_TOL`` whatever the route."""
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
        if library_v is not None:
            # v's zero padding gives output columns of exactly 0
            pad = got[..., library_v.shape[-1]:]
            entry["padded_max_abs"] = float(pad.float().abs().max())
            check(bool((pad == 0).all()), f"flash_attention {label}: the "
                  f"padded output columns are not 0 (max abs "
                  f"{entry['padded_max_abs']:.3g})")
        if route == "tc" or library_v is not None:
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
            # v and o at v's own width: MLA's zero padding is no work the
            # function needs
            dv = d if library_v is None else library_v.shape[-1]
            nbytes = q.element_size() * (b * s * (h + kvh) * (d + dv))
            # QK^T (d long) and P.V (dv long) over the causal half:
            # s(s+1)/2 pairs a head
            flops = 2.0 * (d + dv) * b * h * s * (s + 1) / 2
            peak = fp32 if q.dtype == torch.float32 else bf16
            bound_ms, by = roof(nbytes, flops, bw, peak)
            lib_v = v if library_v is None else library_v
            lib = sdpa_gqa(q, k, lib_v)
            entry["library_vs_plain_max_abs"] = float(
                (lib.float() - want[..., :lib_v.shape[-1]].float()).abs()
                .max())
            del lib

            def new():
                return kernels.flash_attention_gqa(q, k, v)

            def library():
                return sdpa_gqa(q, k, lib_v)
            # SDPA first and last, the kernel's turns between
            turns = {"library": [median_ms(library)], "new": []}
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
            if not entry_point:
                # the training forward, which also writes each row's L,
                # in turns with the serving launch: lse, new, lse
                def with_lse():
                    return fla.flash_attention_gqa_with_lse(q, k, v)
                turns["lse"] = [median_ms(with_lse)]
                turns["new"].append(median_ms(new))
                turns["lse"].append(median_ms(with_lse))
                entry["lse_ms"] = statistics.mean(turns["lse"])
            turns["library"].append(median_ms(library))
            entry.update(
                ms=statistics.mean(turns["new"]), turns_ms=turns,
                plain_ms=median_ms(
                    lambda: fla.flash_attention_gqa_plain(q, k, v), reps=3,
                    inner=1),
                bound_ms=bound_ms, bound_by=by,
                library_ms=statistics.mean(turns["library"]))
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
    # MLA's launch at minicpm3-4b's prefill: KV = H, q.k of nope + rope,
    # v zero-padded from v_dim to that width (the tensor cores at 96)
    mla = get_config(MLA_SERVE["arch"])
    hm, dm = mla.n_heads, mla.mla.nope_dim + mla.mla.rope_dim
    vm = randn(b, s, hm, mla.mla.v_dim, dtype=bf)
    mla_entry = attn_case(
        f"{mla.name} MLA prefill B={b} S={s} (v {mla.mla.v_dim} padded to "
        f"{dm})", randn(b, s, hm, dm, dtype=bf), randn(b, s, hm, dm, dtype=bf),
        F.pad(vm, (0, dm - mla.mla.v_dim)), timed=True, library_v=vm)
    del vm
    # qwen2-7b's launch at its prefill (phase 23): bf16 at head dim 128,
    # the tensor-core route
    qw = get_config(INT8_SERVE["arch"])
    qb, qs = INT8_SERVE["batch"], INT8_SERVE["prompt"]
    qwen2_entry = attn_case(
        f"{qw.name} prefill B={qb} S={qs}",
        randn(qb, qs, qw.n_heads, qw.head_dim, dtype=bf),
        *(randn(qb, qs, qw.n_kv_heads, qw.head_dim, dtype=bf)
          for _ in range(2)), timed=True)
    # qwen3-moe-235b-a22b's launch at its prefill (phase 24): 64/4 heads
    # of 128, a GQA group of 16
    qm = get_config(MOE_SERVE["arch"])
    mb, ms_ = MOE_SERVE["batch"], MOE_SERVE["prompt"]
    moe_entry = attn_case(
        f"{qm.name} prefill B={mb} S={ms_}",
        randn(mb, ms_, qm.n_heads, qm.head_dim, dtype=bf),
        *(randn(mb, ms_, qm.n_kv_heads, qm.head_dim, dtype=bf)
          for _ in range(2)), timed=True)

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
    return attn_main, ssd_main, dict(mla=mla_entry, qwen2=qwen2_entry,
                                     moe=moe_entry)


class RouteTape:
    """The port's expert choices (``repro_torch.models.moe.route``),
    recorded call by call or replayed, so that the second route of a
    comparison takes the first route's experts: in bf16 an ulp of
    attention flips some choices, and logits compared across a flip
    measure an expert swap, not the attention. ``moe_ffn`` looks
    ``route`` up at every call, so one swap reaches every layer."""

    def __init__(self):
        self.moe = importlib.import_module("repro_torch.models.moe")
        self.route = self.moe.route

    @contextlib.contextmanager
    def _swapped(self, fn):
        self.moe.route = fn
        try:
            yield
        finally:
            self.moe.route = self.route

    @contextlib.contextmanager
    def record(self):
        """Yields ``{"calls": [(experts, cfg), ...]}``, filled as the
        layers route (nothing but a list append on the path)."""
        tape = {"calls": []}

        def recorded(xf, router, cfg):
            gates, experts = self.route(xf, router, cfg)
            tape["calls"].append((experts, cfg))
            return gates, experts
        with self._swapped(recorded):
            yield tape

    @contextlib.contextmanager
    def replay(self, calls):
        """Route each call to the experts of ``calls`` (a record's, in
        order), the gates the softmax of this route's own logits at
        them: where the choices agree, the real route's bits. Yields
        ``{"differ": [...], "entries": [...]}``: per call, the choices
        this route would have made that the replayed ones lack."""
        import torch
        it = iter(calls)
        tape = {"differ": [], "entries": []}

        def replayed(xf, router, cfg):
            experts, _ = next(it)
            check(tuple(experts.shape) == (xf.shape[0], cfg.moe_top_k),
                  f"route replay: {tuple(experts.shape)} recorded for "
                  f"{xf.shape[0]} tokens")
            logits = (xf @ router.to(xf.dtype)).float()
            own = self.route(xf, router, cfg)[1]
            tape["differ"].append(
                (own[:, :, None] != experts[:, None, :]).all(-1).sum())
            tape["entries"].append(experts.numel())
            return torch.softmax(logits.gather(1, experts), -1), experts
        with self._swapped(replayed):
            yield tape
        check(next(it, None) is None, "route replay: recorded calls left "
              "over (the replayed path routed fewer times)")


def routed(tape, calls=None):
    """``tape.record()``, or ``tape.replay(calls)`` where calls are
    given; a no-op where there is no tape (no MoE)."""
    if tape is None:
        return contextlib.nullcontext({})
    return tape.record() if calls is None else tape.replay(calls)


def differ_share(rep):
    """The share of replayed choices the route would have made
    otherwise (None where nothing was replayed)."""
    if not rep.get("entries"):
        return None
    return float(sum(int(d) for d in rep["differ"])) / sum(rep["entries"])


def dropped(calls):
    """(token, k) pairs each recorded call dropped: each expert keeps
    ``moe.capacity(cfg, T)`` of its pairs."""
    import torch
    moe = importlib.import_module("repro_torch.models.moe")
    out = []
    for experts, cfg in calls:
        load = torch.bincount(experts.reshape(-1), minlength=cfg.n_experts)
        cap = moe.capacity(cfg, experts.shape[0])
        out.append(int((load - cap).clamp(min=0).sum()))
    return out


def splice(first, step, batch):
    """Per layer, a prefill's recorded choices (B * S tokens) followed by
    one decode step's (B tokens) in a prefill of S + 1 tokens' order."""
    import torch
    out = []
    for (a, cfg), (b_, _) in zip(first, step):
        k = a.shape[1]
        out.append((torch.cat([a.view(batch, -1, k), b_.view(batch, 1, k)],
                              1).reshape(-1, k), cfg))
    return out


def greedy_token(logits, cfg):
    return logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)


def continuation(dev, cfg, params, tokens, tape):
    """The first decode step from a prefill of ``tokens`` against the
    last position of a prefill one token longer: (max difference over
    scale, the share of choices replayed against the longer prefill's
    own). A MoE config runs at ample capacity (``n_experts /
    moe_top_k``: nothing drops at any T, as the reference's
    ``test_moe_decode_matches_with_ample_capacity``), the longer
    prefill replaying the prefill's and the step's choices."""
    import torch

    from repro_torch.train import make_prefill_step, make_serve_step
    if tape is not None:
        cfg = dataclasses.replace(
            cfg, moe_capacity_factor=cfg.n_experts / cfg.moe_top_k)
    b, s = tokens.shape
    prefill = make_prefill_step(cfg)
    with routed(tape) as first:
        lg, pc = prefill(params, {"tokens": tokens})
    cache = decode_cache(cfg, pc, s + 1, dev)
    del pc
    tok = greedy_token(lg, cfg)
    with routed(tape) as step:
        dec, _c = make_serve_step(cfg)(params, cache, tok, s)
    del _c, cache
    calls = None if tape is None else splice(first["calls"], step["calls"], b)
    with routed(tape, calls) as rep:
        longer, _c = prefill(params, {"tokens": torch.cat([tokens, tok], 1)})
    del _c
    return rel_err(dec, longer), differ_share(rep)


def serve_phase(dev, gen, wrappers, cfg, batch, prompt, steps, expect,
                int8=False, params=None):
    """Phase 10 (and 21, 23, 24): the LM serving path of ``cfg``:
    ``batch`` prompts of ``prompt`` tokens, then ``steps`` greedy decode
    steps, held against the plain route in bf16 and, with the same
    weights, in fp32. ``expect``: each kernel's launches on that path
    (counters not named there must not move). ``int8``: then decode the
    same steps again, from the same prefill, with
    ``kv_cache_dtype="int8"``, fed the native run's tokens, each step's
    logits within 5e-2 of the native's max abs. ``params``: the weights
    (drawn from ``gen`` where None). A MoE config's comparisons replay
    the first route's expert choices (:class:`RouteTape`), and its fp32
    check is the caller's (``moe_serve_phase``: a cut of the model, as
    the served weights widened do not fit). Returns the report, with the
    launches of the main path (prefill + decode), and the decode
    cache."""
    import torch

    from repro_torch.models import init_params
    from repro_torch.train import make_prefill_step, make_serve_step

    b, s = batch, prompt
    label = f"serve {cfg.name}"
    tape = RouteTape() if cfg.family == "moe" else None
    t0 = time.perf_counter()
    if params is None:
        params = init_params(cfg, gen, device=dev)
    sync()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    shape = (f"{cfg.n_heads}/{cfg.n_kv_heads} heads"
             + (f", ssm d_inner {cfg.ssm.d_inner}" if cfg.ssm else "")
             + (f", MLA {cfg.mla}" if cfg.mla else "")
             + (f", {cfg.n_experts} experts of d_ff {cfg.d_ff}, top-"
                f"{cfg.moe_top_k}, capacity factor {cfg.moe_capacity_factor}"
                if tape else ""))
    log(f"{label}: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}"
        f", {shape}), {n_params} params, {n_bytes / 2**30:.3f} GiB in "
        f"{cfg.dtype}, ready in {time.perf_counter() - t0:.2f} s")
    prefill = make_prefill_step(cfg)
    serve_step = make_serve_step(cfg)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)

    # the main path: one prefill, then greedy decode steps
    reset_launches(wrappers)
    torch.cuda.reset_peak_memory_stats(dev)
    sync()
    t0 = time.perf_counter()
    with routed(tape) as main_pf:
        logits, pcache = prefill(params, {"tokens": tokens})
    # one position more than the path uses, for the traced step below
    cache = decode_cache(cfg, pcache, s + steps + 1, dev)
    del pcache
    tok = greedy_token(logits, cfg)
    step_ms, fed, dec_logits = [], [], []
    with routed(tape) as main_dec:
        for t in range(steps):
            sync()
            t1 = time.perf_counter()
            fed.append(tok)
            dlogits, cache = serve_step(params, cache, tok, s + t)
            tok = greedy_token(dlogits, cfg)
            sync()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            dec_logits.append(dlogits)
    path_s = time.perf_counter() - t0
    launches = read_launches(wrappers)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"{label}: main path (prefill + {steps} decode steps) "
        f"{path_s:.3f} s; launches {launches}; peak memory "
        f"{peak_gib:.3f} GiB")
    check(tuple(logits.shape) == (b, 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all())
          and bool(torch.isfinite(dlogits).all()),
          f"{label}: non-finite or misshapen logits")
    for nm, cnt in launches.items():
        check(cnt == expect.get(nm, 0), f"{label}: {nm} launched {cnt} "
              f"times on the main path, not {expect.get(nm, 0)}")
    routing = {}
    if tape:
        moe = importlib.import_module("repro_torch.models.moe")
        by_layer = dropped(main_pf["calls"])
        routing = dict(
            capacity_prefill=moe.capacity(cfg, b * s),
            capacity_decode=moe.capacity(cfg, b),
            dropped_prefill=sum(by_layer),
            dropped_prefill_by_layer=by_layer,
            pairs_prefill=cfg.n_layers * b * s * cfg.moe_top_k,
            dropped_decode=sum(dropped(main_dec["calls"])),
            pairs_decode=cfg.n_layers * steps * b * cfg.moe_top_k)
        log(f"{label}: (token, k) pairs dropped over {cfg.n_layers} layers: "
            f"prefill {routing['dropped_prefill']} of "
            f"{routing['pairs_prefill']} (capacity "
            f"{routing['capacity_prefill']}; by layer {by_layer}), decode "
            f"{routing['dropped_decode']} of {routing['pairs_decode']} "
            f"(capacity {routing['capacity_decode']})")

    # prefill time: median of 3 after the main path's warm-up call
    pre_ms = []
    for _ in range(3):
        sync()
        t1 = time.perf_counter()
        again, _c = prefill(params, {"tokens": tokens})
        sync()
        pre_ms.append((time.perf_counter() - t1) * 1e3)
        del _c
    check(torch.equal(again, logits), f"{label}: a repeat prefill differs")

    # The served dtype, bf16: over 32 layers of random weights the bf16
    # roundings of any two correct attentions part the logits by about
    # 3e-2 of scale (scripts/lm_bf16_floor.py), so the bound is 3e-2 or
    # 1.5 times the farthest that two other correct attentions, PyTorch's
    # SDPA and one in float64, land from the plain route on the same
    # prompts, whichever is larger. A MoE route replays the main
    # prefill's expert choices.
    pf_calls = main_pf.get("calls")
    ssd_plain = kernel_module("ssd_intra").ssd_intra_chunks_plain
    with plain_route(), routed(tape, pf_calls) as rep_plain:
        plain_logits, _c = prefill(params, {"tokens": tokens})
        del _c
    floors, shares = {}, {"plain": differ_share(rep_plain)}
    for nm, attention in (("sdpa", sdpa_gqa), ("float64", exact_gqa)):
        with lm_route(attention, ssd_plain), routed(tape, pf_calls) as rep_:
            other, _c = prefill(params, {"tokens": tokens})
        floors[nm] = rel_err(other, plain_logits)
        shares[nm] = differ_share(rep_)
        del _c, other
    plain_err = rel_err(logits, plain_logits)
    floor = max(floors.values())
    # decode continuation: position s decoded from the cache against the
    # last position of a prefill of s + 1 tokens
    cont_err, shares["continuation"] = continuation(dev, cfg, params, tokens,
                                                    tape)
    bound = max(1.5 * floor, 3e-2)
    log(f"{label} bf16: kernel vs plain prefill logits {plain_err:.4g} of "
        f"scale; SDPA vs plain {floors['sdpa']:.4g}, float64 attention vs "
        f"plain {floors['float64']:.4g}; decode continuation "
        f"{cont_err:.4g}; bound {bound:.4g}")
    if tape:
        routing["replayed_differ_share"] = shares
        log(f"{label} bf16: share of expert choices a route would have "
            f"made otherwise (replayed): {shares}")
    check(plain_err <= bound, f"{label}: bf16 kernel prefill is "
          f"{plain_err:.3g} of scale from the plain one, beyond {bound:.3g}")
    check(cont_err <= bound, f"{label}: bf16 decode continuation "
          f"{cont_err:.3g} of scale, beyond {bound:.3g}")
    del plain_logits
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
               cache_bytes=sum(t.numel() * t.element_size()
                               for t in cache.values()),
               cache_positions=s + steps + 1)
    if tape:
        rep["routing"] = routing
    if int8:
        rep["int8"] = int8_decode(dev, cfg, params, tokens, logits, fed,
                                  dec_logits, s, label)
    del dec_logits
    if not tape:
        rep.update(fp32_check(dev, dataclasses.replace(cfg, dtype="float32"),
                              _widen(params), tokens, label))
    log(f"{label}: prefill {prefill_ms:.2f} ms median of {pre_ms} "
        f"({rep['prefill_tokens_per_s']:.4g} tokens/s); decode "
        f"{decode_ms:.3f} ms per step median ({rep['decode_tokens_per_s']:.4g}"
        f" tokens/s, first step {step_ms[0]:.2f} ms); cache "
        f"{rep['cache_bytes']} bytes for {rep['cache_positions']} positions")
    rep["trace"] = traced(lambda: prefill(params, {"tokens": tokens}),
                          f"traced prefill ({cfg.name})")
    rep["trace_decode"] = traced(
        lambda: serve_step(params, cache, tok, s + steps),
        f"traced decode step ({cfg.name})")
    return rep, cache


def int8_decode(dev, cfg, params, tokens, logits, fed, dec_logits, s,
                label):
    """The int8 KV cache on the serving path: the prefill with
    ``kv_cache_dtype="int8"`` (the native prefill's logits bit for bit,
    its cache quantized), then the native run's decode steps again, fed
    the tokens the native run fed, each step's logits within 5e-2 of the
    native's max abs (the reference's bound)."""
    import torch

    from repro_torch.train import make_prefill_step, make_serve_step
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    lg8, pc8 = make_prefill_step(cfg8)(params, {"tokens": tokens})
    check(torch.equal(lg8, logits), f"{label} int8: the prefill's logits "
          f"differ from the native prefill's")
    check(pc8["k"].dtype == torch.int8 and pc8["k_scale"].dtype ==
          torch.float32, f"{label} int8: the prefill's cache is not int8")
    cache8 = decode_cache(cfg8, pc8, s + len(fed) + 1, dev)
    del pc8
    serve8 = make_serve_step(cfg8)
    step_ms, errs, agree = [], [], 0
    for t, tok in enumerate(fed):
        sync()
        t1 = time.perf_counter()
        lg, cache8 = serve8(params, cache8, tok, s + t)
        sync()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        want = dec_logits[t]
        errs.append(float((lg - want).abs().max()) / float(want.abs().max()))
        agree += int((lg.argmax(-1) == want.argmax(-1)).all())
    nbytes = sum(t.numel() * t.element_size() for t in cache8.values())
    # the native cache: k and v alone, in the compute dtype
    native = (cache8["k"].numel() + cache8["v"].numel()) * \
        torch.finfo(cfg.compute_dtype).bits // 8
    rep = dict(decode_step_ms=step_ms,
               decode_ms_per_step_median=statistics.median(step_ms[1:]),
               logits_rel_err=errs, max_logits_rel_err=max(errs),
               steps_same_argmax=agree, cache_bytes=nbytes,
               native_cache_bytes=native, cache_ratio=nbytes / native)
    log(f"{label} int8: decode {rep['decode_ms_per_step_median']:.3f} ms per "
        f"step median; logits within {max(errs):.4g} of the native's scale "
        f"(bound 5e-2), the same argmax at {agree} of {len(fed)} steps; "
        f"cache {nbytes} bytes against {native} native "
        f"({rep['cache_ratio']:.4f})")
    check(max(errs) <= 5e-2, f"{label} int8: decode logits {max(errs):.3g} "
          f"of the native's scale, beyond 5e-2")
    return rep


def fp32_check(dev, cfg32, params32, tokens, label):
    """fp32 weights (the served ones widened, or a MoE model's cut):
    kernel against plain prefill and the decode continuation, each
    within 1e-4 of scale; a MoE route replays the kernel prefill's
    expert choices."""
    from repro_torch.train import make_prefill_step

    tape = RouteTape() if cfg32.family == "moe" else None
    prefill32 = make_prefill_step(cfg32)
    with routed(tape) as first:
        lg32, _c = prefill32(params32, {"tokens": tokens})
        del _c
    with plain_route(), routed(tape, first.get("calls")) as rep:
        plain32, _c = prefill32(params32, {"tokens": tokens})
        del _c
    plain_err32 = rel_err(lg32, plain32)
    cont_err32, cont_share = continuation(dev, cfg32, params32, tokens, tape)
    log(f"{label} fp32: kernel vs plain prefill logits {plain_err32:.4g} of "
        f"scale; decode continuation {cont_err32:.4g}"
        + (f"; expert choices replayed, differing share "
           f"{differ_share(rep)} and {cont_share}" if tape else ""))
    check(plain_err32 <= 1e-4, f"{label}: fp32 kernel and plain prefill "
          f"logits differ by {plain_err32:.3g} of scale > 1e-4")
    check(cont_err32 <= 1e-4, f"{label}: fp32 decode continuation "
          f"{cont_err32:.3g} of scale > 1e-4")
    return dict(plain_logits_err_fp32=plain_err32,
                continuation_err_fp32=cont_err32)


def decode_cache(cfg, pcache, max_len, dev):
    """A decode cache of ``max_len`` positions holding a prefill's."""
    from repro_torch.models import init_cache
    some = next(iter(pcache.values()))
    cache = init_cache(cfg, some.shape[1], max_len, device=dev)
    for k_, v_ in pcache.items():
        if k_ in ("ssm", "conv"):
            cache[k_].copy_(v_)
        else:           # k, v, their scales, MLA's latents: (L, B, S, ...)
            cache[k_][:, :, :v_.shape[2]] = v_
    return cache


def _widen(tree):
    return {k: _widen(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# -- phase 24: the MoE FFN -----------------------------------------------------

# cuBLAS's kernels by name on an H100 (the rest of a MoE layer's device
# time is the dispatch and combine glue and the elementwise work)
CUBLAS = re.compile(r"gemm|xmma|nvjet|cutlass", re.I)


def moe_serve_phase(dev, wrappers, spec, seed, router_init=False):
    """Phase 24 (a), (b), (d): ``spec``'s MoE config at full width, cut
    to ``spec["layers"]`` layers, served as phase 10 serves hymba-1.5b
    (``serve_phase``: its bf16 checks with the expert choices replayed,
    the decode continuation at ample capacity); ``router_init``: then
    ``kmeans_router_init`` on its embedding table (24 d). The fp32 check
    runs on a cut of ``MOE_FP32_LAYERS`` layers drawn after the bf16
    weights are freed (the served weights widened do not fit)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    full = get_config(spec["arch"])
    cfg = dataclasses.replace(full, n_layers=spec["layers"])
    nl = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device=dev)
    sync()
    log(f"serve {cfg.name}: full width, cut to {nl} of {full.n_layers} "
        f"layers (the whole model does not fit one card); drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    # bf16 at a head dim of 128: every attention launch on the tensor
    # cores, none on FFMA; decode attends in plain torch
    rep, cache = serve_phase(dev, gen, wrappers, cfg, spec["batch"],
                             spec["prompt"], spec["steps"],
                             expect={"flash_attention": nl,
                                     "flash_attention.tc": nl},
                             params=params)
    rep["layers_of"] = [nl, full.n_layers]
    del cache
    if router_init:
        rep["router_init"] = router_init_check(dev, gen, params, cfg,
                                               spec["batch"], spec["prompt"])
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=MOE_FP32_LAYERS,
                                dtype="float32")
    params32 = init_params(cfg32, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (spec["batch"], spec["prompt"]),
                           generator=gen, device=dev)
    rep["fp32_layers"] = cfg32.n_layers
    rep.update(fp32_check(dev, cfg32, params32, tokens,
                          f"serve {cfg.name} ({cfg32.n_layers}-layer cut)"))
    del params32
    torch.cuda.empty_cache()
    return rep


def router_init_check(dev, gen, params, cfg, batch, seq):
    """Phase 24 (d): ``kmeans_router_init`` on the served model's
    embedding table, ``batch`` x ``seq`` sample tokens (``n_experts``
    centroids of d_model): every layer the same (D, E) router in the
    embedding's dtype, unit columns, finite; the entropy and max/mean
    load of the layer-0 top-1 choices of the random and the k-means
    routers, as ``repro_torch.examples.expert_bootstrap`` reports
    them."""
    import torch

    from repro_torch.core.integrations import kmeans_router_init
    from repro_torch.examples.expert_bootstrap import routing_stats
    label = f"kmeans_router_init {cfg.name}"
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=dev)
    ent_r, load_r = routing_stats(params, cfg, tokens)
    sync()
    t0 = time.perf_counter()
    km = kmeans_router_init(params, cfg, tokens, seed=0)
    sync()
    secs = time.perf_counter() - t0
    router = km["layers"]["moe"]["router"]
    check(tuple(router.shape) == (cfg.n_layers, cfg.d_model, cfg.n_experts)
          and router.dtype == params["embed"].dtype
          and bool(torch.isfinite(router).all()),
          f"{label}: a router of {tuple(router.shape)} {router.dtype}")
    check(all(torch.equal(router[0], r_) for r_ in router[1:]),
          f"{label}: the layers' routers differ")
    norms = router[0].float().norm(dim=0)
    check(float((norms - 1).abs().max()) <= 1e-2, f"{label}: column norms "
          f"{float(norms.min()):.4g}..{float(norms.max()):.4g}, not 1")
    ent_k, load_k = routing_stats(km, cfg, tokens)
    out = dict(sample_tokens=batch * seq, centroids=cfg.n_experts,
               seconds=secs, random=dict(entropy=ent_r, max_over_mean=load_r),
               kmeans=dict(entropy=ent_k, max_over_mean=load_k),
               max_entropy=math.log(cfg.n_experts))
    log(f"{label}: {batch * seq} sample tokens, {cfg.n_experts} centroids "
        f"of {cfg.d_model} in {secs:.2f} s; random router entropy "
        f"{ent_r:.4f} max/mean load {load_r:.3f}; k-means router entropy "
        f"{ent_k:.4f} max/mean load {load_k:.3f} (max entropy "
        f"{out['max_entropy']:.4f})")
    return out


def moe_layer_phase(dev, gen, cfg, batch, seq):
    """Phase 24 (c): one MoE layer at ``cfg``'s full width (``batch`` x
    ``seq`` tokens, bf16, the config's capacity), forward and backward:
    two passes ``torch.equal`` in the output and the gradients of x,
    router, w_gate, w_up and w_down; against the same layer in fp32 with
    the bf16 pass's expert choices replayed, each within 3e-2 of scale;
    ms by CUDA events; the device ms of a pass by kernel, cuBLAS against
    the rest (the dispatch and combine glue, the elementwise work)."""
    import torch
    moe = importlib.import_module("repro_torch.models.moe")
    label = f"moe layer {cfg.name}"
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff

    def draw(*shape, std=1.0):
        w = torch.randn(shape, generator=gen, device=dev).mul_(std)
        return w.to(torch.bfloat16).requires_grad_()
    p = {"router": draw(d, e, std=d ** -0.5),
         "w_gate": draw(e, d, f, std=d ** -0.5),
         "w_up": draw(e, d, f, std=d ** -0.5),
         "w_down": draw(e, f, d, std=f ** -0.5)}
    x = draw(batch, seq, d)
    g_out = torch.randn((batch, seq, d), generator=gen,
                        device=dev).to(torch.bfloat16)

    def fwd_bwd(xx, pp, gg):
        for t in (xx, *pp.values()):
            t.grad = None
        out = moe.moe_ffn(xx, pp, cfg)
        out.backward(gg)
        return out.detach(), {"x": xx.grad} | {k: v.grad for k, v in
                                               pp.items()}
    tape = RouteTape()
    with tape.record() as rec:
        out1, g1 = fwd_bwd(x, p, g_out)
    out2, g2 = fwd_bwd(x, p, g_out)
    same = {"out": torch.equal(out1, out2)} | {
        k: torch.equal(g1[k], g2[k]) for k in g1}
    log(f"{label}: two forward-and-backward passes torch.equal: {same}")
    check(all(same.values()), f"{label}: two passes differ: {same}")
    del out2, g2
    drops = sum(dropped(rec["calls"]))
    x32 = x.detach().float().requires_grad_()
    p32 = {k: v.detach().float().requires_grad_() for k, v in p.items()}
    with tape.replay(rec["calls"]) as rep:
        out32, g32 = fwd_bwd(x32, p32, g_out.float())
    errs = {"out": rel_err(out1, out32)} | {k: rel_err(g1[k], g32[k])
                                            for k in g1}
    share = differ_share(rep)
    del x32, p32, out32, g32, out1, g1
    torch.cuda.empty_cache()
    log(f"{label}: bf16 against fp32 with the bf16 choices replayed, max "
        f"difference over scale {errs} (bound 3e-2); fp32 would have "
        f"chosen otherwise at {share} of the entries; {drops} of "
        f"{batch * seq * cfg.moe_top_k} (token, k) pairs dropped at "
        f"capacity {moe.capacity(cfg, batch * seq)}")
    for nm, err in errs.items():
        check(err <= 3e-2, f"{label}: {nm} {err:.3g} of scale from fp32")

    def forward():
        with torch.no_grad():
            return moe.moe_ffn(x, p, cfg)
    fwd_ms = median_ms(forward)
    pass_ms = median_ms(lambda: fwd_bwd(x, p, g_out), reps=5, inner=2)
    by_kernel = device_ms_by_kernel(lambda: fwd_bwd(x, p, g_out), calls=5)
    gemm = sum(v for k, v in by_kernel.items() if CUBLAS.search(k))
    glue = {k: v for k, v in by_kernel.items() if not CUBLAS.search(k)}
    top = sorted(glue.items(), key=lambda kv: -kv[1])[:8]
    log(f"{label}: forward {fwd_ms:.3f} ms, forward and backward "
        f"{pass_ms:.3f} ms (CUDA events); device ms a pass: cuBLAS "
        f"{gemm:.3f}, the rest {sum(glue.values()):.3f}")
    for k, v in top:
        log(f"  {v:9.4f} ms  {k[:90]}")
    return dict(tokens=batch * seq, dtype="bfloat16", bits_equal=same,
                fp32_rel_err=errs, fp32_differ_share=share, dropped=drops,
                capacity=moe.capacity(cfg, batch * seq), forward_ms=fwd_ms,
                forward_backward_ms=pass_ms, device_ms_cublas=gemm,
                device_ms_rest=sum(glue.values()),
                device_ms_rest_top=[[k, v] for k, v in top])


# -- phase 2d: the backward kernels against their plain versions --------------

def rel_err(a, b) -> float:
    """max |a - b| over the largest |b|, in fp32."""
    b = b.float()
    return float((a.float() - b).abs().max()) / (float(b.abs().max())
                                                 + 1e-30)


def row_errs(got, want) -> dict:
    """``flash_attention.row_rel_err`` of dq's query rows and of dk's
    and dv's key rows, under the backward's floor."""
    fla = kernel_module("flash_attention")
    return {nm: fla.row_rel_err(g, w, fla.BWD_ROW_FLOOR)
            for nm, g, w in zip(("dq", "dk", "dv"), got, want)}


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

    bwd = fla.flash_attention_gqa_bwd

    def route_counts():
        return {"tc": bwd.launches_tc, "ffma": bwd.launches_ffma}

    def attn_case(label, b, s, h, kvh, d, dtype, timed=False, v_dim=None):
        """``v_dim``: MLA's values, that wide and zero-padded to ``d`` (as
        is their output gradient); SDPA's autograd takes them unpadded."""
        q, do = randn(b, s, h, d, dtype=dtype), randn(b, s, h, d, dtype=dtype)
        k, v = (randn(b, s, kvh, d, dtype=dtype) for _ in range(2))
        vd = d if v_dim is None else v_dim
        if vd < d:
            v, do = (torch.nn.functional.pad(t[..., :vd], (0, d - vd))
                     for t in (v, do))
        # the training forward: the output and each row's L
        o, lse = fla.flash_attention_gqa_with_lse(q, k, v)
        route = fla.route_for(dtype, d)
        before = route_counts()
        got = fla.flash_attention_gqa_bwd(q, k, v, o, do, lse)
        again = fla.flash_attention_gqa_bwd(q, k, v, o, do, lse)
        moved = {r: n - before[r] for r, n in route_counts().items()}
        want = fla.flash_attention_gqa_bwd_plain(q, k, v, o, do)
        # the forward's L against the plain logsumexp
        lse_err = float((lse - fla.flash_attention_gqa_lse_plain(q, k, v)[1])
                        .abs().max())
        sync()
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        del again
        check(moved == {r: 2 * (r == route) for r in moved},
              f"flash_attention_bwd {label}: two calls moved the route "
              f"counts by {moved}, not 2 on {route!r}")
        lse_tol = 1e-4 if dtype == torch.float32 else 1e-3
        check(lse_err <= lse_tol, f"flash_attention {label}: the forward's "
              f"L is {lse_err:.3g} from the plain logsumexp, beyond "
              f"{lse_tol}")
        names = ("dq", "dk", "dv")
        errs = {nm: rel_err(g, w) for nm, g, w in zip(names, got, want)}
        rows = row_errs(got, want)
        floor = lib_rows = None
        def sdpa_leaves():
            return [t.clone().requires_grad_(True)
                    for t in (q, k, v[..., :vd])]
        if dtype == torch.float32:
            tol = 1e-4
        else:
            # another correct backward: autograd through SDPA
            leaves = sdpa_leaves()
            lib = list(torch.autograd.grad(sdpa_gqa(*leaves), leaves,
                                           do[..., :vd]))
            lib[2] = torch.nn.functional.pad(lib[2], (0, d - vd))
            floor = max(rel_err(a, w) for a, w in zip(lib, want))
            lib_rows = row_errs(lib, want)
            tol = max(3e-2, 1.5 * floor)
            del lib, leaves
        check(same, f"flash_attention_bwd {label}: two calls differ")
        if vd < d:
            # dO's zero padding gives dv columns of exactly 0
            check(bool((got[2][..., vd:] == 0).all()),
                  f"flash_attention_bwd {label}: dv's padded columns are "
                  f"not 0")
        check(all(bool(torch.isfinite(g).all()) and g.shape == w.shape
                  and g.dtype == dtype for g, w in zip(got, want)),
              f"flash_attention_bwd {label}: non-finite or misshapen grads")
        check(max(errs.values()) <= tol, f"flash_attention_bwd {label}: "
              f"{errs} of the plain version's scale, beyond {tol:.3g}")
        check(max(rows.values()) <= fla.BWD_ROW_REL_TOL,
              f"flash_attention_bwd {label}: a row lies {rows} from the "
              f"plain version's, beyond {fla.BWD_ROW_REL_TOL}")
        entry = dict(case=label, shape=dict(b=b, s=s, h=h, kv=kvh, d=d),
                     dtype=str(dtype), route=route, rel_err=errs, tol=tol,
                     row_rel_err=rows, row_tol=fla.BWD_ROW_REL_TOL,
                     sdpa_rel_err=floor, sdpa_row_rel_err=lib_rows,
                     deterministic=same,
                     lse_max_abs_err=lse_err, lse_tol=lse_tol,
                     max_abs_err=max(float((g.float() - w.float()).abs()
                                           .max())
                                     for g, w in zip(got, want)))
        del got
        if timed and route == "tc":
            # the earlier kernels, the FFMA route, on the same inputs
            ffma = fla.launch_gqa_bwd(q, k, v, o, do, lse, "ffma")
            entry["ffma_rel_err"] = max(rel_err(g, w)
                                        for g, w in zip(ffma, want))
            entry["ffma_row_rel_err"] = max(row_errs(ffma, want).values())
            check(entry["ffma_rel_err"] <= tol and entry["ffma_row_rel_err"]
                  <= fla.BWD_ROW_REL_TOL, f"flash_attention_bwd {label}: "
                  f"the FFMA route is {entry['ffma_rel_err']:.3g} (rows "
                  f"{entry['ffma_row_rel_err']:.3g}) from the plain version")
            del ffma
        del want
        if timed:
            es = q.element_size()
            pairs = b * h * s * (s + 1) / 2     # the causal half
            # q, dq, k, dk at q.k's width; o, dO, v, dv at v's own (MLA's
            # zero padding is no work the function needs)
            nbytes = es * 2 * b * s * (h + kvh) * (d + vd)
            # the five products a backward needs: S again, dQ and dK (d
            # long), dV and dP (vd long); 2.5x the forward's at vd = d
            flops = 2.0 * (3 * d + 2 * vd) * pairs
            peak = fp32 if dtype == torch.float32 else bf16
            bound_ms, by = roof(nbytes, flops, bw, peak)
            # the tc route's seven products (S and dP twice), beside it
            design_ms = roof(nbytes, 2.0 * (4 * d + 3 * vd) * pairs, bw,
                             peak)[0]
            leaves = sdpa_leaves()
            out = sdpa_gqa(*leaves)
            do_lib = do[..., :vd]

            def new():
                return fla.flash_attention_gqa_bwd(q, k, v, o, do, lse)

            def library():
                return torch.autograd.grad(out, leaves, do_lib,
                                           retain_graph=True)
            def old():
                return fla.launch_gqa_bwd(q, k, v, o, do, lse, "ffma")
            # in turns: (ffma,) library, new, new, library (, ffma); the
            # FFMA route is the earlier kernels where the new route is tc
            turns = {"ffma": [median_ms(old)]} if route == "tc" else {}
            turns["library"] = [median_ms(library)]
            turns["new"] = [median_ms(new), median_ms(new)]
            turns["library"].append(median_ms(library))
            if route == "tc":
                turns["ffma"].append(median_ms(old))
                entry["earlier_ms"] = statistics.mean(turns["ffma"])
            dev_ms = device_ms_by_kernel(new)
            ms = statistics.mean(turns["new"])
            entry.update(
                ms=ms, turns_ms=turns,
                plain_ms=median_ms(
                    lambda: fla.flash_attention_gqa_bwd_plain(q, k, v, o,
                                                              do),
                    reps=3, inner=1),
                bound_ms=bound_ms, bound_by=by, design_bound_ms=design_ms,
                library_ms=statistics.mean(turns["library"]),
                device_ms=dev_ms, device_ms_sum=sum(dev_ms.values()),
                device_over_events=sum(dev_ms.values()) / ms,
                host_ms=host_ms(new))
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
            ms = median_ms(new)
            dev_ms = device_ms_by_kernel(new)
            entry.update(
                ms=ms, device_ms=dev_ms, device_ms_sum=sum(dev_ms.values()),
                device_over_events=sum(dev_ms.values()) / ms,
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
    # MLA's backward at minicpm3-4b's training shape (the tensor cores)
    mla = get_config(MLA_SERVE["arch"])
    mm = mla.mla
    mla_entry = attn_case(
        f"{mla.name} MLA training B={b} S={s} (v {mm.v_dim} padded to "
        f"{mm.nope_dim + mm.rope_dim})", b, s, mla.n_heads, mla.n_heads,
        mm.nope_dim + mm.rope_dim, bf, timed=True, v_dim=mm.v_dim)
    m = cfg.ssm
    ssd_main = ssd_case(f"{cfg.name} training B={b} S={s}", b, s // m.chunk,
                        m.chunk, m.n_heads, m.n_groups, m.d_state,
                        m.head_dim, timed=True)
    ssd_case(f"{cfg.name} cells Q=100", b, 4, 100, m.n_heads, m.n_groups,
             m.d_state, m.head_dim)
    m2 = get_config("mamba2-780m").ssm
    ssd_case("mamba2-780m cells", b, 4, m2.chunk, m2.n_heads, m2.n_groups,
             m2.d_state, m2.head_dim)
    # chunks over 128 rows (the wide route's 128 x 128 tiles) at both
    # cells' widths: 256 and a ragged 200, over a sequence of s
    wide = []
    for q_ in (256, 200):
        for nm, mc in ((cfg.name, m), ("mamba2-780m", m2)):
            wide.append(ssd_case(
                f"{nm} cells Q={q_} (wide route)", b, -(-s // q_), q_,
                mc.n_heads, mc.n_groups, mc.d_state, mc.head_dim, timed=True))
    return attn_main, ssd_main, dict(mla=mla_entry, ssd_wide=wide)


# -- phase 18: LM training at full width and depth ---------------------------

def _tree_equal(a, b) -> bool:
    from repro_torch.checkpoint.checkpoint import tree_flatten
    return all(torch_equal(x, y) for x, y in zip(tree_flatten(a)[0],
                                                 tree_flatten(b)[0]))


def torch_equal(x, y) -> bool:
    import torch
    if x.device != y.device:            # a state held on the host
        y = y.to(x.device)
    return x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)


def _to_host(tree):
    """A train state (or a tree of tensors) moved to the host."""
    if isinstance(tree, tuple):
        return type(tree)(*(_to_host(f) for f in tree))
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.cpu()


def train_phase(dev, gen, wrappers, cfg, batch, seq, steps, want,
                first_on_host=False):
    """Phase 18 (and 22): ``cfg``'s training, ``steps`` steps of
    ``batch`` x ``seq`` tokens from ``TokenPipeline(seed=0)``. ``want``:
    each kernel's launches a step (counters not named there must not
    move). ``first_on_host``: the first step's result waits on the host
    while the step repeats, for a state of which three do not fit on the
    card. Returns the report, with the main path's launches."""
    import torch

    from repro_torch.data import TokenPipeline
    from repro_torch.train import init_train_state, make_train_step

    label = f"train {cfg.name}"
    t0 = time.perf_counter()
    state0 = init_train_state(cfg, gen, device=dev)
    sync()
    n_params = sum(t.numel() for t in _leaves(state0.params))
    log(f"{label}: {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, remat {cfg.remat!r}), {n_params} params in "
        f"{cfg.dtype} with fp32 moments, made in "
        f"{time.perf_counter() - t0:.2f} s")
    pipe = TokenPipeline(cfg, batch=batch, seq=seq, seed=0)
    step = make_train_step(cfg)
    first = pipe.global_batch(0)

    # (b) the first step twice from one state: the same bits
    s1, m1 = step(state0, first)
    if first_on_host:
        s1 = _to_host(s1)
    s1b, m1b = step(state0, first)
    sync()
    same = _tree_equal(s1, s1b) and torch_equal(m1["loss"], m1b["loss"]) \
        and torch_equal(m1["grad_norm"], m1b["grad_norm"])
    del s1, s1b, m1b
    check(same, f"{label}: the same step from one state gave other bits")

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
    log(f"{label}: first step, kernels {float(m1['loss']):.6f} loss "
        f"{float(m1['grad_norm']):.6f} grad_norm; plain route "
        f"{float(mp['loss']):.6f}, {float(mp['grad_norm']):.6f}; SDPA route "
        f"{float(ms_['loss']):.6f}, {float(ms_['grad_norm']):.6f}; kernels "
        f"vs plain {errs}, bound {bound:.4g}")
    check(max(errs.values()) <= bound, f"{label}: the kernels' first step "
          f"is {errs} from the plain route's, beyond {bound:.3g}")

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
    check(int(state.step) == steps, f"{label}: the state's step counter")
    check(all(math.isfinite(x) for x in losses + norms),
          f"{label}: non-finite loss or grad_norm {losses} {norms}")
    per_step = {nm: c / steps for nm, c in launches.items()}
    for nm, cnt in per_step.items():
        check(cnt == want.get(nm, 0), f"{label}: {nm} launched {cnt} times "
              f"a step, not {want.get(nm, 0)}")
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
    log(f"{label}: {steps} steps in {path_s:.3f} s, step ms {step_ms} (median "
        f"of the last {steps - 1}: {med:.2f} ms, {rep['tokens_per_s']:.5g} "
        f"tokens/s); losses {losses}; peak memory {peak_gib:.3f} GiB; "
        f"launches a step {per_step}")
    # where a step's time goes: one more step, traced, after the path
    nxt = pipe.global_batch(steps)
    rep["trace"] = tr = traced(lambda: step(state, nxt),
                               f"traced train step ({cfg.name})")
    bwd = {BWD_KERNEL.match(k_).group(1): v_ for k_, v_, _ in tr["port"]
           if BWD_KERNEL.match(k_)}
    tr["backward_ms"] = sum(bwd.values())
    log(f"{label}: traced step busy {tr['busy_ms']:.1f} ms, of which the "
        f"backward kernels {tr['backward_ms']:.2f} ms: "
        + ", ".join(f"{k_} {v_:.2f}" for k_, v_ in bwd.items()))
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
                         r"fa_bwd_dkdv_tc|fa_bwd_dq_tc|fa_bwd_sum|"
                         r"ssd_bwd_cell|ssd_bwd_reduce)(_kernel)?[<(]")
# the backward kernels among them (training)
BWD_KERNEL = re.compile(r".*?::((?:fa|ssd)_bwd_\w+)")


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


# -- phase 2e: the bound upkeep of a move --------------------------------------

def bounds_upkeep_inputs(dev, gen, n, d, k, g, all_maybe=False):
    """``bounds_upkeep``'s inputs after a move, on the card, in its
    argument order: points near their old centroid, centroids moved by
    about 0.05 a coordinate, bounds that straddle each other (about half
    the rows *maybe*; with ``all_maybe`` every row but the sentinels),
    and every 97th row a sharded fit's sentinel (ub 0, lb +inf)."""
    import torch
    c = torch.randn((k, d), generator=gen, device=dev) * 3
    new_c = c + torch.randn((k, d), generator=gen, device=dev) * 0.05
    labels = torch.randint(0, k, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    x = c[labels.long()] + torch.randn((n, d), generator=gen,
                                       device=dev) * 0.5
    ub = torch.rand((n,), generator=gen, device=dev) * 4
    if all_maybe:
        ub.fill_(float("inf"))
    lb = torch.rand((n, 1), generator=gen, device=dev) * 4 \
        + torch.rand((n, g), generator=gen, device=dev)
    ub[::97] = 0.0
    lb[::97] = float("inf")
    drift = torch.sqrt(torch.sum((new_c - c) ** 2, dim=-1))
    groups = torch.arange(k, device=dev) % g
    gdrift = torch.full((g,), float("-inf"), device=dev).scatter_reduce_(
        0, groups, drift, "amax")
    return (x, torch.sum(x * x, dim=-1), new_c,
            torch.sum(new_c * new_c, dim=-1), labels, ub, lb.contiguous(),
            drift, gdrift)


def bounds_upkeep_phase(dev, bw):
    """``bounds_upkeep`` at uci-xlarge's and uci-highk's shapes against
    its plain version: bit for bit in ``lb_dec`` and ``tightened``, and in
    ``ub_t`` and ``need`` on every row the refresh did not touch (every
    row with the refresh off); a refreshed ``ub_t`` squared within 1e-5
    of ``||x||^2 + ||c_a||^2``, ``need`` equal where the plain ``ub_t``
    stands farther from ``glb`` than the root of that. Each case timed
    by CUDA events in turns with the plain version (plain, kernel,
    kernel, plain), its device time by kernel under the profiler, and
    the least time the card could take: N (13 + 8 G) bytes, and each
    refreshed row's X row and x2 on top. Then ``own_dists`` on each
    shape's compact buffer (:func:`own_dists_case`). Returns the cases,
    each named by its ``kernel``; the first is ``bounds_upkeep`` at
    uci-xlarge with about half the rows refreshed."""
    import torch
    import repro_torch.kernels as kernels
    bu_mod = kernel_module("bounds_upkeep")
    wrapper = kernels.bounds_upkeep
    gen = torch.Generator(device=dev).manual_seed(11)
    cases = []
    for label, prob in (("uci-xlarge", XLARGE), ("uci-highk", HIGHK)):
        n, d, k = prob["n"], prob["d"], prob["k"]
        g = max(k // 10, 1)
        for all_maybe in (False, True):
            args = bounds_upkeep_inputs(dev, gen, n, d, k, g, all_maybe)
            ub_p, _, maybe, _ = bu_mod.bounds_upkeep_plain(*args,
                                                           refresh=False)
            rows_maybe = int(maybe.sum())
            for refresh in ((True,) if all_maybe else (True, False)):
                case = (f"{label} N={n} D={d} K={k} G={g}, "
                        f"{'all' if all_maybe else 'half'} maybe, refresh "
                        f"{'on' if refresh else 'off'}")
                before = wrapper.launches
                got = wrapper(*args, refresh=refresh)
                sync()
                check(wrapper.launches == before + 1,
                      f"bounds_upkeep {case}: not one launch")
                want = bu_mod.bounds_upkeep_plain(*args, refresh=refresh)
                check(torch.equal(got[1], want[1])
                      and torch.equal(got[3], want[3]),
                      f"bounds_upkeep {case}: lb_dec or tightened differ")
                kept = ~maybe if refresh else torch.ones_like(maybe)
                check(torch.equal(got[0][kept], want[0][kept])
                      and torch.equal(got[2][kept], want[2][kept]),
                      f"bounds_upkeep {case}: ub_t or need differ on rows "
                      f"the refresh did not touch")
                x2, c2, a = args[1], args[3], args[4].long()
                tol = 1e-5 * (x2 + c2[a])
                err2 = (got[0] ** 2 - want[0] ** 2).abs()
                check(bool(((err2 <= tol) | kept).all()),
                      f"bounds_upkeep {case}: a refreshed ub_t beyond "
                      f"the expanded form's tolerance")
                glb = want[1].min(dim=1).values
                clear = (want[0] - glb).abs() > tol.sqrt()
                check(bool((got[2] == want[2])[clear].all()),
                      f"bounds_upkeep {case}: need differs off a tie")
                again = wrapper(*args, refresh=refresh)
                check(all(torch.equal(p, q) for p, q in zip(got, again)),
                      f"bounds_upkeep {case}: a second call's bits differ")
                nbytes = n * (13 + 8 * g) \
                    + (rows_maybe * (4 * d + 4) if refresh else 0)
                bound_ms = nbytes / bw * 1e3

                def kernel():
                    return wrapper(*args, refresh=refresh)

                def plain():
                    return bu_mod.bounds_upkeep_plain(*args,
                                                      refresh=refresh)
                turns = {"plain": [median_ms(plain)],
                         "kernel": [median_ms(kernel), median_ms(kernel)]}
                turns["plain"].append(median_ms(plain))
                rows, smem = bu_mod.plan(g)
                entry = dict(
                    kernel="bounds_upkeep", case=case, n=n, d=d, k=k, g=g,
                    refresh=refresh,
                    maybe_rows=rows_maybe,
                    need_diffs=int((got[2] != want[2]).sum()),
                    max_abs_err=float((got[0] - want[0]).abs().max()),
                    ms=statistics.mean(turns["kernel"]),
                    plain_ms=statistics.mean(turns["plain"]),
                    turns_ms=turns, bytes=nbytes, bound_ms=bound_ms,
                    bound_by="bytes", library_ms=None,
                    device_ms=device_ms_by_kernel(kernel),
                    rows_a_block=rows, smem=smem,
                    launches=wrapper.launches - before)
                log(f"bounds_upkeep {json.dumps(entry)}")
                cases.append(entry)
                if refresh and not all_maybe:
                    cases.append(own_dists_case(label, args, got[0], maybe,
                                                bw))
            del args, ub_p, maybe
            torch.cuda.empty_cache()
    return cases


def own_dists_case(label, args, ub_t, maybe, bw):
    """``own_dists`` on the compact buffer the pass would gather for the
    ``maybe`` rows of ``bounds_upkeep``'s inputs ``args``: the rows'
    indices padded to a power of two (at most N) with row 0, as the
    pass pads its buffer, and their X rows, x2 and labels gathered. On
    the buffer's rows the bits of the move's refresh ``ub_t``; every
    slot squared within 1e-5 of ``||x||^2 + ||c_a||^2`` of
    :func:`own_dists_plain`; the same bits again on a second call.
    Timed in turns with the plain version beside the buffer's bytes
    (an X row, x2 and a label read and a distance written a slot; the
    centroids stay in L2)."""
    import torch
    import repro_torch.kernels as kernels
    bu_mod = kernel_module("bounds_upkeep")
    own = bu_mod.own_dists
    x, x2, c, c2, labels = args[:5]
    n, d = x.shape
    k = c.shape[0]
    idx = torch.nonzero(maybe).flatten()
    rows = idx.numel()
    cap = min(1 << (rows - 1).bit_length(), n)
    idx = torch.cat([idx, idx.new_zeros(cap - rows)])
    cpts, c_x2, c_as = x[idx], x2[idx], labels[idx]
    case = f"{label} compact buffer {cap} rows ({rows} live) D={d} K={k}"
    before = own.launches
    got = kernels.own_dists(cpts, c_x2, c, c2, c_as)
    sync()
    check(own.launches == before + 1, f"own_dists {case}: not one launch")
    check(torch.equal(got[:rows], ub_t[idx[:rows]]),
          f"own_dists {case}: not the bits of bounds_upkeep's refresh")
    want = bu_mod.own_dists_plain(cpts, c_x2, c, c2, c_as)
    tol = 1e-5 * (c_x2 + c2[c_as.long()])
    check(bool(((got ** 2 - want ** 2).abs() <= tol).all()),
          f"own_dists {case}: beyond the expanded form's tolerance")
    check(torch.equal(kernels.own_dists(cpts, c_x2, c, c2, c_as), got),
          f"own_dists {case}: a second call's bits differ")
    nbytes = cap * (4 * d + 12)

    def kernel():
        return kernels.own_dists(cpts, c_x2, c, c2, c_as)

    def plain():
        return bu_mod.own_dists_plain(cpts, c_x2, c, c2, c_as)
    turns = {"plain": [median_ms(plain)],
             "kernel": [median_ms(kernel), median_ms(kernel)]}
    turns["plain"].append(median_ms(plain))
    entry = dict(
        kernel="own_dists", case=case, n=cap, d=d, k=k, live_rows=rows,
        max_abs_err=float((got - want).abs().max()),
        ms=statistics.mean(turns["kernel"]),
        plain_ms=statistics.mean(turns["plain"]), turns_ms=turns,
        bytes=nbytes, bound_ms=nbytes / bw * 1e3, bound_by="bytes",
        library_ms=None, device_ms=device_ms_by_kernel(kernel),
        launches=own.launches - before)
    log(f"own_dists {json.dumps(entry)}")
    return entry


# -- phase 2f: the candidate pass's group filter and tail -------------------

def candidate_tail_phase(dev, bw):
    """``candidate_mask`` and ``candidate_tail`` on the pending passes of
    a kernel-backend fit at uci-xlarge's and uci-highk's shapes (G = K /
    10; points from ``make_points`` seed 5, every (N/K)-th point a first
    centroid), after 2 iterations (most blocks live) and after 10: each
    bit for bit against its plain version on the pass's inputs
    (``grouped_assign``'s outputs for the tail) and one launch a call;
    each timed by CUDA events in turns with its plain version (plain,
    kernel, kernel, plain), its device time by kernel under the
    profiler, beside the least time the card could take by bytes. The
    mask reads need, ub_t and lb and writes the mask: N (5 + 4 G) + G
    ceil(N / 256) bytes. The tail reads best2, idx, the labels, ub_t and
    need and writes the new labels and ub (25 bytes a point), reads lb
    and writes the new lb (8 G), reads garg and gmin where a group is
    computed (8) and gmin2 where that group holds the new label (4), and
    the groups (4 K). Returns the cases; the first two are the mask and
    the tail at uci-xlarge after 2 iterations."""
    import torch
    import repro_torch.kernels as kernels
    from repro_torch.core import engine
    from repro_torch.core.kmeans import group_centroids
    from repro_torch.data import make_points
    ct_mod = kernel_module("candidate_tail")
    mask_k, tail_k = kernels.candidate_mask, kernels.candidate_tail
    cases = []
    for label, prob in (("uci-xlarge", XLARGE), ("uci-highk", HIGHK)):
        n, d, k = prob["n"], prob["d"], prob["k"]
        g = max(k // 10, 1)
        pts = torch.from_numpy(make_points(n, d, k, seed=5)[0]).to(dev)
        init = pts[:: n // k][:k].clone()
        groups = group_centroids(init, g)
        members, gsize = engine.build_group_tables(groups.cpu().numpy(), g,
                                                   dev)
        mem_s = members.clamp_min(0).long()
        core = engine.PassCore(backend="kernel", k=k, n_groups=g)
        body = engine._loop_body(core, pts, None, groups, members, gsize)
        c = engine._init_carry(pts, init, groups, n_groups=g)
        for it in range(1, 11):
            c = body(c)
            if it not in (2, 10):
                continue
            need, lb, ub = c.need, c.lb, c.ub
            case = f"{label} N={n} D={d} K={k} G={g}, pass after " \
                   f"iteration {it}"
            before = (mask_k.launches, tail_k.launches)
            mask = mask_k(need, lb, ub)
            sync()
            check(mask_k.launches == before[0] + 1,
                  f"candidate_mask {case}: not one launch")
            check(torch.equal(mask, ct_mod.candidate_mask_plain(need, lb,
                                                                ub)),
                  f"candidate_mask {case}: not the plain version's bits")
            ga = kernels.grouped_assign(
                pts, c.centroids[mem_s].contiguous(), members, mask,
                tile_n=256, x2=c.x2, c2g=c.c2[mem_s].contiguous())
            args = tuple(ga) + (c.assignments, ub, lb, need, groups)
            got = tail_k(*args)
            sync()
            check(tail_k.launches == before[1] + 1,
                  f"candidate_tail {case}: not one launch")
            check(all(torch.equal(a, b) for a, b in zip(
                got, ct_mod.candidate_tail_plain(*args))),
                f"candidate_tail {case}: not the plain version's bits")
            group_need = need[:, None] & (lb < ub[:, None])
            computed = int(group_need.sum())
            collisions = int((group_need & (ga[3] == got[0][:, None])).sum())
            del group_need
            common = dict(case=case, n=n, d=d, k=k, g=g, iteration=it,
                          pending=int(need.sum()),
                          live_blocks=float(mask.float().mean()),
                          computed_groups=computed, collisions=collisions,
                          max_abs_err=0.0, bound_by="bytes",
                          library_ms=None)
            for name, kernel, plain, nbytes in (
                    ("candidate_mask", lambda: mask_k(need, lb, ub),
                     lambda: ct_mod.candidate_mask_plain(need, lb, ub),
                     n * (5 + 4 * g) + mask.numel()),
                    ("candidate_tail", lambda: tail_k(*args),
                     lambda: ct_mod.candidate_tail_plain(*args),
                     n * (25 + 8 * g) + 8 * computed + 4 * collisions
                     + 4 * k)):
                before = getattr(kernels, name).launches
                turns = {"plain": [median_ms(plain)],
                         "kernel": [median_ms(kernel), median_ms(kernel)]}
                turns["plain"].append(median_ms(plain))
                entry = dict(
                    common, kernel=name,
                    ms=statistics.mean(turns["kernel"]),
                    plain_ms=statistics.mean(turns["plain"]),
                    turns_ms=turns, bytes=nbytes,
                    bound_ms=nbytes / bw * 1e3,
                    host_ms=host_ms(kernel),
                    device_ms=device_ms_by_kernel(kernel),
                    launches=getattr(kernels, name).launches - before)
                log(f"{name} {json.dumps(entry)}")
                cases.append(entry)
            del ga, args, got, mask
        del pts, c, body
        torch.cuda.empty_cache()
    return cases


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
                "centroid_update": kernels.centroid_update,
                "bounds_upkeep": kernels.bounds_upkeep,
                "own_dists": kernels.own_dists}

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
            fit("auto", pts, init, count=True, backend="compact",
                tune="auto", return_stats=True, **kw)
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
    # the tuned fit's kernels, counted on every rank from just before it
    # to just after it: a bound upkeep a move, and the refresh in the
    # pass (own_dists) exactly where the config puts it there
    in_pass = bool(auto["config"].get("refresh_in_pass"))
    auto_launches = {nm: sum(r["auto"]["launches"][nm] for r in ranks)
                     for nm in ("bounds_upkeep", "own_dists")}
    log(f"phase 16 (a) tune='auto' launches over {world} ranks: "
        f"{auto_launches}, refresh_in_pass {in_pass}, n_iters "
        f"{auto['n_iters']}")
    check(auto_launches["bounds_upkeep"] == world * auto["n_iters"],
          f"phase 16: bounds_upkeep launched "
          f"{auto_launches['bounds_upkeep']} times in the tuned fit over "
          f"{world} ranks, not a launch a rank a move")
    check((auto_launches["own_dists"] > 0) == in_pass,
          f"phase 16: own_dists launched {auto_launches['own_dists']} "
          f"times in the tuned fit with refresh_in_pass {in_pass}")
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
        launches=launches, auto_launches=auto_launches)

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


# -- phase 25: the sharded train state ---------------------------------------

LM_WRAPPERS = ("flash_attention", "ssd_intra", "flash_attention_bwd",
               "ssd_intra_bwd")


def lm_wrappers() -> dict:
    """The LM kernels' wrappers by the ``kernels`` line's names."""
    import repro_torch.kernels as kernels
    return {"flash_attention": kernels.flash_attention,
            "ssd_intra": kernels.ssd_intra,
            "flash_attention_bwd":
                kernel_module("flash_attention").flash_attention_gqa_bwd,
            "ssd_intra_bwd": kernel_module("ssd_intra").ssd_intra_chunks_bwd}


def _shards_equal(a, b) -> bool:
    """Whether two states placed alike hold the same bits: each rank
    compares its own shards (the shards cover every leaf), no
    collective."""
    import torch
    from repro_torch.checkpoint.checkpoint import tree_flatten
    from repro_torch.dtensor import local_tensor
    same = True
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        check(getattr(x, "placements", None) == getattr(y, "placements",
                                                        None),
              "phase 25: two states compared shard by shard are placed "
              "differently")
        x, y = local_tensor(x), local_tensor(y)
        same &= x.dtype == y.dtype and x.shape == y.shape \
            and bool(torch.equal(x, y))
    return same


def _shards_are_file(state, arrays) -> bool:
    """Whether each of this rank's shards of ``state`` holds the bytes of
    its slice of the checkpoint's host leaves ``arrays``."""
    from repro_torch.checkpoint.checkpoint import tree_flatten
    from repro_torch.dtensor import local_slices
    same = True
    for x, a in zip(tree_flatten(state)[0], arrays):
        sl = local_slices(x.shape, x.device_mesh.shape,
                          x.device_mesh.get_coordinate(), x.placements)
        same &= _same_bytes(x.to_local(), a[sl])
    return same


def _same_bytes(t, arr) -> bool:
    """Whether tensor ``t`` holds the bytes of numpy array ``arr``."""
    import torch
    t = t.detach().cpu().contiguous().reshape(-1)
    a = np.ascontiguousarray(arr).reshape(-1)
    return t.numel() * t.element_size() == a.nbytes and bool(np.array_equal(
        t.view(torch.uint8).numpy(), a.view(np.uint8)))


def _collective_rates(dev, mesh, nbytes, reps=3) -> dict:
    """The bytes a second that reach a rank of a ``gloo`` world, through
    the host from the card, when every rank of a group hands every
    other one ``nbytes``: ``all_gather`` (``core.distributed._gather``,
    the route of ``dtensor.gather_full``) against point-to-point
    (``dtensor.exchange``, the route of ``dtensor.reduce_to_shard``), in
    turns, over the world and over mesh dimension 1's pairs. Medians of
    ``reps`` turns."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import _gather
    from repro_torch.dtensor import exchange
    x = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=dev)

    def settle():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    out = {}
    for label, group in (("world", dist.group.WORLD),
                         ("pair", mesh.get_group(1))):
        ranks = dist.get_process_group_ranks(group)
        peers = [r for r in ranks if r != dist.get_rank()]
        times = {"all_gather": [], "p2p": []}
        for _ in range(reps):
            for route in times:
                dist.barrier()
                settle()
                t = time.perf_counter()
                if route == "all_gather":
                    _gather(x, group, len(ranks))
                else:
                    exchange({r: x for r in peers},
                             {r: ((nbytes,), torch.uint8) for r in peers},
                             dev)
                settle()
                times[route].append(time.perf_counter() - t)
        out[label] = {route: len(peers) * nbytes / statistics.median(ts)
                      for route, ts in times.items()}
    return out


def rowwise_train_step(cfg, parts: int):
    """The sharded step's arithmetic on one device, without placements:
    the batch's rows cut into ``parts`` blocks as the data axis cuts
    them, each block's gradient from a pass of its own
    (``loss_and_grads``), their fp32 mean added in block order, then
    AdamW on the whole leaves. Phase 25 holds the sharded state to it
    tightly; ``make_train_step`` (one pass over every row, bf16
    gradients) differs from it by bf16's rounding."""
    import torch
    from repro_torch.checkpoint.checkpoint import tree_flatten, tree_unflatten
    from repro_torch.data import to_device
    from repro_torch.optim.adamw import AdamWConfig, adamw_update
    from repro_torch.train import TrainState, loss_and_grads

    def step(state, batch):
        n = len(batch["tokens"]) // parts
        acc, loss = None, None
        for j in range(parts):
            rows = to_device({k: v[j * n:(j + 1) * n]
                              for k, v in batch.items()}, state.step.device)
            part_loss, grads = loss_and_grads(state.params, rows, cfg)
            leaves, treedef, _ = tree_flatten(grads)
            del grads, rows
            part = [g.float() for g in leaves]
            del leaves
            acc = part if acc is None else [a + g for a, g in zip(acc, part)]
            loss = part_loss.float() if loss is None \
                else loss + part_loss.float()
            del part
        grads = tree_unflatten(treedef, [a / parts for a in acc])
        del acc
        with torch.no_grad():
            p, m, v, metrics = adamw_update(grads, state.m, state.v,
                                            state.params, state.step,
                                            AdamWConfig())
        metrics["loss"] = loss / parts
        return TrainState(state.step + 1, p, m, v), metrics

    return step


def _slices_of(state, shardings) -> dict:
    """This rank's slices of a full state's params, m and v under
    ``shardings``, on the host: {tree: [leaf slices]}."""
    from repro_torch.checkpoint.checkpoint import tree_flatten
    from repro_torch.dtensor import local_slices
    out = {}
    for k in ("params", "m", "v"):
        out[k] = []
        for x, sh in zip(tree_flatten(getattr(state, k))[0],
                         tree_flatten(getattr(shardings, k))[0]):
            sl = local_slices(x.shape, sh.mesh.shape,
                              sh.mesh.get_coordinate(), sh.placements)
            out[k].append(x[sl].cpu().clone())
    return out


def _gap_sums(state, ref, init) -> dict:
    """Per leaf of params, m and v: ``[sum (got - want)^2, sum ref^2,
    elements that differ]`` over this rank's shards (a plain state's
    whole leaves), in float64, where ``want`` is the leaf ``ref``
    (the rank's slice of the unsharded state) and
    ``ref`` is ``want`` for a moment and ``want - init`` (the update)
    for a parameter. The parent adds them over the ranks (a replicated
    shard counts once a rank on both sides of the ratio)."""
    import torch
    from repro_torch.checkpoint.checkpoint import tree_flatten
    from repro_torch.dtensor import local_tensor
    out = {}
    for k in ("params", "m", "v"):
        rows = []
        for i, x in enumerate(tree_flatten(getattr(state, k))[0]):
            got = local_tensor(x).double()
            want = ref[k][i].to(got.device).double()
            base = want - init[i].to(got.device).double() \
                if k == "params" else want
            rows.append([float(torch.sum(torch.square(got - want))),
                         float(torch.sum(torch.square(base))),
                         int(torch.count_nonzero(got != want))])
        out[k] = rows
    return out


def sharded_train_rank(rank, world, job):
    """One rank of phase 25's world (``spawn_world`` runs it, every rank
    on the card). (a) :func:`rowwise_train_step` from the same seed on
    this rank, the ranks one after another, kept as this rank's slices
    of the state after step 1 and the last; then the sharded step on
    mesh ``job["mesh"]``: each shard's shape against DTensor's own rule,
    ``job["steps"]`` steps from the initial state, the main path, with
    the LM kernels' counts reset just before and read just after and
    each step's transfers timed; the state after step 1 and the last
    against the unsharded slices (:func:`_gap_sums`); the first step
    again from the initial state (the same bits); the collectives'
    rates (:func:`_collective_rates`). (b) the state after
    ``job["save_at"]`` steps saved and resumed onto mesh
    ``job["elastic"]`` (``ElasticController``), bit for bit; (c)
    ``ResilientLoop(state_shardings=...)`` on the replay cut through a
    failure, bit for bit its uninterrupted run. Returns this rank's
    report."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    import repro_torch.core.distributed as core_dist
    import repro_torch.dtensor as dtensor
    from repro_torch.checkpoint import load_checkpoint_arrays, save_checkpoint
    from repro_torch.checkpoint.checkpoint import tree_flatten
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.sharding import (batch_pspecs, named,
                                             train_state_pspecs)
    from repro_torch.runtime import (ElasticController, FailureInjector,
                                     ResilientLoop)
    from repro_torch.train import init_train_state, make_sharded_train_step

    dev = torch.device("cpu" if job["rehearsal"] else "cuda")
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    wrappers = lm_wrappers()
    cfg = get_config(job["arch"])
    cfg = dataclasses.replace(cfg.reduced() if job["rehearsal"] else cfg,
                              n_layers=job["layers"])

    def rank_sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def mesh_of(shape):
        return init_device_mesh(dev.type, tuple(shape),
                                mesh_dim_names=("data", "model"))

    def shapes_ok(leaves):
        """Each shard the shape DTensor's own rule gives."""
        return all(tuple(x.to_local().shape) == tuple(
            compute_local_shape_and_global_offset(x.shape, x.device_mesh,
                                                  x.placements)[0])
            for x in leaves)

    def seeded():
        return torch.Generator(device=dev).manual_seed(job["seed"])

    def setup(c, mesh):
        st_sh = named(mesh, train_state_pspecs(c))
        step = make_sharded_train_step(c, st_sh,
                                       named(mesh, batch_pspecs(c, mesh)))
        state = init_train_state(c, seeded(), device=dev, shardings=st_sh)
        return st_sh, step, state

    out = {"device": str(dev)}
    mesh = mesh_of(job["mesh"])
    pipe = TokenPipeline(cfg, batch=job["batch"], seq=job["seq"], seed=0)
    st_sh = named(mesh, train_state_pspecs(cfg))
    last = job["steps"]

    # the yardstick for the state: the sharded step's arithmetic on one
    # device (rowwise_train_step), one rank at a time (a state, the
    # step's new one and fp32 gradients are about 25 GB at 16 layers)
    tok = named(mesh, batch_pspecs(cfg, mesh))["tokens"]
    parts = math.prod(mesh.shape[i] for i, p in enumerate(tok.placements)
                      if isinstance(p, Shard))
    ref, ref_losses = {}, []
    for r in range(world):
        if r == rank:
            st = init_train_state(cfg, seeded(), device=dev)
            unsharded = rowwise_train_step(cfg, parts)
            for i in range(last):
                st, met = unsharded(st, pipe.global_batch(i))
                ref_losses.append(float(met["loss"]))
                if i + 1 in (1, last):
                    ref[i + 1] = _slices_of(st, st_sh)
            del st, met
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    if dev.type == "cuda":
        out["after_yardstick_gib"] = torch.cuda.memory_reserved(dev) / 2**30

    st_sh, step, state0 = setup(cfg, mesh)
    leaves = tree_flatten(state0)[0]
    out["shapes_ok"] = shapes_ok(leaves)
    out["shard_bytes"] = sum(x.to_local().numel() * x.to_local().element_size()
                             for x in leaves)
    del leaves

    # the main path: each step's collectives timed between two syncs of
    # the card (a gloo transfer copies through the host anyway)
    spent = []

    def timed(fn):
        def run(*args):
            rank_sync()
            t = time.perf_counter()
            got = fn(*args)
            rank_sync()
            spent.append(time.perf_counter() - t)
            return got
        return run

    routes = (dtensor, "exchange"), (core_dist, "_gather")
    kept = [getattr(mod, name) for mod, name in routes]
    reset_launches(wrappers)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state, s1, m1 = state0, None, None
    losses, norms, step_ms, coll_ms = [], [], [], []
    for (mod, name), fn in zip(routes, kept):
        setattr(mod, name, timed(fn))
    try:
        for i in range(last):
            batch_i = pipe.global_batch(i)
            spent.clear()
            rank_sync()
            t0 = time.perf_counter()
            state, met = step(state, batch_i)
            rank_sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            coll_ms.append(sum(spent) * 1e3)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
            if i == 0:
                s1, m1 = state, met
    finally:
        for (mod, name), fn in zip(routes, kept):
            setattr(mod, name, fn)
    out["launches"] = read_launches(wrappers)
    out.update(losses=losses, grad_norms=norms, step_ms=step_ms,
               collective_ms=coll_ms, ref_losses=ref_losses,
               peak_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                         if dev.type == "cuda" else 0.0),
               first=dict(loss=float(m1["loss"]),
                          grad_norm=float(m1["grad_norm"])))
    init = [x.to_local() for x in tree_flatten(state0.params)[0]]
    out["gaps"] = {n: _gap_sums(s, ref[n], init)
                   for n, s in ((1, s1), (last, state))}
    del state, ref, init
    # the first step again from the same state: the same bits
    s1b, m1b = step(state0, pipe.global_batch(0))
    out["repeat"] = _shards_equal(s1, s1b) and all(
        bool(torch.equal(m1[k], m1b[k])) for k in ("loss", "grad_norm"))
    del s1, s1b, m1b, state0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["rates"] = _collective_rates(dev, mesh, job["rate_bytes"])

    # (b) and (c) on the replay cut (its checkpoints a quarter of the
    # 16 layers'): (b) its state after save_at steps saved, resumed on
    # another mesh, both states held to the file's bits shard by shard
    rp = job["replay"]
    cut = dataclasses.replace(cfg, n_layers=rp["layers"])
    c_sh, c_step, c_state = setup(cut, mesh)
    c_pipe = TokenPipeline(cut, batch=job["batch"], seq=rp["seq"], seed=0)
    kept = c_state
    for i in range(job["save_at"]):
        kept = c_step(kept, c_pipe.global_batch(i))[0]
    ck = os.path.join(job["scratch"], "elastic")
    rank_sync()
    t0 = time.perf_counter()
    save_checkpoint(ck, job["save_at"], kept)
    out["save_s"] = time.perf_counter() - t0
    ctl = ElasticController(ck)
    t0 = time.perf_counter()
    on_b, at = ctl.resume_on(kept, named(mesh_of(job["elastic"]),
                                         train_state_pspecs(cut)),
                             device=dev)
    rank_sync()
    out["resume_s"] = time.perf_counter() - t0
    arrays = load_checkpoint_arrays(ck)[2]
    out["elastic"] = dict(
        step=at, bits=_shards_are_file(on_b, arrays)
        and _shards_are_file(kept, arrays),
        mesh=list(on_b.params["embed"].device_mesh.shape),
        has=ctl.has_checkpoint(),
        shapes_ok=shapes_ok(tree_flatten(on_b)[0]))
    del on_b, kept, arrays

    # (c) a failure, restored onto the placements
    def run(tag, fail):
        loop = ResilientLoop(c_step, c_pipe,
                             os.path.join(job["scratch"], tag),
                             ckpt_every=rp["ckpt_every"],
                             injector=FailureInjector(fail))
        t = time.perf_counter()
        final = loop.run(c_state, rp["steps"], state_shardings=c_sh)
        rank_sync()
        return loop, final, time.perf_counter() - t

    _, clean, clean_s = run("clean", ())
    loop, faulted, fault_s = run("fault", (rp["fail_at"],))
    out["replay"] = dict(bits=_shards_equal(clean, faulted),
                         restarts=loop.restarts, clean_s=clean_s,
                         faulted_s=fault_s,
                         losses=[m["loss"] for m in loop.metrics_log])
    return out


def nccl_rank(rank, world, job):
    """Phase 25 (d), the one rank of a world over NCCL: phase 18's
    unsharded first step and the sharded step on the trivial mesh from
    the same state (``make_host_mesh``, 1 x 1), compared bit for bit."""
    import torch
    from repro_torch.checkpoint.checkpoint import tree_flatten
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.dtensor import local_tensor
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (batch_pspecs, named,
                                             train_state_pspecs)
    from repro_torch.train import (init_train_state, make_sharded_train_step,
                                   make_train_step)
    dev = torch.device("cpu" if job["rehearsal"] else "cuda")
    cfg = get_config(job["arch"])
    cfg = cfg.reduced() if job["rehearsal"] else cfg
    state = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(job["seed"]), device=dev)
    batch = TokenPipeline(cfg, batch=job["batch"], seq=job["seq"],
                          seed=0).global_batch(0)
    want, wm = make_train_step(cfg)(state, batch)
    mesh = make_host_mesh(device=dev)
    step = make_sharded_train_step(cfg, named(mesh, train_state_pspecs(cfg)),
                                   named(mesh, batch_pspecs(cfg, mesh)))
    t0 = time.perf_counter()
    got, gm = step(state, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    same = {k: bool(torch.equal(gm[k], wm[k]))
            for k in ("loss", "grad_norm", "lr")}
    for name, a, b in (("params", got.params, want.params),
                       ("m", got.m, want.m), ("v", got.v, want.v)):
        same[name] = all(
            x.dtype == y.dtype and bool(torch.equal(local_tensor(x), y))
            for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]))
    return dict(bits=same, loss=float(gm["loss"]), want_loss=float(wm["loss"]),
                seconds=seconds, backend=torch.distributed.get_backend())


def _start(cmd, scratch_dir):
    """A port entry point as a user runs it: a process in the
    repository's environment, its output piped."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.Popen([sys.executable, "-m", *cmd, "--ckpt-dir",
                             scratch_dir], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(pr, name, t0, timeout=600):
    """Wait for a :func:`_start` process; logs its output, fails the run
    unless it exits 0. Returns (stdout, seconds since ``t0``)."""
    try:
        so, se = pr.communicate(timeout=timeout)
    finally:
        if pr.poll() is None:
            pr.kill()
            pr.wait()
    sec = time.perf_counter() - t0
    log(f"phase 25 {name} exited {pr.returncode} after {sec:.1f} s: "
        + " | ".join(x for x in so.splitlines() if x.strip()))
    check(pr.returncode == 0, f"phase 25: {name} exited {pr.returncode}: "
          f"{se[-1500:]}")
    return so, sec


def _gap_table(ranks, n) -> dict:
    """{tree: (largest relative gap over the leaves, its leaf's index,
    elements that differ, every leaf's gap)} after step ``n``: each
    leaf's :func:`_gap_sums` added over the ranks."""
    out = {}
    for k in ("params", "m", "v"):
        rows = [r["gaps"][n][k] for r in ranks]
        gaps, differ = [], 0
        for leaf in range(len(rows[0])):
            num = sum(x[leaf][0] for x in rows)
            den = sum(x[leaf][1] for x in rows)
            differ += sum(x[leaf][2] for x in rows)
            gaps.append(math.sqrt(num / den) if den else
                        (0.0 if num == 0 else math.inf))
        worst = max(gaps)
        out[k] = (worst, gaps.index(worst), differ, gaps)
    return out


def sharded_train_phase(dev, scratch, train_rep, mla_train_cfg,
                        mla_train_rep, *, rehearsal=False):
    """Phase 25: the sharded train state on ``torch.distributed``
    (``SHARDED_TRAIN``). (a)-(c) in a world of ``world`` gloo ranks
    sharing the card (:func:`sharded_train_rank`): against the parent's
    single-device steps from the same state, each step's loss and
    ``grad_norm``, and against the ranks' unsharded steps the full
    parameters and moments after step 1 and the last, within
    ``SHARDED_BOUNDS``; the first step repeated bit for bit, every shard
    the shape DTensor's rule gives; the collectives' rates; (b) on the
    replay cut, the elastic resume and the saved state shard for shard
    the file's bits, and the parent's unsharded restore of the same
    checkpoint the file's bits; (c) the replay bit for bit. (d) a world
    of 1 over NCCL at full depth: the sharded step on the trivial mesh
    is phase 18's first step, bit for bit. (e) the launcher and (f) the
    LM example as processes, side by side once the worlds are done.
    (g) the model FLOP share of phases 18 and 22. ``rehearsal=True``
    runs (a)-(d) on the CPU at the configs' ``reduced()`` widths, (d)
    over gloo, and skips (e) and (f), saying so. Returns the report,
    with the main path's launches summed over the ranks."""
    import torch
    from repro_torch.checkpoint import (load_checkpoint_arrays,
                                        restore_checkpoint)
    from repro_torch.checkpoint.checkpoint import tree_flatten
    from repro_torch.configs import get_config
    from repro_torch.core.distributed import spawn_world
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.specs import meta_train_state
    from repro_torch.roofline.analysis import model_flops
    from repro_torch.train import init_train_state, make_train_step

    st, bounds = SHARDED_TRAIN, SHARDED_BOUNDS
    full_cfg = get_config(st["arch"])
    full_cfg = full_cfg.reduced() if rehearsal else full_cfg
    cfg = dataclasses.replace(full_cfg, n_layers=st["layers"])
    rep = dict(arch=cfg.name, layers=cfg.n_layers, world=st["world"],
               mesh=list(st["mesh"]), batch=st["batch"], seq=st["seq"],
               steps=st["steps"], bounds=bounds)
    if rehearsal:
        log("phase 25 rehearsal: on the CPU at reduced widths, (d) over "
            "gloo; (e) and (f) skipped")
    # the yardsticks: the single-device steps from the same state, one
    # pass over every row (make_train_step) and a pass a data rank's
    # rows (rowwise_train_step), their states after step 1 and the last
    # held to each other
    pipe = TokenPipeline(cfg, batch=st["batch"], seq=st["seq"], seed=0)
    last = st["steps"]

    def chain(step_fn, keep):
        gen = torch.Generator(device=dev).manual_seed(st["seed"])
        state = init_train_state(cfg, gen, device=dev)
        init = [t.clone() for t in tree_flatten(state.params)[0]]
        losses, norms, kept = [], [], {}
        for i in range(last):
            state, m = step_fn(state, pipe.global_batch(i))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if i + 1 in (1, last):
                kept[i + 1] = keep(state, i + 1)
        return init, losses, norms, kept

    t0 = time.perf_counter()
    init, s_losses, s_norms, whole = chain(make_train_step(cfg),
                                           lambda x, n: x)
    single = dict(losses=s_losses, grad_norms=s_norms,
                  seconds=time.perf_counter() - t0)
    n_params = sum(t.numel() for t in init)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_flatten(whole[1])[0])
    want = {n: {k: tree_flatten(getattr(x, k))[0] for k in ("params", "m",
                                                             "v")}
            for n, x in whole.items()}

    def held(state, n):
        sums = _gap_sums(state, want[n], init)
        del want[n], whole[n]
        return sums
    r_init, r_losses, r_norms, r_sums = chain(
        rowwise_train_step(cfg, st["mesh"][0]), held)
    rowwise_gaps = {n: _gap_table([{"gaps": r_sums}], n) for n in r_sums}
    del init, r_init, want, whole
    parent_gib = 0.0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        parent_gib = torch.cuda.memory_reserved(dev) / 2**30
    log(f"phase 25: {cfg.name} at full width cut to {cfg.n_layers} of "
        f"{full_cfg.n_layers} layers ({n_params} parameters, a state of "
        f"{state_bytes / 1e9:.3f} GB); make_train_step: losses "
        f"{single['losses']}, grad_norms {single['grad_norms']}; "
        f"rowwise_train_step (a pass a data rank's rows): losses "
        f"{r_losses}, grad_norms {r_norms}, its state against "
        f"make_train_step's (largest relative gap, its leaf, elements that "
        f"differ) by tree after step: "
        f"{ {n: {k: v[:3] for k, v in g.items()} for n, g in rowwise_gaps.items()} }"
        f"; the parent keeps {parent_gib:.3f} GiB of the card")
    rep["rowwise"] = dict(losses=r_losses, grad_norms=r_norms,
                          gaps=rowwise_gaps)

    job = dict(arch=st["arch"], layers=st["layers"], batch=st["batch"],
               seq=st["seq"], steps=st["steps"], seed=st["seed"],
               mesh=st["mesh"], elastic=st["elastic"], save_at=st["save_at"],
               replay=st["replay"], rate_bytes=st["rate_bytes"],
               rehearsal=rehearsal,
               scratch=tempfile.mkdtemp(prefix="sharded_", dir=scratch))
    t0 = time.perf_counter()
    ranks = spawn_world(sharded_train_rank, st["world"], args=(job,),
                        backend="gloo", timeout=st["timeout"])
    world_s = time.perf_counter() - t0
    r0 = ranks[0]
    rel = {k: [abs(a - b) / abs(b) for a, b in zip(r0[k], single[k])]
           for k in ("losses", "grad_norms")}
    gaps = {n: _gap_table(ranks, n) for n in (1, st["steps"])}
    launches = {nm: sum(r["launches"][nm] for r in ranks)
                for nm in r0["launches"]}
    per_step = {nm: c / (st["steps"] * st["world"])
                for nm, c in launches.items()}
    nl = cfg.n_layers
    want = {"flash_attention": 2 * nl, "flash_attention.tc": 2 * nl,
            "ssd_intra": 2 * nl, "flash_attention_bwd": nl,
            "flash_attention_bwd.tc": nl, "ssd_intra_bwd": nl}
    med = statistics.median(r0["step_ms"][1:])
    coll = statistics.median(r0["collective_ms"][1:])
    tokens = st["batch"] * st["seq"]
    rates = {g: {k: v / 1e9 for k, v in r.items()}
             for g, r in r0["rates"].items()}
    rep["a"] = dict(single=single, rel_err=rel, gaps=gaps,
                    first=[r["first"] for r in ranks],
                    losses=r0["losses"], grad_norms=r0["grad_norms"],
                    ref_losses=[r["ref_losses"] for r in ranks],
                    step_ms=[r["step_ms"] for r in ranks],
                    collective_ms=[r["collective_ms"] for r in ranks],
                    step_ms_median=med, collective_ms_median=coll,
                    tokens_per_s=tokens / (med / 1e3),
                    peak_gib=[r["peak_gib"] for r in ranks],
                    shard_bytes=[r["shard_bytes"] for r in ranks],
                    rates_gb_s=[r["rates"] for r in ranks],
                    after_yardstick_gib=[r.get("after_yardstick_gib", 0.0)
                                         for r in ranks],
                    launches_per_rank_step=per_step, world_s=world_s)
    log(f"phase 25 (a) world of {st['world']} gloo ranks on mesh "
        f"{tuple(st['mesh'])} ('data', 'model'), {st['steps']} steps of "
        f"{st['batch']} x {st['seq']} tokens: losses {r0['losses']}, "
        f"grad_norms {r0['grad_norms']} (relative to the single device's "
        f"{rel}); the ranks' rowwise_train_step losses "
        f"{rep['a']['ref_losses']}; the full state against "
        f"rowwise_train_step's, (largest relative gap, its leaf, elements "
        f"that differ) by tree after step: "
        f"{ {n: {k: v[:3] for k, v in g.items()} for n, g in gaps.items()} }"
        f"; rank 0 "
        f"step ms {r0['step_ms']} (median of the last {st['steps'] - 1}: "
        f"{med:.1f} ms, {tokens / (med / 1e3):.5g} tokens/s), of which "
        f"transfers {r0['collective_ms']}; peak memory a rank "
        f"{[round(r['peak_gib'], 3) for r in ranks]} GiB (the yardstick "
        f"left {[round(x, 3) for x in rep['a']['after_yardstick_gib']]}), "
        f"shards a rank "
        f"{[r['shard_bytes'] for r in ranks]} bytes; launches a rank a step "
        f"{per_step}; the world ran {world_s:.1f} s")
    log(f"phase 25 (a) collectives through the host, {st['rate_bytes']} "
        f"bytes from every rank to every other of a group, GB/s into rank "
        f"0 (median of 3): {rates}; {nvidia_smi_line() if not rehearsal else 'cpu'}")
    for n, g in rowwise_gaps.items():
        check(g["params"][0] <= bounds["params"]
              and max(g["m"][0], g["v"][0]) <= bounds["moments"],
              f"phase 25: rowwise_train_step's state after step {n} is off "
              f"make_train_step's: {g}")
    check(max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], r_losses))
          <= bounds["rowwise_loss"],
          f"phase 25: the sharded losses {r0['losses']} are off "
          f"rowwise_train_step's {r_losses}")
    check(max(rel["losses"]) <= bounds["loss"], f"phase 25: the losses "
          f"{rel['losses']} from the single device's, beyond {bounds['loss']}")
    check(max(rel["grad_norms"]) <= bounds["grad_norm"], f"phase 25: "
          f"grad_norm {rel['grad_norms']} from the single device's, beyond "
          f"{bounds['grad_norm']}")
    for n, g in gaps.items():
        at = 0 if n == 1 else 1
        check(g["params"][0] <= bounds["rowwise_params"][at]
              and max(g["m"][0], g["v"][0]) <= bounds["rowwise_moments"][at],
              f"phase 25: the sharded state after step {n} is off "
              f"rowwise_train_step's: {g}")
    check(all(r["losses"] == r0["losses"] for r in ranks),
          "phase 25: the ranks' losses differ")
    check(all(r["repeat"] for r in ranks),
          "phase 25: the same sharded step from one state gave other bits")
    check(all(r["shapes_ok"] for r in ranks),
          "phase 25: a shard's shape is not what its placements give")
    check(all(math.isfinite(x) for x in r0["losses"] + r0["grad_norms"]),
          "phase 25: a non-finite loss or grad_norm")
    for nm in LM_WRAPPERS + ("flash_attention.tc", "flash_attention_bwd.tc"):
        check(per_step.get(nm, 0) == want[nm] or rehearsal,
              f"phase 25: {nm} launched {per_step.get(nm, 0)} times a rank "
              f"a step, not {want[nm]}")

    # (b) the elastic resume, and the parent's unsharded restore
    rp = st["replay"]
    cut = dataclasses.replace(cfg, n_layers=rp["layers"])
    el = [r["elastic"] for r in ranks]
    ck = os.path.join(job["scratch"], "elastic")
    ck_bytes = sum(f.stat().st_size for f in
                   (Path(ck) / f"step_{st['save_at']:06d}").iterdir())
    t0 = time.perf_counter()
    restored, at = restore_checkpoint(ck, meta_train_state(cut), device=dev)
    sync()
    restore_s = time.perf_counter() - t0
    arrays = load_checkpoint_arrays(ck)[2]
    parent_bits = all(_same_bytes(x, a) for x, a in
                      zip(tree_flatten(restored)[0], arrays))
    del restored, arrays
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rep["b"] = dict(step=at, bits=[e["bits"] for e in el],
                    mesh=el[0]["mesh"], checkpoint_bytes=ck_bytes,
                    save_s=r0["save_s"], resume_s=r0["resume_s"],
                    parent_restore_s=restore_s, parent_bits=parent_bits,
                    layers=rp["layers"], seq=rp["seq"])
    log(f"phase 25 (b) on the cut to {rp['layers']} layers, step "
        f"{st['save_at']} saved from mesh {tuple(st['mesh'])} "
        f"({ck_bytes / 1e9:.3f} GB, {r0['save_s']:.2f} s with the transfers "
        f"to rank 0) and resumed on {tuple(el[0]['mesh'])} in "
        f"{r0['resume_s']:.2f} s: both states the file's bits, shard for "
        f"shard, on every rank: {rep['b']['bits']}; the parent's unsharded "
        f"restore {restore_s:.2f} s, the file's bits: {parent_bits}")
    check(all(e["bits"] and e["step"] == st["save_at"] and e["has"]
              and e["shapes_ok"] for e in el),
          "phase 25: the elastic resume is not the saved state's bits, or "
          "a shard is not the shape its placements give")
    check(at == st["save_at"] and parent_bits,
          "phase 25: the unsharded restore is not the checkpoint's bits")

    # (c) the replay
    rps = [r["replay"] for r in ranks]
    rep["c"] = dict(rps[0], bits=[x["bits"] for x in rps], **rp)
    log(f"phase 25 (c) ResilientLoop(state_shardings=...) on the cut to "
        f"{rp['layers']} layers and {rp['seq']} tokens, {rp['steps']} steps, "
        f"a checkpoint every {rp['ckpt_every']}, a failure at step "
        f"{rp['fail_at']}: {rps[0]['restarts']} restart, uninterrupted "
        f"{rps[0]['clean_s']:.2f} s, faulted {rps[0]['faulted_s']:.2f} s, "
        f"bit for bit {rep['c']['bits']}")
    check(all(x["restarts"] == 1 and x["bits"] for x in rps),
          "phase 25: the replay is not its uninterrupted run's bits")
    shutil.rmtree(job["scratch"], ignore_errors=True)

    # (d) the NCCL route: a world of 1 at full depth, phase 18's state
    job1 = dict(arch=st["arch"], batch=TRAIN["batch"], seq=TRAIN["seq"],
                seed=1, rehearsal=rehearsal)
    t0 = time.perf_counter()
    one = spawn_world(nccl_rank, 1, args=(job1,),
                      backend="gloo" if rehearsal else "nccl",
                      timeout=st["timeout"])[0]
    one_s = time.perf_counter() - t0
    p18 = train_rep["first_step"]["kernels"]["loss"] if train_rep else None
    rep["d"] = dict(one, world_s=one_s, phase18_loss=p18)
    log(f"phase 25 (d) a world of 1 over {one['backend']} at full depth: the "
        f"sharded step on the trivial mesh against phase 18's unsharded step "
        f"from the same state, bit for bit {one['bits']}; loss "
        f"{one['loss']:.6f} (phase 18's first step {p18}); the sharded step "
        f"{one['seconds']:.2f} s, the world {one_s:.1f} s")
    check(all(one["bits"].values()), f"phase 25: the sharded step on the "
          f"trivial mesh is not the unsharded step's bits {one['bits']}")
    check(p18 is None or one["want_loss"] == p18,
          "phase 25: the unsharded step is not phase 18's first step")

    # (e) the launcher, as a user runs it, and (f) the LM example beside
    # it (a few GB of the card), once no world is timing its steps
    if not rehearsal:
        t0 = time.perf_counter()
        lm = _start(["repro_torch.examples.train_lm"],
                    tempfile.mkdtemp(prefix="lm_", dir=scratch))
        launcher = _start(["repro_torch.launch.train", *LAUNCHER],
                          tempfile.mkdtemp(prefix="launch_", dir=scratch))
        so, sec = _finish(launcher, "(e) launch.train", t0)
        check("loss" in so and "restarts=1" in so,
              "phase 25: the launcher printed no loss or not restarts=1")
        rep["e"] = dict(stdout=so, seconds=sec)
        so, sec = _finish(lm, "(f) examples.train_lm", t0)
        mt = re.search(r"loss: start=([0-9.]+) end=([0-9.]+)", so)
        check(mt is not None and float(mt.group(2)) < float(mt.group(1)),
              "phase 25: the LM example's loss did not fall")
        rep["f"] = dict(stdout=so, seconds=sec, start=float(mt.group(1)),
                        end=float(mt.group(2)))

    # (g) the model-FLOP share of phases 18 and 22
    _, _, bf16 = peaks(torch.cuda.get_device_name(0)) \
        if dev.type == "cuda" else (0, 0, 989e12)
    share = {}
    for label, c, r in (("train", full_cfg, train_rep),
                        ("mla_train", mla_train_cfg, mla_train_rep)):
        if r is None:
            continue
        mf = model_flops(c, "train", r["batch"], r["seq"])
        sec = r["step_ms_median_last"] / 1e3
        share[label] = dict(model_flops=mf, step_s=sec,
                            flops_per_s=mf / sec,
                            share=mf / sec / bf16)
    rep["g"] = dict(bf16_peak=bf16, mfu=share)
    log(f"phase 25 (g) model FLOPs a step over the median step time and "
        f"the bf16 peak ({bf16 / 1e12:.0f} TFLOP/s), "
        f"{nvidia_smi_line()}: "
        + "; ".join(f"{k} {v['model_flops']:.5g} FLOP in {v['step_s']:.4f} s"
                    f" = {v['flops_per_s'] / 1e12:.2f} TFLOP/s, "
                    f"{v['share']:.2%}" for k, v in share.items()))
    rep["launches"] = launches
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
    bu_mod = kernel_module("bounds_upkeep")
    ct_mod = kernel_module("candidate_tail")
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
    # the forward's and the backward's tensor-core kernels
    report["hgmma"] = {nm: hgmma_count(_build.library_path(nm))
                       for nm in ("flash_attention", "flash_attention_bwd")}

    wrappers = {"grouped_assign": kernels.grouped_assign,
                "centroid_update": kernels.centroid_update,
                "bounds_upkeep": kernels.bounds_upkeep,
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
        kernels.bounds_upkeep = bu_mod.bounds_upkeep_plain
        kernels.own_dists = bu_mod.own_dists_plain
        kernels.candidate_mask = ct_mod.candidate_mask_plain
        kernels.candidate_tail = ct_mod.candidate_tail_plain
        try:
            yield
        finally:
            kernels.grouped_assign = wrappers["grouped_assign"]
            kernels.centroid_update = wrappers["centroid_update"]
            kernels.bounds_upkeep = wrappers["bounds_upkeep"]
            kernels.own_dists = bu_mod.own_dists
            kernels.candidate_mask = ct_mod.candidate_mask
            kernels.candidate_tail = ct_mod.candidate_tail

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

    # -- 2e. the bound upkeep of a move ----------------------------------
    report["bounds_upkeep"] = bu_cases = bounds_upkeep_phase(dev, bw)
    bu_main = bu_cases[0]
    own_main = next(c for c in bu_cases if c["kernel"] == "own_dists")

    # -- 2f. the candidate pass's group filter and tail -----------------
    report["candidate_tail"] = ct_cases = candidate_tail_phase(dev, bw)
    ct_mask_main, ct_tail_main = ct_cases[:2]

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
        the port's first kernel (``filtered_assign_simple``) where that
        kernel takes the shape; the variant the launch took (and the
        slice of D it walks) is logged, and every case must take the new
        kernel."""
        kw = dict(tile_n=tile_n, tile_k=tile_k, x2=x2, c2=c2)
        n_, d_ = x.shape
        k_ = c.shape[0]
        points, stages, d_slice = fa_mod.variant(d_, k_, tile_n, tile_k)
        check(points > 0, f"{label}: no variant of the kernel takes tiles "
              f"{tile_n}x{tile_k} at D = {d_}")
        with_first = fa_mod.simple_takes(d_, tile_n, tile_k)
        got = kernels.filtered_assign(x, c, mask, **kw)
        want = fa_mod.filtered_assign_plain(x, c, mask, **kw)
        if with_first:
            first = fa_mod.filtered_assign_simple(x, c, mask, **kw)
        sync()
        check(not with_first or (torch.equal(got[0], first[0])
                                 and torch.equal(got[1], first[1])),
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
                     tile_k=tile_k, variant=dict(points=points, stages=stages,
                                                 d_slice=d_slice),
                     density=float(mask.float().mean()), live_pairs=pairs,
                     max_abs_err=err, atol=atol, argmin_tie_rows=ties,
                     equals_first_kernel=with_first or None)
        if timed:
            nbytes = 4 * (n_ * d_ + n_ + k_ * d_ + k_) + gn * gk + 8 * n_
            bound_ms, by = bound(nbytes, 2.0 * d_ * pairs)

            def new():
                return kernels.filtered_assign(x, c, mask, **kw)

            def old():
                return fa_mod.filtered_assign_simple(x, c, mask, **kw)
            # in turns: the first kernel, the new one, the new, the first
            # (where the first kernel takes the shape)
            turns = {"earlier": [cuda_ms(old)]} if with_first else {}
            turns["new"] = [cuda_ms(new), cuda_ms(new)]
            if with_first:
                turns["earlier"].append(cuda_ms(old))
                entry["earlier_ms"] = statistics.mean(turns["earlier"])
            entry.update(
                ms=statistics.mean(turns["new"]), turns_ms=turns,
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
    # a D too wide for whole rows in shared memory: the kernel walks D in
    # slices (the first kernel takes D = 256 at 64x16 only), timed
    fa_wide = []
    for d_w in (256, 700):
        xw = torch.randn((FA_WIDE["n"], d_w), generator=gen, device=dev)
        cw = torch.randn((FA_WIDE["k"], d_w), generator=gen, device=dev)
        for tn, tk in ((256, 128), (64, 16)):
            fa_wide.append(fa_case(
                f"wide D={d_w} {tn}x{tk} density {FA_WIDE['density']}", xw,
                cw, rand_mask(FA_WIDE["n"], FA_WIDE["k"], tn, tk,
                              FA_WIDE["density"]), tn, tk, timed=True))
        del xw, cw
    check(all(e["variant"]["d_slice"] > 0 for e in fa_wide),
          "filtered_assign: a wide D took whole rows, not slices")
    check(any(e["equals_first_kernel"] for e in fa_wide),
          "filtered_assign: no wide D case was held bit for bit against "
          "the first kernel")
    report["filtered_assign_wide_d"] = fa_wide
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
    ct_before = (kernels.candidate_mask.launches,
                 kernels.candidate_tail.launches)
    sync()
    t0 = time.perf_counter()
    km.fit(points)
    sync()
    fit_s = time.perf_counter() - t0
    # the candidate pass's mask and tail, once a pass: n_iters bodies and
    # the epilogue
    ct_fit = {"candidate_mask": kernels.candidate_mask.launches
              - ct_before[0],
              "candidate_tail": kernels.candidate_tail.launches
              - ct_before[1]}
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
    # one bound upkeep a move
    check(launches["bounds_upkeep"] == n_iters,
          f"bounds_upkeep launched {launches['bounds_upkeep']} times on the "
          f"main path for n_iters={n_iters}")
    log(f"candidate pass kernels on the main path's fit: {ct_fit}")
    for nm, cnt in ct_fit.items():
        check(cnt == n_iters + 1, f"{nm} launched {cnt} times in the main "
              f"path's fit, not once a pass ({n_iters + 1})")
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
                          first_kernel_fit_s=first_fit_s,
                          candidate_launches=ct_fit)

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
    attn_main, ssd_main, report["lm_kernels_more"] = lm_kernel_phase(
        dev, gen, bw, fp32, bf16, lm_cfg, SERVE["batch"], SERVE["prompt"])

    # -- 2d. the backward kernels against their plain versions -----------
    t0 = time.perf_counter()
    attn_bwd, ssd_bwd, report["lm_backward_more"] = lm_backward_phase(
        dev, gen, bw, fp32, bf16, lm_cfg, TRAIN["batch"], TRAIN["seq"])
    log(f"phase 2d took {time.perf_counter() - t0:.1f} s")

    # -- 10. the LM serving path: hymba-1.5b at full width and depth -----
    del points
    t0 = time.perf_counter()
    nl = lm_cfg.n_layers
    # bf16 at a head dim of 64: every attention launch on the tensor cores
    serve_rep, cache = serve_phase(
        dev, torch.Generator(device=dev).manual_seed(0), wrappers, lm_cfg,
        SERVE["batch"], SERVE["prompt"], SERVE["steps"],
        expect={"flash_attention": nl, "flash_attention.tc": nl,
                "ssd_intra": nl})
    report["serve"] = serve_rep
    # phase 20's input: the first prompt's layer-0 keys and values
    kv0 = tuple(cache[nm][0, 0, :SERVE["prompt"]].clone()
                for nm in ("k", "v"))
    del cache
    log(f"phase 10 took {time.perf_counter() - t0:.1f} s")

    # -- 18. training at hymba-1.5b's full width and depth ---------------
    t0 = time.perf_counter()
    train_cfg = get_config(TRAIN["arch"])
    nl = train_cfg.n_layers
    report["train"] = train_rep = train_phase(
        dev, torch.Generator(device=dev).manual_seed(1), wrappers, train_cfg,
        TRAIN["batch"], TRAIN["seq"], TRAIN["steps"],
        # each layer's forward and its recomputation; bf16 at head dim
        # 64: the tensor-core kernels alone, forward and backward
        want={"flash_attention": 2 * nl, "flash_attention.tc": 2 * nl,
              "ssd_intra": 2 * nl, "flash_attention_bwd": nl,
              "flash_attention_bwd.tc": nl, "ssd_intra_bwd": nl})
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

    # -- 21. MLA serving: minicpm3-4b at full width and depth ------------
    t0 = time.perf_counter()
    mla_cfg = get_config(MLA_SERVE["arch"])
    nl = mla_cfg.n_layers
    # bf16 at q.k 96: every attention launch on the tensor cores, none
    # on FFMA (a counter not named must not move)
    mla_rep, cache = serve_phase(
        dev, torch.Generator(device=dev).manual_seed(3), wrappers, mla_cfg,
        MLA_SERVE["batch"], MLA_SERVE["prompt"], MLA_SERVE["steps"],
        expect={"flash_attention": nl, "flash_attention.tc": nl})
    mm = mla_cfg.mla
    # the latent cache beside a GQA cache of H heads of q.k's width
    gqa_bytes = 2 * nl * MLA_SERVE["batch"] * mla_rep["cache_positions"] \
        * mla_cfg.n_heads * (mm.nope_dim + mm.rope_dim) * 2
    mla_rep["gqa_cache_bytes"] = gqa_bytes
    log(f"serve {mla_cfg.name}: latent cache {mla_rep['cache_bytes']} "
        f"bytes, a GQA "
        f"cache of {mla_cfg.n_heads} heads of {mm.nope_dim + mm.rope_dim} "
        f"{gqa_bytes} bytes ({mla_rep['cache_bytes'] / gqa_bytes:.4f})")
    del cache
    report["mla_serve"] = mla_rep
    torch.cuda.empty_cache()
    log(f"phase 21 took {time.perf_counter() - t0:.1f} s")

    # -- 22. MLA training: minicpm3-4b at full width, 31 of 62 layers ----
    t0 = time.perf_counter()
    mla_train_cfg = dataclasses.replace(get_config(MLA_TRAIN["arch"]),
                                        n_layers=MLA_TRAIN["layers"])
    nl = mla_train_cfg.n_layers
    log(f"train {mla_train_cfg.name}: cut to {nl} of "
        f"{get_config(MLA_TRAIN['arch']).n_layers} layers (at 22 bytes a "
        f"parameter full depth needs about 94 GB)")
    report["mla_train"] = mla_train_rep = train_phase(
        dev, torch.Generator(device=dev).manual_seed(4), wrappers,
        mla_train_cfg, MLA_TRAIN["batch"], MLA_TRAIN["seq"],
        MLA_TRAIN["steps"],
        # bf16 at q.k 96: the tensor-core kernels alone, forward and
        # backward
        want={"flash_attention": 2 * nl, "flash_attention.tc": 2 * nl,
              "flash_attention_bwd": nl, "flash_attention_bwd.tc": nl},
        # three states of 31 layers (2.32e9 parameters) do not fit
        first_on_host=True)
    torch.cuda.empty_cache()
    log(f"phase 22 took {time.perf_counter() - t0:.1f} s")

    # -- 23. qwen2-7b serving, native and with the int8 KV cache ---------
    t0 = time.perf_counter()
    q_cfg = get_config(INT8_SERVE["arch"])
    nl = q_cfg.n_layers
    # bf16 at a head dim of 128: the tensor-core kernel
    int8_rep, cache = serve_phase(
        dev, torch.Generator(device=dev).manual_seed(5), wrappers, q_cfg,
        INT8_SERVE["batch"], INT8_SERVE["prompt"], INT8_SERVE["steps"],
        expect={"flash_attention": nl, "flash_attention.tc": nl},
        int8=True)
    del cache
    report["int8_serve"] = int8_rep
    torch.cuda.empty_cache()
    log(f"phase 23 took {time.perf_counter() - t0:.1f} s")

    # -- 24. the MoE FFN: qwen3-moe and llama4-scout served ---------------
    t0 = time.perf_counter()
    report["moe_serve"] = moe_rep = moe_serve_phase(
        dev, wrappers, MOE_SERVE, seed=6, router_init=True)
    report["scout_serve"] = scout_rep = moe_serve_phase(
        dev, wrappers, SCOUT_SERVE, seed=7)
    report["moe_layer"] = moe_layer_phase(
        dev, torch.Generator(device=dev).manual_seed(8),
        get_config(MOE_SERVE["arch"]), MOE_SERVE["batch"],
        MOE_SERVE["prompt"])
    torch.cuda.empty_cache()
    log(f"phase 24 took {time.perf_counter() - t0:.1f} s")

    # -- 25. the sharded train state on torch.distributed ----------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["sharded_train"] = sharded_rep = sharded_train_phase(
        dev, scratch, train_rep, mla_train_cfg, mla_train_rep)
    torch.cuda.empty_cache()
    log(f"phase 25 took {time.perf_counter() - t0:.1f} s")

    lm_paths = {"lm_serve": serve_rep["launches"],       # phase 10
                "train": train_rep["launches"],          # phase 18
                "mla_serve": mla_rep["launches"],        # phase 21
                "mla_train": mla_train_rep["launches"],  # phase 22
                "qwen2_serve": int8_rep["launches"],     # phase 23
                "moe_serve": moe_rep["launches"],        # phase 24 (a)
                "scout_serve": scout_rep["launches"],    # phase 24 (b)
                # phase 25 (a), summed over the ranks
                "sharded_train": sharded_rep["launches"]}
    train_paths = {"train": train_rep["launches"],
                   "mla_train": mla_train_rep["launches"],
                   "sharded_train": sharded_rep["launches"]}

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
        # no TPU counterpart: the move's bound upkeep, array code in
        # repro/core/engine.py that XLA fuses; the sharded drivers'
        # ranks count their own
        row("bounds_upkeep", bu_main,
            "src/repro_torch/kernels/csrc/bounds_upkeep.cu",
            "none (repro/core/engine.py move_and_bounds, fused by XLA)",
            {"fit": launches, "stream": stream_launches,
             "resilient_stream": resilient_launches}),
        # no TPU counterpart: the candidate pass's group filter and tail
        # around grouped_assign, array code in repro/core/engine.py that
        # XLA fuses; launched once a pass of the main path's fit
        row("candidate_mask", ct_mask_main,
            "src/repro_torch/kernels/csrc/candidate_tail.cu",
            "none (repro/core/engine.py pallas_candidate_pass, fused by "
            "XLA)", {"fit": ct_fit}),
        row("candidate_tail", ct_tail_main,
            "src/repro_torch/kernels/csrc/candidate_tail.cu",
            "none (repro/core/engine.py _finish_pass, fused by XLA)",
            {"fit": ct_fit}),
        # the compact pass's in-pass refresh in the same order, run by
        # phase 16's tuned sharded fit (summed over its ranks)
        row("own_dists", own_main,
            "src/repro_torch/kernels/csrc/bounds_upkeep.cu",
            "none (repro/core/engine.py compact_candidate_pass, fused by "
            "XLA)", {"sharded_auto": report["sharded"]["auto_launches"]}),
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
            "src/repro/kernels/flash_attention.py:77", train_paths),
        row("ssd_intra_bwd", ssd_bwd,
            "src/repro_torch/kernels/csrc/ssd_intra_bwd.cu",
            "src/repro/kernels/ssd_intra.py:44", train_paths),
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
