#!/usr/bin/env python3
"""Where ``filtered_assign``'s and ``pairwise_sq_dists``' time goes.

    python3 scripts/block_skip_probe.py [--out probe.json]

On one card, at uci-xlarge (N = 2^20, D = 32, K = 256, the blob
centres; ``filtered_assign`` at tiles 256x128 with every block live and
the norms given):

1. ``csrc/filtered_assign.cu`` and ``csrc/pairwise_sq_dists.cu`` built
   again with one thing changed by a switch of the sources (``-D``),
   beside the kernels, and timed in turns with them (kernel, copies...,
   copies reversed, kernel) by CUDA events: ``filtered_assign`` with 8
   warps in one block an SM instead of two 4-warp blocks
   (``FA_WARPS=8``), and without its running-min update
   (``FA_PROBE_NO_MIN``); ``pairwise_sq_dists`` without its stores
   (``PSD_PROBE_NO_STORES``) and without its epilogue, the distances and
   the stores (``PSD_PROBE_NO_EPILOGUE``). The outputs of the cut copies
   are wrong by design;
2. the FFMA rate of the kernels' inner loop alone: an 8 x 8 outer product
   a lane from shared memory, D = 32, as ``fa_kernel`` reads it, and
   independent FFMAs on uniform operands, in TFLOP/s;
3. the points' norms at uci-xlarge: ``torch.sum(x * x, -1)`` against the
   wrapper's norm kernel (``filtered_assign._norms``);
4. both kernels against the port's first kernels, in turns, at other
   (N, D, K) of the paper suite's range (``filtered_assign`` at 256x128,
   every block live, norms not given; ``pairwise_sq_dists`` in fp32).

Prints one JSON object. Needs a card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "block_skip_probe"

# (N, D, K) of the sweep: uci-xlarge's N and D at small K, uci-highk's
# shape, and D = 128 at small and large K
SWEEP = [(1 << 20, 32, 64), (1 << 20, 32, 128), (262_144, 32, 1024),
         (65_536, 128, 64), (65_536, 128, 1024)]
# (source, name): the -D switches of each copy
COPIES = {
    ("filtered_assign", "8 warps, one block an SM"): ["-DFA_WARPS=8"],
    ("filtered_assign", "no running-min update"): ["-DFA_PROBE_NO_MIN"],
    ("pairwise_sq_dists", "no stores"): ["-DPSD_PROBE_NO_STORES"],
    ("pairwise_sq_dists", "no epilogue"): ["-DPSD_PROBE_NO_EPILOGUE"],
}

LOOP_CU = r"""
#include <cuda_runtime.h>
#include <stdio.h>
// fa_kernel's loop: rows of 36 floats, lane (lane >> 2, lane & 3), 8 x 8
__global__ void __launch_bounds__(256, 1) outer(float* out, int iters, float s) {
  extern __shared__ __align__(16) float sm[];
  for (int e = threadIdx.x; e < 2 * 256 * 36; e += 256) sm[e] = (e % 97) * s;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int xo = ((warp / 2) * 8 + (lane >> 2)) * 9;
  const int co = 256 * 9 + ((warp % 2) * 4 + (lane & 3)) * 9;
  const float4* sm4 = reinterpret_cast<const float4*>(sm);
  float acc[8][8];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll 2
    for (int q = 0; q < 8; ++q) {
      float4 xv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) xv[i] = sm4[xo + i * 32 * 9 + q];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 cv = sm4[co + j * 8 * 9 + q];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = acc[i][j];
          v = fmaf(xv[i].x, cv.x, v);
          v = fmaf(xv[i].y, cv.y, v);
          v = fmaf(xv[i].z, cv.z, v);
          acc[i][j] = fmaf(xv[i].w, cv.w, v);
        }
      }
    }
  }
  float t = 0.0f;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) t += acc[i][j];
  if (t == 1.2345f) out[threadIdx.x] = t;
}
// independent FFMAs on uniform operands
__global__ void uniform(float* out, int iters, float s) {
  float acc[16];
  for (int i = 0; i < 16; ++i) acc[i] = threadIdx.x * 0.001f + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = fmaf(acc[i], s, 0.001f);
  }
  float t = 0.0f;
  for (int i = 0; i < 16; ++i) t += acc[i];
  if (t == 1.2345f) out[threadIdx.x] = t;
}
int main() {
  float* out;
  cudaMalloc(&out, 4096);
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int smem = 2 * 256 * 36 * 4;
  cudaFuncSetAttribute(outer, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int w = 0; w < 2; ++w) {
    cudaEventRecord(a);
    outer<<<sms, 256, smem>>>(out, 1000, 0.5f);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    if (w) printf("outer %.4f\n", 2.0 * 8 * 256 * 1000 * 256.0 * sms / ms / 1e9);
    cudaEventRecord(a);
    uniform<<<sms * 4, 256>>>(out, 20000, 0.999f);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    cudaEventElapsedTime(&ms, a, b);
    if (w) printf("uniform %.4f\n", 2.0 * 16 * 20000 * 256.0 * sms * 4 / ms / 1e9);
  }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""


def build(build_mod) -> dict:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for (src, name), switches in COPIES.items():
        stem = re.sub(r"\W+", "_", f"{src}_{name}")
        so = OUT_DIR / f"{stem}.so"
        procs[(src, name)] = (subprocess.Popen(
            [build_mod._nvcc(), *build_mod.NVCC_FLAGS, *switches, "-o",
             str(so), str(build_mod.CSRC / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    loop_cu = OUT_DIR / "loop.cu"
    loop_cu.write_text(LOOP_CU)
    exe = OUT_DIR / "loop"
    loop = subprocess.Popen([build_mod._nvcc(), "-gencode",
                             "arch=compute_90a,code=sm_90a", "-O3", "-o",
                             str(exe), str(loop_cu)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"block_skip_probe: nvcc failed on {key}:\n{log}")
        lib = ctypes.CDLL(str(so))
        err = getattr(lib, f"{key[0]}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        libs[key] = lib
    log, _ = loop.communicate()
    if loop.returncode:
        sys.exit(f"block_skip_probe: nvcc failed on the loop:\n{log}")
    return libs, exe


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("block_skip_probe: needs a card")
    from repro_torch.data import make_points
    from repro_torch.kernels import _build
    fa = importlib.import_module("repro_torch.kernels.filtered_assign")
    psd = importlib.import_module("repro_torch.kernels.distance")
    dev = torch.device("cuda", 0)

    def ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    _build.build_all()
    libs, exe = build(_build)
    pts, centres, _ = make_points(1 << 20, 32, 256, seed=0)
    x = torch.from_numpy(pts).to(dev)
    c = torch.from_numpy(centres).to(dev)
    x2 = fa._norms(x)
    c2 = torch.sum(c * c, dim=-1)
    mask = torch.ones((4096, 2), dtype=torch.bool, device=dev)
    calls = {
        "filtered_assign": lambda: fa.filtered_assign(x, c, mask, x2=x2,
                                                      c2=c2),
        "pairwise_sq_dists": lambda: psd.pairwise_sq_dists(x, c)}
    report = {"card": subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "copies_ms": {}}
    for src, call in calls.items():
        kernel = _build.load(src)
        names = [n for s, n in COPIES if s == src]
        turns = {"kernel": [ms(call)]}
        for name in names + names[::-1]:
            _build._LIBS[src] = libs[(src, name)]
            turns.setdefault(name, []).append(ms(call))
        _build._LIBS[src] = kernel
        turns["kernel"].append(ms(call))
        report["copies_ms"][src] = turns
    out = subprocess.run([str(exe)], capture_output=True, text=True)
    rates = dict(line.split() for line in out.stdout.splitlines())
    report["loop_tflops"] = {k: float(v) for k, v in rates.items()}
    report["norms_ms"] = {"torch.sum(x * x, -1)": ms(
        lambda: torch.sum(x * x, dim=-1)), "norm kernel": ms(
        lambda: fa._norms(x))}
    report["sweep_ms"] = {}
    for n, d, k in SWEEP:
        pts, _, _ = make_points(n, d, 16, seed=0)
        xs = torch.from_numpy(pts).to(dev)
        cs = xs[:: n // k][:k].contiguous()
        ms_mask = torch.ones((-(-n // 256), -(-k // 128)), dtype=torch.bool,
                             device=dev)
        pairs = {
            "filtered_assign": (
                lambda: fa.filtered_assign(xs, cs, ms_mask),
                lambda: fa.filtered_assign_simple(xs, cs, ms_mask)),
            "pairwise_sq_dists": (
                lambda: psd.pairwise_sq_dists(xs, cs),
                lambda: psd.pairwise_sq_dists_simple(xs, cs))}
        for src, (new, first) in pairs.items():
            turns = [ms(first), ms(new), ms(new), ms(first)]
            report["sweep_ms"][f"{src} N={n} D={d} K={k}"] = {
                "ms": (turns[1] + turns[2]) / 2,
                "first_kernel_ms": (turns[0] + turns[3]) / 2}
    line = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line)
    print(line)


if __name__ == "__main__":
    main()
