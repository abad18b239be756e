// Fused SSD intra-chunk pass (Mamba-2), for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/ssd_intra.py
// (ssd_intra -> _ssd_intra_kernel). For each cell (one batch·chunk and
// one head) with C, B (Q, N), x (Q, P) and the within-chunk cumulative
// log-decay cum (Q,), all fp32, it writes the fp32
//
//     y[i] = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) x_j
//
// without the (Q, Q) scores or decays ever reaching device memory.
// Cells are (outer, head) pairs: head h reads the C and B of group
// h / rep, and every tensor is read through its own (outer, group or
// head, row) strides with N or P contiguous, so the model passes its
// (batch, chunk, Q, G, N) and (batch, chunk, Q, H, P) tensors as they
// are, with no per-head copy of B and C; the entry point's (G, Q, N)
// cells are the case of one head.
//
// Bound on the card: at hymba-1.5b's prefill (B = 2, S = 2048, 25
// heads, Q = 128, N = 16, P = 128) the causal half of the two products
// is 1.9 GFLOP (0.028 ms in fp32 FFMA) against 105 MB of x in and y
// out (0.031 ms at 3.35 TB/s): about balanced, bytes slightly ahead.
//
// Design. The port's first kernel of it moved 0.55 TB/s: it
// staged with one scalar load and one divide an element and nothing in
// flight while it computed, its 62 KB blocks left three to an SM, and
// its (cell, 64-row) grid read a cell's first rows of x twice and split
// the work 1:2. This one:
//   - a block owns (cell, up to 128 columns of P, up to 128 rows of Q):
//     at Q <= 128 and P <= 128 a whole cell, so each element of x is
//     read once. It walks the causal triangle in 32-row j-blocks of B
//     and x.
//   - j-blocks of B, x and cum stream by cp.async into a ring of
//     kStages = 3 stages, two in flight while one is computed (C and
//     cum of the block's rows ride with the first). Copies are 16 bytes
//     where every row of C, B and x starts on 16 bytes (N and P
//     multiples of 4, strides and bases aligned) and 4 bytes otherwise,
//     zero-filled past Q, N and P either way: no route without copies
//     in flight, and nothing raised.
//   - thread (ty, tx) of 16 x TY keeps rows ty + TY k of y and columns
//     4 tx .. 4 tx + 3 (and 64 + 4 tx .. at P > 64): 8 x 8 fp32
//     accumulators at P = 128, so that a j's 16 floats a lane from
//     shared memory (scores of 8 rows, x of 8 columns) feed 64 FFMAs,
//     what the SM's shared memory and FFMA units do in the same time.
//     Row groups wholly above a j-block skip it, a case compiled for
//     each first row group, so the loops carry no branch; with 16
//     thread rows, the diagonal j-block's first 16 rows skip its last
//     16 columns too. The work is the same for every thread.
//   - the scores of a j-block (C B^T, then the decay) go to shared
//     memory, formed by the same threads for rows ty + TY k and
//     columns tx, tx + 16.
//   - 256 threads where the block's shared memory leaves two blocks an
//     SM (hymba's N = 16: 86 KB), else 512 (N = 128: 162 KB, one block
//     an SM): 16 warps an SM either way (ssd_intra_resident_warps).
// Above the diagonal (j > i) and past Q the decay is *selected* to 0,
// never multiplied: there exp(cum_i - cum_j) is exp of a positive
// number and may be inf. Products are fp32 FFMA.
#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kRB = 128;       // rows of y a block owns at most
constexpr int kJB = 32;        // rows of B and x a ring stage holds
constexpr int kStages = 3;     // ring stages
constexpr int kLdS = kJB + 4;  // scores row stride
// two blocks an SM: 233,472 bytes of shared memory, 1,024 kept back for
// each block
constexpr int kSmemTarget = 115712;

struct Strides {
  long long o, g, r;           // outer, group or head, row; elements
};

extern __shared__ __align__(16) float sm[];

__device__ __forceinline__ uint32_t saddr(const float* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes from src to shared dst; bytes 0 writes zeros
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + rows) x columns [col0, col0 + width) of src (row
// stride rs, the last axis contiguous) into dst (row stride ld), zero
// outside rows < q and columns < w; width a multiple of 4
template <bool kVec, int kThreads>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      long long rs, int row0, int rows,
                                      int q, int col0, int width, int w) {
  const int t = threadIdx.x;
  if (kVec) {
    const int w4 = width / 4;
    for (int e = t; e < rows * w4; e += kThreads) {
      const int r = e / w4, c = 4 * (e - r * w4);
      const bool ok = row0 + r < q && col0 + c < w;
      cp16(dst + r * ld + c,
           ok ? src + (long long)(row0 + r) * rs + col0 + c : src,
           ok ? 16 : 0);
    }
  } else {
    for (int e = t; e < rows * width; e += kThreads) {
      const int r = e / width, c = e - r * width;
      const bool ok = row0 + r < q && col0 + c < w;
      cp4(dst + r * ld + c,
          ok ? src + (long long)(row0 + r) * rs + col0 + c : src,
          ok ? 4 : 0);
    }
  }
}

// cum of rows [row0, row0 + rows) (stride rs) into dst, zero past q
template <int kThreads>
__device__ __forceinline__ void stage_cum(float* dst, const float* src,
                                          long long rs, int row0, int rows,
                                          int q) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const bool ok = row0 + r < q;
    cp4(dst + r, ok ? src + (long long)(row0 + r) * rs : src, ok ? 4 : 0);
  }
}

__host__ __device__ inline int n_ld(int n) {
  const int n4 = (n + 3) & ~3;
  return (n4 / 4) % 2 == 0 ? n4 + 4 : n4;    // an odd number of float4s
}

// kPS: the columns of y a block owns, 64 or 128
__host__ __device__ inline size_t smem_floats(int n, int kPS) {
  const int ldn = n_ld(n);
  return (size_t)kRB * ldn + kRB + (size_t)kRB * kLdS +
         (size_t)kStages * (kJB * ldn + kJB * kPS + kJB);
}

template <int kThreads, int kPS, bool kVec>
__global__ void __launch_bounds__(kThreads, 512 / kThreads)
ssd_kernel(const float* __restrict__ c, const float* __restrict__ b,
           const float* __restrict__ x, const float* __restrict__ cum,
           float* __restrict__ out, int q, int n, int p, int heads, int rep,
           int pslices, Strides cs, Strides bs, Strides xs, Strides us,
           Strides os) {
  constexpr int kTY = kThreads / 16;        // thread rows
  constexpr int kRows = kRB / kTY;          // rows of y a thread keeps
  constexpr int kC4 = kPS / 64;             // float4 columns it keeps
  const int n4 = (n + 3) & ~3, ldn = n_ld(n);
  float* csm = sm;                          // [kRB][ldn]
  float* cum_i = csm + kRB * ldn;           // [kRB]
  float* ssm = cum_i + kRB;                 // [kRB][kLdS]
  float* ring = ssm + kRB * kLdS;           // kStages x stage
  const int stage_floats = kJB * ldn + kJB * kPS + kJB;

  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  // y rows a thread keeps: ty + kTY k, so that the causal triangle
  // gives every thread as much work
  auto frow = [&](int k) { return ty + kTY * k; };
  const int cell = blockIdx.x / pslices;
  const int p0 = (blockIdx.x - cell * pslices) * kPS;
  const int outer = cell / heads, hd = cell - outer * heads, grp = hd / rep;
  const int i0 = blockIdx.y * kRB;

  const float* cp = c + outer * cs.o + grp * cs.g;
  const float* bp = b + outer * bs.o + grp * bs.g;
  const float* xp = x + outer * xs.o + hd * xs.g;
  const float* up = cum + outer * us.o + hd * us.g;

  const int last = min(i0 + kRB, q);        // rows [i0, last) of y
  const int njb = (last + kJB - 1) / kJB;   // j-blocks 0 .. njb - 1

  auto load_jb = [&](int jb) {
    float* st = ring + (jb % kStages) * stage_floats;
    const int j0 = jb * kJB;
    stage<kVec, kThreads>(st, ldn, bp, bs.r, j0, kJB, q, 0, n4, n);
    stage<kVec, kThreads>(st + kJB * ldn, kPS, xp, xs.r, j0, kJB, q, p0, kPS,
                          p);
    stage_cum<kThreads>(st + kJB * ldn + kJB * kPS, up, us.r, j0, kJB, q);
  };

  // C and cum of the block's rows go with the first stage
  stage<kVec, kThreads>(csm, ldn, cp, cs.r, i0, kRB, q, 0, n4, n);
  stage_cum<kThreads>(cum_i, up, us.r, i0, kRB, q);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < njb) load_jb(s);
    cp_commit();
  }

  float acc[kRows][4 * kC4];
#pragma unroll
  for (int k = 0; k < kRows; ++k)
#pragma unroll
    for (int o = 0; o < 4 * kC4; ++o) acc[k][o] = 0.0f;

  for (int jb = 0; jb < njb; ++jb) {
    if (jb + kStages - 1 < njb) load_jb(jb + kStages - 1);
    cp_commit();
    cp_wait<kStages - 1>();                 // j-block jb has landed
    __syncthreads();
    const float* bsm = ring + (jb % kStages) * stage_floats;
    const float* xsm = bsm + kJB * ldn;
    const float* cum_j = xsm + kJB * kPS;
    const int j0 = jb * kJB;

    // the scores of rows at or below the j-block's first row, in row
    // groups k >= k0 of rows ty + kTY k (a group wholly above it takes no
    // part); k0 is the same for every thread, and each case is compiled
    // on its own, so the loops carry no branch. With 16 thread rows, on
    // the diagonal (diag) the rows j0 .. j0 + 15 have nothing in the
    // j-block's columns 16 .. 31 (all above the diagonal): their scores
    // there are not formed, and the product skips them.
    auto rows_from = [&](auto k0c, auto diagc) {
      constexpr int k0 = decltype(k0c)::value;
      constexpr bool diag = decltype(diagc)::value;
      // scores of rows ty + kTY k, columns tx and tx + 16
      float sc[kRows][2];
#pragma unroll
      for (int k = k0; k < kRows; ++k) sc[k][0] = sc[k][1] = 0.0f;
      for (int nn = 0; nn < n4; nn += 4) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(&bsm[tx * ldn + nn]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&bsm[(tx + 16) * ldn + nn]);
#pragma unroll
        for (int k = k0; k < kRows; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(
              &csm[(ty + kTY * k) * ldn + nn]);
          float s0 = sc[k][0], s1 = sc[k][1];
          s0 = fmaf(a.x, b0.x, s0);
          s0 = fmaf(a.y, b0.y, s0);
          s0 = fmaf(a.z, b0.z, s0);
          s0 = fmaf(a.w, b0.w, s0);
          if (!(diag && k == k0)) {
            s1 = fmaf(a.x, b1.x, s1);
            s1 = fmaf(a.y, b1.y, s1);
            s1 = fmaf(a.z, b1.z, s1);
            s1 = fmaf(a.w, b1.w, s1);
          }
          sc[k][0] = s0;
          sc[k][1] = s1;
        }
      }
#pragma unroll
      for (int k = k0; k < kRows; ++k) {
        const int li = ty + kTY * k, row = i0 + li;
#pragma unroll
        for (int m = 0; m < (diag && k == k0 ? 1 : 2); ++m) {
          const int lj = tx + 16 * m, col = j0 + lj;
          ssm[li * kLdS + lj] = (col <= row && col < q && row < q)
              ? sc[k][m] * expf(cum_i[li] - cum_j[lj]) : 0.0f;
        }
      }
      __syncthreads();                      // the scores block complete

    };
    using T = std::true_type;
    using F = std::false_type;
    const int k0 = max(0, (j0 - i0) / kTY);
    if (kTY == 16 && j0 >= i0) {            // k0 = 0, 2, 4 or 6
      switch (k0) {
        case 0: rows_from(std::integral_constant<int, 0>{}, T{}); break;
        case 2: rows_from(std::integral_constant<int, 2>{}, T{}); break;
        case 4: rows_from(std::integral_constant<int, 4>{}, T{}); break;
        default: rows_from(std::integral_constant<int, 6>{}, T{}); break;
      }
    } else {                                // 32 thread rows, or below it
      switch (k0) {
        case 0: rows_from(std::integral_constant<int, 0>{}, F{}); break;
        case 1: rows_from(std::integral_constant<int, 1>{}, F{}); break;
        case 2: rows_from(std::integral_constant<int, 2>{}, F{}); break;
        default: rows_from(std::integral_constant<int, 3>{}, F{}); break;
      }
    }

    // y += scores x over the j-block's columns [jlo, jhi), 2 j at a time:
    // a float2 of scores a row, and kC4 float4s of x a j, against
    // 8 kC4 kRows FFMAs (at kPS = 128, 16 floats a lane a j feed 64
    // FFMAs: what the SM's shared memory and its FFMA units do in the
    // same time). Row groups k >= kf take part: those with a row at or
    // below the first column.
    auto product = [&](auto kfc, int jlo, int jhi) {
      constexpr int kf = decltype(kfc)::value;
#pragma unroll 1
      for (int jj = jlo; jj < jhi; jj += 2) {
        float2 s2[kRows];
#pragma unroll
        for (int k = kf; k < kRows; ++k)
          s2[k] = *reinterpret_cast<const float2*>(&ssm[frow(k) * kLdS + jj]);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float4 xv[kC4];
#pragma unroll
          for (int h = 0; h < kC4; ++h)
            xv[h] = *reinterpret_cast<const float4*>(
                &xsm[(jj + u) * kPS + 64 * h + 4 * tx]);
#pragma unroll
          for (int k = kf; k < kRows; ++k) {
            const float sv = u == 0 ? s2[k].x : s2[k].y;
#pragma unroll
            for (int h = 0; h < kC4; ++h) {
              acc[k][4 * h + 0] = fmaf(sv, xv[h].x, acc[k][4 * h + 0]);
              acc[k][4 * h + 1] = fmaf(sv, xv[h].y, acc[k][4 * h + 1]);
              acc[k][4 * h + 2] = fmaf(sv, xv[h].z, acc[k][4 * h + 2]);
              acc[k][4 * h + 3] = fmaf(sv, xv[h].w, acc[k][4 * h + 3]);
            }
          }
        }
      }
    };
    auto product_from = [&](int jlo, int jhi) {
      switch (max(0, (j0 + jlo - i0) / kTY)) {
        case 0: product(std::integral_constant<int, 0>{}, jlo, jhi); break;
        case 1: product(std::integral_constant<int, 1>{}, jlo, jhi); break;
        case 2: product(std::integral_constant<int, 2>{}, jlo, jhi); break;
        case 3: product(std::integral_constant<int, 3>{}, jlo, jhi); break;
        case 4: product(std::integral_constant<int, 4>{}, jlo, jhi); break;
        case 5: product(std::integral_constant<int, 5>{}, jlo, jhi); break;
        case 6: product(std::integral_constant<int, 6>{}, jlo, jhi); break;
        default: product(std::integral_constant<int, 7>{}, jlo, jhi); break;
      }
    };
    if (kTY == 16 && j0 >= i0) {            // the diagonal's two halves
      product_from(0, kJB / 2);
      product_from(kJB / 2, kJB);
    } else {
      product_from(0, kJB);
    }
    __syncthreads();                        // the stage and scores are free
  }

  float* op = out + outer * os.o + hd * os.g;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = i0 + frow(k);
#pragma unroll
    for (int h = 0; h < kC4; ++h) {
      const int col = p0 + 64 * h + 4 * tx;
      if (row >= q || col >= p) continue;
      float* dst = op + (long long)row * os.r + col;
      const float* a = &acc[k][4 * h];
      if (kVec) {
        *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], a[2], a[3]);
      } else {
#pragma unroll
        for (int o = 0; o < 4; ++o)
          if (col + o < p) dst[o] = a[o];
      }
    }
  }
}

template <int kThreads, int kPS, bool kVec>
int launch(const float* c, const float* b, const float* x, const float* cum,
           float* out, int cells, int q, int n, int p, int heads, int rep,
           Strides cs, Strides bs, Strides xs, Strides us, Strides os,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(n, kPS);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<kThreads, kPS, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int pslices = (p + kPS - 1) / kPS;
  const dim3 grid(cells * pslices, (q + kRB - 1) / kRB);
  ssd_kernel<kThreads, kPS, kVec><<<grid, kThreads, bytes, stream>>>(
      c, b, x, cum, out, q, n, p, heads, rep, pslices, cs, bs, xs, us, os);
  return (int)cudaGetLastError();
}

// resident warps an SM of ssd_kernel<kThreads, kPS, true> at N = n
template <int kThreads, int kPS>
int resident_warps(int n) {
  const size_t bytes = sizeof(float) * smem_floats(n, kPS);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<kThreads, kPS, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ssd_kernel<kThreads, kPS, true>, kThreads, bytes);
  return err == cudaSuccess ? blocks * kThreads / 32 : -(int)err;
}

// a block owns 128 columns of y where P > 64, else 64; 256 threads
// where its shared memory leaves two blocks an SM, else 512
bool wide_for(int p) { return p > 64; }
int threads_for(int n, int p) {
  return sizeof(float) * smem_floats(n, wide_for(p) ? 128 : 64) <=
                 kSmemTarget
             ? 256
             : 512;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}
bool strides4(const Strides& s) {
  return s.o % 4 == 0 && s.g % 4 == 0 && s.r % 4 == 0;
}

}  // namespace

extern "C" {

// cells = outer * heads; c and b (outer, groups, q, n) through
// (outer, group, row) strides, x and out (outer, heads, q, p) and cum
// (outer, heads, q) through (outer, head, row) strides, the last axis
// contiguous; all fp32; heads a multiple of groups; n, p <= 128.
// Returns cudaErrorInvalidValue for a shape it cannot take, else
// cudaGetLastError() after the launch.
int ssd_intra_launch(const void* c, const void* b, const void* x,
                     const void* cum, void* out, int outer, int heads,
                     int groups, int q, int n, int p, long long c_so,
                     long long c_sg, long long c_sr, long long b_so,
                     long long b_sg, long long b_sr, long long x_so,
                     long long x_sh, long long x_sr, long long u_so,
                     long long u_sh, long long u_sr, long long o_so,
                     long long o_sh, long long o_sr, void* stream) {
  if (outer < 1 || groups < 1 || heads % groups != 0 || q < 1 || n < 1 ||
      n > 128 || p < 1 || p > 128)
    return (int)cudaErrorInvalidValue;
  const Strides cs{c_so, c_sg, c_sr}, bs{b_so, b_sg, b_sr},
      xs{x_so, x_sh, x_sr}, us{u_so, u_sh, u_sr}, os{o_so, o_sh, o_sr};
  const float *cf = static_cast<const float*>(c),
              *bf = static_cast<const float*>(b),
              *xf = static_cast<const float*>(x),
              *uf = static_cast<const float*>(cum);
  float* of = static_cast<float*>(out);
  const int cells = outer * heads, rep = heads / groups;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte copies and stores where every row starts on 16 bytes
  const bool vec = n % 4 == 0 && p % 4 == 0 && aligned16(c) &&
                   aligned16(b) && aligned16(x) && aligned16(out) &&
                   strides4(cs) && strides4(bs) && strides4(xs) &&
                   strides4(os);
  const bool wide = wide_for(p);
  const bool two_an_sm = threads_for(n, p) == 256;
#define SSD_LAUNCH(T, PS, V)                                              \
  launch<T, PS, V>(cf, bf, xf, uf, of, cells, q, n, p, heads, rep, cs, bs, \
                   xs, us, os, st)
  if (two_an_sm) {
    if (wide) return vec ? SSD_LAUNCH(256, 128, true) : SSD_LAUNCH(256, 128, false);
    return vec ? SSD_LAUNCH(256, 64, true) : SSD_LAUNCH(256, 64, false);
  }
  if (wide) return vec ? SSD_LAUNCH(512, 128, true) : SSD_LAUNCH(512, 128, false);
  return vec ? SSD_LAUNCH(512, 64, true) : SSD_LAUNCH(512, 64, false);
#undef SSD_LAUNCH
}

// warps of the kernel that ssd_intra_launch picks for (n, p) resident on
// an SM at once (from the CUDA occupancy calculator), or minus a CUDA
// error
int ssd_intra_resident_warps(int n, int p) {
  if (n < 1 || n > 128 || p < 1 || p > 128) return -(int)cudaErrorInvalidValue;
  const bool wide = wide_for(p);
  if (threads_for(n, p) == 256)
    return wide ? resident_warps<256, 128>(n) : resident_warps<256, 64>(n);
  return wide ? resident_warps<512, 128>(n) : resident_warps<512, 64>(n);
}

const char* ssd_intra_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
