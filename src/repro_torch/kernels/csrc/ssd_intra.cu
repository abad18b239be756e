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
// Design (simple first): one CTA of 256 threads per (cell, 64-row
// tile): the cell is never held whole in shared memory (at Q = N = 128,
// P = 64 that would be 224 KiB). The CTA stages its 64 rows of C once,
// then streams 64-row blocks of B and x up to its last row (blocks
// above the diagonal are skipped), forms the 64 x 64 block of
// (C B^T) ∘ decay in shared memory and adds its product with x into
// per-thread fp32 accumulators: thread (ty, tx) of a 16 x 16 grid holds
// scores of rows ty + 16i and columns tx + 16j, and outputs of its rows
// at columns tx + 16c. The decay is *selected* to 0 above the diagonal
// (j > i) and past Q, never multiplied: there exp(cum_i - cum_j) is
// exp of a positive number and may be inf. Products are fp32 FFMA.
//
// Bound on the card: at hymba-1.5b's prefill (B = 2, S = 2048, 25
// heads, Q = 128, N = 16, P = 128) the causal half of the two products
// is 1.9 GFLOP (0.028 ms in fp32 FFMA) against 105 MB of x in and y
// out (0.031 ms at 3.35 TB/s): about balanced, bytes slightly ahead.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;      // output rows per CTA
constexpr int kCols = 64;      // source rows (j) per streamed block
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLdS = kCols + 4;

struct Strides {
  long long o, g, r;           // outer, group or head, row; elements
};

// rows x width tile of rows row0.. into dst (row stride ld), zero
// outside [0, q) x [0, w)
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      long long row_stride, int row0, int q,
                                      int w, int width, int ld, int rows,
                                      float* __restrict__ dst) {
  for (int e = threadIdx.x; e < rows * width; e += kThreads) {
    const int r = e / width, c = e - r * width;
    const int gr = row0 + r;
    dst[r * ld + c] = (gr < q && c < w) ? src[(long long)gr * row_stride + c]
                                        : 0.0f;
  }
}

template <int kP>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ c, const float* __restrict__ b,
           const float* __restrict__ x, const float* __restrict__ cum,
           float* __restrict__ out, int q, int n, int p, int heads, int rep,
           Strides cs, Strides bs, Strides xs, Strides us, Strides os) {
  constexpr int ldx = kP + 4;
  constexpr int kOut = kP / 16;             // output columns per thread
  const int n4 = (n + 3) & ~3;              // N padded to a float4
  const int ldn = n4 + 4;
  extern __shared__ __align__(16) float smem[];
  float* csm = smem;                        // [kRows][ldn]
  float* bsm = csm + kRows * ldn;           // [kCols][ldn]
  float* xsm = bsm + kCols * ldn;           // [kCols][ldx]
  float* ssm = xsm + kCols * ldx;           // [kRows][kLdS]
  float* cum_i = ssm + kRows * kLdS;        // [kRows]
  float* cum_j = cum_i + kRows;             // [kCols]

  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int cell = blockIdx.x;
  const int outer = cell / heads, hd = cell - outer * heads, grp = hd / rep;
  const int i0 = blockIdx.y * kRows;

  const float* cp = c + outer * cs.o + grp * cs.g;
  const float* bp = b + outer * bs.o + grp * bs.g;
  const float* xp = x + outer * xs.o + hd * xs.g;
  const float* up = cum + outer * us.o + hd * us.g;

  stage(cp, cs.r, i0, q, n, n4, ldn, kRows, csm);
  for (int r = t; r < kRows; r += kThreads)
    cum_i[r] = i0 + r < q ? up[(long long)(i0 + r) * us.r] : 0.0f;

  float acc[4][kOut];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 0; o < kOut; ++o) acc[i][o] = 0.0f;

  const int last = min(i0 + kRows - 1, q - 1);
  for (int j0 = 0; j0 <= last; j0 += kCols) {
    __syncthreads();                        // the last block's b, x, s read
    stage(bp, bs.r, j0, q, n, n4, ldn, kCols, bsm);
    stage(xp, xs.r, j0, q, p, kP, ldx, kCols, xsm);
    for (int r = t; r < kCols; r += kThreads)
      cum_j[r] = j0 + r < q ? up[(long long)(j0 + r) * us.r] : 0.0f;
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int k = 0; k < n4; k += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&csm[(ty + 16 * i) * ldn + k]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bb[j] = *reinterpret_cast<const float4*>(&bsm[(tx + 16 * j) * ldn + k]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s_ij = sc[i][j];
          s_ij = fmaf(a[i].x, bb[j].x, s_ij);
          s_ij = fmaf(a[i].y, bb[j].y, s_ij);
          s_ij = fmaf(a[i].z, bb[j].z, s_ij);
          sc[i][j] = fmaf(a[i].w, bb[j].w, s_ij);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int li = ty + 16 * i, row = i0 + li;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lj = tx + 16 * j, col = j0 + lj;
        const float decay =
            (col <= row && col < q) ? expf(cum_i[li] - cum_j[lj]) : 0.0f;
        ssm[li * kLdS + lj] = sc[i][j] * decay;
      }
    }
    __syncthreads();                        // the scores block complete

#pragma unroll 2
    for (int kk = 0; kk < kCols; kk += 4) {
      float4 s4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s4[i] = *reinterpret_cast<const float4*>(&ssm[(ty + 16 * i) * kLdS + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float xv[kOut];
#pragma unroll
        for (int o = 0; o < kOut; ++o) xv[o] = xsm[(kk + u) * ldx + tx + 16 * o];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float si = u == 0 ? s4[i].x : u == 1 ? s4[i].y : u == 2 ? s4[i].z
                                                                         : s4[i].w;
#pragma unroll
          for (int o = 0; o < kOut; ++o) acc[i][o] = fmaf(si, xv[o], acc[i][o]);
        }
      }
    }
  }

  float* op = out + outer * os.o + hd * os.g;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty + 16 * i;
    if (row >= q) continue;
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      const int col = tx + 16 * o;
      if (col < p) op[(long long)row * os.r + col] = acc[i][o];
    }
  }
}

size_t smem_bytes(int n, int kp) {
  const int ldn = ((n + 3) & ~3) + 4;
  return sizeof(float) * ((size_t)(kRows + kCols) * ldn +
                          (size_t)kCols * (kp + 4) + kRows * kLdS + kRows +
                          kCols);
}

template <int kP>
int launch(const float* c, const float* b, const float* x, const float* cum,
           float* out, int cells, int q, int n, int p, int heads, int rep,
           Strides cs, Strides bs, Strides xs, Strides us, Strides os,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(n, kP);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<kP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cells, (q + kRows - 1) / kRows);
  ssd_kernel<kP><<<grid, kThreads, bytes, stream>>>(
      c, b, x, cum, out, q, n, p, heads, rep, cs, bs, xs, us, os);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cells = outer * heads; c and b (outer, groups, q, n) through
// (outer, group, row) strides, x and out (outer, heads, q, p) and cum
// (outer, heads, q) through (outer, head, row) strides, the last axis
// contiguous; all fp32; heads a multiple of groups; n, p <= 128.
// Returns cudaGetLastError() after the launch.
int ssd_intra_launch(const void* c, const void* b, const void* x,
                     const void* cum, void* out, int outer, int heads,
                     int groups, int q, int n, int p, long long c_so,
                     long long c_sg, long long c_sr, long long b_so,
                     long long b_sg, long long b_sr, long long x_so,
                     long long x_sh, long long x_sr, long long u_so,
                     long long u_sh, long long u_sr, long long o_so,
                     long long o_sh, long long o_sr, void* stream) {
  if (outer < 1 || groups < 1 || heads % groups != 0 || q < 1 || n < 1 ||
      n > 128 || p < 1)
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
  if (p <= 16)
    return launch<16>(cf, bf, xf, uf, of, cells, q, n, p, heads, rep, cs, bs, xs, us, os, st);
  if (p <= 32)
    return launch<32>(cf, bf, xf, uf, of, cells, q, n, p, heads, rep, cs, bs, xs, us, os, st);
  if (p <= 64)
    return launch<64>(cf, bf, xf, uf, of, cells, q, n, p, heads, rep, cs, bs, xs, us, os, st);
  if (p <= 128)
    return launch<128>(cf, bf, xf, uf, of, cells, q, n, p, heads, rep, cs, bs, xs, us, os, st);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_intra_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
