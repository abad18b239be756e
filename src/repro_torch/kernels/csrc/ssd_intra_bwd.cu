// Backward of the fused SSD intra-chunk pass (Mamba-2), for sm_90a.
//
// Replaces no TPU kernel: the Pallas kernel repro/kernels/ssd_intra.py
// (ssd_intra -> _ssd_intra_kernel) has no backward, and the reference
// trains through plain jnp. The port's training path runs the forward
// kernel (csrc/ssd_intra.cu), so its gradient is this kernel, launched
// from the autograd Function in ssd_intra.py.
//
// A cell is one (batch x chunk, head); head h reads the C and B of group
// h / rep. With, for j <= i (zero above the diagonal),
//
//     L_ij = exp(cum_i - cum_j)     M_ij = (c_i . b_j) L_ij
//     y_i  = sum_j M_ij x_j         dS_ij = dy_i . x_j
//
// the gradients are
//
//     dx   = M^T dy
//     dC   = (dS o L) B              dB = (dS o L)^T C
//     dcum_i = sum_j (dS o M)_ij - sum_k (dS o M)_ki
//
// dB and dC sum over the heads of a group; at hymba-1.5b one group holds
// all 25 heads, and a block a (cell, group) would give 32 blocks for 132
// SMs. So two kernels:
//   1. ssd_bwd_cell, a block a cell: walks the causal triangle in 32 x 32
//      tiles, column tile by column tile, and for each over the row tiles
//      on or below it. A column tile's dx, dB and column sums sit in
//      shared memory until its walk ends; the whole cell's dC and row
//      sums sit there until the cell ends. It writes dx and dcum, and its
//      head's dC and dB to fp32 scratch (outer, heads, q, n).
//   2. ssd_bwd_reduce, a thread an element of dC and dB: sums the
//      group's heads in order.
// Every output element is summed by one thread in a fixed order: no
// atomics, and two calls give the same bits. All fp32 FFMA, as in the
// forward. Above the diagonal and past q, L is selected to 0, never
// multiplied (exp of a positive number may be inf there).
//
// Bound on the card: at hymba-1.5b's training step (b 2, s 2048, Q 128,
// N 16, P 128, 25 heads: 800 cells) the causal halves of dS (Q x Q x P),
// dx (Q x Q x P), M, dC and dB (Q x Q x N each) are 4.0e9 flops (0.060 ms
// at the fp32 FFMA peak) against 159 MB of C, B, x, cum and dy in and
// dC, dB, dx, dcum out (0.047 ms at 3.35 TB/s): about balanced. This
// first version forms each product one output element a thread from
// shared memory (two loads an FFMA), so shared memory, not the FFMA
// units, bounds it.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kJ = 32;          // rows and columns of a tile
constexpr int kThreads = 256;

struct Shape {
  int heads, groups, rep, q, n, p;
};

// floats of shared memory ssd_bwd_cell takes
size_t cell_floats(int q, int n, int p) {
  return (size_t)q * n + 2 * q                    // dC, row sums, col sums
         + 2 * kJ * (p + 1) + 2 * kJ * (n + 1)    // x, dy, B, C tiles
         + 2 * kJ                                 // cum of both
         + 3 * kJ * (kJ + 1)                      // W, M, dS o M
         + (size_t)kJ * p + (size_t)kJ * n + kJ;  // dx, dB, col sums
}

// rows [r0, r0 + kJ) of a (rows, width) slice at row stride rs into a
// kJ x (width + 1) tile; zero past q
__device__ __forceinline__ void load(float* tile, const float* base, int r0,
                                     int q, int width, long long rs) {
  for (int e = threadIdx.x; e < kJ * width; e += kThreads) {
    const int r = e / width, c = e % width;
    tile[r * (width + 1) + c] =
        r0 + r < q ? base[(long long)(r0 + r) * rs + c] : 0.f;
  }
}

// C, B (outer, q, groups, n); x, dy, dx (outer, q, heads, p); cum, dcum
// (outer, q, heads); pc, pb (outer, heads, q, n): all contiguous, fp32
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_cell(const float* __restrict__ C, const float* __restrict__ B,
                 const float* __restrict__ x, const float* __restrict__ cum,
                 const float* __restrict__ dy, float* __restrict__ dx,
                 float* __restrict__ dcum, float* __restrict__ pc,
                 float* __restrict__ pb, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  const int q = sh.q, n = sh.n, p = sh.p;
  float* dc_acc = smem;                       // (q, n)
  float* rsum = dc_acc + (size_t)q * n;       // (q,)
  float* csum = rsum + q;                     // (q,)
  float* xt = csum + q;                       // x_j   kJ x (p + 1)
  float* yt = xt + kJ * (p + 1);              // dy_i  kJ x (p + 1)
  float* bt = yt + kJ * (p + 1);              // B_j   kJ x (n + 1)
  float* ct = bt + kJ * (n + 1);              // C_i   kJ x (n + 1)
  float* uj = ct + kJ * (n + 1);              // cum_j
  float* ui = uj + kJ;                        // cum_i
  float* wt = ui + kJ;                        // dS o L     kJ x (kJ + 1)
  float* mt = wt + kJ * (kJ + 1);             // M
  float* zt = mt + kJ * (kJ + 1);             // dS o M
  float* dx_acc = zt + kJ * (kJ + 1);         // (kJ, p)
  float* db_acc = dx_acc + kJ * p;            // (kJ, n)
  float* cs_acc = db_acc + kJ * n;            // (kJ,)

  const int cell = blockIdx.x;
  const int outer = cell / sh.heads, hd = cell % sh.heads, g = hd / sh.rep;
  const long long cgs = (long long)sh.groups * n;     // row stride of C, B
  const long long xhs = (long long)sh.heads * p;      // of x, dy, dx
  const float* cb = C + (long long)outer * q * cgs + (long long)g * n;
  const float* bb = B + (long long)outer * q * cgs + (long long)g * n;
  const long long xo = (long long)outer * q * xhs + (long long)hd * p;
  const float* ub = cum + (long long)outer * q * sh.heads + hd;
  const int tid = threadIdx.x, nb = (q + kJ - 1) / kJ;

  for (int e = tid; e < q * n; e += kThreads) dc_acc[e] = 0.f;
  for (int e = tid; e < q; e += kThreads) rsum[e] = 0.f;

  for (int jb = 0; jb < nb; ++jb) {
    const int j0 = jb * kJ;
    __syncthreads();
    load(xt, x + xo, j0, q, p, xhs);
    load(bt, bb, j0, q, n, cgs);
    for (int e = tid; e < kJ; e += kThreads)
      uj[e] = j0 + e < q ? ub[(long long)(j0 + e) * sh.heads] : 0.f;
    for (int e = tid; e < kJ * p; e += kThreads) dx_acc[e] = 0.f;
    for (int e = tid; e < kJ * n; e += kThreads) db_acc[e] = 0.f;
    for (int e = tid; e < kJ; e += kThreads) cs_acc[e] = 0.f;
    for (int ib = jb; ib < nb; ++ib) {
      const int i0 = ib * kJ;
      __syncthreads();
      load(yt, dy + xo, i0, q, p, xhs);
      load(ct, cb, i0, q, n, cgs);
      for (int e = tid; e < kJ; e += kThreads)
        ui[e] = i0 + e < q ? ub[(long long)(i0 + e) * sh.heads] : 0.f;
      __syncthreads();
      // the tile's W = dS o L, M = G o L and dS o M; row r is i0 + r,
      // column c is j0 + c
      for (int e = tid; e < kJ * kJ; e += kThreads) {
        const int r = e / kJ, c = e % kJ;
        const int i = i0 + r, j = j0 + c;
        float w = 0.f, m = 0.f, z = 0.f;
        if (i < q && j <= i) {
          float gsc = 0.f, ds = 0.f;
          for (int k = 0; k < n; ++k)
            gsc = fmaf(ct[r * (n + 1) + k], bt[c * (n + 1) + k], gsc);
          for (int k = 0; k < p; ++k)
            ds = fmaf(yt[r * (p + 1) + k], xt[c * (p + 1) + k], ds);
          const float l = expf(ui[r] - uj[c]);
          w = ds * l;
          m = gsc * l;
          z = ds * m;
        }
        wt[r * (kJ + 1) + c] = w;
        mt[r * (kJ + 1) + c] = m;
        zt[r * (kJ + 1) + c] = z;
      }
      __syncthreads();
      // dx_j += M^T dy_i
      for (int e = tid; e < kJ * p; e += kThreads) {
        const int c = e / p, k = e % p;
        float acc = dx_acc[e];
        for (int r = 0; r < kJ; ++r)
          acc = fmaf(mt[r * (kJ + 1) + c], yt[r * (p + 1) + k], acc);
        dx_acc[e] = acc;
      }
      // dB_j += W^T C_i
      for (int e = tid; e < kJ * n; e += kThreads) {
        const int c = e / n, k = e % n;
        float acc = db_acc[e];
        for (int r = 0; r < kJ; ++r)
          acc = fmaf(wt[r * (kJ + 1) + c], ct[r * (n + 1) + k], acc);
        db_acc[e] = acc;
      }
      // dC_i += W B_j
      for (int e = tid; e < kJ * n; e += kThreads) {
        const int r = e / n, k = e % n;
        if (i0 + r >= q) continue;
        float acc = dc_acc[(i0 + r) * n + k];
        for (int c = 0; c < kJ; ++c)
          acc = fmaf(wt[r * (kJ + 1) + c], bt[c * (n + 1) + k], acc);
        dc_acc[(i0 + r) * n + k] = acc;
      }
      // row and column sums of dS o M
      for (int e = tid; e < 2 * kJ; e += kThreads) {
        if (e < kJ) {
          if (i0 + e >= q) continue;
          float acc = rsum[i0 + e];
          for (int c = 0; c < kJ; ++c) acc += zt[e * (kJ + 1) + c];
          rsum[i0 + e] = acc;
        } else {
          const int c = e - kJ;
          float acc = cs_acc[c];
          for (int r = 0; r < kJ; ++r) acc += zt[r * (kJ + 1) + c];
          cs_acc[c] = acc;
        }
      }
    }
    __syncthreads();
    // the column tile is done: dx, this head's dB, the column sums
    for (int e = tid; e < kJ * p; e += kThreads) {
      const int c = e / p, k = e % p;
      if (j0 + c < q) dx[xo + (long long)(j0 + c) * xhs + k] = dx_acc[e];
    }
    float* pbh = pb + ((long long)outer * sh.heads + hd) * q * n;
    for (int e = tid; e < kJ * n; e += kThreads) {
      const int c = e / n;
      if (j0 + c < q) pbh[(long long)j0 * n + e] = db_acc[e];
    }
    for (int e = tid; e < kJ; e += kThreads)
      if (j0 + e < q) csum[j0 + e] = cs_acc[e];
  }
  __syncthreads();
  float* pch = pc + ((long long)outer * sh.heads + hd) * q * n;
  for (int e = tid; e < q * n; e += kThreads) pch[e] = dc_acc[e];
  float* du = dcum + (long long)outer * q * sh.heads + hd;
  for (int e = tid; e < q; e += kThreads)
    du[(long long)e * sh.heads] = rsum[e] - csum[e];
}

// dC and dB (outer, q, groups, n): each element the sum, over the rep
// heads of its group in order, of the heads' partials
__global__ void ssd_bwd_reduce(const float* __restrict__ pc,
                               const float* __restrict__ pb,
                               float* __restrict__ dC, float* __restrict__ dB,
                               long long total, Shape sh) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int k = (int)(e % sh.n);
  const int g = (int)((e / sh.n) % sh.groups);
  const int i = (int)((e / ((long long)sh.n * sh.groups)) % sh.q);
  const long long outer = e / ((long long)sh.n * sh.groups * sh.q);
  float sc = 0.f, sb = 0.f;
  for (int t = 0; t < sh.rep; ++t) {
    const long long at =
        ((outer * sh.heads + g * sh.rep + t) * sh.q + i) * sh.n + k;
    sc += pc[at];
    sb += pb[at];
  }
  dC[e] = sc;
  dB[e] = sb;
}

}  // namespace

extern "C" {

// C, B (outer, q, groups, n); x, dy, dx (outer, q, heads, p); cum, dcum
// (outer, q, heads); dC, dB like C; pc, pb (outer, heads, q, n) scratch.
// All contiguous fp32; heads a multiple of groups; n, p <= 128. Returns
// cudaErrorInvalidValue for a shape it cannot take (or one whose cell
// does not fit in shared memory), else cudaGetLastError() after the two
// launches.
int ssd_intra_bwd_launch(const void* C, const void* B, const void* x,
                         const void* cum, const void* dy, void* dC, void* dB,
                         void* dx, void* dcum, void* pc, void* pb, int outer,
                         int heads, int groups, int q, int n, int p,
                         void* stream) {
  if (outer < 1 || groups < 1 || heads % groups != 0 || q < 1 || n < 1 ||
      n > 128 || p < 1 || p > 128)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * cell_floats(q, n, p);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  const Shape sh{heads, groups, heads / groups, q, n, p};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_cell, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_cell<<<outer * heads, kThreads, bytes, st>>>(
      static_cast<const float*>(C), static_cast<const float*>(B),
      static_cast<const float*>(x), static_cast<const float*>(cum),
      static_cast<const float*>(dy), static_cast<float*>(dx),
      static_cast<float*>(dcum), static_cast<float*>(pc),
      static_cast<float*>(pb), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)outer * q * groups * n;
  const int blocks = (int)((total + 255) / 256);
  ssd_bwd_reduce<<<blocks, 256, 0, st>>>(
      static_cast<const float*>(pc), static_cast<const float*>(pb),
      static_cast<float*>(dC), static_cast<float*>(dB), total, sh);
  return (int)cudaGetLastError();
}

const char* ssd_intra_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
