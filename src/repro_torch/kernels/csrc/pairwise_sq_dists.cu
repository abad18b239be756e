// Tiled pairwise squared distances, for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/distance.py
// (pairwise_sq_dists -> _dist_kernel). For points x (N, D) and
// centroids c (K, D), fp32 or bf16, it writes the fp32 (N, K) matrix
// max(|x|^2 - 2 x.c + |c|^2, 0), with both squared norms computed
// inside the kernel, as _dist_kernel does. Ragged N, K and D are
// handled by bounds checks (the reference pads to its tiles).
//
// Bound on the card: at uci-xlarge (N = 2^20, D = 32, K = 256) the
// 1 GiB fp32 output alone takes 0.32 ms at 3.35 TB/s, above the
// 2*N*K*D = 17.2 GFLOP of FFMA (0.26 ms at 67 TFLOP/s): the kernel is
// bound by the bytes it writes, and the FFMAs come within a fifth of
// that, so the two have to overlap. The products run in fp32 FFMA: the
// tensor cores have no IEEE fp32 mode, and TF32 changes labels; bf16
// inputs, 3% of the bytes, are widened to fp32 as they are staged.
//
// What held the first kernel (psd_simple_kernel, kept below as the
// yardstick) to 2.5x its bound, and what psd_kernel does about it:
//   - a CTA a 128 x 128 output tile staged, computed and stored in
//     turn, two CTAs an SM: its 64 KiB of stores overlapped nothing of
//     its own. psd_kernel's CTAs are persistent, two an SM, each
//     walking a run of 128-row tiles; a tile's stores, 16-byte
//     streaming stores (st.global.cs) straight from registers, drain
//     while the CTA computes the next 128 columns or the next tile.
//   - x read once per 128 centroids, with 4-byte loads. The CTA keeps
//     a slice of ks centroids (all K where they fit: at uci-xlarge all
//     256, 32 KiB) and their norms in shared memory for its whole run,
//     so x is read once per slice and the norms computed once per CTA;
//     x tiles arrive by 16-byte cp.async, as the contiguous bytes of
//     128 rows, through a ring of 3 (or 2) stages.
// Each thread keeps an 8 x 8 block of dot products in registers, rows
// {ty*4..ty*4+3, 64+ty*4..64+ty*4+3} and columns likewise with tx, as
// the first kernel does: the centroids sit transposed, [d][ks], so a
// warp's float4 reads of them are contiguous and its stores are 256
// contiguous bytes a row. x rows are read as float4s along d (two
// addresses a warp, so their stride costs no bank conflict): straight
// from the ring for fp32 with D % 4 == 0, else after a pass that widens
// the tile into a [128][D rounded up to 4] fp32 buffer.
// The launch picks (ks, stages, CTAs an SM) from (K, D, dtype) alone
// (pairwise_sq_dists_slice_cols). Two kinds of input take the first
// kernel instead, on the entry point's own route: a D whose 128-centroid
// slice does not fit beside two ring stages (D > 148 in fp32 with
// D % 4 == 0 and in bf16, D > 111 in fp32 otherwise), and an x not on
// 16 bytes (a view at an odd offset), which cp.async cannot copy.
// What still holds psd_kernel at 1.8x its bound at uci-xlarge (an H100
// 80GB HBM3 at 700 W; scripts/block_skip_probe.py, which builds copies
// with -DPSD_PROBE_NO_STORES and -DPSD_PROBE_NO_EPILOGUE): its 8 x 8
// loop runs at three quarters of the FFMA rate, and its epilogue's
// arithmetic (not its stores) costs a quarter of its time.
//
// Exactness: the norms are one fmaf(v, v, acc) chain and each dot
// product one fmaf(x, c, acc) chain over d = 0, 1, ..., from 0.0f, in
// the first kernel's order (zero columns past D add nothing: the
// chains are never -0), and both kernels form the distance with
// sq_dist, so the output is bit for bit the first kernel's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;              // points and centroids per CTA tile
constexpr int kThreads = 256;           // 16 x 16 threads, 8 x 8 each
constexpr int kHalf = kTile / 2;
constexpr int kPad = kTile + 4;         // the first kernel's row stride
constexpr int kSliceD = 16;             // the first kernel's D per step
constexpr int kMaxStages = 3;
constexpr int kBlocks = 2;              // psd_kernel's blocks an SM
constexpr int kSmemMax = 232448;        // the most shared memory one block has
constexpr int kSmemSM = 233472;         // an SM's, for all its blocks
constexpr int kReserved = 1024;         // the system's share a block

// The squared distance from a point's norm, a dot product and a
// centroid's norm: the one expression both kernels compile.
__device__ __forceinline__ float sq_dist(float xx, float acc, float c2) {
  return fmaxf(xx - 2.0f * acc + c2, 0.0f);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Bytes a ring stage holds: kTile rows of x as they lie in memory,
// from the 16 bytes that hold the tile's first byte
__host__ __device__ inline int blob_bytes(int d, int es) {
  return ((kTile * d * es + 15) & ~15) + 16;
}

// psd_kernel's shared memory, in bytes: the centroid slice [dp][ks]
// and its norms [ks] (fp32); the widened x tile [128][dp] where x is
// not read from the ring; the ring
__host__ __device__ inline long long smem_bytes(int ks, int stages, int d,
                                                int es, bool direct) {
  const long long dp = (d + 3) & ~3;
  return 4LL * (dp * ks + ks + (direct ? 0 : kTile * dp)) +
         (long long)stages * blob_bytes(d, es);
}

struct Plan {
  int ks, stages, smem;
};

// The most centroids a slice holds (a multiple of 128, at most K
// rounded up to 128), the ring's stages and the shared memory: two CTAs
// an SM and three stages where a 128-centroid slice fits so, else
// fewer; ks 0 where none fits (the first kernel takes the shape).
Plan plan(int k, int d, int es, bool direct) {
  const long long need = (k + kTile - 1) / kTile;
  const long long per = 4LL * kTile * (((d + 3) & ~3) + 1);
  // all K in one slice where it fits, else the widest slice
  const long long leasts[2] = {need, 1};
  for (long long least : leasts) {
    for (int blocks = kBlocks; blocks >= 1; blocks /= 2) {
      const long long budget =
          blocks > 1 ? kSmemSM / blocks - kReserved : (long long)kSmemMax;
      for (int stages = kMaxStages; stages >= 2; --stages) {
        const long long fixed = smem_bytes(0, stages, d, es, direct);
        const long long fit = budget >= fixed ? (budget - fixed) / per : 0;
        const long long nks = fit < need ? fit : need;
        if (nks >= least)
          return {(int)(kTile * nks), stages,
                  (int)smem_bytes((int)(kTile * nks), stages, d, es, direct)};
      }
    }
  }
  return {0, 0, 0};
}

// The 8 x 8 dot products of a thread's rows and columns over the x
// tile xt ([kTile][ldx] fp32) and 128 columns cb of the slice ([dp][ks]),
// in d order; with kNorm also its rows' squared norms.
template <bool kNorm>
__device__ __forceinline__ void products(const float* xt, int ldx,
                                         const float* cb, int ks, int dp,
                                         int tx, int ty, float (&acc)[8][8],
                                         float (&xx)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (kNorm) xx[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  for (int q = 0; q < dp / 4; ++q) {
    float4 xv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (i < 4 ? 0 : kHalf) + ty * 4 + (i & 3);
      xv[i] = *reinterpret_cast<const float4*>(xt + r * ldx + 4 * q);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* crow = cb + (4 * q + e) * ks;
      const float4 b0 = *reinterpret_cast<const float4*>(crow + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(crow + kHalf + tx * 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = lane4(xv[i], e);
        if (kNorm) xx[i] = fmaf(a, a, xx[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocks)
psd_kernel(const T* __restrict__ x, const T* __restrict__ c,
           float* __restrict__ out, int n, int k, int d, int ks, int stages,
           int n_tiles, int units, bool direct, bool vec) {
  extern __shared__ __align__(16) float smf[];
  constexpr int es = (int)sizeof(T);
  const int dp = (d + 3) & ~3;
  float* cs = smf;                               // [dp][ks]
  float* c2s = cs + dp * ks;                     // [ks]
  float* xs = c2s + ks;                          // [kTile][dp], converted
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(xs + (direct ? 0 : kTile * dp));
  const int blob = blob_bytes(d, es);
  const uint32_t ring_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const size_t xbytes = (size_t)n * d * es;
  const size_t tbytes = (size_t)kTile * d * es;
  const char* xb = reinterpret_cast<const char*>(x);
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  // the CTA's run of units (slice-major: unit u = slice * n_tiles + tile)
  const int u0 = (int)((long long)units * blockIdx.x / gridDim.x);
  const int nu = (int)((long long)units * (blockIdx.x + 1) / gridDim.x) - u0;

  // unit u0 + i's x tile into stage i % stages (x starts on 16 bytes)
  auto load = [&](int i) {
    const size_t start = (size_t)((u0 + i) % n_tiles) * tbytes;
    const size_t stop = min(start + tbytes, xbytes);
    const size_t a0 = start & ~(size_t)15;
    const uint32_t dst = ring_s + (uint32_t)((i % stages) * blob);
    for (size_t o = a0 + 16 * (size_t)t; o < stop; o += 16 * kThreads)
      cp16(dst + (uint32_t)(o - a0), xb + o,
           (int)min((size_t)16, xbytes - o));
  };

  for (int s = 0; s < stages - 1; ++s) {
    if (s < nu) load(s);
    cp_commit();
  }
  int cur = -1;                                  // the slice in cs
  for (int i = 0; i < nu; ++i) {
    const int u = u0 + i;
    const int slice = u / n_tiles, tile = u - slice * n_tiles;
    if (stages == 3)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();                  // tile i is in; unit i - 1 is done
    if (i + stages - 1 < nu) load(i + stages - 1);
    cp_commit();
    const int row0 = tile * kTile, rows = min(kTile, n - row0);
    const int col0 = slice * ks, cols = min(ks, k - col0);
    const unsigned char* blobp = ring + (i % stages) * blob;
    bool again = false;
    if (slice != cur) {               // the slice and its norms
      for (int cc = t; cc < ks; cc += kThreads) {
        const int gc = col0 + cc;
        const bool ok = gc < k;
        const T* crow = c + (size_t)(ok ? gc : 0) * d;
        float nrm = 0.0f;
        for (int dd = 0; dd < dp; ++dd) {
          const float v = ok && dd < d ? widen(crow[dd]) : 0.0f;
          cs[dd * ks + cc] = v;
          nrm = fmaf(v, v, nrm);
        }
        c2s[cc] = nrm;
      }
      cur = slice;
      again = true;
    }
    if (!direct) {                    // widen the tile into xs
      const T* src = reinterpret_cast<const T*>(
          blobp + (((size_t)tile * tbytes) & 15));
      if ((d * es) % 16 == 0) {       // 16 bytes at a time (dp == d)
        constexpr int v = 16 / es;
        const int per_row = d / v;
        for (int e = t; e < kTile * per_row; e += kThreads) {
          const int r = e / per_row, q = e - r * per_row;
          float w[v];
          if (r < rows) {
            const uint4 raw =
                *reinterpret_cast<const uint4*>(src + (size_t)r * d + q * v);
            const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int z = 0; z < v; ++z) w[z] = widen(vals[z]);
          } else {
#pragma unroll
            for (int z = 0; z < v; ++z) w[z] = 0.0f;
          }
#pragma unroll
          for (int z = 0; z < v; z += 4)
            *reinterpret_cast<float4*>(xs + r * dp + q * v + z) =
                make_float4(w[z], w[z + 1], w[z + 2], w[z + 3]);
        }
      } else {
        for (int e = t; e < kTile * dp; e += kThreads) {
          const int r = e / dp, cc = e - r * dp;
          xs[e] = r < rows && cc < d ? widen(src[(size_t)r * d + cc]) : 0.0f;
        }
      }
      again = true;
    }
    if (again) __syncthreads();
    const float* xt =
        direct ? reinterpret_cast<const float*>(blobp) : xs;
    const int ldx = direct ? d : dp;

    float xx[8];
    for (int cb = 0; cb * kTile < cols; ++cb) {
      float acc[8][8];
      if (cb == 0)
        products<true>(xt, ldx, cs, ks, dp, tx, ty, acc, xx);
      else
        products<false>(xt, ldx, cs + cb * kTile, ks, dp, tx, ty, acc, xx);
#ifdef PSD_PROBE_NO_EPILOGUE       // the probe's cut copy: wrong output
      {
        float sum = 0.0f;
        for (int i = 0; i < 8; ++i)
          for (int j = 0; j < 8; ++j) sum += acc[i][j];
        if (sum == 1.5f) out[0] = sum;
      }
      if (cols > 0) continue;
#endif
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int lr = (i < 4 ? 0 : kHalf) + ty * 4 + (i & 3);
        if (lr >= rows) continue;
        float* orow = out + (size_t)(row0 + lr) * k + col0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lc = cb * kTile + h * kHalf + tx * 4;
          if (lc >= cols) continue;
          const float4 n2 = *reinterpret_cast<const float4*>(c2s + lc);
          const float v0 = sq_dist(xx[i], acc[i][h * 4 + 0], n2.x);
          const float v1 = sq_dist(xx[i], acc[i][h * 4 + 1], n2.y);
          const float v2 = sq_dist(xx[i], acc[i][h * 4 + 2], n2.z);
          const float v3 = sq_dist(xx[i], acc[i][h * 4 + 3], n2.w);
#ifdef PSD_PROBE_NO_STORES         // the probe's cut copy: wrong output
          if (v0 + v1 + v2 + v3 == 1.5f) __stcs(orow + lc, v0);
          continue;
#endif
          if (vec && lc + 3 < cols) {
            __stcs(reinterpret_cast<float4*>(orow + lc),
                   make_float4(v0, v1, v2, v3));
          } else {
            __stcs(orow + lc, v0);
            if (lc + 1 < cols) __stcs(orow + lc + 1, v1);
            if (lc + 2 < cols) __stcs(orow + lc + 2, v2);
            if (lc + 3 < cols) __stcs(orow + lc + 3, v3);
          }
        }
      }
    }
  }
  cp_wait<0>();
}

// ---------------------------------------------------------------------
// The port's first kernel, kept as the yardstick that psd_kernel is
// held to bit for bit and timed against, and launched by the entry
// point for the inputs psd_kernel does not take (a wide D, an x not on
// 16 bytes; see above). One CTA of 256 threads per 128 x 128 output
// tile. The CTA stages 16-wide slices of D of its 128 points and its
// 128 centroids in shared memory, transposed ([d][row], rows padded to
// 132 so that the transposing stores conflict 2-way at most and every
// row stays 16-byte aligned), and each thread keeps an 8 x 8 block of
// dot products in registers: rows {ty*4..ty*4+3, 64+ty*4..64+ty*4+3},
// columns likewise with tx, so that both the float4 shared-memory
// reads and the float4 global stores of a warp are contiguous. bf16
// inputs are widened to fp32 as they are staged. The norms come from
// the same staged slices: thread t < 128 sums row t, thread t >= 128
// centroid t - 128.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int rows,
                                      int row0, int d, int d0,
                                      float (*dst)[kPad]) {
  // kTile rows x kSliceD columns; 16 neighbouring threads read one
  // row's 16 contiguous values
  for (int e = threadIdx.x; e < kTile * kSliceD; e += kThreads) {
    const int r = e / kSliceD, col = e - r * kSliceD;
    const int gr = row0 + r, gd = d0 + col;
    dst[col][r] = (gr < rows && gd < d) ? widen(src[(size_t)gr * d + gd])
                                        : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
psd_simple_kernel(const T* __restrict__ x, const T* __restrict__ c,
                  float* __restrict__ out, int n, int k, int d) {
  __shared__ __align__(16) float xs[kSliceD][kPad];
  __shared__ __align__(16) float cs[kSliceD][kPad];
  __shared__ float x2s[kTile];
  __shared__ float c2s[kTile];

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int row0 = blockIdx.x * kTile;
  const int col0 = blockIdx.y * kTile;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float norm = 0.0f;

  for (int d0 = 0; d0 < d; d0 += kSliceD) {
    stage(x, n, row0, d, d0, xs);
    stage(c, k, col0, d, d0, cs);
    __syncthreads();
    {
      const float(*src)[kPad] = t < kTile ? xs : cs;
      const int r = t < kTile ? t : t - kTile;
#pragma unroll
      for (int j = 0; j < kSliceD; ++j) norm = fmaf(src[j][r], src[j][r], norm);
    }
#pragma unroll
    for (int j = 0; j < kSliceD; ++j) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[j][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[j][kHalf + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&cs[j][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&cs[j][kHalf + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
    }
    __syncthreads();                      // the slices are free again
  }
  if (t < kTile)
    x2s[t] = norm;
  else
    c2s[t - kTile] = norm;
  __syncthreads();

  const bool vec = (k % 4) == 0;          // rows of out 16-byte aligned
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lr = (i < 4 ? 0 : kHalf) + ty * 4 + (i & 3);
    const int row = row0 + lr;
    if (row >= n) continue;
    const float xx = x2s[lr];
    float* orow = out + (size_t)row * k;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lc = h * kHalf + tx * 4;
      const int col = col0 + lc;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = sq_dist(xx, acc[i][h * 4 + q], c2s[lc + q]);
      if (vec && col + 3 < k) {
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < k) orow[col + q] = v[q];
      }
    }
  }
}

template <typename T>
int launch_simple(const T* x, const T* c, float* out, int n, int k, int d,
                  cudaStream_t s) {
  const dim3 grid((n + kTile - 1) / kTile, (k + kTile - 1) / kTile);
  psd_simple_kernel<T><<<grid, kThreads, 0, s>>>(x, c, out, n, k, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* x, const T* c, float* out, int n, int k, int d,
           cudaStream_t s) {
  const bool direct = sizeof(T) == 4 && d % 4 == 0;
  const Plan p = d >= 1 && (reinterpret_cast<uintptr_t>(x) & 15) == 0
                     ? plan(k, d, (int)sizeof(T), direct)
                     : Plan{0, 0, 0};
  if (p.ks == 0) return launch_simple<T>(x, c, out, n, k, d, s);
  cudaError_t e = cudaFuncSetAttribute(
      psd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, psd_kernel<T>,
                                                    kThreads, p.smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const long long n_tiles = (n + kTile - 1) / kTile;
  const long long units = n_tiles * ((k + p.ks - 1) / p.ks);
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long grid = units < (long long)per_sm * sms
                             ? units : (long long)per_sm * sms;
  const bool vec = k % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  psd_kernel<T><<<(int)grid, kThreads, p.smem, s>>>(
      x, c, out, n, k, d, p.ks, p.stages, (int)n_tiles, (int)units, direct,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The centroids a slice of psd_kernel holds at (k, d, dtype) for an x
// on 16 bytes: a multiple of 128, or 0 where the launch takes the first
// kernel (dtype 0 fp32, 1 bf16; -1 for another dtype).
int pairwise_sq_dists_slice_cols(int k, int d, int dtype) {
  if (dtype != 0 && dtype != 1) return -1;
  const int es = dtype == 0 ? 4 : 2;
  return plan(k, d, es, dtype == 0 && d % 4 == 0).ks;
}

// x (n, d), c (k, d), both fp32 (dtype 0) or both bf16 (dtype 1);
// out (n, k) fp32. Launches psd_kernel, or the first kernel where
// pairwise_sq_dists_slice_cols is 0 or x is not on 16 bytes. Returns
// cudaGetLastError() after the launch.
int pairwise_sq_dists_launch(const void* x, const void* c, void* out, int n,
                             int k, int d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch(static_cast<const float*>(x), static_cast<const float*>(c),
                  static_cast<float*>(out), n, k, d, s);
  if (dtype == 1)
    return launch(static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(c),
                  static_cast<float*>(out), n, k, d, s);
  return (int)cudaErrorInvalidValue;
}

// The first kernel, with the same arguments: the yardstick.
int pairwise_sq_dists_simple_launch(const void* x, const void* c, void* out,
                                    int n, int k, int d, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_simple(static_cast<const float*>(x),
                         static_cast<const float*>(c),
                         static_cast<float*>(out), n, k, d, s);
  if (dtype == 1)
    return launch_simple(static_cast<const __nv_bfloat16*>(x),
                         static_cast<const __nv_bfloat16*>(c),
                         static_cast<float*>(out), n, k, d, s);
  return (int)cudaErrorInvalidValue;
}

const char* pairwise_sq_dists_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
