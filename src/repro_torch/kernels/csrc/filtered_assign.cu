// Block-skip nearest-centroid search over (tile_n x tile_k) blocks,
// for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/filtered_assign.py
// (filtered_assign -> _filtered_assign_kernel). For every point x and
// every centroid block j that is live in the (ceil(N/tile_n),
// ceil(K/tile_k)) mask of the point's tile, it computes the squared
// distances max(x2 - 2 x.c + c2, 0) to the block's centroids, with the
// norms x2 (N,) and c2 (K,) as given, and returns the global min and
// its centroid id over the live blocks. A row with no live block gets
// (inf, -1). Ragged N and K are handled by bounds checks; the
// reference's pad centroids (1e15 rows, norms 1e30*d) exist only so
// that they never win, which the checks give as well.
//
// Ties: the CTA walks the live blocks in ascending order and each
// block's centroids in ascending order, and replaces its running min
// only on a strict <. That is the reference's rule: the first index
// within a block (argmin) and the earlier block across blocks
// (`local_min < best`).
//
// Design (simple first): one CTA per tile of tile_n points, one thread
// per point, the running (min, argmin) in registers. The CTA reads its
// row of the mask, entry by entry; a dead block costs that one read,
// and a tile with no live block never loads its points. The tile's
// points sit in shared memory transposed, [d][tile_n + 1] (the +1
// keeps the transposing store free of bank conflicts). A live block's
// centroids are streamed through shared memory S at a time
// (S = 8, 16 or 32, the largest not above tile_k), stored [d][S + 4]
// so that each thread reads four centroids' values of one column with
// one float4 load; each thread keeps S dot products in registers and
// runs them in fp32 FFMA (TF32 would change labels).
//
// Bound on the card: at uci-highk (N = 262,144, D = 32, K = 1024) with
// every block live, 2*N*K*D = 17.2 GFLOP of FFMA, 0.26 ms at
// 67 TFLOP/s; its bytes (x once, 32 MiB, and 2 MiB of outputs) take
// 0.01 ms. The kernel is bound by the FFMA throughput; in this first
// version every FFMA also needs a quarter of a shared-memory load.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

template <int S>
__global__ void fa_kernel(const float* __restrict__ x,
                          const float* __restrict__ x2,
                          const float* __restrict__ c,
                          const float* __restrict__ c2,
                          const unsigned char* __restrict__ mask,
                          float* __restrict__ best_out,
                          int* __restrict__ idx_out, int n, int k, int d,
                          int gk, int tile_k) {
  extern __shared__ __align__(16) float smem[];
  constexpr int cs_stride = S + 4;
  const int tile_n = blockDim.x;
  const int xs_stride = tile_n + 1;
  float* cs = smem;                                // [d][S + 4]
  float* c2s = cs + (size_t)d * cs_stride;         // [S]
  float* xs = c2s + S;                             // [d][tile_n + 1]

  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const size_t row0 = (size_t)tile * tile_n;
  const size_t row = row0 + t;
  const bool valid = row < (size_t)n;
  const unsigned char* mrow = mask + (size_t)tile * gk;

  const float xx = valid ? x2[row] : 0.0f;
  float best = CUDART_INF_F;
  int best_id = -1;
  bool loaded = false;

  for (int b = 0; b < gk; ++b) {
    if (!mrow[b]) continue;                        // dead block
    if (!loaded) {                                 // the tile's points,
      const int tile_elems = tile_n * d;           // pad rows = 0
      for (int e = t; e < tile_elems; e += tile_n) {
        const int r = e / d, col = e - r * d;
        const size_t gr = row0 + r;
        xs[col * xs_stride + r] = gr < (size_t)n ? x[gr * d + col] : 0.0f;
      }
      loaded = true;                               // visible after the
    }                                              // next barrier
    const int kb_end = min((b + 1) * tile_k, k);
    for (int s0 = b * tile_k; s0 < kb_end; s0 += S) {
      const int ns = min(S, kb_end - s0);
      __syncthreads();                             // cs is free again
      for (int e = t; e < S * d; e += tile_n) {
        const int j = e / d, col = e - j * d;
        cs[col * cs_stride + j] =
            j < ns ? c[(size_t)(s0 + j) * d + col] : 0.0f;
      }
      for (int j = t; j < S; j += tile_n)          // tile_n may be < S
        c2s[j] = j < ns ? c2[s0 + j] : 0.0f;
      __syncthreads();

      float acc[S];
#pragma unroll
      for (int j = 0; j < S; ++j) acc[j] = 0.0f;
      for (int col = 0; col < d; ++col) {
        const float xv = xs[col * xs_stride + t];
        const float4* cv =
            reinterpret_cast<const float4*>(cs + col * cs_stride);
#pragma unroll
        for (int q = 0; q < S / 4; ++q) {
          const float4 v = cv[q];
          acc[4 * q + 0] = fmaf(xv, v.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(xv, v.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(xv, v.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(xv, v.w, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (j < ns) {
          const float dd = fmaxf(xx - 2.0f * acc[j] + c2s[j], 0.0f);
          if (dd < best) {
            best = dd;
            best_id = s0 + j;
          }
        }
      }
    }
  }
  if (valid) {
    best_out[row] = best;
    idx_out[row] = best_id;
  }
}

template <int S>
int smem_bytes(int d, int tile_n) {
  return (int)sizeof(float) * (d * (S + 4) + S + d * (tile_n + 1));
}

template <int S>
int launch(const float* x, const float* x2, const float* c, const float* c2,
           const unsigned char* mask, float* best, int* idx, int n, int k,
           int d, int tile_n, int tile_k, cudaStream_t stream) {
  const int smem = smem_bytes<S>(d, tile_n);
  cudaError_t e = cudaFuncSetAttribute(
      fa_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n + tile_n - 1) / tile_n;
  const int gk = (k + tile_k - 1) / tile_k;
  fa_kernel<S><<<tiles, tile_n, smem, stream>>>(x, x2, c, c2, mask, best,
                                                idx, n, k, d, gk, tile_k);
  return (int)cudaGetLastError();
}

// centroids staged per shared-memory chunk for this tile_k
int slots_for(int tile_k) {
  return tile_k >= 32 ? 32 : (tile_k >= 16 ? 16 : 8);
}

}  // namespace

extern "C" {

// x (n, d) f32; x2 (n,) f32; c (k, d) f32; c2 (k,) f32;
// mask (ceil(n/tile_n), ceil(k/tile_k)) u8. Outputs: best (n,) f32,
// idx (n,) i32.
int filtered_assign_launch(const void* x, const void* x2, const void* c,
                           const void* c2, const void* mask, void* best,
                           void* idx, int n, int k, int d, int tile_n,
                           int tile_k, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* x2f = static_cast<const float*>(x2);
  const auto* cf = static_cast<const float*>(c);
  const auto* c2f = static_cast<const float*>(c2);
  const auto* m = static_cast<const unsigned char*>(mask);
  auto* bf = static_cast<float*>(best);
  auto* ii = static_cast<int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (slots_for(tile_k)) {
    case 32:
      return launch<32>(xf, x2f, cf, c2f, m, bf, ii, n, k, d, tile_n, tile_k,
                        s);
    case 16:
      return launch<16>(xf, x2f, cf, c2f, m, bf, ii, n, k, d, tile_n, tile_k,
                        s);
    default:
      return launch<8>(xf, x2f, cf, c2f, m, bf, ii, n, k, d, tile_n, tile_k,
                       s);
  }
}

const char* filtered_assign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
