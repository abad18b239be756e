// Group-granular block-skip nearest-centroid search, for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/grouped_assign.py
// (grouped_assign -> _grouped_assign_kernel). For every point x and
// every group g whose (point tile, g) block is live in the mask it
// computes the squared distances max(|x|^2 - 2 x.c + |c|^2, 0) to the
// group's centroids and returns, per (point, group), the min, the id
// of the argmin and the second min, and per point the global best and
// its id. A dead block costs one mask read and the (inf, -1, inf)
// writes. Padded slots (id -1) count as +inf.
//
// Ties: within a group the first slot wins (slots are in ascending
// centroid id); across groups the comparison is a strict <, so the
// earlier group wins -- as the Pallas kernel does.
//
// Design (simple first): one CTA per tile of tile_n points, one thread
// per point. The tile's points sit in shared memory transposed,
// [d][tile_n + 1] (the +1 keeps the transposing store free of bank
// conflicts). The CTA loops over the G groups with each thread's
// running best in registers, and streams a live group's slots through
// shared memory 32 at a time, so a group of any size fits (Hamerly,
// one group of K = 1024 at D = 128, is 512 KB). Each thread keeps 32
// dot products in registers and runs them in fp32 FFMA: the tensor
// cores have no IEEE fp32 mode, and TF32 would change labels.
//
// Bound on the card: at uci-xlarge (N = 2^20, D = 32, K = 256, G = 25)
// with every block live, 2*N*K*D = 17.2 GFLOP of FFMA (0.26 ms at
// 67 TFLOP/s), and the three (N, G) outputs alone are 315 MB (0.09 ms
// at 3.35 TB/s). That output floor is paid at any mask density; this
// first kernel writes the (N, G) outputs with a stride of G per thread.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kSlots = 32;   // centroid slots per shared-memory chunk

__global__ void ga_kernel(const float* __restrict__ x,
                          const float* __restrict__ x2,
                          const float* __restrict__ cg,
                          const float* __restrict__ c2g,
                          const int* __restrict__ ids,
                          const unsigned char* __restrict__ mask,
                          float* __restrict__ best_out,
                          int* __restrict__ idx_out,
                          float* __restrict__ gmin_out,
                          int* __restrict__ garg_out,
                          float* __restrict__ gmin2_out,
                          int n, int d, int g, int lmax) {
  extern __shared__ float smem[];
  const int tile_n = blockDim.x;
  const int xs_stride = tile_n + 1;
  float* xs = smem;                              // [d][tile_n + 1]
  float* cs = xs + (size_t)d * xs_stride;        // [kSlots][d]
  float* c2s = cs + kSlots * d;                  // [kSlots]
  int* ids_s = reinterpret_cast<int*>(c2s + kSlots);  // [kSlots]

  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const size_t row0 = (size_t)tile * tile_n;
  const size_t row = row0 + t;
  const bool valid = row < (size_t)n;

  // the tile's points, transposed into shared memory (pad rows = 0)
  const int tile_elems = tile_n * d;
  for (int e = t; e < tile_elems; e += tile_n) {
    const int r = e / d, col = e - r * d;
    const size_t gr = row0 + r;
    xs[col * xs_stride + r] = gr < (size_t)n ? x[gr * d + col] : 0.0f;
  }
  const float xx = valid ? x2[row] : 0.0f;
  float best = CUDART_INF_F;
  int best_id = -1;
  __syncthreads();

  for (int gi = 0; gi < g; ++gi) {
    const size_t out = row * g + gi;
    if (!mask[(size_t)tile * g + gi]) {            // dead block
      if (valid) {
        gmin_out[out] = CUDART_INF_F;
        garg_out[out] = -1;
        gmin2_out[out] = CUDART_INF_F;
      }
      continue;
    }
    float m1 = CUDART_INF_F, m2 = CUDART_INF_F;
    int a1 = -1;
    for (int s0 = 0; s0 < lmax; s0 += kSlots) {
      const int ns = min(kSlots, lmax - s0);
      __syncthreads();                             // cs is free again
      const float* src = cg + ((size_t)gi * lmax + s0) * d;
      for (int e = t; e < kSlots * d; e += tile_n)
        cs[e] = e < ns * d ? src[e] : 0.0f;
      if (t < kSlots) {
        c2s[t] = t < ns ? c2g[(size_t)gi * lmax + s0 + t] : 0.0f;
        ids_s[t] = t < ns ? ids[(size_t)gi * lmax + s0 + t] : -1;
      }
      __syncthreads();

      float acc[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) acc[j] = 0.0f;
      for (int col = 0; col < d; ++col) {
        const float xv = xs[col * xs_stride + t];
#pragma unroll
        for (int j = 0; j < kSlots; ++j)
          acc[j] = fmaf(xv, cs[j * d + col], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int id = ids_s[j];
        const float dd = id >= 0
            ? fmaxf(xx - 2.0f * acc[j] + c2s[j], 0.0f) : CUDART_INF_F;
        if (dd < m1) {
          m2 = m1;
          m1 = dd;
          a1 = id;
        } else if (dd < m2) {
          m2 = dd;
        }
      }
    }
    if (valid) {
      gmin_out[out] = m1;
      garg_out[out] = a1;
      gmin2_out[out] = m2;
    }
    if (m1 < best) {
      best = m1;
      best_id = a1;
    }
  }
  if (valid) {
    best_out[row] = best;
    idx_out[row] = best_id;
  }
}

}  // namespace

extern "C" {

int grouped_assign_smem_bytes(int d, int tile_n) {
  return (int)sizeof(float) * (d * (tile_n + 1) + kSlots * d + 2 * kSlots);
}

// x (n, d) f32; x2 (n,) f32; cg (g, lmax, d) f32; c2g (g, lmax) f32;
// ids (g, lmax) i32 (-1 = pad); mask (ceil(n/tile_n), g) u8.
// Outputs: best (n,) f32, idx (n,) i32, gmin/garg/gmin2 (n, g).
int grouped_assign_launch(const void* x, const void* x2, const void* cg,
                          const void* c2g, const void* ids,
                          const void* mask, void* best, void* idx,
                          void* gmin, void* garg, void* gmin2, int n, int d,
                          int g, int lmax, int tile_n, void* stream) {
  const int smem = grouped_assign_smem_bytes(d, tile_n);
  cudaError_t e = cudaFuncSetAttribute(
      ga_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n + tile_n - 1) / tile_n;
  ga_kernel<<<tiles, tile_n, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(x2),
      static_cast<const float*>(cg), static_cast<const float*>(c2g),
      static_cast<const int*>(ids), static_cast<const unsigned char*>(mask),
      static_cast<float*>(best), static_cast<int*>(idx),
      static_cast<float*>(gmin), static_cast<int*>(garg),
      static_cast<float*>(gmin2), n, d, g, lmax);
  return (int)cudaGetLastError();
}

const char* grouped_assign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
