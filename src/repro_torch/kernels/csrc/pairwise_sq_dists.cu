// Tiled pairwise squared distances, for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/distance.py
// (pairwise_sq_dists -> _dist_kernel). For points x (N, D) and
// centroids c (K, D), fp32 or bf16, it writes the fp32 (N, K) matrix
// max(|x|^2 - 2 x.c + |c|^2, 0), with both squared norms computed
// inside the kernel, as _dist_kernel does. Ragged N, K and D are
// handled by bounds checks (the reference pads to its tiles).
//
// Design (simple first): one CTA of 256 threads per 128 x 128 output
// tile. The CTA stages 16-wide slices of D of its 128 points and its
// 128 centroids in shared memory, transposed ([d][row], rows padded to
// 132 so that the transposing stores conflict 2-way at most and every
// row stays 16-byte aligned), and each thread keeps an 8 x 8 block of
// dot products in registers: rows {ty*4..ty*4+3, 64+ty*4..64+ty*4+3},
// columns likewise with tx, so that both the float4 shared-memory
// reads and the float4 global stores of a warp are contiguous. The
// products run in fp32 FFMA: the tensor cores have no IEEE fp32 mode,
// and TF32 changes labels. bf16 inputs are widened to fp32 as they are
// staged. The norms come from the same staged slices: thread t < 128
// sums row t, thread t >= 128 centroid t - 128.
//
// Bound on the card: at uci-xlarge (N = 2^20, D = 32, K = 256) the
// 1 GiB fp32 output alone takes 0.32 ms at 3.35 TB/s, above the
// 2*N*K*D = 17.2 GFLOP of FFMA (0.26 ms at 67 TFLOP/s): the kernel is
// bound by the bytes it writes, and writes each output once, in
// 16-byte stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;              // points and centroids per CTA
constexpr int kPad = kTile + 4;         // shared row stride (floats)
constexpr int kSliceD = 16;             // D columns staged per step
constexpr int kThreads = 256;           // 16 x 16 threads, 8 x 8 each
constexpr int kHalf = kTile / 2;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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
psd_kernel(const T* __restrict__ x, const T* __restrict__ c,
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
        v[q] = fmaxf(xx - 2.0f * acc[i][h * 4 + q] + c2s[lc + q], 0.0f);
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

}  // namespace

extern "C" {

// x (n, d), c (k, d), both fp32 (dtype 0) or both bf16 (dtype 1);
// out (n, k) fp32. Returns cudaGetLastError() after the launch.
int pairwise_sq_dists_launch(const void* x, const void* c, void* out, int n,
                             int k, int d, int dtype, void* stream) {
  const dim3 grid((n + kTile - 1) / kTile, (k + kTile - 1) / kTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    psd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(c),
        static_cast<float*>(out), n, k, d);
  } else if (dtype == 1) {
    psd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(c), static_cast<float*>(out), n, k,
        d);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* pairwise_sq_dists_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
