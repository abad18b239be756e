// Per-cluster sums and counts in a fixed order, for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/centroid_update.py
// (centroid_update -> _centroid_update_kernel), a one-hot matmul that
// the TPU's matrix unit likes. On Hopper the same function is a
// segmented reduction: sums[k] = sum of w_i * x_i over rows i with
// label k, counts[k] = sum of w_i. Label -1 (or any label outside
// [0, K)) contributes nothing.
//
// Why not atomics: fp32 atomicAdd lands in no fixed order, so two
// runs of one fit would differ in the last bits, and so would weights
// of 1.0 against no weights. This kernel reduces in a fixed order:
//
//   pass 1 (cu_partial): CTA (chunk, d-tile) is one warp. Lane l owns
//     column d-tile*32 + l of a K x 32 accumulator in shared memory and
//     adds the chunk's rows into it in row order. Lane 0 of the first
//     d-tile also owns the K counts. The chunk's partials go to
//     scratch.
//   pass 2 (cu_reduce): one thread per (k, d) sums the partials in
//     chunk order.
//
// Each product is w_i * x_i rounded and then added (no fused
// multiply-add), as the reference multiplies before it sums; with no
// weights w_i = 1.0f, and 1.0f * x is exact, so uniform weights of 1.0
// are bit-identical to no weights.
//
// Bound on the card: bytes. The points are read once (N*D*4 bytes;
// 134 MB at N = 2^20, D = 32), one add per element. The partials add
// chunks*K*D*4 bytes written and read again.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;

__global__ void cu_partial(const float* __restrict__ x,
                           const int* __restrict__ labels,
                           const float* __restrict__ w,
                           float* __restrict__ part_sums,
                           float* __restrict__ part_counts,
                           int n, int d, int k, int rows_per_chunk) {
  extern __shared__ float smem[];
  float* acc = smem;                 // [k][kLanes]
  float* cnt = smem + k * kLanes;    // [k], first d-tile only
  const int lane = threadIdx.x;
  const int chunk = blockIdx.x;
  const int col = blockIdx.y * kLanes + lane;
  const bool active = col < d;
  const bool counts = blockIdx.y == 0;

  for (int kk = 0; kk < k; ++kk) acc[kk * kLanes + lane] = 0.0f;
  if (counts)
    for (int kk = lane; kk < k; kk += kLanes) cnt[kk] = 0.0f;
  __syncwarp();

  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(n, r0 + rows_per_chunk);
  int r = r0;
  // four rows' loads in flight, applied in row order
  for (; r + 4 <= r1; r += 4) {
    int l[4];
    float v[4], wi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      l[u] = labels[r + u];
      wi[u] = w ? w[r + u] : 1.0f;
      v[u] = active ? x[(size_t)(r + u) * d + col] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (l[u] < 0 || l[u] >= k) continue;
      float* a = &acc[l[u] * kLanes + lane];
      *a = __fadd_rn(*a, __fmul_rn(wi[u], v[u]));
      if (counts && lane == 0) cnt[l[u]] = __fadd_rn(cnt[l[u]], wi[u]);
    }
  }
  for (; r < r1; ++r) {
    const int l = labels[r];
    if (l < 0 || l >= k) continue;
    const float wi = w ? w[r] : 1.0f;
    const float v = active ? x[(size_t)r * d + col] : 0.0f;
    float* a = &acc[l * kLanes + lane];
    *a = __fadd_rn(*a, __fmul_rn(wi, v));
    if (counts && lane == 0) cnt[l] = __fadd_rn(cnt[l], wi);
  }
  __syncwarp();

  if (active)
    for (int kk = 0; kk < k; ++kk)
      part_sums[((size_t)chunk * k + kk) * d + col] = acc[kk * kLanes + lane];
  if (counts)
    for (int kk = lane; kk < k; kk += kLanes)
      part_counts[(size_t)chunk * k + kk] = cnt[kk];
}

__global__ void cu_reduce(const float* __restrict__ part_sums,
                          const float* __restrict__ part_counts,
                          float* __restrict__ sums,
                          float* __restrict__ counts,
                          int chunks, int k, int d) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t kd = (size_t)k * d;
  if (i < kd) {
    float s = 0.0f;
    for (int c = 0; c < chunks; ++c) s = __fadd_rn(s, part_sums[c * kd + i]);
    sums[i] = s;
  }
  if (i < (size_t)k) {
    float s = 0.0f;
    for (int c = 0; c < chunks; ++c)
      s = __fadd_rn(s, part_counts[(size_t)c * k + i]);
    counts[i] = s;
  }
}

}  // namespace

extern "C" {

int centroid_update_smem_bytes(int k) {
  return (k * kLanes + k) * (int)sizeof(float);
}

// x (n, d) f32; labels (n,) i32; w (n,) f32 or null;
// part_sums (chunks, k, d) and part_counts (chunks, k) scratch;
// sums (k, d), counts (k,) outputs. chunks = ceil(n / rows_per_chunk).
int centroid_update_launch(const void* x, const void* labels, const void* w,
                           void* part_sums, void* part_counts, void* sums,
                           void* counts, int n, int d, int k,
                           int rows_per_chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (n + rows_per_chunk - 1) / rows_per_chunk;
  const int smem = centroid_update_smem_bytes(k);
  cudaError_t e = cudaFuncSetAttribute(
      cu_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (chunks > 0) {
    dim3 grid(chunks, (d + kLanes - 1) / kLanes);
    cu_partial<<<grid, kLanes, smem, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(labels),
        static_cast<const float*>(w), static_cast<float*>(part_sums),
        static_cast<float*>(part_counts), n, d, k, rows_per_chunk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const size_t kd = (size_t)k * d;
  const size_t total = kd > (size_t)k ? kd : (size_t)k;
  const int threads = 256;
  cu_reduce<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(part_sums),
      static_cast<const float*>(part_counts), static_cast<float*>(sums),
      static_cast<float*>(counts), chunks, k, d);
  return (int)cudaGetLastError();
}

const char* centroid_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
