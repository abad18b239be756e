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
// of 1.0 against no weights. This kernel reduces in a fixed order that
// depends on (N, D, K) alone, through the launch plan that
// kernels/centroid_update.py computes and passes in:
//
//   pass 1 (cu_partial): block (chunk, column tile) is `warps` warps.
//     Each warp owns a contiguous run of the chunk's rows and its own
//     K x tile accumulator (plus K counts) in shared memory; lane l
//     adds column tile * blockIdx.y + l. Rows, labels and weights
//     stream into a per-warp ring of kStages stages of stage_rows rows
//     by cp.async (16 bytes a thread where the rows allow it), so
//     kStages - 1 stages are in flight while one is added: some 15 KB
//     an SM must be in flight to cover the latency at 3.35 TB/s, more
//     than loads from the warps' own registers can hold. A stage is
//     added kGroup rows at a time from registers (add_group), in row
//     order: where the group's labels differ, its read-modify-writes of
//     the accumulator are independent and all in flight at once (a loop
//     that adds one row at a time is bound by its chain of dependent
//     shared-memory round trips, not by memory). The warps'
//     accumulators then merge in warp order into the chunk's partial.
//   pass 2 (cu_reduce): block b owns 32 consecutive outputs; warp w
//     sums a fixed segment of the chunks in chunk order, and the
//     segments merge in warp order, so the whole card takes part.
//
// Each product is w_i * x_i rounded and then added (no fused
// multiply-add), as the reference multiplies before it sums; with no
// weights w_i = 1.0f, and 1.0f * x is exact, so uniform weights of 1.0
// are bit-identical to no weights.
//
// Bound on the card: bytes. The points are read once (N*D*4 bytes;
// 134 MB at N = 2^20, D = 32), one add per element. The partials add
// chunks*(K*D + K)*4 bytes written and read again (8.9 MB there).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kStages = 4;        // ring stages a warp keeps
constexpr int kGroup = 8;         // rows added together from registers
constexpr int kReduceWarps = 8;   // chunk segments of pass 2
constexpr unsigned kAll = 0xffffffffu;

// pass 1's dynamic shared memory. The hot loop reaches it by 32-bit
// shared addresses computed once (lds, sts), so the compiler does not
// rebuild the shared window's base for each access.
extern __shared__ __align__(16) float sm[];

__device__ __forceinline__ float lds(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void sts(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Adds nr <= kGroup staged rows into the warp's accumulator in row
// order: acc[l] = ((acc[l] + p_a) + p_b) + ... over the rows a < b < ...
// of label l, p = w * x. Shared addresses, this lane's: row r's x at
// xa + r * row_bytes, its label (as bits) at la + 4r, its weight at
// wa + 4r; the accumulator of label l at aa + l * row_bytes, the count
// at ca + 4l. Where the group's labels are all distinct (the common
// case) their read-modify-writes touch distinct addresses and are all
// in flight at once; where all rows share one label the sum runs in a
// register between one read and one write; otherwise rows go one at a
// time. The three give the same bits. Every lane sees every label, so
// the control flow is uniform across the warp.
__device__ __forceinline__ void add_group(uint32_t xa, uint32_t la,
                                          uint32_t wa, uint32_t aa,
                                          uint32_t ca, uint32_t row_bytes,
                                          bool weighted, int nr, int k,
                                          bool col, int lane, bool counts) {
  // lane r < nr: row r's label and weight; -1 for a row that adds
  // nothing (past nr, or a label outside [0, k))
  int key = -1;
  float wl = 1.0f;
  if (lane < nr) {
    const int l = __float_as_int(lds(la + 4u * lane));
    if ((unsigned)l < (unsigned)k) key = l;
    if (weighted) wl = lds(wa + 4u * lane);
  }
  const unsigned same = __match_any_sync(kAll, key);
  // a live row whose label an earlier row of the group has
  const bool repeat = key >= 0 && (same & ((1u << lane) - 1u)) != 0;
  float p[kGroup];
  int l[kGroup];
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    l[r] = __shfl_sync(kAll, key, r);
    const float x = col && r < nr ? lds(xa + r * row_bytes) : 0.0f;
    p[r] = __fmul_rn(__shfl_sync(kAll, wl, r), x);
  }
  if (!__any_sync(kAll, repeat)) {
    float a[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      a[r] = l[r] >= 0 && col ? lds(aa + l[r] * row_bytes) : 0.0f;
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      if (l[r] >= 0 && col) sts(aa + l[r] * row_bytes, __fadd_rn(a[r], p[r]));
    if (counts && key >= 0)
      sts(ca + 4u * key, __fadd_rn(lds(ca + 4u * key), wl));
    return;
  }
  const unsigned live = (1u << nr) - 1u;
  if (l[0] >= 0 && (__shfl_sync(kAll, same, 0) & live) == live) {
    float a = col ? lds(aa + l[0] * row_bytes) : 0.0f;
    float c = counts ? lds(ca + 4u * l[0]) : 0.0f;
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      if (r < nr) {
        a = __fadd_rn(a, p[r]);
        c = __fadd_rn(c, __shfl_sync(kAll, wl, r));
      }
    if (col) sts(aa + l[0] * row_bytes, a);
    if (counts && lane == 0) sts(ca + 4u * l[0], c);
    return;
  }
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    const float wr = __shfl_sync(kAll, wl, r);
    if (l[r] >= 0) {
      if (col) {
        const uint32_t i = aa + l[r] * row_bytes;
        sts(i, __fadd_rn(lds(i), p[r]));
      }
      if (counts && lane == 0)
        sts(ca + 4u * l[r], __fadd_rn(lds(ca + 4u * l[r]), wr));
    }
  }
}

// One warp's shared memory, in floats from its base (warp * warp_floats;
// the launch refuses a warp_floats shorter than warp_floats_needed or not
// a multiple of 4), with ring = kStages * stage_rows:
//   x ring  [ring][tile]
//   acc     [k][tile]
//   counts  [k]
//   labels  [ring]   (int bits)
//   weights [ring]
// kVec = 4 copies 16 bytes a thread (D % 4 == 0, tile % 4 == 0, x
// 16-byte aligned); kVec = 1 copies 4.
__host__ __device__ constexpr long long warp_floats_needed(int k, int tile,
                                                          int stage_rows) {
  return (long long)kStages * stage_rows * (tile + 2) + (long long)k * tile + k;
}

template <int kVec>
__global__ void __launch_bounds__(256)
cu_partial(const float* __restrict__ x, const int* __restrict__ labels,
           const float* __restrict__ w, float* __restrict__ part, int n,
           int d, int k, int tile, int stage_rows, int rows_per_chunk,
           int rows_per_warp, int warp_floats) {
  const int ring = kStages * stage_rows;
  const int warps = blockDim.x / kLanes;
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int xs = warp * warp_floats;
  const int acc = xs + ring * tile;
  const int cnt = acc + k * tile;
  const int labs = cnt + k;
  const int wts = labs + ring;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(sm));

  for (int i = lane; i < k * tile; i += kLanes) sm[acc + i] = 0.0f;
  for (int i = lane; i < k; i += kLanes) sm[cnt + i] = 0.0f;

  const int c0 = blockIdx.y * tile;
  const int cols = min(tile, d - c0);
  const bool counts = blockIdx.y == 0;
  const int chunk0 = blockIdx.x * rows_per_chunk;
  const int chunk1 = min(n, chunk0 + rows_per_chunk);
  const int r0 = min(chunk1, chunk0 + warp * rows_per_warp);
  const int r1 = min(chunk1, r0 + rows_per_warp);
  const int blocks = (r1 - r0 + stage_rows - 1) / stage_rows;
  const int per_row = cols / kVec;

  // copy rows block b of the warp's run into ring slot b % kStages; one
  // commit group per call, empty past the run
  auto copy_block = [&](int b) {
    if (b < blocks) {
      const int rb = r0 + b * stage_rows, nr = min(stage_rows, r1 - rb);
      const int slot = (b % kStages) * stage_rows;
      int rr = lane / per_row, cc = (lane - rr * per_row) * kVec;
      const int step = kLanes / per_row, left = kLanes - step * per_row;
      // walk (row, column) pairs 32 at a time without a division each
      for (int e = lane; e < nr * per_row; e += kLanes) {
        const float* src = x + (size_t)(rb + rr) * d + c0 + cc;
        const uint32_t dst = base + 4u * (xs + (slot + rr) * tile + cc);
        if (kVec == 4)
          cp_async16(dst, src);
        else
          cp_async4(dst, src);
        rr += step;
        cc += left * kVec;
        if (cc >= per_row * kVec) {
          cc -= per_row * kVec;
          ++rr;
        }
      }
      for (int e = lane; e < nr; e += kLanes) {
        cp_async4(base + 4u * (labs + slot + e), labels + rb + e);
        if (w) cp_async4(base + 4u * (wts + slot + e), w + rb + e);
      }
    }
    cp_commit();
  };

  for (int b = 0; b < kStages - 1; ++b) copy_block(b);
  for (int b = 0; b < blocks; ++b) {
    copy_block(b + kStages - 1);
    cp_wait_ring();                  // this lane's copies of block b
    __syncwarp();                    // and every other lane's
    const int slot = (b % kStages) * stage_rows;
    const int nr = min(stage_rows, r1 - (r0 + b * stage_rows));
    for (int g = 0; g < nr; g += kGroup) {
      add_group(base + 4u * (xs + (slot + g) * tile + lane),
                base + 4u * (labs + slot + g), base + 4u * (wts + slot + g),
                base + 4u * (acc + lane), base + 4u * cnt, 4u * tile,
                w != nullptr, min(kGroup, nr - g), k, lane < cols, lane,
                counts);
      // the counts are shared by the warp's lanes (the accumulator's
      // columns are each lane's own): order this group's count writes
      // before the next group's reads
      if (counts) __syncwarp();
    }
    __syncwarp();                    // slot read before it is refilled
  }
  __syncthreads();

  // the warps' accumulators in warp order: the chunk's partial, sums
  // [k][d] then counts [k]
  float* out = part + (size_t)blockIdx.x * ((size_t)k * d + k);
  const int acc0 = ring * tile;
  for (int e = threadIdx.x; e < k * cols; e += blockDim.x) {
    const int kk = e / cols, c = e - kk * cols;
    float s = sm[acc0 + kk * tile + c];
    for (int v = 1; v < warps; ++v)
      s = __fadd_rn(s, sm[v * warp_floats + acc0 + kk * tile + c]);
    out[(size_t)kk * d + c0 + c] = s;
  }
  if (counts) {
    const int cnt0 = acc0 + k * tile;
    for (int kk = threadIdx.x; kk < k; kk += blockDim.x) {
      float s = sm[cnt0 + kk];
      for (int v = 1; v < warps; ++v)
        s = __fadd_rn(s, sm[v * warp_floats + cnt0 + kk]);
      out[(size_t)k * d + kk] = s;
    }
  }
}

__global__ void __launch_bounds__(kReduceWarps * kLanes)
cu_reduce(const float* __restrict__ part, float* __restrict__ sums,
          float* __restrict__ counts, int chunks, int k, int d) {
  __shared__ float seg_sums[kReduceWarps][kLanes];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const size_t kd = (size_t)k * d, m = kd + k;
  const size_t i = (size_t)blockIdx.x * kLanes + lane;
  const int seg = (chunks + kReduceWarps - 1) / kReduceWarps;
  const int c0 = min(chunks, warp * seg), c1 = min(chunks, c0 + seg);
  float s = 0.0f;
  if (i < m) {
#pragma unroll 8
    for (int c = c0; c < c1; ++c) s = __fadd_rn(s, part[(size_t)c * m + i]);
  }
  seg_sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < m) {
    float t = seg_sums[0][lane];
    for (int v = 1; v < kReduceWarps && v * seg < chunks; ++v)
      t = __fadd_rn(t, seg_sums[v][lane]);
    if (i < kd)
      sums[i] = t;
    else
      counts[i - kd] = t;
  }
}

}  // namespace

extern "C" {

// x (n, d) f32; labels (n,) i32; w (n,) f32 or null; part (chunks,
// k*d + k) scratch; sums (k, d), counts (k,) outputs. The plan
// (kernels/centroid_update.py): `warps` accumulator warps a block,
// column tiles of `tile`, ring stages of stage_rows rows, `chunks`
// chunks of rows_per_chunk rows, each warp rows_per_warp of them,
// warp_floats floats of shared memory a warp (smem bytes a block in
// all).
int centroid_update_launch(const void* x, const void* labels, const void* w,
                           void* part, void* sums, void* counts, int n, int d,
                           int k, int warps, int tile, int stage_rows,
                           int chunks, int rows_per_chunk, int rows_per_warp,
                           int warp_floats, int smem, void* stream) {
  // the plan must give each warp the layout cu_partial reads
  if (d < 1 || k < 1 || warps < 1 || warps > 8 || tile < 1 ||
      tile > kLanes || stage_rows < 1 || warp_floats % 4 ||
      warp_floats < warp_floats_needed(k, tile, stage_rows) ||
      (long long)smem < 4LL * warps * warp_floats)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && tile % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (chunks > 0) {
    auto kernel = vec ? cu_partial<4> : cu_partial<1>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(chunks, (d + tile - 1) / tile);
    kernel<<<grid, warps * kLanes, smem, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(labels),
        static_cast<const float*>(w), static_cast<float*>(part), n, d, k,
        tile, stage_rows, rows_per_chunk, rows_per_warp, warp_floats);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const size_t m = (size_t)k * d + k;
  cu_reduce<<<(unsigned)((m + kLanes - 1) / kLanes), kReduceWarps * kLanes, 0,
              s>>>(static_cast<const float*>(part), static_cast<float*>(sums),
                   static_cast<float*>(counts), chunks, k, d);
  return (int)cudaGetLastError();
}

const char* centroid_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
