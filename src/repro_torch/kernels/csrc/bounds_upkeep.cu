// The per-point bound upkeep of a move and the own-distance refresh, in
// one pass over the points, for sm_90a.
//
// Replaces no TPU kernel: in the JAX package this is plain array code in
// repro/core/engine.py's move_and_bounds, which XLA fuses. On the card
// the same code ran as some fifteen PyTorch launches an iteration, each a
// pass over N or N x G values (a gather of an N x D copy of the centroids
// among them). This kernel does the whole of it after the centroid update
// and the K-sized drift work. Per point i with label a = a_i:
//
//   ub'    = ub_i + drift[a]
//   lb_dec = max(lb_i - group_drift, 0)          (the row, written out)
//   glb    = min(lb_dec)
//   maybe  = ub' > glb
//   ub_t   = refresh && maybe ? d_own : ub'
//            d_own = sqrt(max(x2_i - 2 (x_i . c_a) + c2[a], 0))
//   need   = ub_t > glb
//
// and `tightened`, the count of maybe rows, as one int64.
//
// Numerics. Every operation but the dot is elementwise or a min, so it
// gives the plain PyTorch version's bits in any order: the same fp32
// rounding of each add and subtract, NaN kept by the clamp and the min as
// torch.clamp_min and torch.min keep it. The dot has a fixed order of its
// own, which differs from torch.sum's. Eight lanes take a row; lane j of
// the eight adds, starting from 0, the products of its columns in column
// order: 4j .. 4j + 3, then 32 + 4j .. 32 + 4j + 3, and so on (at D 32 the
// four columns 4j .. 4j + 3). The eight sums are then added by a
// butterfly (xor 4, 2, 1). Each product is rounded before it is added
// (__fmul_rn, __fadd_rn: no fused multiply-add), as the plain version
// rounds points * c[a]. The order depends on D alone: 16-byte loads and
// 4-byte ones give the same sums. Addition commutes, so the eight lanes
// end with the same bits.
//
// Bound on the card: bytes. A point reads its label, ub and G lower bounds
// and writes ub, G lower bounds and need: N (13 + 8 G) bytes, 223 MB at
// uci-xlarge (N 2^20, G 25) and 217 MB at uci-highk (N 2^18, G 102), 0.067
// and 0.065 ms at 3.35 TB/s. A refreshed row adds its X row and x2 (D*4 +
// 4 bytes); the centroids (K*D*4, 32 KB at K 256, 128 KB at K 1024) stay in
// L2. The design touches each of those bytes once:
//
//   - a block owns `rows` consecutive points (a function of G alone, from
//     kernels/bounds_upkeep.py, which leaves shared memory for 8 blocks an
//     SM). Its slice of the N x G table is one contiguous run of rows * G
//     floats, copied into shared memory by cp.async, 16 bytes a thread
//     where the run is aligned, all of it in flight at once;
//   - the registers are held to kMinBlocks (4) blocks an SM, 64 a thread
//     with no spill. On an H100 the kernel ran 10-45% slower held to 6 or
//     8 blocks (40 or 32 registers, spilling), and at a depth of 1 or 2;
//   - the decay runs over the run in shared memory and is stored back to
//     the device in the same coalesced order; group_drift is staged in
//     shared memory beside it;
//   - thread t then takes point t: the min of its row from shared memory,
//     its label, ub, drift[a] and c2[a] (one value each, from L2);
//   - each warp refreshes its maybe rows together: four rows at a time,
//     eight lanes a row, kDepth such steps in flight at once, so the X
//     rows and the centroid rows are read 16 bytes a lane, coalesced;
//   - bu_own_kernel runs the same refresh over every row it is given: the
//     compact pass's refresh on its buffer, so that the refresh gives the
//     same bits in either place;
//   - the maybe rows are counted by warp ballots, added in a fixed order
//     in the block and added to the int64 total with one integer atomic a
//     block: an integer sum is exact in any order. No float is added
//     atomically.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;  // blocks an SM the registers allow
constexpr int kDepth = 4;      // rows an eight-lane group holds
constexpr unsigned kAll = 0xffffffffu;

extern __shared__ __align__(16) float sm[];

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
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// torch.clamp_min(v, 0): NaN stays NaN
__device__ __forceinline__ float clamp0(float v) {
  return v != v ? v : fmaxf(v, 0.0f);
}

// floats of shared memory before the lb run: group_drift, padded to 16
// bytes, then kWarps counts (kernels/bounds_upkeep.py's plan sizes the
// block's shared memory from the same layout)
__device__ __forceinline__ int head_floats(int g) {
  return ((g + 3) / 4) * 4 + kWarps;
}

// The own distances sqrt(max(x2_i - 2 (x_i . c_a) + c2[a], 0)) of the
// warp's rows in `rows` (bit r: row wrow0 + r), in the order the note
// gives. Row p of a step of 4 * kDepth rows (in ballot order) goes to the
// eight lanes 8 (p % 4) .. 8 (p % 4) + 7, slot p / 4. Lane r gets its
// own row's distance where bit r is set, and keeps `other` elsewhere; `a`
// and `i` are the lane's own label and row. Every lane of the warp calls.
__device__ __forceinline__ float own_dists(
    unsigned rows, int wrow0, int lane, int a, int i,
    const float* __restrict__ x, const float* __restrict__ x2,
    const float* __restrict__ c, const float* __restrict__ c2, int d,
    int xvec, float other) {
  const int oct = lane / 8, sub = lane % 8;
  float out = other;
  unsigned left = rows;
  while (left) {
    int who[kDepth], aq[kDepth];
    int my_q = -1, my_oct = 0;          // where this lane's own row went
    float acc[kDepth];
#pragma unroll
    for (int q = 0; q < kDepth; ++q) {
      who[q] = -1;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const int r = left ? __ffs(left) - 1 : -1;
        left &= left - 1;
        if (o == oct) who[q] = r;
        if (r == lane) {
          my_q = q;
          my_oct = o;
        }
      }
      aq[q] = __shfl_sync(kAll, a, who[q] < 0 ? 0 : who[q]);
      acc[q] = 0.0f;
    }
    for (int b = 4 * sub; b < d; b += 32) {
#pragma unroll
      for (int q = 0; q < kDepth; ++q) {
        if (who[q] < 0) continue;
        const float* xr = x + (size_t)(wrow0 + who[q]) * d + b;
        const float* cr = c + (size_t)aq[q] * d + b;
        if (xvec) {
          const float4 xv = __ldg(reinterpret_cast<const float4*>(xr));
          const float4 cv = __ldg(reinterpret_cast<const float4*>(cr));
          acc[q] = __fadd_rn(acc[q], __fmul_rn(xv.x, cv.x));
          acc[q] = __fadd_rn(acc[q], __fmul_rn(xv.y, cv.y));
          acc[q] = __fadd_rn(acc[q], __fmul_rn(xv.z, cv.z));
          acc[q] = __fadd_rn(acc[q], __fmul_rn(xv.w, cv.w));
        } else {
          for (int j = 0; j < 4 && b + j < d; ++j)
            acc[q] = __fadd_rn(acc[q],
                               __fmul_rn(__ldg(xr + j), __ldg(cr + j)));
        }
      }
    }
    // each eight lanes' butterfly; a row's owner then takes the sum from
    // the first lane of its eight
#pragma unroll
    for (int q = 0; q < kDepth; ++q) {
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        acc[q] = __fadd_rn(acc[q], __shfl_xor_sync(kAll, acc[q], off));
      const float dot = __shfl_sync(kAll, acc[q], 8 * my_oct);
      if (my_q == q) {
        const float d2 =
            __fadd_rn(__fsub_rn(x2[i], __fmul_rn(2.0f, dot)), c2[a]);
        out = __fsqrt_rn(clamp0(d2));
      }
    }
  }
  return out;
}

// kVec: the lb run is copied and stored 16 bytes at a time (the host
// checks that lb and lb_out lie on 16 bytes and that rows * g % 4 == 0,
// so every block's run starts on 16 bytes). xvec: the X and centroid rows
// are read 16 bytes at a time (D % 4 == 0, both on 16 bytes).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bu_upkeep_kernel(const float* __restrict__ x, const float* __restrict__ x2,
                 const float* __restrict__ c, const float* __restrict__ c2,
                 const int* __restrict__ labels, const float* __restrict__ ub,
                 const float* __restrict__ lb,
                 const float* __restrict__ drift,
                 const float* __restrict__ gdrift, float* __restrict__ ub_out,
                 float* __restrict__ lb_out, uint8_t* __restrict__ need,
                 unsigned long long* __restrict__ tightened, int n, int d,
                 int k, int g, int rows, int refresh, int xvec) {
  float* s_gd = sm;
  int* s_cnt = reinterpret_cast<int*>(sm + head_floats(g) - kWarps);
  float* s_lb = sm + head_floats(g);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, n - r0);
  const int len = nr * g;
  const float* src = lb + (size_t)r0 * g;
  float* dst = lb_out + (size_t)r0 * g;
  const uint32_t s_lb_a =
      static_cast<uint32_t>(__cvta_generic_to_shared(s_lb));

  // the block's run of the lower bounds, all of it in flight at once
  constexpr int kW = kVec ? 4 : 1;
  const int units = len / kW;
  for (int u = tid; u < units; u += kThreads) {
    if (kVec)
      cp_async16(s_lb_a + 16u * u, src + 4 * u);
    else
      cp_async4(s_lb_a + 4u * u, src + u);
  }
  for (int e = units * kW + tid; e < len; e += kThreads)
    cp_async4(s_lb_a + 4u * e, src + e);
  for (int j = tid; j < g; j += kThreads) s_gd[j] = gdrift[j];
  cp_wait_all();
  __syncthreads();

  // the decay, in place in shared memory and out to the device; a unit's
  // first column walks by (kW * kThreads) % g without a division
  {
    const int step = (kW * kThreads) % g;
    int col = (kW * tid) % g;
    for (int u = tid; u < units; u += kThreads) {
      if (kVec) {
        float4 v = reinterpret_cast<float4*>(s_lb)[u];
        int c1 = col + 1, c2_ = col + 2, c3 = col + 3;
        while (c1 >= g) c1 -= g;
        while (c2_ >= g) c2_ -= g;
        while (c3 >= g) c3 -= g;
        v.x = clamp0(__fsub_rn(v.x, s_gd[col]));
        v.y = clamp0(__fsub_rn(v.y, s_gd[c1]));
        v.z = clamp0(__fsub_rn(v.z, s_gd[c2_]));
        v.w = clamp0(__fsub_rn(v.w, s_gd[c3]));
        reinterpret_cast<float4*>(s_lb)[u] = v;
        reinterpret_cast<float4*>(dst)[u] = v;
      } else {
        const float v = clamp0(__fsub_rn(s_lb[u], s_gd[col]));
        s_lb[u] = v;
        dst[u] = v;
      }
      col += step;
      if (col >= g) col -= g;
    }
    for (int e = units * kW + tid; e < len; e += kThreads) {
      const float v = clamp0(__fsub_rn(s_lb[e], s_gd[e % g]));
      s_lb[e] = v;
      dst[e] = v;
    }
  }
  __syncthreads();

  // thread t takes point r0 + t
  const bool mine = tid < nr;
  const int i = r0 + tid;
  float glb = 0.0f, ubp = 0.0f;
  int a = 0;
  bool maybe = false;
  if (mine) {
    const float* row = s_lb + tid * g;
    glb = row[0];
    for (int j = 1; j < g; ++j) {
      const float v = row[j];
      if (v < glb || v != v) glb = v;       // torch.min keeps a NaN
    }
    a = labels[i];
    if ((unsigned)a >= (unsigned)k) __trap();   // drift[a] out of range
    ubp = __fadd_rn(ub[i], drift[a]);
    maybe = ubp > glb;
  }
  const unsigned maybes = __ballot_sync(kAll, maybe);
  if (lane == 0) s_cnt[warp] = __popc(maybes);

  const float ubt =
      refresh ? own_dists(maybes, r0 + warp * 32, lane, a, i, x, x2, c, c2,
                          d, xvec, ubp)
              : ubp;
  if (mine) {
    ub_out[i] = ubt;
    need[i] = ubt > glb ? 1 : 0;
  }
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_cnt[w];
    if (total) atomicAdd(tightened, (unsigned long long)total);
  }
}

// The own distance of every row, in the refresh's order: the compact
// pass's in-pass refresh, so that both placements of the refresh give the
// same bits.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bu_own_kernel(const float* __restrict__ x, const float* __restrict__ x2,
              const float* __restrict__ c, const float* __restrict__ c2,
              const int* __restrict__ labels, float* __restrict__ out, int n,
              int d, int k, int xvec) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool mine = i < n;
  int a = 0;
  if (mine) {
    a = labels[i];
    if ((unsigned)a >= (unsigned)k) __trap();   // c[a] out of range
  }
  const float own = own_dists(__ballot_sync(kAll, mine), i - lane, lane, a,
                              i, x, x2, c, c2, d, xvec, 0.0f);
  if (mine) out[i] = own;
}

}  // namespace

extern "C" {

// x (n, d) f32, x2 (n,) f32, c (k, d) f32 and c2 (k,) f32 (read only with
// refresh; may be null without it); labels (n,) i32 in [0, k); ub (n,),
// lb (n, g), drift (k,), gdrift (g,) f32; outputs ub_out (n,), lb_out
// (n, g) f32, need (n,) bool, tightened one int64, zeroed here. `rows`
// points a block (kernels/bounds_upkeep.py's plan), smem bytes a block.
int bounds_upkeep_launch(const void* x, const void* x2, const void* c,
                         const void* c2, const void* labels, const void* ub,
                         const void* lb, const void* drift,
                         const void* gdrift, void* ub_out, void* lb_out,
                         void* need, void* tightened, int n, int d, int k,
                         int g, int rows, int smem, int refresh,
                         void* stream) {
  if (n < 0 || g < 1 || k < 1 || rows < 1 || rows > kThreads ||
      (refresh && (d < 1 || !x || !x2 || !c || !c2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(tightened, 0, sizeof(long long), s);
  if (e != cudaSuccess || n == 0) return (int)e;
  const bool vec = reinterpret_cast<uintptr_t>(lb) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(lb_out) % 16 == 0 &&
                   (long long)rows * g % 4 == 0;
  const int xvec = refresh && d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  auto kernel = vec ? bu_upkeep_kernel<true> : bu_upkeep_kernel<false>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((n + rows - 1) / rows);
  kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(x2),
      static_cast<const float*>(c), static_cast<const float*>(c2),
      static_cast<const int*>(labels), static_cast<const float*>(ub),
      static_cast<const float*>(lb), static_cast<const float*>(drift),
      static_cast<const float*>(gdrift), static_cast<float*>(ub_out),
      static_cast<float*>(lb_out), static_cast<uint8_t*>(need),
      static_cast<unsigned long long*>(tightened), n, d, k, g, rows, refresh,
      xvec);
  return (int)cudaGetLastError();
}

// out (n,) f32: the own distance of each row of x (n, d) to c[labels],
// with x2 (n,) and c2 (k,), in the refresh's order; labels i32 in [0, k).
int bounds_upkeep_own_launch(const void* x, const void* x2, const void* c,
                             const void* c2, const void* labels, void* out,
                             int n, int d, int k, void* stream) {
  if (n < 0 || d < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int xvec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  bu_own_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(x2),
      static_cast<const float*>(c), static_cast<const float*>(c2),
      static_cast<const int*>(labels), static_cast<float*>(out), n, d, k,
      xvec);
  return (int)cudaGetLastError();
}

const char* bounds_upkeep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
