// The candidate pass's group filter and its tail, for sm_90a: the work of
// repro_torch/core/engine.py's kernel_candidate_pass around the
// grouped_assign kernel.
//
// Replaces no TPU kernel: in the JAX package this is plain array code in
// repro/core/engine.py's pallas_candidate_pass and _finish_pass, which XLA
// fuses. On the card the same code ran as some twenty PyTorch launches a
// pass, each a pass over an N x G table. Two kernels take their place.
//
// ct_mask_kernel, before grouped_assign: block b owns point tile b (tile_n
// rows) and writes row b of the (ceil(N / tile_n), G) block mask:
//
//   mask[b, g] = OR over the tile's rows i of need_i & (lb[i, g] < ub_t_i)
//
// The (N, G) group_need table is never formed. The mask is an OR, so its
// bits do not depend on the order in which the block sees its rows.
//
// ct_tail_kernel, after grouped_assign (best2, idx, gmin, garg, gmin2): per
// point i with label a = a_i and own group o = groups[a],
//
//   best_d   = sqrt(best2_i)
//   changed  = best_d < ub_t_i
//   new_a    = changed ? idx_i : a
//   new_ub   = minimum(ub_t_i, best_d)
//   new_lb_g = need_i & (lb[i, g] < ub_t_i)
//              ? sqrt(garg[i, g] == new_a ? gmin2[i, g] : gmin[i, g])
//              : lb[i, g]
//   new_lb_o = minimum(new_lb_o, changed & new_a != a ? ub_t_i : +inf)
//
// Numerics. No value is a sum: every output is a selection, a compare, a
// square root or a minimum of inputs, so the kernel gives the bits of the
// plain PyTorch version (kernels/candidate_tail.py). The root is IEEE's
// (__fsqrt_rn, as torch.sqrt rounds it), the compares strict, and
// `minimum` keeps a NaN as torch.minimum does (the first NaN operand, else
// the smaller). Every row of the block is processed, also a row whose own
// need is false: grouped_assign scores every row of a live tile, and such
// a row can move.
//
// Bound on the card: bytes. The mask reads need, ub_t and lb: N (5 + 4 G)
// bytes, 110 MB at uci-xlarge (N 2^20, G 25), 0.033 ms at 3.35 TB/s. The
// tail reads best2, idx, a, ub_t and need (17 bytes a point) and lb, writes
// new_a, new_ub (8) and new_lb, and reads garg and gmin (8 bytes) where a
// group is computed and gmin2 where it also holds new_a: N (25 + 8 G) bytes
// and 8 a computed group, 236-446 MB at uci-xlarge, 0.07-0.13 ms. The
// design touches each of those bytes once:
//
//   - both kernels walk their block's run of the N x G tables in its
//     memory order, 16 bytes a thread where the run and every table lie on
//     16 bytes, so each warp's loads and stores are coalesced;
//   - a row's scalars (the mask's threshold, the tail's new label, own
//     group and cap) are worked out once, by one thread, into shared
//     memory, where the table walk reads them;
//   - the tail reads garg and gmin only for four elements of which one is
//     computed, and gmin2 only for an element whose garg is the row's new
//     label; the mask's blocks need no atomics: a live group is a byte of
//     shared memory set to 1 by whichever threads find it live.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;      // points a block of the tail takes

extern __shared__ __align__(16) unsigned char ct_sm[];

// torch.minimum: a NaN operand (the first, if both are) else the smaller
__device__ __forceinline__ float torch_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

// need_i ? ub_t_i : -inf, so that `lb < thr` is need_i & (lb < ub_t_i) for
// every lb, a NaN among them
__device__ __forceinline__ float threshold(uint8_t need, float ub) {
  return need ? ub : -CUDART_INF_F;
}

// kVec: the tile's run of lb is read 16 bytes at a time (the host checks
// that lb lies on 16 bytes and that tile_n * g % 4 == 0).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ct_mask_kernel(const uint8_t* __restrict__ need, const float* __restrict__ lb,
               const float* __restrict__ ub, uint8_t* __restrict__ mask,
               int n, int g, int tile_n) {
  float* s_thr = reinterpret_cast<float*>(ct_sm);
  uint8_t* s_live = ct_sm + 4 * (size_t)tile_n;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * tile_n;
  const int nr = min(tile_n, n - r0);
  for (int j = tid; j < g; j += kThreads) s_live[j] = 0;
  for (int r = tid; r < nr; r += kThreads)
    s_thr[r] = threshold(need[r0 + r], ub[r0 + r]);
  __syncthreads();

  const float* run = lb + (size_t)r0 * g;
  const int len = nr * g;
  int done = 0;
  if (kVec) {
    const int units = len / 4;
    const float4* run4 = reinterpret_cast<const float4*>(run);
    for (int u = tid; u < units; u += kThreads) {
      const float4 v = __ldg(run4 + u);
      const float l[4] = {v.x, v.y, v.z, v.w};
      int r = 4 * u / g, c = 4 * u - r * g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (l[j] < s_thr[r]) s_live[c] = 1;
        if (++c == g) {
          c = 0;
          ++r;
        }
      }
    }
    done = 4 * units;
  }
  for (int e = done + tid; e < len; e += kThreads) {
    const int r = e / g;
    if (__ldg(run + e) < s_thr[r]) s_live[e - r * g] = 1;
  }
  __syncthreads();
  for (int j = tid; j < g; j += kThreads)
    mask[(size_t)blockIdx.x * g + j] = s_live[j];
}

// One element (r, c) of the tail's table walk: the lower bound `l` as it
// came in, its computed value where the group is computed, then the cap
// on the row's old group. `gm` is gmin's value there, `ga` garg's (both
// read only where computed); gmin2 is read here where garg is the new
// label.
__device__ __forceinline__ float tail_elem(
    float l, bool computed, int ga, float gm, const float* gmin2_e,
    int c, int na, int own, float cap) {
  float v = l;
  if (computed) v = __fsqrt_rn(ga == na ? __ldg(gmin2_e) : gm);
  if (c == own) v = torch_min(v, cap);
  return v;
}

// kVec: lb, gmin, garg and new_lb are walked 16 bytes at a time (each lies
// on 16 bytes; kRows * g % 4 == 0 puts every block's run on 16 bytes too).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ct_tail_kernel(const float* __restrict__ best2, const int* __restrict__ idx,
               const float* __restrict__ gmin, const int* __restrict__ garg,
               const float* __restrict__ gmin2,
               const int* __restrict__ labels, const float* __restrict__ ub,
               const float* __restrict__ lb,
               const uint8_t* __restrict__ need,
               const int* __restrict__ groups, int* __restrict__ new_labels,
               float* __restrict__ new_ub, float* __restrict__ new_lb, int n,
               int k, int g) {
  __shared__ float s_thr[kRows], s_cap[kRows];
  __shared__ int s_na[kRows], s_own[kRows];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, n - r0);

  // the row's scalars, one thread a row
  for (int r = tid; r < nr; r += kThreads) {
    const int i = r0 + r;
    const int a = labels[i];
    if ((unsigned)a >= (unsigned)k) __trap();      // groups[a] out of range
    const int own = groups[a];
    if ((unsigned)own >= (unsigned)g) __trap();    // lb[i, own] out of range
    const float u = ub[i];
    const float bd = __fsqrt_rn(best2[i]);
    const bool changed = bd < u;
    const int na = changed ? idx[i] : a;
    new_labels[i] = na;
    new_ub[i] = torch_min(u, bd);
    s_thr[r] = threshold(need[i], u);
    s_na[r] = na;
    s_own[r] = own;
    s_cap[r] = changed && na != a ? u : CUDART_INF_F;
  }
  __syncthreads();

  const size_t base = (size_t)r0 * g;
  const int len = nr * g;
  int done = 0;
  if (kVec) {
    const int units = len / 4;
    const float4* lb4 = reinterpret_cast<const float4*>(lb + base);
    const float4* gmin4 = reinterpret_cast<const float4*>(gmin + base);
    const int4* garg4 = reinterpret_cast<const int4*>(garg + base);
    float4* out4 = reinterpret_cast<float4*>(new_lb + base);
    for (int u = tid; u < units; u += kThreads) {
      const float4 lv = __ldg(lb4 + u);
      const float l[4] = {lv.x, lv.y, lv.z, lv.w};
      int rr[4], cc[4];
      bool comp[4];
      bool any = false;
      {
        int r = 4 * u / g, c = 4 * u - r * g;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          rr[j] = r;
          cc[j] = c;
          comp[j] = l[j] < s_thr[r];
          any |= comp[j];
          if (++c == g) {
            c = 0;
            ++r;
          }
        }
      }
      int ga[4] = {0, 0, 0, 0};
      float gm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (any) {
        const int4 a4 = __ldg(garg4 + u);
        const float4 m4 = __ldg(gmin4 + u);
        ga[0] = a4.x;
        ga[1] = a4.y;
        ga[2] = a4.z;
        ga[3] = a4.w;
        gm[0] = m4.x;
        gm[1] = m4.y;
        gm[2] = m4.z;
        gm[3] = m4.w;
      }
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = tail_elem(l[j], comp[j], ga[j], gm[j],
                         gmin2 + base + 4 * u + j, cc[j], s_na[rr[j]],
                         s_own[rr[j]], s_cap[rr[j]]);
      out4[u] = make_float4(o[0], o[1], o[2], o[3]);
    }
    done = 4 * units;
  }
  for (int e = done + tid; e < len; e += kThreads) {
    const int r = e / g, c = e - r * g;
    const size_t at = base + e;
    const float l = __ldg(lb + at);
    const bool comp = l < s_thr[r];
    new_lb[at] = tail_elem(l, comp, comp ? __ldg(garg + at) : 0,
                           comp ? __ldg(gmin + at) : 0.0f, gmin2 + at, c,
                           s_na[r], s_own[r], s_cap[r]);
  }
}

bool on16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Bytes of shared memory a block of the mask takes at (tile_n, g): a float
// threshold a row of the tile, then a live flag a group
// (kernels/candidate_tail.py's mask_smem).
int mask_smem(int tile_n, int g) { return 4 * tile_n + g; }

}  // namespace

extern "C" {

// need (n,) bool, lb (n, g) f32, ub (n,) f32 -> mask (ceil(n / tile_n), g)
// bool.
int candidate_tail_mask_launch(const void* need, const void* lb,
                               const void* ub, void* mask, int n, int g,
                               int tile_n, void* stream) {
  if (n < 0 || g < 1 || tile_n < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int smem = mask_smem(tile_n, g);
  const bool vec = on16(lb) && (long long)tile_n * g % 4 == 0;
  auto kernel = vec ? ct_mask_kernel<true> : ct_mask_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((n + tile_n - 1) / tile_n);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(need), static_cast<const float*>(lb),
      static_cast<const float*>(ub), static_cast<uint8_t*>(mask), n, g,
      tile_n);
  return (int)cudaGetLastError();
}

// grouped_assign's outputs best2 (n,) f32, idx (n,) i32, gmin, garg (i32)
// and gmin2 (n, g); labels (n,) i32 in [0, k), ub (n,) f32, lb (n, g) f32,
// need (n,) bool, groups (k,) i32 in [0, g) -> new_labels (n,) i32,
// new_ub (n,) f32, new_lb (n, g) f32.
int candidate_tail_launch(const void* best2, const void* idx,
                          const void* gmin, const void* garg,
                          const void* gmin2, const void* labels,
                          const void* ub, const void* lb, const void* need,
                          const void* groups, void* new_labels, void* new_ub,
                          void* new_lb, int n, int k, int g, void* stream) {
  if (n < 0 || k < 1 || g < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const bool vec = on16(gmin) && on16(garg) && on16(lb) && on16(new_lb);
  auto kernel = vec ? ct_tail_kernel<true> : ct_tail_kernel<false>;
  const unsigned blocks = (unsigned)((n + kRows - 1) / kRows);
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(best2), static_cast<const int*>(idx),
      static_cast<const float*>(gmin), static_cast<const int*>(garg),
      static_cast<const float*>(gmin2), static_cast<const int*>(labels),
      static_cast<const float*>(ub), static_cast<const float*>(lb),
      static_cast<const uint8_t*>(need), static_cast<const int*>(groups),
      static_cast<int*>(new_labels), static_cast<float*>(new_ub),
      static_cast<float*>(new_lb), n, k, g);
  return (int)cudaGetLastError();
}

const char* candidate_tail_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
