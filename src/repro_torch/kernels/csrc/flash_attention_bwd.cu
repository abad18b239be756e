// Backward of causal grouped-query flash attention, for sm_90a.
//
// Replaces no TPU kernel: the Pallas kernel repro/kernels/flash_attention.py
// (flash_attention -> _flash_kernel) has no backward, and the reference
// trains through plain jnp attention. The port's training path runs the
// forward kernel (csrc/flash_attention.cu), so its gradient is this
// kernel, launched from the autograd Function in flash_attention.py.
//
// Inputs, all with the head dim contiguous and in one dtype (fp32 or
// bf16): q, o, dO (b, s, h, d) and k, v (b, s, kv, d), contiguous; query
// head hh reads kv head hh / (h / kv); and the fp32 L (b, h, s) that the
// forward wrote, L_i = log sum_{j <= i} exp(scale q_i . k_j), with
// scale = 1 / sqrt(d). With P = exp(scale q k^T - L) over keys j <= i:
//
//     dV = P^T dO            dP = dO V^T
//     dS = P o (dP - D)      D_i = sum_d dO_id O_id
//     dQ = scale dS K        dK = scale dS^T Q
//
// dK and dV of a kv head sum over the h / kv query heads of its group.
// No kernel recomputes L: the forward saves it. Every output element is
// summed by one thread in a fixed order, with no atomics anywhere, so
// two calls give the same bits.
//
// fa_bwd_pre, on both routes, a warp a row: D_i, and L and D copied
// into fp32 scratch padded to whole 64-row tiles (L = +inf, D = 0 past
// s, so a padded query row's P is exp(-inf) = 0 with no mask). It moves
// o and dO once: bound by bytes.
//
// Two routes after it; the wrapper picks one by dtype and head dim
// alone (kernels/flash_attention.py, route_for), as the forward does:
//
// tc (bf16 at d = 64, 96 or 128): the tensor cores, the forward tc
//   kernel's building blocks (csrc/tc_common.cuh): 64-row tiles copied
//   by TMA into swizzled shared memory (64-column panels with the
//   128-byte swizzle at d 64 and 128, three 32-column panels with the
//   64-byte swizzle at d 96: Panels), mbarriers, wgmma m64n64k16 (and
//   m64n96k16 for the products whose width is d 96) with fp32
//   accumulators in registers. A CTA is one
//   warpgroup of 128 threads that owns 64 rows; the other side's 64-row
//   tiles stream through a three-stage TMA ring.
//   - fa_bwd_dkdv_tc, a CTA a (key tile, query head, batch): K and V of
//     its keys stay in shared memory; Q, dO, L and D of each query tile
//     on or below the diagonal stream in. Per tile: S^T = K Q^T (both
//     operands K-major in shared memory, as the forward's S = Q K^T);
//     P^T = exp2(S^T scale log2 e - L log2 e) in the accumulator
//     fragments, the diagonal tile masked by selection; P^T rounded to
//     bf16 in registers, where the accumulator layout is the A layout
//     of the next product; dV += P^T dO (A from registers, dO read
//     MN-major, as the forward reads V) issued with dP^T = V dO^T;
//     dS^T = P^T o (dP^T - D) in registers, rounded to bf16; dK += dS^T
//     Q (Q MN-major). A CTA writes its head's dK (times scale) and dV
//     as fp32 partials (b, h, s, d).
//   - fa_bwd_sum adds each group's h / kv partials in order and casts
//     to bf16: the group's sum in a fixed order, with 5x the CTAs a
//     loop over the group inside a CTA would give (hymba-1.5b: 1,600
//     CTAs, not 320, for 132 SMs through a causal tail).
//   - fa_bwd_dq_tc, a CTA a (query tile, head, batch): Q and dO of its
//     rows stay; K and V of each key tile on or below the diagonal
//     stream in. S = Q K^T and dP = dO V^T issued together, P and dS in
//     registers, dQ += dS K (K MN-major); dQ written once, times scale.
//   Seven products a tile pair in all (S twice, dP twice, dV, dK, dQ)
//   against the five a backward needs at least. Both CTAs schedule the
//   longest walks first, and the query heads of one kv group have
//   neighbouring blockIdx.x, so K and V tiles come from L2. P and dS
//   are rounded to bf16 before their products, as SDPA and
//   FlashAttention do.
//
// ffma (fp32, the strict parity route since the tensor cores have no
//   IEEE fp32 mode, and bf16 at head dims other than 64, 96 and 128):
//   - fa_bwd_dkdv, a block a (key tile, kv head, batch): owns its 64
//     rows of dK and dV in registers and loops over the query heads of
//     the group in order, and for each over the query tiles on or below
//     the diagonal, so the group's sum is taken inside the block.
//   - fa_bwd_dq, a block a (query tile, head, batch): owns its 64 rows
//     of dQ and loops over the key tiles on or below the diagonal.
//   256 threads (ty, tx) of 16 x 16 each hold a 4 x 4 piece (rows
//   ty + 16 r, columns tx + 16 c) of a 64 x 64 score tile and 4 rows of
//   an accumulator (columns tx + 16 c). Operands are widened to fp32 in
//   shared memory (rows padded by one float); products are fp32 FFMA,
//   sums fp32, grads written in the inputs' dtype.
//
// Bound on the card: at hymba-1.5b (b 2, s 2048, 25 / 5 heads of 64,
// bf16) the five products a backward needs at least (S again, dV, dP,
// dQ, dK) over the causal half are 6.7e10 flops, 0.068 ms at the bf16
// tensor-core peak, against 63 MB of q, k, v, o, dO in and grads out
// (0.019 ms): bound by operations. The tc route's seven products are
// 9.4e10 flops (0.095 ms); its partials add 52 MB written and read
// again. A warpgroup waits for each product before the elementwise
// work that needs it; two CTAs an SM at d 64 and 96 (about 99 KB of
// shared memory each at 96) let one CTA's products overlap another's
// exponentials; d 128 takes one.
#include <math.h>

#include "tc_common.cuh"

namespace {

constexpr int kT = 64;          // rows of a query or key tile
constexpr int kThreads = 256;   // 16 x 16

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// s_pad: s rounded up to whole kT-row tiles, the row stride of the
// padded L and D
struct Dims {
  int s, s_pad, h, kv, d, rep;
  float scale;
};

// ---------------------------------------------------------------------------
// D of every query row, and L and D padded to whole tiles
// ---------------------------------------------------------------------------
constexpr int kPreWarps = 8;

// o, dout (b, s, h, d) contiguous; lse (b, h, s); lpad, dpad (b, h, s_pad)
template <typename T>
__global__ void __launch_bounds__(32 * kPreWarps)
    fa_bwd_pre(const T* __restrict__ o, const T* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ lpad,
               float* __restrict__ dpad, long long rows, int s, int s_pad,
               int h, int d) {
  const long long row = (long long)blockIdx.x * kPreWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                  // the whole warp
  const long long bh = row / s_pad;
  const int i = (int)(row - bh * s_pad);
  const long long bi = bh / h, hh = bh - bi * h;
  float part = 0.f;
  if (i < s) {
    const long long at = ((bi * s + i) * h + hh) * d;
    for (int c = lane; c < d; c += 32)
      part = fmaf(to_f(dout[at + c]), to_f(o[at + c]), part);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) {
    lpad[row] = i < s ? lse[bh * s + i] : INFINITY;
    dpad[row] = i < s ? part : 0.f;
  }
}

// ---------------------------------------------------------------------------
// The FFMA route
// ---------------------------------------------------------------------------

// rows [r0, r0 + kT) of one (batch, head) of a contiguous (b, s, heads, d)
// tensor, whose row stride is heads * d, into a kT x (DM + 1) fp32 tile;
// zero past s and d
template <typename T, int DM>
__device__ __forceinline__ void load_tile(float* tile, const T* base, int r0,
                                          int s, int d, long long rs) {
  for (int e = threadIdx.x; e < kT * DM; e += kThreads) {
    const int r = e / DM, c = e % DM;
    float v = 0.f;
    if (r0 + r < s && c < d) v = to_f(base[(long long)(r0 + r) * rs + c]);
    tile[r * (DM + 1) + c] = v;
  }
}

// L and D of rows [r0, r0 + kT) of one (batch, head) into shared memory;
// zero past s
__device__ __forceinline__ void load_rows(float* ls, float* ds,
                                          const float* lse, const float* dlt,
                                          int r0, int s) {
  for (int e = threadIdx.x; e < kT; e += kThreads) {
    const bool in = r0 + e < s;
    ls[e] = in ? lse[r0 + e] : 0.f;
    ds[e] = in ? dlt[r0 + e] : 0.f;
  }
}

// acc[r][c] = sum over DM of a[ty + 16 r][.] * b[tx + 16 c][.]
template <int DM>
__device__ __forceinline__ void dot_tile(float acc[4][4], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int k = 0; k < DM; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a[(ty + 16 * r) * (DM + 1) + k];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b[(tx + 16 * c) * (DM + 1) + k];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// acc[r][c] += sum over the kT rows i of w[i][ty + 16 r] * m[i][tx + 16 c]
// (w a kT x (kT + 1) tile, m a kT x (DM + 1) tile): a product with the
// tile's rows as the inner dimension, rows ty + 16 r of the result
template <int DM>
__device__ __forceinline__ void acc_tn(float acc[4][DM / 16], const float* w,
                                       const float* m, int ty, int tx) {
#pragma unroll 2
  for (int i = 0; i < kT; ++i) {
    float wv[4], mv[DM / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r) wv[r] = w[i * (kT + 1) + ty + 16 * r];
#pragma unroll
    for (int c = 0; c < DM / 16; ++c) mv[c] = m[i * (DM + 1) + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < DM / 16; ++c)
        acc[r][c] = fmaf(wv[r], mv[c], acc[r][c]);
  }
}

// P (masked, in registers) of query tile qs (rows r0..) against key tile
// ks (rows c0..), from L
template <int DM>
__device__ __forceinline__ void probs(float p[4][4], const float* qs,
                                      const float* ks, const float* ls,
                                      int r0, int c0, int ty, int tx,
                                      const Dims& dm) {
  dot_tile<DM>(p, qs, ks, ty, tx);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = r0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = c0 + tx + 16 * c;
      p[r][c] = (i < dm.s && j <= i)
                    ? expf(p[r][c] * dm.scale - ls[ty + 16 * r])
                    : 0.f;
    }
  }
}

// dK and dV of one key tile of one kv head
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dlt,
                T* __restrict__ dk, T* __restrict__ dv, Dims dm) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kT * (DM + 1);
  float* qs = vs + kT * (DM + 1);
  float* gs = qs + kT * (DM + 1);          // dO
  float* ps = gs + kT * (DM + 1);          // P, then dS
  float* ls = ps + kT * (kT + 1);
  float* ds = ls + kT;
  const int kb = blockIdx.x, kvh = blockIdx.y, bb = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int c0 = kb * kT, nqb = (dm.s + kT - 1) / kT;
  const long long qrs = (long long)dm.h * dm.d, krs = (long long)dm.kv * dm.d;
  const long long koff = (long long)bb * dm.s * krs + (long long)kvh * dm.d;
  load_tile<T, DM>(ks, k + koff, c0, dm.s, dm.d, krs);
  load_tile<T, DM>(vs, v + koff, c0, dm.s, dm.d, krs);
  float ak[4][DM / 16], av[4][DM / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DM / 16; ++c) ak[r][c] = av[r][c] = 0.f;
  for (int g = 0; g < dm.rep; ++g) {
    const int hh = kvh * dm.rep + g;
    const long long qoff = (long long)bb * dm.s * qrs + (long long)hh * dm.d;
    const long long roff = ((long long)bb * dm.h + hh) * dm.s_pad;
    for (int qb = kb; qb < nqb; ++qb) {
      const int r0 = qb * kT;
      __syncthreads();
      load_tile<T, DM>(qs, q + qoff, r0, dm.s, dm.d, qrs);
      load_tile<T, DM>(gs, dout + qoff, r0, dm.s, dm.d, qrs);
      load_rows(ls, ds, lse + roff, dlt + roff, r0, dm.s);
      __syncthreads();
      float p[4][4];
      probs<DM>(p, qs, ks, ls, r0, c0, ty, tx, dm);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ps[(ty + 16 * r) * (kT + 1) + tx + 16 * c] = p[r][c];
      __syncthreads();
      acc_tn<DM>(av, ps, gs, ty, tx);     // dV += P^T dO
      float dp[4][4];
      dot_tile<DM>(dp, gs, vs, ty, tx);   // dP = dO V^T
      __syncthreads();                    // every read of P is done
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ps[(ty + 16 * r) * (kT + 1) + tx + 16 * c] =
              p[r][c] * (dp[r][c] - ds[ty + 16 * r]);
      __syncthreads();
      acc_tn<DM>(ak, ps, qs, ty, tx);     // dK += dS^T Q
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = c0 + ty + 16 * r;
    if (j >= dm.s) continue;
#pragma unroll
    for (int c = 0; c < DM / 16; ++c) {
      const int col = tx + 16 * c;
      if (col >= dm.d) continue;
      const long long at = koff + (long long)j * krs + col;
      dk[at] = from_f<T>(ak[r][c] * dm.scale);
      dv[at] = from_f<T>(av[r][c]);
    }
  }
}

// dQ of one query tile of one head
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dlt,
              T* __restrict__ dq, Dims dm) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* gs = qs + kT * (DM + 1);          // dO
  float* ks = gs + kT * (DM + 1);
  float* vs = ks + kT * (DM + 1);
  float* ss = vs + kT * (DM + 1);          // dS
  float* ls = ss + kT * (kT + 1);
  float* ds = ls + kT;
  const int nqb = (dm.s + kT - 1) / kT;
  const int qb = nqb - 1 - (int)blockIdx.x;   // the longest rows first
  const int hh = blockIdx.y, bb = blockIdx.z, kvh = hh / dm.rep;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r0 = qb * kT;
  const long long qrs = (long long)dm.h * dm.d, krs = (long long)dm.kv * dm.d;
  const long long qoff = (long long)bb * dm.s * qrs + (long long)hh * dm.d;
  const long long koff = (long long)bb * dm.s * krs + (long long)kvh * dm.d;
  const long long roff = ((long long)bb * dm.h + hh) * dm.s_pad;
  load_tile<T, DM>(qs, q + qoff, r0, dm.s, dm.d, qrs);
  load_tile<T, DM>(gs, dout + qoff, r0, dm.s, dm.d, qrs);
  load_rows(ls, ds, lse + roff, dlt + roff, r0, dm.s);
  float aq[4][DM / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DM / 16; ++c) aq[r][c] = 0.f;
  for (int kb = 0; kb <= qb; ++kb) {
    const int c0 = kb * kT;
    __syncthreads();
    load_tile<T, DM>(ks, k + koff, c0, dm.s, dm.d, krs);
    load_tile<T, DM>(vs, v + koff, c0, dm.s, dm.d, krs);
    __syncthreads();
    float p[4][4], dp[4][4];
    probs<DM>(p, qs, ks, ls, r0, c0, ty, tx, dm);
    dot_tile<DM>(dp, gs, vs, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ss[(ty + 16 * r) * (kT + 1) + tx + 16 * c] =
            p[r][c] * (dp[r][c] - ds[ty + 16 * r]);
    __syncthreads();
    // dQ += dS K: the inner dimension is the key tile's rows
#pragma unroll 2
    for (int j = 0; j < kT; ++j) {
      float sv[4], kv_[DM / 16];
#pragma unroll
      for (int r = 0; r < 4; ++r) sv[r] = ss[(ty + 16 * r) * (kT + 1) + j];
#pragma unroll
      for (int c = 0; c < DM / 16; ++c)
        kv_[c] = ks[j * (DM + 1) + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DM / 16; ++c)
          aq[r][c] = fmaf(sv[r], kv_[c], aq[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = r0 + ty + 16 * r;
    if (i >= dm.s) continue;
#pragma unroll
    for (int c = 0; c < DM / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < dm.d)
        dq[qoff + (long long)i * qrs + col] = from_f<T>(aq[r][c] * dm.scale);
    }
  }
}

template <int DM>
constexpr size_t main_bytes() {
  return sizeof(float) * (4 * kT * (DM + 1) + kT * (kT + 1) + 2 * kT);
}

template <typename T, int DM>
int launch_ffma(const void* q, const void* k, const void* v,
                const void* dout, void* dq, void* dk, void* dv,
                const float* lpad, const float* dpad, int b, const Dims& dm,
                cudaStream_t st) {
  const int nb = (dm.s + kT - 1) / kT;
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkdv<T, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)main_bytes<DM>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fa_bwd_dq<T, DM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)main_bytes<DM>());
  if (err != cudaSuccess) return (int)err;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *gt = static_cast<const T*>(dout);
  fa_bwd_dkdv<T, DM><<<dim3(nb, dm.kv, b), kThreads, main_bytes<DM>(), st>>>(
      qt, kt, vt, gt, lpad, dpad, static_cast<T*>(dk), static_cast<T*>(dv),
      dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dq<T, DM><<<dim3(nb, dm.h, b), kThreads, main_bytes<DM>(), st>>>(
      qt, kt, vt, gt, lpad, dpad, static_cast<T*>(dq), dm);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core route
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBT = 64;          // rows of every tile
constexpr int kBStages = 3;      // streamed tiles in the ring
constexpr int kBThreads = 128;   // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

template <int kD>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return kBT * kD * 2;           // one 64-row bf16 tile, in Panels<kD>
}

// K and V of the CTA's keys; a ring of Q and dO tiles; a ring of L and
// D (64 floats each); the ring's mbarriers and K and V's; slack to align
// the base to 1024 bytes (a swizzled tile's)
template <int kD>
constexpr int dkdv_smem() {
  return 2 * tile_bytes<kD>() + kBStages * (2 * tile_bytes<kD>() + 512) +
         8 * (kBStages + 1) + 1024;
}
// Q and dO of the CTA's rows; a ring of K and V tiles; mbarriers; slack
template <int kD>
constexpr int dq_smem() {
  return 2 * tile_bytes<kD>() + kBStages * 2 * tile_bytes<kD>() +
         8 * (kBStages + 1) + 1024;
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// Thread t of the warpgroup holds, in the fragment layout of a wgmma
// accumulator, rows r_a = 16(t / 32) + (t % 32) / 4 and r_a + 8 of the
// CTA's 64; register 4j + i is column 8j + 2(t % 4) + i % 2 of row r_a
// (i < 2) or r_a + 8 (i >= 2), across all kD columns.
template <int kD>
__global__ void __launch_bounds__(kBThreads, kD <= 96 ? 2 : 1)
fa_bwd_dkdv_tc(const __grid_constant__ Map mq, const __grid_constant__ Map mk,
               const __grid_constant__ Map mv, const __grid_constant__ Map mg,
               const float* __restrict__ lpad, const float* __restrict__ dpad,
               float* __restrict__ dkp, float* __restrict__ dvp, int s,
               int s_pad, int h, int rep, float scale_log2, float scale) {
  using P = Panels<kD>;
  constexpr uint32_t kTile = tile_bytes<kD>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_sm = base, v_sm = base + kTile;
  const uint32_t q_sm = base + 2 * kTile;            // kBStages x kTile
  const uint32_t g_sm = q_sm + kBStages * kTile;     // dO, kBStages x kTile
  const uint32_t ld_sm = g_sm + kBStages * kTile;    // kBStages x (L, D)
  const uint32_t bars = ld_sm + kBStages * 512;      // the ring's, then K/V
  const float* ld = reinterpret_cast<const float*>(smem_raw + (ld_sm - raw));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, bi = bh / h, hi = bh - bi * h, kvh = hi / rep;
  const int kt = blockIdx.y;          // key tile 0 walks the most tiles
  const int k0 = kt * kBT;
  const int tiles = s_pad / kBT - kt; // query tiles kt .. on
  const float* lrow = lpad + (long long)bh * s_pad;
  const float* drow = dpad + (long long)bh * s_pad;

  // one thread asks for each copy, a box a panel; rows past s arrive as
  // zeros
  auto load_q = [&](int t) {
    const int st = t % kBStages;
    const uint32_t bar = bars + 8 * st;
    const int r0 = (kt + t) * kBT;
    mbar_expect(bar, 2 * kTile + 512);
#pragma unroll
    for (int pn = 0; pn < P::kCount; ++pn) {
      tma_load(q_sm + st * kTile + pn * kBT * P::kRow, mq, bar,
               P::kCols * pn, r0, hi, bi);
      tma_load(g_sm + st * kTile + pn * kBT * P::kRow, mg, bar,
               P::kCols * pn, r0, hi, bi);
    }
    bulk_load(ld_sm + st * 512, lrow + r0, 256, bar);
    bulk_load(ld_sm + st * 512 + 256, drow + r0, 256, bar);
  };
  const uint32_t kv_bar = bars + 8 * kBStages;
  if (tid == 0) {
    for (int i = 0; i <= kBStages; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(kv_bar, 2 * kTile);
#pragma unroll
    for (int pn = 0; pn < P::kCount; ++pn) {
      tma_load(k_sm + pn * kBT * P::kRow, mk, kv_bar, P::kCols * pn, k0, kvh,
               bi);
      tma_load(v_sm + pn * kBT * P::kRow, mv, kv_bar, P::kCols * pn, k0, kvh,
               bi);
    }
    for (int t = 0; t < kBStages - 1 && t < tiles; ++t) load_q(t);
  }

  const int ra = 16 * warp + lane / 4, rb = ra + 8;  // key rows in the tile
  const int col_t = 2 * (lane % 4);
  float dk[kD / 2], dv[kD / 2];
  zero(dk);
  zero(dv);
  mbar_wait(kv_bar, 0);

  for (int t = 0; t < tiles; ++t) {
    // the warpgroup is done with tile t - 1, whose stage tile
    // t + kBStages - 1 takes
    __syncthreads();
    if (tid == 0 && t + kBStages - 1 < tiles) load_q(t + kBStages - 1);
    const int st = t % kBStages;
    mbar_wait(bars + 8 * st, (t / kBStages) & 1);
    const uint32_t qt = q_sm + st * kTile, gt = g_sm + st * kTile;
    const float* lt = ld + st * 128;            // L of the 64 queries
    const float* dt = lt + 64;                  // and their D

    // S^T = K Q^T: rows the CTA's keys, columns the tile's queries
    float sc[32];
    zero(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(sc, kdesc<kD>(k_sm, kBT, kk), kdesc<kD>(qt, kBT, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    pin(sc);

    // P^T = exp(S^T scale - L) of each query column; on the diagonal
    // tile (t = 0) a key after its query is selected to 0, never
    // multiplied; a padded query's L is +inf, so its P is 0
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * jj + col_t + e;
        const float l2 = lt[c] * kLog2e;
        float pa = exp2_approx(fmaf(sc[4 * jj + e], scale_log2, -l2));
        float pb = exp2_approx(fmaf(sc[4 * jj + 2 + e], scale_log2, -l2));
        if (t == 0) {
          if (ra > c) pa = 0.f;
          if (rb > c) pb = 0.f;
        }
        sc[4 * jj + e] = pa;
        sc[4 * jj + 2 + e] = pb;
      }
    uint32_t pf[4][4];
    to_a_frags(sc, pf);

    // dV += P^T dO and dP^T = V dO^T, issued together
    float dp[32];
    zero(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_rows<kD>(dv, pf[kk], gt, kBT, kk);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(dp, kdesc<kD>(v_sm, kBT, kk), kdesc<kD>(gt, kBT, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    pin(dp);
    pin(dv);

    // dS^T = P^T o (dP^T - D), then dK += dS^T Q
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dd = dt[8 * jj + col_t + e];
        dp[4 * jj + e] = sc[4 * jj + e] * (dp[4 * jj + e] - dd);
        dp[4 * jj + 2 + e] = sc[4 * jj + 2 + e] * (dp[4 * jj + 2 + e] - dd);
      }
    uint32_t sf[4][4];
    to_a_frags(dp, sf);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_rows<kD>(dk, sf[kk], qt, kBT, kk);
    wg_commit();
    wg_wait_all();
    pin(dk);
  }

  // this head's partials, (b, h, s, d) fp32
  float* kp = dkp + (long long)bh * s * kD;
  float* vp = dvp + (long long)bh * s * kD;
  const int row_a = k0 + ra, row_b = k0 + rb;
#pragma unroll
  for (int jj = 0; jj < kD / 8; ++jj) {
    const int col = 8 * jj + col_t;
    if (row_a < s) {
      const long long at = (long long)row_a * kD + col;
      *reinterpret_cast<float2*>(kp + at) =
          make_float2(dk[4 * jj] * scale, dk[4 * jj + 1] * scale);
      *reinterpret_cast<float2*>(vp + at) =
          make_float2(dv[4 * jj], dv[4 * jj + 1]);
    }
    if (row_b < s) {
      const long long at = (long long)row_b * kD + col;
      *reinterpret_cast<float2*>(kp + at) =
          make_float2(dk[4 * jj + 2] * scale, dk[4 * jj + 3] * scale);
      *reinterpret_cast<float2*>(vp + at) =
          make_float2(dv[4 * jj + 2], dv[4 * jj + 3]);
    }
  }
}

// dK, dV (b, s, kv, d) bf16, four elements a thread: each the sum over
// the rep query heads of its group, in order, of the partials
// (b, h, s, d)
__global__ void fa_bwd_sum(const float* __restrict__ dkp,
                           const float* __restrict__ dvp, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, long long quads, int s,
                           int h, int kv, int d) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= quads) return;
  const long long at = 4 * e;
  const int c = (int)(at % d);
  const long long row = at / d;                 // (bi, i, kvh)
  const int kvh = (int)(row % kv);
  const long long bs = row / kv;                // bi * s + i
  const long long bi = bs / s, i = bs - bi * s;
  const int rep = h / kv;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int g = 0; g < rep; ++g) {
    const long long src = ((bi * h + kvh * rep + g) * s + i) * d + c;
    const float4 a = *reinterpret_cast<const float4*>(dkp + src);
    const float4 w = *reinterpret_cast<const float4*>(dvp + src);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += w.x; sv.y += w.y; sv.z += w.z; sv.w += w.w;
  }
  __nv_bfloat162* kq = reinterpret_cast<__nv_bfloat162*>(dk + at);
  __nv_bfloat162* vq = reinterpret_cast<__nv_bfloat162*>(dv + at);
  kq[0] = __floats2bfloat162_rn(sk.x, sk.y);
  kq[1] = __floats2bfloat162_rn(sk.z, sk.w);
  vq[0] = __floats2bfloat162_rn(sv.x, sv.y);
  vq[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

template <int kD>
__global__ void __launch_bounds__(kBThreads, kD <= 96 ? 2 : 1)
fa_bwd_dq_tc(const __grid_constant__ Map mq, const __grid_constant__ Map mk,
             const __grid_constant__ Map mv, const __grid_constant__ Map mg,
             const float* __restrict__ lpad, const float* __restrict__ dpad,
             bf16* __restrict__ dq, int s, int s_pad, int h, int rep,
             float scale_log2, float scale) {
  using P = Panels<kD>;
  constexpr uint32_t kTile = tile_bytes<kD>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_sm = base, g_sm = base + kTile;
  const uint32_t k_sm = base + 2 * kTile;            // kBStages x kTile
  const uint32_t v_sm = k_sm + kBStages * kTile;     // kBStages x kTile
  const uint32_t bars = v_sm + kBStages * kTile;     // the ring's, then Q's

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, bi = bh / h, hi = bh - bi * h, kvh = hi / rep;
  // the longest rows (most key tiles) are scheduled first
  const int qt = (int)(gridDim.y - 1 - blockIdx.y);
  const int q0 = qt * kBT;
  const int tiles = qt + 1;                          // key tiles 0 .. qt

  auto load_kv = [&](int j) {
    const int st = j % kBStages;
    const uint32_t bar = bars + 8 * st;
    mbar_expect(bar, 2 * kTile);
#pragma unroll
    for (int pn = 0; pn < P::kCount; ++pn) {
      tma_load(k_sm + st * kTile + pn * kBT * P::kRow, mk, bar,
               P::kCols * pn, j * kBT, kvh, bi);
      tma_load(v_sm + st * kTile + pn * kBT * P::kRow, mv, bar,
               P::kCols * pn, j * kBT, kvh, bi);
    }
  };
  const uint32_t q_bar = bars + 8 * kBStages;
  if (tid == 0) {
    for (int i = 0; i <= kBStages; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(q_bar, 2 * kTile);
#pragma unroll
    for (int pn = 0; pn < P::kCount; ++pn) {
      tma_load(q_sm + pn * kBT * P::kRow, mq, q_bar, P::kCols * pn, q0, hi,
               bi);
      tma_load(g_sm + pn * kBT * P::kRow, mg, q_bar, P::kCols * pn, q0, hi,
               bi);
    }
    for (int j = 0; j < kBStages - 1 && j < tiles; ++j) load_kv(j);
  }

  const int row_a = q0 + 16 * warp + lane / 4, row_b = row_a + 8;
  const int col_t = 2 * (lane % 4);
  // L (+inf past s: P = 0) and D of the thread's two rows
  const float* lrow = lpad + (long long)bh * s_pad;
  const float* drow = dpad + (long long)bh * s_pad;
  const float l2a = lrow[row_a] * kLog2e, l2b = lrow[row_b] * kLog2e;
  const float da = drow[row_a], db = drow[row_b];
  float acc[kD / 2];
  zero(acc);
  mbar_wait(q_bar, 0);

  for (int j = 0; j < tiles; ++j) {
    __syncthreads();
    if (tid == 0 && j + kBStages - 1 < tiles) load_kv(j + kBStages - 1);
    const int st = j % kBStages;
    mbar_wait(bars + 8 * st, (j / kBStages) & 1);
    const uint32_t kt = k_sm + st * kTile, vt = v_sm + st * kTile;

    // S = Q K^T and dP = dO V^T, issued together
    float sc[32], dp[32];
    zero(sc);
    zero(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(sc, kdesc<kD>(q_sm, kBT, kk), kdesc<kD>(kt, kBT, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(dp, kdesc<kD>(g_sm, kBT, kk), kdesc<kD>(vt, kBT, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    pin(sc);
    pin(dp);

    // dS = P o (dP - D), P = exp(S scale - L); on the diagonal tile a
    // key after the row is selected to 0
    const bool diag = j == qt;
    const int k0 = j * kBT;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * jj + col_t + e;
        float pa = exp2_approx(fmaf(sc[4 * jj + e], scale_log2, -l2a));
        float pb = exp2_approx(fmaf(sc[4 * jj + 2 + e], scale_log2, -l2b));
        if (diag) {
          if (col > row_a) pa = 0.f;
          if (col > row_b) pb = 0.f;
        }
        dp[4 * jj + e] = pa * (dp[4 * jj + e] - da);
        dp[4 * jj + 2 + e] = pb * (dp[4 * jj + 2 + e] - db);
      }
    uint32_t sf[4][4];
    to_a_frags(dp, sf);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_rows<kD>(acc, sf[kk], kt, kBT, kk);
    wg_commit();
    wg_wait_all();
    pin(acc);
  }

  // dq (b, s, h, d) contiguous
#pragma unroll
  for (int jj = 0; jj < kD / 8; ++jj) {
    const int col = 8 * jj + col_t;
    if (row_a < s)
      *reinterpret_cast<__nv_bfloat162*>(
          dq + (((long long)bi * s + row_a) * h + hi) * kD + col) =
          __floats2bfloat162_rn(acc[4 * jj] * scale,
                                acc[4 * jj + 1] * scale);
    if (row_b < s)
      *reinterpret_cast<__nv_bfloat162*>(
          dq + (((long long)bi * s + row_b) * h + hi) * kD + col) =
          __floats2bfloat162_rn(acc[4 * jj + 2] * scale,
                                acc[4 * jj + 3] * scale);
  }
}

template <int kD>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              void* dq, void* dk, void* dv, const float* lpad,
              const float* dpad, float* dkp, float* dvp, int b, int s,
              int s_pad, int h, int kv, cudaStream_t st) {
  // contiguous (b, s, heads, kD): (batch, sequence, head) strides
  const Strides qs{(long long)s * h * kD, (long long)h * kD, kD},
      ks{(long long)s * kv * kD, (long long)kv * kD, kD};
  Map mq, mk, mv, mg;
  if (!make_map<kD>(&mq, q, b, s, h, qs, kBT) ||
      !make_map<kD>(&mg, dout, b, s, h, qs, kBT) ||
      !make_map<kD>(&mk, k, b, s, kv, ks, kBT) ||
      !make_map<kD>(&mv, v, b, s, kv, ks, kBT))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkdv_tc<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkdv_smem<kD>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fa_bwd_dq_tc<kD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_smem<kD>());
  if (err != cudaSuccess) return (int)err;
  // the scale of the head dim itself, 1 / sqrt(kD), not of a panel's
  const float scale = 1.0f / sqrtf((float)kD), scale_log2 = scale * kLog2e;
  const dim3 grid(b * h, s_pad / kBT);
  fa_bwd_dkdv_tc<kD><<<grid, kBThreads, dkdv_smem<kD>(), st>>>(
      mq, mk, mv, mg, lpad, dpad, dkp, dvp, s, s_pad, h, h / kv, scale_log2,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dq_tc<kD><<<grid, kBThreads, dq_smem<kD>(), st>>>(
      mq, mk, mv, mg, lpad, dpad, static_cast<bf16*>(dq), s, s_pad, h,
      h / kv, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the partials (b, h, s, kD) in quads of the true kD (a multiple of 4)
  const long long quads = (long long)b * s * kv * kD / 4;
  fa_bwd_sum<<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(
      dkp, dvp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), quads, s, h,
      kv, kD);
  return (int)cudaGetLastError();
}

}  // namespace tc

namespace {

template <typename T>
int launch_pre(const void* o, const void* dout, const void* lse,
               float* lpad, float* dpad, int b, int s, int s_pad, int h,
               int d, cudaStream_t st) {
  const long long rows = (long long)b * h * s_pad;
  fa_bwd_pre<T><<<(unsigned)((rows + kPreWarps - 1) / kPreWarps),
                  32 * kPreWarps, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<const float*>(lse), lpad, dpad, rows, s, s_pad, h, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ffma_dispatch(const void* q, const void* k, const void* v,
                         const void* dout, void* dq, void* dk, void* dv,
                         const float* lpad, const float* dpad, int b,
                         const Dims& dm, cudaStream_t st) {
  if (dm.d <= 64)
    return launch_ffma<T, 64>(q, k, v, dout, dq, dk, dv, lpad, dpad, b, dm,
                              st);
  return launch_ffma<T, 128>(q, k, v, dout, dq, dk, dv, lpad, dpad, b, dm,
                             st);
}

}  // namespace

extern "C" {

// q, o, dout, dq (b, s, h, d) and k, v, dk, dv (b, s, kv, d), all
// contiguous, all fp32 (dtype 0) or all bf16 (dtype 1); lse the
// forward's fp32 (b, h, s); lpad and dpad fp32 scratch of b * h * s_pad
// floats, s_pad = s rounded up to a multiple of 64; h a multiple of kv,
// 1 <= d <= 128. tc = 1 takes the tensor-core route (bf16, d = 64, 96
// or 128, every base on 16 bytes), which also needs dkp and dvp, fp32
// scratch of b * h * s * d floats each; tc = 0 the FFMA route (dkp and
// dvp unused). Returns cudaErrorInvalidValue for a shape it cannot
// take, else cudaGetLastError() after the launches.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* dq, void* dk, void* dv,
                               void* lpad, void* dpad, void* dkp, void* dvp,
                               int b, int s, int h, int kv, int d, int dtype,
                               int tc, void* stream) {
  if (b < 1 || s < 1 || kv < 1 || h % kv != 0 || d < 1 || d > 128 ||
      dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (tc && (dtype != 1 || (d != 64 && d != 96 && d != 128)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int s_pad = (s + kT - 1) / kT * kT;
  float *lp = static_cast<float*>(lpad), *dp = static_cast<float*>(dpad);
  int err = dtype == 0
                ? launch_pre<float>(o, dout, lse, lp, dp, b, s, s_pad, h, d, st)
                : launch_pre<__nv_bfloat16>(o, dout, lse, lp, dp, b, s, s_pad,
                                            h, d, st);
  if (err != 0) return err;
  if (tc) {
    float *kp = static_cast<float*>(dkp), *vp = static_cast<float*>(dvp);
    if (d == 64)
      return tc::launch_tc<64>(q, k, v, dout, dq, dk, dv, lp, dp, kp, vp, b,
                               s, s_pad, h, kv, st);
    if (d == 96)
      return tc::launch_tc<96>(q, k, v, dout, dq, dk, dv, lp, dp, kp, vp, b,
                               s, s_pad, h, kv, st);
    if (d == 128)
      return tc::launch_tc<128>(q, k, v, dout, dq, dk, dv, lp, dp, kp, vp, b,
                                s, s_pad, h, kv, st);
    return (int)cudaErrorInvalidValue;
  }
  const Dims dm{s, s_pad, h, kv, d, h / kv, 1.0f / sqrtf((float)d)};
  if (dtype == 0)
    return launch_ffma_dispatch<float>(q, k, v, dout, dq, dk, dv, lp, dp, b,
                                       dm, st);
  return launch_ffma_dispatch<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, lp,
                                             dp, b, dm, st);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
