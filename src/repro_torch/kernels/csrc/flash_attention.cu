// Causal softmax attention with an online softmax, for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py
// (flash_attention -> _flash_kernel). For queries q (B, S, H, D) and
// keys and values k, v (B, S, KV, D), fp32 or bf16, it writes
// out[b, i, h] = sum_{j <= i} softmax_j(q_i . k_j / sqrt(D)) v_j in q's
// type, with the scores, the running max, the denominator and the
// accumulator in fp32. Query head h reads kv head h / (H / KV), so
// grouped-query attention needs no broadcast copy (H = KV is the
// reference's MHA contract). Each tensor is read through its own
// (batch, sequence, head) strides with D contiguous, so the model's
// (B, S, H, D) layout and the entry point's (B, H, S, D) both go in
// without a transpose. Any S is taken: rows and keys past S are zeros
// or bounds checks (the reference needs S divisible by its blocks).
//
// Two kernels; the wrapper picks one by dtype and head dim alone
// (kernels/flash_attention.py, route_for):
//
// tc::fa_tc_kernel, bf16 with D = 64, 96 or 128: the tensor cores. One
//   CTA per (b*h, 128 query rows), two warpgroups of 64 rows each. Q, K
//   and V stay bf16 in shared memory in the swizzled layout that wgmma
//   descriptors read (tc_common.cuh, Panels): at D 64 and 128 64-column
//   panels of 128-byte rows, 16-byte chunk c of row r at c ^ (r % 8); at
//   D 96 (MLA's q.k) three 32-column panels of 64-byte rows, chunk c of
//   row r at c ^ (r / 2 % 4), so no column is padding. One thread asks
//   the tensor memory accelerator (TMA) for each tile through tensor
//   maps built on the host over the tensors' own strides
//   (cuTensorMapEncodeTiled, reached through the runtime), a box a
//   panel; rows past S arrive as zeros, and each copy reports to an
//   mbarrier, so the copies take no instruction slots from the softmax
//   (copies made by every thread did not overlap it). 64-key tiles of K
//   and V fill a three-stage ring: tiles j + 1 and j + 2 are in flight
//   while tile j is computed, and one block barrier a tile frees the
//   stage tile j + 2 takes. S = Q K^T is wgmma m64n64k16, D / 16
//   k-steps, with both operands in shared memory (K-major) and fp32
//   accumulators in registers. The online softmax works on the
//   accumulator fragments (a thread holds two rows, a row lives in a
//   quad, so row max and sum take two shuffles), in the log2 domain
//   with ex2. P is rounded to bf16 in registers, where the accumulator
//   layout of S is already the A-operand layout of the next wgmma (as
//   in FlashAttention-3), and O += P V is wgmma with A from registers
//   and V read MN-major (transposed B) from shared memory: one m64n64
//   product per 64-column panel of D, or at D 96 one m64n96 product
//   across the three 32-column panels (48 accumulators a thread).
//   Rounding P to bf16 is the one rounding the reference does not take
//   (it widens p and v to fp32); SDPA takes the same one.
//
// simt::fa_kernel, fp32 (the strict parity route: the tensor cores have
//   no IEEE fp32 mode) and bf16 at other head dims: one CTA of 256
//   threads per (b*h, 64 queries); the query block is staged once in
//   shared memory and 64-key blocks of K and V are streamed through it.
//   Thread (ty, tx) of a 16 x 16 grid holds scores of rows ty + 16i and
//   keys tx + 16j (i, j < 4) and the output columns tx + 16c of its
//   rows; the running max and denominator of a row live in the 16
//   threads that share it and meet by shuffles. Probabilities go
//   through shared memory into the P.V product. All products are fp32
//   FFMA, bf16 widened as it is staged.
//
// Both write, where the caller passes an lse buffer (the training
// forward; serving passes null and the kernels do what they did
// without it), each row's logsumexp of its scaled scores,
// L_i = log sum_{j <= i} exp(q_i . k_j / sqrt(D)), in natural-log units
// on both routes (the tc kernel's running max and sum are in log2
// units and are converted), so csrc/flash_attention_bwd.cu rebuilds P
// as exp(S / sqrt(D) - L) without a pass over the keys of its own.
//
// Both: kv tiles above the diagonal are never loaded and only tiles
// that cross it are masked; the longest rows (most kv tiles) are
// scheduled first; query heads of one kv group have neighbouring
// blockIdx.x, so their K and V tiles come from L2. Masked scores are
// selected to -inf and their probabilities are 0, and a row whose tile
// is all masked keeps alpha = 0, never exp(-inf - -inf).
//
// Bound on the card: at hymba-1.5b's prefill (B = 2, S = 2048, H = 25,
// KV = 5, D = 64, bf16) the causal half of QK^T and P.V is 26.9 GFLOP,
// 0.027 ms on the bf16 tensor cores and 0.40 ms in fp32 FFMA, against
// 31.5 MB of q, k, v and out (0.009 ms): the work is bound by
// operations. The tc kernel leaves the tensor cores idle while a
// warpgroup does its softmax; two CTAs an SM at D = 64 and 96 (98 KB of
// shared memory each at 96) let one CTA's products overlap the other's
// softmax; D = 128 takes one.
#include <math.h>

#include "tc_common.cuh"

namespace simt {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per streamed block
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLdP = kBK + 4;  // shared row stride of the probabilities

using Strides = tc::Strides;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// kRows x kD tile of rows row0.. of one head into dst (row stride
// kD + 4), zero outside [0, s) x [0, d); neighbouring threads read
// neighbouring elements of a row
template <typename T, int kD, int kRows>
__device__ __forceinline__ void stage(const T* __restrict__ src,
                                      long long row_stride, int row0, int s,
                                      int d, float* __restrict__ dst) {
  constexpr int ld = kD + 4;
  for (int e = threadIdx.x; e < kRows * kD; e += kThreads) {
    const int r = e / kD, c = e % kD;
    const int gr = row0 + r;
    dst[r * ld + c] = (gr < s && c < d)
                          ? widen(src[(long long)gr * row_stride + c])
                          : 0.0f;
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out,
          float* __restrict__ lse, int s, int h, int rep, int d, Strides qs,
          Strides ks, Strides vs, Strides os, float scale) {
  constexpr int ld = kD + 4;
  constexpr int kCols = kD / 16;            // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qsm = smem;                        // [kBQ][ld]
  float* ksm = qsm + kBQ * ld;              // [kBK][ld]
  float* vsm = ksm + kBK * ld;              // [kBK][ld]
  float* psm = vsm + kBK * ld;              // [kBQ][kLdP]

  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh - bi * h, kvh = hi / rep;
  // the longest rows (most kv blocks) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;

  const T* qp = q + bi * qs.b + hi * qs.h;
  const T* kp = k + bi * ks.b + kvh * ks.h;
  const T* vp = v + bi * vs.b + kvh * vs.h;
  stage<T, kD, kBQ>(qp, qs.s, q0, s, d, qsm);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int last = min(q0 + kBQ - 1, s - 1);  // the block's last key
  for (int k0 = 0; k0 <= last; k0 += kBK) {
    __syncthreads();                        // k, v and p of the last block read
    stage<T, kD, kBK>(kp, ks.s, k0, s, d, ksm);
    stage<T, kD, kBK>(vp, vs.s, k0, s, d, vsm);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < kD; c += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&qsm[(ty + 16 * i) * ld + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(&ksm[(tx + 16 * j) * ld + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float acc_ij = sc[i][j];
          acc_ij = fmaf(a[i].x, b[j].x, acc_ij);
          acc_ij = fmaf(a[i].y, b[j].y, acc_ij);
          acc_ij = fmaf(a[i].z, b[j].z, acc_ij);
          sc[i][j] = fmaf(a[i].w, b[j].w, acc_ij);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        // select, never multiply: masked scores are -inf
        sc[i][j] = (col <= row && col < s) ? sc[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = m[i] == -INFINITY ? 0.0f : expf(m[i] - m_safe);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = sc[i][j] == -INFINITY ? 0.0f : expf(sc[i][j] - m_safe);
        psm[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                        // p complete

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(&psm[(ty + 16 * i) * kLdP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) vv[c] = vsm[(kk + u) * ld + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pi = u == 0 ? p[i].x : u == 1 ? p[i].y : u == 2 ? p[i].z
                                                                       : p[i].w;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pi, vv[c], acc[i][c]);
        }
      }
    }
  }

  T* op = out + bi * os.b + hi * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
    const float den = fmaxf(l[i], 1e-30f);
    // the row's logsumexp of the scaled scores, for the backward
    if (lse != nullptr && tx == 0)
      lse[(long long)bh * s + row] = m[i] + logf(den);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) put(op + (long long)row * os.s + col, acc[i][c] / den);
    }
  }
}

template <int kD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBQ + 2 * kBK) * (kD + 4) + kBQ * kLdP);
}

template <typename T, int kD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int s, int h, int kv, int d, Strides qs,
           Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * h, (s + kBQ - 1) / kBQ);
  fa_kernel<T, kD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, s, h, h / kv, d,
      qs, ks, vs, os, 1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int b, int s, int h, int kv, int d, Strides qs,
             Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  if (d <= 16) return launch<T, 16>(q, k, v, out, lse, b, s, h, kv, d, qs, ks, vs, os, stream);
  if (d <= 32) return launch<T, 32>(q, k, v, out, lse, b, s, h, kv, d, qs, ks, vs, os, stream);
  if (d <= 64) return launch<T, 64>(q, k, v, out, lse, b, s, h, kv, d, qs, ks, vs, os, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, out, lse, b, s, h, kv, d, qs, ks, vs, os, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace simt


namespace tc {

constexpr int kRows = 128;     // query rows per CTA: two warpgroups of 64
constexpr int kKeys = 64;      // keys per streamed tile
constexpr int kStages = 3;     // K and V tiles in the ring
constexpr int kThreads = 256;

template <int kD>
constexpr int smem_bytes() {
  // Q (kRows rows) and a ring of kStages K and V tiles, all bf16; the
  // ring's and Q's mbarriers; slack to align the base to 1024 bytes
  return (kRows + 2 * kStages * kKeys) * kD * 2 + 8 * (kStages + 1) + 1024;
}

// Thread t of warpgroup g holds, in the fragment layout of a wgmma
// accumulator, rows r_a = 64g + 16(t / 32) + (t % 32) / 4 and r_a + 8;
// register 4j + i of a 64-column block is column 8j + 2(t % 4) + i % 2
// of row r_a (i < 2) or r_a + 8 (i >= 2).
template <int kD>
__global__ void __launch_bounds__(kThreads, kD <= 96 ? 2 : 1)
fa_tc_kernel(const __grid_constant__ Map mq, const __grid_constant__ Map mk,
             const __grid_constant__ Map mv, bf16* __restrict__ out,
             float* __restrict__ lse, int s, int h, int rep, Strides os,
             float scale_log2) {
  using P = Panels<kD>;
  constexpr uint32_t kTile = kKeys * kD * 2;     // bytes of one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_sm = base;                    // panels of [kRows][kRow]
  const uint32_t k_sm = q_sm + kRows * kD * 2;   // kStages x kTile
  const uint32_t v_sm = k_sm + kStages * kTile;  // kStages x kTile
  const uint32_t bars = v_sm + kStages * kTile;  // kStages tiles, then Q

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32,
            lane = tid % 32;
  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh - bi * h, kvh = hi / rep;
  // the longest rows (most kv tiles) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int last = min(q0 + kRows, s) - 1;       // the CTA's last key
  const int tiles = last / kKeys + 1;

  // one thread asks for each copy, a box a panel; rows past s arrive as
  // zeros, and the boxes cover the tile exactly, so the bytes expected
  // are the tile's
  auto load_kv = [&](int j) {
    const uint32_t stage = (j % kStages) * kTile;
    const uint32_t bar = bars + 8 * (j % kStages);
    mbar_expect(bar, 2 * kTile);
#pragma unroll
    for (int pn = 0; pn < P::kCount; ++pn) {
      tma_load(k_sm + stage + pn * kKeys * P::kRow, mk, bar, P::kCols * pn,
               j * kKeys, kvh, bi);
      tma_load(v_sm + stage + pn * kKeys * P::kRow, mv, bar, P::kCols * pn,
               j * kKeys, kvh, bi);
    }
  };
  const uint32_t q_bar = bars + 8 * kStages;
  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(q_bar, kRows * kD * 2);
#pragma unroll
    for (int pn = 0; pn < P::kCount; ++pn)
      tma_load(q_sm + pn * kRows * P::kRow, mq, q_bar, P::kCols * pn, q0, hi,
               bi);
    for (int j = 0; j < kStages - 1 && j < tiles; ++j) load_kv(j);
  }

  const int r0 = q0 + 64 * wg;                   // the warpgroup's rows
  const int wg_last = r0 < s ? min(r0 + 63, s - 1) : -1;
  const int row_a = r0 + 16 * warp + lane / 4, row_b = row_a + 8;
  const int col_t = 2 * (lane % 4);
  const uint32_t q_wg = q_sm + 64 * wg * P::kRow;

  // the output's accumulators: register 4j + i is column 8j + col_t + i % 2
  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;
  mbar_wait(q_bar, 0);

  for (int j = 0; j < tiles; ++j) {
    // every warpgroup is done with tile j - 1, whose stage tile
    // j + kStages - 1 takes
    __syncthreads();
    if (tid == 0 && j + kStages - 1 < tiles) load_kv(j + kStages - 1);
    mbar_wait(bars + 8 * (j % kStages), (j / kStages) & 1);

    const int k0 = j * kKeys;
    if (k0 <= wg_last) {                         // uniform in the warpgroup
      const uint32_t kt = k_sm + (j % kStages) * kTile;
      const uint32_t vt = v_sm + (j % kStages) * kTile;
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)      // 16 columns a step
        wgmma_ss(sc, kdesc<kD>(q_wg, kRows, kk), kdesc<kD>(kt, kKeys, kk),
                 kk > 0);
      wg_commit();
      wg_wait_all();
      pin(sc);

      // mask the tile that crosses the diagonal; row max over the quad
      const bool diag = k0 + kKeys - 1 > r0;
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = k0 + 8 * jj + col_t;
        if (diag) {
          // select, never multiply: masked scores are -inf
          if (col > row_a) sc[4 * jj] = -INFINITY;
          if (col + 1 > row_a) sc[4 * jj + 1] = -INFINITY;
          if (col > row_b) sc[4 * jj + 2] = -INFINITY;
          if (col + 1 > row_b) sc[4 * jj + 3] = -INFINITY;
        }
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * jj], sc[4 * jj + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * jj + 2], sc[4 * jj + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      // a row with no live key yet keeps its exponents at -inf: p = 0
      const float ms_a = mn_a == -INFINITY ? 0.0f : mn_a * scale_log2;
      const float ms_b = mn_b == -INFINITY ? 0.0f : mn_b * scale_log2;
      const float al_a =
          m_a == -INFINITY ? 0.0f : exp2_approx(m_a * scale_log2 - ms_a);
      const float al_b =
          m_b == -INFINITY ? 0.0f : exp2_approx(m_b * scale_log2 - ms_b);
      m_a = mn_a;
      m_b = mn_b;
      float rs_a = 0.0f, rs_b = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        sc[4 * jj] = exp2_approx(fmaf(sc[4 * jj], scale_log2, -ms_a));
        sc[4 * jj + 1] = exp2_approx(fmaf(sc[4 * jj + 1], scale_log2, -ms_a));
        sc[4 * jj + 2] = exp2_approx(fmaf(sc[4 * jj + 2], scale_log2, -ms_b));
        sc[4 * jj + 3] = exp2_approx(fmaf(sc[4 * jj + 3], scale_log2, -ms_b));
        rs_a += sc[4 * jj] + sc[4 * jj + 1];
        rs_b += sc[4 * jj + 2] + sc[4 * jj + 3];
      }
      // the quad's partial sums meet once, at the end
      l_a = l_a * al_a + rs_a;
      l_b = l_b * al_b + rs_b;
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) o[i] *= i % 4 < 2 ? al_a : al_b;

      // P in bf16: the accumulator fragment of keys 16kk .. 16kk + 15 is
      // the A fragment of k-step kk
      uint32_t pa[4][4];
      to_a_frags(sc, pa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)     // 16 keys (rows of V) a step
        wgmma_rs_rows<kD>(o, pa[kk], vt, kKeys, kk);
      wg_commit();
      wg_wait_all();
      pin(o);
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  bf16* op = out + bi * os.b + hi * os.h;
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  // each row's logsumexp of the scaled scores, for the backward, in
  // natural-log units as the FFMA kernel writes it: the running max and
  // sum are in log2 units (ex2), so L = (m scale_log2 + log2 l) ln 2
  if (lse != nullptr && lane % 4 == 0) {
    float* lp = lse + (long long)bh * s;
    if (row_a < s)
      lp[row_a] = fmaf(m_a, scale_log2, log2f(fmaxf(l_a, 1e-30f))) *
                  0.6931471805599453f;
    if (row_b < s)
      lp[row_b] = fmaf(m_b, scale_log2, log2f(fmaxf(l_b, 1e-30f))) *
                  0.6931471805599453f;
  }
#pragma unroll
  for (int jj = 0; jj < kD / 8; ++jj) {
    const int col = 8 * jj + col_t;
    if (row_a < s)
      *reinterpret_cast<__nv_bfloat162*>(op + (long long)row_a * os.s + col) =
          __floats2bfloat162_rn(o[4 * jj] * inv_a, o[4 * jj + 1] * inv_a);
    if (row_b < s)
      *reinterpret_cast<__nv_bfloat162*>(op + (long long)row_b * os.s + col) =
          __floats2bfloat162_rn(o[4 * jj + 2] * inv_b,
                                o[4 * jj + 3] * inv_b);
  }
}

template <int kD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int s, int h, int kv, Strides qs, Strides ks,
           Strides vs, Strides os, cudaStream_t stream) {
  Map mq, mk, mv;
  if (!make_map<kD>(&mq, q, b, s, h, qs, kRows) ||
      !make_map<kD>(&mk, k, b, s, kv, ks, kKeys) ||
      !make_map<kD>(&mv, v, b, s, kv, vs, kKeys))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_tc_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * h, (s + kRows - 1) / kRows);
  // the scale of the head dim itself, 1 / sqrt(kD), not of a panel's
  fa_tc_kernel<kD><<<grid, kThreads, bytes, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), lse, s, h, h / kv, os,
      1.4426950408889634f / sqrtf((float)(kD)));
  return (int)cudaGetLastError();
}

}  // namespace tc

extern "C" {

// q (b, s, h, d), k and v (b, s, kv, d) and out (b, s, h, d) through
// (batch, sequence, head) element strides, D contiguous; all fp32
// (dtype 0) or all bf16 (dtype 1); h a multiple of kv, 1 <= d <= 128.
// lse: null, or fp32 (b, h, s) contiguous, where each row's logsumexp
// of its scaled scores goes (the training forward's; serving passes
// null). The FFMA kernel. Returns cudaGetLastError() after the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, void* lse, int b, int s, int h, int kv,
                           int d,
                           long long q_sb, long long q_ss, long long q_sh,
                           long long k_sb, long long k_ss, long long k_sh,
                           long long v_sb, long long v_ss, long long v_sh,
                           long long o_sb, long long o_ss, long long o_sh,
                           int dtype, void* stream) {
  if (b < 1 || s < 1 || kv < 1 || h % kv != 0 || d < 1)
    return (int)cudaErrorInvalidValue;
  using simt::Strides;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return simt::dispatch<float>(q, k, v, out, static_cast<float*>(lse), b,
                                 s, h, kv, d, qs, ks, vs, os, st);
  if (dtype == 1)
    return simt::dispatch<__nv_bfloat16>(q, k, v, out,
                                         static_cast<float*>(lse), b, s, h,
                                         kv, d, qs, ks, vs, os, st);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernel: as flash_attention_launch, bf16 only, d = 64,
// 96 or 128 (any other d returns cudaErrorInvalidValue), every base and
// stride a multiple of 16 bytes (the wrapper checks). Returns
// cudaGetLastError() after the launch.
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              void* out, void* lse, int b, int s, int h,
                              int kv, int d,
                              long long q_sb, long long q_ss, long long q_sh,
                              long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh,
                              long long o_sb, long long o_ss, long long o_sh,
                              void* stream) {
  if (b < 1 || s < 1 || kv < 1 || h % kv != 0)
    return (int)cudaErrorInvalidValue;
  const tc::Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lf = static_cast<float*>(lse);
  if (d == 64)
    return tc::launch<64>(q, k, v, out, lf, b, s, h, kv, qs, ks, vs, os, st);
  if (d == 96)
    return tc::launch<96>(q, k, v, out, lf, b, s, h, kv, qs, ks, vs, os, st);
  if (d == 128)
    return tc::launch<128>(q, k, v, out, lf, b, s, h, kv, qs, ks, vs, os,
                           st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
