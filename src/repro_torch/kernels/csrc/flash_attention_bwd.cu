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
// head hh reads kv head hh / (h / kv). scale = 1 / sqrt(d). With
// P = softmax(scale q k^T) over keys j <= i:
//
//     dV = P^T dO            dP = dO V^T
//     dS = P o (dP - D)      D_i = sum_d dO_id O_id
//     dQ = scale dS K        dK = scale dS^T Q
//
// dK and dV of a kv head sum over the h / kv query heads of its group.
//
// Three kernels, in order on the caller's stream:
//   1. fa_bwd_pre, a block a (query tile, head, batch): recomputes each
//      row's logsumexp L_i over keys <= i (online max and sum over the
//      key tiles) and D_i, into fp32 scratch (b, h, s). The forward
//      kernel is not changed to save L.
//   2. fa_bwd_dkdv, a block a (key tile, kv head, batch): owns its 64
//      rows of dK and dV in registers and loops over the query heads of
//      the group in order, and for each over the query tiles on or
//      below the diagonal. So the group's sum is taken inside the
//      block, in a fixed order, with no atomics: two calls give the
//      same bits.
//   3. fa_bwd_dq, a block a (query tile, head, batch): owns its 64 rows
//      of dQ and loops over the key tiles on or below the diagonal.
// Tiles are 64 rows; 256 threads (ty, tx) of 16 x 16 each hold a 4 x 4
// piece (rows ty + 16 r, columns tx + 16 c) of a 64 x 64 score tile and
// 4 rows of an accumulator (columns tx + 16 c). Operands are widened to
// fp32 in shared memory (rows padded by one float, so the 16 columns a
// half-warp reads fall in 16 banks); products are fp32 FFMA, sums fp32,
// grads written in the inputs' dtype. Tensor cores are later work.
//
// Bound on the card: at hymba-1.5b (b 2, s 2048, 25 / 5 heads of 64) the
// five products a backward needs at least (S again, dV, dP, dQ, dK) are
// 2.5 times the forward's 2.68e10 flops, 6.7e10, at the bf16 tensor-core
// peak; this first version recomputes S three times and runs in FFMA.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

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

struct Dims {
  int s, h, kv, d, rep;
  float scale;
};

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

// the half-warp of 16 tx lanes that shares a ty
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// 1. logsumexp and D of every query row
// ---------------------------------------------------------------------------
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_pre(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ lse, float* __restrict__ dlt, Dims dm) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kT * (DM + 1);
  const int qb = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int kvh = hh / dm.rep, r0 = qb * kT;
  const long long qrs = (long long)dm.h * dm.d, krs = (long long)dm.kv * dm.d;
  const T* qbase = q + (long long)bb * dm.s * qrs + (long long)hh * dm.d;
  const T* kbase = k + (long long)bb * dm.s * krs + (long long)kvh * dm.d;
  load_tile<T, DM>(qs, qbase, r0, dm.s, dm.d, qrs);
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  for (int kb = 0; kb <= qb; ++kb) {
    __syncthreads();
    load_tile<T, DM>(ks, kbase, kb * kT, dm.s, dm.d, krs);
    __syncthreads();
    float sc[4][4];
    dot_tile<DM>(sc, qs, ks, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = r0 + ty + 16 * r;
      float mt = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = kb * kT + tx + 16 * c;
        sc[r][c] = (i < dm.s && j <= i) ? sc[r][c] * dm.scale : -INFINITY;
        mt = fmaxf(mt, sc[r][c]);
      }
      const float mn = fmaxf(m[r], row_max(mt));
      // a row past s stays at -inf; every lane of the warp goes on to
      // the shuffle
      const float base = mn == -INFINITY ? 0.f : mn;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sum += sc[r][c] == -INFINITY ? 0.f : expf(sc[r][c] - base);
      l[r] = l[r] * expf(m[r] - base) + row_sum(sum);
      m[r] = mn;
    }
  }
  float* lrow = lse + ((long long)bb * dm.h + hh) * dm.s;
  float* drow = dlt + ((long long)bb * dm.h + hh) * dm.s;
  const T* obase = o + (long long)bb * dm.s * qrs + (long long)hh * dm.d;
  const T* gbase = dout + (long long)bb * dm.s * qrs + (long long)hh * dm.d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = r0 + ty + 16 * r;
    float part = 0.f;
    if (i < dm.s)
      for (int c = tx; c < dm.d; c += 16)
        part = fmaf(to_f(gbase[(long long)i * qrs + c]),
                    to_f(obase[(long long)i * qrs + c]), part);
    part = row_sum(part);
    if (tx == 0 && i < dm.s) {
      lrow[i] = m[r] + logf(l[r]);
      drow[i] = part;
    }
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

// ---------------------------------------------------------------------------
// 2. dK and dV of one key tile of one kv head
// ---------------------------------------------------------------------------
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
    const long long roff = ((long long)bb * dm.h + hh) * dm.s;
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

// ---------------------------------------------------------------------------
// 3. dQ of one query tile of one head
// ---------------------------------------------------------------------------
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
  const long long roff = ((long long)bb * dm.h + hh) * dm.s;
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
constexpr size_t pre_bytes() {
  return sizeof(float) * 2 * kT * (DM + 1);
}
template <int DM>
constexpr size_t main_bytes() {
  return sizeof(float) * (4 * kT * (DM + 1) + kT * (kT + 1) + 2 * kT);
}

template <typename T, int DM>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* dlt, int b, int s, int h, int kv, int d,
           cudaStream_t st) {
  const Dims dm{s, h, kv, d, h / kv, 1.0f / sqrtf((float)d)};
  const int nb = (s + kT - 1) / kT;
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_pre<T, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pre_bytes<DM>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fa_bwd_dkdv<T, DM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)main_bytes<DM>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fa_bwd_dq<T, DM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)main_bytes<DM>());
  if (err != cudaSuccess) return (int)err;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *ot = static_cast<const T*>(o),
          *gt = static_cast<const T*>(dout);
  float *lf = static_cast<float*>(lse), *df = static_cast<float*>(dlt);
  fa_bwd_pre<T, DM><<<dim3(nb, h, b), kThreads, pre_bytes<DM>(), st>>>(
      qt, kt, ot, gt, lf, df, dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dkdv<T, DM><<<dim3(nb, kv, b), kThreads, main_bytes<DM>(), st>>>(
      qt, kt, vt, gt, lf, df, static_cast<T*>(dk), static_cast<T*>(dv), dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dq<T, DM><<<dim3(nb, h, b), kThreads, main_bytes<DM>(), st>>>(
      qt, kt, vt, gt, lf, df, static_cast<T*>(dq), dm);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, void* lse,
             void* dlt, int b, int s, int h, int kv, int d,
             cudaStream_t st) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, dlt, b, s, h, kv,
                         d, st);
  return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, dlt, b, s, h, kv,
                        d, st);
}

}  // namespace

extern "C" {

// q, o, dout, dq (b, s, h, d) and k, v, dk, dv (b, s, kv, d), all
// contiguous, all fp32 (dtype 0) or all bf16 (dtype 1); lse and delta
// fp32 scratch of b * h * s floats; h a multiple of kv, 1 <= d <= 128.
// Returns cudaErrorInvalidValue for a shape it cannot take, else
// cudaGetLastError() after the three launches.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout, void* dq,
                               void* dk, void* dv, void* lse, void* delta,
                               int b, int s, int h, int kv, int d, int dtype,
                               void* stream) {
  if (b < 1 || s < 1 || kv < 1 || h % kv != 0 || d < 1 || d > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, s, h,
                           kv, d, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                   b, s, h, kv, d, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
