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
// without a transpose. Any S is taken: rows and keys past S are bounds
// checks (the reference needs S divisible by its blocks).
//
// Design (simple first): one CTA of 256 threads per (b·h, 64-query
// block); the query block is staged once in shared memory and 64-key
// blocks of K and V are streamed through it, up to the block's last
// query: kv blocks above the diagonal are never loaded, and the
// diagonal block is masked in-block. Thread (ty, tx) of a 16 x 16 grid
// holds scores of rows ty + 16i and keys tx + 16j (i, j < 4) and the
// output columns tx + 16c of its rows; the running max and denominator
// of a row live in the 16 threads that share it and meet by shuffles.
// Probabilities go through shared memory into the P·V product. All
// products are fp32 FFMA, bf16 widened as it is staged; masked scores
// are selected to -inf and their probabilities to 0, and a row whose
// block is all masked keeps alpha = 0, never exp(-inf - -inf).
//
// Bound on the card: at hymba-1.5b's prefill (B = 2, S = 2048, H = 25,
// KV = 5, D = 64, bf16) the causal half of QK^T and P·V is 26.9 GFLOP,
// 0.027 ms on the bf16 tensor cores and 0.40 ms in fp32 FFMA, against
// 31.5 MB of q, k, v and out (0.009 ms): the work is bound by
// operations, and this kernel, without tensor cores, by FFMA throughput and
// shared-memory reads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per streamed block
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLdP = kBK + 4;  // shared row stride of the probabilities

struct Strides {
  long long b, s, h;           // elements; D is contiguous
};

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
          const T* __restrict__ v, T* __restrict__ out, int s, int h,
          int rep, int d, Strides qs, Strides ks, Strides vs, Strides os,
          float scale) {
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
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int h, int kv, int d, Strides qs, Strides ks, Strides vs,
           Strides os, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * h, (s + kBQ - 1) / kBQ);
  fa_kernel<T, kD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, h, h / kv, d, qs,
      ks, vs, os, 1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int s, int h, int kv, int d, Strides qs, Strides ks, Strides vs,
             Strides os, cudaStream_t stream) {
  if (d <= 16) return launch<T, 16>(q, k, v, out, b, s, h, kv, d, qs, ks, vs, os, stream);
  if (d <= 32) return launch<T, 32>(q, k, v, out, b, s, h, kv, d, qs, ks, vs, os, stream);
  if (d <= 64) return launch<T, 64>(q, k, v, out, b, s, h, kv, d, qs, ks, vs, os, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, out, b, s, h, kv, d, qs, ks, vs, os, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (b, s, h, d), k and v (b, s, kv, d) and out (b, s, h, d) through
// (batch, sequence, head) element strides, D contiguous; all fp32
// (dtype 0) or all bf16 (dtype 1); h a multiple of kv, 1 <= d <= 128.
// Returns cudaGetLastError() after the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int b, int s, int h, int kv, int d,
                           long long q_sb, long long q_ss, long long q_sh,
                           long long k_sb, long long k_ss, long long k_sh,
                           long long v_sb, long long v_ss, long long v_sh,
                           long long o_sb, long long o_ss, long long o_sh,
                           int dtype, void* stream) {
  if (b < 1 || s < 1 || kv < 1 || h % kv != 0 || d < 1)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, b, s, h, kv, d, qs, ks, vs, os, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, b, s, h, kv, d, qs, ks, vs,
                                   os, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
