// Hopper building blocks shared by the tensor-core attention kernels
// (flash_attention.cu's forward, flash_attention_bwd.cu's backward):
// TMA copies through tensor maps into swizzled shared memory (Panels:
// 64-column panels with the 128-byte swizzle at d 64 and 128, 32-column
// panels with the 64-byte swizzle at d 96), mbarriers with bounded
// waits, wgmma descriptors and the bf16 products (m64n64k16 from shared
// memory or registers; m64n96k16 from registers at d 96). Each .cu that
// includes it is its own library; kernels/_build.py hashes this header
// with every source, so an edit here rebuilds them all.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, s, h;           // elements; D is contiguous
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A head's rows as the tensor map reads them: dims (D, X, Y, B), X and
// Y the sequence and head axes in increasing stride; seq names the one
// that is the sequence (1 or 2). A box is one swizzled panel (64
// columns, 128 bytes, or 32 columns, 64 bytes; see Panels) of `rows`
// rows of one head of one batch.
struct Map {
  CUtensorMap map;
  int seq;
};

// the tensor-map copy of a box to shared memory, completion reported to
// the mbarrier at bar; c0 the column, row the first row
__device__ __forceinline__ void tma_load(uint32_t dst, const Map& m,
                                         uint32_t bar, int c0, int row,
                                         int head, int batch) {
  const int c1 = m.seq == 1 ? row : head, c2 = m.seq == 1 ? head : row;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&m.map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(batch), "r"(bar)
      : "memory");
}

// a plain bulk copy of `bytes` (a multiple of 16, both ends on 16
// bytes) to shared memory, completion reported to the mbarrier at bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// Wait for the completion of the barrier's phase of this parity. A
// bounded spin: a copy that never lands traps (a launch error) rather
// than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}

// wgmma shared-memory descriptor; offsets in bytes; layout 1 the
// 128-byte swizzle, 2 the 64-byte one
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo, uint32_t layout = 1) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

// How a tile of kD bf16 columns lies in shared memory: kD / kCols
// panels of kCols columns one after the other, each `rows` rows of kRow
// bytes, swizzled in atoms of 8 rows (kAtom bytes, every panel on a
// multiple of it). d 64 and 128: panels of 64 columns, 128-byte rows,
// 16-byte chunk c of row r at c ^ (r % 8) (CU_TENSOR_MAP_SWIZZLE_128B).
// d 96: three panels of 32 columns, 64-byte rows, chunk c of row r at
// c ^ (r / 2 % 4) (CU_TENSOR_MAP_SWIZZLE_64B): every panel whole, no
// column of padding, and one m64n96k16 product reads all three.
template <int kD>
struct Panels {
  static_assert(kD == 64 || kD == 96 || kD == 128, "d 64, 96 or 128");
  static constexpr int kCols = kD == 96 ? 32 : 64;
  static constexpr int kCount = kD / kCols;
  static constexpr uint32_t kRow = 2 * kCols;
  static constexpr uint32_t kAtom = 8 * kRow;
  static constexpr uint32_t kLayout = kCols == 64 ? 1 : 2;
  static constexpr int kSteps = kCols / 16;     // k-steps of 16 a panel
};

// descriptor of k-step kk (columns 16kk .. 16kk + 15) of a K-major
// operand: 64 rows from `tile` of a tile whose panels hold `rows` rows
template <int kD>
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, uint32_t rows,
                                          int kk) {
  using P = Panels<kD>;
  return sdesc(tile + (kk / P::kSteps) * rows * P::kRow +
                   (kk % P::kSteps) * 32,
               16, P::kAtom, P::kLayout);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads of an accumulator above the wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, fp32) = a (64 x 16, shared, K-major) * b (16 x 64, shared,
// K-major), + d when accumulate is non-zero
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += a (64 x 16 bf16, registers) * b (16 x 64, shared,
// MN-major: the 64 columns of a row are contiguous)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 96, fp32) += a (64 x 16 bf16, registers) * b (16 x 96, shared,
// MN-major in three 32-column panels of the 64-byte swizzle, the next
// panel lbo bytes on)
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, "
      "1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc (64 x kD, fp32; register 4j + i is column 8j + 2(t % 4) + i % 2,
// as in one m64n64 accumulator per 64 columns) += a (64 x 16 bf16,
// registers) * rows 16kk .. 16kk + 15 of an MN-major tile in Panels
// whose panels hold `rows` rows: one m64n64k16 a 64-column panel, or one
// m64n96k16 across d 96's three
template <int kD>
__device__ __forceinline__ void wgmma_rs_rows(float (&acc)[kD / 2],
                                              const uint32_t (&a)[4],
                                              uint32_t tile, uint32_t rows,
                                              int kk) {
  using P = Panels<kD>;
  const uint32_t at = tile + kk * 16 * P::kRow;
  if constexpr (kD == 96) {
    wgmma_rs_n96(acc, a, sdesc(at, rows * P::kRow, P::kAtom, P::kLayout));
  } else {
#pragma unroll
    for (int pn = 0; pn < P::kCount; ++pn)
      // 128 bytes a row; 8-row groups 1024 bytes apart in both directions
      wgmma_rs(*reinterpret_cast<float(*)[32]>(&acc[32 * pn]), a,
               sdesc(at + pn * rows * P::kRow, 1024, 1024));
  }
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An m64n64 fp32 accumulator (fragment layout: thread t of the
// warpgroup holds rows r_a = 16(t / 32) + (t % 32) / 4 and r_a + 8;
// register 4j + i is column 8j + 2(t % 4) + i % 2 of row r_a (i < 2) or
// r_a + 8 (i >= 2)) rounded to bf16 as the A fragments of the four
// k-steps of 16 of the next product: the accumulator layout of the
// columns 16kk .. 16kk + 15 is the A layout of k-step kk.
__device__ __forceinline__ void to_a_frags(const float (&c)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so the library
// needs no link to libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of a (b, s, heads, kD) bf16 tensor with (batch, sequence, head)
// element strides st, D contiguous, read in boxes of one panel
// (Panels<kD>: 64 columns 128-byte swizzled, or 32 columns 64-byte
// swizzled) by `rows` rows. Returns false where cuTensorMapEncodeTiled
// refuses it.
template <int kD>
inline bool make_map(Map* m, const void* base, int b, int s, int heads,
                     Strides st, int rows) {
  constexpr int cols = Panels<kD>::kCols;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  // the middle dims in increasing stride; a dim of one element is never
  // stepped, so it takes the packed stride
  const bool seq_first = st.s <= st.h;
  m->seq = seq_first ? 1 : 2;
  const long long inner = seq_first ? st.s : st.h;
  const long long outer = seq_first ? st.h : st.s;
  const int n_inner = seq_first ? s : heads, n_outer = seq_first ? heads : s;
  const cuuint64_t e = 2;                        // bytes of a bf16
  const cuuint64_t s1 = (cuuint64_t)inner * e;
  const cuuint64_t s2 = n_outer > 1 ? (cuuint64_t)outer * e : s1 * n_inner;
  const cuuint64_t s3 = b > 1 ? (cuuint64_t)st.b * e : s2 * n_outer;
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)n_inner,
                              (cuuint64_t)n_outer, (cuuint64_t)b};
  const cuuint64_t strides[3] = {s1, s2, s3};
  const cuuint32_t box[4] = {(cuuint32_t)cols,
                             seq_first ? (cuuint32_t)rows : 1u,
                             seq_first ? 1u : (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(&m->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc
