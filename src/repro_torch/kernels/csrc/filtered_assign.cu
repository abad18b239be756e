// Block-skip nearest-centroid search over (tile_n x tile_k) blocks,
// for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/filtered_assign.py
// (filtered_assign -> _filtered_assign_kernel). For every point x and
// every centroid block j that is live in the (ceil(N/tile_n),
// ceil(K/tile_k)) mask of the point's tile, it computes the squared
// distances max(x2 - 2 x.c + c2, 0) to the block's centroids, with the
// norms x2 (N,) and c2 (K,) as given, and returns the global min and
// its centroid id over the live blocks. A row with no live block gets
// (inf, -1). Where no x2 is given (a null pointer), fa_kernel forms
// each point's norm from its tile as one fmaf chain over d; the
// yardstick's wrapper takes the same chain from fa_norms_kernel, which
// serves only the yardstick, so both give the same bits. Ragged N
// and K are handled by bounds checks; the reference's pad centroids
// (1e15 rows, norms 1e30*d) exist only so that they never win, which
// the checks give as well.
//
// Ties: the reference keeps the first index within a block (argmin)
// and the earlier block across blocks (`local_min < best`), so its
// result is the least (value, id) pair over the live centroids,
// compared value first. Both kernels below give that pair.
//
// Bound on the card: at uci-highk (N = 262,144, D = 32, K = 1024) and
// at uci-xlarge (N = 2^20, K = 256) with every block live, 2*N*K*D =
// 17.2 GFLOP of FFMA, 0.26 ms at 67 TFLOP/s; the bytes (x once, 32 or
// 128 MiB, and the outputs) take at most 0.05 ms. The kernel is bound
// by the FFMA throughput. The products run in fp32 FFMA: the tensor
// cores have no IEEE fp32 mode, and TF32 would change labels.
//
// What held the first kernel (fa_simple_kernel, kept below as the
// yardstick) near 4x its bound, and what fa_kernel does about it:
//   - one shared-memory byte per FFMA. The SM's shared memory gives a
//     warp 4 bytes a lane a cycle, broadcast or not, against 4 warp
//     FFMAs a cycle; a thread a point read S/4 float4s and one float
//     for S FFMAs. Here a lane keeps a register tile of kR = 8 points x
//     kC = 8 centroids: per 4 of D, 16 float4 loads feed 256 FFMAs, a
//     quarter of the bytes per FFMA.
//   - two barriers per chunk of at most 32 centroids, a block at a
//     time. A block turns its tile's mask row into a list of live
//     blocks once, lays their columns out back to back and stages
//     chunks of CS = 32, 64 or 128 of those columns (across block
//     boundaries, so tiles of 8 or 16 centroids are staged 8 or 16
//     blocks to a chunk) through a ring of 3 (or 2, where D is wide)
//     cp.async stages: one barrier per chunk, and the copies of the next
//     two chunks run under the products of this one.
//   - the tile's mask row, its points and its first chunks wait on
//     memory before any product, and the tile's lanes merge after the
//     last: a block of 4 warps, two blocks an SM where two fit in the
//     SM's shared memory, so one block's waits run under the other's
//     products (scripts/block_skip_probe.py times 8 warps in one block
//     an SM against it, built with -DFA_WARPS=8). Two fit up to D = 76
//     at 256 points and three stages, D = 60 at 64 points; a wider D
//     runs one block an SM (D = 128: 188,680 bytes at 256 x 3).
//   - scalar transposing stores of the point tile. The tile is copied
//     once by 16-byte cp.async (4-byte where D % 4 or an alignment
//     forbids it), rows a multiple of 4 floats apart but not of 8, so
//     the float4s of neighbouring rows fall in different bank groups.
// A block of 4 warps owns TP = 64 WR points (WR = 4 or 1 warp rows,
// WC = 4 / WR warp columns); lane (r, c) of the block's 8 WR x 4 WC
// lanes keeps points r + 8 WR i and chunk slots c + 4 WC j (i, j < 8).
// Where tile_n exceeds TP, a tile takes ceil(tile_n / TP) blocks; a tile
// of fewer points leaves the block's other rows zero, unused. The launch
// picks (TP, stages) itself from (D, K, tile_n, tile_k) alone
// (filtered_assign_variant): TP = 256 for tiles of 256 points or more,
// else 64; three stages where they fit, else two. A D too wide for two
// stages of whole rows (D > 172 at 256 x 128; the paper suite's widest D
// is 128) takes fa_wide_kernel instead, the same lanes and tiles with D
// walked in slices of kDS = 32 (the variant's slice): each ring stage
// holds one slice of the point tile and of a chunk, the lane's 8 x 8
// accumulators stay in registers across a chunk's slices, and the
// running min is taken after its last slice. The point tile is staged
// again for every chunk, so that route moves (TP + CS) x D floats a
// chunk; it is there to be right at any D, not yet fast.
// What still holds fa_kernel at 2.5x its bound at uci-xlarge (an H100
// 80GB HBM3 at 700 W, scripts/block_skip_probe.py): its 8 x 8 loop
// runs at three quarters of the FFMA rate independent FFMAs reach, and
// the running-min update adds six non-FFMA instructions a pair to the
// 32 FFMAs.
//
// Exactness: each (point, centroid) dot product is one fmaf chain over
// d = 0, 1, ..., D - 1 from 0.0f, as in the first kernel (the zero
// columns that round D up to 4 add fmaf(0, 0, acc) == acc: acc is
// never -0; fa_wide_kernel runs the same chain slice after slice,
// without a break), and both kernels form the distance with sq_dist. A
// lane
// sees its slots in ascending id order and keeps a running (min, id)
// with a strict <, so it holds the least (value, id) of its slots; the
// lanes' pairs then merge by the least (value, id), which is the
// reference's pair whatever the order the chunks came in. A pad slot
// has c2 = inf, so its distance is inf and never replaces the running
// min. So (best, idx) are bit for bit the first kernel's.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
#ifndef FA_WARPS
#define FA_WARPS 4                 // scripts/block_skip_probe.py builds 8
#endif
constexpr int kWarps = FA_WARPS;
constexpr int kBlocksPerSM = 8 / kWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kR = 8;              // points a lane keeps
constexpr int kC = 8;              // chunk slots a lane keeps
// (min, id) of every warp column's points: 2 x WC x TP = 2 x 4 x 64
constexpr int kMergeFloats = 2 * kWarps * 64;
constexpr int kSmemMax = 232448;   // the most shared memory one block has
constexpr int kDS = 32;            // fa_wide_kernel's slice of D

extern __shared__ __align__(16) float sm[];

// The squared distance from a point's norm, a dot product and a
// centroid's norm: the one expression both kernels compile.
__device__ __forceinline__ float sq_dist(float xx, float acc, float c2) {
  return fmaxf(xx - 2.0f * acc + c2, 0.0f);
}

// cp.async of 16 (.cg: past L1, for the points; .ca: through L1, for
// the centroids, which every block of an SM reads) or 4 bytes to shared
// address dst; bytes 0 writes zeros
__device__ __forceinline__ void cp16cg(uint32_t dst, const void* src,
                                       int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp16ca(uint32_t dst, const void* src,
                                       int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ints live in the float array as their bits
__device__ __forceinline__ int ldi(int i) { return __float_as_int(sm[i]); }
__device__ __forceinline__ void sti(int i, int v) { sm[i] = __int_as_float(v); }

// Both kernels below share a tile's live-block list, its positions and
// the merge of the lanes' (min, id) pairs.

// the live blocks of a mask row of gk entries, in ascending order, as
// ints at lb, and their count at lb + gk; run by one warp
__device__ __forceinline__ void list_live_blocks(const unsigned char* mrow,
                                                 int gk, int lb, int lane) {
  int count = 0;
  for (int b0 = 0; b0 < gk; b0 += 32) {
    const bool lv = b0 + lane < gk && mrow[b0 + lane] != 0;
    const unsigned bits = __ballot_sync(kAll, lv);
    if (lv) sti(lb + count + __popc(bits & ((1u << lane) - 1u)), b0 + lane);
    count += __popc(bits);
  }
  if (lane == 0) sti(lb + gk, count);
}

// positions: the live blocks' columns back to back; the ragged last
// block, if live, is the list's last, and its columns past k are left
// out
__device__ __forceinline__ int live_positions(int lb, int nlive, int gk,
                                              int k, int tile_k) {
  return nlive * tile_k -
         (ldi(lb + nlive - 1) == gk - 1 ? gk * tile_k - k : 0);
}

// the centroid at position pos, or -1 past the positions
__device__ __forceinline__ int position_column(int lb, int pos, int npos,
                                               int tile_k) {
  if (pos >= npos) return -1;
  const int q = pos / tile_k;
  return ldi(lb + q) * tile_k + (pos - q * tile_k);
}

// a tile with no live block: (inf, -1) for each of the block's rows
__device__ __forceinline__ void store_no_live(float* best_out, int* idx_out,
                                              size_t row0, int rows) {
  for (int p = threadIdx.x; p < rows; p += kThreads) {
    best_out[row0 + p] = CUDART_INF_F;
    idx_out[row0 + p] = -1;
  }
}

// the least (value, id) of each of the block's points: over a lane row's
// 4 lanes, then over the warp columns through shared memory at merge (an
// id of -1 comes only with inf, and loses to no pair)
template <int WR>
__device__ __forceinline__ void merge_store(float (&m)[kR], int (&a)[kR],
                                            int merge, int lane, int wc,
                                            int lrow, int rows, size_t row0,
                                            float* best_out, int* idx_out) {
  constexpr int WC = kWarps / WR;
  constexpr int TP = 64 * WR;
  constexpr int RP = 8 * WR;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float om = __shfl_xor_sync(kAll, m[i], o);
      const int oa = __shfl_xor_sync(kAll, a[i], o);
      if (om < m[i] || (om == m[i] && oa < a[i])) {
        m[i] = om;
        a[i] = oa;
      }
    }
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int p = lrow + RP * i;
      sm[merge + wc * TP + p] = m[i];
      sti(merge + (WC + wc) * TP + p, a[i]);
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < rows; p += kThreads) {
    float bm = sm[merge + p];
    int ba = ldi(merge + WC * TP + p);
    for (int w = 1; w < WC; ++w) {
      const float om = sm[merge + w * TP + p];
      const int oa = ldi(merge + (WC + w) * TP + p);
      if (om < bm || (om == bm && oa < ba)) {
        bm = om;
        ba = oa;
      }
    }
    best_out[row0 + p] = bm;
    idx_out[row0 + p] = ba;
  }
}

// fa_kernel's shared memory, in floats: the point tile [TP][ld]; the
// ring of `stages` chunks, each [CS][ld] centroid rows, CS norms and CS
// ids; the (min, id) merge of the warp columns [2][WC][TP]; the tile's
// live blocks [gk] and their count. Rows hold D rounded up to 4 (zeros
// past D), a multiple of 4 floats apart but not of 8.
struct Layout {
  int ld, cs, stage, c2, ids, ring, merge, lb, total;
};

__host__ __device__ inline int row_stride(int d) {
  const int l = (d + 3) & ~3;
  return (l / 4) % 2 == 0 ? l + 4 : l;
}

__host__ __device__ inline Layout layout(int points, int stages, int d,
                                         int gk) {
  Layout l;
  l.ld = row_stride(d);
  l.cs = kThreads * kR * kC / points;   // slots a chunk stages
  l.c2 = l.cs * l.ld;                   // offsets inside a stage
  l.ids = l.c2 + l.cs;
  l.stage = l.ids + l.cs;
  l.ring = points * l.ld;
  l.merge = l.ring + stages * l.stage;
  l.lb = l.merge + kMergeFloats;
  l.total = l.lb + gk + 1;
  return l;
}

template <int WR>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fa_kernel(const float* __restrict__ x, const float* __restrict__ x2,
          const float* __restrict__ c, const float* __restrict__ c2,
          const unsigned char* __restrict__ mask,
          float* __restrict__ best_out, int* __restrict__ idx_out, int n,
          int k, int d, int gk, int tile_n, int tile_k, int subs,
          int stages, bool vec) {
  constexpr int WC = kWarps / WR;       // warp columns
  constexpr int TP = 64 * WR;           // points a block owns
  constexpr int RP = 8 * WR;            // a lane's points lie RP apart
  constexpr int RC = 4 * WC;            // a lane's slots lie RC apart
  constexpr int CS = RC * kC;           // slots a chunk stages
  // threads a slot stages with (CS <= kThreads), or slots a thread
  constexpr int TPS = CS < kThreads ? kThreads / CS : 1;
  const Layout l = layout(TP, stages, d, gk);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wc = warp % WC;
  const int lrow = (warp / WC) * 8 + (lane >> 2);
  const int lcol = wc * 4 + (lane & 3);
  const int tile = blockIdx.x / subs;
  const size_t tile0 = (size_t)tile * tile_n;
  const size_t row0 = tile0 + (size_t)(blockIdx.x - tile * subs) * TP;
  const size_t end = min(tile0 + (size_t)tile_n, (size_t)n);
  if (row0 >= end) return;              // a block past a ragged tile
  const int rows = (int)min((size_t)TP, end - row0);
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(sm));

  // the tile's live blocks, in ascending order
  if (warp == 0) list_live_blocks(mask + (size_t)tile * gk, gk, l.lb, lane);
  __syncthreads();
  const int nlive = ldi(l.lb + gk);
  if (nlive == 0) {                     // the points are never loaded
    store_no_live(best_out, idx_out, row0, rows);
    return;
  }
  const int npos = live_positions(l.lb, nlive, gk, k, tile_k);
  const int nch = (npos + CS - 1) / CS;
  const int dp = (d + 3) & ~3, u4 = dp / 4;

  // the point tile, zeros past the tile's rows and past d
  if (vec) {
    for (int e = t; e < TP * u4; e += kThreads) {
      const int p = e / u4, q = e - p * u4;
      const bool ok = p < rows;
      cp16cg(sbase + 4u * (p * l.ld + 4 * q),
             ok ? x + (row0 + p) * d + 4 * q : x, ok ? 16 : 0);
    }
  } else {
    for (int e = t; e < TP * dp; e += kThreads) {
      const int p = e / dp, col = e - p * dp;
      const bool ok = p < rows && col < d;
      cp4(sbase + 4u * (p * l.ld + col), ok ? x + (row0 + p) * d + col : x,
          ok ? 4 : 0);
    }
  }

  // chunk ch into ring stage ch % stages: TPS threads a slot; a pad
  // slot (past the positions) gets a zero row, c2 = inf, id -1
  auto stage = [&](int ch) {
    const int base = l.ring + (ch % stages) * l.stage;
    const int part = t % TPS;
    for (int f = t / TPS; f < CS; f += kThreads / TPS) {
    const int col = position_column(l.lb, ch * CS + f, npos, tile_k);
    const bool ok = col >= 0;
    const float* src = c + (size_t)(ok ? col : 0) * d;
    const uint32_t dst = sbase + 4u * (base + f * l.ld);
    if (vec) {
      for (int q = part; q < u4; q += TPS)
        cp16ca(dst + 16u * q, src + 4 * q, ok ? 16 : 0);
    } else {
      for (int cc = part; cc < dp; cc += TPS)
        cp4(dst + 4u * cc, src + (cc < d ? cc : 0), ok && cc < d ? 4 : 0);
    }
    if (part == 0) {
      sti(base + l.ids + f, col);
      if (ok)
        cp4(sbase + 4u * (base + l.c2 + f), c2 + col, 4);
      else
        sm[base + l.c2 + f] = CUDART_INF_F;
    }
    }
  };

  float xx[kR], m[kR];
  int a[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int p = lrow + RP * i;
    xx[i] = x2 != nullptr && p < rows ? x2[row0 + p] : 0.0f;
    m[i] = CUDART_INF_F;
    a[i] = -1;
  }
  // the point tile rides in the first group
  for (int s = 0; s < stages - 1; ++s) {
    if (s < nch) stage(s);
    cp_commit();
  }
  const float4* sm4 = reinterpret_cast<const float4*>(sm);
  const int ld4 = l.ld / 4;
  const int xo = lrow * ld4;
  for (int ch = 0; ch < nch; ++ch) {
    if (stages == 3)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();                    // chunk ch is in; ch - 1 is done
    if (ch + stages - 1 < nch) stage(ch + stages - 1);
    cp_commit();
    const int base = l.ring + (ch % stages) * l.stage;
    const int co = base / 4 + lcol * ld4;
    if (ch == 0 && x2 == nullptr) {     // the norms, from the point tile
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        float nrm = 0.0f;
        for (int q = 0; q < u4; ++q) {
          const float4 v = sm4[xo + i * RP * ld4 + q];
          nrm = fmaf(v.x, v.x, nrm);
          nrm = fmaf(v.y, v.y, nrm);
          nrm = fmaf(v.z, v.z, nrm);
          nrm = fmaf(v.w, v.w, nrm);
        }
        xx[i] = nrm;
      }
    }
    float acc[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) acc[i][j] = 0.0f;
    // four d at a time, in d order; past d both sides are 0
#pragma unroll 2
    for (int q = 0; q < u4; ++q) {
      float4 xv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) xv[i] = sm4[xo + i * RP * ld4 + q];
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const float4 cv = sm4[co + j * RC * ld4 + q];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          float v = acc[i][j];
          v = fmaf(xv[i].x, cv.x, v);
          v = fmaf(xv[i].y, cv.y, v);
          v = fmaf(xv[i].z, cv.z, v);
          acc[i][j] = fmaf(xv[i].w, cv.w, v);
        }
      }
    }
    // slots in ascending id order: a strict < keeps the first
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int f = lcol + RC * j;
      const float cc2 = sm[base + l.c2 + f];
      const int id = ldi(base + l.ids + f);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
#ifdef FA_PROBE_NO_MIN             // the probe's cut copy: wrong output
        m[i] = fminf(m[i], acc[i][j]);
#else
        const float dd = sq_dist(xx[i], acc[i][j], cc2);
        a[i] = dd < m[i] ? id : a[i];
        m[i] = fminf(m[i], dd);
#endif
      }
    }
  }
  cp_wait<0>();
  merge_store<WR>(m, a, l.merge, lane, wc, lrow, rows, row0, best_out,
                  idx_out);
}

// fa_wide_kernel's shared memory, in floats: the ring of `stages` steps,
// each the point tile's slice [TP][ld] and a chunk's slice [CS][ld]
// (ld = row_stride(kDS)), CS norms and CS ids; then the merge and the
// live blocks, as in Layout.
struct WideLayout {
  int ld, cs, cb, c2, ids, stage, merge, lb, total;
};

__host__ __device__ inline WideLayout layout_wide(int points, int stages,
                                                  int gk) {
  WideLayout l;
  l.ld = row_stride(kDS);
  l.cs = kThreads * kR * kC / points;
  l.cb = points * l.ld;                 // offsets inside a stage
  l.c2 = l.cb + l.cs * l.ld;
  l.ids = l.c2 + l.cs;
  l.stage = l.ids + l.cs;
  l.merge = stages * l.stage;
  l.lb = l.merge + kMergeFloats;
  l.total = l.lb + gk + 1;
  return l;
}

// fa_kernel with D walked in slices of kDS: a step of the ring is one
// slice of one chunk (step = chunk x nds + slice), which stages that
// slice of the point tile and of the chunk's centroids. The lanes, the
// live-block list, the ids, the tie rule and the merge are fa_kernel's.
template <int WR>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fa_wide_kernel(const float* __restrict__ x, const float* __restrict__ x2,
               const float* __restrict__ c, const float* __restrict__ c2,
               const unsigned char* __restrict__ mask,
               float* __restrict__ best_out, int* __restrict__ idx_out,
               int n, int k, int d, int gk, int tile_n, int tile_k,
               int subs, int stages, bool vec) {
  constexpr int WC = kWarps / WR;
  constexpr int TP = 64 * WR;
  constexpr int RP = 8 * WR;
  constexpr int RC = 4 * WC;
  constexpr int CS = RC * kC;
  constexpr int TPS = CS < kThreads ? kThreads / CS : 1;
  constexpr int S4 = kDS / 4;           // float4s of a full slice
  const WideLayout l = layout_wide(TP, stages, gk);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wc = warp % WC;
  const int lrow = (warp / WC) * 8 + (lane >> 2);
  const int lcol = wc * 4 + (lane & 3);
  const int tile = blockIdx.x / subs;
  const size_t tile0 = (size_t)tile * tile_n;
  const size_t row0 = tile0 + (size_t)(blockIdx.x - tile * subs) * TP;
  const size_t end = min(tile0 + (size_t)tile_n, (size_t)n);
  if (row0 >= end) return;
  const int rows = (int)min((size_t)TP, end - row0);
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(sm));

  if (warp == 0) list_live_blocks(mask + (size_t)tile * gk, gk, l.lb, lane);
  __syncthreads();
  const int nlive = ldi(l.lb + gk);
  if (nlive == 0) {
    store_no_live(best_out, idx_out, row0, rows);
    return;
  }
  const int npos = live_positions(l.lb, nlive, gk, k, tile_k);
  const int nch = (npos + CS - 1) / CS;
  const int dp = (d + 3) & ~3, u4 = dp / 4;
  const int nds = (dp + kDS - 1) / kDS;
  const int nsteps = nch * nds;

  // step st into ring stage st % stages: the slice's columns [col0,
  // col0 + kDS) of the point tile and of the chunk, zeros past the
  // tile's rows, past d and in pad slots (c2 = inf, id -1)
  auto stage = [&](int st) {
    const int ch = st / nds, col0 = (st - ch * nds) * kDS;
    const int base = (st % stages) * l.stage;
    if (vec) {
      for (int e = t; e < TP * S4; e += kThreads) {
        const int p = e / S4, q = e - p * S4;
        const bool ok = p < rows && col0 + 4 * q < d;
        cp16cg(sbase + 4u * (base + p * l.ld + 4 * q),
               ok ? x + (row0 + p) * d + col0 + 4 * q : x, ok ? 16 : 0);
      }
    } else {
      for (int e = t; e < TP * kDS; e += kThreads) {
        const int p = e / kDS, col = e - p * kDS;
        const bool ok = p < rows && col0 + col < d;
        cp4(sbase + 4u * (base + p * l.ld + col),
            ok ? x + (row0 + p) * d + col0 + col : x, ok ? 4 : 0);
      }
    }
    const int part = t % TPS;
    for (int f = t / TPS; f < CS; f += kThreads / TPS) {
      const int col = position_column(l.lb, ch * CS + f, npos, tile_k);
      const bool ok = col >= 0;
      const float* src = c + (size_t)(ok ? col : 0) * d + col0;
      const uint32_t dst = sbase + 4u * (base + l.cb + f * l.ld);
      if (vec) {
        for (int q = part; q < S4; q += TPS) {
          const bool in = ok && col0 + 4 * q < d;
          cp16ca(dst + 16u * q, in ? src + 4 * q : c, in ? 16 : 0);
        }
      } else {
        for (int cc = part; cc < kDS; cc += TPS) {
          const bool in = ok && col0 + cc < d;
          cp4(dst + 4u * cc, in ? src + cc : c, in ? 4 : 0);
        }
      }
      if (part == 0) {
        sti(base + l.ids + f, col);
        if (ok)
          cp4(sbase + 4u * (base + l.c2 + f), c2 + col, 4);
        else
          sm[base + l.c2 + f] = CUDART_INF_F;
      }
    }
  };

  float xx[kR], m[kR];
  int a[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int p = lrow + RP * i;
    xx[i] = x2 != nullptr && p < rows ? x2[row0 + p] : 0.0f;
    m[i] = CUDART_INF_F;
    a[i] = -1;
  }
  for (int s = 0; s < stages - 1; ++s) {
    if (s < nsteps) stage(s);
    cp_commit();
  }
  const float4* sm4 = reinterpret_cast<const float4*>(sm);
  const int ld4 = l.ld / 4;
  float acc[kR][kC];
  for (int st = 0; st < nsteps; ++st) {
    if (stages == 3)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();                    // step st is in; st - 1 is done
    if (st + stages - 1 < nsteps) stage(st + stages - 1);
    cp_commit();
    const int ch = st / nds, ds = st - ch * nds;
    const int base = (st % stages) * l.stage;
    const int xo = base / 4 + lrow * ld4;
    const int co = (base + l.cb) / 4 + lcol * ld4;
    const int q4 = min(S4, u4 - ds * S4);   // float4s of this slice
    if (ch == 0 && x2 == nullptr) {     // the norms, slice after slice
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        float nrm = xx[i];
        for (int q = 0; q < q4; ++q) {
          const float4 v = sm4[xo + i * RP * ld4 + q];
          nrm = fmaf(v.x, v.x, nrm);
          nrm = fmaf(v.y, v.y, nrm);
          nrm = fmaf(v.z, v.z, nrm);
          nrm = fmaf(v.w, v.w, nrm);
        }
        xx[i] = nrm;
      }
    }
    if (ds == 0) {
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) acc[i][j] = 0.0f;
    }
    // four d at a time, in d order, the chain carried across slices
#pragma unroll 2
    for (int q = 0; q < q4; ++q) {
      float4 xv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) xv[i] = sm4[xo + i * RP * ld4 + q];
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const float4 cv = sm4[co + j * RC * ld4 + q];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          float v = acc[i][j];
          v = fmaf(xv[i].x, cv.x, v);
          v = fmaf(xv[i].y, cv.y, v);
          v = fmaf(xv[i].z, cv.z, v);
          acc[i][j] = fmaf(xv[i].w, cv.w, v);
        }
      }
    }
    if (ds == nds - 1) {                // the chunk's dot products are whole
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int f = lcol + RC * j;
        const float cc2 = sm[base + l.c2 + f];
        const int id = ldi(base + l.ids + f);
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const float dd = sq_dist(xx[i], acc[i][j], cc2);
          a[i] = dd < m[i] ? id : a[i];
          m[i] = fminf(m[i], dd);
        }
      }
    }
  }
  cp_wait<0>();
  merge_store<WR>(m, a, l.merge, lane, wc, lrow, rows, row0, best_out,
                  idx_out);
}

// The squared norm of every row of x (n, d): one fmaf chain over d
// from 0.0f a row, a thread a row: fa_kernel's own chain, for the first
// kernel's wrapper where the caller gives no norms (the yardstick only).
__global__ void __launch_bounds__(kThreads)
fa_norms_kernel(const float* __restrict__ x, float* __restrict__ x2, int n,
                int d, bool vec) {
  const size_t row = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (row >= (size_t)n) return;
  const float* r = x + row * d;
  float acc = 0.0f;
  if (vec) {
    for (int q = 0; q < d / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(r)[q];
      acc = fmaf(v.x, v.x, acc);
      acc = fmaf(v.y, v.y, acc);
      acc = fmaf(v.z, v.z, acc);
      acc = fmaf(v.w, v.w, acc);
    }
  } else {
    for (int col = 0; col < d; ++col) acc = fmaf(r[col], r[col], acc);
  }
  x2[row] = acc;
}

// ---------------------------------------------------------------------
// The port's first kernel, kept as the yardstick that fa_kernel is held
// to bit for bit and timed against; only filtered_assign_simple_launch
// reaches it. One CTA per tile of tile_n points, one thread
// per point, the running (min, argmin) in registers. The CTA reads its
// row of the mask, entry by entry, walking the live blocks in ascending
// order and each block's centroids in ascending order, and replaces its
// running min only on a strict <. A dead block costs that one read, and
// a tile with no live block never loads its points. The tile's points
// sit in shared memory transposed, [d][tile_n + 1]. A live block's
// centroids are streamed through shared memory S at a time (S = 8, 16
// or 32, the largest not above tile_k), stored [d][S + 4] so that each
// thread reads four centroids' values of one column with one float4
// load; each thread keeps S dot products in registers.
template <int S>
__global__ void fa_simple_kernel(const float* __restrict__ x,
                                 const float* __restrict__ x2,
                                 const float* __restrict__ c,
                                 const float* __restrict__ c2,
                                 const unsigned char* __restrict__ mask,
                                 float* __restrict__ best_out,
                                 int* __restrict__ idx_out, int n, int k,
                                 int d, int gk, int tile_k) {
  constexpr int cs_stride = S + 4;
  const int tile_n = blockDim.x;
  const int xs_stride = tile_n + 1;
  float* cs = sm;                                  // [d][S + 4]
  float* c2s = cs + (size_t)d * cs_stride;         // [S]
  float* xs = c2s + S;                             // [d][tile_n + 1]

  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const size_t row0 = (size_t)tile * tile_n;
  const size_t row = row0 + t;
  const bool valid = row < (size_t)n;
  const unsigned char* mrow = mask + (size_t)tile * gk;

  const float xx = valid ? x2[row] : 0.0f;
  float best = CUDART_INF_F;
  int best_id = -1;
  bool loaded = false;

  for (int b = 0; b < gk; ++b) {
    if (!mrow[b]) continue;                        // dead block
    if (!loaded) {                                 // the tile's points,
      const int tile_elems = tile_n * d;           // pad rows = 0
      for (int e = t; e < tile_elems; e += tile_n) {
        const int r = e / d, col = e - r * d;
        const size_t gr = row0 + r;
        xs[col * xs_stride + r] = gr < (size_t)n ? x[gr * d + col] : 0.0f;
      }
      loaded = true;                               // visible after the
    }                                              // next barrier
    const int kb_end = min((b + 1) * tile_k, k);
    for (int s0 = b * tile_k; s0 < kb_end; s0 += S) {
      const int ns = min(S, kb_end - s0);
      __syncthreads();                             // cs is free again
      for (int e = t; e < S * d; e += tile_n) {
        const int j = e / d, col = e - j * d;
        cs[col * cs_stride + j] =
            j < ns ? c[(size_t)(s0 + j) * d + col] : 0.0f;
      }
      for (int j = t; j < S; j += tile_n)          // tile_n may be < S
        c2s[j] = j < ns ? c2[s0 + j] : 0.0f;
      __syncthreads();

      float acc[S];
#pragma unroll
      for (int j = 0; j < S; ++j) acc[j] = 0.0f;
      for (int col = 0; col < d; ++col) {
        const float xv = xs[col * xs_stride + t];
        const float4* cv =
            reinterpret_cast<const float4*>(cs + col * cs_stride);
#pragma unroll
        for (int q = 0; q < S / 4; ++q) {
          const float4 v = cv[q];
          acc[4 * q + 0] = fmaf(xv, v.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(xv, v.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(xv, v.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(xv, v.w, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (j < ns) {
          const float dd = sq_dist(xx, acc[j], c2s[j]);
          if (dd < best) {
            best = dd;
            best_id = s0 + j;
          }
        }
      }
    }
  }
  if (valid) {
    best_out[row] = best;
    idx_out[row] = best_id;
  }
}

// The first kernel's centroids staged per shared-memory chunk: the
// largest of 32, 16 and 8 not above tile_k.
int simple_stage(int tile_k) {
  return tile_k >= 32 ? 32 : tile_k >= 16 ? 16 : 8;
}

// The first kernel's shared memory in bytes: a chunk of S centroids and
// the points transposed, [d][tile_n + 1].
long long simple_smem(int d, int tile_n, int S) {
  return 4LL * ((long long)d * (S + 4) + S + (long long)d * (tile_n + 1));
}

template <int S>
int launch_simple(const float* x, const float* x2, const float* c,
                  const float* c2, const unsigned char* mask, float* best,
                  int* idx, int n, int k, int d, int tile_n, int tile_k,
                  cudaStream_t stream) {
  const int smem = (int)simple_smem(d, tile_n, S);
  cudaError_t e = cudaFuncSetAttribute(
      fa_simple_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n + tile_n - 1) / tile_n;
  const int gk = (k + tile_k - 1) / tile_k;
  fa_simple_kernel<S><<<tiles, tile_n, smem, stream>>>(
      x, x2, c, c2, mask, best, idx, n, k, d, gk, tile_k);
  return (int)cudaGetLastError();
}

// The slice of D the launch walks at a shape: 0, whole rows (fa_kernel),
// where two stages of whole rows fit in one block's shared memory, else
// kDS (fa_wide_kernel).
int d_slice(int d, int k, int tile_n, int tile_k) {
  const int gk = (k + tile_k - 1) / tile_k;
  const int tp = tile_n >= 256 ? 256 : 64;
  return d <= 65536 && 4LL * layout(tp, 2, d, gk).total <= kSmemMax ? 0
                                                                      : kDS;
}

// The launch's variant at a shape: TP = 256 points a block for tiles of
// 256 points or more, else 64; three chunks (or slices of chunks) in
// flight where they fit in one block's shared memory, else two. False
// where two do not fit even in slices (a mask row of more blocks than
// shared memory holds).
bool variant_for(int d, int k, int tile_n, int tile_k, int* points,
                 int* stages) {
  if (d < 1 || k < 0 || tile_n < 1 || tile_k < 1) return false;
  const int gk = (k + tile_k - 1) / tile_k;
  if (gk > kSmemMax / 4) return false;
  const int tp = tile_n >= 256 ? 256 : 64;
  const bool sliced = d_slice(d, k, tile_n, tile_k) != 0;
  for (int s = 3; s >= 2; --s) {
    const long long floats = sliced ? layout_wide(tp, s, gk).total
                                    : layout(tp, s, d, gk).total;
    if (4LL * floats <= kSmemMax) {
      *points = tp;
      *stages = s;
      return true;
    }
  }
  return false;
}

template <int WR>
int launch_fa(const float* x, const float* x2, const float* c,
              const float* c2, const unsigned char* m, float* best, int* idx,
              int n, int k, int d, int tile_n, int tile_k, int stages,
              bool sliced, cudaStream_t st) {
  constexpr int TP = 64 * WR;
  const int gk = (k + tile_k - 1) / tile_k;
  const int smem = 4 * (sliced ? layout_wide(TP, stages, gk).total
                               : layout(TP, stages, d, gk).total);
  auto* kern = sliced ? fa_wide_kernel<WR> : fa_kernel<WR>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (n + (long long)tile_n - 1) / tile_n;
  const int subs = (tile_n + TP - 1) / TP;
  if (tiles * subs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // 16-byte copies where every row of x and of c starts on 16 bytes
  const bool vec = d % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(c)) & 15) == 0;
  kern<<<(int)(tiles * subs), kThreads, smem, st>>>(
      x, x2, c, c2, m, best, idx, n, k, d, gk, tile_n, tile_k, subs, stages,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The variant filtered_assign_launch takes at (d, k, tile_n, tile_k):
// writes the points a block owns (256 or 64), the chunks in flight (3 or
// 2) and the columns of D walked at a time (0 for whole rows, fa_kernel;
// kDS for fa_wide_kernel) and returns 1, or writes zeros and returns 0
// for a shape the launch refuses.
int filtered_assign_variant(int d, int k, int tile_n, int tile_k,
                            int* points, int* stages, int* slice) {
  int p = 0, s = 0;
  const bool ok = variant_for(d, k, tile_n, tile_k, &p, &s);
  *points = p;
  *stages = s;
  *slice = ok ? d_slice(d, k, tile_n, tile_k) : 0;
  return ok ? 1 : 0;
}

// 1 where filtered_assign_simple_launch takes (d, tile_n, tile_k): its
// shared memory fits in one block's and tile_n is at most 1024 (one
// thread a point); else 0.
int filtered_assign_simple_takes(int d, int tile_n, int tile_k) {
  return d >= 1 && tile_n >= 1 && tile_n <= 1024 && tile_k >= 1 &&
                 simple_smem(d, tile_n, simple_stage(tile_k)) <= kSmemMax
             ? 1
             : 0;
}

// x (n, d) f32; x2 (n,) f32, or null for fa_kernel to form the norms
// itself; c (k, d) f32; c2 (k,) f32; mask (ceil(n/tile_n),
// ceil(k/tile_k)) u8. Outputs: best (n,) f32, idx (n,) i32. Launches
// fa_kernel, or fa_wide_kernel where filtered_assign_variant's slice is
// not 0, in that variant. Returns
// cudaErrorInvalidValue, before any launch, for a shape with no
// variant, else cudaGetLastError() after the launch.
int filtered_assign_launch(const void* x, const void* x2, const void* c,
                           const void* c2, const void* mask, void* best,
                           void* idx, int n, int k, int d, int tile_n,
                           int tile_k, void* stream) {
  int points = 0, stages = 0;
  if (n < 1 || !variant_for(d, k, tile_n, tile_k, &points, &stages))
    return (int)cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* x2f = static_cast<const float*>(x2);
  const auto* cf = static_cast<const float*>(c);
  const auto* c2f = static_cast<const float*>(c2);
  const auto* m = static_cast<const unsigned char*>(mask);
  auto* bf = static_cast<float*>(best);
  auto* ii = static_cast<int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sliced = d_slice(d, k, tile_n, tile_k) != 0;
  return points == 256
             ? launch_fa<4>(xf, x2f, cf, c2f, m, bf, ii, n, k, d, tile_n,
                            tile_k, stages, sliced, s)
             : launch_fa<1>(xf, x2f, cf, c2f, m, bf, ii, n, k, d, tile_n,
                            tile_k, stages, sliced, s);
}

// The first kernel, with the same arguments (x2 not null): the
// yardstick. tile_n up to 1024 (one thread per point).
int filtered_assign_simple_launch(const void* x, const void* x2,
                                  const void* c, const void* c2,
                                  const void* mask, void* best, void* idx,
                                  int n, int k, int d, int tile_n,
                                  int tile_k, void* stream) {
  if (x2 == nullptr || n < 1 || k < 0 ||
      !filtered_assign_simple_takes(d, tile_n, tile_k))
    return (int)cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* x2f = static_cast<const float*>(x2);
  const auto* cf = static_cast<const float*>(c);
  const auto* c2f = static_cast<const float*>(c2);
  const auto* m = static_cast<const unsigned char*>(mask);
  auto* bf = static_cast<float*>(best);
  auto* ii = static_cast<int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int stage = simple_stage(tile_k);
  if (stage == 32)
    return launch_simple<32>(xf, x2f, cf, c2f, m, bf, ii, n, k, d, tile_n,
                             tile_k, s);
  if (stage == 16)
    return launch_simple<16>(xf, x2f, cf, c2f, m, bf, ii, n, k, d, tile_n,
                             tile_k, s);
  return launch_simple<8>(xf, x2f, cf, c2f, m, bf, ii, n, k, d, tile_n,
                          tile_k, s);
}

// x2 (n,) f32 = the squared norms of the rows of x (n, d) f32, for
// the yardstick's wrapper where the caller gave none.
int filtered_assign_norms_launch(const void* x, void* x2, int n, int d,
                                 void* stream) {
  if (n < 1 || d < 0) return (int)cudaErrorInvalidValue;
  const bool vec =
      d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  fa_norms_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(x2), n, d, vec);
  return (int)cudaGetLastError();
}

const char* filtered_assign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
