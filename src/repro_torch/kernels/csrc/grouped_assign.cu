// Group-granular block-skip nearest-centroid search, for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/grouped_assign.py
// (grouped_assign -> _grouped_assign_kernel). For every point x and
// every group g whose (point tile, g) block is live in the mask it
// computes the squared distances max(|x|^2 - 2 x.c + |c|^2, 0) to the
// group's centroids and returns, per (point, group), the min, the id
// of the argmin and the second min, and per point the global best and
// its id. A dead block reads (inf, -1, inf). A slot whose id is -1 (a
// pad, at the row's tail or anywhere inside it) counts as +inf.
//
// Ties: within a group the first slot wins (slots are in ascending
// centroid id); across groups the comparison is a strict <, so the
// earlier group wins -- as the Pallas kernel does.
//
// Bound on the card: at uci-xlarge (N = 2^20, D = 32, K = 256, G = 25)
// with every block live, 2*N*K*D = 17.2 GFLOP of FFMA (0.26 ms at
// 67 TFLOP/s); the three (N, G) outputs are 315 MB (0.09 ms at
// 3.35 TB/s). The products run in fp32 FFMA: the tensor cores have no
// IEEE fp32 mode, and TF32 would change labels.
//
// What held the first kernel (ga_simple_kernel, kept below as the
// yardstick) to 16x its bound, and what ga_kernel does about it:
//   - one shared-memory load per FFMA. A warp's shared-memory load
//     costs the SM's shared memory a cycle per 4 bytes a lane gets,
//     broadcast or not (a float4 costs 4), against 4 warp FFMAs a
//     cycle. So a lane keeps a register block of R = 8 points x kS = 8
//     slots: per 4 of D, 16 float4 loads feed 256 FFMAs, as many cycles
//     as they take.
//   - padded slots computed. A small kernel (ga_plan_kernel) finds each
//     group's live length (its last slot with an id >= 0, plus 1) and
//     lays the live slots of all groups out back to back (off, src),
//     once per call, on the card. A block stages the live slots of the
//     groups live for its points, back to back, and its warps cut that
//     run into equal ranges of 8-slot chunks, a chunk running across
//     group boundaries: no group is rounded up to a chunk. Interior -1
//     slots are still masked.
//   - (N, G) stores with a stride of G per thread. The block gathers
//     the triples of a window of up to kGw = 32 groups in shared memory
//     and writes whole runs of rows (at G <= 32, one contiguous run).
// A block of 8 warps (one an SM: 232 registers a thread) owns 32 R
// points (256; fewer where D is wide: R = points_for(d, g), a function
// of the shape that the launch evaluates before it launches anything)
// and keeps their x in shared memory, rows a multiple of 4 floats apart
// but not of 8, so that 8 neighbouring rows' float4s fall in 8 bank
// groups. Each warp computes
// every point of the block against its range of slots; lane l keeps
// points l + 32 r. The centroids of a window's live groups are staged by
// cp.async, in batches where they do not fit (Hamerly, one group of
// K = 1024 at D = 128: 8 batches). A warp writes the groups that start
// inside its range straight to the block's triples; the group it
// continues from an earlier range (another warp's, or a batch before)
// goes to a side buffer and merges, in warp order, after a barrier.
//
// Exactness: each (point, slot) dot product is one fmaf chain over
// d = 0, 1, ..., D - 1 from 0.0f (the zero columns that round D up to
// 4 add fmaf(0, 0, acc) == acc: acc is never -0), and the epilogue is
// the first kernel's fmaxf(xx - 2 acc + c2, 0); each warp visits its
// slots in ascending order with the first kernel's update, and the
// pieces of a group merge in slot order, the earlier piece winning a
// tie and the second min taken over the whole multiset, min(max(m1a,
// m1b), m2a, m2b). So every output is bit for bit the first kernel's
// (chip_smoke.py and the cuda tests hold them equal). No atomics.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kS = 8;             // slots a lane computes at once
constexpr int kGw = 32;           // groups a window gathers and stores
constexpr int kMinCap = 8;        // fewest slots a batch may stage
constexpr int kPlanThreads = 1024;
constexpr int kSmemMax = 232448;  // the most shared memory one block has

extern __shared__ __align__(16) float sm[];

// cp.async of 16 (or 4) bytes to shared address dst; bytes 0 writes
// zeros
__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp16z(uint32_t dst, const void* src,
                                      int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ints live in the float array as their bits
__device__ __forceinline__ int ldi(int i) { return __float_as_int(sm[i]); }
__device__ __forceinline__ void sti(int i, int v) { sm[i] = __int_as_float(v); }

// ga_kernel's shared memory, in floats: x [P][ldx]; |x|^2 [P]; the
// window's triples [3][P][ldb] (ldb odd); each warp's triple of a group
// it continues [kWarps][3][P]; the window table (wpos [kGw + 1], woff
// [kGw], the group each warp continues [kWarps], a word of live bits a
// tile the block spans [R + 1]); then cap + kS staged slots: centroids
// [][ldc], |c|^2, ids and window group. Rows of x and of the centroids
// hold D rounded up to 4 (zeros past D); x rows are a multiple of 4
// floats apart but not of 8, so that 8 neighbouring rows' float4s fall
// in 8 different 16-byte bank groups.
struct Layout {
  int ldx, ldc, ldb, gw;
  int x2s, buf, pbuf, wpos, woff, wcont, wlive, cs, c2s, ids, grp, total;
};

__host__ __device__ inline Layout layout(int r, int d, int g, int cap) {
  Layout l;
  const int pts = 32 * r;
  l.ldc = (d + 3) & ~3;
  l.ldx = (l.ldc / 4) % 2 == 0 ? l.ldc + 4 : l.ldc;
  l.gw = g < 1 ? 1 : (g < kGw ? g : kGw);
  l.ldb = l.gw | 1;
  l.x2s = pts * l.ldx;
  l.buf = l.x2s + pts;
  l.pbuf = l.buf + 3 * pts * l.ldb;
  l.wpos = l.pbuf + kWarps * 3 * pts;
  l.woff = l.wpos + kGw + 1;
  l.wcont = l.woff + kGw;
  l.wlive = l.wcont + kWarps;
  l.cs = (l.wlive + r + 1 + 3) & ~3;
  l.c2s = l.cs + (cap + kS) * l.ldc;
  l.ids = l.c2s + cap + kS;
  l.grp = l.ids + cap + kS;
  l.total = l.grp + cap + kS;
  return l;
}

// Each group's live length and the live slots laid out back to back:
// off[g] = the first compact slot of group g, off[G] = their number;
// src[f] = the (g * lmax + slot) of compact slot f. One block.
__global__ void __launch_bounds__(kPlanThreads)
ga_plan_kernel(const int* __restrict__ ids, int g, int lmax,
               int* __restrict__ off, int* __restrict__ src) {
  __shared__ int wsum[kPlanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = blockDim.x >> 5;
  // 1. live lengths, a warp a group: the last 32-slot word with a live id
  for (int gi = warp; gi < g; gi += nw) {
    int len = 0;
    for (int s0 = lmax > 0 ? ((lmax - 1) / 32) * 32 : -1; s0 >= 0;
         s0 -= 32) {
      const int s = s0 + lane;
      const unsigned live = __ballot_sync(
          kAll, s < lmax && ids[(size_t)gi * lmax + s] >= 0);
      if (live) {
        len = s0 + 32 - __clz(live);
        break;
      }
    }
    if (lane == 0) off[gi + 1] = len;
  }
  __syncthreads();
  // 2. off[i + 1] = len[0] + ... + len[i]; thread t owns a run of groups
  const int per = (g + blockDim.x - 1) / blockDim.x;
  const int lo = min(g, t * per), hi = min(g, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += off[i + 1];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < nw ? wsum[lane] : 0;
    int w = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kAll, w, o);
      if (lane >= o) w += u;
    }
    if (lane < nw) wsum[lane] = w - v;
  }
  __syncthreads();
  int run = wsum[warp] + incl - sum;
  for (int i = lo; i < hi; ++i) {
    run += off[i + 1];
    off[i + 1] = run;
  }
  if (t == 0) off[0] = 0;
  __syncthreads();
  // 3. the compact slot table
  for (int e = t; e < g * lmax; e += blockDim.x) {
    const int gi = e / lmax, s = e - gi * lmax;
    const int base = off[gi];
    if (s < off[gi + 1] - base) src[base + s] = e;
  }
}

// The running (min, its id, second min) of a lane's R points over the
// slots it has seen of the current group. The first kernel's update,
//   if (dd < m1) { m2 = m1; m1 = dd; a1 = id; }
//   else if (dd < m2) m2 = dd;
// without branches: m2 = min(m2, max(m1, dd)), m1 = min(m1, dd), the id
// taken on a strict <, so the first slot wins a tie. The two agree bit
// for bit: dd is never NaN (fmaxf with 0) nor -0, and fminf and fmaxf
// return one of their operands.
template <int R>
struct State {
  float m1[R], m2[R];
  int a1[R];
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m1[r] = CUDART_INF_F;
      m2[r] = CUDART_INF_F;
      a1[r] = -1;
    }
  }
  __device__ __forceinline__ void update(int r, float dd, int id) {
    a1[r] = dd < m1[r] ? id : a1[r];
    m2[r] = fminf(m2[r], fmaxf(m1[r], dd));
    m1[r] = fminf(m1[r], dd);
  }
};

// Merges a later piece (m1, a1, m2) of a group into the triple at
// shared offsets t0, t1 = t0 + stride, t2 = t0 + 2 stride, which holds
// the earlier pieces: the earlier wins a tie.
__device__ __forceinline__ void merge_into(int t0, int stride, float m1,
                                           int a1, float m2) {
  const float b1 = sm[t0], b2 = sm[t0 + 2 * stride];
  sm[t0 + 2 * stride] = fminf(fminf(b2, m2), fmaxf(b1, m1));
  if (m1 < b1) {
    sm[t0] = m1;
    sti(t0 + stride, a1);
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
ga_kernel(const float* __restrict__ x, const float* __restrict__ x2,
          const float* __restrict__ cg, const float* __restrict__ c2g,
          const int* __restrict__ ids, const unsigned char* __restrict__ mask,
          const int* __restrict__ off, const int* __restrict__ src,
          float* __restrict__ best_out, int* __restrict__ idx_out,
          float* __restrict__ gmin_out, int* __restrict__ garg_out,
          float* __restrict__ gmin2_out, int n, int d, int g, int tile_n,
          int cap, bool vec, bool xvec) {
  constexpr int kP = 32 * R;            // points a block owns
  const Layout l = layout(R, d, g, cap);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t row0 = (size_t)blockIdx.x * kP;
  const int rows = (int)min((size_t)kP, (size_t)n - row0);
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  const int bstride = kP * l.ldb;       // one of the three triple arrays

  // the block's x and |x|^2, zeros past n and past d
  const int dp = l.ldc;                 // d rounded up to 4
  if (xvec) {
    for (int e = t; e < kP * (dp / 4); e += kThreads) {
      const int p = e / (dp / 4), col = 4 * (e - p * (dp / 4));
      const bool ok = p < rows;
      cp16z(sbase + 4u * (p * l.ldx + col), ok ? x + (row0 + p) * d + col : x,
            ok ? 16 : 0);
    }
  } else {
    for (int e = t; e < kP * dp; e += kThreads) {
      const int p = e / dp, col = e - p * dp;
      const bool ok = p < rows && col < d;
      cp4(sbase + 4u * (p * l.ldx + col), ok ? x + (row0 + p) * d + col : x,
          ok ? 4 : 0);
    }
  }
  for (int p = t; p < kP; p += kThreads)
    cp4(sbase + 4u * (l.x2s + p), p < rows ? x2 + row0 + p : x2,
        p < rows ? 4 : 0);
  const int tile0 = (int)(row0 / tile_n);
  const int tile1 = (int)((row0 + rows - 1) / tile_n);
  float best = CUDART_INF_F;            // thread t's point t
  int best_id = -1;

  for (int gw0 = 0; gw0 < g; gw0 += l.gw) {
    const int gw = min(l.gw, g - gw0);
    // the window table: each group's live slots where any of the
    // block's tiles has it live, at back-to-back positions wpos
    if (warp == 0) {
      int len = 0, o = 0;
      if (lane < gw) {
        o = off[gw0 + lane];
        len = off[gw0 + lane + 1] - o;
      }
      bool live = false;
      for (int tl = tile0; tl <= tile1; ++tl) {
        const bool lv = lane < gw && mask[(size_t)tl * g + gw0 + lane];
        const unsigned word = __ballot_sync(kAll, lv);
        if (lane == 0) sti(l.wlive + tl - tile0, (int)word);
        live |= lv;
      }
      if (!live) len = 0;
      int incl = len;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int v = __shfl_up_sync(kAll, incl, s);
        if (lane >= s) incl += v;
      }
      sti(l.wpos + lane, incl - len);
      if (lane == 31) sti(l.wpos + 32, incl);
      sti(l.woff + lane, o);
    }
    for (int e = t; e < bstride; e += kThreads) {
      sm[l.buf + e] = CUDART_INF_F;
      sti(l.buf + bstride + e, -1);
      sm[l.buf + 2 * bstride + e] = CUDART_INF_F;
    }
    __syncthreads();
    const int staged = ldi(l.wpos + gw);

    for (int b0 = 0; b0 < staged; b0 += cap) {
      const int nb = min(staged - b0, cap);
      // the batch's slots, a thread a slot
      for (int f = t; f < nb; f += kThreads) {
        const int sf = b0 + f;
        int i = 0;
        while (ldi(l.wpos + i + 1) <= sf) ++i;
        const int srow = src[ldi(l.woff + i) + sf - ldi(l.wpos + i)];
        sti(l.grp + f, i);
        const float* crow = cg + (size_t)srow * d;
        const uint32_t dst = sbase + 4u * (l.cs + f * l.ldc);
        if (vec) {
          for (int col = 0; col < d; col += 4) cp16(dst + 4u * col, crow + col);
        } else {
          for (int col = 0; col < dp; ++col)
            cp4(dst + 4u * col, col < d ? crow + col : crow, col < d ? 4 : 0);
        }
        cp4(sbase + 4u * (l.c2s + f), c2g + srow, 4);
        cp4(sbase + 4u * (l.ids + f), ids + srow, 4);
      }
      cp_commit();
      cp_wait_all();
      __syncthreads();

      // this warp's range [a, e) of the batch, in whole chunks
      const int chunks = (nb + kS - 1) / kS;
      const int a = kS * (warp * chunks / kWarps);
      const int e = min(nb, kS * ((warp + 1) * chunks / kWarps));
      if (a < e) {
        State<R> st;
        st.reset();
        const int first = ldi(l.grp + a);
        // the first group goes to the side buffer where it started
        // before this range (in an earlier warp's range or batch)
        const bool cont = b0 + a != ldi(l.wpos + first);
        int cur = first;
        float xx[R];
#pragma unroll
        for (int r = 0; r < R; ++r) xx[r] = sm[l.x2s + lane + 32 * r];
        auto finish = [&](int gi) {
          const bool side = cont && gi == first;
          const int base = side ? l.pbuf + warp * 3 * kP : l.buf + gi;
          const int step = side ? 1 : l.ldb;
          const int arr = side ? kP : bstride;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int o = base + (lane + 32 * r) * step;
            sm[o] = st.m1[r];
            sti(o + arr, st.a1[r]);
            sm[o + 2 * arr] = st.m2[r];
          }
        };
        const float4* sm4 = reinterpret_cast<const float4*>(sm);
        const int x4 = lane * l.ldx / 4, ldx4 = l.ldx / 4, ldc4 = l.ldc / 4;
        for (int f0 = a; f0 < e; f0 += kS) {
          float acc[R][kS];
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int j = 0; j < kS; ++j) acc[r][j] = 0.0f;
          const int c4 = (l.cs + f0 * l.ldc) / 4;
          // four d at a time, in d order; past d both sides are 0
#pragma unroll 2
          for (int k = 0; k < dp / 4; ++k) {
            float4 xv[R], cv[kS];
#pragma unroll
            for (int r = 0; r < R; ++r) xv[r] = sm4[x4 + 32 * r * ldx4 + k];
#pragma unroll
            for (int j = 0; j < kS; ++j) cv[j] = sm4[c4 + j * ldc4 + k];
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int j = 0; j < kS; ++j) {
                float v = acc[r][j];
                v = fmaf(xv[r].x, cv[j].x, v);
                v = fmaf(xv[r].y, cv[j].y, v);
                v = fmaf(xv[r].z, cv[j].z, v);
                acc[r][j] = fmaf(xv[r].w, cv[j].w, v);
              }
          }
#pragma unroll
          for (int j = 0; j < kS; ++j) {
            const int f = f0 + j;
            if (f >= e) break;
            const int gi = ldi(l.grp + f);
            if (gi != cur) {
              finish(cur);
              cur = gi;
              st.reset();
            }
            const int id = ldi(l.ids + f);
            const float c2 = sm[l.c2s + f];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float dd = id >= 0
                  ? fmaxf(xx[r] - 2.0f * acc[r][j] + c2, 0.0f) : CUDART_INF_F;
              st.update(r, dd, id);
            }
          }
        }
        finish(cur);
        if (lane == 0) sti(l.wcont + warp, cont ? first : -1);
      } else if (lane == 0) {
        sti(l.wcont + warp, -1);
      }
      __syncthreads();
      // the pieces of groups continued from an earlier range, merged
      // in warp order
      for (int p = t; p < kP; p += kThreads) {
        for (int w = 0; w < kWarps; ++w) {
          const int gi = ldi(l.wcont + w);
          if (gi < 0) continue;
          const int o = l.pbuf + w * 3 * kP + p;
          merge_into(l.buf + p * l.ldb + gi, bstride, sm[o], ldi(o + kP),
                     sm[o + 2 * kP]);
        }
      }
      __syncthreads();
    }

    // the best over live groups, in group order, from loads alone (so
    // that they all issue at once); then dead blocks read (inf, -1, inf)
    if (t < rows) {
      const unsigned live =
          (unsigned)ldi(l.wlive + (int)((row0 + t) / tile_n) - tile0);
      const int o = l.buf + t * l.ldb;
      for (int gi = 0; gi < gw; ++gi) {
        const float m1 = sm[o + gi];
        if (((live >> gi) & 1u) && m1 < best) {
          best = m1;
          best_id = ldi(o + bstride + gi);
        }
      }
      const unsigned all = gw == 32 ? ~0u : (1u << gw) - 1u;
      if (live != all) {
        for (int gi = 0; gi < gw; ++gi) {
          if ((live >> gi) & 1u) continue;
          sm[o + gi] = CUDART_INF_F;
          sti(o + bstride + gi, -1);
          sm[o + 2 * bstride + gi] = CUDART_INF_F;
        }
      }
    }
    __syncthreads();
    // the window's part of the block's rows; where the window is every
    // group and the rows are unpadded, one contiguous run, in float4s
    // where it starts on 16 bytes
    const size_t first_out = row0 * g + gw0;
    if (gw == g && l.ldb == gw && first_out % 4 == 0 && (rows * g) % 4 == 0) {
      const int n4 = rows * g / 4;
      const float4* b4 = reinterpret_cast<const float4*>(sm + l.buf);
      const int s4 = bstride / 4;
      for (int e = t; e < n4; e += kThreads) {
        reinterpret_cast<float4*>(gmin_out + first_out)[e] = b4[e];
        reinterpret_cast<float4*>(garg_out + first_out)[e] = b4[s4 + e];
        reinterpret_cast<float4*>(gmin2_out + first_out)[e] = b4[2 * s4 + e];
      }
    } else {
      // element e = p gw + gi, stepped by kThreads without a divide
      const int dp_ = kThreads / gw, dg = kThreads - dp_ * gw;
      int p = t / gw, gi = t - p * gw;
      for (int e = t; e < rows * gw; e += kThreads) {
        const size_t o = (row0 + p) * g + gw0 + gi;
        const int b = l.buf + p * l.ldb + gi;
        gmin_out[o] = sm[b];
        garg_out[o] = ldi(b + bstride);
        gmin2_out[o] = sm[b + 2 * bstride];
        p += dp_;
        gi += dg;
        if (gi >= gw) {
          gi -= gw;
          ++p;
        }
      }
    }
    __syncthreads();
  }
  cp_wait_all();                        // an empty window loop (g == 0)
  if (t < rows) {
    best_out[row0 + t] = best;
    idx_out[row0 + t] = best_id;
  }
}

// ---------------------------------------------------------------------
// The port's first kernel, kept as the yardstick that ga_kernel is held
// to bit for bit and timed against; no path of the port launches it.
// One CTA per tile of tile_n points, one thread per point; the tile's
// points transposed in shared memory, [d][tile_n + 1]; a live group's
// slots streamed through shared memory 32 at a time, every slot of a
// chunk computed (pads too) with 32 accumulators a thread; the (N, G)
// outputs written with a stride of G per thread.
constexpr int kSlots = 32;   // centroid slots per shared-memory chunk

__global__ void ga_simple_kernel(const float* __restrict__ x,
                                 const float* __restrict__ x2,
                                 const float* __restrict__ cg,
                                 const float* __restrict__ c2g,
                                 const int* __restrict__ ids,
                                 const unsigned char* __restrict__ mask,
                                 float* __restrict__ best_out,
                                 int* __restrict__ idx_out,
                                 float* __restrict__ gmin_out,
                                 int* __restrict__ garg_out,
                                 float* __restrict__ gmin2_out,
                                 int n, int d, int g, int lmax) {
  const int tile_n = blockDim.x;
  const int xs_stride = tile_n + 1;
  float* xs = sm;                                // [d][tile_n + 1]
  float* cs = xs + (size_t)d * xs_stride;        // [kSlots][d]
  float* c2s = cs + kSlots * d;                  // [kSlots]
  int* ids_s = reinterpret_cast<int*>(c2s + kSlots);  // [kSlots]

  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const size_t row0 = (size_t)tile * tile_n;
  const size_t row = row0 + t;
  const bool valid = row < (size_t)n;

  // the tile's points, transposed into shared memory (pad rows = 0)
  const int tile_elems = tile_n * d;
  for (int e = t; e < tile_elems; e += tile_n) {
    const int r = e / d, col = e - r * d;
    const size_t gr = row0 + r;
    xs[col * xs_stride + r] = gr < (size_t)n ? x[gr * d + col] : 0.0f;
  }
  const float xx = valid ? x2[row] : 0.0f;
  float best = CUDART_INF_F;
  int best_id = -1;
  __syncthreads();

  for (int gi = 0; gi < g; ++gi) {
    const size_t out = row * g + gi;
    if (!mask[(size_t)tile * g + gi]) {            // dead block
      if (valid) {
        gmin_out[out] = CUDART_INF_F;
        garg_out[out] = -1;
        gmin2_out[out] = CUDART_INF_F;
      }
      continue;
    }
    float m1 = CUDART_INF_F, m2 = CUDART_INF_F;
    int a1 = -1;
    for (int s0 = 0; s0 < lmax; s0 += kSlots) {
      const int ns = min(kSlots, lmax - s0);
      __syncthreads();                             // cs is free again
      const float* src = cg + ((size_t)gi * lmax + s0) * d;
      for (int e = t; e < kSlots * d; e += tile_n)
        cs[e] = e < ns * d ? src[e] : 0.0f;
      if (t < kSlots) {
        c2s[t] = t < ns ? c2g[(size_t)gi * lmax + s0 + t] : 0.0f;
        ids_s[t] = t < ns ? ids[(size_t)gi * lmax + s0 + t] : -1;
      }
      __syncthreads();

      float acc[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) acc[j] = 0.0f;
      for (int col = 0; col < d; ++col) {
        const float xv = xs[col * xs_stride + t];
#pragma unroll
        for (int j = 0; j < kSlots; ++j)
          acc[j] = fmaf(xv, cs[j * d + col], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int id = ids_s[j];
        const float dd = id >= 0
            ? fmaxf(xx - 2.0f * acc[j] + c2s[j], 0.0f) : CUDART_INF_F;
        if (dd < m1) {
          m2 = m1;
          m1 = dd;
          a1 = id;
        } else if (dd < m2) {
          m2 = dd;
        }
      }
    }
    if (valid) {
      gmin_out[out] = m1;
      garg_out[out] = a1;
      gmin2_out[out] = m2;
    }
    if (m1 < best) {
      best = m1;
      best_id = a1;
    }
  }
  if (valid) {
    best_out[row] = best;
    idx_out[row] = best_id;
  }
}

}  // namespace

extern "C" {

// int32 scratch the launch needs: off (g + 1) and src (g * lmax)
int grouped_assign_scratch_ints(int g, int lmax) {
  return g + 1 + g * lmax;
}

}  // extern "C"

namespace {

// Slots a batch of ga_kernel<r> stages at (d, g): as many as the rest of
// a block's shared memory holds
long long batch_cap(int r, int d, int g) {
  const Layout fixed = layout(r, d, g, 0);
  return ((long long)kSmemMax / 4 - fixed.total) / (fixed.ldc + 3);
}

// Points a lane of ga_kernel takes at (d, g): the largest R of 8, 4, 2
// and 1 that leaves a batch of kMinCap slots, or 0 where none does. A
// function of the shape alone, so a launch picks its variant up front.
int points_for(int d, int g) {
  for (int r = 8; r >= 1; r /= 2)
    if (batch_cap(r, d, g) >= kMinCap) return r;
  return 0;
}

template <int R>
void launch_ga(const float* x, const float* x2, const float* cg,
               const float* c2g, const int* ids, const unsigned char* mask,
               const int* off, const int* src, float* best, int* idx,
               float* gmin, int* garg, float* gmin2, int n, int d, int g,
               int tile_n, bool vec, bool xvec, int smem, int cap,
               cudaStream_t st) {
  const int blocks = (n + 32 * R - 1) / (32 * R);
  ga_kernel<R><<<blocks, kThreads, smem, st>>>(
      x, x2, cg, c2g, ids, mask, off, src, best, idx, gmin, garg, gmin2, n,
      d, g, tile_n, cap, vec, xvec);
}

template <int R>
cudaError_t allow_smem(int smem) {
  return cudaFuncSetAttribute(
      ga_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

extern "C" {

// Points a lane of ga_kernel takes at (d, g) (8, 4, 2 or 1), or 0 for a
// shape the launch refuses
int grouped_assign_points(int d, int g) {
  return d < 1 || g < 0 ? 0 : points_for(d, g);
}

// x (n, d) f32; x2 (n,) f32; cg (g, lmax, d) f32; c2g (g, lmax) f32;
// ids (g, lmax) i32 (-1 = pad); mask (ceil(n/tile_n), g) u8; scratch
// scratch_ints i32 (at least grouped_assign_scratch_ints(g, lmax)).
// Outputs: best (n,) f32, idx (n,) i32, gmin/garg/gmin2 (n, g).
// Launches ga_plan_kernel, then ga_kernel with grouped_assign_points(d,
// g) points a lane; returns cudaErrorInvalidValue for a shape it cannot
// take (before any launch), else cudaGetLastError() after each launch,
// and launches ga_kernel only where the plan's launch succeeded.
int grouped_assign_launch(const void* x, const void* x2, const void* cg,
                          const void* c2g, const void* ids,
                          const void* mask, void* best, void* idx,
                          void* gmin, void* garg, void* gmin2, void* scratch,
                          int scratch_ints, int n, int d, int g, int lmax,
                          int tile_n, void* stream) {
  // tile_n >= 32: a block's 32 R points span at most R + 1 tiles
  if (n < 1 || d < 1 || g < 0 || lmax < 0 || tile_n < 32 ||
      scratch_ints < grouped_assign_scratch_ints(g, lmax))
    return (int)cudaErrorInvalidValue;
  const int r = points_for(d, g);
  if (r == 0) return (int)cudaErrorInvalidValue;
  const int cap = (int)batch_cap(r, d, g);
  const int smem = 4 * layout(r, d, g, cap).total;
  cudaError_t e = r == 8   ? allow_smem<8>(smem)
                  : r == 4 ? allow_smem<4>(smem)
                  : r == 2 ? allow_smem<2>(smem)
                           : allow_smem<1>(smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* off = static_cast<int*>(scratch);
  int* src = off + g + 1;
  ga_plan_kernel<<<1, kPlanThreads, 0, st>>>(static_cast<const int*>(ids),
                                            g, lmax, off, src);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // 16-byte copies where every centroid row starts on 16 bytes
  const bool vec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(cg) & 15) == 0;
  const bool xvec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const float *xf = static_cast<const float*>(x),
              *x2f = static_cast<const float*>(x2),
              *cgf = static_cast<const float*>(cg),
              *c2f = static_cast<const float*>(c2g);
  const int* idsi = static_cast<const int*>(ids);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  float *bf = static_cast<float*>(best), *g1 = static_cast<float*>(gmin),
        *g2 = static_cast<float*>(gmin2);
  int *ii = static_cast<int*>(idx), *ga = static_cast<int*>(garg);
#define GA_LAUNCH(R)                                                    \
  launch_ga<R>(xf, x2f, cgf, c2f, idsi, m, off, src, bf, ii, g1, ga, g2, \
               n, d, g, tile_n, vec, xvec, smem, cap, st)
  if (r == 8) GA_LAUNCH(8);
  else if (r == 4) GA_LAUNCH(4);
  else if (r == 2) GA_LAUNCH(2);
  else GA_LAUNCH(1);
#undef GA_LAUNCH
  return (int)cudaGetLastError();
}

// The first kernel, with the same arguments but the scratch: the
// yardstick. Returns cudaErrorInvalidValue where its shared memory,
// d * (tile_n + 1) + 32 * d + 64 floats, exceeds a block's.
int grouped_assign_simple_launch(const void* x, const void* x2,
                                 const void* cg, const void* c2g,
                                 const void* ids, const void* mask,
                                 void* best, void* idx, void* gmin,
                                 void* garg, void* gmin2, int n, int d,
                                 int g, int lmax, int tile_n, void* stream) {
  if (tile_n < 32 || tile_n > 1024 || n < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  const long long smem =
      4LL * ((long long)d * (tile_n + 1) + kSlots * d + 2 * kSlots);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ga_simple_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n + tile_n - 1) / tile_n;
  ga_simple_kernel<<<tiles, tile_n, (int)smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(x2),
      static_cast<const float*>(cg), static_cast<const float*>(c2g),
      static_cast<const int*>(ids), static_cast<const unsigned char*>(mask),
      static_cast<float*>(best), static_cast<int*>(idx),
      static_cast<float*>(gmin), static_cast<int*>(garg),
      static_cast<float*>(gmin2), n, d, g, lmax);
  return (int)cudaGetLastError();
}

const char* grouped_assign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
