// Backward of the fused SSD intra-chunk pass (Mamba-2), for sm_90a.
//
// Replaces no TPU kernel: the Pallas kernel repro/kernels/ssd_intra.py
// (ssd_intra -> _ssd_intra_kernel) has no backward, and the reference
// trains through plain jnp. The port's training path runs the forward
// kernel (csrc/ssd_intra.cu), so its gradient is this kernel, launched
// from the autograd Function in ssd_intra.py.
//
// A cell is one (batch x chunk, head); head h reads the C and B of group
// h / rep. With, for j <= i (zero above the diagonal),
//
//     L_ij = exp(cum_i - cum_j)     M_ij = (c_i . b_j) L_ij
//     y_i  = sum_j M_ij x_j         dS_ij = dy_i . x_j
//
// the gradients are
//
//     dx   = M^T dy
//     dC   = (dS o L) B              dB = (dS o L)^T C
//     dcum_i = sum_j (dS o M)_ij - sum_k (dS o M)_ki
//
// dB and dC sum over the heads of a group (at hymba-1.5b one group holds
// all 25 heads). Two kernels:
//   1. ssd_bwd_cell, two blocks a cell (Q <= 128, the configs' chunk),
//      256 threads each, in the forward kernel's pattern (csrc/ssd_intra.cu):
//      register tiles of 8 x 8 fp32 accumulators a thread, so that 16
//      floats a lane from shared memory feed 64 FFMAs, and a cp.async
//      ring of three stages, two in flight while one is computed. Both
//      stage the cell's C, B and cum first.
//      - the dS block (blockIdx.y = 0) holds the whole Q x Q dS = dy x^T
//        in registers, rows ty + 16 k and columns tx + 16 m of thread
//        (ty, tx), and streams 16-column slices of dy and x; a pair of
//        16-row groups wholly above the diagonal (m > k) is never formed,
//        a case compiled away. Then, in the same tiles, G = C B^T, L,
//        W = dS o L (to shared memory, over the ring) and dS o M, whose
//        row sums meet by shuffles and column sums through shared
//        memory: dcum. Last dC = W B and dB = W^T C, a row of each a
//        thread pair (row r's dC walks r + 1 columns, its dB Q - r rows:
//        every thread the same work), into this head's partials.
//      - the dx block (blockIdx.y = 1) is the forward turned over: it
//        owns rows j of dx = M^T dy and streams 32-row i-blocks of dy;
//        the scores M_ij of an i-block go to shared memory, rows j that
//        lie wholly after it take no part (a case compiled for each
//        i-block), and dx_j += sum_i M_ij dy_i in 8 x 8 tiles.
//      dS blocks come first in the grid, so the last wave holds the
//      dx blocks, which take less time.
//   2. ssd_bwd_reduce, a thread an element of dC and dB: sums the
//      group's heads' partials in order.
// A chunk of more rows than 128 (a config's chunk of 256, say) takes
// another route, ssd_intra_bwd_wide_launch: its cell's causal Q x Q
// splits into tiles of 128 x 128 on and below the diagonal, and
// ssd_bwd_tile runs the two blocks above on each tile, the i rows of
// one tile of 128 against the j rows of another (off the diagonal every
// 16-row pair is formed). Each tile writes its partial dC and dcum row
// sums (its i rows), dB and dcum column sums (its j rows) and dx (its j
// rows) to its own slot of a workspace, and ssd_bwd_reduce_tiled adds
// the slots of each element in a fixed order, heads then tiles. The
// partials cost (Q / 128 + 1) / 2 times dx's bytes more than a cell of
// 128 rows writes; the route is there to be right, not yet fast.
// Every output element is summed by one thread in a fixed order: no
// atomics, and two calls give the same bits. All fp32 FFMA, as in the
// forward (TF32 misses the 1e-4 bound, and wgmma's tf32 operands must
// be K-major, which dx = M^T dy, dB = W^T C and the column sums are
// not). Above the diagonal and past Q, L is selected to 0, never
// multiplied (exp of a positive number may be inf there).
//
// Bound on the card: at hymba-1.5b's training step (b 2, s 2048, Q 128,
// N 16, P 128, 25 heads: 800 cells) the causal halves of dS (Q x Q x P),
// dx (Q x Q x P), M, dC and dB (Q x Q x N each) are 4.0e9 flops (0.060 ms
// at the fp32 FFMA peak) against 159 MB of C, B, x, cum and dy in and
// dC, dB, dx, dcum out (0.047 ms at 3.35 TB/s): about balanced. The
// register tiles form 36 of dS's 64 16 x 16 pairs and 20 of dx's 32
// (16 x 32) pairs, 1.1x to 1.25x the causal half; 1,600 blocks of 96 KB
// at two an SM.
#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kQ = 128;         // rows of a cell the kernel takes at most
constexpr int kThreads = 256;   // 16 x 16
constexpr int kStages = 3;      // ring stages
constexpr int kPC = 16;         // columns of dy and x a dS stage holds
constexpr int kLdC = kPC + 4;   // their row stride
constexpr int kIB = 32;         // rows of dy a dx stage holds
constexpr int kLdS = kIB + 4;   // the dx block's scores row stride
constexpr int kLdW = kQ + 1;    // W's row stride: odd, so a column walk
                                // and a row walk both hit distinct banks
// the dS block's ring, which W takes over once dS is formed
constexpr int kRingW = kStages * 2 * kQ * kLdC > kQ * kLdW
                           ? kStages * 2 * kQ * kLdC
                           : kQ * kLdW;

struct Shape {
  int heads, groups, rep, q, n, p;
};

__device__ __forceinline__ uint32_t saddr(const float* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes from src to shared dst; bytes 0 writes zeros
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   saddr(dst)),
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

// rows [row0, row0 + rows) x columns [col0, col0 + width) of src (row
// stride rs, the last axis contiguous) into dst (row stride ld), zero
// outside rows < q and columns < w; width a multiple of 4
template <bool kVec>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      long long rs, int row0, int rows,
                                      int q, int col0, int width, int w) {
  const int t = threadIdx.x;
  if (kVec) {
    const int w4 = width / 4;
    for (int e = t; e < rows * w4; e += kThreads) {
      const int r = e / w4, c = 4 * (e - r * w4);
      const bool ok = row0 + r < q && col0 + c < w;
      cp16(dst + r * ld + c,
           ok ? src + (long long)(row0 + r) * rs + col0 + c : src,
           ok ? 16 : 0);
    }
  } else {
    for (int e = t; e < rows * width; e += kThreads) {
      const int r = e / width, c = e - r * width;
      const bool ok = row0 + r < q && col0 + c < w;
      cp4(dst + r * ld + c,
          ok ? src + (long long)(row0 + r) * rs + col0 + c : src,
          ok ? 4 : 0);
    }
  }
}

__host__ __device__ inline int n_ld(int n) {
  const int n4 = (n + 3) & ~3;
  return (n4 / 4) % 2 == 0 ? n4 + 4 : n4;    // an odd number of float4s
}

// floats of shared memory: C, B and cum of the cell, then the larger of
// the two blocks' own regions; kPS the columns of dx a dx block owns
__host__ __device__ inline size_t smem_floats(int n, int kPS) {
  const size_t common = 2 * (size_t)kQ * n_ld(n) + kQ;
  const size_t ds_side = kRingW + kQ + 16 * kQ;
  const size_t dx_side = (size_t)kQ * kLdS + (size_t)kStages * kIB * kPS;
  return common + (ds_side > dx_side ? ds_side : dx_side);
}

// pointers and sizes of one cell, or of one tile (i rows x j columns)
// of a wide cell: the i side is C, dy and cum_i, the j side B, x and
// cum_j; in a whole cell both sides are the same rows
struct Cell {
  const float* x;                // row 0 of the j side's x
  const float* dy;               // row 0 of the i side's dy
  long long xhs;                 // their row stride
  int qi, qj;                    // rows of each side that lie in the cell
  int n, p, n4, ldn;
  const float* csm;              // C of the i side, B of the j side and
  const float* bsm;              // both sides' cum, in shared memory
  const float* cumi;
  const float* cumj;
};

// ---------------------------------------------------------------------------
// the dS block: dcum, and this head's dC and dB partials
// ---------------------------------------------------------------------------
// kTiled: a tile of a wide cell, whose row sums and column sums of
// dS o M go to dcum_row and csp_out apart; else a whole cell, whose dcum
// goes to dcum_row. kDiag: the tile lies on the diagonal (a whole cell
// does), so that pairs of 16-row groups above it are never formed.
template <bool kVec, bool kTiled, bool kDiag>
__device__ __forceinline__ void ds_block(const Cell& cl, float* region,
                                         float* dcum_row, long long dcum_rs,
                                         float* csp_out, float* pch,
                                         float* pbh) {
  static_assert(kTiled || kDiag, "a whole cell is a diagonal tile");
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int qi = cl.qi, qj = cl.qj;
  float* ring = region;             // kStages x (dy, x) slices; then W
  float* wsm = region;
  float* rs = region + kRingW;      // dS o M row sums [kQ]
  float* csp = rs + kQ;             // column sums of each ty [16][kQ]
  const int nch = (cl.p + kPC - 1) / kPC;
  auto load_slice = [&](int c) {
    float* st = ring + (c % kStages) * 2 * kQ * kLdC;
    stage<kVec>(st, kLdC, cl.dy, cl.xhs, 0, kQ, qi, c * kPC, kPC, cl.p);
    stage<kVec>(st + kQ * kLdC, kLdC, cl.x, cl.xhs, 0, kQ, qj, c * kPC, kPC,
                cl.p);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nch) load_slice(s);
    cp_commit();                    // C, B (and cum) ride with the first
  }

  // dS of rows ty + 16 k, columns tx + 16 m; on the diagonal m > k is
  // above it
  float acc[8][8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int m = 0; m <= (kDiag ? k : 7); ++m) acc[k][m] = 0.f;
  for (int c = 0; c < nch; ++c) {
    if (c + kStages - 1 < nch) load_slice(c + kStages - 1);
    cp_commit();
    cp_wait<kStages - 1>();         // slice c has landed
    __syncthreads();
    const float* ys = ring + (c % kStages) * 2 * kQ * kLdC;
    const float* xs = ys + kQ * kLdC;
#pragma unroll
    for (int pp = 0; pp < kPC; pp += 4) {
      float4 b[8];
#pragma unroll
      for (int m = 0; m < 8; ++m)
        b[m] = *reinterpret_cast<const float4*>(&xs[(tx + 16 * m) * kLdC + pp]);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float4 a =
            *reinterpret_cast<const float4*>(&ys[(ty + 16 * k) * kLdC + pp]);
#pragma unroll
        for (int m = 0; m <= (kDiag ? k : 7); ++m) {
          float v = acc[k][m];
          v = fmaf(a.x, b[m].x, v);
          v = fmaf(a.y, b[m].y, v);
          v = fmaf(a.z, b[m].z, v);
          acc[k][m] = fmaf(a.w, b[m].w, v);
        }
      }
    }
    __syncthreads();                // the stage is free
  }

  // G = C B^T, L, W = dS o L and dS o M in the same tiles; W over the
  // ring, which every thread is done with
  float csum[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) csum[m] = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = ty + 16 * k;
    float g[8];
#pragma unroll
    for (int m = 0; m <= (kDiag ? k : 7); ++m) g[m] = 0.f;
    for (int nn = 0; nn < cl.n4; nn += 4) {
      const float4 a =
          *reinterpret_cast<const float4*>(&cl.csm[i * cl.ldn + nn]);
#pragma unroll
      for (int m = 0; m <= (kDiag ? k : 7); ++m) {
        const float4 bb = *reinterpret_cast<const float4*>(
            &cl.bsm[(tx + 16 * m) * cl.ldn + nn]);
        float v = g[m];
        v = fmaf(a.x, bb.x, v);
        v = fmaf(a.y, bb.y, v);
        v = fmaf(a.z, bb.z, v);
        g[m] = fmaf(a.w, bb.w, v);
      }
    }
    const float ci = cl.cumi[i];
    float rsum = 0.f;
#pragma unroll
    for (int m = 0; m <= (kDiag ? k : 7); ++m) {
      const int j = tx + 16 * m;
      // select, never multiply: above the diagonal exp may be inf
      const bool in = kDiag ? (j <= i && i < qi) : (i < qi && j < qj);
      const float l = in ? expf(ci - cl.cumj[j]) : 0.f;
      const float w = acc[k][m] * l;
      const float z = w * g[m];
      wsm[i * kLdW + j] = w;
      rsum += z;
      csum[m] += z;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)   // the 16 tx lanes of a row
      rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
    if (tx == 0) rs[i] = rsum;
  }
#pragma unroll
  for (int m = 0; m < 8; ++m) csp[ty * kQ + tx + 16 * m] = csum[m];
  __syncthreads();                  // W, the row sums, the column sums
  if (t < (kTiled ? kQ : qi)) {
    float cs = 0.f;
    for (int y = 0; y < 16; ++y) cs += csp[y * kQ + t];
    if (kTiled) {
      dcum_row[t] = rs[t];
      csp_out[t] = cs;
    } else {
      dcum_row[(long long)t * dcum_rs] = rs[t] - cs;
    }
  }

  // dC_r = sum_{j <= r} W_rj B_j and dB_r = sum_{i >= r} W_ir C_i (off
  // the diagonal every j and every i), a thread pair a row r, eight
  // columns of N a thread each pass; qj >= qi, as j lies before i
  const int r = t / 2, half = t % 2;
  if (r >= qj) return;
  const int jend = kDiag ? r + 1 : qj, ibeg = kDiag ? r : 0;
  for (int n0 = 0; n0 < cl.n4; n0 += 16) {
    const int c0 = n0 + 8 * half;
    const bool has0 = c0 < cl.n4, has1 = c0 + 4 < cl.n4;
    float4 dc[2], db[2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      dc[u] = db[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < jend; ++j) {
      const float w = wsm[r * kLdW + j];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (!(u == 0 ? has0 : has1)) continue;
        const float4 bb =
            *reinterpret_cast<const float4*>(&cl.bsm[j * cl.ldn + c0 + 4 * u]);
        dc[u].x = fmaf(w, bb.x, dc[u].x);
        dc[u].y = fmaf(w, bb.y, dc[u].y);
        dc[u].z = fmaf(w, bb.z, dc[u].z);
        dc[u].w = fmaf(w, bb.w, dc[u].w);
      }
    }
    for (int i = ibeg; i < qi; ++i) {
      const float w = wsm[i * kLdW + r];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (!(u == 0 ? has0 : has1)) continue;
        const float4 cc =
            *reinterpret_cast<const float4*>(&cl.csm[i * cl.ldn + c0 + 4 * u]);
        db[u].x = fmaf(w, cc.x, db[u].x);
        db[u].y = fmaf(w, cc.y, db[u].y);
        db[u].z = fmaf(w, cc.z, db[u].z);
        db[u].w = fmaf(w, cc.w, db[u].w);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float dcv[4] = {dc[u].x, dc[u].y, dc[u].z, dc[u].w};
      const float dbv[4] = {db[u].x, db[u].y, db[u].z, db[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + 4 * u + e;
        if (col < cl.n) {
          pch[(long long)r * cl.n + col] = dcv[e];
          pbh[(long long)r * cl.n + col] = dbv[e];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the dx block: dx = M^T dy, the forward kernel turned over
// ---------------------------------------------------------------------------
// dx rows go to dxp, dxs floats apart. kDiag as in ds_block: off the
// diagonal every row j takes part in every i-block.
template <int kPS, bool kVec, bool kDiag>
__device__ __forceinline__ void dx_block(const Cell& cl, float* region,
                                         float* dxp, long long dxs) {
  constexpr int kC4 = kPS / 64;     // float4 columns a thread keeps
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int qi = cl.qi, qj = cl.qj;
  float* ssm = region;              // M of the i-block, [j][i] [kQ][kLdS]
  float* ring = ssm + kQ * kLdS;    // kStages x kIB rows of dy
  const int nib = (qi + kIB - 1) / kIB;
  auto load_ib = [&](int ib) {
    stage<kVec>(ring + (ib % kStages) * kIB * kPS, kPS, cl.dy, cl.xhs,
                ib * kIB, kIB, qi, 0, kPS, cl.p);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nib) load_ib(s);
    cp_commit();                    // C, B (and cum) ride with the first
  }

  // rows j = ty + 16 k of dx, columns 4 tx .. 4 tx + 3 (+ 64)
  float acc[8][4 * kC4];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int o = 0; o < 4 * kC4; ++o) acc[k][o] = 0.f;

  for (int ib = 0; ib < nib; ++ib) {
    if (ib + kStages - 1 < nib) load_ib(ib + kStages - 1);
    cp_commit();
    cp_wait<kStages - 1>();         // i-block ib has landed
    __syncthreads();
    const float* ys = ring + (ib % kStages) * kIB * kPS;
    const int i0 = ib * kIB;

    // row groups k < kEnd take part: those with a row j <= i0 + 31; each
    // case is compiled on its own, so the loops carry no branch
    auto rows_to = [&](auto kendc) {
      constexpr int kEnd = decltype(kendc)::value;
      // M_ij of rows j = ty + 16 k and columns i0 + tx, i0 + tx + 16
      float sc[kEnd][2];
#pragma unroll
      for (int k = 0; k < kEnd; ++k) sc[k][0] = sc[k][1] = 0.f;
      for (int nn = 0; nn < cl.n4; nn += 4) {
        const float4 c0 = *reinterpret_cast<const float4*>(
            &cl.csm[(i0 + tx) * cl.ldn + nn]);
        const float4 c1 = *reinterpret_cast<const float4*>(
            &cl.csm[(i0 + tx + 16) * cl.ldn + nn]);
#pragma unroll
        for (int k = 0; k < kEnd; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(
              &cl.bsm[(ty + 16 * k) * cl.ldn + nn]);
          float s0 = sc[k][0], s1 = sc[k][1];
          s0 = fmaf(a.x, c0.x, s0);
          s0 = fmaf(a.y, c0.y, s0);
          s0 = fmaf(a.z, c0.z, s0);
          s0 = fmaf(a.w, c0.w, s0);
          s1 = fmaf(a.x, c1.x, s1);
          s1 = fmaf(a.y, c1.y, s1);
          s1 = fmaf(a.z, c1.z, s1);
          s1 = fmaf(a.w, c1.w, s1);
          sc[k][0] = s0;
          sc[k][1] = s1;
        }
      }
#pragma unroll
      for (int k = 0; k < kEnd; ++k) {
        const int j = ty + 16 * k;
#pragma unroll
        for (int mm = 0; mm < 2; ++mm) {
          const int li = tx + 16 * mm, i = i0 + li;
          // select, never multiply: below the diagonal exp may be inf
          const bool in = kDiag ? (i >= j && i < qi) : (i < qi && j < qj);
          ssm[j * kLdS + li] =
              in ? sc[k][mm] * expf(cl.cumi[i] - cl.cumj[j]) : 0.f;
        }
      }
      __syncthreads();              // the scores block complete

      // dx_j += sum_i M_ij dy_i, two i at a time
#pragma unroll 1
      for (int ii = 0; ii < kIB; ii += 2) {
        float2 s2[kEnd];
#pragma unroll
        for (int k = 0; k < kEnd; ++k)
          s2[k] = *reinterpret_cast<const float2*>(
              &ssm[(ty + 16 * k) * kLdS + ii]);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float4 yv[kC4];
#pragma unroll
          for (int h = 0; h < kC4; ++h)
            yv[h] = *reinterpret_cast<const float4*>(
                &ys[(ii + u) * kPS + 64 * h + 4 * tx]);
#pragma unroll
          for (int k = 0; k < kEnd; ++k) {
            const float sv = u == 0 ? s2[k].x : s2[k].y;
#pragma unroll
            for (int h = 0; h < kC4; ++h) {
              acc[k][4 * h + 0] = fmaf(sv, yv[h].x, acc[k][4 * h + 0]);
              acc[k][4 * h + 1] = fmaf(sv, yv[h].y, acc[k][4 * h + 1]);
              acc[k][4 * h + 2] = fmaf(sv, yv[h].z, acc[k][4 * h + 2]);
              acc[k][4 * h + 3] = fmaf(sv, yv[h].w, acc[k][4 * h + 3]);
            }
          }
        }
      }
    };
    switch (kDiag ? ib : 3) {
      case 0: rows_to(std::integral_constant<int, 2>{}); break;
      case 1: rows_to(std::integral_constant<int, 4>{}); break;
      case 2: rows_to(std::integral_constant<int, 6>{}); break;
      default: rows_to(std::integral_constant<int, 8>{}); break;
    }
    __syncthreads();                // the stage and the scores are free
  }

#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int j = ty + 16 * k;
#pragma unroll
    for (int h = 0; h < kC4; ++h) {
      const int col = 64 * h + 4 * tx;
      if (j >= qj || col >= cl.p) continue;
      float* dst = dxp + (long long)j * dxs + col;
      const float* a = &acc[k][4 * h];
      if (kVec) {
        *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], a[2], a[3]);
      } else {
#pragma unroll
        for (int o = 0; o < 4; ++o)
          if (col + o < cl.p) dst[o] = a[o];
      }
    }
  }
}

// C, B (outer, q, groups, n); x, dy, dx (outer, q, heads, p); cum, dcum
// (outer, q, heads); pc, pb (outer, heads, q, n): all contiguous, fp32.
// Grid (cells, 2): blockIdx.y 0 the dS block, 1 the dx block.
template <int kPS, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_cell(const float* __restrict__ C, const float* __restrict__ B,
                 const float* __restrict__ x, const float* __restrict__ cum,
                 const float* __restrict__ dy, float* __restrict__ dx,
                 float* __restrict__ dcum, float* __restrict__ pc,
                 float* __restrict__ pb, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  const int q = sh.q, n = sh.n, p = sh.p;
  const int n4 = (n + 3) & ~3, ldn = n_ld(n);
  float* csm = smem;                          // [kQ][ldn]
  float* bsm = csm + kQ * ldn;                // [kQ][ldn]
  float* cumsm = bsm + kQ * ldn;              // [kQ]
  float* region = cumsm + kQ;

  const int cell = blockIdx.x;
  const int outer = cell / sh.heads, hd = cell % sh.heads, g = hd / sh.rep;
  const long long cgs = (long long)sh.groups * n;     // row stride of C, B
  const long long xhs = (long long)sh.heads * p;      // of x, dy, dx
  const long long co = (long long)outer * q * cgs + (long long)g * n;
  const long long xo = (long long)outer * q * xhs + (long long)hd * p;
  const float* up = cum + (long long)outer * q * sh.heads + hd;

  // the cell's C, B and cum; the copies commit with the ring's first stage
  stage<kVec>(csm, ldn, C + co, cgs, 0, kQ, q, 0, n4, n);
  stage<kVec>(bsm, ldn, B + co, cgs, 0, kQ, q, 0, n4, n);
  for (int r = threadIdx.x; r < kQ; r += kThreads)
    cumsm[r] = r < q ? up[(long long)r * sh.heads] : 0.f;

  const Cell cl{x + xo, dy + xo, xhs, q, q, n, p, n4, ldn, csm, bsm, cumsm,
                cumsm};
  if (blockIdx.y == 0) {
    const long long part = ((long long)outer * sh.heads + hd) * q * n;
    ds_block<kVec, false, true>(cl, region,
                                dcum + (long long)outer * q * sh.heads + hd,
                                sh.heads, nullptr, pc + part, pb + part);
  } else {
    dx_block<kPS, kVec, true>(cl, region, dx + xo, xhs);
  }
}

// tile pairs (ti, tj), tj <= ti, of a cell's causal Q x Q with `tiles`
// tiles a side; the pair (ti, tj) has index n_pairs(ti) + tj
__host__ __device__ inline int n_pairs(int tiles) {
  return tiles * (tiles + 1) / 2;
}

// A wide cell (Q > kQ), one block a kQ x kQ tile (rows i of tile ti,
// columns j of tile tj) and a side. Grid (cells x pairs, 2): blockIdx.y
// 0 the dS side, 1 the dx side. Each writes its tile's partials at its
// slot (cell, pair) of the workspace: pdx (slots, kQ, p) the dx rows of
// tile tj from the i rows of ti; prs, pcs (slots, kQ) the row sums (i
// side) and column sums (j side) of dS o M; pc, pb (slots, kQ, n) this
// head's dC rows (i side) and dB rows (j side).
template <int kPS, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_tile(const float* __restrict__ C, const float* __restrict__ B,
                 const float* __restrict__ x, const float* __restrict__ cum,
                 const float* __restrict__ dy, float* __restrict__ pdx,
                 float* __restrict__ prs, float* __restrict__ pcs,
                 float* __restrict__ pc, float* __restrict__ pb, Shape sh,
                 int tiles) {
  extern __shared__ __align__(16) float smem[];
  const int q = sh.q, n = sh.n, p = sh.p;
  const int n4 = (n + 3) & ~3, ldn = n_ld(n);
  float* csm = smem;                          // [kQ][ldn] C, i side
  float* bsm = csm + kQ * ldn;                // [kQ][ldn] B, j side
  float* cumi = bsm + kQ * ldn;               // [kQ]
  float* cumj = cumi + kQ;                    // [kQ]
  float* region = cumj + kQ;

  const int pairs = n_pairs(tiles);
  const int cell = blockIdx.x / pairs, pair = blockIdx.x % pairs;
  int ti = 0;
  while (n_pairs(ti + 1) <= pair) ++ti;
  const int tj = pair - n_pairs(ti);
  const int i0 = ti * kQ, j0 = tj * kQ;
  const int outer = cell / sh.heads, hd = cell % sh.heads, g = hd / sh.rep;
  const long long cgs = (long long)sh.groups * n;
  const long long xhs = (long long)sh.heads * p;
  const long long co = (long long)outer * q * cgs + (long long)g * n;
  const long long xo = (long long)outer * q * xhs + (long long)hd * p;
  const float* up = cum + (long long)outer * q * sh.heads + hd;

  // the tile's C, B and cum; the copies commit with the ring's first stage
  stage<kVec>(csm, ldn, C + co, cgs, i0, kQ, q, 0, n4, n);
  stage<kVec>(bsm, ldn, B + co, cgs, j0, kQ, q, 0, n4, n);
  for (int r = threadIdx.x; r < kQ; r += kThreads) {
    cumi[r] = i0 + r < q ? up[(long long)(i0 + r) * sh.heads] : 0.f;
    cumj[r] = j0 + r < q ? up[(long long)(j0 + r) * sh.heads] : 0.f;
  }

  const Cell cl{x + xo + (long long)j0 * xhs, dy + xo + (long long)i0 * xhs,
                xhs, min(kQ, q - i0), min(kQ, q - j0), n, p, n4, ldn, csm,
                bsm, cumi, cumj};
  const long long slot = (long long)cell * pairs + pair;
  if (blockIdx.y == 0) {
    float* pch = pc + slot * kQ * n;
    float* pbh = pb + slot * kQ * n;
    if (ti == tj)
      ds_block<kVec, true, true>(cl, region, prs + slot * kQ, 1,
                                 pcs + slot * kQ, pch, pbh);
    else
      ds_block<kVec, true, false>(cl, region, prs + slot * kQ, 1,
                                  pcs + slot * kQ, pch, pbh);
  } else {
    if (ti == tj)
      dx_block<kPS, kVec, true>(cl, region, pdx + slot * kQ * p, p);
    else
      dx_block<kPS, kVec, false>(cl, region, pdx + slot * kQ * p, p);
  }
}

// dC and dB (outer, q, groups, n): each element the sum, over the rep
// heads of its group in order, of the heads' partials
__global__ void ssd_bwd_reduce(const float* __restrict__ pc,
                               const float* __restrict__ pb,
                               float* __restrict__ dC, float* __restrict__ dB,
                               long long total, Shape sh) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int k = (int)(e % sh.n);
  const int g = (int)((e / sh.n) % sh.groups);
  const int i = (int)((e / ((long long)sh.n * sh.groups)) % sh.q);
  const long long outer = e / ((long long)sh.n * sh.groups * sh.q);
  float sc = 0.f, sb = 0.f;
  for (int t = 0; t < sh.rep; ++t) {
    const long long at =
        ((outer * sh.heads + g * sh.rep + t) * sh.q + i) * sh.n + k;
    sc += pc[at];
    sb += pb[at];
  }
  dC[e] = sc;
  dB[e] = sb;
}

// A wide cell's gradients from ssd_bwd_tile's partials, a thread an
// element, each sum in a fixed order: elements [0, ncb) are dC and dB
// (outer, q, groups, n), summed over the group's heads in order and, for
// each head, over the tiles of the row's tile row (dC) or column (dB) in
// order; then [ncb, ncb + nx) dx (outer, q, heads, p), over the tiles of
// its column; then dcum (outer, q, heads), its row sums less its column
// sums.
__global__ void ssd_bwd_reduce_tiled(
    const float* __restrict__ pdx, const float* __restrict__ prs,
    const float* __restrict__ pcs, const float* __restrict__ pc,
    const float* __restrict__ pb, float* __restrict__ dC,
    float* __restrict__ dB, float* __restrict__ dx, float* __restrict__ dcum,
    long long ncb, long long nx, long long total, Shape sh, int tiles) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int pairs = n_pairs(tiles);
  auto slot = [&](long long cell, int ti, int tj) {
    return cell * pairs + n_pairs(ti) + tj;
  };
  if (e < ncb) {
    const int k = (int)(e % sh.n);
    const int g = (int)((e / sh.n) % sh.groups);
    const int i = (int)((e / ((long long)sh.n * sh.groups)) % sh.q);
    const long long outer = e / ((long long)sh.n * sh.groups * sh.q);
    const int tr = i / kQ, r = i % kQ;
    float sc = 0.f, sb = 0.f;
    for (int t = 0; t < sh.rep; ++t) {
      const long long cell = outer * sh.heads + g * sh.rep + t;
      for (int tj = 0; tj <= tr; ++tj)
        sc += pc[(slot(cell, tr, tj) * kQ + r) * sh.n + k];
      for (int ti = tr; ti < tiles; ++ti)
        sb += pb[(slot(cell, ti, tr) * kQ + r) * sh.n + k];
    }
    dC[e] = sc;
    dB[e] = sb;
    return;
  }
  e -= ncb;
  if (e < nx) {
    const int c = (int)(e % sh.p);
    const int h = (int)((e / sh.p) % sh.heads);
    const int j = (int)((e / ((long long)sh.p * sh.heads)) % sh.q);
    const long long outer = e / ((long long)sh.p * sh.heads * sh.q);
    const long long cell = outer * sh.heads + h;
    const int tc = j / kQ, r = j % kQ;
    float s = 0.f;
    for (int ti = tc; ti < tiles; ++ti)
      s += pdx[(slot(cell, ti, tc) * kQ + r) * sh.p + c];
    dx[e] = s;
    return;
  }
  e -= nx;
  const int h = (int)(e % sh.heads);
  const int i = (int)((e / sh.heads) % sh.q);
  const long long outer = e / ((long long)sh.heads * sh.q);
  const long long cell = outer * sh.heads + h;
  const int tr = i / kQ, r = i % kQ;
  float rsum = 0.f, csum = 0.f;
  for (int tj = 0; tj <= tr; ++tj) rsum += prs[slot(cell, tr, tj) * kQ + r];
  for (int ti = tr; ti < tiles; ++ti) csum += pcs[slot(cell, ti, tr) * kQ + r];
  dcum[e] = rsum - csum;
}

template <int kPS, bool kVec>
int launch_cell(const void* C, const void* B, const void* x,
                const void* cum, const void* dy, void* dx, void* dcum,
                void* pc, void* pb, int cells, const Shape& sh,
                cudaStream_t st) {
  const size_t bytes = sizeof(float) * smem_floats(sh.n, kPS);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_cell<kPS, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_cell<kPS, kVec><<<dim3(cells, 2), kThreads, bytes, st>>>(
      static_cast<const float*>(C), static_cast<const float*>(B),
      static_cast<const float*>(x), static_cast<const float*>(cum),
      static_cast<const float*>(dy), static_cast<float*>(dx),
      static_cast<float*>(dcum), static_cast<float*>(pc),
      static_cast<float*>(pb), sh);
  return (int)cudaGetLastError();
}

template <int kPS, bool kVec>
int launch_tile(const void* C, const void* B, const void* x, const void* cum,
                const void* dy, float* pdx, float* prs, float* pcs,
                float* pc, float* pb, long long blocks, const Shape& sh,
                int tiles, cudaStream_t st) {
  // the whole cell's layout and the j side's cum
  const size_t bytes = sizeof(float) * (smem_floats(sh.n, kPS) + kQ);
  if (bytes > 232448 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_tile<kPS, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_tile<kPS, kVec><<<dim3((unsigned)blocks, 2), kThreads, bytes, st>>>(
      static_cast<const float*>(C), static_cast<const float*>(B),
      static_cast<const float*>(x), static_cast<const float*>(cum),
      static_cast<const float*>(dy), pdx, prs, pcs, pc, pb, sh, tiles);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// float offsets of a wide cell's workspace: pdx, prs, pcs, pc, pb, each
// a multiple of 4 floats from the start
struct Work {
  long long pdx, prs, pcs, pc, pb, total;
};

Work work_of(long long cells, int q, int n, int p) {
  const int tiles = (q + kQ - 1) / kQ;
  const long long slots = cells * n_pairs(tiles);
  Work w;
  w.pdx = 0;
  w.prs = w.pdx + slots * kQ * p;
  w.pcs = w.prs + slots * kQ;
  w.pc = w.pcs + slots * kQ;
  w.pb = w.pc + slots * kQ * n;
  w.total = w.pb + slots * kQ * n;
  return w;
}

}  // namespace

extern "C" {

// C, B (outer, q, groups, n); x, dy, dx (outer, q, heads, p); cum, dcum
// (outer, q, heads); dC, dB like C; pc, pb (outer, heads, q, n) scratch.
// All contiguous fp32; heads a multiple of groups; q <= 128; n, p <=
// 128. Returns cudaErrorInvalidValue for a shape it cannot take, else
// cudaGetLastError() after the two launches.
int ssd_intra_bwd_launch(const void* C, const void* B, const void* x,
                         const void* cum, const void* dy, void* dC, void* dB,
                         void* dx, void* dcum, void* pc, void* pb, int outer,
                         int heads, int groups, int q, int n, int p,
                         void* stream) {
  if (outer < 1 || groups < 1 || heads % groups != 0 || q < 1 || q > kQ ||
      n < 1 || n > 128 || p < 1 || p > 128)
    return (int)cudaErrorInvalidValue;
  const Shape sh{heads, groups, heads / groups, q, n, p};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cells = outer * heads;
  // 16-byte copies and stores where every row starts on 16 bytes
  const bool vec = n % 4 == 0 && p % 4 == 0 && aligned16(C) &&
                   aligned16(B) && aligned16(x) && aligned16(dy) &&
                   aligned16(dx);
  int err;
  if (p > 64)
    err = vec ? launch_cell<128, true>(C, B, x, cum, dy, dx, dcum, pc, pb,
                                       cells, sh, st)
              : launch_cell<128, false>(C, B, x, cum, dy, dx, dcum, pc, pb,
                                        cells, sh, st);
  else
    err = vec ? launch_cell<64, true>(C, B, x, cum, dy, dx, dcum, pc, pb,
                                      cells, sh, st)
              : launch_cell<64, false>(C, B, x, cum, dy, dx, dcum, pc, pb,
                                       cells, sh, st);
  if (err != 0) return err;
  const long long total = (long long)outer * q * groups * n;
  const int blocks = (int)((total + 255) / 256);
  ssd_bwd_reduce<<<blocks, 256, 0, st>>>(
      static_cast<const float*>(pc), static_cast<const float*>(pb),
      static_cast<float*>(dC), static_cast<float*>(dB), total, sh);
  return (int)cudaGetLastError();
}

// Floats of workspace ssd_intra_bwd_wide_launch takes at this shape.
long long ssd_intra_bwd_wide_floats(int outer, int heads, int q, int n,
                                    int p) {
  return work_of((long long)outer * heads, q, n, p).total;
}

// A chunk of Q > 128 rows: each cell's causal Q x Q in tiles of 128 x
// 128 on and below the diagonal (ssd_bwd_tile), whose partials
// ssd_bwd_reduce_tiled adds in a fixed order. The arguments of
// ssd_intra_bwd_launch, with `work` (ssd_intra_bwd_wide_floats floats,
// 16-byte aligned) in place of pc and pb. Returns cudaErrorInvalidValue
// for a shape it cannot take (Q <= 128 among them: ssd_intra_bwd_launch
// takes those), else cudaGetLastError() after the two launches.
int ssd_intra_bwd_wide_launch(const void* C, const void* B, const void* x,
                              const void* cum, const void* dy, void* dC,
                              void* dB, void* dx, void* dcum, void* work,
                              int outer, int heads, int groups, int q, int n,
                              int p, void* stream) {
  if (outer < 1 || groups < 1 || heads % groups != 0 || q <= kQ || n < 1 ||
      n > 128 || p < 1 || p > 128 || !aligned16(work))
    return (int)cudaErrorInvalidValue;
  const Shape sh{heads, groups, heads / groups, q, n, p};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long cells = (long long)outer * heads;
  const int tiles = (q + kQ - 1) / kQ;
  const Work w = work_of(cells, q, n, p);
  float* base = static_cast<float*>(work);
  const long long blocks = cells * n_pairs(tiles);
  // 16-byte copies and stores where every row starts on 16 bytes
  const bool vec = n % 4 == 0 && p % 4 == 0 && aligned16(C) &&
                   aligned16(B) && aligned16(x) && aligned16(dy);
  float *pdx = base + w.pdx, *prs = base + w.prs, *pcs = base + w.pcs,
        *pc = base + w.pc, *pb = base + w.pb;
  int err;
  if (p > 64)
    err = vec ? launch_tile<128, true>(C, B, x, cum, dy, pdx, prs, pcs, pc,
                                       pb, blocks, sh, tiles, st)
              : launch_tile<128, false>(C, B, x, cum, dy, pdx, prs, pcs, pc,
                                        pb, blocks, sh, tiles, st);
  else
    err = vec ? launch_tile<64, true>(C, B, x, cum, dy, pdx, prs, pcs, pc,
                                      pb, blocks, sh, tiles, st)
              : launch_tile<64, false>(C, B, x, cum, dy, pdx, prs, pcs, pc,
                                       pb, blocks, sh, tiles, st);
  if (err != 0) return err;
  const long long ncb = (long long)outer * q * groups * n;
  const long long nx = (long long)outer * q * heads * p;
  const long long total = ncb + nx + (long long)outer * q * heads;
  ssd_bwd_reduce_tiled<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      pdx, prs, pcs, pc, pb, static_cast<float*>(dC), static_cast<float*>(dB),
      static_cast<float*>(dx), static_cast<float*>(dcum), ncb, nx, total, sh,
      tiles);
  return (int)cudaGetLastError();
}

const char* ssd_intra_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
