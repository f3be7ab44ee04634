// Kernel B2: all-pairs DTW (symmetric2 / symmetricP2), float32, sm_90a.
//
// Replaces the TPU kernel `_dtw_kernel` in vpd_tpu/ops/pallas/dtw_kernel.py
// (launched by `_dtw_pallas` / `dtw_matrix_pallas`). It computes what that
// kernel computes, out[q, t] = g[n-1, m-1] / (n + m) with local cost
// ||q_i - t_j|| and +inf where the end cell is unreachable, for every
// (query, target) pair; it equals the host DP of ops/dtw.py.
//
// What bounds it: operations, in two parts. The local costs are a matrix
// product, ||q||^2 + ||t||^2 - 2 q.t, as the JAX kernel computes them: 2D
// flops a cell, done on the tensor cores in TF32 three times over for
// float32 accuracy (495 TFLOP/s dense). The recurrence is about 8 float32
// operations a cell outside the tensor cores (67 TFLOP/s). Inputs and
// outputs are a few MB. The least time is the larger of the two parts.
//
// Design (one target per block, one query per warp):
// * The block stages its target, up to CW rows at a time, in shared memory
//   already cut into TF32 hi and lo parts and laid out in the order of the
//   mma A fragments (16 target rows x 8 dimensions, D padded with zeros to
//   a multiple of 8): a lane fetches its 4 hi and 4 lo values of one
//   fragment with two 16-byte loads, free of bank conflicts. The squared
//   norms of the staged rows are computed once, beside them.
// * A warp walks its pair's DP rows in tiles of RB = 8 rows. The query's 8
//   rows are the mma's N: each lane loads its B fragments straight from
//   memory, splits them into hi and lo, and the group of 4 lanes that owns
//   a row sums its squared norm with two shuffles. Each 16 x 8 x 8 step is
//   three mma.sync.m16n8k8 TF32 (lo.hi + hi.lo + hi.hi, 3xTF32), and only
//   ceil(m/16)*16 columns x 8 rows are covered.
// * The epilogue forms ||q||^2 + ||t||^2 - 2 q.t, clamps at 0 and takes the
//   square root, the twin's own arithmetic. Where a row nearly equals a
//   column (the squared cost below 1/64 of ||q||^2 + ||t||^2, where the
//   matmul form cancels), the cell is summed again as (q - t)^2 in float32,
//   so identical rows cost exactly 0.
// * L <= 128 (the main path: the recognize CLI's device_max_len): the
//   recurrence runs in registers. Lane l owns columns 4l .. 4l + 3 and
//   holds DP rows i-1..i-3 and cost rows i-1, i-2 of them; it reads cost
//   row i from the warp's 8-row tile with one 16-byte load and takes what
//   it needs from columns to its left (at most 3) from lane l - 1 by
//   __shfl_up_sync: 5 shuffles a row for symmetricP2, no ring index and no
//   shared-memory write. symmetric2's in-row recurrence g[j] = min(c[j],
//   g[j-1] + d[j]) is a scan over the maps x -> min(a, x + b), composed as
//   (a1,b1) then (a2,b2) = (min(a2, a1 + b2), b1 + b2): each lane composes
//   its 4 columns, the warp scans the composites with shuffles, and each
//   lane applies the result column by column. A warp then needs 4.2 KB of
//   shared memory, so that at D = 32 registers, not shared memory, bound
//   the resident warps (Shape below: 20 for symmetricP2, 24 for
//   symmetric2).
// * L > 128: the costs go to a per-warp ring of RB + 2 rows and the DP
//   values to a ring of 4 rows, both in shared memory, and a lane walks
//   columns lane, lane + 32, ...; symmetric2 scans runs of 32 columns and
//   carries the last value to the next.
// * Nothing is subtracted in the recurrence, so +inf marks unreachable
//   cells and no path forms inf - inf.
// * Rows stop at n - 1 and columns at m - 1: the work is what the true
//   lengths need.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int RB = 8;          // DP rows per cost tile: the mma's N
constexpr int CW = 128;        // target rows staged per chunk
constexpr int MAX_WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_BUDGET = 200 * 1024;  // of the 227 KB a block may use
constexpr float FIX_FRAC = 1.f / 64;  // below this share, sum (q - t)^2

// k-steps of 8 dimensions for D: 4, 8 or 16, the kernel's template
// argument, so that the product's loops have fixed trip counts (D is
// padded with zeros up to 8 ks)
__host__ __device__ constexpr int ks_for(int D) {
  return D <= 32 ? 4 : D <= 64 ? 8 : 16;
}

struct Layout {
  int lp;         // L rounded up to 32: a DP row in shared memory
  int cw;         // rows of the staged target chunk
  int ks;         // k-steps of 8 dimensions: ks_for(D)
  bool reg;       // L <= CW: the recurrence runs in registers
  int cs;         // stride of a cost row, 4 past a multiple of 32 floats:
                  // the epilogue's stores are free of bank conflicts
  int ring;       // cost rows per warp
  int warp_floats;

  __host__ __device__ Layout(int L, int D) {
    lp = (L + 31) / 32 * 32;
    cw = lp < CW ? lp : CW;
    ks = ks_for(D);
    reg = lp <= CW;
    // in registers each lane reads 4 columns of a 128-wide cost row; the
    // ring keeps two more cost rows and 4 DP rows
    cs = (reg ? CW : lp) + 4;
    ring = reg ? RB : RB + 2;
    warp_floats = ring * cs + (reg ? 0 : 4 * lp);
  }
  __host__ __device__ int frag_floats() const { return cw * ks * 16; }
  __host__ __device__ size_t floats(int warps) const {
    return (size_t)frag_floats() + cw + (size_t)warps * warp_floats;
  }
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// c += a b for a 16 x 8 TF32 tile a (rows: target columns), an 8 x 8 tile
// b (columns: query rows), float32 c.
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The whole block: target rows c0 .. (at most cw of them, up to m) into
// the A-fragment order, hi and lo parts, zeros up to the next multiple of
// 16 rows and of 8 ks dimensions, and their squared norms into tn. A warp
// takes a row, its lanes the dimensions.
__device__ void stage_target(const float* tp, float* frag, float* tn, int c0,
                             int m, int D, const Layout& lay) {
  const int rows = min(lay.cw, m - c0);
  const int rows16 = (rows + 15) & ~15;
  const int d8 = lay.ks * 8;
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int r = threadIdx.x >> 5; r < rows16; r += blockDim.x >> 5) {
    const float* row = tp + (size_t)(c0 + r) * D;
    float s = 0.f;
    for (int k = lane; k < d8; k += 32) {
      const float v = r < rows && k < D ? row[k] : 0.f;
      s = fmaf(v, v, s);
      const uint32_t hi = to_tf32(v);
      const uint32_t lo = to_tf32(v - __uint_as_float(hi));
      // fragment (r / 16, k / 8); lane (r % 8) * 4 + k % 4; register
      // (r % 16) / 8 + 2 ((k % 8) / 4)
      const int at = (r & 7) * 4 + (k & 3);
      const int reg = ((r >> 3) & 1) + 2 * ((k >> 2) & 1);
      float* f = frag + (((r >> 4) * lay.ks + (k >> 3)) * 32 + at) * 8;
      f[reg] = __uint_as_float(hi);
      f[4 + reg] = __uint_as_float(lo);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) tn[r] = s;
  }
}

// The hardware's approximate square root (relative error near 2^-23;
// inputs below 2^-126 count as 0), without the refinement steps of the
// correctly rounded sqrtf.
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float direct_sq(const float* a, const float* b,
                                           int D) {
  float s = 0.f;
  for (int k = 0; k < D; ++k) {
    const float d = a[k] - b[k];
    s = fmaf(d, d, s);
  }
  return s;
}

// Local costs of query rows i0 .. i0 + RB - 1 (of n) against the staged
// target rows c0 .. c0 + mc - 1, into cost rows (i0 + r) % ring. KS is
// lay.ks, known at compile time: the query fragments stay in registers.
template <int KS>
__device__ __forceinline__ void cost_tile(const float* frag, const float* tn,
                                          const float* qp, const float* tp,
                                          float* cost, int i0, int n, int c0,
                                          int mc, int D, const Layout& lay,
                                          int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  uint32_t bh[KS][2], bl[KS][2];
  float qn = 0.f;
  const bool row_ok = i0 + g < n;
  const float* qrow = qp + (size_t)(i0 + g) * D;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = s * 8 + h * 4 + t4;
      const float v = row_ok && k < D ? qrow[k] : 0.f;
      qn = fmaf(v, v, qn);
      bh[s][h] = to_tf32(v);
      bl[s][h] = to_tf32(v - __uint_as_float(bh[s][h]));
    }
  }
  qn += __shfl_xor_sync(FULL, qn, 1);
  qn += __shfl_xor_sync(FULL, qn, 2);
  // this lane's cells: query rows 2 t4 and 2 t4 + 1
  const float qn_r[2] = {__shfl_sync(FULL, qn, 8 * t4),
                         __shfl_sync(FULL, qn, 8 * t4 + 4)};
  const float4* frag4 = reinterpret_cast<const float4*>(frag);
  const int tiles = (mc + 15) / 16;
  float* const out[2] = {cost + ((i0 + 2 * t4) % lay.ring) * lay.cs + c0,
                         cost + ((i0 + 2 * t4 + 1) % lay.ring) * lay.cs + c0};
  for (int mt = 0; mt < tiles; ++mt) {
    // two independent chains: hi.hi, and the small lo.hi + hi.lo terms
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
    const float4* f = frag4 + (mt * KS * 32 + lane) * 2;
#pragma unroll
    for (int s = 0; s < KS; ++s, f += 64) {
      const float4 h = f[0], l = f[1];
      const uint32_t h0 = __float_as_uint(h.x), h1 = __float_as_uint(h.y),
                     h2 = __float_as_uint(h.z), h3 = __float_as_uint(h.w);
      mma_tf32(small, __float_as_uint(l.x), __float_as_uint(l.y),
               __float_as_uint(l.z), __float_as_uint(l.w), bh[s][0],
               bh[s][1]);
      mma_tf32(small, h0, h1, h2, h3, bl[s][0], bl[s][1]);
      mma_tf32(acc, h0, h1, h2, h3, bh[s][0], bh[s][1]);
    }
    const float tn_c[2] = {tn[mt * 16 + g], tn[mt * 16 + g + 8]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // c_e: column g + 8 (e / 2), row 2 t4 + e % 2
      const int col = mt * 16 + g + 8 * (e >> 1);
      const int r = 2 * t4 + (e & 1);
      const float norms = qn_r[e & 1] + tn_c[e >> 1];
      float sq = fmaf(-2.f, acc[e] + small[e], norms);
      if (sq < FIX_FRAC * norms) {  // rare: a row close to a column
        if (i0 + r < n && col < mc)
          sq = direct_sq(qp + (size_t)(i0 + r) * D,
                         tp + (size_t)(c0 + col) * D, D);
      }
      out[e & 1][col] = sqrt_approx(fmaxf(sq, 0.f));
    }
  }
}

// One DP row of symmetricP2. Returns g[i][m - 1] in the lane that owns
// column m - 1 and `last` unchanged in the others.
__device__ __forceinline__ float row_p2(const float* cost, float* gring,
                                        int i, int m, const Layout& lay,
                                        int lane, float last) {
  const int ring = lay.ring, cs = lay.cs, lp = lay.lp;
  const float* d = cost + (i % ring) * cs;
  const float* d1 = cost + ((i + ring - 1) % ring) * cs;  // row i - 1
  const float* d2 = cost + ((i + ring - 2) % ring) * cs;  // row i - 2
  const float* g1 = gring + ((i + 3) & 3) * lp;
  const float* g2 = gring + ((i + 2) & 3) * lp;
  const float* g3 = gring + ((i + 1) & 3) * lp;
  float* out = gring + (i & 3) * lp;
  for (int j = lane; j < m; j += 32) {
    const float dj = d[j];
    float v;
    if (i == 0) {
      v = j == 0 ? dj : INFINITY;
    } else {
      v = j >= 1 ? g1[j - 1] + 2.f * dj : INFINITY;
      if (i >= 2 && j >= 3)
        v = fminf(v, g2[j - 3] + 2.f * d1[j - 2] + 2.f * d[j - 1] + dj);
      if (i >= 3 && j >= 2)
        v = fminf(v, g3[j - 2] + 2.f * d2[j - 1] + 2.f * d1[j] + dj);
    }
    out[j] = v;
    if (j == m - 1) last = v;
  }
  return last;
}

// One DP row of symmetric2, by an affine (min,+) scan along the row.
__device__ __forceinline__ float row_s2(const float* cost, float* gring,
                                        int i, int m, const Layout& lay,
                                        int lane, float last) {
  const float* d = cost + (i % lay.ring) * lay.cs;
  const float* g1 = gring + ((i + 3) & 3) * lay.lp;
  float* out = gring + (i & 3) * lay.lp;
  float carry = INFINITY;  // g[i][j0 - 1]
  for (int j0 = 0; j0 < m; j0 += 32) {
    const int j = j0 + lane;
    const bool ok = j < m;
    const float dj = ok ? d[j] : 0.f;
    float c = INFINITY;  // best arrival from row i - 1
    if (ok) {
      if (i == 0)
        c = j == 0 ? dj : INFINITY;
      else
        c = fminf((j >= 1 ? g1[j - 1] : INFINITY) + 2.f * dj, g1[j] + dj);
    }
    float a = c, b = dj;  // the map x -> min(a, x + b), scanned
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float ap = __shfl_up_sync(FULL, a, off);
      const float bp = __shfl_up_sync(FULL, b, off);
      if (lane >= off) {
        a = fminf(a, ap + b);
        b = bp + b;
      }
    }
    const float v = fminf(a, carry + b);
    if (ok) out[j] = v;
    if (j == m - 1) last = v;
    carry = __shfl_sync(FULL, v, 31);
  }
  return last;
}

// The recurrence in registers (L <= CW): lane l owns columns 4 l .. 4 l + 3
// and reads each cost row with one 16-byte load. What a cell needs from
// columns to its left comes from the lane to the left by __shfl_up_sync;
// lane 0 gets +inf for a DP value (no cell).
__device__ __forceinline__ float from_left(float v, int lane, float edge) {
  const float u = __shfl_up_sync(FULL, v, 1);
  return lane == 0 ? edge : u;
}

__device__ __forceinline__ void load_costs(const float* row, int lane,
                                           float (&d)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(row + 4 * lane);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

// symmetricP2: DP rows i-1..i-3 and cost rows i-1, i-2 of the lane's
// columns, and of the left lane's last 3 (DP) and last 2 (cost) columns.
struct RegP2 {
  float g1[4], g2[4], g3[4], d1[4], d2[4];
  float lg1[3], lg2[3], lg3[3], ld1[2], ld2[2];

  __device__ RegP2() {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      g1[e] = g2[e] = g3[e] = INFINITY;
      d1[e] = d2[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 3; ++e) lg1[e] = lg2[e] = lg3[e] = INFINITY;
    ld1[0] = ld1[1] = ld2[0] = ld2[1] = 0.f;
  }

  // Row i from the cost row `crow`; its 4 values into v.
  __device__ __forceinline__ void row(const float* crow, int i, int lane,
                                      float (&v)[4]) {
    float d[4];
    load_costs(crow, lane, d);
    // lane 0 gets its own costs: they are added only to the +inf of G2 and
    // G3 there, so they cannot win
    const float ld0[2] = {__shfl_up_sync(FULL, d[2], 1),
                          __shfl_up_sync(FULL, d[3], 1)};
    // column 4 lane + x of a row, x in [-3, 3]
    auto G1 = [&](int x) { return x >= 0 ? g1[x] : lg1[x + 3]; };
    auto G2 = [&](int x) { return x >= 0 ? g2[x] : lg2[x + 3]; };
    auto G3 = [&](int x) { return x >= 0 ? g3[x] : lg3[x + 3]; };
    auto D0 = [&](int x) { return x >= 0 ? d[x] : ld0[x + 2]; };
    auto D1 = [&](int x) { return x >= 0 ? d1[x] : ld1[x + 2]; };
    auto D2 = [&](int x) { return x >= 0 ? d2[x] : ld2[x + 2]; };
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float best = G1(e - 1) + 2.f * d[e];
      best = fminf(best, G2(e - 3) + 2.f * D1(e - 2) + 2.f * D0(e - 1) +
                             d[e]);
      best = fminf(best, G3(e - 2) + 2.f * D2(e - 1) + 2.f * D1(e) + d[e]);
      v[e] = i > 0 ? best : (lane == 0 && e == 0 ? d[0] : INFINITY);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      g3[e] = g2[e];
      g2[e] = g1[e];
      g1[e] = v[e];
      d2[e] = d1[e];
      d1[e] = d[e];
    }
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      lg3[e] = lg2[e];
      lg2[e] = lg1[e];
      lg1[e] = from_left(v[e + 1], lane, INFINITY);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ld2[e] = ld1[e];
      ld1[e] = ld0[e];
    }
  }
};

// symmetric2: DP row i-1 of the lane's columns and the left lane's last.
// In-row, g[j] = min(c[j], g[j-1] + d[j]): the lane composes its 4 maps
// x -> min(c, x + d), the warp scans the composites, and the lane applies
// what its left neighbours compose to +inf, column by column.
struct RegS2 {
  float g1[4], lg1;

  __device__ RegS2() {
#pragma unroll
    for (int e = 0; e < 4; ++e) g1[e] = INFINITY;
    lg1 = INFINITY;
  }

  __device__ __forceinline__ void row(const float* crow, int i, int lane,
                                      float (&v)[4]) {
    float d[4], c[4];
    load_costs(crow, lane, d);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float diag = (e > 0 ? g1[e - 1] : lg1) + 2.f * d[e];
      c[e] = i > 0 ? fminf(diag, g1[e] + d[e])
                   : (lane == 0 && e == 0 ? d[0] : INFINITY);
    }
    float a = c[0], b = d[0];
#pragma unroll
    for (int e = 1; e < 4; ++e) {
      a = fminf(c[e], a + d[e]);
      b += d[e];
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float ap = __shfl_up_sync(FULL, a, off);
      const float bp = __shfl_up_sync(FULL, b, off);
      if (lane >= off) {
        a = fminf(a, ap + b);
        b = bp + b;
      }
    }
    float x = from_left(a, lane, INFINITY);  // g[i][4 lane - 1]
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x = fminf(c[e], x + d[e]);
      v[e] = x;
      g1[e] = x;
    }
    lg1 = from_left(v[3], lane, INFINITY);
  }
};

// One warp's pair with the recurrence in registers: tiles of RB rows,
// each computed into the warp's cost rows and then walked row by row.
template <int KS, class Reg>
__device__ __forceinline__ float pair_in_registers(
    const float* frag, const float* tn, const float* qp, const float* tp,
    float* cost, int n, int m, int D, const Layout& lay, int lane) {
  Reg st;
  float last = INFINITY;
  for (int i0 = 0; i0 < n; i0 += RB) {
    cost_tile<KS>(frag, tn, qp, tp, cost, i0, n, 0, m, D, lay, lane);
    __syncwarp();
#pragma unroll 4
    for (int r = 0; r < RB; ++r) {
      const int i = i0 + r;
      if (i >= n) break;
      float v[4];
      st.row(cost + r * lay.cs, i, lane, v);
      if (i == n - 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * lane + e == m - 1) last = v[e];
      }
    }
    __syncwarp();
  }
  return last;
}

// One warp's pair with the recurrence in shared-memory rings (L > CW).
// A target longer than CW is staged chunk by chunk, and then all warps of
// the block walk the same number of tiles, n_max's.
template <int KS, bool P2>
__device__ __forceinline__ float pair_in_ring(
    float* frag, float* tn, const float* qp, const float* tp, float* cost,
    int n, int m, int D, const Layout& lay, int lane) {
  __shared__ int n_max;
  if (threadIdx.x == 0) n_max = 0;
  __syncthreads();
  if (lane == 0) atomicMax(&n_max, n);
  const int chunks = (m + lay.cw - 1) / lay.cw;
  if (chunks == 1) stage_target(tp, frag, tn, 0, m, D, lay);
  __syncthreads();
  // with one chunk no block barrier is left: each warp stops at its n
  const int i_end = chunks > 1 ? n_max : n;
  float* gring = cost + lay.ring * lay.cs;
  float last = INFINITY;
  for (int i0 = 0; i0 < i_end; i0 += RB) {
    const bool active = i0 < n;
    for (int c = 0; c < chunks; ++c) {
      const int c0 = c * lay.cw;
      if (chunks > 1) {
        __syncthreads();
        stage_target(tp, frag, tn, c0, m, D, lay);
        __syncthreads();
      }
      if (active)
        cost_tile<KS>(frag, tn, qp, tp, cost, i0, n, c0,
                      min(lay.cw, m - c0), D, lay, lane);
    }
    __syncwarp();
    if (active) {
      for (int i = i0; i < min(i0 + RB, n); ++i) {  // the last is row n - 1
        last = P2 ? row_p2(cost, gring, i, m, lay, lane, last)
                  : row_s2(cost, gring, i, m, lay, lane, last);
        __syncwarp();
      }
    }
  }
  return last;
}

// Warps per block, and blocks an SM is to hold (registers are capped to
// let them in), for each variant. With the recurrence in registers a warp
// needs 4.2 KB of shared memory. At D <= 32 symmetric2 fits 3 blocks of 8
// warps in 80 registers; symmetricP2 keeps more rows and takes 2 blocks
// of 10 in 96 registers, without spills. At D <= 64 the target's 64 KB
// allow 2 blocks of 8.
template <int KS, bool P2, bool REG>
struct Shape {
  static constexpr int warps = REG && KS == 4 && P2 ? 10 : MAX_WARPS;
  static constexpr int min_blocks =
      !REG ? 1 : KS == 4 ? (P2 ? 2 : 3) : KS == 8 ? 2 : 1;
};

template <int KS, bool P2, bool REG>
__global__ void __launch_bounds__(32 * Shape<KS, P2, REG>::warps,
                                  Shape<KS, P2, REG>::min_blocks)
    dtw_kernel(const float* __restrict__ q, const int* __restrict__ q_lens,
               const float* __restrict__ t, const int* __restrict__ t_lens,
               float* __restrict__ out, int Q, int T, int L, int D,
               int q_groups) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay(L, D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int tj = blockIdx.x / q_groups;
  const int qi = (blockIdx.x % q_groups) * warps + warp;
  const int m = t_lens[tj];
  const int n = qi < Q ? q_lens[qi] : 0;
  float* frag = smem;
  float* tn = frag + lay.frag_floats();
  float* cost = tn + lay.cw + (size_t)warp * lay.warp_floats;
  const float* tp = t + (size_t)tj * L * D;
  const float* qp = q + (size_t)(qi < Q ? qi : 0) * L * D;

  float last;
  int owner;  // the lane that holds column m - 1
  if constexpr (REG) {
    stage_target(tp, frag, tn, 0, m, D, lay);
    __syncthreads();
    using Reg = typename std::conditional<P2, RegP2, RegS2>::type;
    last = pair_in_registers<KS, Reg>(frag, tn, qp, tp, cost, n, m, D, lay,
                                      lane);
    owner = (m - 1) / 4;
  } else {
    last = pair_in_ring<KS, P2>(frag, tn, qp, tp, cost, n, m, D, lay, lane);
    owner = (m - 1) & 31;
  }
  if (qi < Q && lane == owner)
    out[(size_t)qi * T + tj] = last / (float)(n + m);
}

using KernelFn = void (*)(const float*, const int*, const float*,
                          const int*, float*, int, int, int, int, int);

// The kernel, block size and shared memory for (L, D, step pattern).
struct Launch {
  KernelFn kernel;
  int warps;
  size_t bytes;
};

template <int KS, bool P2, bool REG>
void choose(Launch* out) {
  out->kernel = dtw_kernel<KS, P2, REG>;
  out->warps = Shape<KS, P2, REG>::warps;
}

template <int KS>
void pick(bool p2, bool reg, Launch* out) {
  if (reg)
    p2 ? choose<KS, true, true>(out) : choose<KS, false, true>(out);
  else
    p2 ? choose<KS, true, false>(out) : choose<KS, false, false>(out);
}

cudaError_t plan(int L, int D, int step_pattern, Launch* out) {
  if (L <= 0 || D <= 0 || D > 128 || (step_pattern != 0 && step_pattern != 1))
    return cudaErrorInvalidValue;
  const Layout lay(L, D);
  const bool p2 = step_pattern == 1;
  if (lay.ks == 4)
    pick<4>(p2, lay.reg, out);
  else if (lay.ks == 8)
    pick<8>(p2, lay.reg, out);
  else
    pick<16>(p2, lay.reg, out);
  while (out->warps > 1 &&
         lay.floats(out->warps) * sizeof(float) > SMEM_BUDGET)
    out->warps /= 2;
  out->bytes = lay.floats(out->warps) * sizeof(float);
  if (out->bytes > SMEM_BUDGET) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(out->kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)out->bytes);
}

}  // namespace

// q (Q, L, D) and t (T, L, D) contiguous float32; q_lens (Q,), t_lens (T,)
// int32 in [1, L] (the caller checks); out (Q, T) float32, normalized,
// +inf where unreachable. step_pattern: 0 symmetric2, 1 symmetricP2.
// Returns the cudaError_t of the launch.
extern "C" int vpd_dtw_matrix(const float* q, const int* q_lens,
                              const float* t, const int* t_lens, float* out,
                              int Q, int T, int L, int D, int step_pattern,
                              cudaStream_t stream) {
  if (Q <= 0 || T <= 0) return cudaSuccess;
  Launch lc;
  cudaError_t err = plan(L, D, step_pattern, &lc);
  if (err != cudaSuccess) return err;
  const int q_groups = (Q + lc.warps - 1) / lc.warps;
  if ((long long)T * q_groups > INT_MAX) return cudaErrorInvalidValue;
  lc.kernel<<<T * q_groups, 32 * lc.warps, lc.bytes, stream>>>(
      q, q_lens, t, t_lens, out, Q, T, L, D, q_groups);
  return cudaGetLastError();
}

// What the launch for (L, D, step_pattern) uses, into info[5]: registers
// per thread, local memory per thread in bytes (0 unless registers
// spill), dynamic shared memory per block in bytes, warps per block and
// warps resident per SM. Returns a cudaError_t.
extern "C" int vpd_dtw_kernel_info(int L, int D, int step_pattern,
                                   int* info) {
  Launch lc;
  cudaError_t err = plan(L, D, step_pattern, &lc);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, lc.kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, lc.kernel, 32 * lc.warps, lc.bytes);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)lc.bytes;
  info[3] = lc.warps;
  info[4] = blocks * lc.warps;
  return cudaSuccess;
}
