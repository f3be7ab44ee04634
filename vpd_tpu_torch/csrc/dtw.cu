// Kernel B2: all-pairs DTW (symmetric2 / symmetricP2), float32, sm_90a.
//
// Replaces the TPU kernel `_dtw_kernel` in vpd_tpu/ops/pallas/dtw_kernel.py
// (launched by `_dtw_pallas` / `dtw_matrix_pallas`). It computes what that
// kernel computes, out[q, t] = g[n-1, m-1] / (n + m) with local cost
// ||q_i - t_j|| and +inf where the end cell is unreachable, for every
// (query, target) pair; it equals the host DP of ops/dtw.py.
//
// What bounds it: operations. Each DP cell inside the lengths costs 2D
// float32 operations for its local cost (subtract, fused multiply-add per
// dimension) plus about 8 for the recurrence and the square root; inputs
// and outputs are a few MB. So the least time is ops / 67 TFLOP/s.
//
// Design (one target per block, one query per warp):
// * The block stages its target, up to CW rows of D floats at a time, in
//   shared memory with an odd row stride, so that 32 lanes reading 32
//   different rows hit 32 different banks.
// * A warp walks its pair's DP rows in tiles of RB rows. For a tile it
//   copies the RB query rows to shared memory, and each lane computes the
//   local costs of RB rows x its columns (j = lane + 32 g) in registers:
//   every target value read is used RB times and every query value (a
//   broadcast read) CG times. Costs are the direct sum of (q - t)^2, more
//   exact than the matmul form of the JAX code.
// * The costs go to a per-warp ring of RB + 2 rows and the DP values to a
//   ring of 4 rows, both in shared memory: symmetricP2 reads rows i-1..i-3
//   and cost rows i-1, i-2 at column offsets of up to 3.
// * symmetricP2 has no dependency inside a row: each lane computes its
//   cells at once. symmetric2's in-row recurrence g[j] = min(c[j],
//   g[j-1] + d[j]) is a scan over the maps x -> min(a, x + b), composed as
//   (a1,b1) then (a2,b2) = (min(a2, a1 + b2), b1 + b2), with warp shuffles
//   over each run of 32 columns and the last value carried to the next.
//   Nothing is subtracted, so +inf marks unreachable cells and no path
//   forms inf - inf.
// * Rows stop at n - 1 and columns at m - 1: the work is what the true
//   lengths need.

#include <cuda_runtime.h>
#include <math.h>

#include <climits>

namespace {

constexpr int RB = 8;          // DP rows per cost tile
constexpr int CW = 128;        // target rows staged per chunk
constexpr int CG = CW / 32;    // column groups per lane in a chunk
constexpr int MAX_WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_BUDGET = 200 * 1024;  // of the 227 KB a block may use

struct Layout {
  int lp;         // L rounded up to 32: a DP row in shared memory
  int cw;         // rows of the staged target chunk
  int ts_stride;  // odd stride of a staged target row
  int warp_floats;

  __host__ __device__ Layout(int L, int D) {
    lp = (L + 31) / 32 * 32;
    cw = lp < CW ? lp : CW;
    ts_stride = D | 1;
    warp_floats = RB * D + (RB + 2) * lp + 4 * lp;
  }
  __host__ __device__ size_t floats(int warps) const {
    return (size_t)cw * ts_stride + (size_t)warps * warp_floats;
  }
};

// Local costs of rows i0 .. i0 + rows - 1 against target rows c0 .. (the
// chunk in ts), into the cost ring.
__device__ __forceinline__ void cost_tile(const float* qs, const float* ts,
                                          float* cost, int i0, int rows,
                                          int c0, int m, int D,
                                          const Layout& lay, int lane) {
  const int chunk = min(lay.cw, m - c0);
  const int groups = (chunk + 31) / 32;
  float acc[RB][CG];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int g = 0; g < CG; ++g) acc[r][g] = 0.f;

  for (int k = 0; k < D; ++k) {
    float qv[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) qv[r] = qs[r * D + k];
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      if (g < groups) {
        const float tv = ts[(g * 32 + lane) * lay.ts_stride + k];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float diff = qv[r] - tv;
          acc[r][g] = fmaf(diff, diff, acc[r][g]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r < rows) {
      float* row = cost + ((i0 + r) % (RB + 2)) * lay.lp;
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const int j = g * 32 + lane;
        if (g < groups && j < chunk) row[c0 + j] = sqrtf(acc[r][g]);
      }
    }
  }
}

// One DP row of symmetricP2. Returns g[i][m - 1] in the lane that owns
// column m - 1 and `last` unchanged in the others.
__device__ __forceinline__ float row_p2(const float* cost, float* gring,
                                        int i, int m, int lp, int lane,
                                        float last) {
  const float* d = cost + (i % (RB + 2)) * lp;
  const float* d1 = cost + ((i + RB + 1) % (RB + 2)) * lp;  // row i - 1
  const float* d2 = cost + ((i + RB) % (RB + 2)) * lp;      // row i - 2
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
                                        int i, int m, int lp, int lane,
                                        float last) {
  const float* d = cost + (i % (RB + 2)) * lp;
  const float* g1 = gring + ((i + 3) & 3) * lp;
  float* out = gring + (i & 3) * lp;
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

template <bool P2>
__global__ void dtw_kernel(const float* __restrict__ q,
                           const int* __restrict__ q_lens,
                           const float* __restrict__ t,
                           const int* __restrict__ t_lens,
                           float* __restrict__ out, int Q, int T, int L,
                           int D, int q_groups) {
  extern __shared__ float smem[];
  __shared__ int n_max_s;
  const Layout lay(L, D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int tj = blockIdx.x / q_groups;
  const int qi = (blockIdx.x % q_groups) * warps + warp;
  const int m = t_lens[tj];
  const int n = qi < Q ? q_lens[qi] : 0;

  if (threadIdx.x == 0) n_max_s = 0;
  __syncthreads();
  if (lane == 0) atomicMax(&n_max_s, n);
  __syncthreads();
  const int n_max = n_max_s;

  float* ts = smem;
  float* qs = smem + (size_t)lay.cw * lay.ts_stride +
              (size_t)warp * lay.warp_floats;
  float* cost = qs + RB * D;
  float* gring = cost + (RB + 2) * lay.lp;
  const float* tp = t + (size_t)tj * L * D;
  const float* qp = q + (size_t)(qi < Q ? qi : 0) * L * D;
  const int chunks = (m + lay.cw - 1) / lay.cw;

  auto stage = [&](int c0) {  // the whole block: target rows c0 ..
    const int rows = min(lay.cw, m - c0);
    for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
      const int r = e / D;
      ts[r * lay.ts_stride + (e - r * D)] = tp[(size_t)c0 * D + e];
    }
  };
  if (chunks == 1) stage(0);
  __syncthreads();

  float last = INFINITY;
  for (int i0 = 0; i0 < n_max; i0 += RB) {  // the same count in all warps
    const bool active = i0 < n;
    const int rows = active ? min(RB, n - i0) : 0;
    for (int e = lane; e < rows * D; e += 32)
      qs[e] = qp[(size_t)i0 * D + e];
    __syncwarp();
    for (int c = 0; c < chunks; ++c) {
      if (chunks > 1) {
        __syncthreads();
        stage(c * lay.cw);
        __syncthreads();
      }
      if (active) cost_tile(qs, ts, cost, i0, rows, c * lay.cw, m, D, lay,
                            lane);
    }
    __syncwarp();
    for (int i = i0; i < i0 + rows; ++i) {  // the last is row n - 1
      last = P2 ? row_p2(cost, gring, i, m, lay.lp, lane, last)
                : row_s2(cost, gring, i, m, lay.lp, lane, last);
      __syncwarp();
    }
  }
  if (qi < Q && lane == ((m - 1) & 31))
    out[(size_t)qi * T + tj] = last / (float)(n + m);
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
  if (L <= 0 || D <= 0 || (step_pattern != 0 && step_pattern != 1))
    return cudaErrorInvalidValue;
  const Layout lay(L, D);
  int warps = MAX_WARPS;
  while (warps > 1 && lay.floats(warps) * sizeof(float) > SMEM_BUDGET)
    warps /= 2;
  const size_t bytes = lay.floats(warps) * sizeof(float);
  if (bytes > SMEM_BUDGET) return cudaErrorInvalidValue;
  const int q_groups = (Q + warps - 1) / warps;
  if ((long long)T * q_groups > INT_MAX) return cudaErrorInvalidValue;

  auto kernel = step_pattern == 1 ? dtw_kernel<true> : dtw_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<T * q_groups, 32 * warps, bytes, stream>>>(
      q, q_lens, t, t_lens, out, Q, T, L, D, q_groups);
  return cudaGetLastError();
}
