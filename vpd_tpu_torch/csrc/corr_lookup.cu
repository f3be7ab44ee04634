// RAFT's correlation lookup in one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: vpd_tpu's lookup is plain XLA
// (vpd_tpu/models/raft.py, `corr_lookup`), a separable hat-weight form
// written for the TPU's matrix unit. On the card that form
// (`corr_lookup_reference` in vpd_tpu_torch/ops/corr.py) is about 65
// launches a lookup: two (N, 2r+1, size) weight tensors a level through six
// elementwise launches each, two small float32 batched products a level
// (N = 65,536 products of 16 x 16 x 9 at the finest level) and a cat.
//
// What it computes: for query n (a cell of the 1/8 grid) with centre
// (cx, cy), level l and tap offsets i, j in [-r, r], the bilinear sample of
// the query's (h_l, w_l) map at (cx / 2^l + i, cy / 2^l + j), zero outside
// the map: grid_sample(align_corners=True, padding_mode='zeros'), which the
// hat weights equal. The output is (N, levels * (2r+1)^2) float32, each
// level's taps x-offset-major: k = (i + r) * (2r + 1) + (j + r).
//
// What bounds it: bytes. At the flow cell's shapes (256 pairs, a 16 x 16
// grid, 4 levels of 16, 8, 4 and 2 cells a side, r = 4) a correct kernel
// writes the output once, 65,536 x 324 x 4 B = 84.9 MB, reads the
// coordinates, 0.5 MB, and of each query's maps at most each level's
// (2r+2)^2 window inside the map, 65,536 x (100 + 64 + 16 + 4) x 4 B =
// 48.2 MB of the pyramid's 89.1 MB: 133.7 MB, 39.9 us at 3.35 TB/s. The
// arithmetic is six multiply-adds an output, 127 M, nothing on this card.
//
// Design: all (2r+1)^2 taps of a level share one fractional offset, since
// the tap offsets are whole cells, so a level's samples come from the
// (2r+2) x (2r+2) window of cells from (floor(cx / 2^l) - r,
// floor(cy / 2^l) - r). A warp takes one query (kWarps queries a block).
// 1. Its lanes load every level's window into shared memory, the cells
//    inside the map from device memory and zeros outside, row by row so
//    that neighbouring lanes read neighbouring cells; the loads of all
//    levels are issued before any is used. Only the window's cells are
//    read, so the bytes follow the window and not the map: 100 + 64 + 16
//    + 4 of a query's 340 cells at the cell's shapes, 48.2 MB, some 64 MB
//    in 32-byte sectors (a window's 40-byte rows straddle sectors).
// 2. Each lane computes outputs from the window: the corner weights from
//    the fractional part (rounded per tap offset as the plain twin rounds
//    centre + offset, so the two agree to float32 rounding), then four
//    loads from shared memory (the window is kept column-major, so that
//    neighbouring lanes, which take neighbouring y offsets, read
//    neighbouring words) and six multiply-adds an output. The query's row
//    is staged in shared memory.
// 3. The staged row leaves in 16-byte stores where its length is a
//    multiple of 4 floats (324 x 4 B = 81 x 16 B at the cell's shapes), so
//    one warp store writes 512 contiguous bytes; else in 4-byte stores,
//    neighbouring lanes on neighbouring words.
// No atomics, no scratch in device memory, no host sync. One build a
// radius (3 for raft-small, 4 for RAFT basic); the levels (1 to kMaxLevels, each map at least 1 x 1)
// and the number of queries are arguments. 32 registers a thread and
// 23 KB of shared memory a block at the cell's shapes: 64 warps an SM.
// Measured on the H100 at the cell's shapes: 92-103 us a launch, 39-43%
// of the 39.9 us bound, against about 2 ms for the plain form it replaces
// and 0.29 ms for F.grid_sample over the four levels. Copying the windows
// with cp.async gained about 5%, a pipelined walk of many queries a warp
// lost 20% (64 registers), and a table of the tap weights nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxLevels = 8;

struct Params {
  const float* maps[kMaxLevels];  // level l: (N, h[l], w[l])
  int h[kMaxLevels];
  int w[kMaxLevels];
  int levels;
  const float* coords;  // (N, 2): x, y on the finest level's grid
  float* out;           // (N, levels * (2r+1)^2)
  int64_t n;
};

// Floats of one warp's shared memory: the staged row, rounded up to whole
// 16-byte words, then the levels' windows.
__host__ __device__ constexpr int warp_floats(int taps, int side,
                                              int levels) {
  return ((levels * taps + 3) & ~3) + levels * side * side;
}

// One axis of a query at level l: the centre there, c / 2^l (exact), and
// its cell, floor(c / 2^l), clamped so that a centre too far off the map
// for any tap to reach it still makes an int index (its taps are zero).
__device__ __forceinline__ float2 axis(float c, int level, int size,
                                       int r) {
  const float scaled = ldexpf(c, -level);
  const float lo = static_cast<float>(-2 * r - 2);
  const float hi = static_cast<float>(size + 2 * r + 2);
  return make_float2(scaled, fminf(fmaxf(floorf(scaled), lo), hi));
}

// The weight of the far cell of tap offset d on an axis: the rounded
// centre + d less its cell, in [0, 1], as the plain twin's hat weights
// round it (its near cell takes 1 - that). A non-finite centre gives 0.
__device__ __forceinline__ float far_weight(float2 a, int d) {
  const float f = __fadd_rn(a.x, static_cast<float>(d)) -
                  (a.y + static_cast<float>(d));
  return fminf(fmaxf(f, 0.f), 1.f);
}

template <int R>
__global__ void __launch_bounds__(kThreads) corr_lookup_kernel(
    const Params p) {
  constexpr int kSide = 2 * R + 2;   // window cells a side
  constexpr int kK = 2 * R + 1;      // taps a side
  constexpr int kTaps = kK * kK;     // taps a level
  constexpr int kCells = kSide * kSide;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (q >= p.n) return;  // a whole warp; the block never synchronises
  const int levels = p.levels;
  const int row_len = levels * kTaps;
  float* stage = smem + warp * warp_floats(kTaps, kSide, levels);
  float* win = stage + ((row_len + 3) & ~3);
  const float cx = __ldg(p.coords + 2 * q);
  const float cy = __ldg(p.coords + 2 * q + 1);

  // 1. the windows, zeros outside the map; stored column-major
  for (int l = 0; l < levels; ++l) {
    const int h = p.h[l], w = p.w[l];
    const int x0 = static_cast<int>(axis(cx, l, w, R).y) - R;
    const int y0 = static_cast<int>(axis(cy, l, h, R).y) - R;
    const float* map = p.maps[l] + q * h * w;
    float* dst = win + l * kCells;
#pragma unroll
    for (int e = lane; e < kCells; e += 32) {
      const int row = e / kSide;
      const int col = e - row * kSide;
      const int y = y0 + row, x = x0 + col;
      const bool inside = y >= 0 && y < h && x >= 0 && x < w;
      dst[col * kSide + row] = inside ? __ldg(map + y * w + x) : 0.f;
    }
  }
  __syncwarp();

  // 2. the taps: four corners each, x first and then y, as the twin's
  // two products
  for (int l = 0; l < levels; ++l) {
    const float2 ax = axis(cx, l, p.w[l], R);
    const float2 ay = axis(cy, l, p.h[l], R);
    const float* src = win + l * kCells;
    float* row_out = stage + l * kTaps;
#pragma unroll
    for (int k = lane; k < kTaps; k += 32) {
      const int i = k / kK;      // x offset + r: the window's column
      const int j = k - i * kK;  // y offset + r: the window's row
      const float fx = far_weight(ax, i - R);
      const float fy = far_weight(ay, j - R);
      const float* c0 = src + i * kSide + j;  // column i, rows j and j + 1
      const float* c1 = c0 + kSide;           // column i + 1
      const float near_row = (1.f - fx) * c0[0] + fx * c1[0];
      const float far_row = (1.f - fx) * c0[1] + fx * c1[1];
      row_out[k] = (1.f - fy) * near_row + fy * far_row;
    }
  }
  __syncwarp();

  // 3. the row, in 16-byte stores where it is a whole number of them
  float* out = p.out + q * row_len;
  if ((row_len & 3) == 0) {
    const float4* from = reinterpret_cast<const float4*>(stage);
    float4* to = reinterpret_cast<float4*>(out);
    for (int v = lane; v < row_len / 4; v += 32) to[v] = from[v];
  } else {
    for (int k = lane; k < row_len; k += 32) out[k] = stage[k];
  }
}

template <int R>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int kSide = 2 * R + 2;
  constexpr int kTaps = (2 * R + 1) * (2 * R + 1);
  const size_t smem = sizeof(float) * kWarps *
                      warp_floats(kTaps, kSide, p.levels);
  const int64_t blocks = (p.n + kWarps - 1) / kWarps;
  corr_lookup_kernel<R><<<static_cast<unsigned>(blocks), kThreads, smem,
                          stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// maps: `levels` device pointers, level l a contiguous (n, heights[l],
// widths[l]) float32 map a query; heights, widths: host arrays. coords:
// (n, 2) float32 (x, y); out: (n, levels * (2r+1)^2) float32, 16-byte
// aligned. The launch goes on `stream`. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue (nothing launched) for arguments
// the kernel does not take: radius other than 3 or 4, levels outside
// 1-kMaxLevels, a map under 1 x 1 or of 2^31 cells or more a query, n
// under 1 or of 2^31 / kWarps blocks or more.
extern "C" int vpd_corr_lookup(const void* const* maps, const int* heights,
                               const int* widths, int levels,
                               const void* coords, void* out, long long n,
                               int radius, void* stream) {
  if ((radius != 3 && radius != 4) || levels < 1 || levels > kMaxLevels ||
      n < 1 || (n + kWarps - 1) / kWarps >= (1ll << 31) ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  for (int l = 0; l < levels; ++l) {
    if (heights[l] < 1 || widths[l] < 1 ||
        static_cast<long long>(heights[l]) * widths[l] >= (1ll << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.maps[l] = static_cast<const float*>(maps[l]);
    p.h[l] = heights[l];
    p.w[l] = widths[l];
  }
  for (int l = levels; l < kMaxLevels; ++l) {
    p.maps[l] = nullptr;
    p.h[l] = p.w[l] = 0;
  }
  p.levels = levels;
  p.coords = static_cast<const float*>(coords);
  p.out = static_cast<float*>(out);
  p.n = n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return radius == 3 ? launch<3>(p, s) : launch<4>(p, s);
}
