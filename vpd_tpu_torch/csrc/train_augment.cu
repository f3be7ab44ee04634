// The student's train-time input stage in one pass, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: vpd_tpu's augmentation is plain XLA
// (vpd_tpu/data/augment.py). On the card the same chain in plain PyTorch
// (`train_augment_batch` of vpd_tpu_torch/data/augment.py, after an
// `index_select` of the cache rows) is 60-100 launches, each reading and
// writing the whole batch. This kernel computes, per image, exactly that
// chain on the draws `sample_train_augment` made:
//   - the cache row `rows[b] - row_offset` (or image b without rows);
//   - colour jitter (brightness, contrast, saturation, hue) in the image's
//     order, from a (B, 4) table (a batch-wide order is one row with stride
//     0); contrast blends with the image's mean grey, a block reduction in
//     a fixed order (no atomics, so the output is deterministic);
//   - normalization by the sport's statistics, plus noise * sqrt(0.05) on
//     the person pixels (mask > 0) of the samples drawn for it;
//   - the flow decoded as u8 / 255 - 0.5 (first two channels);
//   - the horizontal flip, as index arithmetic, with the x-flow negated;
//   - RandomResizedCrop: bilinear sampling at pixel centres clamped at the
//     border, rows first and then columns, the non-zero weights of the
//     plain path's interpolation matrices (`_interp_matrix`);
// and writes the (B, out, out, C) NHWC input in bf16, float32 or float64.
// Every value is computed in float32 (in float64 for a float64 output) and
// rounded once, where it is stored.
//
// What bounds it: bytes, by the count that every correct kernel must move:
// the whole rgb image (the contrast mean reads it) and the output, at
// B = 2048, 128 x 128, 5 channels in bf16 100.7 + 335.5 = 436.2 MB, 130 us
// at 3.35 TB/s (772 MB, 230 us, with every flow, mask and noise byte). The
// arithmetic is about 200 float32 operations a source pixel (the HSV round
// trip), 6.7 G at that shape, 0.1 ms at the card's 67 TFLOP/s: the two
// bounds are close, so the design spends no operation twice where it can
// help it.
//
// Design: one block of kThreads threads an image.
// 1. Tables of the crop's source rows and columns and their weights for
//    every output row and column (columns as source columns, the flip
//    applied), and, with jitter, the mean grey: every pixel through the
//    ops that precede contrast, summed per thread in a fixed order, then
//    over the warp by shuffles and over the warps in order.
// 2. Output rows in tiles of up to kTileRows. A tile needs a run of source
//    rows; each is computed once, in the columns the crop reads, through
//    the whole pointwise chain (jitter, normalize, noise, flow decode) into
//    a ring of rows in shared memory (in the compute type), slot = row %
//    ring rows. Rows a tile shares with the one before stay in the ring.
//    Then each output pixel reads its 4 taps from the ring and is staged
//    in shared memory in the output type; the staged tile, a contiguous
//    run of the output, leaves in 16-byte stores as the next tile's rows
//    are computed. A warp takes a row, its lanes along it, in both halves
//    of a tile.
// At 128 x 128, 5 channels, bf16 a block stages 40 KB and takes 64
// registers a thread: four blocks (1,024 threads) an SM. Measured on the
// H100 at B = 2048 in bf16: 0.91-1.05 ms, 12-14% of the 130 us byte bound,
// against 18.6-19.1 ms for the plain chain it replaces.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 8;
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most on sm_90
constexpr size_t kHeadBytes = 256;   // warp sums and the mean grey
constexpr double kTiny = 1e-8;
constexpr double kNoiseSd = 0.22360679774997896;  // sqrt(0.05)

// dtype codes of the output
constexpr int kFloat32 = 0, kBFloat16 = 1, kFloat64 = 2;

struct Params {
  const uint8_t* rgb;   // (N, H, W, 3)
  const uint8_t* flow;  // (N, H, W, flow_c) or null
  const uint8_t* mask;  // (N, H, W) or null
  const int32_t* rows;  // (B,), or null: image b is row b
  int64_t n_rows, row_offset;
  const float *fb, *fc, *fs, *fh;  // (B,) each, or null: no jitter
  const int64_t* order;            // (B, 4) op table, row stride below
  int order_stride;
  const void* noise;           // (B, H, W, 3) in the output's dtype
  const uint8_t* apply_noise;  // (B,) bool
  const float *top, *left, *crop_h, *crop_w;  // (B,) each
  const uint8_t* flip;                        // (B,) bool
  void* out;                                  // (B, S, S, C)
  int flow_c, height, width, out_size, tile_rows, ring_rows;
  double mean[3], inv_std[3];
};

// The arithmetic runs in float32, or in float64 for a float64 output.
template <typename OutT>
struct Compute {
  using type = float;
};
template <>
struct Compute<double> {
  using type = double;
};

__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double vmin(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float vfloor(float x) { return floorf(x); }
__device__ __forceinline__ double vfloor(double x) { return floor(x); }
__device__ __forceinline__ float vfma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double vfma(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }

__device__ __forceinline__ float load_value(const float* p) { return *p; }
__device__ __forceinline__ double load_value(const double* p) { return *p; }
__device__ __forceinline__ float load_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_value(double* p, double v) { *p = v; }
__device__ __forceinline__ void store_value(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ T clamp01(T x) {
  return vmin(vmax(x, T(0)), T(1));
}

// x mod 1 as torch's remainder gives it for a divisor of 1
template <typename T>
__device__ __forceinline__ T mod1(T x) {
  return x - vfloor(x);
}

template <typename T>
__device__ __forceinline__ T grey(T r, T g, T b) {
  return T(0.299) * r + T(0.587) * g + T(0.114) * b;
}

template <typename T>
struct Jitter {
  T fb, fc, fs, fh, mean;
};

template <typename T>
struct Norm {
  T mean[3], inv_std[3];
};

// One jitter op (0 brightness, 1 contrast, 2 saturation, 3 hue) on a pixel
// in [0, 1], the formulas of data/augment.batch_color_jitter.
template <typename T>
__device__ __forceinline__ void jitter_op(int op, const Jitter<T>& j, T& r,
                                          T& g, T& b) {
  if (op == 0) {
    r = clamp01(r * j.fb);
    g = clamp01(g * j.fb);
    b = clamp01(b * j.fb);
  } else if (op == 1 || op == 2) {
    const T m = op == 1 ? j.mean : grey(r, g, b);
    const T f = op == 1 ? j.fc : j.fs;
    r = clamp01((r - m) * f + m);
    g = clamp01((g - m) * f + m);
    b = clamp01((b - m) * f + m);
  } else {
    // RGB -> HSV, the hue shifted mod 1, HSV -> RGB
    const T maxc = vmax(vmax(r, g), b);
    const T minc = vmin(vmin(r, g), b);
    const T delta = maxc - minc;
    const T s = maxc > T(0) ? delta * rcp(vmax(maxc, T(kTiny))) : T(0);
    const T inv = rcp(vmax(delta, T(kTiny)));
    const T rc = (maxc - r) * inv;
    const T gc = (maxc - g) * inv;
    const T bc = (maxc - b) * inv;
    T h = r == maxc ? bc - gc
                    : (g == maxc ? T(2) + rc - bc : T(4) + gc - rc);
    h = delta > T(0) ? mod1(h * (T(1) / T(6))) : T(0);
    h = mod1(h + j.fh);
    const T h6 = h * T(6);
    const T sector = vfloor(h6);
    const T f = h6 - sector;
    const T v = maxc;
    const T p = v * (T(1) - s);
    const T q = v * (T(1) - s * f);
    const T t = v * (T(1) - s * (T(1) - f));
    switch (static_cast<int>(sector) % 6) {
      case 0: r = v; g = t; b = p; break;
      case 1: r = q; g = v; b = p; break;
      case 2: r = p; g = v; b = t; break;
      case 3: r = p; g = q; b = v; break;
      case 4: r = t; g = p; b = v; break;
      default: r = v; g = p; b = q; break;
    }
  }
}

// One source pixel through the pointwise chain into `dst`: rgb / 255,
// the jitter ops in order, normalize, the mask noise (in OutT), and with
// C = 5 the decoded flow. `pix` indexes the streams, `noise_pix` the
// batch's noise.
template <typename OutT, typename T, int C>
__device__ __forceinline__ void chain_pixel(const Params& p, int64_t pix,
                                            int64_t noise_pix, bool jitter,
                                            int ops, const Jitter<T>& j,
                                            const Norm<T>& norm, bool noisy,
                                            T* dst) {
  const T inv255 = T(1) / T(255);
  T v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = p.rgb[3 * pix + c] * inv255;
  if (jitter) {
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      jitter_op((ops >> (2 * k)) & 3, j, v[0], v[1], v[2]);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = (v[c] - norm.mean[c]) * norm.inv_std[c];
  if (noisy && p.mask[pix] > 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] += load_value(static_cast<const OutT*>(p.noise) +
                         noise_pix * 3 + c) *
              T(kNoiseSd);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) dst[c] = v[c];
  if constexpr (C == 5) {
    const uint8_t* fl = p.flow + pix * p.flow_c;
    dst[3] = fl[0] * inv255 - T(0.5);
    dst[4] = fl[1] * inv255 - T(0.5);
  }
}

// The block's staged tile of `n` values to `dst`: 16 bytes a store where
// both ends are 16-byte aligned, else a value a store.
template <typename OutT>
__device__ __forceinline__ void store_tile(const OutT* stage, OutT* dst,
                                           int n) {
  const int bytes = n * static_cast<int>(sizeof(OutT));
  if (((reinterpret_cast<uintptr_t>(dst) | bytes) & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(stage);
    for (int k = threadIdx.x; k < bytes / 16; k += kThreads) {
      reinterpret_cast<uint4*>(dst)[k] = src[k];
    }
  } else {
    for (int k = threadIdx.x; k < n; k += kThreads) dst[k] = stage[k];
  }
}

// Source index pair and weights of output position o along an axis: the
// plain path's (1 - w) at floor(pos) and w at floor(pos) + 1, clamped; a
// clamped pair collapses onto one index with weight (1 - w) + w. pos is
// computed in the plain path's order of operations.
__device__ __forceinline__ void axis_taps(int o, float start, float extent,
                                          int out, int size, int& lo,
                                          int& hi, float& wlo, float& whi) {
  const float pos = __fadd_rn(
      __fadd_rn(start, __fdiv_rn(__fmul_rn(static_cast<float>(o) + 0.5f,
                                           extent),
                                 static_cast<float>(out))),
      -0.5f);
  lo = min(max(static_cast<int>(floorf(pos)), 0), size - 1);
  hi = min(lo + 1, size - 1);
  const float w = clamp01(pos - static_cast<float>(lo));
  if (lo == hi) {
    wlo = __fadd_rn(1.f - w, w);
    whi = 0.f;
  } else {
    wlo = 1.f - w;
    whi = w;
  }
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Shared memory: head (warp sums, mean), the 8 tables of S entries, the
// ring of rows in the compute type (C values a pixel), the staged output
// tile.
__host__ __device__ __forceinline__ size_t ring_offset(int out_size) {
  return kHeadBytes + align16(static_cast<size_t>(8) * 4 * out_size);
}

template <typename T, int C>
__host__ __device__ __forceinline__ size_t stage_offset(int out_size,
                                                        int width,
                                                        int ring_rows) {
  return ring_offset(out_size) +
         align16(static_cast<size_t>(ring_rows) * width * C * sizeof(T));
}

template <typename OutT, int C>
size_t smem_bytes(int out_size, int width, int ring_rows, int tile_rows) {
  using T = typename Compute<OutT>::type;
  return stage_offset<T, C>(out_size, width, ring_rows) +
         static_cast<size_t>(tile_rows) * out_size * C * sizeof(OutT);
}

// The kernel's body: image blockIdx.x.
template <typename OutT, int C>
__device__ __forceinline__ void augment_image(const Params& p) {
  using T = typename Compute<OutT>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int H = p.height, W = p.width, S = p.out_size;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  T* red = reinterpret_cast<T*>(smem);  // kWarps sums, then the mean
  int* ylo = reinterpret_cast<int*>(smem + kHeadBytes);
  int* yhi = ylo + S;
  float* ywlo = reinterpret_cast<float*>(yhi + S);
  float* ywhi = ywlo + S;
  int* xlo = reinterpret_cast<int*>(ywhi + S);  // source columns
  int* xhi = xlo + S;
  float* xwlo = reinterpret_cast<float*>(xhi + S);
  float* xwhi = xwlo + S;
  T* ring = reinterpret_cast<T*>(smem + ring_offset(S));
  OutT* stage =
      reinterpret_cast<OutT*>(smem + stage_offset<T, C>(S, W, p.ring_rows));

  int64_t row = b;
  if (p.rows != nullptr) {
    row = p.rows[b] - p.row_offset;
    if (row < 0 || row >= p.n_rows) __trap();  // as index_select asserts
  }
  const int64_t base = row * H * W;  // the image's first pixel
  const bool flipped = p.flip[b] != 0;
  const bool jitter = p.fb != nullptr;
  const bool noisy = p.mask != nullptr && p.apply_noise[b] != 0;

  Norm<T> norm;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    norm.mean[c] = static_cast<T>(p.mean[c]);
    norm.inv_std[c] = static_cast<T>(p.inv_std[c]);
  }
  Jitter<T> j = {T(1), T(1), T(1), T(0), T(0)};
  int ops = 0, n_before_contrast = 0;  // ops: 2 bits an op, in order
  if (jitter) {
    j.fb = p.fb[b];
    j.fc = p.fc[b];
    j.fs = p.fs[b];
    j.fh = p.fh[b];
    const int64_t* o = p.order + static_cast<int64_t>(b) * p.order_stride;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int op = static_cast<int>(o[k]) & 3;
      ops |= op << (2 * k);
      if (op == 1) n_before_contrast = k;
    }
  }

  // 1. the tables and the mean grey
  const float top = p.top[b], left = p.left[b];
  const float ch = p.crop_h[b], cw = p.crop_w[b];
  for (int o = tid; o < S; o += kThreads) {
    axis_taps(o, top, ch, S, H, ylo[o], yhi[o], ywlo[o], ywhi[o]);
    int lo, hi;
    axis_taps(o, left, cw, S, W, lo, hi, xwlo[o], xwhi[o]);
    xlo[o] = flipped ? W - 1 - lo : lo;
    xhi[o] = flipped ? W - 1 - hi : hi;
  }
  if (jitter) {
    const T inv255 = T(1) / T(255);
    T acc = T(0);
    const uint8_t* px = p.rgb + base * 3;
    for (int q = tid; q < H * W; q += kThreads) {
      T r = px[3 * q] * inv255;
      T g = px[3 * q + 1] * inv255;
      T bl = px[3 * q + 2] * inv255;
#pragma unroll 1
      for (int k = 0; k < n_before_contrast; ++k) {
        jitter_op((ops >> (2 * k)) & 3, j, r, g, bl);
      }
      acc += grey(r, g, bl);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(~0u, acc, d);
    if (lane == 0) red[warp] = acc;
    __syncthreads();
    if (tid == 0) {
      T sum = T(0);
      for (int w = 0; w < kWarps; ++w) sum += red[w];
      red[kWarps] = sum / static_cast<T>(H * W);
    }
  }
  __syncthreads();
  j.mean = red[kWarps];  // unused without jitter

  // the source columns the crop reads
  const int ca = min(min(xlo[0], xhi[0]), min(xlo[S - 1], xhi[S - 1]));
  const int cb = max(max(xlo[0], xhi[0]), max(xlo[S - 1], xhi[S - 1]));
  const int ring_rows = p.ring_rows;
  OutT* out = static_cast<OutT*>(p.out);

  // 2. tiles of output rows
  int done = -1;             // the last source row in the ring
  int staged0 = 0, staged_rows = 0;  // the staged tile, still to store
  for (int oy0 = 0; oy0 < S;) {
    const int lo = ylo[oy0];
    int oy1 = oy0 + 1;
    while (oy1 < S && oy1 - oy0 < p.tile_rows &&
           yhi[oy1] - lo < ring_rows) {
      ++oy1;
    }
    const int hi = yhi[oy1 - 1];
    const int first = max(lo, done + 1);

    // the new source rows, through the pointwise chain, into the ring: a
    // warp a row, its lanes along the row
    for (int y = first + warp; y <= hi; y += kWarps) {
      T* ring_row = ring + static_cast<size_t>(y % ring_rows) * W * C;
      for (int x = ca + lane; x <= cb; x += 32) {
        chain_pixel<OutT, T, C>(
            p, base + static_cast<int64_t>(y) * W + x,
            (static_cast<int64_t>(b) * H + y) * W + x, jitter, ops, j, norm,
            noisy, ring_row + x * C);
      }
    }
    // the tile before, staged, leaves meanwhile
    store_tile(stage, out + (static_cast<int64_t>(b) * S + staged0) * S * C,
               staged_rows * S * C);
    done = max(done, hi);
    __syncthreads();

    // the tile's output pixels from their 4 taps: a warp an output row
    for (int oy = oy0 + warp; oy < oy1; oy += kWarps) {
      const T* r0 = ring + static_cast<size_t>(ylo[oy] % ring_rows) * W * C;
      const T* r1 = ring + static_cast<size_t>(yhi[oy] % ring_rows) * W * C;
      const T wy0 = ywlo[oy], wy1 = ywhi[oy];
      OutT* o_row = stage + static_cast<size_t>(oy - oy0) * S * C;
      for (int ox = lane; ox < S; ox += 32) {
        const T wx0 = xwlo[ox], wx1 = xwhi[ox];
        const int c0 = xlo[ox] * C, c1 = xhi[ox] * C;
        OutT* o = o_row + ox * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const T a = vfma(wy1, r1[c0 + c], wy0 * r0[c0 + c]);
          const T e = vfma(wy1, r1[c1 + c], wy0 * r0[c1 + c]);
          T v = vfma(wx1, e, wx0 * a);
          if (C == 5 && c == 3 && flipped) v = -v;
          store_value(o + c, v);
        }
      }
    }
    staged0 = oy0;
    staged_rows = oy1 - oy0;
    oy0 = oy1;
    __syncthreads();
  }
  store_tile(stage, out + (static_cast<int64_t>(b) * S + staged0) * S * C,
             staged_rows * S * C);
}

// bf16 and float32 output. ptxas fits the 5-channel builds in 64
// registers (four blocks an SM) without spilling.
template <typename OutT, int C>
__global__ void __launch_bounds__(kThreads)
    train_augment_kernel(const Params p) {
  augment_image<OutT, C>(p);
}

// float64 output, for parity runs: at the register count ptxas picks under
// the launch bound alone its 5-channel build spills; one block an SM as
// the bound's floor lets it take the registers it needs.
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    train_augment_kernel_f64(const Params p) {
  augment_image<double, C>(p);
}

template <typename OutT, int C>
int launch(Params p, int batch, cudaStream_t stream) {
  // a tile of R output rows reads at most (R - 1) H / S + 2 source rows;
  // one more for rounding (the kernel also ends a tile where the ring is
  // full). Halve R until the block's shared memory fits.
  size_t smem = 0;
  for (int r = kTileRows; r >= 1; r /= 2) {
    p.tile_rows = r;
    p.ring_rows = std::min(p.height, ((r - 1) * p.height + p.out_size - 1) /
                                             p.out_size + 3);
    smem = smem_bytes<OutT, C>(p.out_size, p.width, p.ring_rows, r);
    if (smem <= kMaxSmem) break;
  }
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const Params);
  if constexpr (std::is_same_v<OutT, double>) {
    kernel = train_augment_kernel_f64<C>;
  } else {
    kernel = train_augment_kernel<OutT, C>;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<batch, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_channels(const Params& p, int batch, cudaStream_t stream) {
  return p.flow != nullptr ? launch<OutT, 5>(p, batch, stream)
                           : launch<OutT, 3>(p, batch, stream);
}

}  // namespace

// rgb: (N, H, W, 3) uint8; flow: (N, H, W, flow_c) uint8 or null (then 3
// output channels, else 5); mask: (N, H, W) uint8 or null; rows: (B,)
// int32 indices into N after subtracting row_offset, or null (then N = B
// and image b is row b). fb, fc, fs, fh: (B,) float32 each, or all null
// (no jitter); order: the (B, 4) int64 op table, order_stride 4 (per
// sample) or 0 (one row for the batch). noise: (B, H, W, 3) in the
// output's dtype, apply_noise: (B,) bool, both read only with a mask.
// top, left, crop_h, crop_w: (B,) float32; flip: (B,) bool. out: (B, S,
// S, C) in dtype code out_dtype, S = out_size. Dtype codes: 0 float32, 1
// bfloat16, 2 float64. Device pointers; the launch goes on `stream`.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// (nothing launched) for arguments the kernel does not take.
extern "C" int vpd_train_augment(
    const void* rgb, const void* flow, int flow_c, const void* mask,
    const void* rows, long long n_rows, long long row_offset, const void* fb,
    const void* fc, const void* fs, const void* fh, const void* order,
    int order_stride, const void* noise, const void* apply_noise,
    const void* top, const void* left, const void* crop_h,
    const void* crop_w, const void* flip, void* out,
    int out_dtype, int batch, int height, int width, int out_size,
    double mean0, double mean1, double mean2, double inv_std0,
    double inv_std1, double inv_std2, void* stream) {
  const bool jitter = fb != nullptr;
  auto code_ok = [](int code) { return code >= kFloat32 && code <= kFloat64; };
  if (batch <= 0 || height <= 0 || width <= 0 || out_size <= 0 ||
      n_rows <= 0 || (flow != nullptr && flow_c < 2) ||
      (rows == nullptr && n_rows != batch) || !code_ok(out_dtype) ||
      (jitter && (fc == nullptr || fs == nullptr || fh == nullptr ||
                  order == nullptr || (order_stride != 0 &&
                                       order_stride != 4))) ||
      (mask != nullptr && (noise == nullptr || apply_noise == nullptr)) ||
      static_cast<long long>(height) * width >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.rgb = static_cast<const uint8_t*>(rgb);
  p.flow = static_cast<const uint8_t*>(flow);
  p.mask = static_cast<const uint8_t*>(mask);
  p.rows = static_cast<const int32_t*>(rows);
  p.n_rows = n_rows;
  p.row_offset = row_offset;
  p.fb = static_cast<const float*>(fb);
  p.fc = static_cast<const float*>(fc);
  p.fs = static_cast<const float*>(fs);
  p.fh = static_cast<const float*>(fh);
  p.order = static_cast<const int64_t*>(order);
  p.order_stride = order_stride;
  p.noise = noise;
  p.apply_noise = static_cast<const uint8_t*>(apply_noise);
  p.top = static_cast<const float*>(top);
  p.left = static_cast<const float*>(left);
  p.crop_h = static_cast<const float*>(crop_h);
  p.crop_w = static_cast<const float*>(crop_w);
  p.flip = static_cast<const uint8_t*>(flip);
  p.out = out;
  p.flow_c = flow_c;
  p.height = height;
  p.width = width;
  p.out_size = out_size;
  p.mean[0] = mean0;
  p.mean[1] = mean1;
  p.mean[2] = mean2;
  p.inv_std[0] = inv_std0;
  p.inv_std[1] = inv_std1;
  p.inv_std[2] = inv_std2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == kBFloat16) {
    return launch_channels<__nv_bfloat16>(p, batch, s);
  }
  if (out_dtype == kFloat64) return launch_channels<double>(p, batch, s);
  return launch_channels<float>(p, batch, s);
}
