// Fused crop preprocess for the VPD student, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of vpd_tpu/ops/pallas/preprocess.py:37
// (launched by `preprocess_crops_pallas`, pallas_call at :142). It
// computes, per pixel,
//   [(rgb/255 - mean) * (1/std), flow[..., :2]/255 - 0.5]
// and writes it in bf16, mirrored along W with the x-flow channel (3)
// negated where the sample is flipped. This equals the plain
// `eval_transform_batch` + `flip_batch` of vpd_tpu_torch/data/augment.py.
// In pair mode (mode 1) one read of the uint8 input produces both the
// original (out[:B]) and the flipped (out[B:]) variant, which is what
// extraction always embeds. The output is (N, H, W, C) contiguous:
// channels_last for the encoder, so it needs no copy.
//
// What bounds it: bytes. Every output value costs three flops, far below
// the card's ~295 flops per byte of bandwidth, so the least time is the
// uint8 input read once plus the bf16 output written once over 3.35 TB/s.
// At the extraction batch (B=512, 128x128, pair mode, 5 channels) that is
// 25.2 MB rgb + 25.2 MB flow + 167.8 MB out = 218.1 MB -> 65.1 us. The
// output is 77% of those bytes, so the stores set the pace.
//
// Vector variant (W a multiple of 16 and at most kMaxVectorWidth, at most
// 4 flow channels, every pointer 16-byte aligned; the wrapper decides
// from the shapes and pointers, `kernel_variant` in ops/preprocess.py):
// - A block owns `rows` whole (b, h) rows, rows = max(1, kPixelsPerBlock
//   / W), twice that in mode 0, found from blockIdx alone (no division
//   per pixel; one per row for the sample's flip flag). Consecutive rows
//   are consecutive in the input and in both output halves, so a block's
//   rgb, flow, output and flipped output are each one contiguous run of
//   16-byte words.
// - Loads: the block's rgb and flow runs go to shared memory as uint4,
//   neighbouring threads on neighbouring words; each byte is read once.
//   In mode 0 the per-sample flip flag is read once per row.
// - Compute: a thread takes two neighbouring pixels, so its 2C bf16
//   values are C aligned 32-bit words. It writes the original pair at its
//   place and the flipped pair (the two pixels swapped, channel 3
//   negated) at the mirrored place of a second shared row buffer. C is
//   odd, so a warp's word stores hit 32 distinct banks.
// - Stores: both staged runs leave as uint4, consecutive lanes on
//   consecutive 16-byte words: a warp writes 512 contiguous bytes, whole
//   sectors, 80 (5 channels) or 48 (3 channels) stores a 128-pixel row.
// At W = 128 a block of 128 threads holds 4 rows (13.3 KB of shared
// memory in pair mode with 3 flow channels). At 42 registers 10 blocks
// fit an SM, so each SM stages 133 KB, 100 KB of it output. Blocks of
// 256 threads (5 an SM) and streaming stores (__stcs) were slower.
//
// General variant (any W, any flow_c >= 2, any alignment): one thread per
// pixel reads its bytes and writes each bf16 value alone, the kernel of
// the first port. Both variants compute (x * (1/255) - mean) * inv_std in
// float32 and round once with __float2bfloat16_rn, so they agree bit for
// bit.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;          // threads of a vector block
constexpr int kPixelsPerBlock = 512;   // in pair mode; rows = this / W
constexpr int kMaxVectorWidth = 1024;  // keeps a row's staging < 48 KB

struct Norm {
  float mean[3];
  float inv_std[3];
};

// --- vector variant --------------------------------------------------------

// The C bf16 values of pixel p of the block's staged input, as bits.
template <int C, int FLOW_C>
__device__ __forceinline__ void pixel_bits(const uint8_t* __restrict__ rgb,
                                           const uint8_t* __restrict__ flow,
                                           int p, const Norm& norm,
                                           uint32_t (&v)[C]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float x = (static_cast<float>(rgb[p * 3 + c]) * (1.f / 255.f) -
                     norm.mean[c]) * norm.inv_std[c];
    v[c] = __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  if constexpr (C == 5) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float x =
          static_cast<float>(flow[p * FLOW_C + c]) * (1.f / 255.f) - 0.5f;
      v[3 + c] = __bfloat16_as_ushort(__float2bfloat16_rn(x));
    }
  }
}

// Two pixels' 2C values, `first` then `second`, as C 32-bit words.
template <int C>
__device__ __forceinline__ void store_two(uint32_t* __restrict__ dst,
                                          const uint32_t (&first)[C],
                                          const uint32_t (&second)[C]) {
  uint32_t seq[2 * C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    seq[c] = first[c];
    seq[C + c] = second[c];
  }
#pragma unroll
  for (int k = 0; k < C; ++k) dst[k] = seq[2 * k] | (seq[2 * k + 1] << 16);
}

// FLOW_C = 0 means no flow (C = 3); otherwise C = 5 and FLOW_C in 2..4.
// No __launch_bounds__: with it ptxas aims at 40 registers and spills.
template <int C, int FLOW_C>
__global__ void preprocess_vector(const uint4* __restrict__ rgb,
                                  const uint4* __restrict__ flow,
                                  const int32_t* __restrict__ flip,
                                  uint4* __restrict__ out, int total_rows,
                                  int height, int width, int rows, Norm norm,
                                  int pair) {
  extern __shared__ uint4 smem[];
  const int row0 = blockIdx.x * rows;
  const int n_rows = min(rows, total_rows - row0);
  const int pixels = n_rows * width;

  // shared layout, every part a multiple of 16 bytes since W % 16 == 0:
  // flip flags (mode 0), rgb, flow, output, flipped output (mode 1)
  int* s_flip = reinterpret_cast<int*>(smem);
  uint4* s_rgb = smem + (rows + 3) / 4;
  uint4* s_flow = s_rgb + rows * width * 3 / 16;
  uint4* s_out = s_flow + rows * width * FLOW_C / 16;
  uint4* s_flipped = s_out + rows * width * C / 8;

  const int rgb_words = pixels * 3 / 16;
  const int64_t rgb_base = static_cast<int64_t>(row0) * width * 3 / 16;
  for (int k = threadIdx.x; k < rgb_words; k += kThreads) {
    s_rgb[k] = rgb[rgb_base + k];
  }
  if constexpr (FLOW_C > 0) {
    const int flow_words = pixels * FLOW_C / 16;
    const int64_t flow_base =
        static_cast<int64_t>(row0) * width * FLOW_C / 16;
    for (int k = threadIdx.x; k < flow_words; k += kThreads) {
      s_flow[k] = flow[flow_base + k];
    }
  }
  if (!pair && threadIdx.x < n_rows) {
    s_flip[threadIdx.x] =
        flip != nullptr && flip[(row0 + threadIdx.x) / height] != 0;
  }
  __syncthreads();

  const uint8_t* in_rgb = reinterpret_cast<const uint8_t*>(s_rgb);
  const uint8_t* in_flow = reinterpret_cast<const uint8_t*>(s_flow);
  uint32_t* o = reinterpret_cast<uint32_t*>(s_out);
  uint32_t* f = reinterpret_cast<uint32_t*>(s_flipped);
  const int half = width / 2;
  for (int q = threadIdx.x; q < pixels / 2; q += kThreads) {
    const int i = q / half;  // row in the block
    const int mirrored = i * half + (half - 1 - (q - i * half));
    uint32_t a[C], b[C];
    pixel_bits<C, FLOW_C>(in_rgb, in_flow, 2 * q, norm, a);
    pixel_bits<C, FLOW_C>(in_rgb, in_flow, 2 * q + 1, norm, b);
    if (pair || !s_flip[i]) store_two<C>(o + q * C, a, b);
    if (pair || s_flip[i]) {
      if constexpr (C == 5) {  // the x flow changes sign
        a[3] ^= 0x8000u;
        b[3] ^= 0x8000u;
      }
      store_two<C>((pair ? f : o) + mirrored * C, b, a);
    }
  }
  __syncthreads();

  const int out_words = pixels * C / 8;
  const int64_t out_base = static_cast<int64_t>(row0) * width * C / 8;
  for (int k = threadIdx.x; k < out_words; k += kThreads) {
    out[out_base + k] = s_out[k];
  }
  if (pair) {  // the flipped half starts total_rows rows further on
    const int64_t flip_base =
        (static_cast<int64_t>(total_rows) + row0) * width * C / 8;
    for (int k = threadIdx.x; k < out_words; k += kThreads) {
      out[flip_base + k] = s_flipped[k];
    }
  }
}

template <int C, int FLOW_C>
int launch_vector(const void* rgb, const void* flow, const int32_t* flip,
                  void* out, int total_rows, int height, int width,
                  const Norm& norm, int pair, cudaStream_t stream) {
  // mode 0 stages one output buffer, not two: twice the pixels a block
  // stage about as many bytes
  const int pixels = kPixelsPerBlock * (pair ? 1 : 2);
  const int rows = width >= pixels ? 1 : pixels / width;
  const size_t smem =
      16 * ((rows + 3) / 4) +
      static_cast<size_t>(rows) * width * (3 + FLOW_C + 2 * C * (1 + pair));
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<int64_t>(total_rows) + rows - 1) / rows);
  preprocess_vector<C, FLOW_C><<<blocks, kThreads, smem, stream>>>(
      static_cast<const uint4*>(rgb), static_cast<const uint4*>(flow), flip,
      static_cast<uint4*>(out), total_rows, height, width, rows, norm, pair);
  return static_cast<int>(cudaGetLastError());
}

// --- general variant -------------------------------------------------------

template <int C>
__device__ __forceinline__ void store_pixel(__nv_bfloat16* __restrict__ dst,
                                            const float (&v)[C],
                                            bool flipped) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float x = (C == 5 && c == 3 && flipped) ? -v[c] : v[c];
    dst[c] = __float2bfloat16_rn(x);
  }
}

template <int C>
__global__ void preprocess_general(const uint8_t* __restrict__ rgb,
                                   const uint8_t* __restrict__ flow,
                                   int flow_c,
                                   const int32_t* __restrict__ flip,
                                   __nv_bfloat16* __restrict__ out,
                                   int batch, int height, int width,
                                   Norm norm, int pair) {
  const int64_t pixels = static_cast<int64_t>(batch) * height * width;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       p < pixels; p += stride) {
    const int64_t row = p / width;  // b * height + h
    const int w = static_cast<int>(p - row * width);
    const int64_t mirrored = row * width + (width - 1 - w);

    float v[C];
    const uint8_t* px = rgb + p * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] = (static_cast<float>(px[c]) * (1.f / 255.f) - norm.mean[c]) *
             norm.inv_std[c];
    }
    if constexpr (C == 5) {
      const uint8_t* fl = flow + p * flow_c;
      v[3] = static_cast<float>(fl[0]) * (1.f / 255.f) - 0.5f;
      v[4] = static_cast<float>(fl[1]) * (1.f / 255.f) - 0.5f;
    }

    if (pair) {
      store_pixel<C>(out + p * C, v, false);
      store_pixel<C>(out + (pixels + mirrored) * C, v, true);
    } else {
      const int b = static_cast<int>(row / height);
      const bool flipped = flip != nullptr && flip[b] != 0;
      store_pixel<C>(out + (flipped ? mirrored : p) * C, v, flipped);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// rgb: (B, H, W, 3) uint8; flow: (B, H, W, flow_c) uint8 or null (then
// C = 3); flip: (B,) int32 or null (mode 0 only); out: (B, H, W, C) bf16
// in mode 0 and (2B, H, W, C) in mode 1. All pointers are device memory;
// the launch goes on `stream`. `vector` = 1 launches the vector variant,
// and is refused (cudaErrorInvalidValue, nothing launched) where its
// conditions do not hold; 0 launches the general one. Returns
// cudaGetLastError() after launch.
extern "C" int vpd_preprocess_crops(const void* rgb, const void* flow,
                                    int flow_c, const void* flip, void* out,
                                    int batch, int height, int width,
                                    float mean0, float mean1, float mean2,
                                    float inv_std0, float inv_std1,
                                    float inv_std2, int mode, int vector,
                                    void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0 || (mode != 0 && mode != 1) ||
      (flow != nullptr && flow_c < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Norm norm = {{mean0, mean1, mean2}, {inv_std0, inv_std1, inv_std2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* flip32 = static_cast<const int32_t*>(flip);
  if (vector) {
    const int64_t total_rows = static_cast<int64_t>(batch) * height;
    if (width % 16 != 0 || width > kMaxVectorWidth ||
        (flow != nullptr && flow_c > 4) || total_rows >= (1ll << 31) ||
        !aligned16(rgb) || !aligned16(flow) || !aligned16(out)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int rows = static_cast<int>(total_rows);
    switch (flow == nullptr ? 0 : flow_c) {
      case 0:
        return launch_vector<3, 0>(rgb, flow, flip32, out, rows, height,
                                   width, norm, mode, s);
      case 2:
        return launch_vector<5, 2>(rgb, flow, flip32, out, rows, height,
                                   width, norm, mode, s);
      case 3:
        return launch_vector<5, 3>(rgb, flow, flip32, out, rows, height,
                                   width, norm, mode, s);
      default:
        return launch_vector<5, 4>(rgb, flow, flip32, out, rows, height,
                                   width, norm, mode, s);
    }
  }
  const int64_t pixels = static_cast<int64_t>(batch) * height * width;
  const int threads = 256;
  const int64_t want = (pixels + threads - 1) / threads;
  const unsigned blocks =
      static_cast<unsigned>(want < (1ll << 30) ? want : (1ll << 30));
  const uint8_t* rgb8 = static_cast<const uint8_t*>(rgb);
  const uint8_t* flow8 = static_cast<const uint8_t*>(flow);
  __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out);
  if (flow8 != nullptr) {
    preprocess_general<5><<<blocks, threads, 0, s>>>(
        rgb8, flow8, flow_c, flip32, dst, batch, height, width, norm, mode);
  } else {
    preprocess_general<3><<<blocks, threads, 0, s>>>(
        rgb8, nullptr, 0, flip32, dst, batch, height, width, norm, mode);
  }
  return static_cast<int>(cudaGetLastError());
}
