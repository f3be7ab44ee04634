// Fused crop preprocess for the VPD student, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of vpd_tpu/ops/pallas/preprocess.py
// (launched by `preprocess_crops_pallas`). It computes, per pixel,
//   [(rgb/255 - mean) * (1/std), flow[..., :2]/255 - 0.5]
// and writes it in bf16, mirrored along W with the x-flow channel (3)
// negated where the sample is flipped. This equals the plain
// `eval_transform_batch` + `flip_batch` of vpd_tpu_torch/data/augment.py.
//
// What bounds it: bytes. Every output value costs three flops, far below
// the card's ~295 flops per byte of bandwidth, so the least time is the
// uint8 input read once plus the bf16 output written once over 3.35 TB/s.
// At the extraction batch (B=512, 128x128, pair mode) that is
// 25.2 MB rgb + 25.2 MB flow + 167.8 MB out = 218.1 MB -> 65 us.
//
// Design: one thread per input pixel reads its 3 rgb bytes and 2 flow
// bytes once, normalizes in f32 and stores C bf16 values. Consecutive
// threads touch consecutive pixels, so loads and stores coalesce; the
// flipped copy goes to the mirrored column of the same row, which is also
// contiguous across a warp. In pair mode (mode 1) one read of the uint8
// input produces both the original (out[:B]) and the flipped (out[B:])
// variant, which is what extraction always embeds. The output is
// (N, H, W, C) contiguous: channels_last for the encoder, so it needs no
// copy. None of the TPU layout tricks (W*C lane packing, permutation
// matmuls, int32 cast hops) are needed here.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Norm {
  float mean[3];
  float inv_std[3];
};

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
__global__ void preprocess_kernel(const uint8_t* __restrict__ rgb,
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

}  // namespace

// rgb: (B, H, W, 3) uint8; flow: (B, H, W, flow_c) uint8 or null (then
// C = 3); flip: (B,) int32 or null (mode 0 only); out: (B, H, W, C) bf16
// in mode 0 and (2B, H, W, C) in mode 1. All pointers are device memory;
// the launch goes on `stream`. Returns cudaGetLastError() after launch.
extern "C" int vpd_preprocess_crops(const void* rgb, const void* flow,
                                    int flow_c, const void* flip, void* out,
                                    int batch, int height, int width,
                                    float mean0, float mean1, float mean2,
                                    float inv_std0, float inv_std1,
                                    float inv_std2, int mode, void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0 || (mode != 0 && mode != 1) ||
      (flow != nullptr && flow_c < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Norm norm = {{mean0, mean1, mean2}, {inv_std0, inv_std1, inv_std2}};
  const int64_t pixels = static_cast<int64_t>(batch) * height * width;
  const int threads = 256;
  const int64_t want = (pixels + threads - 1) / threads;
  const unsigned blocks =
      static_cast<unsigned>(want < (1ll << 30) ? want : (1ll << 30));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* rgb8 = static_cast<const uint8_t*>(rgb);
  const uint8_t* flow8 = static_cast<const uint8_t*>(flow);
  const int32_t* flip32 = static_cast<const int32_t*>(flip);
  __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out);
  if (flow8 != nullptr) {
    preprocess_kernel<5><<<blocks, threads, 0, s>>>(
        rgb8, flow8, flow_c, flip32, dst, batch, height, width, norm, mode);
  } else {
    preprocess_kernel<3><<<blocks, threads, 0, s>>>(
        rgb8, nullptr, 0, flip32, dst, batch, height, width, norm, mode);
  }
  return static_cast<int>(cudaGetLastError());
}
