// The form of kernel KA (gomel_tpu_torch/csrc/ingest.cu) before its Hopper
// redesign, kept only for tools/profile_ingest.py, which builds it beside the
// shipped source and races the two; the port's library never contains it.
// Entry point prof_earlier_pcm16_ingest, the arguments of gomel_pcm16_ingest.
//
// Per output sample: int16 -> float, stereo mean, divide by the power-of-two
// scale, zero past the input; zero-stuffing (zp > 0) finds output sample t's
// group g = t / (zp + zs) by a 64-bit division a sample. Each thread converts
// 4 samples a block-width apart, one 2-byte (or 4-byte) load and one 4-byte
// store each; grid y walks the rows, grid x is sized by the output.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float load_sample(const int16_t* __restrict__ src,
                                             long long i, int channels) {
  const int16_t* p = src + i * channels;
  float v = static_cast<float>(p[0]);
  if (channels == 2) v = (v + static_cast<float>(p[1])) / 2.0f;
  return v;
}

__global__ void pcm16_ingest_kernel(const int16_t* __restrict__ pcm,
                                    float* __restrict__ out, long long rows,
                                    long long n_in, long long n_out,
                                    int channels, float scale,
                                    const float* __restrict__ scales, int zp,
                                    int zs) {
  const long long group = static_cast<long long>(zp) + zs;
  const float boost = static_cast<float>(1 + zs);
  const long long tile = static_cast<long long>(kThreads) * kUnroll;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const int16_t* src = pcm + r * n_in * channels;
    float* dst = out + r * n_out;
    const float row_scale = scales != nullptr ? scales[r] : scale;
    for (long long base = blockIdx.x * tile; base < n_out;
         base += static_cast<long long>(gridDim.x) * tile) {
      // all loads first, so each thread keeps kUnroll of them in flight
      float v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long t = base + k * kThreads + threadIdx.x;
        v[k] = 0.0f;
        if (zp == 0) {
          if (t < n_in) v[k] = load_sample(src, t, channels);
        } else {
          const long long g = t / group;
          const long long pos = t - g * group;
          const long long i = g * zp + pos;
          if (pos < zp && i < n_in) v[k] = load_sample(src, i, channels);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long t = base + k * kThreads + threadIdx.x;
        if (t < n_out) {
          dst[t] = zp == 0 ? v[k] / row_scale : (v[k] / row_scale) * boost;
        }
      }
    }
  }
}

}  // namespace

// pcm: int16 [rows, n_in, channels] (channels 1 or 2); out: float32
// [rows, n_out] with n_out >= the upsampled length (n_in when zp = 0);
// scales: float32 [rows], or null for the one ``scale``.
GOMEL_API int prof_earlier_pcm16_ingest(const void* pcm, void* out,
                                         long long rows, long long n_in,
                                         long long n_out, int channels,
                                         float scale,
                                         const void* scales, int zp, int zs,
                                         int device, void* stream) {
  cudaSetDevice(device);
  const long long tile = static_cast<long long>(kThreads) * kUnroll;
  long long bx = (n_out + tile - 1) / tile;
  if (bx > 65535) bx = 65535;
  const long long by = rows < 65535 ? rows : 65535;
  pcm16_ingest_kernel<<<dim3(static_cast<unsigned>(bx), static_cast<unsigned>(by)),
                        kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(pcm), static_cast<float*>(out), rows, n_in,
      n_out, channels, scale, static_cast<const float*>(scales), zp, zs);
  return gomel_status();
}
