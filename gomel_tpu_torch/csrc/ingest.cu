// KA: raw PCM-16 ingest — int16 samples to the padded float32 signal.
//
// Replaces gomel_tpu/ops/quantize.py:105 pcm16_ingest (K1) with its zero-stuff
// upsample, gomel_tpu/ops/resample.py:17 zero_stuff_upsample (K12), and the
// batch CLIs' per-row scaled ingest, gomel_tpu/parallel/batch.py:289.
//
// Per output sample: int16 -> float, stereo mean ((a + b) / 2, exact in
// float32), divide by the power-of-two scale (exact), zero past the input.
// Every step is exact, so the result equals the JAX program bit for bit.
//
// Per-row scales (``scales`` not null): row r divides by scales[r] instead
// of the one ``scale`` (a bucket of the batch CLIs mixes WAV rows, 32768, and
// mel-scaled FLAC rows, 65536). The JAX program multiplies by the float32
// reciprocal; for a power of two both are exact, so they agree bit for bit.
//
// Zero-stuffing (zp > 0; the phase path at 8-32 kHz and 11.025/22.05 kHz):
// after every zp input samples come zs zeros, and kept samples are
// multiplied by (1 + zs), after the division, as the JAX program orders it.
// Output sample t lies in group g = t / (zp + zs) at r = t mod (zp + zs); it
// is input sample g*zp + r when r < zp and that index exists, else 0. The
// upsampled length is n + ceil(n / zp) * zs: the trailing partial group still
// reserves its zeros. Multiplying by a small integer can round; both sides
// round the same single product, so it stays bit-exact. zp = 0 (the mel
// path) takes the branch it always took.
//
// Bound: device memory bandwidth. It reads 2 (mono) or 4 (stereo) bytes and
// writes 4 bytes per sample, with no arithmetic worth counting.
// Design: each thread converts 4 samples a block-width apart (all 4 loads
// come before any store, to keep enough bytes in flight); neighbouring
// threads take neighbouring samples, so loads and stores coalesce; grid y
// walks the rows, so there is no 64-bit division per sample; the padding is
// written by the same pass, so the output needs no separate memset.
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
GOMEL_API int gomel_pcm16_ingest(const void* pcm, void* out, long long rows,
                                 long long n_in, long long n_out, int channels,
                                 float scale, const void* scales, int zp,
                                 int zs, int device, void* stream) {
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
