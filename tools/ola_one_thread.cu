// The earlier one-thread-a-sample forms of kernels KH (overlap-add +
// normalise + PCM-16) and KM (shard epilogue), as the port shipped them
// before their hop-row walk (gomel_tpu_torch/csrc/overlap_add.cuh), kept for
// tools/profile_ola.py's race and built only by it (with -I
// gomel_tpu_torch/csrc). One thread a sample in a grid-stride loop, the grid
// capped at 65535 blocks; each sample splits its position into hop-row and
// column by a 64-bit signed division, then reads and writes 4 or 2 bytes at
// a time. With magic != 0 the division becomes a multiply by a reciprocal
// the host precomputed, i = umulhi64(p, magic) (exact for p < 2^32 and hop
// < 2^16 with magic = floor(2^64 / hop) + 1): the ablation that sizes the
// division's share.
#include <math.h>

#include "overlap_add.cuh"

namespace {

__device__ __forceinline__ long long hop_row(long long p, int hop,
                                             unsigned long long magic) {
  if (magic != 0) {
    return static_cast<long long>(
        __umul64hi(static_cast<unsigned long long>(p), magic));
  }
  return p / hop;
}

__global__ void old_overlap_normalize_kernel(
    const float* __restrict__ frames_w, const float* __restrict__ table,
    float* __restrict__ out_f, int16_t* __restrict__ out_pcm,
    int* __restrict__ finite, long long length, int frames, int n, int hop,
    int taps, int short_form, float threshold, float boost,
    unsigned long long magic) {
  const long long b = blockIdx.y;
  const float* src = frames_w + b * frames * static_cast<long long>(n);
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < length; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = hop_row(t, hop, magic);
    const int c = static_cast<int>(t - i * hop);
    const float acc = ola_sum(src, i, c, frames, n, hop, taps);
    float y = acc;
    if (table != nullptr) {
      const float ws = window_sum_at(table, i, c, frames, taps, hop, short_form);
      y = ws > threshold ? __fdiv_rn(acc, ws)
                         : (ws > 1e-21f ? __fdiv_rn(acc, threshold) : acc);
    }
    if (boost != 0.0f) y = __fmul_rn(y, boost);
    if (!isfinite(y)) finite[b] = 0;
    if (out_f != nullptr) out_f[b * length + t] = y;
    if (out_pcm != nullptr) out_pcm[b * length + t] = pcm16_sample(y);
  }
}

__global__ void old_shard_epilogue_kernel(
    const float* __restrict__ sig_ext, long long ext_len,
    const float* __restrict__ recv, long long recv_stride, int halo,
    const float* __restrict__ table, long long start, int n_frames, int taps,
    int hop, int short_form, float threshold, float boost,
    const float* __restrict__ t_prev, float momentum,
    float* __restrict__ out_f, long long out_stride,
    float* __restrict__ out_t, int16_t* __restrict__ out_pcm,
    int* __restrict__ finite, long long chunk, unsigned long long magic) {
  const long long b = blockIdx.y;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < chunk; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    float t = sig_ext[b * ext_len + j];
    if (recv != nullptr && j < halo) {
      t = __fadd_rn(t, recv[b * recv_stride + j]);
    }
    float y = t;
    if (table != nullptr) {
      const long long p = start + j;
      const long long i = hop_row(p, hop, magic);
      const int c = static_cast<int>(p - i * hop);
      const float ws =
          i < static_cast<long long>(n_frames) + taps - 1
              ? window_sum_at(table, i, c, n_frames, taps, hop, short_form)
              : 0.0f;
      y = ws > threshold ? __fdiv_rn(t, ws)
                         : (ws > 1e-21f ? __fdiv_rn(t, threshold) : t);
      if (boost != 0.0f) y = __fmul_rn(y, boost);
    }
    if (t_prev != nullptr) {
      const long long at = b * chunk + j;
      y = __fadd_rn(t, __fmul_rn(momentum, __fsub_rn(t, t_prev[at])));
      out_t[at] = t;
    }
    if (!isfinite(y)) finite[b] = 0;
    if (out_f != nullptr) out_f[b * out_stride + j] = y;
    if (out_pcm != nullptr) out_pcm[b * chunk + j] = pcm16_sample(y);
  }
}

unsigned grid_x(long long samples) {
  const long long bx = (samples + 255) / 256;
  return static_cast<unsigned>(bx > 65535 ? 65535 : bx);
}

}  // namespace

// As gomel_overlap_normalize before the walk, plus magic (0: the division).
GOMEL_API int prof_old_overlap_normalize(
    const void* frames_w, const void* table, void* out_f, void* out_pcm,
    void* finite, long long batch, long long frames, long long n,
    long long hop, int short_form, float threshold, float boost,
    unsigned long long magic, int device, void* stream) {
  cudaSetDevice(device);
  const long long length = n + (frames - 1) * hop;
  const int taps = static_cast<int>((n + hop - 1) / hop);
  old_overlap_normalize_kernel<<<dim3(grid_x(length),
                                      static_cast<unsigned>(batch)),
                                 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames_w), static_cast<const float*>(table),
      static_cast<float*>(out_f), static_cast<int16_t*>(out_pcm),
      static_cast<int*>(finite), length, static_cast<int>(frames),
      static_cast<int>(n), static_cast<int>(hop), taps, short_form, threshold,
      boost, magic);
  return gomel_status();
}

// As gomel_shard_epilogue before the walk (start, not row0 and col0), plus
// magic.
GOMEL_API int prof_old_shard_epilogue(
    const void* sig_ext, long long ext_len, const void* recv,
    long long recv_stride, long long halo, const void* table, long long start,
    long long n_frames, long long hop, long long taps, int short_form,
    float threshold, float boost, const void* t_prev, float momentum,
    void* out_f, long long out_stride, void* out_t, void* out_pcm,
    void* finite, long long batch, long long chunk, unsigned long long magic,
    int device, void* stream) {
  cudaSetDevice(device);
  old_shard_epilogue_kernel<<<dim3(grid_x(chunk), static_cast<unsigned>(batch)),
                              256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sig_ext), ext_len,
      static_cast<const float*>(recv), recv_stride, static_cast<int>(halo),
      static_cast<const float*>(table), start, static_cast<int>(n_frames),
      static_cast<int>(taps), static_cast<int>(hop), short_form, threshold,
      boost, static_cast<const float*>(t_prev), momentum,
      static_cast<float*>(out_f), out_stride, static_cast<float*>(out_t),
      static_cast<int16_t*>(out_pcm), static_cast<int*>(finite), chunk, magic);
  return gomel_status();
}
