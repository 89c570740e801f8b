// KM: the shard epilogue of the frame-sharded synthesis.
//
// Replaces the halo add and what follows it in gomel_tpu/parallel/sharded.py
// (K17, K9, K11, K13 on a shard): _local_overlap_add's
// body.at[:halo].add(recv) (:229-234), the global window-sum normalisation
// and boost of sharded_phase_decode_fn (:503-508, with
// gomel_tpu/ops/istft.py:189 normalize_by_window_sum), the momentum step of
// sharded_griffin_lim_fn (:423-426) and the PCM-16 conversion the long-form
// file decodes run after it (gomel_tpu/ops/quantize.py:124).
//
// Input: the shard's un-normalised overlap-add sig_ext [B, chunk + halo]
// (KH without a window, or KK) and the tail recv [B, halo] its left
// neighbour's overlap-add spilled into it (null on shard 0: the open
// boundary). One thread per output sample j < chunk, one owner each, so no
// atomics: t = sig_ext[j] + recv[j] for j < halo (one rounded add, the order
// of the JAX program), else sig_ext[j]. Then one of:
//   decode (table != null): the window sum at the sample's GLOBAL position
//     p = start + j of a signal of n_frames real frames, from KH's [taps,
//     hop] prefix table (overlap_add.cuh window_sum_at; 0 past the last real
//     frame's span), under the host threshold 0.5 * max of that window sum
//     (global, never per shard), with the three branches of
//     normalize_by_window_sum; then x boost when non-zero; float32 or PCM-16;
//   momentum (t_prev != null): c = t + m * (t - t_prev) rounded step by step,
//     writing c and t (KK's epilogue);
//   plain: t, float32 or PCM-16 (the final Griffin-Lim iteration).
// The float output y / c has a row stride out_stride >= chunk: the GL
// carry is written straight into the next iteration's extended buffer
// [B, chunk + halo], whose halo columns the caller fills from the right
// neighbour. Any non-finite output clears its row's finite flag.
//
// The window sum equals the JAX program's per-shard masked overlap-add plus
// the halo (sharded.py:237-243) up to the order of summation: the JAX sum
// of a sample adds its K = ceil(n / hop) squared-window rows in frame
// order, split at a shard boundary into two partial sums; the table gives
// the prefix sums S[k] and full - S[k]. Each is a sum of at most K
// non-negative float32 terms, so the two differ by at most about 2 K ulp
// of the sum (K = 4 at n = 4096, hop = 1280), relative 5e-7.
//
// Bound: bytes. It reads sig_ext and recv and writes y (and t): at the
// 30-minute phase decode shard (16,880 frames of 1280 hop) 86 MB read and
// 86 MB (float32) or 43 MB (PCM-16) written per row, about 0.04 ms per
// shard at 3.35 TB/s.
#include <math.h>

#include "overlap_add.cuh"

namespace {

__global__ void shard_epilogue_kernel(
    const float* __restrict__ sig_ext, long long ext_len,
    const float* __restrict__ recv, long long recv_stride, int halo,
    const float* __restrict__ table, long long start, int n_frames, int taps,
    int hop, int short_form, float threshold, float boost,
    const float* __restrict__ t_prev, float momentum,
    float* __restrict__ out_f, long long out_stride,
    float* __restrict__ out_t, int16_t* __restrict__ out_pcm,
    int* __restrict__ finite, long long chunk) {
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
      const long long i = p / hop;
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

}  // namespace

// sig_ext: float32 [batch, ext_len]; recv: float32 rows of halo samples
// with row stride recv_stride, or null; table: float32 [taps, hop] prefix
// table (taps = ceil(n / hop)) or null; t_prev: float32 [batch, chunk] or
// null (with out_t float32 [batch, chunk]); out_f: float32 rows of row stride out_stride, or null;
// out_pcm: int16 [batch, chunk] or null; finite: int32 [batch], set to 1 by
// the caller.
GOMEL_API int gomel_shard_epilogue(
    const void* sig_ext, long long ext_len, const void* recv,
    long long recv_stride, long long halo, const void* table, long long start,
    long long n_frames, long long hop, long long taps, int short_form,
    float threshold, float boost, const void* t_prev, float momentum, void* out_f,
    long long out_stride, void* out_t, void* out_pcm, void* finite,
    long long batch, long long chunk, int device, void* stream) {
  cudaSetDevice(device);
  const int threads = 256;
  long long bx = (chunk + threads - 1) / threads;
  if (bx > 65535) bx = 65535;
  shard_epilogue_kernel<<<dim3(static_cast<unsigned>(bx),
                               static_cast<unsigned>(batch)),
                          threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sig_ext), ext_len,
      static_cast<const float*>(recv), recv_stride, static_cast<int>(halo),
      static_cast<const float*>(table), start, static_cast<int>(n_frames),
      static_cast<int>(taps), static_cast<int>(hop), short_form, threshold,
      boost,
      static_cast<const float*>(t_prev), momentum,
      static_cast<float*>(out_f), out_stride, static_cast<float*>(out_t),
      static_cast<int16_t*>(out_pcm), static_cast<int*>(finite), chunk);
  return gomel_status();
}
