// The overlap-add body shared by KH (phase_decode.cu) and KK (griffinlim.cu),
// and the window sum and PCM-16 conversion KH shares with KM
// (shard_epilogue.cu).
//
// One thread per output sample t = i * hop + c (hop-row i, column c), so
// every sample has one owner: no atomics, and the sum is deterministic. It
// adds the K = ceil(n / hop) frames covering t with k ascending (frame i - k,
// column k * hop + c), from 0.0f, each add rounded on its own: the order of
// gomel_tpu/ops/istft.py:35-37, so the sum equals the plain version's bit for
// bit.
#pragma once

#include <math.h>

#include "common.cuh"

__device__ __forceinline__ float ola_sum(const float* __restrict__ src,
                                         long long i, int c, int frames,
                                         int n, int hop, int taps) {
  float acc = 0.0f;
  for (int k = 0; k < taps; ++k) {
    const long long fi = i - k;
    const int col = k * hop + c;
    float v = 0.0f;
    if (fi >= 0 && fi < frames && col < n) v = src[fi * n + col];
    acc = __fadd_rn(acc, v);
  }
  return acc;
}

// The window sum of ``frames`` frames at hop-row i (< frames + taps - 1),
// column c, from the [taps, hop] prefix table S[k] = sum_{j <= k} of the
// hop-rows of w^2 (gomel_tpu/ops/istft.py:51-72): head, periodic middle and
// tail rows, or the short form. Shared by KH and KM (shard_epilogue.cu).
__device__ __forceinline__ float window_sum_at(const float* __restrict__ table,
                                               long long i, int c, int frames,
                                               int taps, int hop,
                                               int short_form) {
  const long long rows_out = static_cast<long long>(frames) + taps - 1;
  if (short_form) {
    const float top = table[min(i, static_cast<long long>(taps - 1)) * hop + c];
    const long long s = i - frames;
    const float sub =
        s >= 0 ? table[min(s, static_cast<long long>(taps - 1)) * hop + c]
               : 0.0f;
    return top - sub;
  }
  const float full = table[static_cast<long long>(taps - 1) * hop + c];
  if (i < taps - 1) return table[i * hop + c];
  if (i < rows_out - (taps - 1)) return full;
  return full - table[(i - (rows_out - (taps - 1))) * hop + c];
}

// gomel_tpu/ops/quantize.py:124 pcm16_encode for one sample: clip to
// [-1, 1], rintf(x * 32768) (round half to even), saturate; NaN stores 0, as
// the JAX program's conversion gives. The caller clears the finite flag.
__device__ __forceinline__ int16_t pcm16_sample(float y) {
  float q = isnan(y) ? 0.0f : fminf(fmaxf(y, -1.0f), 1.0f);
  q = fminf(fmaxf(rintf(q * 32768.0f), -32768.0f), 32767.0f);
  return static_cast<int16_t>(q);
}
