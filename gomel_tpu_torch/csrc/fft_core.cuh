// The float32 FFT body shared by the frame kernels KB (rfft_mag.cu), KE
// (phase_encode.cu) and KG (phase_decode.cu).
//
// An n-point real transform runs as an m = n/2 point complex transform in one
// thread block's shared memory:
//   - forward: the n real samples, read as m complex values
//     z[k] = x[2k] + i x[2k+1], go through stockham_fft<false>; real_split_bin
//     then forms the rfft bins
//       X[k] = (Z[k] + conj Z[m-k]) / 2 - i tw[k] (Z[k] - conj Z[m-k]) / 2
//     for 0 < k < m, X[0] = Re Z0 + Im Z0, X[m] = Re Z0 - Im Z0;
//   - inverse (KG): inverse_split_pair forms Z from the half spectrum, and
//     stockham_fft<true> (conjugated twiddles) gives z, whose real and
//     imaginary parts are the even and odd output samples.
// Twiddles come from a table the host computes in float64 and rounds to
// float32: tw[j] = exp(-2 pi i j / n), j < n/2 (ops/rfft_mag.py).
//
// All arithmetic is float32 on the CUDA cores: no tensor cores, no TF32.
#pragma once

#include "common.cuh"

// Copy one frame of n real samples into shared memory (as m packed complex
// values), multiplied by the window on the way when there is one.
__device__ __forceinline__ void load_frame(float* __restrict__ af,
                                           const float* __restrict__ src,
                                           const float* __restrict__ window,
                                           int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float v = src[i];
    if (window != nullptr) v *= window[i];
    af[i] = v;
  }
  __syncthreads();
}

// Stockham radix-2 over the m complex values in a, ping-ponging with b:
// pass with sub-transform size ns (1, 2, ..., m/2). Returns the buffer that
// holds the result, in natural order. kInverse uses conjugated twiddles
// (an unscaled inverse transform).
template <bool kInverse>
__device__ __forceinline__ float2* stockham_fft(float2* a, float2* b,
                                                const float2* __restrict__ tw,
                                                int m) {
  const int half = m / 2;
  for (int ns = 1; ns < m; ns <<= 1) {
    const int tw_stride = m / ns;
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const int k = j & (ns - 1);
      float2 w = tw[k * tw_stride];  // exp(-2 pi i k / (2 ns))
      if (kInverse) w.y = -w.y;
      const float2 u = a[j];
      const float2 v = a[j + half];
      const float vr = v.x * w.x - v.y * w.y;
      const float vi = v.x * w.y + v.y * w.x;
      const int idx = ((j - k) << 1) + k;
      b[idx] = make_float2(u.x + vr, u.y + vi);
      b[idx + ns] = make_float2(u.x - vr, u.y - vi);
    }
    __syncthreads();
    float2* t = a;
    a = b;
    b = t;
  }
  return a;
}

// rfft bin k (0 <= k <= m) as (re, im) from the forward transform Z in z.
__device__ __forceinline__ float2 real_split_bin(const float2* z,
                                                 const float2* __restrict__ tw,
                                                 int k, int m) {
  float re, im;
  if (k == 0 || k == m) {
    const float2 z0 = z[0];
    re = (k == 0) ? z0.x + z0.y : z0.x - z0.y;
    im = 0.0f;
  } else {
    const float2 p = z[k];
    const float2 q = z[m - k];
    // even part E = (p + conj q) / 2, odd part O = -i (p - conj q) / 2
    const float er = 0.5f * (p.x + q.x);
    const float ei = 0.5f * (p.y - q.y);
    const float orr = 0.5f * (p.y + q.y);
    const float oi = -0.5f * (p.x - q.x);
    const float2 w = tw[k];
    re = er + (orr * w.x - oi * w.y);
    im = ei + (orr * w.y + oi * w.x);
  }
  return make_float2(re, im);
}

// Inverse of the real split for bin k of the half spectrum P = X[k],
// Q = X[m-k] (X[m] for k = 0), whose DC and Nyquist imaginary parts are
// already zero: returns 2 Z[k] = (P + conj Q) + i conj(tw[k]) (P - conj Q).
// The factor 2 is folded into the final 1/n scale (instead of 1/m).
__device__ __forceinline__ float2 inverse_split_bin(float2 p, float2 q,
                                                    float2 w) {
  const float ar = p.x + q.x;
  const float ai = p.y - q.y;
  const float dr = p.x - q.x;
  const float di = p.y + q.y;
  // conj(w) (dr + i di) = (w.x dr + w.y di) + i (w.x di - w.y dr); times i
  return make_float2(ar - (w.x * di - w.y * dr), ai + (w.x * dr + w.y * di));
}
