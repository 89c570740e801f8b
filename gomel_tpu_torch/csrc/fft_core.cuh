// The float32 FFT body shared by the frame kernels KB (rfft_mag.cu), KE
// (phase_encode.cu) and KG (phase_decode.cu).
//
// An n-point real transform runs as an m = n/2 point complex transform in one
// thread block's shared memory (complex_fft: radix-2 Stockham when m is a
// power of two, mixed radix over m's prime factors otherwise):
//   - forward: the n real samples, read as m complex values
//     z[k] = x[2k] + i x[2k+1], go through complex_fft<false>; real_split_bin
//     then forms the rfft bins
//       X[k] = (Z[k] + conj Z[m-k]) / 2 - i tw[k] (Z[k] - conj Z[m-k]) / 2
//     for 0 < k < m, X[0] = Re Z0 + Im Z0, X[m] = Re Z0 - Im Z0;
//   - inverse (KG, KJ): inverse_split_bin forms Z from the half spectrum,
//     and complex_fft<true> (conjugated twiddles) gives z, whose real and
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

// exp(-2 pi i j / n) for 0 <= j < n = 2m, from the half-circle table tw
// (j >= m: -tw[j - m]).
__device__ __forceinline__ float2 twiddle_at(const float2* __restrict__ tw,
                                             int j, int m) {
  if (j < m) return tw[j];
  const float2 w = tw[j - m];
  return make_float2(-w.x, -w.y);
}

// exp(-2 pi i j / n), conjugated for an inverse transform.
template <bool kInverse>
__device__ __forceinline__ float2 root_at(const float2* __restrict__ tw, int j,
                                          int m) {
  float2 w = twiddle_at(tw, j, m);
  if (kInverse) w.y = -w.y;
  return w;
}

// One Stockham pass of radix r over the m complex values in a, into b; ns is
// the product of the radices of the passes before it. Butterfly j < m/r
// takes a[j + t*m/r] (t < r) times the twiddle exp(-2 pi i t k / (ns r)),
// k = j mod ns, and writes their r-point DFT to b[(j - k) r + k + s ns]
// (s < r). kR > 0 is a radix known at compile time: one thread a butterfly,
// the r inputs in registers. kR = 0 takes any r (the primes above 7): one
// thread an output, b[i] = sum_t a[...] exp(-2 pi i t (s ns + k) / (ns r)),
// the pass's twiddle folded into the DFT's roots.
template <bool kInverse, int kR>
__device__ __forceinline__ void radix_pass(const float2* __restrict__ a,
                                           float2* __restrict__ b,
                                           const float2* __restrict__ tw,
                                           int m, int ns, int r) {
  const int stride = m / r;
  const int step = 2 * m / (ns * r);  // table entries per 1/(ns r) turn
  if constexpr (kR > 0) {
    float2 root[kR];  // exp(-2 pi i c / r)
#pragma unroll
    for (int c = 0; c < kR; ++c) {
      root[c] = root_at<kInverse>(tw, c * ns * step, m);
    }
    for (int j = threadIdx.x; j < stride; j += blockDim.x) {
      const int k = j % ns;
      float2 v[kR];
#pragma unroll
      for (int t = 0; t < kR; ++t) {
        const float2 u = a[j + t * stride];
        if (t == 0) {
          v[t] = u;
        } else {
          const float2 w = root_at<kInverse>(tw, t * k * step, m);  // < 2m
          v[t] = make_float2(u.x * w.x - u.y * w.y, u.x * w.y + u.y * w.x);
        }
      }
      float2* dst = b + (j - k) * kR + k;
#pragma unroll
      for (int s = 0; s < kR; ++s) {
        float re = 0.0f;
        float im = 0.0f;
#pragma unroll
        for (int t = 0; t < kR; ++t) {
          const float2 w = root[(t * s) % kR];
          re += v[t].x * w.x - v[t].y * w.y;
          im += v[t].x * w.y + v[t].y * w.x;
        }
        dst[s * ns] = make_float2(re, im);
      }
    }
  } else {
    const int span = ns * r;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const int q = i / span;
      const int e = i - q * span;  // s*ns + k
      const int k = e % ns;
      const float2* src = a + q * ns + k;
      const int inc = e * step;  // < 2m
      int j = 0;
      float re = 0.0f;
      float im = 0.0f;
      for (int t = 0; t < r; ++t) {
        const float2 w = root_at<kInverse>(tw, j, m);
        const float2 v = src[t * stride];
        re += v.x * w.x - v.y * w.y;
        im += v.x * w.y + v.y * w.x;
        j += inc;
        if (j >= 2 * m) j -= 2 * m;
      }
      b[i] = make_float2(re, im);
    }
  }
}

// Mixed-radix Stockham over the m complex values in a, for an m that is not
// a power of two: one radix_pass a factor of m, radix 4 while 4 divides
// what is left, then 2, 3, 5, 7, then any prime (the sizes the wrappers
// pass have every prime factor below 128, as the TPU's n = n1 * n2 split
// with both factors <= 128 implies). Returns the buffer that holds the
// result, in natural order; kInverse conjugates the roots (an unscaled
// inverse).
template <bool kInverse>
__device__ __forceinline__ float2* mixed_radix_fft(
    float2* a, float2* b, const float2* __restrict__ tw, int m) {
  int rest = m;
  for (int ns = 1; ns < m;) {
    int r = 4;
    if (rest % 4 != 0) {
      r = 2;
      while (rest % r != 0) ++r;  // the smallest prime factor left
    }
    switch (r) {
      case 2: radix_pass<kInverse, 2>(a, b, tw, m, ns, r); break;
      case 3: radix_pass<kInverse, 3>(a, b, tw, m, ns, r); break;
      case 4: radix_pass<kInverse, 4>(a, b, tw, m, ns, r); break;
      case 5: radix_pass<kInverse, 5>(a, b, tw, m, ns, r); break;
      case 7: radix_pass<kInverse, 7>(a, b, tw, m, ns, r); break;
      default: radix_pass<kInverse, 0>(a, b, tw, m, ns, r); break;
    }
    __syncthreads();
    float2* t = a;
    a = b;
    b = t;
    rest /= r;
    ns *= r;
  }
  return a;
}

// The m-point complex FFT of the frame kernels: radix-2 Stockham (kPow2, m a
// power of two) or mixed radix. Each frame kernel is built in both forms and
// its entry point launches the one m needs (launch_frames), so the radix-2
// form keeps its own register count, and with it its occupancy.
template <bool kInverse, bool kPow2>
__device__ __forceinline__ float2* complex_fft(float2* a, float2* b,
                                               const float2* __restrict__ tw,
                                               int m) {
  if constexpr (kPow2) return stockham_fft<kInverse>(a, b, tw, m);
  return mixed_radix_fft<kInverse>(a, b, tw, m);
}

inline bool is_pow2(int m) { return (m & (m - 1)) == 0; }

// Launch a frame kernel (the form for m: pow2 or mixed radix) with one block
// a frame, m/2 threads clamped to [32, 256] and smem bytes of dynamic shared
// memory.
template <typename Kernel, typename... Args>
void launch_frames(Kernel kernel, long long blocks, int m, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  int threads = m / 2;
  if (threads > 256) threads = 256;
  if (threads < 32) threads = 32;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(args...);
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
