// The shared-memory forms of the FFT kernels KB (rfft_mag.cu), KE
// (phase_encode.cu), KJ (griffinlim.cu) and KG (phase_decode.cu) that the
// register-resident cores of gomel_tpu_torch/csrc/fft_core.cuh replaced, for
// tools/profile_fft.py's races. Never built into the port's library: the
// tool appends "#define GOMEL_EARLIER_KB" (KE, KJ, KG) and an include of this
// file to its copy of that kernel's source, whose own helpers the kernel
// uses (KJ's project_bin, KG's half_bin and modes). The code is the shipped
// sources' as it was; each kernel takes kPow2:
//   true   radix-2 Stockham over m = n/2 (n/2 a power of two): log2 m passes
//          through two shared buffers, one barrier each;
//   false  the mixed radix over m's prime factors (radix_pass: radix 4
//          while 4 divides what is left, then 2, 3, 5, 7, then a generic
//          direct sum for larger primes), a dense r x r product a point and
//          pass with roots from the table, ping-ponging between the buffers.
// One block a frame, m/2 threads clamped to [32, 256]; the forward kernels
// load the frame into shared memory first and split each bin on its own
// (real_split_bin), KG loads the half spectrum and splits it in place
// before the transform. The entry points (int pow2 first: 1 radix-2, 0 the
// mixed radix; then the shipped entry point's arguments without the plan):
//   prof_earlier_stft_mag       KB
//   prof_earlier_stft_planes    KE
//   prof_earlier_gl_project     KJ
//   prof_earlier_irfft_window   KG, every mode
//
// Included at the end of the kernel's source, so fft_core.cuh (the variant's
// own copy, for the tool's ablation builds) and common.cuh are already in.
#pragma once

namespace {

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

// The m-point complex FFT of the shared-memory frame kernels: radix-2
// Stockham (kPow2) or the mixed radix.
template <bool kInverse, bool kPow2>
__device__ __forceinline__ float2* complex_fft(float2* a, float2* b,
                                               const float2* __restrict__ tw,
                                               int m) {
  if constexpr (kPow2) return stockham_fft<kInverse>(a, b, tw, m);
  return mixed_radix_fft<kInverse>(a, b, tw, m);
}

// Launch a shared-memory frame kernel with one block a frame, m/2 threads
// clamped to [32, 256] and smem bytes of dynamic shared memory.
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

}  // namespace

#ifdef GOMEL_EARLIER_KB

namespace {

template <bool kPow2>
__global__ void stft_mag_kernel(const float* __restrict__ x,
                                const float* __restrict__ window,
                                const float2* __restrict__ tw,
                                float* __restrict__ out, int frames,
                                long long batch_stride, long long hop, int m) {
  extern __shared__ float2 smem[];
  const long long frame = blockIdx.x;
  const long long bi = frame / frames;
  const long long fi = frame - bi * frames;
  load_frame(reinterpret_cast<float*>(smem), x + bi * batch_stride + fi * hop,
             window, 2 * m);
  const float2* z = complex_fft<false, kPow2>(smem, smem + m, tw, m);

  float* dst = out + frame * (m + 1);
  for (int k = threadIdx.x; k <= m; k += blockDim.x) {
    const float2 v = real_split_bin(z, tw, k, m);
    dst[k] = sqrtf(v.x * v.x + v.y * v.y);
  }
}

}  // namespace

GOMEL_API int prof_earlier_stft_mag(int pow2, const void* x,
                                    const void* window, const void* tw,
                                    void* out, long long batch,
                                    long long frames, long long batch_stride,
                                    long long hop, long long n, int device,
                                    void* stream) {
  cudaSetDevice(device);
  const int m = static_cast<int>(n / 2);
  launch_frames(pow2 ? &stft_mag_kernel<true> : &stft_mag_kernel<false>,
                batch * frames, m, 2 * static_cast<size_t>(m) * sizeof(float2),
                static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
                static_cast<const float*>(window),
                static_cast<const float2*>(tw), static_cast<float*>(out),
                static_cast<int>(frames), batch_stride, hop, m);
  return gomel_status();
}

#endif  // GOMEL_EARLIER_KB

#ifdef GOMEL_EARLIER_KE

namespace {

template <bool kPow2>
__global__ void stft_planes_kernel(const float* __restrict__ x,
                                   const float* __restrict__ window,
                                   const float2* __restrict__ tw,
                                   float2* __restrict__ out, int frames,
                                   long long batch_stride, long long hop,
                                   int m, int first, int count) {
  extern __shared__ float2 smem[];
  const long long frame = blockIdx.x;
  const long long bi = frame / frames;
  const long long fi = frame - bi * frames;
  load_frame(reinterpret_cast<float*>(smem), x + bi * batch_stride + fi * hop,
             window, 2 * m);
  const float2* z = complex_fft<false, kPow2>(smem, smem + m, tw, m);

  float2* dst = out + frame * count;
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const float2 v = real_split_bin(z, tw, first + j, m);
    dst[j] = make_float2(v.y, v.x);
  }
}

}  // namespace

GOMEL_API int prof_earlier_stft_planes(int pow2, const void* x,
                                       const void* window, const void* tw,
                                       void* out, long long batch,
                                       long long frames,
                                       long long batch_stride, long long hop,
                                       long long n, int first, int count,
                                       int device, void* stream) {
  cudaSetDevice(device);
  const int m = static_cast<int>(n / 2);
  launch_frames(pow2 ? &stft_planes_kernel<true> : &stft_planes_kernel<false>,
                batch * frames, m, 2 * static_cast<size_t>(m) * sizeof(float2),
                static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
                static_cast<const float*>(window),
                static_cast<const float2*>(tw), static_cast<float2*>(out),
                static_cast<int>(frames), batch_stride, hop, m, first, count);
  return gomel_status();
}

#endif  // GOMEL_EARLIER_KE

#ifdef GOMEL_EARLIER_KJ

namespace {

template <bool kPow2>
__global__ void gl_project_kernel(const float* __restrict__ sig,
                                  const float* __restrict__ mag,
                                  const float* __restrict__ window,
                                  const float2* __restrict__ tw,
                                  float2* __restrict__ out, int frames,
                                  long long length, long long hop, int m,
                                  float inv_n) {
  extern __shared__ float2 smem[];
  float2* a = smem;
  float2* b = smem + m;
  const long long frame = blockIdx.x;
  const long long bi = frame / frames;
  const long long fi = frame - bi * frames;
  load_frame(reinterpret_cast<float*>(a), sig + bi * length + fi * hop,
             window, 2 * m);
  float2* z = complex_fft<false, kPow2>(a, b, tw, m);
  float2* y = (z == a) ? b : a;

  const float* mg = mag + frame * (m + 1);
  for (int k = threadIdx.x; k <= m / 2; k += blockDim.x) {
    const int q = m - k;
    float2 xk = project_bin(real_split_bin(z, tw, k, m), mg[k]);
    float2 xq = project_bin(real_split_bin(z, tw, q, m), mg[q]);
    if (k == 0) {  // DC and Nyquist
      xk.y = 0.0f;
      xq.y = 0.0f;
    }
    y[k] = inverse_split_bin(xk, xq, tw[k]);
    if (k > 0 && k < q) y[q] = inverse_split_bin(xq, xk, tw[q]);
  }
  __syncthreads();

  const float2* r = complex_fft<true, kPow2>(y, z, tw, m);
  const float2* w2 = reinterpret_cast<const float2*>(window);
  float2* dst = out + frame * m;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float2 v = r[i];
    const float2 w = w2[i];
    dst[i] = make_float2(__fmul_rn(__fmul_rn(v.x, inv_n), w.x),
                         __fmul_rn(__fmul_rn(v.y, inv_n), w.y));
  }
}

}  // namespace

GOMEL_API int prof_earlier_gl_project(int pow2, const void* sig,
                                      const void* mag, const void* window,
                                      const void* tw, void* out,
                                      long long batch, long long frames,
                                      long long length, long long hop,
                                      long long n, int device, void* stream) {
  cudaSetDevice(device);
  const int m = static_cast<int>(n / 2);
  launch_frames(pow2 ? &gl_project_kernel<true> : &gl_project_kernel<false>,
                batch * frames, m, 2 * static_cast<size_t>(m) * sizeof(float2),
                static_cast<cudaStream_t>(stream),
                static_cast<const float*>(sig), static_cast<const float*>(mag),
                static_cast<const float*>(window),
                static_cast<const float2*>(tw), static_cast<float2*>(out),
                static_cast<int>(frames), length, hop, m,
                1.0f / static_cast<float>(n));
  return gomel_status();
}

#endif  // GOMEL_EARLIER_KJ

#ifdef GOMEL_EARLIER_KG

namespace {

template <int kMode, bool kPow2>
__global__ void irfft_window_kernel(const void* __restrict__ src,
                                    const float* __restrict__ aux0,
                                    const float* __restrict__ aux1,
                                    const float* __restrict__ window,
                                    const float2* __restrict__ tw,
                                    float2* __restrict__ out, int frames,
                                    int real_frames, int nf, int m,
                                    float max_val, int ihs_passes,
                                    float inv_n) {
  extern __shared__ float2 smem[];
  float2* a = smem;          // m + 1: the half spectrum X, then Z in place
  float2* b = smem + m + 1;  // m: the Stockham partner buffer
  const long long frame = blockIdx.x;
  const long long bi = frame / frames;
  const long long fi = frame - bi * frames;
  if (fi >= real_frames) {  // block-uniform: no barrier is skipped
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      out[frame * m + i] = make_float2(0.0f, 0.0f);
    }
    return;
  }

  float4 ext = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (kMode == kQuant8 || kMode == kQuant16) {
    ext = make_float4(aux0[2 * bi], aux0[2 * bi + 1], aux1[2 * bi],
                      aux1[2 * bi + 1]);
  }
  for (int k = threadIdx.x; k <= m; k += blockDim.x) {
    a[k] = half_bin<kMode>(src, aux0, frame, bi, fi, k, m, frames, nf,
                           max_val, ext, ihs_passes);
  }
  __syncthreads();

  // 2 Z[k] and 2 Z[m - k] from X[k], X[m - k]: disjoint pairs, in place
  for (int k = threadIdx.x; k <= m / 2; k += blockDim.x) {
    const float2 p = a[k];
    const float2 q = a[m - k];
    const float2 zk = inverse_split_bin(p, q, tw[k]);
    if (k > 0) a[m - k] = inverse_split_bin(q, p, tw[m - k]);
    a[k] = zk;
  }
  __syncthreads();

  const float2* z = complex_fft<true, kPow2>(a, b, tw, m);
  const float2* w2 = reinterpret_cast<const float2*>(window);
  float2* dst = out + frame * m;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float2 v = z[i];
    float x0 = __fmul_rn(v.x, inv_n);
    float x1 = __fmul_rn(v.y, inv_n);
    if (w2 != nullptr) {
      const float2 w = w2[i];
      x0 = __fmul_rn(x0, w.x);
      x1 = __fmul_rn(x1, w.y);
    }
    dst[i] = make_float2(x0, x1);
  }
}

template <int kMode>
void launch_earlier_irfft(bool pow2, const void* src, const void* aux0,
                          const void* aux1, const void* window,
                          const void* tw, void* out, long long total,
                          int frames, int real_frames, int nf, int m,
                          float max_val, int ihs_passes, cudaStream_t s) {
  launch_frames(pow2 ? &irfft_window_kernel<kMode, true>
                     : &irfft_window_kernel<kMode, false>,
                total, m, (2 * static_cast<size_t>(m) + 1) * sizeof(float2),
                s, src, static_cast<const float*>(aux0),
                static_cast<const float*>(aux1),
                static_cast<const float*>(window),
                static_cast<const float2*>(tw), static_cast<float2*>(out),
                frames, real_frames, nf, m, max_val, ihs_passes,
                1.0f / static_cast<float>(2 * m));
}

}  // namespace

GOMEL_API int prof_earlier_irfft_window(int pow2, int mode, const void* src,
                                        const void* aux0, const void* aux1,
                                        const void* window, const void* tw,
                                        void* out, long long batch,
                                        long long frames,
                                        long long real_frames, long long nf,
                                        long long n, float max_val,
                                        int ihs_passes, int device,
                                        void* stream) {
  cudaSetDevice(device);
  const auto s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(n / 2);
  const long long total = batch * frames;
  const int f = static_cast<int>(frames), r = static_cast<int>(real_frames);
  const int k = static_cast<int>(nf);
  switch (mode) {
    case kPlanes:
      launch_earlier_irfft<kPlanes>(pow2, src, aux0, aux1, window, tw, out,
                                    total, f, r, k, m, max_val, ihs_passes, s);
      break;
    case kSpec:
      launch_earlier_irfft<kSpec>(pow2, src, aux0, aux1, window, tw, out,
                                  total, f, r, k, m, max_val, ihs_passes, s);
      break;
    case kQuant8:
      launch_earlier_irfft<kQuant8>(pow2, src, aux0, aux1, window, tw, out,
                                    total, f, r, k, m, max_val, ihs_passes, s);
      break;
    case kQuant16:
      launch_earlier_irfft<kQuant16>(pow2, src, aux0, aux1, window, tw, out,
                                     total, f, r, k, m, max_val, ihs_passes,
                                     s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return gomel_status();
}

#endif  // GOMEL_EARLIER_KG
