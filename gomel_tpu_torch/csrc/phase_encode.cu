// KE: framed, windowed real FFT as (imag, real) planes — the phase encode.
//
// Replaces gomel_tpu/ops/phase_ops.py:27 phase_encode and :55
// phase_encode_batch (K5): frames x Hann -> rfft -> (imag, real) of bins
// 1..nf. The same entry point serves gomel_tpu/ops/fftbackend.py:50
// rfft_planes on framed input (hop = n, no window, bins 0..n/2).
// On the TPU the FFT was the matrix-unit Cooley-Tukey split; here it is KB's
// transform (rfft_mag.cu), the frame read straight from the signal into
// registers with the window applied there: the register-resident forward
// core of fft_core.cuh when n/2 is a power of two (fwd_frame_pow2), else its
// mixed-radix register core (fwd_frame_mixed; n = 3000: radices 15, 10, 10,
// 50 threads a frame, 3 frames a block).
//
// Output: out[frame, j] = (Im X[first + j], Re X[first + j]) for j < count,
// as float2, so the [..., F, nf, 2] layout of the JAX op comes out directly
// (phase_ops.py:51) and the stores coalesce. Bin n/2 has Im 0.
//
// Precision: float32 on the CUDA cores only (no TF32, no tensor cores): the
// encode FFT sits before the quantizer's extrema, and the repo's rule keeps
// everything upstream of the PNG quantizer at full float32.
//
// Bound: at the phase path's 2 x 1122 frames it must read the 11.5 MB signal
// and write 27.6 MB of planes: 0.0117 ms at 3.35 TB/s. As for KB, what keeps
// it above that is instruction issue and barrier latency in the register
// cores and the frames' 3.2x overlap through L2, not the float32 rate; its
// epilogue stores 8 bytes a bin (no sqrt), so stores weigh more than KB's.
// Both forms share one epilogue (store_planes): it takes only the pairs
// (k, n/2 - k) that hold a bin of first..first+count-1, splits each from
// one read of Z[k], Z[n/2 - k] and tw[k], and stores the members in that
// range. tools/profile_fft.py races both forms against the shared-memory
// ones they replaced (tools/fft_earlier.cuh).
#include "fft_core.cuh"

namespace {

// The epilogue: bins first..first+count-1 of a frame from Z in z (kSwz: the
// power-of-two core's swizzled buffer, else natural order) into dst, as
// (Im, Re), by thread th of the frame's threads.
template <bool kSwz>
__device__ __forceinline__ void store_planes(const float2* z,
                                             const float2* __restrict__ tw,
                                             float2* __restrict__ dst, int m,
                                             int th, int threads, int first,
                                             int count) {
  // the pairs (k, m - k), 0 <= k <= m/2, with a bin in first..last, whose
  // k lie in lo..hi (k = 0: DC and Nyquist from Z[0])
  const int last = first + count - 1;
  const int lo = min(first, m - last) < 0 ? 0 : min(first, m - last);
  const int hi = min(m / 2, max(last, m - first));
  for (int k = (lo / threads) * threads + th; k <= hi; k += threads) {
    if (k < lo) continue;
    float2 a, b;
    if (k == 0) {
      const float2 z0 = z[0];
      a = make_float2(z0.x + z0.y, 0.0f);
      b = make_float2(z0.x - z0.y, 0.0f);
    } else {
      split_values(z[kSwz ? swz(k) : k], z[kSwz ? swz(m - k) : m - k],
                   __ldg(&tw[k]), a, b);
    }
    if (k >= first && k <= last) dst[k - first] = make_float2(a.y, a.x);
    if (2 * k != m && m - k >= first && m - k <= last) {
      dst[m - k - first] = make_float2(b.y, b.x);
    }
  }
}

// The power-of-two form, as KB's (rfft_mag.cu) with this epilogue.
template <int kLogM>
__global__ void __launch_bounds__(FwdPlan<kLogM>::threads *
                                  FwdPlan<kLogM>::frames_per_block)
stft_planes_pow2_kernel(const float* __restrict__ x,
                        const float* __restrict__ window,
                        const float2* __restrict__ tw,
                        const float2* __restrict__ twp,
                        float2* __restrict__ out, long long total, int frames,
                        long long batch_stride, long long hop, bool vec,
                        int first, int count) {
  using Plan = FwdPlan<kLogM>;
  constexpr int m = Plan::m;
  constexpr int threads = Plan::threads;
  extern __shared__ float2 sbuf[];
  const int slot = threadIdx.x / threads;
  const int th = threadIdx.x - slot * threads;
  const long long frame =
      static_cast<long long>(blockIdx.x) * Plan::frames_per_block + slot;
  const bool valid = frame < total;
  const long long bi = frame / frames;
  const long long fi = frame - bi * frames;
  float2* z = sbuf + slot * m;
  fwd_frame_pow2<kLogM>(z, valid ? x + bi * batch_stride + fi * hop : x,
                        window, vec, valid, twp, th);
  if (!valid) return;
  store_planes<true>(z, tw, out + frame * count, m, th, threads, first,
                     count);
}

// The mixed-radix form (n/2 not a power of two), as KB's
// (stft_mag_mixed_kernel) with this epilogue: pl.frames frames a block of
// pl.threads each, pl.frame_stride float2 of shared memory a frame.
__global__ void __launch_bounds__(kMixedBlockThreads)
stft_planes_mixed_kernel(const float* __restrict__ x,
                         const float* __restrict__ window,
                         const float2* __restrict__ tw,
                         const float2* __restrict__ twp,
                         float2* __restrict__ out,
                         const __grid_constant__ MixedPlan pl, long long total,
                         int frames, long long batch_stride, long long hop,
                         bool vec, int first, int count) {
  extern __shared__ float2 sbuf[];
  const int threads = pl.threads;
  const int slot = threadIdx.x / threads;
  const int th = threadIdx.x - slot * threads;
  const long long frame = static_cast<long long>(blockIdx.x) * pl.frames + slot;
  const bool valid = frame < total;
  const long long bi = frame / frames;
  const long long fi = frame - bi * frames;
  const FrameSource in{valid ? x + bi * batch_stride + fi * hop : x, window,
                       vec, valid};
  const float2* z =
      fwd_frame_mixed(sbuf + slot * pl.frame_stride, in, twp, pl, th);
  if (!valid) return;
  store_planes<false>(z, tw, out + frame * count, pl.m, th, threads, first,
                      count);
}

}  // namespace

// x: float32 signal, frame (b, f) starting at x + b*batch_stride + f*hop;
// window: float32 [n] or null; tw: float2 [n/2]; out: float32
// [batch*frames, count, 2] holding (im, re) of bins first..first+count-1,
// with first + count <= n/2 + 1. n must be an even size of the TPU's
// n1 * n2 split (ops/fftbackend.ct_supported; the wrapper checks). tw_pass,
// radices, threads and frames_per_block: as gomel_stft_mag's (the plan of
// ops/rfft_mag.fwd_plan or mixed_plan); a plan the kernel refuses launches
// nothing and returns cudaErrorInvalidValue.
GOMEL_API int gomel_stft_planes(const void* x, const void* window,
                                const void* tw, const void* tw_pass, void* out,
                                long long batch, long long frames,
                                long long batch_stride, long long hop,
                                long long n, int first, int count,
                                long long radices, int threads,
                                int frames_per_block, int device,
                                void* stream) {
  cudaSetDevice(device);
  const int m = static_cast<int>(n / 2);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = frames_vec_aligned(x, window, batch_stride, hop);
  if (is_pow2(m) && m >= 2) {
    return with_log_m(m, [&](auto log_m) {
      constexpr int kL = decltype(log_m)::value;
      return launch_pow2_frames<kL>(
          stft_planes_pow2_kernel<kL>, batch * frames,
          static_cast<int>(radices), threads, frames_per_block, s,
          static_cast<const float*>(x), static_cast<const float*>(window),
          static_cast<const float2*>(tw), static_cast<const float2*>(tw_pass),
          static_cast<float2*>(out), batch * frames, static_cast<int>(frames),
          batch_stride, hop, vec, first, count);
    });
  }
  MixedPlan pl;
  if (!make_mixed_plan(m, radices, threads, frames_per_block, &pl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_mixed_frames(
      stft_planes_mixed_kernel, batch * frames, pl, s,
      static_cast<const float*>(x), static_cast<const float*>(window),
      static_cast<const float2*>(tw), static_cast<const float2*>(tw_pass),
      static_cast<float2*>(out), pl, batch * frames, static_cast<int>(frames),
      batch_stride, hop, vec, first, count);
}
