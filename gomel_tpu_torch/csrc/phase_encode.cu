// KE: framed, windowed real FFT as (imag, real) planes — the phase encode.
//
// Replaces gomel_tpu/ops/phase_ops.py:27 phase_encode and :55
// phase_encode_batch (K5): frames x Hann -> rfft -> (imag, real) of bins
// 1..nf. The same entry point serves gomel_tpu/ops/fftbackend.py:50
// rfft_planes on framed input (hop = n, no window, bins 0..n/2).
// On the TPU the FFT was the matrix-unit Cooley-Tukey split; here it is KB's
// transform: the register-resident forward core of fft_core.cuh when n/2 is
// a power of two (the frame read straight from the signal into registers,
// the window applied there), else the shared-memory mixed radix.
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
// core and the frames' 3.2x overlap through L2, not the float32 rate; its
// epilogue stores 8 bytes a bin (no sqrt), so stores weigh more than KB's.
// The epilogue takes the pairs (k, n/2 - k) that hold a bin of
// first..first+count-1 and stores the members in that range.
#include "fft_core.cuh"

namespace {

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
  // the pairs (k, m - k), 0 <= k <= m/2, with a bin in first..last, whose
  // k lie in lo..hi (k = 0: DC and Nyquist from Z[0])
  const int last = first + count - 1;
  const int lo = min(first, m - last) < 0 ? 0 : min(first, m - last);
  const int hi = min(m / 2, max(last, m - first));
  float2* dst = out + frame * count;
  for (int k = (lo / threads) * threads + th; k <= hi; k += threads) {
    if (k < lo) continue;
    float2 a, b;
    if (k == 0) {
      const float2 z0 = z[0];
      a = make_float2(z0.x + z0.y, 0.0f);
      b = make_float2(z0.x - z0.y, 0.0f);
    } else {
      split_pair(z, tw, k, m, a, b);
    }
    if (k >= first && k <= last) dst[k - first] = make_float2(a.y, a.x);
    if (2 * k != m && m - k >= first && m - k <= last) {
      dst[m - k - first] = make_float2(b.y, b.x);
    }
  }
}

// The shared-memory form (see rfft_mag.cu's stft_mag_kernel): kPow2 = false
// is the route for n/2 not a power of two, kPow2 = true the earlier radix-2
// form, kept for tools/profile_fft.py's race.
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

// x: float32 signal, frame (b, f) starting at x + b*batch_stride + f*hop;
// window: float32 [n] or null; tw: float2 [n/2]; out: float32
// [batch*frames, count, 2] holding (im, re) of bins first..first+count-1,
// with first + count <= n/2 + 1. n must be an even size of the TPU's
// n1 * n2 split (ops/fftbackend.ct_supported; the wrapper checks). tw_pass,
// radices, threads and frames_per_block: as gomel_stft_mag's.
GOMEL_API int gomel_stft_planes(const void* x, const void* window,
                                const void* tw, const void* tw_pass, void* out,
                                long long batch, long long frames,
                                long long batch_stride, long long hop,
                                long long n, int first, int count, int radices,
                                int threads, int frames_per_block, int device,
                                void* stream) {
  cudaSetDevice(device);
  const int m = static_cast<int>(n / 2);
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_pow2(m) && m >= 2) {
    const bool vec = frames_vec_aligned(x, window, batch_stride, hop);
    return with_log_m(m, [&](auto log_m) {
      constexpr int kL = decltype(log_m)::value;
      return launch_pow2_frames<kL>(
          stft_planes_pow2_kernel<kL>, batch * frames, radices, threads,
          frames_per_block, s, static_cast<const float*>(x),
          static_cast<const float*>(window), static_cast<const float2*>(tw),
          static_cast<const float2*>(tw_pass), static_cast<float2*>(out),
          batch * frames, static_cast<int>(frames), batch_stride, hop, vec,
          first, count);
    });
  }
  const size_t smem = 2 * static_cast<size_t>(m) * sizeof(float2);
  launch_frames(stft_planes_kernel<false>, batch * frames, m, smem, s,
                static_cast<const float*>(x), static_cast<const float*>(window),
                static_cast<const float2*>(tw), static_cast<float2*>(out),
                static_cast<int>(frames), batch_stride, hop, m, first, count);
  return gomel_status();
}
