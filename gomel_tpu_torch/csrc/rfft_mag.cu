// KB: framed, windowed real-FFT magnitude — |rfft_n(x[f*hop : f*hop+n] * w)|.
//
// Replaces gomel_tpu/ops/stft.py:35 frame_signal with the window multiply and
// gomel_tpu/ops/mxu_fft.py:140 rfft_mag (K2; reached through
// gomel_tpu/ops/fftbackend.py:65). On the TPU the FFT was a Cooley-Tukey split
// into two 32x128 dense matmuls on the matrix unit; on Hopper, when n/2 is a
// power of two, it is the register-resident forward core of fft_core.cuh
// (fwd_frame_pow2), else the shared-memory mixed radix (n = 3000).
//
// Precision: all arithmetic is float32 on the CUDA cores. No tensor cores and
// no TF32: an FFT below full float32 precision is catastrophic after the log
// of the mel filterbank on quiet bins. Twiddles come from tables the host
// computes in float64 and rounds to float32, not from sincosf.
//
// Algorithm: the n real samples are read as m = n/2 complex values
// z[k] = x[2k] + i x[2k+1] (the interleaved float layout IS that complex
// array), straight from the signal into registers with the window applied
// there; radix-8/16 Stockham passes in registers, exchanging through one
// swizzled shared buffer, give Z in natural order; the real split forms the
// m + 1 rfft bins, two a read (k and m - k), and this kernel writes
// sqrtf(re^2 + im^2) for each. A kernel per m (FwdPlan): every index,
// stride and table offset is a compile-time constant.
//
// Bound: at the mel path's shape (2 x 1122 frames of 4096, hop 1280) the
// kernel must read the 11.5 MB signal and write 18.4 MB of magnitudes:
// 0.0089 ms at 3.35 TB/s, above the float32 operations (about 0.3 GFLOP).
// What keeps it above that now is instruction issue and the latency between
// the 5 barriers of a 128-thread block: per 16 points a pass, 15 twiddle
// products and a radix-16 butterfly in registers plus 16 shared-memory
// reads and writes; then the epilogue's split and correctly rounded sqrt;
// and the frames' 3.2x overlap, which sends 37 MB of signal through L2.
// What the design does about it: 3 passes instead of 11, one 16 KB buffer
// a frame (56 registers from ptxas for sm_90a: 9 blocks an SM), the first
// pass loaded straight from the signal as float4, twiddles loaded ahead of
// each pass's barrier, conflict-free exchanges, and the epilogue's reads
// halved by pairing bins.
// tools/profile_fft.py races it against the radix-2 form below and splits
// its time by ablation; PERF.md has the numbers.
#include "fft_core.cuh"

namespace {

// The power-of-two form for m = 2^kLogM: FwdPlan's threads a frame and
// frames a block, m float2 of shared memory a frame.
template <int kLogM>
__global__ void __launch_bounds__(FwdPlan<kLogM>::threads *
                                  FwdPlan<kLogM>::frames_per_block)
stft_mag_pow2_kernel(const float* __restrict__ x,
                     const float* __restrict__ window,
                     const float2* __restrict__ tw,
                     const float2* __restrict__ twp, float* __restrict__ out,
                     long long total, int frames, long long batch_stride,
                     long long hop, bool vec) {
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
  float* dst = out + frame * (m + 1);
  for (int k = th; k <= m / 2; k += threads) {
    float2 a, b;
    if (k == 0) {  // DC and Nyquist from Z[0]
      const float2 z0 = z[0];
      a = make_float2(z0.x + z0.y, 0.0f);
      b = make_float2(z0.x - z0.y, 0.0f);
    } else {
      split_pair(z, tw, k, m, a, b);
    }
    dst[k] = sqrtf(a.x * a.x + a.y * a.y);
    if (2 * k != m) dst[m - k] = sqrtf(b.x * b.x + b.y * b.y);
  }
}

// The shared-memory form: one block a frame, two complex buffers of m.
// kPow2 = false (mixed radix) is the port's route when n/2 is not a power of
// two; kPow2 = true, the radix-2 Stockham form that the register core
// replaced, is kept for tools/profile_fft.py's race.
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

// x: float32 signal, frame (b, f) starting at x + b*batch_stride + f*hop;
// window: float32 [n] or null; tw: float2 [n/2]; out: float32
// [batch*frames, n/2 + 1]. n must be an even size of the TPU's n1 * n2 split
// (ops/fftbackend.ct_supported; the wrapper checks). When n/2 is a power of
// two, tw_pass, radices, threads and frames_per_block are the wrapper's plan
// (ops/rfft_mag.fwd_plan) and its per-pass twiddle table; otherwise they are
// ignored.
GOMEL_API int gomel_stft_mag(const void* x, const void* window, const void* tw,
                             const void* tw_pass, void* out, long long batch,
                             long long frames, long long batch_stride,
                             long long hop, long long n, int radices,
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
          stft_mag_pow2_kernel<kL>, batch * frames, radices, threads,
          frames_per_block, s, static_cast<const float*>(x),
          static_cast<const float*>(window), static_cast<const float2*>(tw),
          static_cast<const float2*>(tw_pass), static_cast<float*>(out),
          batch * frames, static_cast<int>(frames), batch_stride, hop, vec);
    });
  }
  const size_t smem = 2 * static_cast<size_t>(m) * sizeof(float2);
  launch_frames(stft_mag_kernel<false>, batch * frames, m, smem, s,
                static_cast<const float*>(x), static_cast<const float*>(window),
                static_cast<const float2*>(tw), static_cast<float*>(out),
                static_cast<int>(frames), batch_stride, hop, m);
  return gomel_status();
}
