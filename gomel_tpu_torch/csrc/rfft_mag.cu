// KB: framed, windowed real-FFT magnitude — |rfft_n(x[f*hop : f*hop+n] * w)|.
//
// Replaces gomel_tpu/ops/stft.py:35 frame_signal with the window multiply and
// gomel_tpu/ops/mxu_fft.py:140 rfft_mag (K2; reached through
// gomel_tpu/ops/fftbackend.py:65). On the TPU the FFT was a Cooley-Tukey split
// into two 32x128 dense matmuls on the matrix unit; on Hopper, when n/2 is a
// power of two, it is the register-resident forward core of fft_core.cuh
// (fwd_frame_pow2), else its mixed-radix register core (fwd_frame_mixed;
// n = 3000: radices 15, 10, 10, 50 threads a frame, 3 frames a block).
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
// tools/profile_fft.py races it against the shared-memory forms it replaced
// (tools/fft_earlier.cuh) and splits its time by ablation; PERF.md has the
// numbers. At n = 3000 (2 x 1917 frames, the mixed core) the bound is 0.0103 ms (11.5 MB in, 23 MB out);
// the core reaches about 20% of it: its 64 registers and n/2 float2 of
// shared memory a frame let about 900 threads reside an SM, and the
// latency between its barriers shows (bank conflicts cost 3-7%, scalar
// loads nothing; the profile tool's ablations).
//
// The fused KB + KC launch (stft_mel_log_pow2_kernel, gomel_stft_mel_log):
// the mel encode's route when n/2 is a power of two (ops/mel_ops.fused_route).
// The same FFT, then an epilogue that keeps the magnitudes in shared memory
// and runs KC's band sum there (mel_bands.cuh), writing only the log-mel:
// the 18.4 MB of magnitudes at the bench shape are neither written nor read
// back, so the launch's byte bound is the signal in and the log-mel out
// (11.5 + 3.4 MB, 0.0045 ms). The split reads Z[k] and Z[m - k], which the
// magnitudes would overwrite: each thread computes its bins' magnitudes
// into registers (9 pairs at most), a barrier, then they go into the
// frame's own buffer (m + 1 floats of its 2m), so the shared memory a block
// and hence KB's occupancy stay as they are. The magnitudes are the very
// expressions KB stores, and the band sum is KC's, so the log-mel equals
// KB followed by KC bit for bit.
//
// Its int16 mode (gomel_stft_mel_log_pcm16; the mel encode from PCM, KA's
// mono ingest folded in): the first pass reads the int16 samples (8-byte
// loads of 4 where the frames' bases allow, fft_core.cuh Pcm16Samples) and
// forms KA's value, the sample divided by the row's power-of-two scale
// (the int16 bits made a float by a LOP3, no conversion instruction, and
// one exact FMA: common.cuh pcm_biased), zero past the row's samples up to
// the padded length; a launch whose frames all lie inside their rows runs
// a build with no test a load. So the log-mel equals KA followed by the float launch bit
// for bit, KA's launch is gone, and the signal the launch reads is 2 bytes
// a sample (5.75 MB at the bench shape, against KA's 5.75 MB read + 11.5 MB
// written + the float launch's 11.5 MB read).
#include <cstring>

#include "fft_core.cuh"
#include "mel_bands.cuh"

namespace {

// |X[k]| and |X[m - k]| of a frame into dst (k = m - k: once).
__device__ __forceinline__ void store_mag_pair(float* __restrict__ dst, int k,
                                               int m, float2 a, float2 b) {
  dst[k] = sqrtf(a.x * a.x + a.y * a.y);
  if (2 * k != m) dst[m - k] = sqrtf(b.x * b.x + b.y * b.y);
}

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
    store_mag_pair(dst, k, m, a, b);
  }
}

// Where frame (bi, fi) of the mel encode's input starts, and its samples:
// the float32 signal (FloatSignal), or the int16 PCM rows divided by the
// row's scale with zeros past n_in (Pcm16Signal: the int16 mode).
struct FloatSignal {
  const float* x;
  long long batch_stride, hop;
  __device__ __forceinline__ FloatSamples frame(long long bi,
                                                long long fi) const {
    return {x + bi * batch_stride + fi * hop};
  }
};

template <bool kWhole>
struct Pcm16Signal {
  const int16_t* pcm;
  const float* scales;  // [batch], or null for the one scale
  float scale;          // powers of two (pcm_scale's inv not 0)
  long long n_in, hop;  // n_in: a row's samples and its stride
  __device__ __forceinline__ Pcm16Samples<kWhole> frame(long long bi,
                                                        long long fi) const {
    const long long start = fi * hop;
    const PcmScale d =
        pcm_scale(scales != nullptr ? __ldg(scales + bi) : scale);
    return {pcm + bi * n_in + start, n_in - start, d.inv, d.bias};
  }
};

// The fused KB + KC launch for m = 2^kLogM: KB's transform and split, the
// magnitudes into the frame's buffer, then the block's band sums over its
// frames into out [total, table.cols].
template <int kLogM, typename Signal>
__global__ void __launch_bounds__(FwdPlan<kLogM>::threads *
                                  FwdPlan<kLogM>::frames_per_block)
stft_mel_log_pow2_kernel(const Signal sig, const float* __restrict__ window,
                         const float2* __restrict__ tw,
                         const float2* __restrict__ twp, MelTable table,
                         float* __restrict__ out, long long total, int frames,
                         bool vec) {
  using Plan = FwdPlan<kLogM>;
  constexpr int m = Plan::m;
  constexpr int threads = Plan::threads;
  constexpr int kPairs = m / 2 / threads + 1;  // bins k = th + i threads <= m/2
  extern __shared__ float2 sbuf[];
  const int slot = threadIdx.x / threads;
  const int th = threadIdx.x - slot * threads;
  const long long first = static_cast<long long>(blockIdx.x) *
                          Plan::frames_per_block;
  const long long frame = first + slot;
  const bool valid = frame < total;
  const long long bi = valid ? frame / frames : 0;
  const long long fi = valid ? frame - bi * frames : 0;
  float2* z = sbuf + slot * m;
  fwd_frame_pow2_samples<kLogM>(z, sig.frame(bi, fi), window, vec, valid, twp,
                                th);
  float mag_k[kPairs], mag_mk[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int k = th + i * threads;
    if (k <= m / 2) {
      float2 a, b;
      if (k == 0) {  // DC and Nyquist from Z[0]
        const float2 z0 = z[0];
        a = make_float2(z0.x + z0.y, 0.0f);
        b = make_float2(z0.x - z0.y, 0.0f);
      } else {
        split_pair(z, tw, k, m, a, b);
      }
      mag_k[i] = sqrtf(a.x * a.x + a.y * a.y);
      mag_mk[i] = sqrtf(b.x * b.x + b.y * b.y);
    }
  }
  __syncthreads();  // every Z read before the magnitudes overwrite it
  float* mag = reinterpret_cast<float*>(z);
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int k = th + i * threads;
    if (k <= m / 2) {
      mag[k] = mag_k[i];
      if (2 * k != m) mag[m - k] = mag_mk[i];
    }
  }
  __syncthreads();
  const long long left = total - first;
  mel_band_sums<false, 1>(reinterpret_cast<const float*>(sbuf), 2 * m,
                          left < Plan::frames_per_block
                              ? static_cast<int>(left)
                              : Plan::frames_per_block,
                          table, out + first * table.cols);
}

// The mixed-radix form (n/2 not a power of two) on plan pl: pl.frames
// frames a block of pl.threads each, pl.frame_stride float2 of shared
// memory a frame (fft_core.cuh).
__global__ void __launch_bounds__(kMixedBlockThreads)
stft_mag_mixed_kernel(const float* __restrict__ x,
                      const float* __restrict__ window,
                      const float2* __restrict__ tw,
                      const float2* __restrict__ twp, float* __restrict__ out,
                      const __grid_constant__ MixedPlan pl, long long total,
                      int frames, long long batch_stride, long long hop,
                      bool vec) {
  extern __shared__ float2 sbuf[];
  const int m = pl.m;
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
  float* dst = out + frame * (m + 1);
  for (int k = th; k <= m / 2; k += threads) {
    float2 a, b;
    if (k == 0) {  // DC and Nyquist from Z[0]
      const float2 z0 = z[0];
      a = make_float2(z0.x + z0.y, 0.0f);
      b = make_float2(z0.x - z0.y, 0.0f);
    } else {
      split_values(z[k], z[m - k], __ldg(&tw[k]), a, b);
    }
    store_mag_pair(dst, k, m, a, b);
  }
}

}  // namespace

// x: float32 signal, frame (b, f) starting at x + b*batch_stride + f*hop;
// window: float32 [n] or null; tw: float2 [n/2]; out: float32
// [batch*frames, n/2 + 1]. n must be an even size of the TPU's n1 * n2 split
// (ops/fftbackend.ct_supported; the wrapper checks). tw_pass, radices,
// threads and frames_per_block are the wrapper's plan and its per-pass
// twiddle table: ops/rfft_mag.fwd_plan when n/2 is a power of two,
// ops/rfft_mag.mixed_plan otherwise. A plan the kernel refuses launches
// nothing and returns cudaErrorInvalidValue.
GOMEL_API int gomel_stft_mag(const void* x, const void* window, const void* tw,
                             const void* tw_pass, void* out, long long batch,
                             long long frames, long long batch_stride,
                             long long hop, long long n, long long radices,
                             int threads, int frames_per_block, int device,
                             void* stream) {
  cudaSetDevice(device);
  const int m = static_cast<int>(n / 2);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = frames_vec_aligned(x, window, batch_stride, hop);
  if (is_pow2(m) && m >= 2) {
    return with_log_m(m, [&](auto log_m) {
      constexpr int kL = decltype(log_m)::value;
      return launch_pow2_frames<kL>(
          stft_mag_pow2_kernel<kL>, batch * frames, static_cast<int>(radices),
          threads, frames_per_block, s, static_cast<const float*>(x),
          static_cast<const float*>(window), static_cast<const float2*>(tw),
          static_cast<const float2*>(tw_pass), static_cast<float*>(out),
          batch * frames, static_cast<int>(frames), batch_stride, hop, vec);
    });
  }
  MixedPlan pl;
  if (!make_mixed_plan(m, radices, threads, frames_per_block, &pl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_mixed_frames(
      stft_mag_mixed_kernel, batch * frames, pl, s, static_cast<const float*>(x),
      static_cast<const float*>(window), static_cast<const float2*>(tw),
      static_cast<const float2*>(tw_pass), static_cast<float*>(out), pl,
      batch * frames, static_cast<int>(frames), batch_stride, hop, vec);
}

namespace {

// The fused launch on Signal's frames: the band table's checks, then the
// kernel of m = n/2 (a power of two, 2 ... 8192).
template <typename Signal>
int launch_stft_mel_log(const Signal& sig, const void* window, const void* tw,
                        const void* tw_pass, const void* slots,
                        const void* weights, int groups, void* out,
                        long long cols, long long batch, long long frames,
                        long long n, int radices, int threads,
                        int frames_per_block, bool vec, void* stream) {
  const int m = static_cast<int>(n / 2);
  if (!(is_pow2(m) && m >= 2) || groups % kMelWarps != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MelTable table{static_cast<const int4*>(slots),
                       static_cast<const float*>(weights), groups,
                       static_cast<int>(cols)};
  return with_log_m(m, [&](auto log_m) {
    constexpr int kL = decltype(log_m)::value;
    return launch_pow2_frames<kL>(
        stft_mel_log_pow2_kernel<kL, Signal>, batch * frames, radices,
        threads, frames_per_block, static_cast<cudaStream_t>(stream), sig,
        static_cast<const float*>(window), static_cast<const float2*>(tw),
        static_cast<const float2*>(tw_pass), table, static_cast<float*>(out),
        batch * frames, static_cast<int>(frames), vec);
  });
}

}  // namespace

// The fused KB + KC launch, for n/2 a power of two (2 ... 8192): x, window,
// tw, tw_pass and the plan as gomel_stft_mag; slots, weights, groups: the
// band table of ops/mel_ops.mel_band_plan (groups a multiple of 4); out:
// float32 [batch*frames, cols], cols = 2M. cudaErrorInvalidValue at any
// other n (there is no fallback: the wrapper raises).
GOMEL_API int gomel_stft_mel_log(const void* x, const void* window,
                                 const void* tw, const void* tw_pass,
                                 const void* slots, const void* weights,
                                 int groups, void* out, long long cols,
                                 long long batch, long long frames,
                                 long long batch_stride, long long hop,
                                 long long n, int radices, int threads,
                                 int frames_per_block, int device,
                                 void* stream) {
  cudaSetDevice(device);
  const FloatSignal sig{static_cast<const float*>(x), batch_stride, hop};
  return launch_stft_mel_log(
      sig, window, tw, tw_pass, slots, weights, groups, out, cols, batch,
      frames, n, radices, threads, frames_per_block,
      frames_vec_aligned(x, window, batch_stride, hop), stream);
}

// The fused launch's int16 mode, KA's mono ingest folded into its frame
// loads: pcm int16 [batch, n_in] (row stride n_in), each sample divided by
// scales[row] (float32 [batch]) or, with scales null, by scale, and zero
// from n_in up to the padded length whose frame count the caller passes
// (frames). The scales must be powers of two in [2^-100, 2^100] (the
// wrapper checks a table; a scalar scale off that set launches nothing and
// returns cudaErrorInvalidValue). Every sample is KA's value, so the
// log-mel equals KA followed by gomel_stft_mel_log bit for bit. The int16
// loads are 8 bytes where every frame's first sample sits on 8 bytes (hop
// and, past one row, n_in multiples of 4, pcm on 8 bytes, the window on
// 16), else scalar; when besides every frame lies inside its row (n_in at
// least the last frame's end) the kernel is the one without a test a load.
GOMEL_API int gomel_stft_mel_log_pcm16(
    const void* pcm, float scale, const void* scales, long long n_in,
    const void* window, const void* tw, const void* tw_pass,
    const void* slots, const void* weights, int groups, void* out,
    long long cols, long long batch, long long frames, long long hop,
    long long n, int radices, int threads, int frames_per_block, int device,
    void* stream) {
  cudaSetDevice(device);
  if (scales == nullptr) {
    unsigned b;
    std::memcpy(&b, &scale, sizeof b);
    const unsigned e = (b >> 23) & 0xffu;
    if ((b & 0x807fffffu) != 0u || e < 27u || e > 227u) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const auto p = static_cast<const int16_t*>(pcm);
  const auto sc = static_cast<const float*>(scales);
  const bool vec = hop % 4 == 0 && (batch == 1 || n_in % 4 == 0) &&
                   reinterpret_cast<uintptr_t>(pcm) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(window) % 16 == 0;
  if (vec && n_in >= (frames - 1) * hop + n) {
    return launch_stft_mel_log(Pcm16Signal<true>{p, sc, scale, n_in, hop},
                               window, tw, tw_pass, slots, weights, groups,
                               out, cols, batch, frames, n, radices, threads,
                               frames_per_block, vec, stream);
  }
  return launch_stft_mel_log(Pcm16Signal<false>{p, sc, scale, n_in, hop},
                             window, tw, tw_pass, slots, weights, groups, out,
                             cols, batch, frames, n, radices, threads,
                             frames_per_block, vec, stream);
}
