// KJ and KK: one Griffin-Lim iteration, from signal to signal.
//
// KJ: the projection of each frame. Replaces the body of
//   gomel_tpu/ops/griffinlim.py:98 griffin_lim up to its overlap-add
//   (:171-195; K13): frame_signal x window -> rfft -> unit phase (angle 0 ->
//   unit 1, and 1/a times, not a division, :178-181) x the fixed magnitudes
//   -> irfft x window, into frames_w [B*F, n] float32.
//   When n/2 is a power of two the frame runs on fft_core.cuh's register
//   core, in one swizzled buffer of n/2 float2 (16 KB at n = 4096):
//   fwd_frame_pow2 reads the frame straight from the signal with the window
//   (float4 loads where the addresses allow), giving Z; then each thread
//   takes pairs of bins (k, n/2 - k) in place: split_pair gives X[k] and
//   X[n/2 - k] from one read of its two slots, project_bin the unit phase
//   times mag[k] and mag[n/2 - k] (DC and Nyquist from Z[0], their imaginary
//   parts dropped: irfft ignores them), and inverse_split_bin (KG's) forms
//   2 Z'[k] and 2 Z'[n/2 - k] (tw[n/2 - k] = -conj tw[k], from the same
//   load), written back to the same two slots. The pairs are disjoint, so
//   one barrier follows, then inv_frame_pow2: the inverse passes, the last
//   storing straight to frames_w scaled by 1/n and times the window. Other
//   sizes run the same steps on the core's mixed-radix form (fwd_frame_mixed,
//   inv_frame_mixed; the buffer unswizzled): n = 3000 three passes each way
//   (radices 15, 10, 10; 50 threads a frame, 3 frames a block), against ten
//   through two buffers in the shared-memory mixed radix it replaced.
//   Every iteration runs in exact float32
//   on the CUDA cores, as the JAX package's does off the TPU (its bf16 DFT,
//   dft_mm.py, is selected only by a TPU backend).
//   The unit phase rounds each step as the JAX program does
//   (__fmul_rn / __fadd_rn / __fsqrt_rn / __fdiv_rn), so nvcc forms no FMA
//   there; the FFT passes are fft_core.cuh's.
//
// KK: the overlap-add of frames_w, with no window-sum normalisation
//   (reference mel/mel.go:127-132; gomel_tpu/ops/griffinlim.py:196), through
//   overlap_add.cuh's one-thread-a-sample body (ola_sum). Its epilogue is
//   one of:
//   the signal t (float32); the momentum step of an interior fast-Griffin-Lim
//   iteration (:201-204), writing t and c = t + m * (t - t_prev) rounded
//   step by step in that order; or, for the final iteration of a file
//   decode, gomel_tpu/ops/quantize.py:124 pcm16_encode (K11) with a per-row
//   finite flag. Bit-exact against its plain version.
//
// Bound: at the bench shape (2 x 1122 frames of 4096) KJ reads the signal
// (~11.5 MB once, neighbouring frames in L2) and 18 MB of magnitudes and
// writes 37 MB of frames_w, and KK reads them back: ~20 us of memory
// together at 3.35 TB/s. KJ does two transforms a frame, so what holds it
// above its byte bound is what holds KB (rfft_mag.cu): instruction issue and
// the latency between barriers, 10 in all at n = 4096 (5 forward, 1 after
// the projection, 4 inverse) against the radix-2 core's 24, in a 128-thread
// block with one 16 KB buffer. Fusing KK into KJ (each frame adding into its
// neighbours' samples) needs atomics or a second pass.
// tools/profile_fft.py races it against the shared-memory forms it replaced
// (tools/fft_earlier.cuh) and splits its time by ablation; PERF.md has the
// numbers. At n = 3000 (the mixed core) the bound is 0.024 ms (80 MB moved); KJ reaches about 28% of it,
// held where KB is (rfft_mag.cu).
#include <math.h>

#include "fft_core.cuh"
#include "overlap_add.cuh"
#include "unit_phase.cuh"

namespace {

// KJ's projection of bins k and m - k (0 <= k <= m/2) of a frame, X[k] = xk
// and X[m - k] = xq (k = 0: DC and Nyquist), onto the magnitudes mg: the
// unit phase times mg[k] and mg[m - k] (DC's and Nyquist's imaginary parts
// dropped: irfft ignores them), then 2 Z'[k] into zk and 2 Z'[m - k] into
// zq (tw[m - k] = -conj tw[k] = -conj w).
__device__ __forceinline__ void project_pair(float2 xk, float2 xq, float2 w,
                                             const float* __restrict__ mg,
                                             int k, int m, float2& zk,
                                             float2& zq) {
  const float mk = mg[k], mq = mg[m - k];
  xk = project_bin(xk, mk);
  xq = project_bin(xq, mq);
  if (k == 0) {
    xk.y = 0.0f;
    xq.y = 0.0f;
  }
  zk = inverse_split_bin(xk, xq, w);
  zq = inverse_split_bin(xq, xk, make_float2(-w.x, w.y));
}

// The power-of-two form for m = 2^kLogM: FwdPlan's threads a frame and
// frames a block, m float2 of shared memory a frame.
template <int kLogM>
__global__ void __launch_bounds__(FwdPlan<kLogM>::threads *
                                  FwdPlan<kLogM>::frames_per_block)
gl_project_pow2_kernel(const float* __restrict__ sig,
                       const float* __restrict__ mag,
                       const float* __restrict__ window,
                       const float2* __restrict__ tw,
                       const float2* __restrict__ twp,
                       float2* __restrict__ out, long long total, int frames,
                       long long length, long long hop, bool vec,
                       float inv_n) {
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
  fwd_frame_pow2<kLogM>(z, valid ? sig + bi * length + fi * hop : sig, window,
                        vec, valid, twp, th);
  if (valid) {
    const float* mg = mag + frame * (m + 1);
    for (int k = th; k <= m / 2; k += threads) {
      float2 xk, xq;
      if (k == 0) {  // DC and Nyquist from Z[0]
        const float2 z0 = z[0];
        xk = make_float2(z0.x + z0.y, 0.0f);
        xq = make_float2(z0.x - z0.y, 0.0f);
      } else {
        split_pair(z, tw, k, m, xk, xq);
      }
      float2 zk, zq;
      project_pair(xk, xq, __ldg(&tw[k]), mg, k, m, zk, zq);
      z[swz(k)] = zk;
      if (k > 0 && 2 * k != m) z[swz(m - k)] = zq;
    }
  }
  __syncthreads();
  inv_frame_pow2<kLogM>(z, twp, th, valid ? out + frame * m : nullptr,
                        reinterpret_cast<const float2*>(window), inv_n, false);
}

// The mixed-radix form (n/2 not a power of two) on plan pl: the mixed
// core's forward in the frame's buffer, the projection of bins k and m - k
// in pairs (unswizzled: z[k]), a barrier, the mixed core's inverse, its
// last pass storing to out times 1/n and the window.
__global__ void __launch_bounds__(kMixedBlockThreads)
gl_project_mixed_kernel(const float* __restrict__ sig,
                        const float* __restrict__ mag,
                        const float* __restrict__ window,
                        const float2* __restrict__ tw,
                        const float2* __restrict__ twp,
                        float2* __restrict__ out,
                        const __grid_constant__ MixedPlan pl, long long total,
                        int frames, long long length, long long hop, bool vec,
                        float inv_n) {
  extern __shared__ float2 sbuf[];
  const int m = pl.m;
  const int threads = pl.threads;
  const int slot = threadIdx.x / threads;
  const int th = threadIdx.x - slot * threads;
  const long long frame = static_cast<long long>(blockIdx.x) * pl.frames + slot;
  const bool valid = frame < total;
  const long long bi = frame / frames;
  const long long fi = frame - bi * frames;
  const FrameSource in{valid ? sig + bi * length + fi * hop : sig, window, vec,
                       valid};
  float2* buf = sbuf + slot * pl.frame_stride;
  float2* z = fwd_frame_mixed(buf, in, twp, pl, th);
  if (valid) {
    const float* mg = mag + frame * (m + 1);
    for (int k = th; k <= m / 2; k += threads) {
      float2 xk, xq;
      const float2 w = __ldg(&tw[k]);
      if (k == 0) {  // DC and Nyquist from Z[0]
        const float2 z0 = z[0];
        xk = make_float2(z0.x + z0.y, 0.0f);
        xq = make_float2(z0.x - z0.y, 0.0f);
      } else {
        split_values(z[k], z[m - k], w, xk, xq);
      }
      float2 zk, zq;
      project_pair(xk, xq, w, mg, k, m, zk, zq);
      z[k] = zk;
      if (k > 0 && 2 * k != m) z[m - k] = zq;
    }
  }
  __syncthreads();
  inv_frame_mixed(z, z == buf ? buf + m : buf, twp, pl, th,
                  valid ? out + frame * m : nullptr,
                  reinterpret_cast<const float2*>(window), inv_n);
}

__global__ void gl_overlap_add_kernel(const float* __restrict__ frames_w,
                                      const float* __restrict__ t_prev,
                                      float* __restrict__ out_t,
                                      float* __restrict__ out_c,
                                      int16_t* __restrict__ out_pcm,
                                      int* __restrict__ finite,
                                      long long length, int frames, int n,
                                      int hop, int taps, float momentum) {
  const long long b = blockIdx.y;
  const float* src = frames_w + b * frames * static_cast<long long>(n);
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < length; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = t / hop;
    const int c = static_cast<int>(t - i * hop);
    const float y = ola_sum(src, i, c, frames, n, hop, taps);
    const long long at = b * length + t;
    if (out_t != nullptr) out_t[at] = y;
    if (out_c != nullptr) {
      out_c[at] = __fadd_rn(y, __fmul_rn(momentum, __fsub_rn(y, t_prev[at])));
    }
    if (out_pcm != nullptr) {
      if (!isfinite(y)) finite[b] = 0;
      out_pcm[at] = pcm16_sample(y);
    }
  }
}

}  // namespace

// sig: float32 [batch, length], length = n + (frames - 1) * hop; mag:
// float32 [batch*frames, n/2 + 1]; window: float32 [n] (8-byte aligned);
// tw: float2 [n/2]; out: float32 [batch*frames, n]. n must be an even size
// of the TPU's n1 * n2 split (ops/fftbackend.ct_supported; the wrapper
// checks). tw_pass, radices, threads and frames_per_block are the wrapper's
// plan and its per-pass twiddle table (ops/rfft_mag.fwd_plan when n/2 is a
// power of two, else ops/rfft_mag.mixed_plan), which the kernel checks as
// KB's does.
GOMEL_API int gomel_gl_project(const void* sig, const void* mag,
                               const void* window, const void* tw,
                               const void* tw_pass, void* out,
                               long long batch, long long frames,
                               long long length, long long hop, long long n,
                               long long radices, int threads,
                               int frames_per_block, int device,
                               void* stream) {
  cudaSetDevice(device);
  const int m = static_cast<int>(n / 2);
  const auto s = static_cast<cudaStream_t>(stream);
  const float inv_n = 1.0f / static_cast<float>(n);
  const bool vec = frames_vec_aligned(sig, window, length, hop);
  if (is_pow2(m) && m >= 2) {
    return with_log_m(m, [&](auto log_m) {
      constexpr int kL = decltype(log_m)::value;
      return launch_pow2_frames<kL>(
          gl_project_pow2_kernel<kL>, batch * frames,
          static_cast<int>(radices), threads, frames_per_block, s,
          static_cast<const float*>(sig), static_cast<const float*>(mag),
          static_cast<const float*>(window), static_cast<const float2*>(tw),
          static_cast<const float2*>(tw_pass), static_cast<float2*>(out),
          batch * frames, static_cast<int>(frames), length, hop, vec, inv_n);
    });
  }
  MixedPlan pl;
  if (!make_mixed_plan(m, radices, threads, frames_per_block, &pl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_mixed_frames(
      gl_project_mixed_kernel, batch * frames, pl, s, static_cast<const float*>(sig),
      static_cast<const float*>(mag), static_cast<const float*>(window),
      static_cast<const float2*>(tw), static_cast<const float2*>(tw_pass),
      static_cast<float2*>(out), pl, batch * frames, static_cast<int>(frames),
      length, hop, vec, inv_n);
}

// frames_w: float32 [batch, frames, n]; t_prev: float32 [batch, length] or
// null; out_t: float32 [batch, length] or null; out_c: float32
// [batch, length] (with t_prev) or null; out_pcm: int16 [batch, length] or
// null; finite: int32 [batch], set to 1 by the caller; row b's is cleared on
// any non-finite sample of that row when out_pcm is given.
// length = n + (frames - 1) * hop.
GOMEL_API int gomel_gl_overlap_add(const void* frames_w, const void* t_prev,
                                   void* out_t, void* out_c, void* out_pcm,
                                   void* finite, long long batch,
                                   long long frames, long long n,
                                   long long hop, float momentum, int device,
                                   void* stream) {
  cudaSetDevice(device);
  const long long length = n + (frames - 1) * hop;
  const int taps = static_cast<int>((n + hop - 1) / hop);
  const int threads = 256;
  long long bx = (length + threads - 1) / threads;
  if (bx > 65535) bx = 65535;
  gl_overlap_add_kernel<<<dim3(static_cast<unsigned>(bx),
                               static_cast<unsigned>(batch)),
                          threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames_w), static_cast<const float*>(t_prev),
      static_cast<float*>(out_t), static_cast<float*>(out_c),
      static_cast<int16_t*>(out_pcm), static_cast<int*>(finite), length,
      static_cast<int>(frames), static_cast<int>(n), static_cast<int>(hop),
      taps, momentum);
  return gomel_status();
}
