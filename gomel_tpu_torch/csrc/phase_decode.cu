// KG and KH: the phase decode, from spectrum (or quantized PNG planes) to
// normalised audio (or PCM-16).
//
// KG: dequantize + grow + inverse rFFT x window, frame by frame.
//   Replaces gomel_tpu/ops/quantize.py:51 dequantize_planes and :201
//   dequantize_planes_batch (K7), gomel_tpu/ops/phase_ops.py:117
//   grow_half_planes (K8), and the irfft x window of gomel_tpu/ops/istft.py:137
//   istft_direct_planes (K9). Its source is one of:
//     kPlanes  re, im [frames, n/2 + 1] float32 (fftbackend.irfft_planes);
//     kSpec    the phase spectrogram [B, F, nf, 2] float32 (phase_decode);
//     kQuant8/kQuant16  PNG planes [B, nf, F, 2] uint8/uint16 with
//              per-channel extrema [B, 2] (the fromphase path).
//   Prologue (per bin k of the half spectrum X, k = 0..n/2): bins past nf - 1
//   repeat bin nf - 1 (grow), X[0] = 0, Re X[k] = channel 1 and
//   Im X[k] = channel 0 of bin k - 1, Im X[n/2] = 0 (phase_ops.py:122-132);
//   for planes the rescale is (v / max_val) * (max - min) + min, then
//   ihs_passes x sinhf (quantize.py:56-59). The imaginary parts of DC and
//   Nyquist are ignored, as numpy's irfft ignores them.
//   Transform: the prologue (load_spectrum) takes the bins in pairs
//   (k, n/2 - k), loads X[k] and X[n/2 - k] straight from the source and
//   writes 2 Z[k] and 2 Z[n/2 - k] (fft_core.cuh inverse_split_bin) into the
//   frame's buffer of n/2 float2 (16 KB at n = 4096); after one barrier a
//   register core's inverse runs its passes with conjugated twiddles and its
//   last pass stores frames_w [B*F, n] float32 straight from registers,
//   scaled by 1/n and multiplied by the window (__fmul_rn, in that order).
//   When n/2 is a power of two that is the power-of-two core
//   (inv_frame_pow2, the buffer swizzled), else the mixed-radix core
//   (inv_frame_mixed, the buffer in natural order, two of n/2 after a
//   generic pass; n = 3000: radices 15, 10, 10, 50 threads a frame, 3
//   frames a block).
//
// KH: overlap-add + window-sum normalisation + volume boost (+ PCM-16).
//   Replaces gomel_tpu/ops/istft.py:22 overlap_add, :41 window_sum, :189
//   normalize_by_window_sum, the boost of gomel_tpu/ops/phase_ops.py:157 and
//   gomel_tpu/ops/quantize.py:124 pcm16_encode (K9, K11). Every output
//   sample has one owner: no atomics, and the result is deterministic. It
//   sums the K = ceil(n/hop) frames covering t with k ascending (frame i - k
//   for hop-row i, istft.py:35-37), takes the window sum from a [K, hop]
//   prefix table the host builds as window_sum does (head, periodic middle,
//   tail; istft.py:51-72), normalises with the three branches of
//   istft.py:202-207 (sig / threshold in the fade), then multiplies by the
//   boost when it is non-zero, and writes float32 or, as pcm16_encode does,
//   clears the finite flag on a non-finite value, clips to [-1, 1],
//   rintf(x * 32768) (round half to even), saturates and stores int16 (NaN
//   stores 0, as the JAX program's conversion gives). Without a table it is
//   the plain overlap-add (the long-form shard's sig_ext, K10). Bound: bytes
//   (frames_w read once, the output written once). Design: the hop-row walk
//   of overlap_add.cuh, no division a sample; 4 adjacent samples a thread
//   (float4 taps and stores, 8-byte PCM-16 stores) when n and hop are
//   multiples of 4 and the pointers 16-byte aligned (the entry point's
//   choice, overlap_add.cuh ola_vector), else one.
//
// Real-frame count (K10, gomel_tpu/ops/istft.py:75 chunked_irfft_overlap_add
// with its frame mask, as the sharded decode builds it, sharded.py:487-501):
// in every mode, a frame at or past ``real_frames`` of its row writes zeros,
// as jnp.where(mask, frames_w, 0) gives; the mask of a shard is always a
// prefix of its frames, so a count carries it. A block whose frames are all
// masked stores its zeros and returns before any barrier; in a block that
// holds several frames (n < 4096, and every mixed-radix plan but one frame
// a block) and a live one, a masked frame loads nothing but keeps its slot
// through every barrier and stores zeros.
//
// Rounding: the JAX program rounds every product and sum on its own; nvcc
// would fuse a multiply feeding an add into one FMA, so those steps use
// __fmul_rn / __fadd_rn / __fdiv_rn explicitly (the global flags stay as
// they are, so KB and KC do not move). KH is then bit-exact against its
// plain version on the same frames_w; KG matches torch.fft.irfft to float32
// FFT rounding.
//
// Bound: at the phase path's 2 x 1122 frames of 4096, KG writes 36.8 MB of
// frames_w and KH reads it back (~22 us at 3.35 TB/s together). As for KB,
// what holds KG above its byte bound is instruction issue and barrier
// latency: 5 barriers at n = 4096 (the prologue's, then 2 a pass before the
// last) against the radix-2 form's 13. KG's column read of the [nf, F, 2]
// planes is strided by F (each 2-byte load takes its own 32-byte sector);
// transposing it needs another layout or several frames a block, and fusing
// KH into KG is later work. tools/profile_fft.py races KG against the
// shared-memory forms it replaced (tools/fft_earlier.cuh) and splits its
// time by ablation; PERF.md has the numbers.
#include <math.h>

#include "fft_core.cuh"
#include "overlap_add.cuh"

namespace {

constexpr int kPlanes = 0;
constexpr int kSpec = 1;
constexpr int kQuant8 = 2;
constexpr int kQuant16 = 3;

__device__ __forceinline__ float dequantize(float v, float max_val, float rng,
                                            float mn, int ihs_passes) {
  float x = __fadd_rn(__fmul_rn(__fdiv_rn(v, max_val), rng), mn);
  for (int p = 0; p < ihs_passes; ++p) x = sinhf(x);
  return x;
}

// channel pair (ch0 = imag, ch1 = real) of stored bin j of frame (bi, fi)
template <int kMode>
__device__ __forceinline__ float2 load_bin(const void* __restrict__ src,
                                           long long bi, long long fi, int j,
                                           int frames, int nf, float max_val,
                                           float4 ext, int ihs_passes) {
  if constexpr (kMode == kSpec) {
    return static_cast<const float2*>(src)[(bi * frames + fi) * nf + j];
  }
  float c0, c1;
  const long long at = (bi * nf + j) * frames + fi;
  if constexpr (kMode == kQuant8) {
    const uchar2 q = static_cast<const uchar2*>(src)[at];
    c0 = q.x;
    c1 = q.y;
  } else {
    const ushort2 q = static_cast<const ushort2*>(src)[at];
    c0 = q.x;
    c1 = q.y;
  }
  // ext = (max0, max1, min0, min1); the range is rounded to float32 first,
  // as (maxs - mins) is in the JAX program
  return make_float2(
      dequantize(c0, max_val, __fsub_rn(ext.x, ext.z), ext.z, ihs_passes),
      dequantize(c1, max_val, __fsub_rn(ext.y, ext.w), ext.w, ihs_passes));
}

// Bin k (0 <= k <= m) of frame (bi, fi)'s half spectrum X, as the prologue
// rules above give it (imaginary parts of DC and Nyquist zero).
template <int kMode>
__device__ __forceinline__ float2 half_bin(const void* __restrict__ src,
                                           const float* __restrict__ aux0,
                                           long long frame, long long bi,
                                           long long fi, int k, int m,
                                           int frames, int nf, float max_val,
                                           float4 ext, int ihs_passes) {
  float re = 0.0f;
  float im = 0.0f;
  if constexpr (kMode == kPlanes) {
    re = static_cast<const float*>(src)[frame * (m + 1) + k];
    im = aux0[frame * (m + 1) + k];
  } else {
    if (k > 0) {
      const int j = min(k - 1, nf - 1);
      const float2 v = load_bin<kMode>(src, bi, fi, j, frames, nf, max_val,
                                       ext, ihs_passes);
      re = v.y;
      im = v.x;
    }
  }
  if (k == 0 || k == m) im = 0.0f;
  return make_float2(re, im);
}

// The prologue of both forms: 2 Z[k] and 2 Z[m - k] of frame (bi, fi) from
// X[k] and X[m - k] for k = th, th + threads, ... <= m/2 (disjoint pairs),
// into z (kSwz: the power-of-two core's swizzled buffer, else natural
// order).
template <int kMode, bool kSwz>
__device__ __forceinline__ void load_spectrum(
    float2* z, const void* __restrict__ src, const float* __restrict__ aux0,
    const float* __restrict__ aux1, const float2* __restrict__ tw,
    long long frame, long long bi, long long fi, int m, int th, int threads,
    int frames, int nf, float max_val, int ihs_passes) {
  float4 ext = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (kMode == kQuant8 || kMode == kQuant16) {
    ext = make_float4(aux0[2 * bi], aux0[2 * bi + 1], aux1[2 * bi],
                      aux1[2 * bi + 1]);
  }
  for (int k = th; k <= m / 2; k += threads) {
    const float2 p = half_bin<kMode>(src, aux0, frame, bi, fi, k, m, frames,
                                     nf, max_val, ext, ihs_passes);
    const float2 q = half_bin<kMode>(src, aux0, frame, bi, fi, m - k, m,
                                     frames, nf, max_val, ext, ihs_passes);
    const float2 w = __ldg(&tw[k]);
    z[kSwz ? swz(k) : k] = inverse_split_bin(p, q, w);
    if (k > 0 && 2 * k != m) {
      z[kSwz ? swz(m - k) : m - k] =
          inverse_split_bin(q, p, make_float2(-w.x, w.y));
    }
  }
}

// Whether the block of frames first..first + per_block - 1 (of total) holds
// a frame before real_frames of its row: its first, or the first frame of a
// later row that starts inside the block. Block-uniform.
__device__ __forceinline__ bool block_live(long long first, int per_block,
                                           long long total, int frames,
                                           int real_frames) {
  const long long last = min(first + per_block, total) - 1;
  const long long row0 = first / frames;
  return first - row0 * frames < real_frames ||
         (real_frames > 0 && (row0 + 1) * frames <= last);
}

// The power-of-two form for m = 2^kLogM: FwdPlan's threads a frame and
// frames a block, m float2 of shared memory a frame.
template <int kMode, int kLogM>
__global__ void __launch_bounds__(FwdPlan<kLogM>::threads *
                                  FwdPlan<kLogM>::frames_per_block)
irfft_window_pow2_kernel(const void* __restrict__ src,
                         const float* __restrict__ aux0,
                         const float* __restrict__ aux1,
                         const float* __restrict__ window,
                         const float2* __restrict__ tw,
                         const float2* __restrict__ twp,
                         float2* __restrict__ out, long long total, int frames,
                         int real_frames, int nf, float max_val,
                         int ihs_passes, float inv_n) {
  using Plan = FwdPlan<kLogM>;
  constexpr int m = Plan::m;
  constexpr int threads = Plan::threads;
  extern __shared__ float2 sbuf[];
  const int slot = threadIdx.x / threads;
  const int th = threadIdx.x - slot * threads;
  const long long first =
      static_cast<long long>(blockIdx.x) * Plan::frames_per_block;
  const long long frame = first + slot;
  const bool valid = frame < total;
  const long long bi = frame / frames;
  const long long fi = frame - bi * frames;
  const bool masked = fi >= real_frames;
  float2* dst = valid ? out + frame * m : nullptr;
  if (!block_live(first, Plan::frames_per_block, total, frames,
                  real_frames)) {
    if (dst != nullptr) {
      for (int i = th; i < m; i += threads) dst[i] = make_float2(0.0f, 0.0f);
    }
    return;
  }
  float2* z = sbuf + slot * m;
  if (valid && !masked) {
    load_spectrum<kMode, true>(z, src, aux0, aux1, tw, frame, bi, fi, m, th,
                               threads, frames, nf, max_val, ihs_passes);
  }
  __syncthreads();
  inv_frame_pow2<kLogM>(z, twp, th, dst,
                        reinterpret_cast<const float2*>(window), inv_n,
                        masked);
}

// The mixed-radix form (n/2 not a power of two) on plan pl: pl.frames
// frames a block of pl.threads each, pl.frame_stride float2 of shared
// memory a frame. A masked frame stores its zeros first (a block with no
// live frame then returns); in a live block it keeps its slot at every
// barrier of the core, which stores nothing for it (dst null).
template <int kMode>
__global__ void __launch_bounds__(kMixedBlockThreads)
irfft_window_mixed_kernel(const void* __restrict__ src,
                          const float* __restrict__ aux0,
                          const float* __restrict__ aux1,
                          const float* __restrict__ window,
                          const float2* __restrict__ tw,
                          const float2* __restrict__ twp,
                          float2* __restrict__ out,
                          const __grid_constant__ MixedPlan pl,
                          long long total, int frames, int real_frames,
                          int nf, float max_val, int ihs_passes, float inv_n) {
  extern __shared__ float2 sbuf[];
  const int m = pl.m;
  const int threads = pl.threads;
  const int slot = threadIdx.x / threads;
  const int th = threadIdx.x - slot * threads;
  const long long first = static_cast<long long>(blockIdx.x) * pl.frames;
  const long long frame = first + slot;
  const bool valid = frame < total;
  const long long bi = frame / frames;
  const long long fi = frame - bi * frames;
  const bool masked = fi >= real_frames;
  float2* dst = valid ? out + frame * m : nullptr;
  if (masked && dst != nullptr) {
    for (int i = th; i < m; i += threads) dst[i] = make_float2(0.0f, 0.0f);
  }
  if (!block_live(first, pl.frames, total, frames, real_frames)) return;
  float2* buf = sbuf + slot * pl.frame_stride;
  if (valid && !masked) {
    load_spectrum<kMode, false>(buf, src, aux0, aux1, tw, frame, bi, fi, m,
                                th, threads, frames, nf, max_val, ihs_passes);
  }
  __syncthreads();
  inv_frame_mixed(buf, buf + m, twp, pl, th, masked ? nullptr : dst,
                  reinterpret_cast<const float2*>(window), inv_n);
}

// KH on the hop-row walk (overlap_add.cuh): a thread owns kV adjacent
// columns c of a hop-row and walks hop-rows i. Tap k reads frame i - k at
// columns k * hop + c .. + kV - 1 (kV = 4: one float4, since n and hop are
// multiples of 4 on the vector path, so a group is wholly inside or wholly
// outside col < n); the taps whose column lies in the frame, k < kc, are
// counted once a column group, and the frame bounds give each hop-row its
// range k_lo <= k < k_hi, so the middle hop-rows check nothing a tap. The
// taps are loaded 4 at a time before they are added. A tap outside the
// frames or past col < n is skipped rather than added as 0.0f: the sum
// starts at +0.0f and a rounded add never turns it into -0.0f, so adding
// +0.0f would change no bit.
template <int kV>
__global__ void __launch_bounds__(kOlaMaxThreads) overlap_normalize_kernel(
    const float* __restrict__ frames_w, const float* __restrict__ table,
    float* __restrict__ out_f, int16_t* __restrict__ out_pcm,
    int* __restrict__ finite, long long length, int frames, int n, int hop,
    int taps, int short_form, float threshold, float boost) {
  OlaThread w;
  if (!ola_thread<kV>(hop, w)) return;
  const long long b = blockIdx.y;
  const float* src = frames_w + b * frames * static_cast<long long>(n);
  const long long rows = static_cast<long long>(frames) + taps - 1;
  const long long mid_lo = short_form ? 0 : taps - 1;
  const long long mid_hi = short_form ? 0 : frames;
  const long long back = n - hop;     // from tap k's element to tap k + 1's
  const long long t_step = w.step * hop;
  const long long src_step = w.step * n;
  bool bad = false;
  for (int g = w.group; g < w.groups; g += blockDim.x) {
    const int c = g * kV;
    int kc = 0;
    while (kc < taps && kc * hop + c < n) ++kc;
    Lanes<kV> full = {};
    if (table != nullptr && mid_lo < mid_hi) {
      full = load_lanes<kV>(table + static_cast<long long>(taps - 1) * hop + c);
    }
    long long t = w.row * hop + c;
    long long at = w.row * n + c;     // tap 0: frame i, column c
    for (long long i = w.row; i < rows; i += w.step, t += t_step,
                   at += src_step) {
      if (t >= length) continue;      // the last hop-row's tail
      const int k_lo = i >= frames ? static_cast<int>(i - (frames - 1)) : 0;
      const int k_hi = i + 1 < kc ? static_cast<int>(i + 1) : kc;
      Lanes<kV> acc;
#pragma unroll
      for (int l = 0; l < kV; ++l) acc.v[l] = 0.0f;
      for (int k = k_lo; k < k_hi; k += 4) {
        Lanes<kV> v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (k + u < k_hi) v[u] = load_lanes<kV>(src + at - (k + u) * back);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (k + u < k_hi) {
#pragma unroll
            for (int l = 0; l < kV; ++l) {
              acc.v[l] = __fadd_rn(acc.v[l], v[u].v[l]);
            }
          }
        }
      }
      Lanes<kV> y = acc;
      if (table != nullptr) {
        const Lanes<kV> ws = window_sum_lanes<kV>(
            table, i, c, full, mid_lo, mid_hi, frames, taps, hop, short_form);
#pragma unroll
        for (int l = 0; l < kV; ++l) {
          y.v[l] = normalize_sample(acc.v[l], ws.v[l], threshold);
        }
      }
#pragma unroll
      for (int l = 0; l < kV; ++l) {
        if (boost != 0.0f) y.v[l] = __fmul_rn(y.v[l], boost);
        bad |= !isfinite(y.v[l]);
      }
      if (out_f != nullptr) store_lanes<kV>(out_f + b * length + t, y);
      if (out_pcm != nullptr) store_pcm16<kV>(out_pcm + b * length + t, y);
    }
  }
  if (bad) finite[b] = 0;
}

template <int kV>
int launch_overlap_normalize(const float* frames_w, const float* table,
                             float* out_f, int16_t* out_pcm, int* finite,
                             long long batch, int frames, int n, int hop,
                             int taps, int short_form, float threshold,
                             float boost, int device, cudaStream_t s) {
  const long long length = n + static_cast<long long>(frames - 1) * hop;
  const int groups = hop / kV;
  const int threads = ola_threads(groups);
  const unsigned blocks =
      ola_blocks(overlap_normalize_kernel<kV>, threads, groups,
                 static_cast<long long>(frames) + taps - 1, batch, device);
  overlap_normalize_kernel<kV><<<dim3(blocks, static_cast<unsigned>(batch)),
                                 threads, 0, s>>>(
      frames_w, table, out_f, out_pcm, finite, length, frames, n, hop, taps,
      short_form, threshold, boost);
  return gomel_status();
}

template <int kMode>
int launch_irfft_window(const void* src, const float* aux0, const float* aux1,
                        const float* window, const float2* tw,
                        const float2* twp, float2* out, long long total,
                        int frames, int real_frames, int nf, int m,
                        float max_val, int ihs_passes, long long radices,
                        int threads, int frames_per_block, cudaStream_t s) {
  const float inv_n = 1.0f / static_cast<float>(2 * m);
  if (is_pow2(m) && m >= 2) {
    return with_log_m(m, [&](auto log_m) {
      constexpr int kL = decltype(log_m)::value;
      return launch_pow2_frames<kL>(
          irfft_window_pow2_kernel<kMode, kL>, total,
          static_cast<int>(radices), threads, frames_per_block, s, src, aux0,
          aux1, window, tw, twp, out, total, frames, real_frames, nf, max_val,
          ihs_passes, inv_n);
    });
  }
  MixedPlan pl;
  if (!make_mixed_plan(m, radices, threads, frames_per_block, &pl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_mixed_frames(irfft_window_mixed_kernel<kMode>, total, pl, s,
                             src, aux0, aux1, window, tw, twp, out, pl, total,
                             frames, real_frames, nf, max_val, ihs_passes,
                             inv_n);
}

}  // namespace

// mode 0: src = re, aux0 = im, float32 [batch*frames, n/2 + 1];
// mode 1: src = spec float32 [batch, frames, nf, 2];
// mode 2/3: src = planes uint8/uint16 [batch, nf, frames, 2], aux0 = maxs,
//   aux1 = mins, float32 [batch, 2].
// window: float32 [n] or null; tw: float2 [n/2]; out: float32
// [batch*frames, n]; frames at or past real_frames (0..frames) of each row
// write zeros. n must be an even size of the TPU's n1 * n2 split
// (ops/fftbackend.ct_supported; the wrapper checks). tw_pass, radices,
// threads and frames_per_block are the wrapper's plan and its per-pass
// twiddle table (ops/rfft_mag.fwd_plan when n/2 is a power of two, else
// ops/rfft_mag.mixed_plan), which the kernel checks as KB's does: a plan it
// refuses launches nothing and returns cudaErrorInvalidValue.
GOMEL_API int gomel_irfft_window(int mode, const void* src, const void* aux0,
                                 const void* aux1, const void* window,
                                 const void* tw, const void* tw_pass,
                                 void* out, long long batch, long long frames,
                                 long long real_frames, long long nf,
                                 long long n, float max_val, int ihs_passes,
                                 long long radices, int threads,
                                 int frames_per_block, int device,
                                 void* stream) {
  cudaSetDevice(device);
  const int m = static_cast<int>(n / 2);
  const long long total = batch * frames;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a0 = static_cast<const float*>(aux0);
  const float* a1 = static_cast<const float*>(aux1);
  const float* w = static_cast<const float*>(window);
  const float2* t = static_cast<const float2*>(tw);
  const float2* tp = static_cast<const float2*>(tw_pass);
  float2* o = static_cast<float2*>(out);
  const int f = static_cast<int>(frames);
  const int r = static_cast<int>(real_frames);
  const int k = static_cast<int>(nf);
  switch (mode) {
    case kPlanes:
      return launch_irfft_window<kPlanes>(src, a0, a1, w, t, tp, o, total, f,
                                          r, k, m, max_val, ihs_passes,
                                          radices, threads, frames_per_block,
                                          s);
    case kSpec:
      return launch_irfft_window<kSpec>(src, a0, a1, w, t, tp, o, total, f, r,
                                        k, m, max_val, ihs_passes, radices,
                                        threads, frames_per_block, s);
    case kQuant8:
      return launch_irfft_window<kQuant8>(src, a0, a1, w, t, tp, o, total, f,
                                          r, k, m, max_val, ihs_passes,
                                          radices, threads, frames_per_block,
                                          s);
    case kQuant16:
      return launch_irfft_window<kQuant16>(src, a0, a1, w, t, tp, o, total, f,
                                           r, k, m, max_val, ihs_passes,
                                           radices, threads, frames_per_block,
                                           s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// frames_w: float32 [batch, frames, n]; table: float32 [ceil(n/hop), hop]
// prefix table, or null for a plain overlap-add; out_f: float32
// [batch, length] or null; out_pcm: int16 [batch, length] or null; finite:
// int32 [batch], set to 1 by the caller; row b's is cleared on any
// non-finite output of that row.
// length = n + (frames - 1) * hop. The vector path (4 samples a thread)
// when n and hop are multiples of 4 and every pointer is 16-byte aligned,
// else the scalar path. batch <= 65535.
GOMEL_API int gomel_overlap_normalize(const void* frames_w, const void* table,
                                      void* out_f, void* out_pcm, void* finite,
                                      long long batch, long long frames,
                                      long long n, long long hop,
                                      int short_form, float threshold,
                                      float boost, int device, void* stream) {
  cudaSetDevice(device);
  if (hop < 1 || n < 1 || frames < 1 || batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int taps = static_cast<int>((n + hop - 1) / hop);
  const float* src = static_cast<const float*>(frames_w);
  const float* tb = static_cast<const float*>(table);
  float* of = static_cast<float*>(out_f);
  int16_t* op = static_cast<int16_t*>(out_pcm);
  int* fin = static_cast<int*>(finite);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int f = static_cast<int>(frames), nn = static_cast<int>(n);
  const int h = static_cast<int>(hop);
  if (ola_vector({n, hop}, {src, tb, of, op})) {
    return launch_overlap_normalize<4>(src, tb, of, op, fin, batch, f, nn, h,
                                       taps, short_form, threshold, boost,
                                       device, s);
  }
  return launch_overlap_normalize<1>(src, tb, of, op, fin, batch, f, nn, h,
                                     taps, short_form, threshold, boost,
                                     device, s);
}
