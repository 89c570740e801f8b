// The float32 FFT bodies of the frame kernels KB (rfft_mag.cu), KE
// (phase_encode.cu), KG (phase_decode.cu) and KJ (griffinlim.cu).
//
// Two register-resident cores, each kernel in the same role on both:
// KB and KE run the forward transform, KG the inverse, KJ both. Whenever
// m = n/2 is a power of two from 2 to 8192 that is the power-of-two core
// (fwd_frame_pow2, inv_frame_pow2: a kernel for each m, the plan fixed at
// compile time); at every other size the FFT kernels take
// (ops/fftbackend.ct_supported) it is the mixed-radix core after it
// (fwd_frame_mixed, inv_frame_mixed: one kernel, the plan read at run
// time). The shared-memory forms they replaced (radix-2 Stockham and a
// mixed radix over m's prime factors, one block a frame) are in
// tools/fft_earlier.cuh, which only tools/profile_fft.py builds.
//
// Both treat an n-point real transform as an m-point complex one:
//   - forward: the n real samples, read as m complex values
//     z[k] = x[2k] + i x[2k+1], give Z in natural order; the kernel's
//     epilogue forms the rfft bins
//       X[k] = (Z[k] + conj Z[m-k]) / 2 - i tw[k] (Z[k] - conj Z[m-k]) / 2
//     for 0 < k < m, k and m - k from one read (split_values), and
//     X[0] = Re Z0 + Im Z0, X[m] = Re Z0 - Im Z0;
//   - inverse (KG, KJ): the kernel's prologue forms 2 Z[k] and 2 Z[m - k]
//     from the half spectrum (inverse_split_bin), and the core's unscaled
//     inverse (conjugated roots) gives z, whose real and imaginary parts are
//     the even and odd output samples, times 1/n.
// Twiddles come from tables the host computes in float64 and rounds to
// float32 (tw[j] = exp(-2 pi i j / n), j < n/2, and each core's per-pass
// table; ops/rfft_mag.py), never from sincosf.
//
// All arithmetic is float32 on the CUDA cores: no tensor cores, no TF32.
#pragma once

#include <utility>

#include "common.cuh"

inline bool is_pow2(int m) { return (m & (m - 1)) == 0; }

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

// ---------------------------------------------------------------------------
// The register-resident forward core: KB and KE at every power-of-two m.
//
// What bounds a frame FFT on Hopper is neither the float32 rate nor device
// memory but shared-memory traffic and the latency of each step between
// block-wide barriers: the radix-2 core it replaced (tools/fft_earlier.cuh)
// moved every point through shared memory log2 m times, one barrier each.
// Here each thread holds kRegPoints = 16 complex points in registers and
// does whole radix-R sub-transforms (R = 2..16) there, so m = 2048 =
// 8 x 16 x 16 takes 3 passes and 2 exchanges through shared memory.
//   - Plan (FwdPlan, a kernel for each m; the wrapper passes the same plan,
//     ops/rfft_mag.fwd_plan, and launch_pow2_frames checks that it does):
//     T = m/16 threads a frame (1 below m = 16), 128/T frames
//     a block while T < 128; radix 8, then 16s, then what is left (m <= 8:
//     one pass of radix m). `radices` packs log2 of each radix, 4 bits a
//     pass, the first pass in the low bits.
//   - The first pass reads the frame straight from the signal into
//     registers. A thread takes butterflies 2 th and 2 th + 1, so each load
//     is one 16-byte float4 (two complex points) of signal and one of window
//     when the frame's address allows it (vec), else four scalar loads of
//     the same values; the window multiplies in registers. The fused
//     KB + KC's int16 mode reads the PCM instead (Pcm16Samples: an 8-byte
//     load of 4 int16 made into KA's values by a LOP3 and an FMA each,
//     zeros past the row).
//   - A Stockham pass (ns = product of the earlier radices, radix R):
//     butterfly j takes a[j + t m/R] (t < R) times exp(-2 pi i t k / (ns R)),
//     k = j mod ns, and writes its R-point DFT to a[(j - k) R + k + s ns].
//     Its twiddles come from a per-pass table the host computes in float64
//     and rounds to float32, t-major so a warp's loads coalesce (never from
//     sincosf); they are loaded before the pass's shared-memory reads, so
//     their latency hides behind the reads and the barrier. Inside a thread
//     the DFT is radix-2 decimation in frequency with the 16th roots as
//     exact constants.
//   - One shared buffer a frame: m float2 (16 KB at n = 4096), point i at
//     swz(i), an XOR swizzle under which every pass's 8-byte accesses hit 16
//     distinct bank pairs in each half-warp for m >= 512. A pass reads its
//     points, meets a barrier, computes, then writes in place and meets a
//     second barrier.
//   - The last pass leaves Z in natural order for the kernel's epilogue,
//     which takes the bins in pairs (split_pair: k and m - k from one read
//     of Z[k], Z[m - k] and tw[k]).
// A frame's result depends only on its samples, the window and m: not on the
// load route, the frame's slot in its block or the grid. kInverse conjugates
// every root (an unscaled inverse transform), for the inverse kernels.

constexpr int kRegPoints = 16;     // complex points a thread holds
constexpr int kBlockThreads = 128;  // a block's threads while a frame takes fewer

__host__ __device__ constexpr int log2_of(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}

// The plan for m = 2^kLogM, as ops/rfft_mag.fwd_plan computes it.
template <int kLogM>
struct FwdPlan {
  static constexpr int m = 1 << kLogM;
  static constexpr int points = m < kRegPoints ? m : kRegPoints;
  static constexpr int threads = m / points;  // a frame
  static constexpr int frames_per_block =
      threads < kBlockThreads ? kBlockThreads / threads : 1;
  // log2 of pass p's radix, 0 past the last pass
  __host__ __device__ static constexpr int pass_log(int p) {
    if (m < kRegPoints) return p == 0 ? kLogM : 0;
    constexpr int lp = log2_of(kRegPoints);
    const int q = kLogM - (lp - 1);
    if (p == 0) return lp - 1;
    if (p <= q / lp) return lp;
    return p == q / lp + 1 ? q % lp : 0;
  }
  // the number of passes (at most 4)
  __host__ __device__ static constexpr int num_passes() {
    int p = 0;
    while (p < 4 && pass_log(p) > 0) ++p;
    return p;
  }
  // the kernels' `radices` argument: pass_log of each pass, 4 bits a pass
  __host__ __device__ static constexpr int code() {
    int c = 0;
    for (int p = 0; p < 4; ++p) c |= pass_log(p) << (4 * p);
    return c;
  }
};

// The float2 slot of complex point i in a frame's buffer. swz is linear over
// XOR, so for a point a + c whose compile-time part c shares no bit with a,
// slot(a + c) = swz(a) ^ swz(c) (at, below).
__host__ __device__ constexpr int swz(int i) { return i ^ ((i >> 4) & 15); }

// The buffer entry of point a + c, given sa = swz(a), for a c with no bit in
// common with a: swz(a) ^ swz(c). With c known at compile time (an unrolled
// loop's index) its bits above 3 become an immediate offset of the access
// and the rest a low-bit XOR.
__device__ __forceinline__ float2& at(float2* z, int sa, int c) {
  const int sc = swz(c);
  return z[(sa ^ (sc & 15)) + (sc & ~15)];
}

// cos and sin of 2 pi e / 16 for 0 < e < 8, e != 4 (the roots a radix-16
// decimation-in-frequency DFT multiplies by), as float literals.
__device__ __forceinline__ float cos16(int e) {
  switch (e) {
    case 1: return 0.923879532511286756f;
    case 2: return 0.707106781186547524f;
    case 3: return 0.382683432365089772f;
    case 5: return -0.382683432365089772f;
    case 6: return -0.707106781186547524f;
    default: return -0.923879532511286756f;  // e = 7
  }
}

__device__ __forceinline__ float sin16(int e) {
  switch (e) {
    case 1: case 7: return 0.382683432365089772f;
    case 2: case 6: return 0.707106781186547524f;
    default: return 0.923879532511286756f;  // e = 3, 5
  }
}

// z * exp(-2 pi i e / 16) (kInverse: exp(+2 pi i e / 16)), 0 <= e < 8.
template <bool kInverse>
__device__ __forceinline__ float2 rot16(float2 z, int e) {
  if (e == 0) return z;
  if (e == 4) return kInverse ? make_float2(-z.y, z.x) : make_float2(z.y, -z.x);
  const float c = cos16(e);
  const float s = kInverse ? sin16(e) : -sin16(e);
  return make_float2(z.x * c - z.y * s, z.x * s + z.y * c);
}

// One radix-2 decimation-in-frequency stage over blocks of 2 kHalf, then
// the stages below it.
template <int R, int kHalf, bool kInverse>
__device__ __forceinline__ void dif_stages(float2* v) {
#pragma unroll
  for (int g = 0; g < R; g += 2 * kHalf) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float2 a = v[g + i];
      const float2 b = v[g + i + kHalf];
      v[g + i] = make_float2(a.x + b.x, a.y + b.y);
      v[g + i + kHalf] = rot16<kInverse>(make_float2(a.x - b.x, a.y - b.y),
                                         i * (8 / kHalf));
    }
  }
  if constexpr (kHalf > 1) dif_stages<R, kHalf / 2, kInverse>(v);
}

// R-point DFT of v[0..R) in registers, radix-2 decimation in frequency:
// X[s] ends in v[bitrev<R>(s)].
template <int R, bool kInverse>
__device__ __forceinline__ void dft_regs(float2* v) {
  dif_stages<R, R / 2, kInverse>(v);
}

template <int R>
__host__ __device__ constexpr int bitrev(int s) {
  int r = 0;
  for (int b = 1; b < R; b <<= 1) {
    r = (r << 1) | (s & 1);
    s >>= 1;
  }
  return r;
}

// Write a butterfly's DFT (v as dft_regs leaves it) to points a + s kNs,
// sa = swz(a).
template <int R, int kNs>
__device__ __forceinline__ void store_dft(float2* z, const float2* v, int sa) {
#pragma unroll
  for (int s = 0; s < R; ++s) at(z, sa, s * kNs) = v[bitrev<R>(s)];
}

// A frame of the float32 signal (KB, KE, KJ, the float fused launch).
struct FloatSamples {
  const float* src;
};

// The same samples formed from int16 PCM (the fused KB + KC's int16 mode):
// sample i is src[i] / s for the row's power-of-two scale s, KA's value (a
// LOP3 and one exact FMA: common.cuh pcm_biased), and 0 at i >= avail (the
// padding past the row's samples). kWhole (the launch's frames all inside
// their rows, vec holding): one 8-byte load of 4, no test. Else the same
// load where vec holds and all four lie inside the row, scalar loads of the
// same samples otherwise.
template <bool kWhole>
struct Pcm16Samples {
  const int16_t* src;
  long long avail;  // the row's samples from the frame's first one
  float inv, bias;  // 1 / s and -kPcmBias / s (pcm_scale)
  __device__ __forceinline__ float value(unsigned h) const {
    return __fmaf_rn(pcm_biased(h), inv, bias);
  }
  __device__ __forceinline__ float4 load4(int off, bool vec) const {
    if (kWhole || (vec && off + 4 <= avail)) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(src + off));
      return make_float4(value(q.x), value(q.x >> 16), value(q.y),
                         value(q.y >> 16));
    }
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = off + j < avail
                 ? value(static_cast<uint16_t>(__ldg(src + off + j)))
                 : 0.0f;
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

// Samples off..off+3 of a frame times the window (if any): two complex
// points. The vector and scalar routes load the same values. The float32
// form keeps its loads behind one restrict pointer as one body: written as
// the int16 form's template it compiled to more instructions, and KB and
// KE ran 2-6% slower (chip_smoke.py phase 4).
__device__ __forceinline__ float4 load_pair(const FloatSamples& s,
                                            const float* __restrict__ window,
                                            int off, bool vec) {
  const float* __restrict__ src = s.src;
  float4 x, w;
  if (vec) {
    x = __ldg(reinterpret_cast<const float4*>(src + off));
  } else {
    x = make_float4(__ldg(src + off), __ldg(src + off + 1),
                    __ldg(src + off + 2), __ldg(src + off + 3));
  }
  if (window == nullptr) return x;
  if (vec) {
    w = __ldg(reinterpret_cast<const float4*>(window + off));
  } else {
    w = make_float4(__ldg(window + off), __ldg(window + off + 1),
                    __ldg(window + off + 2), __ldg(window + off + 3));
  }
  return make_float4(x.x * w.x, x.y * w.y, x.z * w.z, x.w * w.w);
}

template <bool kWhole>
__device__ __forceinline__ float4 load_pair(const Pcm16Samples<kWhole>& s,
                                            const float* __restrict__ window,
                                            int off, bool vec) {
  const float4 x = s.load4(off, vec);
  if (window == nullptr) return x;
  const float4 w =
      vec ? __ldg(reinterpret_cast<const float4*>(window + off))
          : make_float4(__ldg(window + off), __ldg(window + off + 1),
                        __ldg(window + off + 2), __ldg(window + off + 3));
  return make_float4(x.x * w.x, x.y * w.y, x.z * w.z, x.w * w.w);
}

// The first pass (ns = 1, no twiddles), from the signal: B = 2 butterflies
// 2 th and 2 th + 1, whose point t is the float4 at z[2 th + t m/R]; or
// B = 1 (the only pass, R = m), whose points 2c and 2c + 1 are the float4 at
// z[2c]. A slot past the last frame (valid false) loads nothing.
template <int R, int B, int M, bool kInverse, typename S>
__device__ __forceinline__ void first_pass(float2* z, const S& src,
                                           const float* __restrict__ window,
                                           bool vec, bool valid, int th) {
  float2 v[R * B];
#pragma unroll
  for (int c = 0; c < R * B / 2; ++c) {
    const int off = B == 2 ? 4 * th + 2 * c * (M / R) : 4 * c;
    const float4 q = valid ? load_pair(src, window, off, vec)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (B == 2) {
      v[c] = make_float2(q.x, q.y);
      v[R + c] = make_float2(q.z, q.w);
    } else {
      v[2 * c] = make_float2(q.x, q.y);
      v[2 * c + 1] = make_float2(q.z, q.w);
    }
  }
#pragma unroll
  for (int u = 0; u < B; ++u) {
    dft_regs<R, kInverse>(&v[u * R]);
    store_dft<R, 1>(z, &v[u * R], swz((B * th + u) * R));
  }
  __syncthreads();
}

// A later pass of radix R after passes of product kNs, for m = M with T
// threads a frame: butterflies th + u T, u < 16/R. twp: this pass's table,
// twp[(t - 1) kNs + k] = exp(-2 pi i t k / (kNs R)).
template <int R, int M, int kNs, int T, bool kInverse>
__device__ __forceinline__ void reg_pass(float2* z,
                                         const float2* __restrict__ twp,
                                         int th) {
  constexpr int B = kRegPoints / R;
  constexpr int kStride = M / R;
  float2 w[B][R];  // w[u][0] unused
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const int k = (th + u * T) & (kNs - 1);
#pragma unroll
    for (int t = 1; t < R; ++t) {
      w[u][t] = __ldg(&twp[(t - 1) * kNs + k]);
      if (kInverse) w[u][t].y = -w[u][t].y;
    }
  }
  float2 v[kRegPoints];
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const int sj = swz(th + u * T);  // j < kStride: no bit of t kStride
#pragma unroll
    for (int t = 0; t < R; ++t) v[u * R + t] = at(z, sj, t * kStride);
  }
  __syncthreads();  // every point read before any is overwritten
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const int j = th + u * T;
    const int k = j & (kNs - 1);
#pragma unroll
    for (int t = 1; t < R; ++t) {
      const float2 a = v[u * R + t];
      const float2 c = w[u][t];
      v[u * R + t] = make_float2(a.x * c.x - a.y * c.y, a.x * c.y + a.y * c.x);
    }
    dft_regs<R, kInverse>(&v[u * R]);
    // (j - k) R + k has no bit in s kNs's range
    store_dft<R, kNs>(z, &v[u * R], swz((j - k) * R + k));
  }
  __syncthreads();
}

// Passes kPass, kPass + 1, ... of m = 2^kLogM, after passes of product kNs.
template <int kLogM, int kPass, int kNs, bool kInverse>
__device__ __forceinline__ void later_passes(float2* z,
                                             const float2* __restrict__ twp,
                                             int th) {
  using Plan = FwdPlan<kLogM>;
  constexpr int r = Plan::pass_log(kPass);
  if constexpr (kPass < 4 && r > 0) {
    reg_pass<1 << r, Plan::m, kNs, Plan::threads, kInverse>(z, twp, th);
    later_passes<kLogM, kPass + 1, (kNs << r), kInverse>(
        z, twp + ((1 << r) - 1) * kNs, th);
  }
}

// The forward transform of one frame (thread th of its T) into z, Z in
// natural order, its samples from S (FloatSamples, Pcm16Samples). Every
// thread of the block calls it: it holds the barriers.
template <int kLogM, typename S>
__device__ __forceinline__ void fwd_frame_pow2_samples(
    float2* z, const S& src, const float* __restrict__ window, bool vec,
    bool valid, const float2* __restrict__ twp, int th) {
  using Plan = FwdPlan<kLogM>;
  constexpr int r0 = 1 << Plan::pass_log(0);
  first_pass<r0, (Plan::m >= kRegPoints ? 2 : 1), Plan::m, false>(
      z, src, window, vec, valid, th);
  later_passes<kLogM, 1, r0, false>(z, twp, th);
}

// The same from the float32 signal at src.
template <int kLogM>
__device__ __forceinline__ void fwd_frame_pow2(
    float2* z, const float* __restrict__ src, const float* __restrict__ window,
    bool vec, bool valid, const float2* __restrict__ twp, int th) {
  fwd_frame_pow2_samples<kLogM>(z, FloatSamples{src}, window, vec, valid, twp,
                                th);
}

// rfft bins k and m - k (0 < k <= m/2) from Z in a frame's buffer: one read
// of Z[k], Z[m-k] and tw[k] serves both, since tw[m-k] = -conj tw[k]. With
// E = (Z[k] + conj Z[m-k]) / 2 and O = -i (Z[k] - conj Z[m-k]) / 2,
// X[k] = E + tw[k] O and X[m-k] = conj(E - tw[k] O).
__device__ __forceinline__ void split_values(float2 p, float2 q, float2 w,
                                             float2& xk, float2& xmk) {
  const float er = 0.5f * (p.x + q.x);
  const float ei = 0.5f * (p.y - q.y);
  const float orr = 0.5f * (p.y + q.y);
  const float oi = -0.5f * (p.x - q.x);
  const float a = orr * w.x - oi * w.y;
  const float b = orr * w.y + oi * w.x;
  xk = make_float2(er + a, ei + b);
  xmk = make_float2(er - a, b - ei);
}

// The same from a swizzled buffer (the power-of-two core's).
__device__ __forceinline__ void split_pair(const float2* z,
                                           const float2* __restrict__ tw,
                                           int k, int m, float2& xk,
                                           float2& xmk) {
  split_values(z[swz(k)], z[swz(m - k)], __ldg(&tw[k]), xk, xmk);
}

// ---------------------------------------------------------------------------
// The register-resident inverse core: KG and KJ at every power-of-two m.
//
// The same plan (FwdPlan), passes and per-pass twiddle table as the forward
// core, with every root conjugated (kInverse): an unscaled inverse transform
// of Z in natural order in the frame's swizzled buffer. The kernel's
// prologue puts Z there (2 Z[k] and 2 Z[m - k] from the bins k and m - k,
// inverse_split_bin; the factor 2 is folded into the 1/n scale) and meets a
// barrier; then
//   - the first pass (ns = 1) reads the buffer, not the signal, and has no
//     twiddles (and no table row);
//   - each pass takes butterflies j = th + u T (u < points / R), reads
//     a[j + t m/R], and does the R-point DFT in registers;
//   - a pass before the last writes a[(j - k) R + k + s ns] in place between
//     two barriers, as the forward passes do;
//   - the last pass has ns = m/R, so k = j and its outputs are the points
//     j + s m/R: it stores them straight from registers to device memory,
//     consecutive threads on consecutive float2 (coalesced), with no barrier
//     and no shared read after it. Point i holds output samples 2i and
//     2i + 1; each is scaled by 1/n, then multiplied by its window sample
//     (__fmul_rn, in that order; no window: no multiply).
// At n = 4096: 3 passes and 4 barriers after the prologue's, against the
// radix-2 core's 11 passes through two buffers.

// One pass of the inverse core: radix R after passes of product kNs
// (kNs = 1: the first pass), m = M, T threads a frame. kLast: the last pass
// (kNs = M/R), which stores to dst (null: nothing; zero: zeros) as above.
template <int R, int M, int kNs, int T, bool kLast>
__device__ __forceinline__ void inv_pass(float2* z,
                                         const float2* __restrict__ twp,
                                         int th, float2* __restrict__ dst,
                                         const float2* __restrict__ w2,
                                         float inv_n, bool zero) {
  constexpr int kPoints = M < kRegPoints ? M : kRegPoints;
  constexpr int B = kPoints / R;
  constexpr int kStride = M / R;
  static_assert(!kLast || kNs == kStride, "the last pass has ns = m/R");
  float2 w[B][R];  // w[u][0] unused
  if constexpr (kNs > 1) {
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int k = (th + u * T) & (kNs - 1);
#pragma unroll
      for (int t = 1; t < R; ++t) {
        w[u][t] = __ldg(&twp[(t - 1) * kNs + k]);
        w[u][t].y = -w[u][t].y;
      }
    }
  }
  float2 v[kPoints];
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const int sj = swz(th + u * T);  // j < kStride: no bit of t kStride
#pragma unroll
    for (int t = 0; t < R; ++t) v[u * R + t] = at(z, sj, t * kStride);
  }
  if constexpr (!kLast) __syncthreads();  // every point read before a write
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const int j = th + u * T;
    const int k = j & (kNs - 1);
    if constexpr (kNs > 1) {
#pragma unroll
      for (int t = 1; t < R; ++t) {
        const float2 a = v[u * R + t];
        const float2 c = w[u][t];
        v[u * R + t] =
            make_float2(a.x * c.x - a.y * c.y, a.x * c.y + a.y * c.x);
      }
    }
    dft_regs<R, true>(&v[u * R]);
    if constexpr (kLast) {
      if (dst != nullptr) {
#pragma unroll
        for (int s = 0; s < R; ++s) {
          const int i = j + s * kNs;
          const float2 y = v[u * R + bitrev<R>(s)];
          float x0 = __fmul_rn(y.x, inv_n);
          float x1 = __fmul_rn(y.y, inv_n);
          if (w2 != nullptr) {
            const float2 wi = __ldg(&w2[i]);
            x0 = __fmul_rn(x0, wi.x);
            x1 = __fmul_rn(x1, wi.y);
          }
          dst[i] = zero ? make_float2(0.0f, 0.0f) : make_float2(x0, x1);
        }
      }
    } else {
      // (j - k) R + k has no bit in s kNs's range
      store_dft<R, kNs>(z, &v[u * R], swz((j - k) * R + k));
    }
  }
  if constexpr (!kLast) __syncthreads();
}

// Passes kPass, kPass + 1, ... of the inverse of m = 2^kLogM, after passes
// of product kNs; twp points at pass kPass's table (pass 0 has none).
template <int kLogM, int kPass, int kNs>
__device__ __forceinline__ void inv_passes(float2* z,
                                           const float2* __restrict__ twp,
                                           int th, float2* __restrict__ dst,
                                           const float2* __restrict__ w2,
                                           float inv_n, bool zero) {
  using Plan = FwdPlan<kLogM>;
  constexpr int r = Plan::pass_log(kPass);
  constexpr bool kLast = kPass == Plan::num_passes() - 1;
  inv_pass<1 << r, Plan::m, kNs, Plan::threads, kLast>(z, twp, th, dst, w2,
                                                       inv_n, zero);
  if constexpr (!kLast) {
    inv_passes<kLogM, kPass + 1, (kNs << r)>(
        z, kPass == 0 ? twp : twp + ((1 << r) - 1) * kNs, th, dst, w2, inv_n,
        zero);
  }
}

// The inverse transform of one frame (thread th of its T) from Z in natural
// order in z (the kernel's prologue, then a barrier): point i of the result,
// times 1/n and the window pair w2[i] (null: no window), into dst[i]; zeros
// when zero; nothing when dst is null. Every thread of the block calls it:
// it holds the barriers.
template <int kLogM>
__device__ __forceinline__ void inv_frame_pow2(
    float2* z, const float2* __restrict__ twp, int th, float2* __restrict__ dst,
    const float2* __restrict__ w2, float inv_n, bool zero) {
  inv_passes<kLogM, 0, 1>(z, twp, th, dst, w2, inv_n, zero);
}

// ---------------------------------------------------------------------------
// The mixed-radix register core: KB, KE, KG and KJ whenever m = n/2 is not a
// power of two (n = 3000 and every other size ops/fftbackend.ct_supported
// takes).
//
// The shared-memory mixed radix it replaced (tools/fft_earlier.cuh) spent,
// per point and pass, a dense r x r product with roots loaded from the
// table, a runtime `%` and a strided twiddle load, ping-ponged between two
// buffers, and left 40-85% of its 256-thread block idle in each pass's
// second round (m = 1500: five passes of 300-500 butterflies). This core
// runs in-place Cooley-Tukey on one shared buffer of m float2 a frame, a
// butterfly's R points in registers, on a plan the host computes
// (ops/rfft_mag.mixed_plan) and the kernel reads at run time (MixedPlan, by
// value; make_mixed_plan checks it and derives the rest):
//   - Each of a frame's T threads does P/R butterflies of every register
//     pass (P = m/T points; each register radix R divides P): no thread
//     idles. m = 1500 is 15 x 10 x 10 with P = 30, T = 50: three passes,
//     one barrier each.
//   - The butterflies are known at compile time (dft_mixed): radix 2, 4, 8
//     and 16 the power-of-two core's (no multiply beyond +-i and the 16th
//     roots), 3, 5 and 7 the symmetric forms with their roots as float32
//     literals (2 x 2 and 3 x 3 real products a component for 5 and 7
//     instead of 25 and 49 complex ones), the composites (6, 10, 12, 14, 15)
//     as prime-factor nests of those, whose index maps need no twiddle.
//     Nothing above 16: the kernel's registers are those of its largest
//     butterfly, and radix 20, 24 and 30 (which dft_mixed also builds) take
//     them from 64 to 128 and cost 20-35% of the time, the pass they save
//     included (tools/profile_fft.py).
//   - Forward: decimation in time, in place. Pass p (radix R, ns the
//     product of the earlier radices) takes butterfly b = g ns + k at
//     points g ns R + k + t ns, multiplies point t by exp(-2 pi i t k /
//     (ns R)) from its table row, (t - 1) ns + k, read contiguously, and
//     writes its R-point DFT back to the same points: butterflies are
//     disjoint, so a pass needs no barrier between its reads and writes.
//     The first pass reads butterfly j's samples j + t m/R_0 straight from
//     the signal (consecutive threads, consecutive points; 8-byte loads
//     where frames_vec_aligned holds, else scalar ones of the same values)
//     and writes them at rev(j) R_0 + s: the digit reversal DIT needs costs
//     nothing but the store's address. Z ends in natural order.
//   - Inverse (KG, KJ): decimation in frequency, the forward's steps undone in
//     reverse order with conjugated roots (an unscaled inverse); its last
//     pass reads rev(j) R_0 + s and stores the frame's points
//     j + t m/R_0 to device memory, times 1/n and the window.
//   - j / ns and the digits of rev(j) are multiplies by the host's magic
//     numbers (exact for j, ns < 2^14): no `/` or `%` by a runtime value.
//   - A factor of m no register radix takes (a prime from 11 to 127, or a
//     small one that does not divide P) runs a generic pass: a thread an
//     output, the sum over the R inputs with roots from the pass's table of
//     ns R roots. Outputs overwrite inputs other threads still read, so a
//     generic pass after the first writes to a second buffer of m (the
//     plan's frame stride is then 2m); the first reads the signal, the
//     inverse's last writes the frame. n = 254 (m = 127) and n = 4094
//     (23 x 89) run only such passes.
//   - Frames a block: the plan's, up to 256 threads, as many as keep the
//     most threads resident (m = 1500: 3; m = 200: 12), so small sizes
//     share a block.
// A frame's result depends only on its samples, the window and the plan:
// not on the load route, its slot in the block or the grid.

constexpr int kMixedMaxPasses = 8;
constexpr int kMixedBlockThreads = 256;
constexpr int kMixedMaxPoints = 64;

#define GOMEL_MIXED_RADICES(X) \
  X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(10) X(12) X(14) X(15) X(16)

inline bool mixed_register_radix(int r) {
  switch (r) {
#define GOMEL_MIXED_CASE(R) case R:
    GOMEL_MIXED_RADICES(GOMEL_MIXED_CASE)
#undef GOMEL_MIXED_CASE
    return true;
    default:
      return false;
  }
}

// A frame's transform as the kernels read it: ops/rfft_mag.mixed_plan's
// radices, points, threads and frames a block, and what make_mixed_plan
// derives from them.
struct MixedPlan {
  int m;             // complex points a frame, n/2
  int passes;
  int points;        // a thread, P = m / threads
  int threads;       // a frame
  int frames;        // a block
  int frame_stride;  // float2 of shared memory a frame: m, or 2m (generic)
  int radix[kMixedMaxPasses];
  int ns[kMixedMaxPasses];     // the product of the earlier radices
  int table[kMixedMaxPasses];  // the pass's offset in tw_pass
  bool reg[kMixedMaxPasses];   // a register pass, else a generic one
  unsigned long long magic_r[kMixedMaxPasses];     // ceil(2^32 / radix)
  unsigned long long magic_ns[kMixedMaxPasses];    // ceil(2^32 / ns)
  unsigned long long magic_span[kMixedMaxPasses];  // ceil(2^32 / (ns radix))
  unsigned long long magic_stride0;                // ceil(2^32 / (m / radix[0]))
};

// x / d for 0 <= x < 2^14 and 1 <= d < 2^14, from magic = ceil(2^32 / d):
// x magic / 2^32 exceeds x / d by less than x / 2^32 < 1 / d.
__host__ __device__ __forceinline__ int div_magic(int x,
                                                  unsigned long long magic) {
  return static_cast<int>((static_cast<unsigned long long>(x) * magic) >> 32);
}

inline unsigned long long magic_of(int d) {
  return ((1ull << 32) + d - 1) / d;
}

// The plan of m from the wrapper's radices (8 bits a pass, the first in the
// low bits), threads a frame and frames a block; false (the launch refuses
// it) unless the radices multiply to m, there are at most kMixedMaxPasses,
// points = m / threads is a whole number up to kMixedMaxPoints, every
// register radix divides it, and the block has at most kMixedBlockThreads
// threads and fits shared memory. A pass is a register pass when its radix
// is one of GOMEL_MIXED_RADICES and divides points; its table row then holds
// (radix - 1) ns twiddles (none in the first pass), else the ns radix roots
// (ops/rfft_mag._mixed_twiddles_np lays them out the same way).
inline bool make_mixed_plan(int m, long long radices, int threads, int frames,
                            MixedPlan* pl) {
  if (m < 2 || m >= (1 << 14) || threads < 1 || frames < 1 ||
      m % threads != 0 || threads * frames > kMixedBlockThreads) {
    return false;
  }
  pl->m = m;
  pl->threads = threads;
  pl->frames = frames;
  pl->points = m / threads;
  pl->frame_stride = m;
  if (pl->points > kMixedMaxPoints) return false;
  int ns = 1, table = 0, p = 0;
  for (; p < kMixedMaxPasses; ++p) {
    const int r = static_cast<int>((radices >> (8 * p)) & 255);
    if (r == 0) break;
    if (r < 2 || (m / ns) % r != 0) return false;
    const bool reg = mixed_register_radix(r) && pl->points % r == 0;
    pl->radix[p] = r;
    pl->ns[p] = ns;
    pl->table[p] = table;
    pl->reg[p] = reg;
    pl->magic_r[p] = magic_of(r);
    pl->magic_ns[p] = magic_of(ns);
    pl->magic_span[p] = magic_of(ns * r);
    if (!reg && p > 0) pl->frame_stride = 2 * m;
    table += reg ? (p == 0 ? 0 : (r - 1) * ns) : ns * r;
    ns *= r;
  }
  if (p == 0 || ns != m ||
      (p < kMixedMaxPasses && (radices >> (8 * p)) != 0) ||
      static_cast<size_t>(frames) * pl->frame_stride * sizeof(float2) >
          232448) {
    return false;
  }
  pl->passes = p;
  pl->magic_stride0 = magic_of(m / pl->radix[0]);
  return true;
}

// cos and sin of 2 pi r / R for R = 3, 5, 7 and 0 < r <= (R - 1) / 2: the
// float32 roundings of the float64 values, as the host's tables round them.
__device__ __forceinline__ float cos_prime(int R, int r) {
  switch (R * 4 + r) {
    case 13: return -0.5f;         // R 3, r 1
    case 21: return 0.309017f;     // R 5, r 1
    case 22: return -0.809017f;    // R 5, r 2
    case 29: return 0.6234898f;    // R 7, r 1
    case 30: return -0.22252093f;  // R 7, r 2
    default: return -0.90096885f;  // R 7, r 3
  }
}

__device__ __forceinline__ float sin_prime(int R, int r) {
  switch (R * 4 + r) {
    case 13: return 0.8660254f;
    case 21: return 0.95105654f;
    case 22: return 0.58778524f;
    case 29: return 0.7818315f;
    case 30: return 0.9749279f;
    default: return 0.43388373f;
  }
}

// R-point DFT of v[0..R) in registers for an odd prime R (3, 5, 7), in
// natural order: with a_j = v_j + v_{R-j}, b_j = v_j - v_{R-j},
// X[s] = v_0 + sum_j cos(2 pi j s / R) a_j - i sum_j sin(2 pi j s / R) b_j
// and X[R-s] the same with + i (kInverse: the two swapped).
template <int R, bool kInverse>
__device__ __forceinline__ void dft_prime(float2* v) {
  constexpr int H = (R - 1) / 2;
  float2 a[H], b[H];
  const float2 x0 = v[0];
  float2 sum = x0;
#pragma unroll
  for (int j = 1; j <= H; ++j) {
    a[j - 1] = make_float2(v[j].x + v[R - j].x, v[j].y + v[R - j].y);
    b[j - 1] = make_float2(v[j].x - v[R - j].x, v[j].y - v[R - j].y);
    sum = make_float2(sum.x + a[j - 1].x, sum.y + a[j - 1].y);
  }
  v[0] = sum;
#pragma unroll
  for (int s = 1; s <= H; ++s) {
    float2 re = x0;
    float2 im = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      const int r = (j * s) % R;  // cos(2 pi r / R) = cos(2 pi (R - r) / R)
      const int e = r <= H ? r : R - r;
      const float c = cos_prime(R, e);
      const float sn = r <= H ? sin_prime(R, e) : -sin_prime(R, e);
      re = make_float2(re.x + c * a[j - 1].x, re.y + c * a[j - 1].y);
      im = make_float2(im.x + sn * b[j - 1].x, im.y + sn * b[j - 1].y);
    }
    const float2 lo = make_float2(re.x + im.y, re.y - im.x);  // re - i im
    const float2 hi = make_float2(re.x - im.y, re.y + im.x);  // re + i im
    v[s] = kInverse ? hi : lo;
    v[R - s] = kInverse ? lo : hi;
  }
}

// The first factor A of a register radix R = A B in the prime-factor nest:
// its power of two, else 3, else 5 (B = R / A is coprime to A).
template <int R>
__host__ __device__ constexpr int mixed_first_factor() {
  if (R % 2 == 0) {
    int a = 1;
    while (R % (2 * a) == 0) a *= 2;
    return a;
  }
  return R % 3 == 0 ? 3 : 5;
}

// Where dft_mixed<R> leaves X[s]: the power-of-two DFTs in bit-reversed
// order, the primes in natural order, a nest R = A B at
// (s mod A) B + out_pos<B>(s mod B).
template <int R>
__host__ __device__ constexpr int out_pos(int s) {
  if constexpr ((R & (R - 1)) == 0) {
    return bitrev<R>(s);
  } else if constexpr (R == 3 || R == 5 || R == 7) {
    return s;
  } else {
    constexpr int A = mixed_first_factor<R>();
    constexpr int B = R / A;
    return (s % A) * B + out_pos<B>(s % B);
  }
}

// R-point DFT of v[0..R) in registers for R in GOMEL_MIXED_RADICES; X[s]
// ends in v[out_pos<R>(s)]. A composite R = A B with A, B coprime runs the
// prime-factor (Good-Thomas) nest: input n = (B n1 + A n2) mod R, an A-point
// DFT over n1 for each n2, then a B-point DFT over n2 for each k1; output
// s = k1 mod A, k2 mod B by the Chinese remainders, so no twiddle between
// the two.
template <int R, bool kInverse>
__device__ __forceinline__ void dft_mixed(float2* v) {
  if constexpr ((R & (R - 1)) == 0) {
    dft_regs<R, kInverse>(v);
  } else if constexpr (R == 3 || R == 5 || R == 7) {
    dft_prime<R, kInverse>(v);
  } else {
    constexpr int A = mixed_first_factor<R>();
    constexpr int B = R / A;
    float2 y[R];
#pragma unroll
    for (int n2 = 0; n2 < B; ++n2) {
#pragma unroll
      for (int n1 = 0; n1 < A; ++n1) y[n2 * A + n1] = v[(B * n1 + A * n2) % R];
      dft_mixed<A, kInverse>(&y[n2 * A]);
    }
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) {
#pragma unroll
      for (int n2 = 0; n2 < B; ++n2) v[k1 * B + n2] = y[n2 * A + out_pos<A>(k1)];
      dft_mixed<B, kInverse>(&v[k1 * B]);
    }
  }
}

// a * b (kConj: a * conj b).
template <bool kConj>
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  if (kConj) b.y = -b.y;
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Complex point i of a frame (samples 2i and 2i + 1) times the window pair,
// if any: one 8-byte load each when vec, else two scalar loads of the same
// values.
__device__ __forceinline__ float2 load_point(const float* __restrict__ src,
                                             const float* __restrict__ window,
                                             int i, bool vec) {
  float2 x, w;
  if (vec) {
    x = __ldg(reinterpret_cast<const float2*>(src) + i);
  } else {
    x = make_float2(__ldg(src + 2 * i), __ldg(src + 2 * i + 1));
  }
  if (window == nullptr) return x;
  if (vec) {
    w = __ldg(reinterpret_cast<const float2*>(window) + i);
  } else {
    w = make_float2(__ldg(window + 2 * i), __ldg(window + 2 * i + 1));
  }
  return make_float2(x.x * w.x, x.y * w.y);
}

// Point i of the inverse's result into dst[i]: times 1/n, then the window
// pair w2[i] (null: no window), each step rounded (__fmul_rn).
__device__ __forceinline__ void store_inverse(float2* __restrict__ dst,
                                              const float2* __restrict__ w2,
                                              int i, float2 y, float inv_n) {
  float x0 = __fmul_rn(y.x, inv_n);
  float x1 = __fmul_rn(y.y, inv_n);
  if (w2 != nullptr) {
    const float2 wi = __ldg(&w2[i]);
    x0 = __fmul_rn(x0, wi.x);
    x1 = __fmul_rn(x1, wi.y);
  }
  dst[i] = make_float2(x0, x1);
}

// What the forward's first pass reads: the frame's samples from the signal
// (src, window, vec) or, for a slot past the last frame, zeros.
struct FrameSource {
  const float* src;
  const float* window;
  bool vec;
  bool valid;
  __device__ __forceinline__ float2 point(int i) const {
    return valid ? load_point(src, window, i, vec) : make_float2(0.0f, 0.0f);
  }
};

// rev(j) for 0 <= j < m / R_0: the digits of j (R_{P-1} the least
// significant, R_1 the most) in reverse order (R_1 the least significant).
// Decimation in time leaves the samples j + t m/R_0 of butterfly j of the
// first pass at points rev(j) R_0 + t.
__device__ __forceinline__ int mixed_rev(int j, const MixedPlan& pl) {
  int q = 0;
  for (int p = pl.passes - 1; p >= 1; --p) {
    const int r = pl.radix[p];
    const int hi = div_magic(j, pl.magic_r[p]);
    q = q * r + (j - hi * r);
    j = hi;
  }
  return q;
}

// The forward's first pass, radix R: butterflies j = th + u T (u < P/R)
// from the signal's points j + t m/R, their DFTs to points rev(j) R + s.
template <int R>
__device__ __forceinline__ void mixed_first_pass(float2* z,
                                                 const MixedPlan& pl, int th,
                                                 const FrameSource& in) {
  const int nb = pl.points / R;
  const int stride = pl.m / R;
  for (int u = 0; u < nb; ++u) {
    const int j = th + u * pl.threads;
    float2 v[R];
#pragma unroll
    for (int t = 0; t < R; ++t) v[t] = in.point(j + t * stride);
    dft_mixed<R, false>(v);
    float2* a = z + mixed_rev(j, pl) * R;
#pragma unroll
    for (int s = 0; s < R; ++s) a[s] = v[out_pos<R>(s)];
  }
  __syncthreads();
}

// Pass p >= 1 of radix R in place: butterflies b = th + u T = g ns + k at
// points g ns R + k + t ns. Forward: twiddle exp(-2 pi i t k / (ns R)) from
// twp[(t - 1) ns + k], then the DFT. kInverse undoes that: the conjugate
// DFT, then the conjugate twiddle.
template <int R, bool kInverse>
__device__ __forceinline__ void mixed_pass(float2* z, const MixedPlan& pl,
                                           int p,
                                           const float2* __restrict__ twp,
                                           int th) {
  const int nb = pl.points / R;
  const int ns = pl.ns[p];
  const unsigned long long magic = pl.magic_ns[p];
  for (int u = 0; u < nb; ++u) {
    const int b = th + u * pl.threads;
    const int g = div_magic(b, magic);
    const int k = b - g * ns;
    float2* a = z + g * ns * R + k;
    float2 v[R];
#pragma unroll
    for (int t = 0; t < R; ++t) v[t] = a[t * ns];
    if constexpr (!kInverse) {
#pragma unroll
      for (int t = 1; t < R; ++t) {
        v[t] = cmul<false>(v[t], __ldg(&twp[(t - 1) * ns + k]));
      }
      dft_mixed<R, false>(v);
#pragma unroll
      for (int s = 0; s < R; ++s) a[s * ns] = v[out_pos<R>(s)];
    } else {
      dft_mixed<R, true>(v);
      a[0] = v[out_pos<R>(0)];
#pragma unroll
      for (int t = 1; t < R; ++t) {
        a[t * ns] = cmul<true>(v[out_pos<R>(t)], __ldg(&twp[(t - 1) * ns + k]));
      }
    }
  }
  __syncthreads();
}

// The inverse's last pass, radix R: butterflies j = th + u T (u < P/R) from
// points rev(j) R + s, their conjugate DFTs to the frame's points
// j + t m/R in dst (null: nothing), times 1/n and the window.
template <int R>
__device__ __forceinline__ void mixed_last_pass(
    const float2* z, const MixedPlan& pl, int th, float2* __restrict__ dst,
    const float2* __restrict__ w2, float inv_n) {
  if (dst == nullptr) return;
  const int nb = pl.points / R;
  const int stride = pl.m / R;
  for (int u = 0; u < nb; ++u) {
    const int j = th + u * pl.threads;
    const float2* a = z + mixed_rev(j, pl) * R;
    float2 v[R];
#pragma unroll
    for (int s = 0; s < R; ++s) v[s] = a[s];
    dft_mixed<R, true>(v);
#pragma unroll
    for (int t = 0; t < R; ++t) {
      store_inverse(dst, w2, j + t * stride, v[out_pos<R>(t)], inv_n);
    }
  }
}

// The generic passes: a thread an output, u < P; roots[i] =
// exp(-2 pi i i / (ns R)) (conjugated in the inverse), walked by adding the
// output's exponent step modulo ns R.
//
// The forward's first pass when it is generic: output o = s m/R + j of
// butterfly j, sum_t x[j + t m/R] exp(-2 pi i t s / R), to point
// rev(j) R + s.
__device__ __forceinline__ void mixed_generic_first(
    float2* z, const MixedPlan& pl, int th, const FrameSource& in,
    const float2* __restrict__ roots) {
  const int R = pl.radix[0];
  const int stride = pl.m / R;
  for (int u = 0; u < pl.points; ++u) {
    const int o = th + u * pl.threads;
    const int s = div_magic(o, pl.magic_stride0);
    const int j = o - s * stride;
    float re = 0.0f, im = 0.0f;
    int idx = 0;
    for (int t = 0; t < R; ++t) {
      const float2 w = __ldg(&roots[idx]);
      const float2 x = in.point(j + t * stride);
      re += x.x * w.x - x.y * w.y;
      im += x.x * w.y + x.y * w.x;
      idx += s;
      if (idx >= R) idx -= R;
    }
    z[mixed_rev(j, pl) * R + s] = make_float2(re, im);
  }
  __syncthreads();
}

// Generic pass p >= 1 from z into out (the frame's other buffer): output
// i = g ns R + d ns + k. Forward (d = s): sum_t z[g ns R + k + t ns]
// exp(-2 pi i t (k + s ns) / (ns R)). Inverse (d = t): sum_s
// z[g ns R + k + s ns] exp(+2 pi i t (k + s ns) / (ns R)).
template <bool kInverse>
__device__ __forceinline__ void mixed_generic_pass(
    const float2* __restrict__ z, float2* __restrict__ out,
    const MixedPlan& pl, int p, const float2* __restrict__ roots, int th) {
  const int R = pl.radix[p];
  const int ns = pl.ns[p];
  const int span = ns * R;
  for (int u = 0; u < pl.points; ++u) {
    const int i = th + u * pl.threads;
    const int g = div_magic(i, pl.magic_span[p]);
    const int e = i - g * span;
    const int d = div_magic(e, pl.magic_ns[p]);
    const int k = e - d * ns;
    const float2* a = z + g * span + k;
    int idx = kInverse ? d * k : 0;
    const int step = kInverse ? d * ns : e;
    float re = 0.0f, im = 0.0f;
    for (int c = 0; c < R; ++c) {
      const float2 w = cmul<kInverse>(a[c * ns], __ldg(&roots[idx]));
      re += w.x;
      im += w.y;
      idx += step;
      if (idx >= span) idx -= span;
    }
    out[i] = make_float2(re, im);
  }
  __syncthreads();
}

// The inverse's last pass when it is generic: the frame's point
// i = t m/R + j, sum_s z[rev(j) R + s] exp(+2 pi i t s / R), into dst
// (null: nothing), times 1/n and the window.
__device__ __forceinline__ void mixed_generic_last(
    const float2* z, const MixedPlan& pl, int th,
    const float2* __restrict__ roots, float2* __restrict__ dst,
    const float2* __restrict__ w2, float inv_n) {
  if (dst == nullptr) return;
  const int R = pl.radix[0];
  const int stride = pl.m / R;
  for (int u = 0; u < pl.points; ++u) {
    const int i = th + u * pl.threads;
    const int t = div_magic(i, pl.magic_stride0);
    const int j = i - t * stride;
    const float2* a = z + mixed_rev(j, pl) * R;
    float re = 0.0f, im = 0.0f;
    int idx = 0;
    for (int s = 0; s < R; ++s) {
      const float2 w = cmul<true>(a[s], __ldg(&roots[idx]));
      re += w.x;
      im += w.y;
      idx += t;
      if (idx >= R) idx -= R;
    }
    store_inverse(dst, w2, i, make_float2(re, im), inv_n);
  }
}

// The forward transform of one frame (thread th of its T) in z (and, after
// a generic pass, z + m): returns the buffer that holds Z in natural order.
// Every thread of the block calls it: it holds the barriers.
__device__ __forceinline__ float2* fwd_frame_mixed(
    float2* z, const FrameSource& in, const float2* __restrict__ twp,
    const MixedPlan& pl, int th) {
  if (pl.reg[0]) {
    switch (pl.radix[0]) {
#define GOMEL_MIXED_FIRST(R) \
  case R: mixed_first_pass<R>(z, pl, th, in); break;
      GOMEL_MIXED_RADICES(GOMEL_MIXED_FIRST)
#undef GOMEL_MIXED_FIRST
    }
  } else {
    mixed_generic_first(z, pl, th, in, twp + pl.table[0]);
  }
  float2* other = z + pl.m;
  for (int p = 1; p < pl.passes; ++p) {
    const float2* tp = twp + pl.table[p];
    if (pl.reg[p]) {
      switch (pl.radix[p]) {
#define GOMEL_MIXED_FWD(R) \
  case R: mixed_pass<R, false>(z, pl, p, tp, th); break;
        GOMEL_MIXED_RADICES(GOMEL_MIXED_FWD)
#undef GOMEL_MIXED_FWD
      }
    } else {
      mixed_generic_pass<false>(z, other, pl, p, tp, th);
      float2* t = z;
      z = other;
      other = t;
    }
  }
  return z;
}

// The inverse transform of one frame (thread th of its T) from Z in natural
// order in z, other the frame's second buffer (used only after a generic
// pass): point i of the result, times 1/n and the window pair w2[i] (null:
// no window), into dst[i]; nothing when dst is null. Every thread of the
// block calls it.
__device__ __forceinline__ void inv_frame_mixed(
    float2* z, float2* other, const float2* __restrict__ twp,
    const MixedPlan& pl, int th, float2* __restrict__ dst,
    const float2* __restrict__ w2, float inv_n) {
  for (int p = pl.passes - 1; p >= 1; --p) {
    const float2* tp = twp + pl.table[p];
    if (pl.reg[p]) {
      switch (pl.radix[p]) {
#define GOMEL_MIXED_INV(R) \
  case R: mixed_pass<R, true>(z, pl, p, tp, th); break;
        GOMEL_MIXED_RADICES(GOMEL_MIXED_INV)
#undef GOMEL_MIXED_INV
      }
    } else {
      mixed_generic_pass<true>(z, other, pl, p, tp, th);
      float2* t = z;
      z = other;
      other = t;
    }
  }
  if (pl.reg[0]) {
    switch (pl.radix[0]) {
#define GOMEL_MIXED_LAST(R) \
  case R: mixed_last_pass<R>(z, pl, th, dst, w2, inv_n); break;
      GOMEL_MIXED_RADICES(GOMEL_MIXED_LAST)
#undef GOMEL_MIXED_LAST
    }
  } else {
    mixed_generic_last(z, pl, th, twp + pl.table[0], dst, w2, inv_n);
  }
}

// Launch a mixed-core frame kernel on plan pl: pl.frames frames a block of
// pl.threads each, pl.frame_stride float2 of dynamic shared memory a frame.
template <typename Kernel, typename... Args>
int launch_mixed_frames(Kernel kernel, long long total, const MixedPlan& pl,
                        cudaStream_t stream, Args... args) {
  const size_t smem =
      static_cast<size_t>(pl.frames) * pl.frame_stride * sizeof(float2);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const long long blocks = (total + pl.frames - 1) / pl.frames;
  kernel<<<static_cast<unsigned>(blocks), pl.threads * pl.frames, smem,
           stream>>>(args...);
  return gomel_status();
}

// Whether every frame's first sample, and the window, sit on a 16-byte
// boundary: the float4 route of first_pass.
inline bool frames_vec_aligned(const void* x, const void* window,
                               long long batch_stride, long long hop) {
  return hop % 4 == 0 && batch_stride % 4 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(window) % 16 == 0;
}

// f(std::integral_constant<int, L>{}) for m = 2^L, 1 <= L <= 13 (n = 4 ...
// 16384); cudaErrorInvalidValue for any other m.
template <typename F, int... Ls>
int with_log_m(int m, F f, std::integer_sequence<int, Ls...>) {
  int rc = static_cast<int>(cudaErrorInvalidValue);
  (void)((m == (2 << Ls) ? (rc = f(std::integral_constant<int, Ls + 1>{}), true)
                         : false) || ...);
  return rc;
}

template <typename F>
int with_log_m(int m, F f) {
  return with_log_m(m, f, std::make_integer_sequence<int, 13>{});
}

// Launch the power-of-two frame kernel of m = 2^kLogM: FwdPlan's frames a
// block, m float2 of dynamic shared memory a frame. The wrapper's plan
// (radices, threads, frames_per_block: ops/rfft_mag.fwd_plan, whose per-pass
// twiddle table the kernel reads) must equal FwdPlan's; otherwise nothing
// launches and cudaErrorInvalidValue returns.
template <int kLogM, typename Kernel, typename... Args>
int launch_pow2_frames(Kernel kernel, long long total, int radices,
                       int threads, int frames_per_block, cudaStream_t stream,
                       Args... args) {
  using Plan = FwdPlan<kLogM>;
  if (radices != Plan::code() || threads != Plan::threads ||
      frames_per_block != Plan::frames_per_block) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(Plan::frames_per_block) * Plan::m *
                      sizeof(float2);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const long long blocks =
      (total + Plan::frames_per_block - 1) / Plan::frames_per_block;
  kernel<<<static_cast<unsigned>(blocks),
           Plan::threads * Plan::frames_per_block, smem, stream>>>(args...);
  return gomel_status();
}
