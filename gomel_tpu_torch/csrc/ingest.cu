// KA: raw PCM-16 ingest — int16 samples to the padded float32 signal.
//
// Replaces gomel_tpu/ops/quantize.py:105 pcm16_ingest (K1) with its zero-stuff
// upsample, gomel_tpu/ops/resample.py:17 zero_stuff_upsample (K12), and the
// batch CLIs' per-row scaled ingest, gomel_tpu/parallel/batch.py:289. On the
// mel encode from PCM at power-of-two n/2 the fused KB + KC reads the int16
// samples itself (rfft_mag.cu, gomel_stft_mel_log_pcm16) and KA does not run;
// KA serves the phase encodes, the zero-stuff and stereo ingests, the
// long-form shards and the mel encodes on the other FFT routes.
//
// Per output sample: int16 -> float, stereo mean ((a + b) / 2, exact in
// float32), divide by the scale (exact for a power of two), zero past the
// input. Every step is exact, so the result equals the JAX program bit
// for bit.
//
// Per-row scales (``scales`` not null): row r divides by scales[r] instead
// of the one ``scale`` (a bucket of the batch CLIs mixes WAV rows, 32768, and
// mel-scaled FLAC rows, 65536). The JAX program multiplies by the float32
// reciprocal; for a power of two both are exact, so they agree bit for bit.
//
// Zero-stuffing (zp > 0; the phase path at 8-32 kHz and 11.025/22.05 kHz):
// after every zp input samples come zs zeros, and kept samples are
// multiplied by (1 + zs), after the division, as the JAX program orders it.
// Output sample t lies in group g = t / (zp + zs) at r = t mod (zp + zs); it
// is input sample g*zp + r when r < zp and that index exists, else 0. The
// upsampled length is n + ceil(n / zp) * zs: the trailing partial group still
// reserves its zeros. Multiplying by a small integer can round; both sides
// round the same single product, so it stays bit-exact. (zp, zs) is one of
// the five pairs of core/config.py PAD_SHIFT_TABLE, each a kernel of its own,
// so zp + zs is a compile-time constant and t / (zp + zs) a multiply-high;
// the entry point refuses any other pair (cudaErrorInvalidValue).
//
// Bound: device memory bandwidth. It reads 2 (mono) or 4 (stereo) bytes and
// writes 4 bytes an output sample, with no arithmetic worth counting: at the
// bench shape (2 x 1,440,000 mono samples) 17.3 MB, 0.0052 ms at 3.35 TB/s.
// What held the earlier form (tools/ingest_earlier.cu) at 60% of that, 25%
// in the zero-stuff mode: one 2-byte load and one 4-byte store a sample, a
// 64-bit division a sample to find its group, and a grid sized by the
// output with one sample a thread.
// Design (tools/profile_ingest.py measures each choice as an ablation):
//   - A row is cut into slots of 4 output samples whose first one sits on
//     a 16-byte boundary of the output (slot k starts at 4 k - b, b the
//     row's start past 16 bytes in floats; slot 0 and the last are the
//     row's scalar head and tail). A whole slot is one float4 store, so a
//     warp's store covers 512 contiguous bytes: stores are two thirds of
//     the bytes, and two float4s 32 bytes apart a thread (mono slots of 8
//     behind one 16-byte load) measured slower than this.
//   - Mono: one 8-byte load of the slot's 4 int16; stereo: one 16-byte load
//     of its 4 frames. The load is vector where the slot's samples lie
//     inside the input and on the load's boundary (a row-constant test),
//     else scalar loads of the same samples; past the input it writes
//     zeros (the padding, in the same pass).
//   - Zero-stuff: the slot's kept input samples (at most 3) loaded as
//     int16; a whole slot divides its first output by zp + zs once (a
//     multiply-high by the constant) and steps the other three by
//     compile-time wraps, and the boost folds into the one FMA (s / scale
//     is exact, so (s / scale) (1 + zs) is one rounding of s (1 + zs) /
//     scale). It stays near 65% of its bound where the mono mode reaches
//     80%: none of the grid, slots a thread, division or conversion
//     ablations moves it, and what it does beyond the mono mode for the
//     same float4 is the group arithmetic and up to 4 predicated 2-byte
//     loads.
//   - int16 -> float without the conversion instruction (a quarter-rate
//     pipe): a LOP3 makes the bits the float 2^23 + 2^15 + s, and one FMA
//     by the scale's reciprocal gives s / scale exactly (common.cuh
//     pcm_biased, pcm_div_biased).
//   - Indices are 32-bit where every offset fits (each shape the port runs),
//     64-bit in a second build of each kernel; a thread finds its first
//     slot's row by one multiply-high by the host's magic number (64-bit
//     builds: one division): no division a sample, and none on the
//     conversion pipe. The scale's power-of-two test is a branch a slot.
//   - One slot a thread, and a grid of all the slots up to kMaxBlocks
//     blocks (past it, threads walk rows by adds, kIngestUnroll slots a
//     grid stride apart at a time, their loads before their stores). Many
//     short-lived threads keep more loads in flight than fewer threads
//     with 2 or 4 slots each, and blocks retiring while the card schedules
//     the next measured ahead of a grid of the resident blocks walking on
//     (PERF.md). Rows share the walk, so the batch CLIs' small buckets
//     fill the card as one long row does.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kIngestThreads = 256;
constexpr int kIngestUnroll = 1;  // slots a thread has in flight
constexpr int kMonoSlot = 4;      // mono samples a slot (8 bytes of int16)
// the grid's cap: past it the threads walk on by grid strides
constexpr long long kMaxBlocks = 1LL << 20;

// A launch's walk over rows x slots: kIngestUnroll grid strides are
// step_rows rows and step_slots slots on (step_slots < slots).
template <typename I>
struct IngestWalk {
  I rows, n_in, n_out;  // n_in: input samples (frames) a row
  I slots;              // a row's slots
  I step_rows, step_slots;
  // id / slots = (id magic) >> shift for 32-bit ids
  unsigned long long magic;
  int shift;
  int pcm_phase;  // pcm's base past 16 bytes, int16 elements (0..7)
  int out_phase;  // out's base past 16 bytes, floats (0..3)
};

// The slot's shape: kV output samples, stored as kV / 4 float4s.
template <int C, int ZP>
struct SlotShape {
  static constexpr int kV = ZP == 0 && C == 1 ? kMonoSlot : 4;
};

// Input sample (frame) t of a row: int16 -> float, the stereo mean, exact.
template <int C, typename I>
__device__ __forceinline__ float sample_at(const int16_t* __restrict__ src,
                                           I t) {
  if constexpr (C == 1) {
    return pcm_value(static_cast<uint16_t>(__ldg(src + t)));
  } else {
    const float a = pcm_value(static_cast<uint16_t>(__ldg(src + 2 * t)));
    const float b = pcm_value(static_cast<uint16_t>(__ldg(src + 2 * t + 1)));
    return __fmul_rn(__fadd_rn(a, b), 0.5f);
  }
}

// Samples t0 .. t0 + kV - 1 (t0 >= 0, t0 + kV <= n_in) from one vector load
// of kV C int16 at p = src + C t0 (aligned to its width), divided: 8 bytes
// for a mono slot, 16 for a stereo one (and for tools/profile_ingest.py's
// mono_v8 build).
template <int C, int kV, bool kPow2>
__device__ __forceinline__ void load_vector(const int16_t* __restrict__ p,
                                            PcmScale d, float* v) {
  constexpr int kWords = C * kV / 2;  // 32-bit words: 2 int16 each
  static_assert(kWords == 4 || kWords == 2, "a 16- or 8-byte load a slot");
  unsigned w[kWords];
  if constexpr (kWords == 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
  } else {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = q.x;
    w[1] = q.y;
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if constexpr (C == 1) {
      v[2 * i] = pcm_div_biased<kPow2>(pcm_biased(w[i]), d);
      v[2 * i + 1] = pcm_div_biased<kPow2>(pcm_biased(w[i] >> 16), d);
    } else {
      v[i] = pcm_div<kPow2>(__fmul_rn(__fadd_rn(pcm_value(w[i]),
                                                pcm_value(w[i] >> 16)),
                                      0.5f),
                            d);
    }
  }
}

// One slot: where it lies in the output and its kV values.
template <int kV, typename I>
struct Slot {
  float* dst;  // the row's output
  I t0;        // the slot's first output sample in the row (may be < 0)
  bool whole;  // every sample of the slot inside [0, n_out)
  float v[kV];
};

// The slot's kV values (s.t0 set): kPow2 when the row's scale is a power
// of two (a branch a slot, not a sample); aligned: the row's slots sit on
// the vector load's boundary.
template <int C, int ZP, int ZS, bool kPow2, typename I>
__device__ __forceinline__ void fill_slot(const int16_t* __restrict__ src,
                                          const IngestWalk<I>& w, PcmScale d,
                                          bool aligned,
                                          Slot<SlotShape<C, ZP>::kV, I>& s) {
  constexpr int kV = SlotShape<C, ZP>::kV;
  if constexpr (ZP == 0) {
    if (aligned && s.t0 >= 0 && s.t0 + kV <= w.n_in) {
      load_vector<C, kV, kPow2>(src + C * s.t0, d, s.v);
    } else {
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const I t = s.t0 + j;
        s.v[j] = t >= 0 && t < w.n_in
                     ? pcm_div<kPow2>(sample_at<C>(src, t), d)
                     : 0.0f;
      }
    }
  } else {
    using U = std::make_unsigned_t<I>;
    constexpr int kG = ZP + ZS;
    const float boost = static_cast<float>(1 + ZS);
    if (s.whole) {
      // one division for the slot: output j sits p0 + j past group g0's
      // start, which wraps into the next groups at most kWraps times
      constexpr int kWraps = (kV - 1 + kG - 1) / kG;
      const I g0 = static_cast<I>(static_cast<U>(s.t0) / kG);
      const int p0 = static_cast<int>(s.t0 - g0 * kG);
      // power of two: s / scale is exact, so (s / scale) (1 + zs) is one
      // rounding of s (boost / scale): one FMA (mono) or multiply (stereo)
      const float ib = d.inv * boost, bb = d.bias * boost;  // both exact
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        int pos = p0 + j;
        I g = g0;
#pragma unroll
        for (int r = 0; r < kWraps; ++r) {
          if (pos >= kG) {
            pos -= kG;
            ++g;
          }
        }
        const I i = g * ZP + pos;
        float v = 0.0f;
        if (pos < ZP && i < w.n_in) {
          if constexpr (!kPow2) {
            v = __fmul_rn(pcm_div<false>(sample_at<C>(src, i), d), boost);
          } else if constexpr (C == 1) {
            v = __fmaf_rn(pcm_biased(static_cast<uint16_t>(__ldg(src + i))),
                          ib, bb);
          } else {
            v = __fmul_rn(sample_at<C>(src, i), ib);
          }
        }
        s.v[j] = v;
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const I t = s.t0 + j;
      s.v[j] = 0.0f;
      if (t >= 0 && t < w.n_out) {
        const I g = static_cast<I>(static_cast<U>(t) / kG);
        const I pos = t - g * kG;
        const I i = g * ZP + pos;
        if (pos < ZP && i < w.n_in) {
          s.v[j] = __fmul_rn(pcm_div<kPow2>(sample_at<C>(src, i), d), boost);
        }
      }
    }
  }
}

template <int C, int ZP, int ZS, typename I>
__device__ __forceinline__ void load_slot(
    const int16_t* __restrict__ pcm, float* __restrict__ out,
    const IngestWalk<I>& w, const PcmScale& scale,
    const float* __restrict__ scales, I r, I k,
    Slot<SlotShape<C, ZP>::kV, I>& s) {
  constexpr int kV = SlotShape<C, ZP>::kV;
  const I row_out = r * w.n_out;
  const int b = static_cast<int>((row_out + w.out_phase) & 3);
  const I row_in = r * w.n_in * C;  // the row's first int16
  const PcmScale d = scales != nullptr ? pcm_scale(__ldg(scales + r)) : scale;
  s.dst = out + row_out;
  s.t0 = k * kV - b;
  s.whole = s.t0 >= 0 && s.t0 + kV <= w.n_out;
  // the slot's first int16 on the load's boundary (kV C elements): the
  // same for every slot of the row
  const bool aligned =
      ZP == 0 &&
      ((static_cast<I>(w.pcm_phase) + row_in - static_cast<I>(b) * C) &
       (kV * C - 1)) == 0;
  if (d.inv != 0.0f) {
    fill_slot<C, ZP, ZS, true>(pcm + row_in, w, d, aligned, s);
  } else {
    fill_slot<C, ZP, ZS, false>(pcm + row_in, w, d, aligned, s);
  }
}

template <int kV, typename I>
__device__ __forceinline__ void store_slot(const Slot<kV, I>& s, I n_out) {
  if (s.whole) {
    float4* o = reinterpret_cast<float4*>(s.dst + s.t0);
#pragma unroll
    for (int q = 0; q < kV / 4; ++q) {
      o[q] = make_float4(s.v[4 * q], s.v[4 * q + 1], s.v[4 * q + 2],
                         s.v[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const I t = s.t0 + j;
      if (t >= 0 && t < n_out) s.dst[t] = s.v[j];
    }
  }
}

template <int C, int ZP, int ZS, typename I>
__global__ void __launch_bounds__(kIngestThreads)
pcm16_ingest_kernel(const int16_t* __restrict__ pcm, float* __restrict__ out,
                    const IngestWalk<I> w, const PcmScale scale,
                    const float* __restrict__ scales) {
  constexpr int kV = SlotShape<C, ZP>::kV;
  const I stride = static_cast<I>(gridDim.x) * kIngestThreads;
  I r[kIngestUnroll], k[kIngestUnroll];
#pragma unroll
  for (int u = 0; u < kIngestUnroll; ++u) {
    const I id = static_cast<I>(blockIdx.x) * kIngestThreads + threadIdx.x +
                 u * stride;
    if constexpr (sizeof(I) == 4) {
      r[u] = static_cast<I>((static_cast<unsigned long long>(id) * w.magic) >>
                            w.shift);
    } else {
      r[u] = id / w.slots;
    }
    k[u] = id - r[u] * w.slots;
  }
  while (r[0] < w.rows) {  // r[0] is the thread's lowest slot
    Slot<kV, I> s[kIngestUnroll];
#pragma unroll
    for (int u = 0; u < kIngestUnroll; ++u) {
      if (r[u] < w.rows) {
        load_slot<C, ZP, ZS>(pcm, out, w, scale, scales, r[u], k[u], s[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kIngestUnroll; ++u) {
      if (r[u] < w.rows) store_slot(s[u], w.n_out);
    }
#pragma unroll
    for (int u = 0; u < kIngestUnroll; ++u) {
      k[u] += w.step_slots;
      r[u] += w.step_rows;
      if (k[u] >= w.slots) {
        k[u] -= w.slots;
        ++r[u];
      }
    }
  }
}

template <int C, int ZP, int ZS, typename I>
int launch_walk(const int16_t* pcm, float* out, long long rows, long long n_in,
                long long n_out, float scale, const float* scales, int device,
                cudaStream_t stream) {
  constexpr int kV = SlotShape<C, ZP>::kV;
  const auto kernel = pcm16_ingest_kernel<C, ZP, ZS, I>;
  const long long slots = (n_out + 3 + kV - 1) / kV;
  const long long per_block = static_cast<long long>(kIngestThreads) *
                              kIngestUnroll;
  const long long need = (rows * slots + per_block - 1) / per_block;
  const long long blocks = need < kMaxBlocks ? need : kMaxBlocks;
  const long long step = blocks * per_block;
  int log_slots = 0;  // the least l with 2^l >= slots
  while ((1LL << log_slots) < slots) ++log_slots;
  const IngestWalk<I> w{
      static_cast<I>(rows), static_cast<I>(n_in), static_cast<I>(n_out),
      static_cast<I>(slots), static_cast<I>(step / slots),
      static_cast<I>(step % slots),
      // 32-bit ids: ceil(2^(32 + l) / slots) <= 2^33, and (id magic) >>
      // (32 + l) is id / slots for every id < 2^32 (its error id (magic
      // slots - 2^(32 + l)) stays below 2^(32 + l))
      sizeof(I) == 4 ? ((1ULL << (32 + log_slots)) + slots - 1) / slots : 0,
      32 + log_slots,
      static_cast<int>((reinterpret_cast<uintptr_t>(pcm) / 2) & 7),
      static_cast<int>((reinterpret_cast<uintptr_t>(out) / 4) & 3)};
  kernel<<<static_cast<unsigned>(blocks), kIngestThreads, 0, stream>>>(
      pcm, out, w, pcm_scale(scale), scales);
  return gomel_status();
}

// 32-bit indices when every offset a launch forms (rows x the longer of
// a row's int16 and floats, plus the grid's strides) stays below 2^30.
template <int C, int ZP, int ZS>
int launch_pair(const int16_t* pcm, float* out, long long rows,
                long long n_in, long long n_out, float scale,
                const float* scales, int device, cudaStream_t stream) {
  const long long widest = (n_out > C * n_in ? n_out : C * n_in) + 16;
  if ((rows + 2) * widest < (1LL << 30)) {
    return launch_walk<C, ZP, ZS, int>(pcm, out, rows, n_in, n_out, scale,
                                       scales, device, stream);
  }
  return launch_walk<C, ZP, ZS, long long>(pcm, out, rows, n_in, n_out, scale,
                                           scales, device, stream);
}

template <int C>
int launch_channels(const int16_t* pcm, float* out, long long rows,
                    long long n_in, long long n_out, float scale,
                    const float* scales, int zp, int zs, int device,
                    cudaStream_t stream) {
#define GOMEL_INGEST_PAIR(P, S)                                           \
  if (zp == P && zs == S) {                                               \
    return launch_pair<C, P, S>(pcm, out, rows, n_in, n_out, scale,       \
                                scales, device, stream);                  \
  }
  GOMEL_INGEST_PAIR(0, 0)
  GOMEL_INGEST_PAIR(2, 1)  // 32 kHz
  GOMEL_INGEST_PAIR(1, 1)  // 24 kHz, 22.05 kHz
  GOMEL_INGEST_PAIR(1, 2)  // 16 kHz
  GOMEL_INGEST_PAIR(1, 5)  // 8 kHz
  GOMEL_INGEST_PAIR(1, 3)  // 11.025 kHz
#undef GOMEL_INGEST_PAIR
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// pcm: int16 [rows, n_in, channels] (channels 1 or 2); out: float32
// [rows, n_out] with n_out >= the upsampled length (n_in when zp = 0);
// scales: float32 [rows], or null for the one ``scale``; (zp, zs) one of
// PAD_SHIFT_TABLE's pairs or (0, 0). Any other pair or channel count
// launches nothing and returns cudaErrorInvalidValue.
GOMEL_API int gomel_pcm16_ingest(const void* pcm, void* out, long long rows,
                                 long long n_in, long long n_out, int channels,
                                 float scale, const void* scales, int zp,
                                 int zs, int device, void* stream) {
  cudaSetDevice(device);
  const auto p = static_cast<const int16_t*>(pcm);
  const auto o = static_cast<float*>(out);
  const auto sc = static_cast<const float*>(scales);
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n_out <= 0) return gomel_status();
  if (channels == 1) {
    return launch_channels<1>(p, o, rows, n_in, n_out, scale, sc, zp, zs,
                              device, s);
  }
  if (channels == 2) {
    return launch_channels<2>(p, o, rows, n_in, n_out, scale, sc, zp, zs,
                              device, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
