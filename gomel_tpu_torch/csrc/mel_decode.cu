// KI: mel decode front end — log-mel (or quantized PNG planes) to the fixed
// Griffin-Lim magnitudes mag_half [B*F, n/2 + 1].
//
// Replaces gomel_tpu/ops/quantize.py:78 dequantize_mel_plane and :225
// dequantize_mel_plane_batch (K7's mel form), the log-domain volume boost of
// gomel_tpu/pipelines/mel.py:152-154, gomel_tpu/ops/mel_ops.py:152
// mel_to_linear (K15: exp -> undomel matmul -> (v - add) / mul) and
// gomel_tpu/ops/griffinlim.py:90 griffin_lim_magnitudes (K13's magnitudes).
// The source is one of:
//   kFloat   log-mel [B, F, M, 2] float32;
//   kQuant8  PNG planes [B, M, F, 2] uint8 with per-row global extrema
//            mgc_max, mgc_min [B] float32 (the towav device-quantize path).
// Each value is dequantized once, in the JAX order (v / max_val) * (max -
// min) + min with each step rounded on its own (__fdiv_rn / __fmul_rn /
// __fadd_rn, as KG's dequantize), then + boost as a separate rounding when
// the boost is non-zero, then expf.
// U = inverse_mel_weights [n/2, M] is banded, each bin drawing on one
// contiguous run of mels (core/filterbank.py), so the host builds a float32
// table of (first mel, tap count, taps) per bin (ops/mel_ops._band_table) and
// each output is one fmaf chain over its taps in ascending mel order, instead
// of the dense product: at n = 4096, M = 192, at most 2 taps a bin. The
// skipped terms are exact zeros.
// Outputs: channel 0 for bins 0..n/2-1 and channel 1 of bin n/2-1 as bin
// n/2 (griffin_lim_magnitudes), then (v - tune_add) / tune_mul (a true
// division, skipped where (mul, add) = (1, 0): it is then the identity, bit
// for bit, as the JAX op's skipped branch) and fabsf.
//
// Bound: the output, 8 KB a frame (18.4 MB at the bench shape's 2 x 1122
// frames; 0.0055 ms at 3.35 TB/s). The form this replaced ran a block a frame
// (latency-bound: each output a chain of dependent loads of its table row
// from global memory, the uint8 planes read a byte a sector). Design:
//   - the work is runs of kMelRun consecutive frames of one batch row; a
//     grid of the card's resident blocks (common.cuh resident_blocks) takes
//     them in turn, each block staging the band table once in shared memory
//     as planes a bin wide (e index | tap count << 16, then each tap), so a
//     warp's reads of consecutive bins are conflict-free and the table is
//     read from L2 once a block, not once an output;
//   - a run's prologue reads each mel row's [T, 2] sub-image of the uint8
//     planes as 2T contiguous bytes, or the run's T x 2M contiguous floats,
//     kMagBatch loads in flight a thread, into shared memory [T][2M + 2]
//     (the pad keeps a warp's writes, consecutive (frame, channel) pairs of
//     one mel, on distinct banks); two such buffers alternate, so a warp
//     still on the last run's frames never meets the next run's writes and
//     one barrier a run suffices;
//   - warp w computes frame w % T of the run, in chunks of 128 outputs from
//     the (w / T)-th on, lane l the outputs l, l + 32, l + 64, l + 96, and
//     stores each as it goes: a warp's store is 128 contiguous bytes of the
//     frame's row. Rows start at any float (n/2 + 1 is odd); 16-byte stores
//     of the row's aligned chunks through a staging row a warp (the
//     ki_vec_stores build of tools/profile_quant.py) were no faster.
// Tables wider than the block's shared memory allows keep only the first
// plane there and read the taps through L1 (kTaps = 0).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kFloat = 0;
constexpr int kQuant8 = 1;
constexpr int kMagThreads = 256;
constexpr int kMelRun = 4;      // frames a run (T); 8 / T warps a frame
constexpr int kMagBatch = 8;    // loads in flight a thread (prologue, table)
constexpr int kMagChunk = 128;  // outputs a warp computes at once: 4 a lane
constexpr size_t kMagSmemMax = 200 * 1024;

// Shared memory a block takes before the taps' planes: two runs' exps
// [2][T][2M + 2] and the table's first plane [bins].
size_t mag_base_smem(int mels, int bins) {
  return (2 * static_cast<size_t>(kMelRun) * (2 * mels + 2) + bins) *
         sizeof(float);
}

// One output j of a frame (its exps ``er``): j < bins is bin j on channel 0,
// j = bins is bin bins - 1 on channel 1.
template <int kTaps>
__device__ __forceinline__ float mag_value(
    int j, const float* er, const unsigned* __restrict__ hdr,
    const float* __restrict__ wt, const float* __restrict__ taps, int bins,
    int max_taps, bool tune, float tune_mul, float tune_add) {
  const int k = j < bins ? j : bins - 1;
  const unsigned h = hdr[k];
  const int at = static_cast<int>(h & 0xffffu) + j - k;  // Nyquist: channel 1
  const int cnt = static_cast<int>(h >> 16);
  float acc = 0.0f;
  if constexpr (kTaps > 0) {
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      if (t < cnt) acc = fmaf(wt[t * bins + k], er[at + 2 * t], acc);
    }
  } else {
    const float* w = taps + static_cast<long long>(k) * max_taps;
    for (int t = 0; t < cnt; ++t) acc = fmaf(w[t], er[at + 2 * t], acc);
  }
  if (tune) acc = __fdiv_rn(__fsub_rn(acc, tune_add), tune_mul);
  return fabsf(acc);
}

// The exps of one run (frames f0 .. f0 + run - 1 of row b) into ``e``
// [kMelRun][stride]: kMagBatch loads in flight a thread, then their exps.
template <int kMode>
__device__ __forceinline__ void run_prologue(
    const void* __restrict__ src, const float* __restrict__ mgc_max,
    const float* __restrict__ mgc_min, float* e, int stride, int b, int f0,
    int run, int frames, int mels, float max_val, float boost) {
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  if constexpr (kMode == kQuant8) {
    const float mn = mgc_min[b];
    const float rng = __fsub_rn(mgc_max[b], mn);  // float32 first, as in JAX
    // mel m's run: 2 run contiguous bytes at ((b M + m) F + f0) 2
    const unsigned char* s =
        static_cast<const unsigned char*>(src) +
        (static_cast<long long>(b) * mels * frames + f0) * 2;
    const int total = mels * 2 * kMelRun;
    for (int i0 = tid; i0 < total; i0 += kMagBatch * threads) {
      unsigned char q[kMagBatch];
#pragma unroll
      for (int u = 0; u < kMagBatch; ++u) {
        const int i = i0 + u * threads;
        const int m = i / (2 * kMelRun);
        const int o = i - m * 2 * kMelRun;  // byte of the run: frame o / 2
        q[u] = 0;
        if (i < total && o < 2 * run) {
          q[u] = s[static_cast<long long>(m) * frames * 2 + o];
        }
      }
#pragma unroll
      for (int u = 0; u < kMagBatch; ++u) {
        const int i = i0 + u * threads;
        const int m = i / (2 * kMelRun);
        const int o = i - m * 2 * kMelRun;
        if (i < total && o < 2 * run) {
          float v = __fadd_rn(
              __fmul_rn(__fdiv_rn(static_cast<float>(q[u]), max_val), rng), mn);
          if (boost != 0.0f) v = __fadd_rn(v, boost);
          e[(o >> 1) * stride + 2 * m + (o & 1)] = expf(v);
        }
      }
    }
  } else {
    const float* s = static_cast<const float*>(src) +
                     (static_cast<long long>(b) * frames + f0) * 2 * mels;
    const int total = run * 2 * mels;
    for (int i0 = tid; i0 < total; i0 += kMagBatch * threads) {
      float x[kMagBatch];
#pragma unroll
      for (int u = 0; u < kMagBatch; ++u) {
        const int i = i0 + u * threads;
        x[u] = i < total ? s[i] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kMagBatch; ++u) {
        const int i = i0 + u * threads;
        if (i < total) {
          const int t = i / (2 * mels);
          float v = x[u];
          if (boost != 0.0f) v = __fadd_rn(v, boost);
          e[t * stride + (i - t * 2 * mels)] = expf(v);
        }
      }
    }
  }
}

// kTaps > 0: the taps' kTaps planes in shared memory; 0: any count, the taps
// read from global memory. Persistent: block g takes the runs g, g + grid,
// ... (runs = batch x runs_per_row, runs of kMelRun frames of one row).
template <int kMode, int kTaps>
// At most 64 registers a thread, so 4 blocks fit an SM (the uint8 source
// takes 78 registers uncapped: 3 blocks, slower; tools/profile_quant.py).
__global__ void __launch_bounds__(kMagThreads, 4)
mel_to_mag_kernel(const void* __restrict__ src,
                  const float* __restrict__ mgc_max,
                  const float* __restrict__ mgc_min,
                  const int* __restrict__ first, const int* __restrict__ count,
                  const float* __restrict__ taps, float* __restrict__ out,
                  int frames, int mels, int bins, int max_taps, float max_val,
                  float boost, float tune_mul, float tune_add,
                  int runs_per_row, long long runs) {
  // [2][T][2M + 2] exps (two runs' worth), then the table: [bins] e index |
  // count << 16, then kTaps planes [bins] of taps
  extern __shared__ float4 smem4[];
  const int stride = 2 * mels + 2;
  float* e2 = reinterpret_cast<float*>(smem4);
  unsigned* hdr = reinterpret_cast<unsigned*>(e2 + 2 * kMelRun * stride);
  float* wt = reinterpret_cast<float*>(hdr + bins);
  const int tid = threadIdx.x;
  const int threads = blockDim.x;

  // the table, kMagBatch bins in flight a thread
  for (int k0 = tid; k0 < bins; k0 += kMagBatch * threads) {
    int fk[kMagBatch], ck[kMagBatch];
    float wk[kMagBatch][kTaps > 0 ? kTaps : 1];
#pragma unroll
    for (int u = 0; u < kMagBatch; ++u) {
      const int k = k0 + u * threads;
      fk[u] = 0;
      ck[u] = 0;
      if (k < bins) {
        fk[u] = first[k];
        ck[u] = count[k];
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          wk[u][t] = t < max_taps
                         ? taps[static_cast<long long>(k) * max_taps + t]
                         : 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kMagBatch; ++u) {
      const int k = k0 + u * threads;
      if (k < bins) {
        hdr[k] = static_cast<unsigned>(2 * fk[u]) |
                 (static_cast<unsigned>(ck[u]) << 16);
#pragma unroll
        for (int t = 0; t < kTaps; ++t) wt[t * bins + k] = wk[u][t];
      }
    }
  }

  // warp w: frame w % T of each run, its chunks w / T, w / T + parts, ...
  const int warp = tid >> 5;
  const int lane = tid & 31;
  constexpr int kParts = kMagThreads / 32 / kMelRun;
  const int t = warp % kMelRun;
  const int part = warp / kMelRun;
  const bool tune = tune_mul != 1.0f || tune_add != 0.0f;
  int k = 0;
  for (long long r = blockIdx.x; r < runs; r += gridDim.x, ++k) {
    const int b = static_cast<int>(r / runs_per_row);
    const int f0 = static_cast<int>(r - static_cast<long long>(b) *
                                           runs_per_row) * kMelRun;
    const int run = frames - f0 < kMelRun ? frames - f0 : kMelRun;
    // the two buffers alternate: a warp still on run k - 1 reads the other
    float* e = e2 + (k & 1) * kMelRun * stride;
    run_prologue<kMode>(src, mgc_max, mgc_min, e, stride, b, f0, run, frames,
                        mels, max_val, boost);
    __syncthreads();
    if (t >= run) continue;
    const float* er = e + t * stride;
    const long long row = static_cast<long long>(b) * frames + f0 + t;
    float* o = out + row * (bins + 1);
    for (int j0 = part * kMagChunk; j0 <= bins; j0 += kParts * kMagChunk) {
      float v[kMagChunk / 32];
#pragma unroll
      for (int u = 0; u < kMagChunk / 32; ++u) {
        const int j = j0 + lane + 32 * u;
        v[u] = j <= bins ? mag_value<kTaps>(j, er, hdr, wt, taps, bins,
                                            max_taps, tune, tune_mul, tune_add)
                         : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kMagChunk / 32; ++u) {
        const int j = j0 + lane + 32 * u;
        if (j <= bins) o[j] = v[u];
      }
    }
  }
}

template <int kMode, int kTaps>
int launch(const void* src, const float* mx, const float* mn, const int* first,
           const int* count, const float* taps, float* out, long long batch,
           int frames, int mels, int bins, int max_taps, float max_val,
           float boost, float tune_mul, float tune_add, size_t smem,
           int device, cudaStream_t s) {
  auto kernel = mel_to_mag_kernel<kMode, kTaps>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const int runs_per_row = (frames + kMelRun - 1) / kMelRun;
  const long long runs = batch * runs_per_row;
  long long blocks = resident_blocks(reinterpret_cast<const void*>(kernel),
                                     kMagThreads, smem, device);
  if (blocks > runs) blocks = runs;
  kernel<<<static_cast<unsigned>(blocks), kMagThreads, smem, s>>>(
      src, mx, mn, first, count, taps, out, frames, mels, bins, max_taps,
      max_val, boost, tune_mul, tune_add, runs_per_row, runs);
  return gomel_status();
}

// The taps' planes in shared memory where they fit (2 or 4 planes), else
// the first plane only.
template <int kMode>
int launch_mode(const void* src, const float* mx, const float* mn,
                const int* first, const int* count, const float* taps,
                float* out, long long batch, int frames, int mels, int bins,
                int max_taps, float max_val, float boost, float tune_mul,
                float tune_add, int device, cudaStream_t s) {
  const size_t base = mag_base_smem(mels, bins);
  const size_t plane = static_cast<size_t>(bins) * sizeof(float);
  if (base > kMagSmemMax || 2 * mels > 0xffff || max_taps > 0xffff) {
    return static_cast<int>(cudaErrorInvalidValue);  // the packed entry
  }
  if (max_taps <= 2 && base + 2 * plane <= kMagSmemMax) {
    return launch<kMode, 2>(src, mx, mn, first, count, taps, out, batch,
                            frames, mels, bins, max_taps, max_val, boost,
                            tune_mul, tune_add, base + 2 * plane, device, s);
  }
  if (max_taps <= 4 && base + 4 * plane <= kMagSmemMax) {
    return launch<kMode, 4>(src, mx, mn, first, count, taps, out, batch,
                            frames, mels, bins, max_taps, max_val, boost,
                            tune_mul, tune_add, base + 4 * plane, device, s);
  }
  return launch<kMode, 0>(src, mx, mn, first, count, taps, out, batch, frames,
                          mels, bins, max_taps, max_val, boost, tune_mul,
                          tune_add, base, device, s);
}

}  // namespace

// mode 0: src = log-mel float32 [batch, frames, mels, 2];
// mode 1: src = planes uint8 [batch, mels, frames, 2], mgc_max, mgc_min =
//   float32 [batch].
// first, count: int32 [bins]; taps: float32 [bins, max_taps] (bins = n/2);
// out: float32 [batch*frames, bins + 1].
GOMEL_API int gomel_mel_to_mag(int mode, const void* src, const void* mgc_max,
                               const void* mgc_min, const void* first,
                               const void* count, const void* taps, void* out,
                               long long batch, long long frames,
                               long long mels, long long bins,
                               long long max_taps, float max_val, float boost,
                               float tune_mul, float tune_add, int device,
                               void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mx = static_cast<const float*>(mgc_max);
  const float* mn = static_cast<const float*>(mgc_min);
  const int* f = static_cast<const int*>(first);
  const int* c = static_cast<const int*>(count);
  const float* w = static_cast<const float*>(taps);
  float* o = static_cast<float*>(out);
  const int fr = static_cast<int>(frames);
  const int m = static_cast<int>(mels);
  const int b = static_cast<int>(bins);
  const int t = static_cast<int>(max_taps);
  switch (mode) {
    case kFloat:
      return launch_mode<kFloat>(src, mx, mn, f, c, w, o, batch, fr, m, b, t,
                                 max_val, boost, tune_mul, tune_add, device,
                                 s);
    case kQuant8:
      return launch_mode<kQuant8>(src, mx, mn, f, c, w, o, batch, fr, m, b, t,
                                  max_val, boost, tune_mul, tune_add, device,
                                  s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
