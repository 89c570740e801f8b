// KM: the shard epilogue of the frame-sharded synthesis.
//
// Replaces the halo add and what follows it in gomel_tpu/parallel/sharded.py
// (K17, K9, K11, K13 on a shard): _local_overlap_add's
// body.at[:halo].add(recv) (:229-234), the global window-sum normalisation
// and boost of sharded_phase_decode_fn (:503-508, with
// gomel_tpu/ops/istft.py:189 normalize_by_window_sum), the momentum step of
// sharded_griffin_lim_fn (:423-426) and the PCM-16 conversion the long-form
// file decodes run after it (gomel_tpu/ops/quantize.py:124).
//
// Input: the shard's un-normalised overlap-add sig_ext [B, chunk + halo]
// (KH without a window, or KK) and the tail recv [B, halo] its left
// neighbour's overlap-add spilled into it (null on shard 0: the open
// boundary). Every output sample j < chunk has one owner, so no atomics:
// t = sig_ext[j] + recv[j] for j < halo (one rounded add, the order of the
// JAX program), else sig_ext[j]. Then one of:
//   decode (table != null): the window sum at the sample's GLOBAL position
//     p = start + j of a signal of n_frames real frames, from KH's [taps,
//     hop] prefix table (overlap_add.cuh window_sum_lanes; 0 past the last
//     real frame's span), under the host threshold 0.5 * max of that window
//     sum (global, never per shard), with the three branches of
//     normalize_by_window_sum; then x boost when non-zero; float32 or PCM-16;
//   momentum (t_prev != null): c = t + m * (t - t_prev) rounded step by step,
//     writing c and t (KK's epilogue);
//   plain: t, float32 or PCM-16 (the final Griffin-Lim iteration).
// The float output y / c has a row stride out_stride >= chunk: the GL
// carry is written straight into the next iteration's extended buffer
// [B, chunk + halo], whose halo columns the caller fills from the right
// neighbour. Any non-finite output clears its row's finite flag.
//
// Design (overlap_add.cuh, the hop-row walk): the entry point splits
// ``start`` once into the global hop-row row0 = start / hop and column
// col0 = start % hop, for any start; the kernel walks global hop-rows
// row0 + r and columns c, and a sample's j = r * hop + c - col0 follows by
// adds, so no sample is divided. With no window sum to index (the
// Griffin-Lim modes) the rows are kOlaPlainRow samples wide. Vector path
// (the entry point's choice, overlap_add.cuh ola_vector: hop, ext_len,
// chunk, recv_stride, out_stride and col0 multiples of 4, every pointer
// 16-byte aligned; the CLI shapes): 4 adjacent
// samples a thread, float4 loads of sig_ext, recv and t_prev, float4 stores
// of y and t, one 8-byte store of 4 PCM-16 samples; a group of 4 never
// straddles a hop-row, the halo or the chunk's ends. Scalar path otherwise,
// with the same arithmetic. Hop-rows of the window sum's periodic middle take
// the table's last row, loaded once a column group; only the first and last
// taps - 1 hop-rows of the whole signal take window_sum_at's branches.
//
// The window sum equals the JAX program's per-shard masked overlap-add plus
// the halo (sharded.py:237-243) up to the order of summation: the JAX sum
// of a sample adds its K = ceil(n / hop) squared-window rows in frame
// order, split at a shard boundary into two partial sums; the table gives
// the prefix sums S[k] and full - S[k]. Each is a sum of at most K
// non-negative float32 terms, so the two differ by at most about 2 K ulp
// of the sum (K = 4 at n = 4096, hop = 1280), relative 5e-7.
//
// Bound: bytes. It reads sig_ext and recv and writes y (and t): at the
// 30-minute phase decode shard (16,875 frames of 1280 hop) 86 MB read and
// 86 MB (float32) or 43 MB (PCM-16) written per row, about 0.04 ms per
// shard at 3.35 TB/s. A sample costs a few dozen instructions (the division
// by the window sum is the largest), well under what the bytes allow.
#include <math.h>

#include "overlap_add.cuh"

namespace {

template <int kV>
__global__ void __launch_bounds__(kOlaMaxThreads) shard_epilogue_kernel(
    const float* __restrict__ sig_ext, long long ext_len,
    const float* __restrict__ recv, long long recv_stride, long long halo,
    const float* __restrict__ table, long long row0, int col0, long long rows,
    int n_frames, int taps, int hop, int short_form, float threshold,
    float boost, const float* __restrict__ t_prev, float momentum,
    float* __restrict__ out_f, long long out_stride,
    float* __restrict__ out_t, int16_t* __restrict__ out_pcm,
    int* __restrict__ finite, long long chunk) {
  OlaThread w;
  if (!ola_thread<kV>(hop, w)) return;
  const long long b = blockIdx.y;
  const float* sig = sig_ext + b * ext_len;
  const float* rv = recv == nullptr ? nullptr : recv + b * recv_stride;
  const long long rows_out = static_cast<long long>(n_frames) + taps - 1;
  const long long mid_lo = short_form ? 0 : taps - 1;
  const long long mid_hi = short_form ? 0 : n_frames;
  const long long j_step = w.step * hop;
  bool bad = false;
  for (int g = w.group; g < w.groups; g += blockDim.x) {
    const int c = g * kV;
    Lanes<kV> full = {};
    if (table != nullptr && mid_lo < mid_hi) {
      full = load_lanes<kV>(table + static_cast<long long>(taps - 1) * hop + c);
    }
    long long j = w.row * hop + c - col0;
    for (long long r = w.row; r < rows; r += w.step, j += j_step) {
      if (j < 0 || j >= chunk) continue;   // before col0, past the chunk
      Lanes<kV> t = load_lanes<kV>(sig + j);
      if (rv != nullptr && j < halo) {
        const Lanes<kV> h = load_lanes<kV>(rv + j);
#pragma unroll
        for (int l = 0; l < kV; ++l) t.v[l] = __fadd_rn(t.v[l], h.v[l]);
      }
      Lanes<kV> y = t;
      if (table != nullptr) {
        const long long i = row0 + r;
        Lanes<kV> ws = {};
        if (i < rows_out) {
          ws = window_sum_lanes<kV>(table, i, c, full, mid_lo, mid_hi,
                                    n_frames, taps, hop, short_form);
        }
#pragma unroll
        for (int l = 0; l < kV; ++l) {
          y.v[l] = normalize_sample(t.v[l], ws.v[l], threshold);
          if (boost != 0.0f) y.v[l] = __fmul_rn(y.v[l], boost);
        }
      }
      if (t_prev != nullptr) {
        const long long at = b * chunk + j;
        const Lanes<kV> tp = load_lanes<kV>(t_prev + at);
#pragma unroll
        for (int l = 0; l < kV; ++l) {
          y.v[l] = __fadd_rn(t.v[l],
                             __fmul_rn(momentum, __fsub_rn(t.v[l], tp.v[l])));
        }
        store_lanes<kV>(out_t + at, t);
      }
#pragma unroll
      for (int l = 0; l < kV; ++l) bad |= !isfinite(y.v[l]);
      if (out_f != nullptr) store_lanes<kV>(out_f + b * out_stride + j, y);
      if (out_pcm != nullptr) store_pcm16<kV>(out_pcm + b * chunk + j, y);
    }
  }
  if (bad) finite[b] = 0;
}

template <int kV>
int launch_shard_epilogue(const float* sig_ext, long long ext_len,
                          const float* recv, long long recv_stride,
                          long long halo, const float* table, long long row0,
                          int col0, int n_frames, int taps, int hop,
                          int short_form, float threshold, float boost,
                          const float* t_prev, float momentum, float* out_f,
                          long long out_stride, float* out_t, int16_t* out_pcm,
                          int* finite, long long batch, long long chunk,
                          int device, cudaStream_t s) {
  const long long rows = (col0 + chunk + hop - 1) / hop;
  const int groups = hop / kV;
  const int threads = ola_threads(groups);
  const unsigned blocks = ola_blocks(shard_epilogue_kernel<kV>, threads,
                                     groups, rows, batch, device);
  shard_epilogue_kernel<kV><<<dim3(blocks, static_cast<unsigned>(batch)),
                              threads, 0, s>>>(
      sig_ext, ext_len, recv, recv_stride, halo, table, row0, col0, rows,
      n_frames, taps, hop, short_form, threshold, boost, t_prev, momentum,
      out_f, out_stride, out_t, out_pcm, finite, chunk);
  return gomel_status();
}

}  // namespace

// sig_ext: float32 [batch, ext_len]; recv: float32 rows of halo samples
// with row stride recv_stride, or null; table: float32 [taps, hop] prefix
// table (taps = ceil(n / hop)) or null; start: the global position of the
// shard's first sample (with a table); t_prev: float32 [batch, chunk] or
// null (with out_t float32 [batch, chunk]); out_f: float32 rows of row
// stride out_stride, or null; out_pcm: int16 [batch, chunk] or null;
// finite: int32 [batch], set to 1 by the caller. start is split once into
// the hop-row row0 = start / hop and the column col0 = start % hop; without
// a table hop and start are ignored and the walk's rows are kOlaPlainRow
// wide from 0. The vector path (4 samples a thread) when hop, ext_len,
// chunk, recv_stride, out_stride and col0 are multiples of 4 and every
// pointer is 16-byte aligned, else the scalar path. batch <= 65535.
GOMEL_API int gomel_shard_epilogue(
    const void* sig_ext, long long ext_len, const void* recv,
    long long recv_stride, long long halo, const void* table, long long start,
    long long n_frames, long long hop, long long taps, int short_form,
    float threshold, float boost, const void* t_prev, float momentum,
    void* out_f, long long out_stride, void* out_t, void* out_pcm,
    void* finite, long long batch, long long chunk, int device, void* stream) {
  cudaSetDevice(device);
  if (table == nullptr) {
    hop = kOlaPlainRow;
    start = 0;
  }
  if (hop < 1 || start < 0 || chunk < 1 || batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long row0 = start / hop, col0 = start % hop;
  const float* sig = static_cast<const float*>(sig_ext);
  const float* rv = static_cast<const float*>(recv);
  const float* tb = static_cast<const float*>(table);
  const float* tp = static_cast<const float*>(t_prev);
  float* of = static_cast<float*>(out_f);
  float* ot = static_cast<float*>(out_t);
  int16_t* op = static_cast<int16_t*>(out_pcm);
  int* fin = static_cast<int*>(finite);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int f = static_cast<int>(n_frames), k = static_cast<int>(taps);
  const int h = static_cast<int>(hop), c0 = static_cast<int>(col0);
  if (ola_vector({hop, ext_len, chunk, recv_stride, out_stride, col0},
                 {sig, rv, tb, tp, of, ot, op})) {
    return launch_shard_epilogue<4>(sig, ext_len, rv, recv_stride, halo, tb,
                                    row0, c0, f, k, h, short_form, threshold,
                                    boost, tp, momentum, of, out_stride, ot,
                                    op, fin, batch, chunk, device, s);
  }
  return launch_shard_epilogue<1>(sig, ext_len, rv, recv_stride, halo, tb,
                                  row0, c0, f, k, h, short_form, threshold,
                                  boost, tp, momentum, of, out_stride, ot, op,
                                  fin, batch, chunk, device, s);
}
