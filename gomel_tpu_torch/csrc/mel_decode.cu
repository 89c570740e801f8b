// KI: mel decode front end — log-mel (or quantized PNG planes) to the fixed
// Griffin-Lim magnitudes mag_half [B*F, n/2 + 1].
//
// Replaces gomel_tpu/ops/quantize.py:78 dequantize_mel_plane and :225
// dequantize_mel_plane_batch (K7's mel form), the log-domain volume boost of
// gomel_tpu/pipelines/mel.py:152-154, gomel_tpu/ops/mel_ops.py:152
// mel_to_linear (K15: exp -> undomel matmul -> (v - add) / mul) and
// gomel_tpu/ops/griffinlim.py:90 griffin_lim_magnitudes (K13's magnitudes).
// One thread block per frame. Its source is one of:
//   kFloat   log-mel [B, F, M, 2] float32;
//   kQuant8  PNG planes [B, M, F, 2] uint8 with per-row global extrema
//            mgc_max, mgc_min [B] float32 (the towav device-quantize path).
// Prologue: each of the frame's 2M values is dequantized once, in the JAX
// order (v / max_val) * (max - min) + min with each step rounded on its own
// (__fdiv_rn / __fmul_rn / __fadd_rn, as KG's dequantize), then + boost as a
// separate rounding when the boost is non-zero, then expf; the 2M results go
// to shared memory.
// Body: U = inverse_mel_weights [n/2, M] is banded, each bin drawing on one
// contiguous run of mels (core/filterbank.py), so the host builds a float32
// table of (first mel, tap count, taps) per bin and the kernel sums only
// those terms in ascending mel order (fmaf), instead of the dense product:
// at n = 4096, M = 192, at most 2 taps a bin, 4 K multiply-adds per frame
// instead of 786 K. The skipped terms are exact zeros.
// Outputs: channel 0 for bins 0..n/2-1 and channel 1 of bin n/2-1 as bin
// n/2 (griffin_lim_magnitudes), then (v - tune_add) / tune_mul (a true
// division; with (mul, add) = (1, 0) it is the identity, as the JAX op's
// skipped branch) and fabsf.
//
// Bound: the output, 8 KB per frame (18 MB at the bench shape's 2 x 1122
// frames; ~5.5 us at 3.35 TB/s). The uint8 plane read is strided by F (each
// frame's column of the [M, F, 2] image is 2 bytes per row, rows F*2 bytes
// apart), as KG's is: uncoalesced, but only 768 bytes a frame.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kFloat = 0;
constexpr int kQuant8 = 1;

template <int kMode>
__global__ void mel_to_mag_kernel(const void* __restrict__ src,
                                  const float* __restrict__ mgc_max,
                                  const float* __restrict__ mgc_min,
                                  const int* __restrict__ first,
                                  const int* __restrict__ count,
                                  const float* __restrict__ taps,
                                  float* __restrict__ out, int frames,
                                  int mels, int bins, int max_taps,
                                  float max_val, float boost, float tune_mul,
                                  float tune_add) {
  extern __shared__ float e[];  // [mels][2]: exp of the frame's log-mel
  const long long frame = blockIdx.x;
  const long long bi = frame / frames;
  const long long fi = frame - bi * frames;
  float mn = 0.0f;
  float rng = 0.0f;
  if constexpr (kMode == kQuant8) {
    mn = mgc_min[bi];
    rng = __fsub_rn(mgc_max[bi], mn);  // rounded to float32 first, as in JAX
  }
  for (int j = threadIdx.x; j < 2 * mels; j += blockDim.x) {
    float v;
    if constexpr (kMode == kFloat) {
      v = static_cast<const float*>(src)[frame * 2 * mels + j];
    } else {
      const long long m = j >> 1;
      const unsigned char q = static_cast<const unsigned char*>(
          src)[((bi * mels + m) * frames + fi) * 2 + (j & 1)];
      v = __fadd_rn(__fmul_rn(__fdiv_rn(static_cast<float>(q), max_val), rng),
                    mn);
    }
    if (boost != 0.0f) v = __fadd_rn(v, boost);
    e[j] = expf(v);
  }
  __syncthreads();

  float* dst = out + frame * (bins + 1);
  for (int k = threadIdx.x; k <= bins; k += blockDim.x) {
    const int row = k < bins ? k : bins - 1;
    const int c = k < bins ? 0 : 1;
    const int f0 = first[row];
    const int cnt = count[row];
    const float* w = taps + static_cast<long long>(row) * max_taps;
    float acc = 0.0f;
    for (int t = 0; t < cnt; ++t) acc = fmaf(w[t], e[2 * (f0 + t) + c], acc);
    dst[k] = fabsf(__fdiv_rn(__fsub_rn(acc, tune_add), tune_mul));
  }
}

template <int kMode>
int launch(const void* src, const float* mx, const float* mn, const int* first,
           const int* count, const float* taps, float* out, long long blocks,
           int frames, int mels, int bins, int max_taps, float max_val,
           float boost, float tune_mul, float tune_add, cudaStream_t s) {
  const size_t smem = 2 * static_cast<size_t>(mels) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(mel_to_mag_kernel<kMode>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  mel_to_mag_kernel<kMode><<<static_cast<unsigned>(blocks), 256, smem, s>>>(
      src, mx, mn, first, count, taps, out, frames, mels, bins, max_taps,
      max_val, boost, tune_mul, tune_add);
  return gomel_status();
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
  const long long blocks = batch * frames;
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
      return launch<kFloat>(src, mx, mn, f, c, w, o, blocks, fr, m, b, t,
                            max_val, boost, tune_mul, tune_add, s);
    case kQuant8:
      return launch<kQuant8>(src, mx, mn, f, c, w, o, blocks, fr, m, b, t,
                             max_val, boost, tune_mul, tune_add, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
