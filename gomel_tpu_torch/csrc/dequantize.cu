// KL: dequantize_raw, integer PNG planes to float32, elementwise.
//
// Replaces gomel_tpu/ops/quantize.py:88 dequantize_raw (K7), the
// de-quantization of the long-form file decodes
// (gomel_tpu/pipelines/longform.py:307-311, :487-492): a uint8 or uint16
// array [n] (the frame-padded planes [B, F_pad, nf|M, 2]) to float32 [n]:
//   s = v / max_val, s = s * (max - min) + min, sinhf x ihs_passes,
//   s = s + boost when boost != 0,
// in the JAX program's order (quantize.py:95-101), each step rounded on its
// own (__fdiv_rn / __fmul_rn / __fadd_rn, so nvcc forms no FMA and does not
// turn the division into a reciprocal multiply). The extrema broadcast over
// the trailing axis: ext_len = 2 per-channel pairs for phase planes
// (element i takes pair i % 2), ext_len = 1 one scalar pair for mel. The
// range (max - min) is rounded to float32 first, as in the JAX program.
// Without IHS the result equals the plain version bit for bit.
//
// Bound: bytes. It reads n (or 2n) bytes and writes 4n: at the 30-minute
// phase file (67,500 frames x 1536 bins x 2) 207 MB in, 829 MB out, about
// 0.31 ms at 3.35 TB/s. One element per thread in a grid-stride loop, so
// the loads and stores of a warp are contiguous. Fusing KL into the
// prologue of KG or KI (as the single-file decodes do) is later work.
#include <math.h>

#include "common.cuh"

namespace {

template <typename T>
__global__ void dequantize_raw_kernel(const T* __restrict__ src,
                                      const float* __restrict__ maxs,
                                      const float* __restrict__ mins,
                                      float* __restrict__ out, long long n,
                                      int ext_len, float max_val,
                                      int ihs_passes, float boost) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = ext_len == 1 ? 0 : static_cast<int>(i % ext_len);
    const float mn = mins[c];
    const float rng = __fsub_rn(maxs[c], mn);
    float x = __fadd_rn(
        __fmul_rn(__fdiv_rn(static_cast<float>(src[i]), max_val), rng), mn);
    for (int p = 0; p < ihs_passes; ++p) x = sinhf(x);
    if (boost != 0.0f) x = __fadd_rn(x, boost);
    out[i] = x;
  }
}

}  // namespace

// src: uint8 (bytes = 1) or uint16 (bytes = 2) [n]; maxs, mins: float32
// [ext_len]; out: float32 [n].
GOMEL_API int gomel_dequantize_raw(const void* src, const void* maxs,
                                   const void* mins, void* out, long long n,
                                   int bytes, int ext_len, float max_val,
                                   int ihs_passes, float boost, int device,
                                   void* stream) {
  cudaSetDevice(device);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mx = static_cast<const float*>(maxs);
  const float* mn = static_cast<const float*>(mins);
  float* o = static_cast<float*>(out);
  if (bytes == 1) {
    dequantize_raw_kernel<uint8_t><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const uint8_t*>(src), mx, mn, o, n, ext_len, max_val,
        ihs_passes, boost);
  } else if (bytes == 2) {
    dequantize_raw_kernel<uint16_t><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const uint16_t*>(src), mx, mn, o, n, ext_len, max_val,
        ihs_passes, boost);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return gomel_status();
}
