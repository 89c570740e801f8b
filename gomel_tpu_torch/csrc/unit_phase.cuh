// The Griffin-Lim projection of one bin, shared by KJ (griffinlim.cu) and
// KN's projection epilogue (dft_mm.cu).
#pragma once

#include <cuda_runtime.h>

// mag * (re, im) / |(re, im)|, or (mag, 0) where |(re, im)| is 0: the unit
// phase with angle 0 -> 1 and 1/a times, not a division
// (gomel_tpu/ops/griffinlim.py:177-181), each step rounded as the JAX
// program rounds it (no FMA).
__device__ __forceinline__ float2 project_bin(float2 x, float mag) {
  const float a =
      __fsqrt_rn(__fadd_rn(__fmul_rn(x.x, x.x), __fmul_rn(x.y, x.y)));
  const float inv = a > 0.0f ? __fdiv_rn(1.0f, a) : 0.0f;
  const float ur = a > 0.0f ? __fmul_rn(x.x, inv) : 1.0f;
  const float ui = __fmul_rn(x.y, inv);
  return make_float2(__fmul_rn(mag, ur), __fmul_rn(mag, ui));
}
