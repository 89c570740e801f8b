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
// Bound: bytes. It reads n (or 2n) bytes and writes 4n: at one shard of the
// 30-minute phase decode (51.8 M uint8) 0.0774 ms at 3.35 TB/s. What held
// the one-element-a-thread form at 46% of that: a warp's read was one
// 32-byte sector, about 2 KB in flight an SM. A form with 16 bytes of input
// a thread and 4 float4 stores kept that time (tools/profile_mel.py, the
// "wide" form): a warp's store instruction then touched 32 lines 64 bytes
// apart. Design: every warp access is contiguous. A thread takes quads of
// 4 elements (one 4-byte load of uint8 or 8-byte load of uint16, one float4
// store, so a warp loads 128 or 256 contiguous bytes and stores 512), 4
// quads a grid stride apart at once, so 16 or 32 bytes of loads are in
// flight a thread. Element 4q + l has channel l % 2, so the two channels'
// constants sit in registers (no modulo; ext_len 1 is two equal channels).
// A source not aligned to the quad's load width takes 4 narrow loads a
// quad; the elements after the last quad, and every element when ext_len
// exceeds 2, go one a thread. The grid is the card's resident blocks (SMs x
// blocks an SM, asked once per device), each walking quads by its stride.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kDequantThreads = 256;
constexpr int kDequantUnroll = 4;  // quads a thread has in flight

__device__ __forceinline__ float dequant(float v, float max_val, float rng,
                                         float mn, int ihs_passes,
                                         float boost) {
  float x = __fadd_rn(__fmul_rn(__fdiv_rn(v, max_val), rng), mn);
  for (int p = 0; p < ihs_passes; ++p) x = sinhf(x);
  if (boost != 0.0f) x = __fadd_rn(x, boost);
  return x;
}

// Quad q (elements 4q .. 4q + 3) as 4 values: one load when kVecLoad (the
// source aligned to 4 elements), else 4.
template <typename T, bool kVecLoad>
__device__ __forceinline__ float4 load_quad(const T* __restrict__ src,
                                            long long q) {
  if constexpr (!kVecLoad) {
    const T* p = src + 4 * q;
    return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  } else if constexpr (sizeof(T) == 1) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(src) + q);
    return make_float4(w & 0xffu, (w >> 8) & 0xffu, (w >> 16) & 0xffu,
                       w >> 24);
  } else {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(src) + q);
    return make_float4(w.x & 0xffffu, w.x >> 16, w.y & 0xffffu, w.y >> 16);
  }
}

// quads: the elements 0 .. 4 quads - 1 go by quads (0 when ext_len > 2 or
// the output is not 16-byte aligned); the rest one a thread.
template <typename T, bool kVecLoad>
__global__ void __launch_bounds__(kDequantThreads)
dequantize_raw_kernel(const T* __restrict__ src,
                      const float* __restrict__ maxs,
                      const float* __restrict__ mins, float* __restrict__ out,
                      long long n, long long quads, int ext_len, float max_val,
                      int ihs_passes, float boost) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  if (quads > 0) {
    const int c1 = ext_len == 2 ? 1 : 0;  // the odd lanes' channel
    const float mn0 = mins[0], mn1 = mins[c1];
    const float rg0 = __fsub_rn(maxs[0], mn0);
    const float rg1 = __fsub_rn(maxs[c1], mn1);
    for (long long q0 = tid; q0 < quads; q0 += kDequantUnroll * stride) {
      float4 v[kDequantUnroll];
#pragma unroll
      for (int u = 0; u < kDequantUnroll; ++u) {
        const long long q = q0 + u * stride;
        if (q < quads) v[u] = load_quad<T, kVecLoad>(src, q);
      }
#pragma unroll
      for (int u = 0; u < kDequantUnroll; ++u) {
        const long long q = q0 + u * stride;
        if (q < quads) {
          reinterpret_cast<float4*>(out)[q] = make_float4(
              dequant(v[u].x, max_val, rg0, mn0, ihs_passes, boost),
              dequant(v[u].y, max_val, rg1, mn1, ihs_passes, boost),
              dequant(v[u].z, max_val, rg0, mn0, ihs_passes, boost),
              dequant(v[u].w, max_val, rg1, mn1, ihs_passes, boost));
        }
      }
    }
  }
  // the elements after the last quad, one a thread
  for (long long i = 4 * quads + tid; i < n; i += stride) {
    const int c = ext_len == 1   ? 0
                  : ext_len == 2 ? static_cast<int>(i & 1)
                                 : static_cast<int>(i % ext_len);
    const float mn = mins[c];
    out[i] = dequant(static_cast<float>(src[i]), max_val,
                     __fsub_rn(maxs[c], mn), mn, ihs_passes, boost);
  }
}

template <typename T>
int launch_dequantize(const T* src, const float* maxs, const float* mins,
                      float* out, long long n, int ext_len, float max_val,
                      int ihs_passes, float boost, int device,
                      cudaStream_t s) {
  const long long quads = ext_len <= 2 && aligned16(out) ? n / 4 : 0;
  const bool vec_load = reinterpret_cast<uintptr_t>(src) % (4 * sizeof(T)) == 0;
  auto kernel = vec_load ? dequantize_raw_kernel<T, true>
                         : dequantize_raw_kernel<T, false>;
  long long blocks = resident_blocks(reinterpret_cast<const void*>(kernel),
                                     kDequantThreads, 0, device);
  const long long items = quads > 0 ? (quads + kDequantUnroll - 1) /
                                          kDequantUnroll + (n - 4 * quads)
                                    : n;
  const long long need = (items + kDequantThreads - 1) / kDequantThreads;
  if (blocks > need) blocks = need;
  kernel<<<static_cast<unsigned>(blocks > 0 ? blocks : 1), kDequantThreads, 0,
           s>>>(src, maxs, mins, out, n, quads, ext_len, max_val, ihs_passes,
                boost);
  return gomel_status();
}

}  // namespace

// src: uint8 (bytes = 1) or uint16 (bytes = 2) [n], any element-aligned
// start; maxs, mins: float32 [ext_len]; out: float32 [n].
GOMEL_API int gomel_dequantize_raw(const void* src, const void* maxs,
                                   const void* mins, void* out, long long n,
                                   int bytes, int ext_len, float max_val,
                                   int ihs_passes, float boost, int device,
                                   void* stream) {
  cudaSetDevice(device);
  const auto s = static_cast<cudaStream_t>(stream);
  const float* mx = static_cast<const float*>(maxs);
  const float* mn = static_cast<const float*>(mins);
  float* o = static_cast<float*>(out);
  if (bytes == 1) {
    return launch_dequantize(static_cast<const uint8_t*>(src), mx, mn, o, n,
                             ext_len, max_val, ihs_passes, boost, device, s);
  }
  if (bytes == 2) {
    return launch_dequantize(static_cast<const uint16_t*>(src), mx, mn, o, n,
                             ext_len, max_val, ihs_passes, boost, device, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
