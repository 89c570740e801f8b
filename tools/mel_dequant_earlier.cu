// The forms of KC (mel filterbank + log) and KL (dequantize_raw) that the
// port shipped before their Hopper redesign, and two other forms of KL, for
// tools/profile_mel.py's race and ablation. Built only by that tool, never
// into the port's library.
//
//   prof_old_mel_log          KC before: one block of 256 threads a frame,
//                             the frame's magnitudes copied to shared memory
//                             with 4-byte loads, each thread summing whole
//                             columns over [lo, hi) of the dense W_ext
//                             [bins, cols] (a warp's weight loads 1536 bytes
//                             apart), a second round of columns on half the
//                             threads.
//   prof_old_dequantize_raw   KL before: one element a thread in a
//                             grid-stride loop of 132 x 32 blocks, the
//                             channel by a 64-bit modulo, the extrema
//                             reloaded and their range recomputed each
//                             element.
//   prof_wide_dequantize_raw  KL with 16 bytes of input a thread: a scalar
//                             head to the first 16-byte aligned element,
//                             then 16 uint8 (8 uint16) a load and 4 (2)
//                             float4 stores a thread, a scalar tail.
//   prof_lut_dequantize_raw   the shipped KL's walk (quads of 4 elements)
//                             with uint8 values taken from a per-channel
//                             table of the 256 results, computed by the same
//                             rounded steps, so the bits are the division's.
#include <math.h>

#include "common.cuh"

namespace {

__global__ void old_mel_log_kernel(const float* __restrict__ mags,
                                   const float* __restrict__ w,
                                   const int* __restrict__ lo,
                                   const int* __restrict__ hi,
                                   float* __restrict__ out, int bins,
                                   int cols) {
  extern __shared__ float row[];
  const long long r = blockIdx.x;
  const float* src = mags + r * bins;
  for (int k = threadIdx.x; k < bins; k += blockDim.x) row[k] = src[k];
  __syncthreads();

  float* dst = out + r * cols;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float acc = 0.0f;
    const int end = hi[c];
    for (int k = lo[c]; k < end; ++k) {
      acc = fmaf(row[k], w[static_cast<long long>(k) * cols + c], acc);
    }
    acc = (acc < 1e-5f) ? 1e-5f : acc;
    dst[c] = logf(acc);
  }
}

template <typename T>
__global__ void old_dequantize_raw_kernel(const T* __restrict__ src,
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

__device__ __forceinline__ float dequant_value(float v, float max_val,
                                               float rng, float mn,
                                               int ihs_passes, float boost) {
  float x = __fadd_rn(__fmul_rn(__fdiv_rn(v, max_val), rng), mn);
  for (int p = 0; p < ihs_passes; ++p) x = sinhf(x);
  if (boost != 0.0f) x = __fadd_rn(x, boost);
  return x;
}

// The 16 bytes at p as 16 / sizeof(T) values.
template <typename T>
__device__ __forceinline__ void unpack16(const T* p, float* v) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (sizeof(T) == 1) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        v[4 * j + b] = static_cast<float>((w[j] >> (8 * b)) & 0xffu);
      }
    } else {
      v[2 * j] = static_cast<float>(w[j] & 0xffffu);
      v[2 * j + 1] = static_cast<float>(w[j] >> 16);
    }
  }
}

// ext_len 1 or 2; head: the scalar elements before the first 16-byte
// aligned one.
template <typename T, bool kVecStore>
__global__ void __launch_bounds__(256)
wide_dequantize_raw_kernel(const T* __restrict__ src,
                           const float* __restrict__ maxs,
                           const float* __restrict__ mins,
                           float* __restrict__ out, long long n,
                           long long head, int ext_len, float max_val,
                           int ihs_passes, float boost) {
  constexpr int kV = 16 / sizeof(T);
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long vectors = (n - head) / kV;
  const long long tail = head + vectors * kV;
  const int c0 = ext_len == 2 ? static_cast<int>(head & 1) : 0;
  const int c1 = ext_len == 2 ? 1 - c0 : 0;
  const float mn0 = mins[c0], mn1 = mins[c1];
  const float rg0 = __fsub_rn(maxs[c0], mn0);
  const float rg1 = __fsub_rn(maxs[c1], mn1);
  for (long long j = tid; j < vectors; j += stride) {
    const long long e = head + j * kV;
    float v[kV];
    unpack16<T>(src + e, v);
#pragma unroll
    for (int l = 0; l < kV; ++l) {
      v[l] = dequant_value(v[l], max_val, l & 1 ? rg1 : rg0,
                           l & 1 ? mn1 : mn0, ihs_passes, boost);
    }
#pragma unroll
    for (int q = 0; q < kV / 4; ++q) {
      if constexpr (kVecStore) {
        *reinterpret_cast<float4*>(out + e + 4 * q) =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      } else {
#pragma unroll
        for (int l = 0; l < 4; ++l) out[e + 4 * q + l] = v[4 * q + l];
      }
    }
  }
  const long long scalars = head + (n - tail);
  for (long long s = tid; s < scalars; s += stride) {
    const long long i = s < head ? s : tail + (s - head);
    const int c = ext_len == 2 ? static_cast<int>(i & 1) : 0;
    const float mn = mins[c];
    out[i] = dequant_value(static_cast<float>(src[i]), max_val,
                           __fsub_rn(maxs[c], mn), mn, ihs_passes, boost);
  }
}

// uint8, ext_len 1 or 2, the source 4-byte and the output 16-byte aligned:
// the shipped walk, values from the table.
__global__ void __launch_bounds__(256)
lut_dequantize_raw_kernel(const uint8_t* __restrict__ src,
                          const float* __restrict__ maxs,
                          const float* __restrict__ mins,
                          float* __restrict__ out, long long n, int ext_len,
                          float max_val, int ihs_passes, float boost) {
  __shared__ float lut[2][256];
  for (int e = threadIdx.x; e < 512; e += blockDim.x) {
    const int c = ext_len == 2 ? e >> 8 : 0;
    const float mn = mins[c];
    lut[e >> 8][e & 255] = dequant_value(static_cast<float>(e & 255), max_val,
                                         __fsub_rn(maxs[c], mn), mn,
                                         ihs_passes, boost);
  }
  __syncthreads();
  const float* t1 = lut[ext_len == 2 ? 1 : 0];
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long quads = n / 4;
  for (long long q0 = tid; q0 < quads; q0 += 4 * stride) {
    unsigned w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long q = q0 + u * stride;
      if (q < quads) w[u] = __ldg(reinterpret_cast<const unsigned*>(src) + q);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long q = q0 + u * stride;
      if (q < quads) {
        reinterpret_cast<float4*>(out)[q] = make_float4(
            lut[0][w[u] & 0xffu], t1[(w[u] >> 8) & 0xffu],
            lut[0][(w[u] >> 16) & 0xffu], t1[w[u] >> 24]);
      }
    }
  }
  for (long long i = 4 * quads + tid; i < n; i += stride) {
    out[i] = lut[ext_len == 2 ? static_cast<int>(i & 1) : 0][src[i]];
  }
}

}  // namespace

GOMEL_API int prof_old_mel_log(const void* mags, const void* w, const void* lo,
                               const void* hi, void* out, long long rows,
                               long long bins, long long cols, int device,
                               void* stream) {
  cudaSetDevice(device);
  const size_t smem = static_cast<size_t>(bins) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(old_mel_log_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  old_mel_log_kernel<<<static_cast<unsigned>(rows), 256, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mags), static_cast<const float*>(w),
      static_cast<const int*>(lo), static_cast<const int*>(hi),
      static_cast<float*>(out), static_cast<int>(bins),
      static_cast<int>(cols));
  return gomel_status();
}

GOMEL_API int prof_old_dequantize_raw(const void* src, const void* maxs,
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
    old_dequantize_raw_kernel<uint8_t><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const uint8_t*>(src), mx, mn, o, n, ext_len, max_val,
        ihs_passes, boost);
  } else if (bytes == 2) {
    old_dequantize_raw_kernel<uint16_t><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const uint16_t*>(src), mx, mn, o, n, ext_len, max_val,
        ihs_passes, boost);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return gomel_status();
}

// ext_len 1 or 2.
GOMEL_API int prof_wide_dequantize_raw(const void* src, const void* maxs,
                                       const void* mins, void* out,
                                       long long n, int bytes, int ext_len,
                                       float max_val, int ihs_passes,
                                       float boost, int device, void* stream) {
  cudaSetDevice(device);
  if (ext_len > 2 || (bytes != 1 && bytes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long head = ((16 - reinterpret_cast<uintptr_t>(src) % 16) % 16) / bytes;
  if (head > n) head = n;
  float* o = static_cast<float*>(out);
  const bool vec = aligned16(o + head);
  const long long need = ((n - head) / (16 / bytes) + 16 + 255) / 256;
  auto run = [&](auto kernel, const auto* p) {
    long long blocks = resident_blocks(reinterpret_cast<const void*>(kernel),
                                       256, 0, device);
    if (blocks > need) blocks = need;
    kernel<<<static_cast<unsigned>(blocks > 0 ? blocks : 1), 256, 0,
             static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<const float*>(maxs), static_cast<const float*>(mins),
        o, n, head, ext_len, max_val, ihs_passes, boost);
    return gomel_status();
  };
  if (bytes == 1) {
    const auto* p = static_cast<const uint8_t*>(src);
    return vec ? run(wide_dequantize_raw_kernel<uint8_t, true>, p)
               : run(wide_dequantize_raw_kernel<uint8_t, false>, p);
  }
  const auto* p = static_cast<const uint16_t*>(src);
  return vec ? run(wide_dequantize_raw_kernel<uint16_t, true>, p)
             : run(wide_dequantize_raw_kernel<uint16_t, false>, p);
}

// uint8 (bytes must be 1), ext_len 1 or 2, src 4-byte and out 16-byte
// aligned.
GOMEL_API int prof_lut_dequantize_raw(const void* src, const void* maxs,
                                      const void* mins, void* out, long long n,
                                      int bytes, int ext_len, float max_val,
                                      int ihs_passes, float boost, int device,
                                      void* stream) {
  cudaSetDevice(device);
  if (bytes != 1 || ext_len > 2 || reinterpret_cast<uintptr_t>(src) % 4 ||
      !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long blocks = resident_blocks(
      reinterpret_cast<const void*>(lut_dequantize_raw_kernel), 256, 0,
      device);
  const long long need = (n / 16 + 256) / 256;
  if (blocks > need) blocks = need;
  lut_dequantize_raw_kernel<<<static_cast<unsigned>(blocks > 0 ? blocks : 1),
                              256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const float*>(maxs),
      static_cast<const float*>(mins), static_cast<float*>(out), n, ext_len,
      max_val, ihs_passes, boost);
  return gomel_status();
}
