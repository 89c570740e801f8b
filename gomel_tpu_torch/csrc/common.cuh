// Shared declarations of the port's hand-written kernels.
//
// Every kernel is reached through a plain C entry point (no PyTorch headers),
// loaded with ctypes by gomel_tpu_torch/ops/_cuda.py. Each entry point:
//   - takes the CUDA device index and PyTorch's current stream as its last
//     two arguments, and launches on that stream without synchronising;
//   - allocates nothing: the Python wrapper allocates outputs and scratch;
//   - returns cudaGetLastError(), which the wrapper turns into an exception
//     (a launch refused for its configuration never runs, and a later
//     synchronise would not report it).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>
#include <vector>

#define GOMEL_API extern "C" __attribute__((visibility("default")))

static inline int gomel_status() { return static_cast<int>(cudaGetLastError()); }

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// SMs x the kernel's resident blocks an SM at ``threads`` a block and
// ``smem`` bytes of dynamic shared memory: the grid of a persistent launch.
// Asked of the runtime once for each (device, kernel, block size, shared
// memory) and kept: none changes, and the two queries would cost every
// launch microseconds. A failed query is not kept: its error stays for the
// launch's status.
inline long long resident_blocks(const void* kernel, int threads, size_t smem,
                                 int device) {
  struct Seen {
    const void* kernel;
    int threads, device;
    size_t smem;
    long long blocks;
  };
  static std::mutex lock;
  static std::vector<Seen> seen;
  const std::lock_guard<std::mutex> hold(lock);
  for (const Seen& s : seen) {
    if (s.kernel == kernel && s.threads == threads && s.device == device &&
        s.smem == smem) {
      return s.blocks;
    }
  }
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess ||
      sms < 1 || per_sm < 1) {
    return 1;
  }
  const long long blocks = static_cast<long long>(sms) * per_sm;
  seen.push_back({kernel, threads, device, smem, blocks});
  return blocks;
}

// A PCM-16 divisor (KA and the fused KB + KC's int16 frames): v / s as the
// JAX program divides, correctly rounded. When s is a power of two in
// [2^-100, 2^100] (every scale the port passes: 32768, 65536) the quotient
// is the product by 1 / s, the same exact value, so the division's
// instruction sequence is skipped with the same bits.
struct PcmScale {
  float s;
  float inv;   // 1 / s, or 0 when s is not such a power of two
  float bias;  // -kPcmBias / s when inv is not 0 (exact)
};

// An int16 sample s as a float without the conversion pipe (I2F runs at a
// quarter of the float32 rate on Hopper, and a frame kernel converts each
// sample n / hop times): its 16 bits, offset by 2^15, are the low mantissa
// bits of the float 2^23 + 2^15 + s, exactly (one LOP3), whose difference
// from kPcmBias is s, exactly.
constexpr float kPcmBias = 8421376.0f;  // 2^23 + 2^15

__host__ __device__ __forceinline__ PcmScale pcm_scale(float s) {
  unsigned b;
  memcpy(&b, &s, sizeof b);
  const unsigned e = (b >> 23) & 0xffu;
  const bool pow2 = (b & 0x7fffffu) == 0u && e >= 27u && e <= 227u;
  const unsigned ib = (b & 0x80000000u) | ((254u - e) << 23);
  float inv = 0.0f;
  if (pow2) memcpy(&inv, &ib, sizeof inv);
  return {s, inv, -kPcmBias * inv};
}

// 2^23 + 2^15 + s for the int16 s in the low 16 bits of h.
__device__ __forceinline__ float pcm_biased(unsigned h) {
  return __uint_as_float((h & 0xffffu) ^ 0x4b008000u);
}

// s itself, exactly.
__device__ __forceinline__ float pcm_value(unsigned h) {
  return __fsub_rn(pcm_biased(h), kPcmBias);
}

// v / d.s, v a float (the stereo mean): kPow2 when d.inv is not 0.
template <bool kPow2>
__device__ __forceinline__ float pcm_div(float v, PcmScale d) {
  if constexpr (kPow2) {
    return __fmul_rn(v, d.inv);
  } else {
    return __fdiv_rn(v, d.s);
  }
}

// s / d.s from the biased float b of s: one FMA for a power of two, whose
// exact result b / s - kPcmBias / s = s / s is representable, so it is that
// quotient's bits; else the exact difference, then the division.
template <bool kPow2>
__device__ __forceinline__ float pcm_div_biased(float b, PcmScale d) {
  if constexpr (kPow2) {
    return __fmaf_rn(b, d.inv, d.bias);
  } else {
    return __fdiv_rn(__fsub_rn(b, kPcmBias), d.s);
  }
}
