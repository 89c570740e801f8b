// The form of KP (the Griffin-Lim start's Threefry-2x32 draw) that the port
// shipped before its Hopper redesign, for tools/profile_prng.py's race. Built
// only by that tool, never into the port's library. The code is
// gomel_tpu_torch/csrc/threefry.cu as it was, the entry point renamed:
//
//   prof_old_threefry_uniform  one sample a thread a loop trip (one chain in
//                              flight, one 4-byte store), 64-bit sample
//                              indices, rotations as funnel shifts (SHF on
//                              the integer pipe), a grid capped at a fixed
//                              132 x 32 blocks shared by the rows.
#include "common.cuh"

namespace {

__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1, int r0,
                                            int r1, int r2, int r3) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, r0); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r1); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r2); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r3); x1 ^= x0;
}

__global__ void threefry_uniform_kernel(const uint32_t* __restrict__ keys,
                                        float* __restrict__ out, long long rows,
                                        long long per_key) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint32_t k0 = keys[2 * r], k1 = keys[2 * r + 1];
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    float* row = out + r * per_key;
    for (long long j = first; j < per_key; j += stride) {
      uint32_t x0 = k0;                              // counter high word 0
      uint32_t x1 = static_cast<uint32_t>(j) + k1;
      four_rounds(x0, x1, 13, 15, 26, 6);
      x0 += k1; x1 += k2 + 1u;
      four_rounds(x0, x1, 17, 29, 16, 24);
      x0 += k2; x1 += k0 + 2u;
      four_rounds(x0, x1, 13, 15, 26, 6);
      x0 += k0; x1 += k1 + 3u;
      four_rounds(x0, x1, 17, 29, 16, 24);
      x0 += k1; x1 += k2 + 4u;
      four_rounds(x0, x1, 13, 15, 26, 6);
      x0 += k2; x1 += k0 + 5u;
      const uint32_t bits = x0 ^ x1;
      row[j] = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
    }
  }
}

}  // namespace

// keys: uint32 [rows, 2]; out: float32 [rows, per_key], per_key < 2^32.
GOMEL_API int prof_old_threefry_uniform(const void* keys, void* out,
                                        long long rows, long long per_key,
                                        int device, void* stream) {
  cudaSetDevice(device);
  const int threads = 256;
  long long bx = (per_key + threads - 1) / threads;
  const long long by = rows < 65535 ? rows : 65535;
  // enough blocks to fill the card, shared among the rows
  long long cap = (132 * 32 + by - 1) / by;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  threefry_uniform_kernel<<<grid, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<float*>(out), rows,
      per_key);
  return gomel_status();
}
