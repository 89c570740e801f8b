// KP: Threefry-2x32 uniform draw, the Griffin-Lim start made where it is used.
//
// Replaces the device draws of the JAX package: gomel_tpu/ops/griffinlim.py:144
// (jax.random.uniform(key, (out_len,))), gomel_tpu/parallel/sharded.py:308-316
// (one folded key per shard, [b_loc, chunk]) and gomel_tpu/parallel/batch.py:
// 201-210 (one split key per row under vmap). It gives JAX's bits: the
// counter-based Threefry-2x32 of Salmon, Moraes, Dror and Shaw (SC'11), 20
// rounds, under JAX's partitionable rule, where sample j of a key is ONE
// block of counter (j >> 32, j & 0xffffffff), its 32 random bits are x0 ^ x1
// of that block, and the float32 is bitcast((bits >> 9) | 0x3F800000) - 1.
// The wrapper (ops/prng.py) refuses a key that would draw 2^32 samples or
// more, so the counter's high word is 0 here.
//
// One launch fills out[R, L] from a table of R keys: row r, sample j uses key
// r and counter j. R = 1 is a single-key draw of any shape, flattened.
//
// Bound: operations. A sample costs 75 integer instructions (20 rounds of
// add, funnel shift, xor; 12 key-schedule adds; xor, shift, or) and one
// float subtraction for 4 bytes written. The compiler spreads them over both
// pipes (the adds as IMAD.IADD on the FMA pipe, LOP3 and SHF on the integer
// pipe: tools/sass_opcodes.py), so the ceiling is the card's dispatch rate, 128
// lanes an SM a clock: at the bench shape (2 x 1,438,976) 6.4 us of
// instructions against 3.4 us of stores. So nothing is staged: a thread keeps
// a sample in registers from counter to store, the key schedule is hoisted
// out of the sample loop, rotations are single funnel shifts, and a warp's
// stores are 128 contiguous bytes. blockIdx.y walks the rows, so no 64-bit
// division finds a sample's row.
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
GOMEL_API int gomel_threefry_uniform(const void* keys, void* out,
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
