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
// more, so the counter's high word is 0 and every in-row index is 32 bits.
//
// One launch fills out[R, L] from a table of R keys: row r, sample j uses key
// r and counter j. R = 1 is a single-key draw of any shape, flattened.
//
// Bound: operations. A sample costs 75 integer instructions (20 rounds of
// add, rotate, xor; 12 key-schedule adds; xor, shift, or) and one float
// subtraction for 4 bytes written: at the bench shape (2 x 1,438,976) 6.4 us
// of instructions at the card's dispatch rate against 3.4 us of stores. The
// card's pipes are not alike: the compiler puts the round's add on the FMA
// pipe (IMAD.IADD) and its funnel shift and xor on the integer pipe, which
// is half the dispatch width (tools/sass_opcodes.py), so the integer pipe's
// 40 shifts and xors a sample are the practical ceiling (about 7 us at the
// bench shape). The design keeps everything else off that pipe:
//   - the key injections are x * one + k with a 1 passed at launch, which
//     the compiler cannot fold: IMAD on the FMA pipe, where x + k would be
//     IADD3 on the integer pipe (7-8% of the time, tools/profile_prng.py's
//     int_adds build); the float's exponent is added, not ORed, to the
//     shifted bits (disjoint bits: the same value);
//   - each thread draws kSamples consecutive samples of a row at once:
//     independent chains for the scheduler to interleave, and one 16-byte
//     store where the row's start is 16-byte aligned; the samples before the
//     first 16-byte boundary of a row (any per_key % 4 leaves rows
//     unaligned) and after its last whole group go one a thread;
//   - the loop's counters and indices are 32-bit, and blockIdx.y walks the
//     rows (a 64-bit row offset once a row), so no division finds a sample;
//   - the grid is the card's resident blocks (common.cuh resident_blocks)
//     shared by the rows, or fewer where a row has less work: one wave, the
//     same number of blocks on every SM, each thread's trips a grid
//     stride apart.
// Rotating by the 64-bit product x * 2^r (IMAD.WIDE.U32, the FMA pipe; lo |
// hi and the xor one LOP3) takes one integer-pipe instruction a round and
// not two, but was 1.6-1.7x slower on the card (tools/profile_prng.py, the
// "wide" build): the wide multiply does not run at the FMA pipe's full rate.
#include "common.cuh"

namespace {

constexpr int kThreefryThreads = 256;
constexpr int kSamples = 4;  // consecutive samples a thread draws at once
constexpr unsigned kParity = 0x1BD11BDAu;

// Rotation i of a block of four rounds (i + 4 in odd blocks): 13, 15, 26, 6,
// then 17, 29, 16, 24
__host__ __device__ constexpr int rotate_amount(int i) {
  constexpr int kEven[4] = {13, 15, 26, 6};
  constexpr int kOdd[4] = {17, 29, 16, 24};
  return i < 4 ? kEven[i] : kOdd[i - 4];
}

// Round i % 4 of a block of four rounds, rotation i, on n chains:
// x0 += x1; x1 = rotl(x1, rotate_amount(i)) ^ x0
template <int n, int i>
__device__ __forceinline__ void round_n(uint32_t (&x0)[n], uint32_t (&x1)[n]) {
#pragma unroll
  for (int u = 0; u < n; ++u) {
    x0[u] += x1[u];
    x1[u] = __funnelshift_l(x1[u], x1[u], rotate_amount(i)) ^ x0[u];
  }
}

template <int n, int odd>
__device__ __forceinline__ void four_rounds(uint32_t (&x0)[n],
                                            uint32_t (&x1)[n]) {
  round_n<n, 4 * odd>(x0, x1);
  round_n<n, 4 * odd + 1>(x0, x1);
  round_n<n, 4 * odd + 2>(x0, x1);
  round_n<n, 4 * odd + 3>(x0, x1);
}

// x0 += a, x1 += b, as multiply-adds by ``one`` (1, unknown to the
// compiler): the FMA pipe's IMAD, not the integer pipe's IADD3
template <int n>
__device__ __forceinline__ void inject(uint32_t (&x0)[n], uint32_t (&x1)[n],
                                       uint32_t a, uint32_t b, uint32_t one) {
#pragma unroll
  for (int u = 0; u < n; ++u) {
    x0[u] = x0[u] * one + a;
    x1[u] = x1[u] * one + b;
  }
}

// Samples j0 .. j0 + n - 1 of key (k0, k1), as floats in [0, 1).
template <int n>
__device__ __forceinline__ void draw(uint32_t k0, uint32_t k1, uint32_t k2,
                                     uint32_t j0, uint32_t one,
                                     float (&out)[n]) {
  uint32_t x0[n], x1[n];
#pragma unroll
  for (int u = 0; u < n; ++u) {
    x0[u] = k0;                      // counter high word 0
    x1[u] = j0 + static_cast<uint32_t>(u) + k1;
  }
  four_rounds<n, 0>(x0, x1);
  inject<n>(x0, x1, k1, k2 + 1u, one);
  four_rounds<n, 1>(x0, x1);
  inject<n>(x0, x1, k2, k0 + 2u, one);
  four_rounds<n, 0>(x0, x1);
  inject<n>(x0, x1, k0, k1 + 3u, one);
  four_rounds<n, 1>(x0, x1);
  inject<n>(x0, x1, k1, k2 + 4u, one);
  four_rounds<n, 0>(x0, x1);
  inject<n>(x0, x1, k2, k0 + 5u, one);
#pragma unroll
  for (int u = 0; u < n; ++u) {
    const uint32_t bits = x0[u] ^ x1[u];
    out[u] = __fsub_rn(__uint_as_float((bits >> 9) + 0x3F800000u), 1.0f);
  }
}

// Grid (blocks a row, min(rows, 65535)). A row is a head of up to 3 samples
// to the first 16-byte boundary, groups of kSamples (thread t of the row's
// blocks takes groups t, t + stride, ...) and a tail of fewer than
// kSamples; block 0's threads 0-3 draw the head and threads 8 on the tail.
__global__ void __launch_bounds__(kThreefryThreads)
threefry_uniform_kernel(const uint32_t* __restrict__ keys,
                        float* __restrict__ out, long long rows,
                        uint32_t per_key, uint32_t one) {
  const uint32_t stride = gridDim.x * blockDim.x;
  const uint32_t first = blockIdx.x * blockDim.x + threadIdx.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint32_t k0 = keys[2 * r], k1 = keys[2 * r + 1];
    const uint32_t k2 = k0 ^ k1 ^ kParity;
    float* row = out + r * per_key;
    const uint32_t to_16 = static_cast<uint32_t>(
        ((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) / 4);
    const uint32_t head = to_16 < per_key ? to_16 : per_key;
    const uint32_t groups = (per_key - head) / kSamples;
    for (uint32_t g = first; g < groups; g += stride) {
      const uint32_t j0 = head + g * kSamples;
      float v[kSamples];
      draw<kSamples>(k0, k1, k2, j0, one, v);
      if constexpr (kSamples == 1) {
        row[j0] = v[0];
      } else if constexpr (kSamples == 2) {
        *reinterpret_cast<float2*>(row + j0) = make_float2(v[0], v[1]);
      } else {
#pragma unroll
        for (int u = 0; u < kSamples; u += 4) {
          *reinterpret_cast<float4*>(row + j0 + u) =
              make_float4(v[u], v[u + 1], v[u + 2], v[u + 3]);
        }
      }
    }
    if (blockIdx.x == 0 && threadIdx.x < 8 + kSamples) {
      const uint32_t t = threadIdx.x;
      const uint32_t j = t < 8 ? t : head + groups * kSamples + (t - 8);
      if (t < 8 ? j < head : j < per_key) {
        float v[1];
        draw<1>(k0, k1, k2, j, one, v);
        row[j] = v[0];
      }
    }
  }
}

}  // namespace

// keys: uint32 [rows, 2]; out: float32 [rows, per_key], 4-byte aligned,
// 0 < per_key < 2^32.
GOMEL_API int gomel_threefry_uniform(const void* keys, void* out,
                                     long long rows, long long per_key,
                                     int device, void* stream) {
  cudaSetDevice(device);
  const long long resident = resident_blocks(
      reinterpret_cast<const void*>(threefry_uniform_kernel),
      kThreefryThreads, 0, device);
  const long long by = rows < 65535 ? rows : 65535;
  // the card's resident blocks shared by the rows, no more blocks a row
  // than one trip of every group needs
  const long long groups = per_key / kSamples;
  const long long one_trip = (groups + kThreefryThreads - 1) /
                             kThreefryThreads;
  long long bx = resident / by;
  if (bx > one_trip) bx = one_trip;
  if (bx < 1) bx = 1;
  threefry_uniform_kernel<<<dim3(static_cast<unsigned>(bx),
                                 static_cast<unsigned>(by)),
                            kThreefryThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<float*>(out), rows,
      static_cast<uint32_t>(per_key), 1u);
  return gomel_status();
}
