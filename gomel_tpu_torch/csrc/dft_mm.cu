// KN and KO: the real DFT as one matrix product (K14).
//
// Replace gomel_tpu/ops/dft_mm.py (rfft :105, rfft_windowed :114,
// irfft_windowed :126, rfft_mag :135, irfft :140): the whole transform as one
// [frames, N] x [N, 2(N/2+1)] product (KN, forward) or one
// [frames, 2(N/2+1)] x [2(N/2+1), N] product (KO, inverse), with the window
// folded into the weights on the host (ops/dft_mm.py builds them in float64,
// rounds to float32 and, for the bf16 mode, to bf16: the JAX order).
//
// KN: C = A x W. A row r is frame f = r % frames of signal row b = r / frames,
//   read straight from the signal at stride hop (framed input is hop = n), so
//   no [F, N] copy exists. W's columns are interleaved (cos k, -sin k) pairs,
//   padded to the tile width, so the two accumulators a thread holds side by
//   side are the real and imaginary parts of one bin. Epilogues: (re, im)
//   planes, magnitudes, (imag, real) pairs of a bin range (the phase
//   encode's layout), or the Griffin-Lim projection (unit phase, angle 0 ->
//   1, times the fixed magnitude: unit_phase.cuh, as KJ), written as float32
//   planes or as bf16 planes (rows padded to 8 bins) for the bf16 inverse.
// KO: C = A x V. The contraction is a re block (bins 0..n/2) and an im block,
//   each padded with zero weight rows to a multiple of the stage depth, so a
//   stage reads one plane only; the im weights of DC and Nyquist are zero
//   (irfft ignores them, gomel_tpu/ops/dft_mm.py:74-75). Output: windowed
//   frames [rows, N] float32; frames at or past real_frames of their row are
//   zeros (K10's mask).
//
// Bound: at the Griffin-Lim bench shape (2 x 1122 frames of 4096) each
// product is 2,244 x 4,096 x 4,098 x 2 = 75.3 GFLOP: operations bind it
// (0.076 ms at 989 TFLOP/s bf16, 1.12 ms at 67 TFLOP/s float32), against
// 47 MB of operands and results (0.014 ms at 3.35 TB/s). Each 128 x 128
// tile re-reads its operands from L2, though, and in the bf16 mode that
// traffic, not the tensor cores, sets the pace (tools/profile_dft_mm.py:
// without the products the kernels keep ~90% of their time), so the design
// keeps the copies in flight and their bytes few:
//   - a persistent grid, one block an SM, walks 128 x 128 output tiles (row
//     tiles fastest, so a weight column panel stays in L2);
//   - a block is one producer warpgroup and two consumer warpgroups
//     (setmaxnreg moves registers to the consumers), joined by a ring of
//     4-7 shared-memory stages completed on mbarriers;
//   - the producer loads the weights with TMA (tensor maps cached with the
//     weights on the host) and the A operand with cp.async: 16-byte copies
//     where every row base is 16-byte aligned, 4-byte copies where not
//     (KN's length or hop % 4 != 0, float32 planes of n/2 + 1 bins), the
//     ragged edges zero-filled by the copy's source size, row bases computed
//     once a tile; no per-element division or bounds branch;
//   - bf16 mode: wgmma.m64n128k16 with A in registers and B from the
//     128-byte-swizzled stage. A reaches the registers in bf16 (round to
//     nearest even): KN reads a bf16 copy of the signal that a first kernel
//     writes in rows of 16-byte multiples (half the bytes of float32) when
//     hop % 8 == 0, and else converts its float32 fragment on the way, as KO
//     does for float32 planes; bf16 planes, which KN's projection writes in
//     rows padded to 8 bins, go straight in. The contraction is permuted
//     within each 16 on the host so a thread's four A values of a k-step
//     are adjacent in shared memory (one 16- or 8-byte load a row);
//   - the tensor cores accumulate with truncation, so each 64-deep stage
//     sums into a fresh accumulator that a rounded float32 add folds into the
//     running one (a 4096-deep chain in one accumulator drifted to 2.5e-5 of
//     the frame peak from the rounded sum; 64 deep holds 1.4e-6 at n = 8192,
//     as 32 did); while one warpgroup adds, the other's products run;
//   - epilogues store from the accumulators' fragments after loading every
//     value they read; the interior projection's bf16 planes pass through a
//     shared-memory tile and leave in 16-byte row stores;
//   - float32 mode (the exact precisions, on the FMA pipes): 8 x 8 outputs
//     a consumer thread, A and B read as float4 from stages laid out in the
//     order the micro-tile reads them, A swizzled so no read conflicts.
#include <cuda.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "unit_phase.cuh"

namespace {

constexpr int kConsumers = 256;        // two warpgroups: rows 0-63, 64-127
constexpr int kProducers = 128;        // one warpgroup: TMA and cp.async
constexpr int kThreads = kConsumers + kProducers;
constexpr int kTileM = 128;            // rows of an output tile
constexpr int kTileN = 128;            // columns of an output tile
constexpr int kDepth16 = 64;           // k depth of a bf16-mode stage
constexpr int kDepth32 = 32;           // k depth of a float32-mode stage
constexpr int kPromote = 64;           // k depth of one fresh accumulator
constexpr int kSmemLimit = 232448;     // dynamic shared memory a block

enum Epilogue { kPlanes = 0, kMagnitude = 1, kPairs = 2, kProject = 3 };

// Stage geometry of a mode: TA is A's element type in shared memory.
template <bool kBf16, typename TA>
struct Config {
  static constexpr int kDepth = kBf16 ? kDepth16 : kDepth32;
  static constexpr int kABytes = kTileM * kDepth * int(sizeof(TA));
  static constexpr int kBBytes = kTileN * kDepth * (kBf16 ? 2 : 4);
  static constexpr int kStageBytes = kABytes + kBBytes;
  // the bf16 mode's epilogue tile: two bf16 planes of 128 rows x 64 bins
  static constexpr int kOutBytes = kBf16 ? 2 * kTileM * kTileN : 0;
  static constexpr int kStages0 =
      (kSmemLimit - kOutBytes - 3072) / kStageBytes;
  static constexpr int kStages = kStages0 > 8 ? 8 : kStages0;
  // B stages (1024-byte aligned for the swizzle), A stages, the full and
  // empty barriers, the row bases of a tile, the epilogue tile and the
  // alignment slack
  static constexpr int kSmem = kStages * kStageBytes + 16 * kStages +
                               8 * kTileM + kOutBytes + 1024;
  static_assert(kStages >= 2 && kSmem <= kSmemLimit, "stages do not fit");
};

// -- PTX ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// the mbarrier counts one arrival when this thread's cp.asyncs so far land
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// 16 bytes from global to shared; bytes past src_bytes are zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers) : "memory");
}

// K-major operand in a 128-byte-swizzled tile of 8-row groups 1024 bytes
// apart (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads of d across the asynchronous product
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A x B: 64 x 128 x 16, bf16 operands, float32 accumulators; A from
// registers (the m16n8k16 fragment of each warp's 16 rows), B from shared
// memory (128 columns, K-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// two floats as a bf16 pair (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// -- operands ----------------------------------------------------------------

// Where A's 16-byte chunk c of tile row r lies in its stage: float32 rows
// flip bit 2 of the chunk on odd rows, bf16 rows XOR (r & 3) << 1, so the
// consumers' fragment reads are free of bank conflicts.
template <typename TA>
__device__ __forceinline__ int a_chunk(int r, int c) {
  return sizeof(TA) == 4 ? c ^ ((r & 1) << 2) : c ^ ((r & 3) << 1);
}

// KN's A operand: frame r starts at row(r) in the signal (float32, or its
// bf16 copy with rows length apart; -1 past the last row); the contraction
// runs over its n samples.
template <typename T>
struct FrameOperand {
  const T* x;
  long long rows, frames, length, hop;
  int n;
  __device__ long long row(long long r) const {
    if (r >= rows) return -1;
    const long long b = r / frames;
    return b * length + (r - b * frames) * hop;
  }
  __device__ const T* plane(int k0, int& koff) const {
    koff = k0;
    return x;
  }
  __device__ int extent() const { return n; }
};

// KO's A operand: row r of the re plane for the first half of the
// contraction (kh deep), of the im plane for the second; rows ld apart.
template <typename T>
struct PlaneOperand {
  const T* re;
  const T* im;
  long long rows, ld;
  int half, kh;
  __device__ long long row(long long r) const { return r < rows ? r * ld : -1; }
  __device__ const T* plane(int k0, int& koff) const {
    koff = k0 < kh ? k0 : k0 - kh;
    return k0 < kh ? re : im;
  }
  __device__ int extent() const { return half; }
};

struct RowRef {
  long long r;   // the output row, or -1 past the rows
  bool live;     // false: a masked frame (KO), stored as zeros
};

// KN's epilogue: columns (c, c + 1) of row r are (re, im) of bin c / 2.
struct ForwardStore {
  int kind;
  long long rows;
  int half, first, count;
  long long ld_low;       // row stride of the bf16 planes
  float* out0;            // re planes, magnitudes or pairs
  float* out1;            // im planes
  __nv_bfloat16* low0;    // bf16 projected re planes (or null)
  __nv_bfloat16* low1;    // bf16 projected im planes
  const float* mag;       // the fixed magnitudes of the projection
  __device__ RowRef row(long long r) const { return {r < rows ? r : -1, true}; }
  // the projection's fixed magnitude of the bin of column c (0 otherwise);
  // the epilogue loads every one before its first store
  __device__ float aux(RowRef ref, int c) const {
    const int j = c >> 1;
    if (kind != kProject || ref.r < 0 || j >= half) return 0.0f;
    return __ldg(mag + ref.r * half + j);
  }
  // the bf16 planes go through shared memory: 16-byte row stores
  __device__ bool staged() const { return low0 != nullptr; }
  __device__ uint32_t project_low(float re, float im, float m) const {
    const float2 y = project_bin(make_float2(re, im), m);
    return pack_bf16(y.x, y.y);
  }
  // 8 bins from bin j of row r (j a multiple of 8; ld_low too)
  __device__ void put8(long long r, int j, int plane, uint4 v) const {
    if (r < 0 || j >= ld_low) return;
    *reinterpret_cast<uint4*>((plane ? low1 : low0) + r * ld_low + j) = v;
  }
  __device__ void put(RowRef ref, int c, float re, float im, float m) const {
    const long long r = ref.r;
    const int j = c >> 1;
    if (r < 0 || j >= half) return;
    const long long at = r * half + j;
    if (kind == kMagnitude) {
      out0[at] =
          __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
      return;
    }
    if (kind == kPairs) {
      if (j < first || j >= first + count) return;
      float2* dst = reinterpret_cast<float2*>(out0);
      dst[r * count + (j - first)] = make_float2(im, re);
      return;
    }
    if (kind == kProject) {
      const float2 y = project_bin(make_float2(re, im), m);
      re = y.x;
      im = y.y;
      if (low0 != nullptr) {
        low0[r * ld_low + j] = __float2bfloat16_rn(re);
        low1[r * ld_low + j] = __float2bfloat16_rn(im);
        return;
      }
    }
    out0[at] = re;
    out1[at] = im;
  }
};

// KO's epilogue: samples (c, c + 1) of frame row r; n is even, so both or
// neither lie inside the frame.
struct InverseStore {
  float* out;
  long long rows, frames, real_frames;
  int n;
  __device__ RowRef row(long long r) const {
    if (r >= rows) return {-1, false};
    return {r, r - (r / frames) * frames < real_frames};
  }
  __device__ float aux(RowRef, int) const { return 0.0f; }
  __device__ bool staged() const { return false; }
  __device__ uint32_t project_low(float, float, float) const { return 0; }
  __device__ void put8(long long, int, int, uint4) const {}
  __device__ void put(RowRef ref, int c, float v0, float v1, float) const {
    if (ref.r < 0 || c >= n) return;
    float2* dst = reinterpret_cast<float2*>(out + ref.r * n + c);
    *dst = ref.live ? make_float2(v0, v1) : make_float2(0.0f, 0.0f);
  }
};

// KN's signal in bf16 (round to nearest even), rows of ld samples (a
// multiple of 8, zero past length): eight samples a thread, one 16-byte
// store, so the main loop reads half the bytes of the float32 signal.
__global__ void __launch_bounds__(256)
    signal_bf16_kernel(const float* __restrict__ x,
                       __nv_bfloat16* __restrict__ y, long long batch,
                       long long length, long long ld) {
  const long long per_row = ld / 8;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= batch * per_row) return;
  const long long b = i / per_row, j = (i - b * per_row) * 8;
  const float* src = x + b * length + j;
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = j + e < length ? src[e] : 0.0f;
  uint4 out;
  out.x = pack_bf16(v[0], v[1]);
  out.y = pack_bf16(v[2], v[3]);
  out.z = pack_bf16(v[4], v[5]);
  out.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(y + b * ld + j) = out;
}

// -- the producer warpgroup --------------------------------------------------

// A's stage k0.. of the tile whose row bases are rowbase: a thread copies
// chunk p % kChunks of every (kProducers / kChunks)-th row. The chunk's
// valid elements (past the operand's extent or the last row: none) are
// copied, the rest zero-filled.
template <int kDepth, typename TA, typename Operand>
__device__ __forceinline__ void load_a(const Operand& op,
                                       const long long* rowbase,
                                       unsigned char* stage, int k0, int p,
                                       bool vec) {
  constexpr int kPer = 16 / int(sizeof(TA));    // elements a chunk
  constexpr int kChunks = kDepth / kPer;        // chunks a row
  constexpr int kRowBytes = kDepth * int(sizeof(TA));
  constexpr int kStep = kProducers / kChunks;   // rows between a thread's
  int koff;
  const TA* src = op.plane(k0, koff);
  const int c = p % kChunks;
  const int e0 = koff + c * kPer;
  const int valid = min(max(op.extent() - e0, 0), kPer);
  const uint32_t base = smem_u32(stage);
  const int r0 = p / kChunks;
  if (vec) {
#pragma unroll 4
    for (int r = r0; r < kTileM; r += kStep) {
      const long long rb = rowbase[r];
      const int v = rb < 0 ? 0 : valid;
      const TA* g = v > 0 ? src + rb + e0 : src;
      cp_async16(base + r * kRowBytes + a_chunk<TA>(r, c) * 16, g,
                 v * int(sizeof(TA)));
    }
  } else if constexpr (sizeof(TA) == 4) {
#pragma unroll 2
    for (int r = r0; r < kTileM; r += kStep) {
      const long long rb = rowbase[r];
      const int v = rb < 0 ? 0 : valid;
      const TA* g = v > 0 ? src + rb + e0 : src;
      const uint32_t d = base + r * kRowBytes + a_chunk<TA>(r, c) * 16;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cp_async4(d + 4 * e, v > e ? g + e : src, v > e ? 4 : 0);
    }
  }
}

template <bool kBf16, typename TA, typename Operand>
__device__ void producer(const CUtensorMap* bmap, const Operand& op,
                         unsigned char* bsm, unsigned char* asm_,
                         uint64_t* full, uint64_t* empty, long long* rowbase,
                         int nk, int mtiles, int tiles, bool vec) {
  using C = Config<kBf16, TA>;
  const int p = threadIdx.x - kConsumers;
  int s = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile % mtiles) * kTileM;
    const int col0 = (tile / mtiles) * kTileN;
    producer_sync();   // the last tile's copies have read the row bases
    rowbase[p] = op.row(row0 + p);
    producer_sync();
    for (int ks = 0; ks < nk; ++ks) {
      mbar_wait(&empty[s], phase ^ 1);
      const int k0 = ks * C::kDepth;
      if (p == 0) {
        mbar_expect_tx(&full[s], C::kBBytes);
        if constexpr (kBf16) {
          tma_load_2d(bsm + s * C::kBBytes, bmap, k0, col0, &full[s]);
        } else {
          tma_load_2d(bsm + s * C::kBBytes, bmap, col0, k0, &full[s]);
        }
      }
      load_a<C::kDepth, TA>(op, rowbase, asm_ + s * C::kABytes, k0, p, vec);
      cp_async_arrive(&full[s]);
      if (++s == C::kStages) {
        s = 0;
        phase ^= 1;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// -- the consumer warpgroups -------------------------------------------------

// The A fragment of k-step j (16 deep) for rows r and r + 8: samples
// 16 j + 4 t .. + 3 (the host's permutation puts them at the fragment's
// k = 2t, 2t + 1, 2t + 8, 2t + 9).
__device__ __forceinline__ void a_frag(const float* as, int r, int j, int t,
                                       uint32_t (&a)[4]) {
  const int c = a_chunk<float>(r, 4 * j + t);   // r + 8: the same swizzle
  const float4 v0 = *reinterpret_cast<const float4*>(as + r * kDepth16 + 4 * c);
  const float4 v1 =
      *reinterpret_cast<const float4*>(as + (r + 8) * kDepth16 + 4 * c);
  a[0] = pack_bf16(v0.x, v0.y);
  a[1] = pack_bf16(v1.x, v1.y);
  a[2] = pack_bf16(v0.z, v0.w);
  a[3] = pack_bf16(v1.z, v1.w);
}

__device__ __forceinline__ void a_frag(const __nv_bfloat16* as, int r, int j,
                                       int t, uint32_t (&a)[4]) {
  const int off = a_chunk<__nv_bfloat16>(r, 2 * j + (t >> 1)) * 16 +
                  (t & 1) * 8;
  const unsigned char* b = reinterpret_cast<const unsigned char*>(as);
  const uint2 u0 = *reinterpret_cast<const uint2*>(b + r * 128 + off);
  const uint2 u1 = *reinterpret_cast<const uint2*>(b + (r + 8) * 128 + off);
  a[0] = u0.x;
  a[1] = u1.x;
  a[2] = u0.y;
  a[3] = u1.y;
}

// One bf16 stage: the warpgroup's 64 rows x 128 columns, kDepth16 deep, in
// slices of kPromote: each slice's products go to part, then one rounded
// add a value folds it into acc.
template <typename TA>
__device__ __forceinline__ void mma_stage(const TA* as, uint32_t bs, int r,
                                          int t, float (&acc)[64],
                                          float (&part)[64]) {
  constexpr int kSteps = kPromote / 16;
#pragma unroll
  for (int g = 0; g < kDepth16 / kPromote; ++g) {
    uint32_t a[kSteps][4];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) a_frag(as, r, g * kSteps + j, t, a[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      wgmma_rs(part, a[j], desc_sw128(bs + (g * kSteps + j) * 32), j);
    wgmma_commit();
    wgmma_wait();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  }
}

// One float32 stage: rows ty*8.., columns tx*4.. and 64 + tx*4.., kDepth32
// deep, each product a fused multiply-add in k order.
__device__ __forceinline__ void fma_stage(const float* as, const float* bs,
                                          int ty, int tx,
                                          float (&acc)[8][8]) {
#pragma unroll
  for (int q = 0; q < kDepth32 / 4; ++q) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)   // row ty*8 + i has the parity of i
      a[i] = *reinterpret_cast<const float4*>(
          as + (ty * 8 + i) * kDepth32 + 4 * (q ^ ((i & 1) << 2)));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 =
          *reinterpret_cast<const float4*>(bs + (4 * q + kk) * kTileN + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(
          bs + (4 * q + kk) * kTileN + 64 + 4 * tx);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = kk == 0 ? a[i].x
                         : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z
                                   : a[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
      }
    }
  }
}

// Where bin j of row r (of a warpgroup's 64) lies in a plane of the
// epilogue tile: rows of 128 bytes, the 16-byte chunk XOR (r & 7), so the
// fragments' 2-byte writes and the 16-byte row reads miss bank conflicts.
__device__ __forceinline__ int out_offset(int r, int j) {
  return r * 128 + ((((j >> 3) ^ r) & 7) << 4) + ((j & 7) << 1);
}

// KN's interior projection into bf16 planes: the warpgroup projects its 64
// rows into its half of the epilogue tile (16 KB: two planes), then copies
// the tile out a 16-byte chunk a thread (8 bins of one row of one plane).
template <typename Store>
__device__ __forceinline__ void stage_low(const Store& store,
                                          const float (&acc)[64],
                                          unsigned char* out_tile,
                                          long long row0, int col0, int r,
                                          int t) {
  const int wg = r >> 6, wr = r & 63;   // warpgroup, row in it
  unsigned char* tile = out_tile + wg * 2 * 64 * 128;
  const RowRef lo = store.row(row0 + r), hi = store.row(row0 + r + 8);
  float m[32];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    m[2 * j] = store.aux(lo, col0 + 8 * j + 2 * t);
    m[2 * j + 1] = store.aux(hi, col0 + 8 * j + 2 * t);
  }
  // the epilogue's last reads of this tile (one tile ago) are done
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t v = store.project_low(acc[4 * j + 2 * h],
                                           acc[4 * j + 2 * h + 1], m[2 * j + h]);
      const int off = out_offset(wr + 8 * h, 4 * j + t);
      *reinterpret_cast<uint16_t*>(tile + off) = static_cast<uint16_t>(v);
      *reinterpret_cast<uint16_t*>(tile + 64 * 128 + off) =
          static_cast<uint16_t>(v >> 16);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
  const int tid = threadIdx.x & 127;
#pragma unroll
  for (int i = 0; i < 8; ++i) {   // 2 planes x 64 rows x 8 chunks
    const int e = i * 128 + tid;
    const int plane = e >> 9, row = (e >> 3) & 63, c = e & 7;
    const uint4 v = *reinterpret_cast<const uint4*>(
        tile + plane * 64 * 128 + out_offset(row, 8 * c));
    const RowRef ref = store.row(row0 + wg * 64 + row);
    store.put8(ref.r, col0 / 2 + 8 * c, plane, v);
  }
}

template <bool kBf16, typename TA, typename Store>
__device__ void consumer(const Store& store, unsigned char* bsm,
                         unsigned char* asm_, unsigned char* out_tile,
                         uint64_t* full, uint64_t* empty, int nk, int mtiles,
                         int tiles) {
  using C = Config<kBf16, TA>;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  int s = 0;
  uint32_t phase = 0;
  if constexpr (kBf16) {
    // warp w holds rows 16 w + g and 16 w + g + 8 of the tile (g = lane / 4)
    const int g = lane >> 2, t = lane & 3;
    const int r = warp * 16 + g;
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.0f;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const long long row0 = static_cast<long long>(tile % mtiles) * kTileM;
      const int col0 = (tile / mtiles) * kTileN;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(&full[s], phase);
        __syncwarp();
        mma_stage(reinterpret_cast<const TA*>(asm_ + s * C::kABytes),
                  smem_u32(bsm + s * C::kBBytes), r, t, acc, part);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        if (++s == C::kStages) {
          s = 0;
          phase ^= 1;
        }
      }
      // accumulator i: row g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2t + (i & 1)
      const RowRef lo = store.row(row0 + r), hi = store.row(row0 + r + 8);
      if (store.staged()) {
        stage_low(store, acc, out_tile, row0, col0, r, t);
        continue;
      }
      // part is free until the next tile's first product
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        part[2 * j] = store.aux(lo, col0 + 8 * j + 2 * t);
        part[2 * j + 1] = store.aux(hi, col0 + 8 * j + 2 * t);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = col0 + 8 * j + 2 * t;
        store.put(lo, c, acc[4 * j], acc[4 * j + 1], part[2 * j]);
        store.put(hi, c, acc[4 * j + 2], acc[4 * j + 3], part[2 * j + 1]);
      }
    }
  } else {
    const int ty = tid >> 4, tx = tid & 15;
    float acc[8][8];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const long long row0 = static_cast<long long>(tile % mtiles) * kTileM;
      const int col0 = (tile / mtiles) * kTileN;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(&full[s], phase);
        fma_stage(reinterpret_cast<const float*>(asm_ + s * C::kABytes),
                  reinterpret_cast<const float*>(bsm + s * C::kBBytes), ty,
                  tx, acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        if (++s == C::kStages) {
          s = 0;
          phase ^= 1;
        }
      }
      float m[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const RowRef ref = store.row(row0 + ty * 8 + i);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          m[i][j] = store.aux(ref, col0 + 64 * (j >> 1) + 4 * tx + 2 * (j & 1));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const RowRef ref = store.row(row0 + ty * 8 + i);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int h = j >> 1, q = 2 * (j & 1);
          store.put(ref, col0 + 64 * h + 4 * tx + q, acc[i][4 * h + q],
                    acc[i][4 * h + q + 1], m[i][j]);
        }
      }
    }
  }
}

// One block an SM; tiles are taken in turn, row tiles fastest.
template <bool kBf16, typename TA, typename Operand, typename Store>
__global__ void __launch_bounds__(kThreads, 1)
    dft_kernel(const __grid_constant__ CUtensorMap bmap, Operand op,
               Store store, int nk, int mtiles, int tiles, int vec) {
  using C = Config<kBf16, TA>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* bsm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* asm_ = bsm + C::kStages * C::kBBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(asm_ + C::kStages * C::kABytes);
  uint64_t* empty = full + C::kStages;
  long long* rowbase = reinterpret_cast<long long*>(empty + C::kStages);
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      mbar_init(&full[i], kProducers + 1);   // the copies, and TMA's bytes
      mbar_init(&empty[i], kConsumers / 32); // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    producer<kBf16, TA>(&bmap, op, bsm, asm_, full, empty, rowbase, nk,
                        mtiles, tiles, vec != 0);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    consumer<kBf16, TA>(store, bsm, asm_,
                        reinterpret_cast<unsigned char*>(rowbase + kTileM),
                        full, empty, nk, mtiles, tiles);
  }
}

template <bool kBf16, typename TA, typename Operand, typename Store>
int launch(const void* tmap, const Operand& op, const Store& store,
           long long rows, long long depth, long long wcols, bool vec,
           int device, cudaStream_t stream) {
  using C = Config<kBf16, TA>;
  if (depth % C::kDepth != 0 || wcols % kTileN != 0 || rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dft_kernel<kBf16, TA, Operand, Store>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::kSmem);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long mtiles = (rows + kTileM - 1) / kTileM;
  const long long tiles = mtiles * (wcols / kTileN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  memcpy(&map, tmap, sizeof(map));
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      map, op, store, static_cast<int>(depth / C::kDepth),
      static_cast<int>(mtiles), static_cast<int>(tiles), vec ? 1 : 0);
  return gomel_status();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

// The TMA tensor map of a kernel weight layout wt [outer, inner] (bf16:
// [columns, depth], box 64 x 128, 128-byte swizzle; float32: [depth,
// columns], box 128 x 32), written to the 128 bytes at map.
GOMEL_API int gomel_dft_weight_map(void* map, const void* wt, int bf16,
                                   long long outer, long long inner,
                                   int device, void* stream) {
  (void)stream;
  cudaSetDevice(device);
  EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap m;
  const cuuint64_t esize = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * esize};
  const cuuint32_t box[2] = {bf16 ? cuuint32_t(kDepth16) : cuuint32_t(kTileN),
                             bf16 ? cuuint32_t(kTileN) : cuuint32_t(kDepth32)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      &m, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(wt), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  memcpy(map, &m, sizeof(m));
  return 0;
}

// KN. x: float32 [batch, length], frames of n at hop; x_low: null, or (bf16
// mode, hop % 8 == 0) scratch of batch rows of length rounded up to 8 bf16
// samples, which a first kernel fills with x in bf16; tmap: the forward
// weights' map (gomel_dft_weight_map), depth the padded contraction (a
// multiple of 64 in bf16, 32 in float32), wcols the padded columns (a
// multiple of 128 covering 2 (n/2 + 1) interleaved columns); epilogue 0:
// out0/out1 = re/im planes [batch*frames, n/2+1] float32 (or, for 3 with low
// != 0, bf16 with rows ld_low apart), 1: out0 = magnitudes, 2: out0 =
// (imag, real) pairs [batch*frames, count, 2] of bins first.., 3: the
// projection with the fixed magnitudes mag [batch*frames, n/2+1].
GOMEL_API int gomel_dft_fwd(int bf16, const void* x, void* x_low,
                            const void* tmap, const void* mag, void* out0,
                            void* out1, int low, long long ld_low,
                            long long batch, long long frames,
                            long long length, long long hop, long long n,
                            long long depth, long long wcols, int epilogue,
                            int first, int count, int device, void* stream) {
  cudaSetDevice(device);
  const long long rows = batch * frames;
  const bool low_out = low != 0 && epilogue == kProject;
  ForwardStore store{epilogue,
                     rows,
                     static_cast<int>(n / 2 + 1),
                     first,
                     count,
                     ld_low,
                     low_out ? nullptr : static_cast<float*>(out0),
                     low_out ? nullptr : static_cast<float*>(out1),
                     low_out ? static_cast<__nv_bfloat16*>(out0) : nullptr,
                     low_out ? static_cast<__nv_bfloat16*>(out1) : nullptr,
                     static_cast<const float*>(mag)};
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16 && x_low != nullptr) {
    // the bf16 copy's rows, 16-byte aligned: 16-byte copies when hop % 8 == 0
    if (hop % 8 != 0 || reinterpret_cast<uintptr_t>(x_low) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long ld = (length + 7) / 8 * 8;
    const long long threads = batch * (ld / 8);
    signal_bf16_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                         s>>>(static_cast<const float*>(x),
                              static_cast<__nv_bfloat16*>(x_low), batch,
                              length, ld);
    FrameOperand<__nv_bfloat16> a{static_cast<const __nv_bfloat16*>(x_low),
                                  rows, frames, ld, hop, static_cast<int>(n)};
    return launch<true, __nv_bfloat16>(tmap, a, store, rows, depth, wcols,
                                       true, device, s);
  }
  FrameOperand<float> a{static_cast<const float*>(x), rows, frames, length,
                        hop, static_cast<int>(n)};
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   length % 4 == 0 && hop % 4 == 0;
  if (bf16)
    return launch<true, float>(tmap, a, store, rows, depth, wcols, vec, device,
                               s);
  return launch<false, float>(tmap, a, store, rows, depth, wcols, vec, device,
                              s);
}

// KO. re/im: planes [rows, n/2+1] with rows ld apart, float32, or bf16 when
// planes_bf16 (bf16 mode only; then ld % 8 == 0 and 16-byte aligned planes);
// tmap: the inverse weights' map, depth the padded contraction (re block,
// then im block, each depth / 2), wcols a multiple of 128 >= n; out: float32
// [rows, n], where rows = batch * frames and frames at or past real_frames
// are zeros.
GOMEL_API int gomel_dft_inv(int bf16, int planes_bf16, const void* re,
                            const void* im, long long ld, const void* tmap,
                            void* out, long long rows, long long frames,
                            long long real_frames, long long n,
                            long long depth, long long wcols, int device,
                            void* stream) {
  cudaSetDevice(device);
  if (planes_bf16 && !bf16) return static_cast<int>(cudaErrorInvalidValue);
  InverseStore store{static_cast<float*>(out), rows, frames, real_frames,
                     static_cast<int>(n)};
  const int half = static_cast<int>(n / 2 + 1);
  const int kh = static_cast<int>(depth / 2);
  auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(re) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(im) % 16 == 0;
  if (planes_bf16) {
    if (!aligned || ld % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    PlaneOperand<__nv_bfloat16> a{static_cast<const __nv_bfloat16*>(re),
                                  static_cast<const __nv_bfloat16*>(im), rows,
                                  ld, half, kh};
    return launch<true, __nv_bfloat16>(tmap, a, store, rows, depth, wcols,
                                       true, device, s);
  }
  PlaneOperand<float> a{static_cast<const float*>(re),
                        static_cast<const float*>(im), rows, ld, half, kh};
  const bool vec = aligned && ld % 4 == 0;
  if (bf16)
    return launch<true, float>(tmap, a, store, rows, depth, wcols, vec, device,
                               s);
  return launch<false, float>(tmap, a, store, rows, depth, wcols, vec, device,
                              s);
}
