// The earlier form of the matmul DFT kernels KN and KO (mma.sync bf16 tiles
// and a SIMT float32 tile, one 128 x 128 tile a block, no pipelining), kept
// only for tools/profile_dft_mm.py's race against csrc/dft_mm.cu. Built by
// that tool alone, with -I gomel_tpu_torch/csrc; the port never loads it.
// Its weights are laid out by the tool (one row per output column, the
// contraction interleaved and padded to 32).
//
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
//   padded to a multiple of the tile width, so the two accumulators a thread
//   holds side by side (mma.sync's c0/c1, or two neighbours of a SIMT
//   micro-tile) are the real and imaginary parts of one bin. Epilogues:
//   (re, im) planes, magnitudes, (imag, real) pairs of a bin range (the
//   phase encode's layout), or the Griffin-Lim projection (unit phase, angle
//   0 -> 1, times the fixed magnitude: unit_phase.cuh, as KJ), written as
//   float32 planes or as bf16 planes for the bf16 inverse that follows.
// KO: C = A x V. A row r holds the interleaved (re, im) of row r's bins, read
//   from two planes (float32 or bf16); V's rows are the interleaved inverse
//   weights with imag(DC) and imag(Nyquist) zero (irfft ignores them,
//   gomel_tpu/ops/dft_mm.py:74-75) and zero rows up to the padded depth.
//   Output: windowed frames [rows, N] float32; frames at or past real_frames
//   of their row are zeros (K10's mask).
//
// Modes, one template per kernel:
//   bf16: mma.sync.m16n8k16 bf16 x bf16 with float32 accumulation; operands
//     are rounded to bf16 (round to nearest even) on their way into shared
//     memory. This is what a single-pass DEFAULT matmul is on a TPU. The
//     tensor cores accumulate with truncation, so each 32-deep stage sums
//     into a fresh accumulator that a rounded float32 add folds into the
//     running one (a 4096-deep chain in one accumulator drifted to 2.5e-5
//     of the frame peak from the rounded sum).
//   f32: a SIMT float32 tiled product (8 x 8 outputs a thread), for the exact
//     precisions.
// One 128 x 128 output tile a block of 256 threads, no pipelining: a simple
// kernel that is right first; wgmma, TMA and a persistent grid come later.
//
// Bound: at the Griffin-Lim bench shape (2 x 1122 frames of 4096) each
// product is 2,244 x 4,096 x 4,098 x 2 = 75.3 GFLOP: operations bind it
// (0.076 ms at 989 TFLOP/s bf16, 1.12 ms at 67 TFLOP/s float32), against
// 47 MB of operands and results (0.014 ms at 3.35 TB/s).
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "unit_phase.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 128;   // rows of a block's output tile
constexpr int kTileN = 128;   // columns of a block's output tile
constexpr int kDepth16 = 32;  // k depth of a bf16 stage
constexpr int kSkew16 = 8;    // bf16 padding of a shared row (no bank clashes)
constexpr int kDepth32 = 8;   // k depth of a float32 stage

enum Epilogue { kPlanes = 0, kMagnitude = 1, kPairs = 2, kProject = 3 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// KN's A operand: sample k of frame r. row(r) is the frame's offset in the
// signal (-1 past the last row), computed once a tile row.
struct FrameOperand {
  const float* x;
  long long rows, frames, length, hop;
  int n;
  __device__ long long row(long long r) const {
    if (r >= rows) return -1;
    const long long b = r / frames;
    return b * length + (r - b * frames) * hop;
  }
  __device__ float at(long long base, int k) const {
    return (base < 0 || k >= n) ? 0.0f : x[base + k];
  }
};

// KO's A operand: column k of row r is re (k even) or im (k odd) of bin k/2.
template <typename T>
struct PlaneOperand {
  const T* re;
  const T* im;
  long long rows;
  int half;
  __device__ long long row(long long r) const {
    return r < rows ? r * half : -1;
  }
  __device__ float at(long long base, int k) const {
    const int j = k >> 1;
    if (base < 0 || j >= half) return 0.0f;
    return to_float(((k & 1) ? im : re)[base + j]);
  }
};

// KN's epilogue: columns (c, c + 1) of row r are (re, im) of bin c / 2.
struct ForwardStore {
  int kind;
  long long rows;
  int half, first, count;
  float* out0;            // re planes, magnitudes or pairs
  float* out1;            // im planes
  __nv_bfloat16* low0;    // bf16 projected re planes (or null)
  __nv_bfloat16* low1;    // bf16 projected im planes
  const float* mag;       // the fixed magnitudes of the projection
  __device__ void operator()(long long r, int c, float re, float im) const {
    const int j = c >> 1;
    if (r >= rows || j >= half) return;
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
      const float2 y = project_bin(make_float2(re, im), mag[at]);
      re = y.x;
      im = y.y;
      if (low0 != nullptr) {
        low0[at] = __float2bfloat16_rn(re);
        low1[at] = __float2bfloat16_rn(im);
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
  __device__ void operator()(long long r, int c, float v0, float v1) const {
    if (r >= rows || c >= n) return;
    const bool real = r - (r / frames) * frames < real_frames;
    float2* dst = reinterpret_cast<float2*>(out + r * n + c);
    *dst = real ? make_float2(v0, v1) : make_float2(0.0f, 0.0f);
  }
};

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 128 x 128 tile of C = A x W^T on the tensor cores. wt is W stored
// column by column, [columns, ldw] bf16 with ldw a multiple of kDepth16 and
// zeros past the operand's depth. 8 warps as 2 x 4, each 64 x 32 outputs:
// 4 x 4 mma tiles of 16 x 8.
template <typename Operand, typename Store>
__device__ void tile_bf16(const Operand& load_a,
                          const __nv_bfloat16* __restrict__ wt, int ldw,
                          const Store& store) {
  __shared__ __align__(16) __nv_bfloat16 as[kTileM][kDepth16 + kSkew16];
  __shared__ __align__(16) __nv_bfloat16 bs[kTileN][kDepth16 + kSkew16];
  __shared__ long long base[kTileM];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTileM;
  const int col0 = blockIdx.y * kTileN;
  for (int r = tid; r < kTileM; r += kThreads) base[r] = load_a.row(row0 + r);
  __syncthreads();
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int k0 = 0; k0 < ldw; k0 += kDepth16) {
    for (int e = tid; e < kTileM * kDepth16; e += kThreads) {
      const int r = e / kDepth16, k = e % kDepth16;
      as[r][k] = __float2bfloat16_rn(load_a.at(base[r], k0 + k));
    }
    for (int e = tid; e < kTileN * (kDepth16 / 8); e += kThreads) {
      const int c = e / (kDepth16 / 8), q = e % (kDepth16 / 8);
      *reinterpret_cast<uint4*>(&bs[c][q * 8]) =
          *reinterpret_cast<const uint4*>(
              wt + static_cast<long long>(col0 + c) * ldw + k0 + q * 8);
    }
    __syncthreads();
    uint32_t a[2][4][4], b[2][4][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = 16 * h;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + i * 16 + g;
        a[h][i][0] = load_pair(&as[r][kk + 2 * t]);
        a[h][i][1] = load_pair(&as[r + 8][kk + 2 * t]);
        a[h][i][2] = load_pair(&as[r][kk + 2 * t + 8]);
        a[h][i][3] = load_pair(&as[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + j * 8 + g;
        b[h][j][0] = load_pair(&bs[c][kk + 2 * t]);
        b[h][j][1] = load_pair(&bs[c][kk + 2 * t + 8]);
      }
    }
    // the tensor cores' float32 accumulation truncates: a stage's 32
    // products go into a fresh accumulator, added into the running sum
    // with a rounded add, so the bias cannot build up along N
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(part, a[0][i], b[0][j]);
        mma_bf16(part, a[1][i], b[1][j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
      }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long r = row0 + wm + i * 16 + g;
      const int c = col0 + wn + j * 8 + 2 * t;
      store(r, c, acc[i][j][0], acc[i][j][1]);
      store(r + 8, c, acc[i][j][2], acc[i][j][3]);
    }
}

// The same tile in float32 on the CUDA cores: 16 x 16 threads, each 8 x 8
// outputs (rows ty*8.., columns tx*8..: even-aligned pairs).
template <typename Operand, typename Store>
__device__ void tile_f32(const Operand& load_a, const float* __restrict__ wt,
                         int ldw, const Store& store) {
  __shared__ __align__(16) float as[kDepth32][kTileM + 4];
  __shared__ __align__(16) float bs[kDepth32][kTileN + 4];
  __shared__ long long base[kTileM];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTileM;
  const int col0 = blockIdx.y * kTileN;
  for (int r = tid; r < kTileM; r += kThreads) base[r] = load_a.row(row0 + r);
  __syncthreads();
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < ldw; k0 += kDepth32) {
    for (int e = tid; e < kTileM * kDepth32; e += kThreads) {
      const int r = e / kDepth32, k = e % kDepth32;
      as[k][r] = load_a.at(base[r], k0 + k);
    }
    for (int e = tid; e < kTileN * kDepth32; e += kThreads) {
      const int c = e / kDepth32, k = e % kDepth32;
      bs[k][c] = wt[static_cast<long long>(col0 + c) * ldw + k0 + k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDepth32; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[k][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[k][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[k][tx * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; j += 2)
      store(row0 + ty * 8 + i, col0 + tx * 8 + j, acc[i][j], acc[i][j + 1]);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    dft_fwd_kernel(FrameOperand a, const void* __restrict__ wt, int ldw,
                   ForwardStore store) {
  if constexpr (kBf16) {
    tile_bf16(a, static_cast<const __nv_bfloat16*>(wt), ldw, store);
  } else {
    tile_f32(a, static_cast<const float*>(wt), ldw, store);
  }
}

template <bool kBf16, typename T>
__global__ void __launch_bounds__(kThreads)
    dft_inv_kernel(PlaneOperand<T> a, const void* __restrict__ wt, int ldw,
                   InverseStore store) {
  if constexpr (kBf16) {
    tile_bf16(a, static_cast<const __nv_bfloat16*>(wt), ldw, store);
  } else {
    tile_f32(a, static_cast<const float*>(wt), ldw, store);
  }
}

dim3 grid_of(long long rows, long long columns) {
  return dim3(static_cast<unsigned>((rows + kTileM - 1) / kTileM),
              static_cast<unsigned>(columns / kTileN));
}

}  // namespace

// KN. x: float32 [batch, length], frames of n at hop; wt: the forward
// weights [wcols, ldw] (bf16 when bf16, else float32), wcols a multiple of
// 128 covering 2 (n/2 + 1) interleaved columns, ldw a multiple of 32 >= n;
// epilogue 0: out0/out1 = re/im planes [batch*frames, n/2+1] float32 (or,
// for 3 with low != 0, bf16), 1: out0 = magnitudes, 2: out0 = (imag, real)
// pairs [batch*frames, count, 2] of bins first.., 3: the projection with the
// fixed magnitudes mag [batch*frames, n/2+1].
GOMEL_API int gomel_dft_fwd(int bf16, const void* x, const void* wt,
                            const void* mag, void* out0, void* out1, int low,
                            long long batch, long long frames,
                            long long length, long long hop, long long n,
                            long long ldw, long long wcols, int epilogue,
                            int first, int count, int device, void* stream) {
  cudaSetDevice(device);
  const long long rows = batch * frames;
  FrameOperand a{static_cast<const float*>(x), rows, frames, length, hop,
                 static_cast<int>(n)};
  const bool low_out = low != 0 && epilogue == kProject;
  ForwardStore store{epilogue,
                     rows,
                     static_cast<int>(n / 2 + 1),
                     first,
                     count,
                     low_out ? nullptr : static_cast<float*>(out0),
                     low_out ? nullptr : static_cast<float*>(out1),
                     low_out ? static_cast<__nv_bfloat16*>(out0) : nullptr,
                     low_out ? static_cast<__nv_bfloat16*>(out1) : nullptr,
                     static_cast<const float*>(mag)};
  const dim3 grid = grid_of(rows, wcols);
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    dft_fwd_kernel<true><<<grid, kThreads, 0, s>>>(a, wt, static_cast<int>(ldw),
                                                   store);
  } else {
    dft_fwd_kernel<false><<<grid, kThreads, 0, s>>>(a, wt,
                                                    static_cast<int>(ldw),
                                                    store);
  }
  return gomel_status();
}

// KO. re/im: planes [rows, n/2+1], float32, or bf16 when planes_bf16 (bf16
// mode only); wt: the inverse weights [wcols, ldw], wcols a multiple of 128
// >= n, ldw a multiple of 32 >= 2 (n/2 + 1); out: float32 [rows, n], where
// rows = batch * frames and frames at or past real_frames are zeros.
GOMEL_API int gomel_dft_inv(int bf16, int planes_bf16, const void* re,
                            const void* im, const void* wt, void* out,
                            long long rows, long long frames,
                            long long real_frames, long long n,
                            long long ldw, long long wcols, int device,
                            void* stream) {
  cudaSetDevice(device);
  if (planes_bf16 && !bf16) return static_cast<int>(cudaErrorInvalidValue);
  InverseStore store{static_cast<float*>(out), rows, frames, real_frames,
                     static_cast<int>(n)};
  const int half = static_cast<int>(n / 2 + 1);
  const dim3 grid = grid_of(rows, wcols);
  auto s = static_cast<cudaStream_t>(stream);
  const int w = static_cast<int>(ldw);
  if (planes_bf16) {
    PlaneOperand<__nv_bfloat16> a{static_cast<const __nv_bfloat16*>(re),
                                  static_cast<const __nv_bfloat16*>(im), rows,
                                  half};
    dft_inv_kernel<true, __nv_bfloat16><<<grid, kThreads, 0, s>>>(a, wt, w,
                                                                  store);
  } else {
    PlaneOperand<float> a{static_cast<const float*>(re),
                          static_cast<const float*>(im), rows, half};
    if (bf16) {
      dft_inv_kernel<true, float><<<grid, kThreads, 0, s>>>(a, wt, w, store);
    } else {
      dft_inv_kernel<false, float><<<grid, kThreads, 0, s>>>(a, wt, w, store);
    }
  }
  return gomel_status();
}
