// KD: mel PNG quantizer — per-row global min/max, trunc(255 * norm), transpose.
// KF: phase PNG quantizer — the same with per-channel extrema, an asinh
//     prologue and uint8 or uint16 planes (below).
//
// Replaces gomel_tpu/ops/quantize.py:63 quantize_mel_plane and :211
// quantize_mel_plane_batch (K4), with or without ``frames``, the masked form
// being :176 _quantize_mel_masked. Input [B, F, M, 2] float32 and, for the
// masked form, frames [B] int32; output [B, M, F, 2] uint8 plus each row's
// max and min.
//
// Masked form (length-bucketed batches): row b's extrema come from its first
// f = min(max(frames[b], 0), F) frames only, which are the first f*M*2 floats
// of the row, so pass 1 just reduces a shorter row. Pass 2 quantizes all F
// frames with those extrema (pad frames clip), as the JAX program does. JAX
// takes the extrema of where(mask, x, -+FLT_MAX), so a row with pad frames
// (frames[b] < F) starts its reduction from the -+FLT_MAX sentinels instead
// of -+inf: a row with frames = 0 gives max -FLT_MAX and min +FLT_MAX, a
// negative range, and every pixel 127.
//
// NaN: the extrema propagate NaN, as JAX's max and min do (fmaxf would drop
// it). A NaN in a counted frame makes the row's (channel's, for KF) range NaN,
// which pins norm at 0.5: every pixel 127 (or 32767). A NaN in a pad frame
// never reaches the extrema.
//
// Numerics follow the JAX program exactly (quantize.py:72-74): subtract,
// divide by the range (never a reciprocal multiply), multiply by max_val,
// truncate, clip to [0, max_val]; a range <= 0 pins norm at 0.5. No fused
// multiply-add can form (no add follows a multiply), and division is IEEE,
// so the planes equal the JAX program's bit for bit on the same input. The
// extrema are exact, so any reduction order gives the same values: the
// result is deterministic.
//
// Bound: device memory. It reads the float32 spectrogram twice (3.4 MB per
// row at the mel path's shape) and writes a quarter of that. Design: pass 1
// reduces each row in `parts` blocks to partial extrema; pass 2 runs 32x32
// (frame, mel) tiles, each block first folding its row's partials (a few
// hundred bytes, from L2) into the final extrema, then quantizing with
// coalesced float2 loads and writing the transposed uint8 pairs through a
// shared-memory tile, so both the loads and the stores coalesce.
#include <float.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;

// NaN-propagating max and min (JAX semantics): one max.NaN / min.NaN
// instruction each (sm_80 and later); equal to fmaxf / fminf (max.f32,
// min.f32) for any other input
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void warp_minmax(float& mx, float& mn) {
  for (int off = 16; off > 0; off >>= 1) {
    mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    mn = min_nan(mn, __shfl_xor_sync(0xffffffffu, mn, off));
  }
}

// Elements of row b that pass 1 reduces, and its starting extrema: the whole
// row from -+inf (unmasked), or the first frames[b] frames from -+inf when no
// frame is masked and from the -+FLT_MAX sentinels when some are.
__device__ __forceinline__ long long masked_count(const int* frames, int b,
                                                  long long n, int n_frames,
                                                  long long frame_elems,
                                                  float& lo, float& hi) {
  lo = -INFINITY;
  hi = INFINITY;
  if (frames == nullptr) return n;
  const int f = frames[b];
  if (f >= n_frames) return n;
  lo = -FLT_MAX;
  hi = FLT_MAX;
  return f > 0 ? static_cast<long long>(f) * frame_elems : 0;
}

__global__ void minmax_partial_kernel(const float* __restrict__ x, long long n,
                                      const int* __restrict__ frames,
                                      int n_frames, long long frame_elems,
                                      int parts, float2* __restrict__ partial) {
  __shared__ float s_mx[32];
  __shared__ float s_mn[32];
  const int b = blockIdx.y;
  const float* src = x + static_cast<long long>(b) * n;
  float mx, mn;
  const long long count = masked_count(frames, b, n, n_frames, frame_elems, mx,
                                       mn);
  const long long step = static_cast<long long>(parts) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < count; i += step) {
    const float v = src[i];
    mx = max_nan(mx, v);
    mn = min_nan(mn, v);
  }
  warp_minmax(mx, mn);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_mx[warp] = mx;
    s_mn[warp] = mn;
  }
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    mx = lane < warps ? s_mx[lane] : -INFINITY;
    mn = lane < warps ? s_mn[lane] : INFINITY;
    warp_minmax(mx, mn);
    if (lane == 0) partial[static_cast<long long>(b) * parts + blockIdx.x] = make_float2(mx, mn);
  }
}

__device__ __forceinline__ unsigned quantize_one(float v, float mn, float rng,
                                                 float max_val) {
  const float norm = (rng > 0.0f) ? (v - mn) / rng : 0.5f;
  float q = truncf(max_val * norm);
  q = fminf(fmaxf(q, 0.0f), max_val);
  return static_cast<unsigned>(q);
}

__global__ void quantize_mel_kernel(const float2* __restrict__ x,
                                    const float2* __restrict__ partial,
                                    int parts, uchar2* __restrict__ out,
                                    float* __restrict__ mx_out,
                                    float* __restrict__ mn_out, int frames,
                                    int mels, float max_val) {
  __shared__ float s_ext[2];
  __shared__ unsigned short tile[kTile][kTile + 1];
  const int b = blockIdx.z;

  if (threadIdx.y == 0) {
    float mx = -INFINITY;
    float mn = INFINITY;
    for (int p = threadIdx.x; p < parts; p += kTile) {
      const float2 e = partial[static_cast<long long>(b) * parts + p];
      mx = max_nan(mx, e.x);
      mn = min_nan(mn, e.y);
    }
    warp_minmax(mx, mn);
    if (threadIdx.x == 0) {
      s_ext[0] = mx;
      s_ext[1] = mn;
      if (blockIdx.x == 0 && blockIdx.y == 0) {
        mx_out[b] = mx;
        mn_out[b] = mn;
      }
    }
  }
  __syncthreads();
  const float mx = s_ext[0];
  const float mn = s_ext[1];
  const float rng = mx - mn;

  const int f0 = blockIdx.x * kTile;
  const int m0 = blockIdx.y * kTile;
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const int f = f0 + j;
    const int m = m0 + threadIdx.x;
    if (f < frames && m < mels) {
      const float2 v = x[(static_cast<long long>(b) * frames + f) * mels + m];
      tile[j][threadIdx.x] = static_cast<unsigned short>(
          quantize_one(v.x, mn, rng, max_val) |
          (quantize_one(v.y, mn, rng, max_val) << 8));
    }
  }
  __syncthreads();
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const int m = m0 + j;
    const int f = f0 + threadIdx.x;
    if (f < frames && m < mels) {
      const unsigned short t = tile[threadIdx.x][j];
      out[(static_cast<long long>(b) * mels + m) * frames + f] =
          make_uchar2(static_cast<unsigned char>(t & 0xff),
                      static_cast<unsigned char>(t >> 8));
    }
  }
}

}  // namespace

// x: float32 [batch, frames, mels, 2]; true_frames: int32 [batch] (masked
// form) or null (unmasked); partial: float32 scratch [batch, parts, 2]; out:
// uint8 [batch, mels, frames, 2]; mx, mn: float32 [batch].
GOMEL_API int gomel_quantize_mel(const void* x, const void* true_frames,
                                 void* partial, void* out, void* mx, void* mn,
                                 long long batch, long long frames,
                                 long long mels, int parts, float max_val,
                                 int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = frames * mels * 2;
  minmax_partial_kernel<<<dim3(parts, static_cast<unsigned>(batch)), 256, 0, s>>>(
      static_cast<const float*>(x), n, static_cast<const int*>(true_frames),
      static_cast<int>(frames), mels * 2, parts, static_cast<float2*>(partial));
  const int err = gomel_status();
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>((frames + kTile - 1) / kTile),
                  static_cast<unsigned>((mels + kTile - 1) / kTile),
                  static_cast<unsigned>(batch));
  quantize_mel_kernel<<<grid, dim3(kTile, kRows), 0, s>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(partial), parts,
      static_cast<uchar2*>(out), static_cast<float*>(mx),
      static_cast<float*>(mn), static_cast<int>(frames),
      static_cast<int>(mels), max_val);
  return gomel_status();
}

namespace {

// ---------------------------------------------------------------------------
// KF: phase PNG quantizer.
//
// Replaces gomel_tpu/ops/quantize.py:30 quantize_planes and :185
// quantize_planes_batch (K6), with or without ``frames``, the masked form
// being :164 _quantize_planes_masked (the asinh passes come before the mask,
// and the mask and NaN rules are KD's, per channel). Input
// [B, F, nf, 2] float32; output [B, nf, F, 2] uint8 (max_val 255) or uint16
// (HDR, max_val 65535), plus each row's per-channel maxs [B, 2] and
// mins [B, 2]. KD's two passes, with three changes: the extrema are per
// channel; ``ihs_passes`` x asinhf is applied to every value before both the
// extrema and the quantize (recomputed in pass 2 rather than stored: the
// spectrogram is read twice either way); the planes are 8 or 16 bits.
//
// Numerics: JAX's op order (quantize.py:39-47): asinh passes, subtract,
// divide by the range, multiply by max_val, truncate, clip; a range <= 0
// pins norm at 0.5. No multiply feeds an add, so no fused multiply-add can
// form. Without IHS the planes equal the plain version's bit for bit; with
// it they can differ where asinhf and the plain version's asinh differ in
// the last bit and a truncation sits on that boundary.
//
// Bound: device memory, as KD: it reads the float32 spectrogram twice
// (13.8 MB per row at the phase CLI width) and writes a quarter (uint8) or
// half (uint16) of that, through the same shared-memory transpose.

__device__ __forceinline__ float ihs_forward(float v, int passes) {
  for (int p = 0; p < passes; ++p) v = asinhf(v);
  return v;
}

__device__ __forceinline__ void block_minmax4(float4& e) {
  // e = (mx0, mx1, mn0, mn1) reduced over the block, result in warp 0
  __shared__ float4 s_e[32];
  warp_minmax(e.x, e.z);
  warp_minmax(e.y, e.w);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) s_e[warp] = e;
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    e = lane < warps ? s_e[lane]
                     : make_float4(-INFINITY, -INFINITY, INFINITY, INFINITY);
    warp_minmax(e.x, e.z);
    warp_minmax(e.y, e.w);
  }
}

__global__ void minmax_planes_partial_kernel(const float2* __restrict__ x,
                                             long long n,
                                             const int* __restrict__ frames,
                                             int n_frames, long long bins,
                                             int parts, int ihs_passes,
                                             float4* __restrict__ partial) {
  const int b = blockIdx.y;
  const float2* src = x + static_cast<long long>(b) * n;
  float lo, hi;
  const long long count = masked_count(frames, b, n, n_frames, bins, lo, hi);
  float4 e = make_float4(lo, lo, hi, hi);
  const long long step = static_cast<long long>(parts) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < count; i += step) {
    const float2 v = src[i];
    const float a = ihs_forward(v.x, ihs_passes);
    const float c = ihs_forward(v.y, ihs_passes);
    e.x = max_nan(e.x, a);
    e.y = max_nan(e.y, c);
    e.z = min_nan(e.z, a);
    e.w = min_nan(e.w, c);
  }
  block_minmax4(e);
  if (threadIdx.x == 0) partial[static_cast<long long>(b) * parts + blockIdx.x] = e;
}

template <typename T2>
__global__ void quantize_planes_kernel(const float2* __restrict__ x,
                                       const float4* __restrict__ partial,
                                       int parts, T2* __restrict__ out,
                                       float2* __restrict__ mx_out,
                                       float2* __restrict__ mn_out, int frames,
                                       int bins, float max_val, int ihs_passes) {
  using E = decltype(T2::x);
  __shared__ float s_ext[4];
  __shared__ unsigned tile[kTile][kTile + 1];
  const int b = blockIdx.z;

  if (threadIdx.y == 0) {
    float4 e = make_float4(-INFINITY, -INFINITY, INFINITY, INFINITY);
    for (int p = threadIdx.x; p < parts; p += kTile) {
      const float4 q = partial[static_cast<long long>(b) * parts + p];
      e.x = max_nan(e.x, q.x);
      e.y = max_nan(e.y, q.y);
      e.z = min_nan(e.z, q.z);
      e.w = min_nan(e.w, q.w);
    }
    warp_minmax(e.x, e.z);
    warp_minmax(e.y, e.w);
    if (threadIdx.x == 0) {
      s_ext[0] = e.x;
      s_ext[1] = e.y;
      s_ext[2] = e.z;
      s_ext[3] = e.w;
      if (blockIdx.x == 0 && blockIdx.y == 0) {
        mx_out[b] = make_float2(e.x, e.y);
        mn_out[b] = make_float2(e.z, e.w);
      }
    }
  }
  __syncthreads();
  const float mn0 = s_ext[2];
  const float mn1 = s_ext[3];
  const float rng0 = s_ext[0] - mn0;
  const float rng1 = s_ext[1] - mn1;

  const int f0 = blockIdx.x * kTile;
  const int k0 = blockIdx.y * kTile;
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const int f = f0 + j;
    const int k = k0 + threadIdx.x;
    if (f < frames && k < bins) {
      const float2 v = x[(static_cast<long long>(b) * frames + f) * bins + k];
      tile[j][threadIdx.x] =
          quantize_one(ihs_forward(v.x, ihs_passes), mn0, rng0, max_val) |
          (quantize_one(ihs_forward(v.y, ihs_passes), mn1, rng1, max_val) << 16);
    }
  }
  __syncthreads();
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const int k = k0 + j;
    const int f = f0 + threadIdx.x;
    if (f < frames && k < bins) {
      const unsigned t = tile[threadIdx.x][j];
      T2 o;
      o.x = static_cast<E>(t & 0xffffu);
      o.y = static_cast<E>(t >> 16);
      out[(static_cast<long long>(b) * bins + k) * frames + f] = o;
    }
  }
}

}  // namespace

// x: float32 [batch, frames, bins, 2]; true_frames: int32 [batch] (masked
// form) or null (unmasked); partial: float32 scratch [batch, parts, 4]; out:
// [batch, bins, frames, 2] uint8 (max_val <= 255) or uint16; mx, mn: float32
// [batch, 2].
GOMEL_API int gomel_quantize_planes(const void* x, const void* true_frames,
                                    void* partial, void* out, void* mx,
                                    void* mn, long long batch,
                                    long long frames, long long bins,
                                    int parts, float max_val, int ihs_passes,
                                    int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  minmax_planes_partial_kernel<<<dim3(parts, static_cast<unsigned>(batch)), 256,
                                 0, s>>>(
      static_cast<const float2*>(x), frames * bins,
      static_cast<const int*>(true_frames), static_cast<int>(frames), bins,
      parts, ihs_passes, static_cast<float4*>(partial));
  const int err = gomel_status();
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>((frames + kTile - 1) / kTile),
                  static_cast<unsigned>((bins + kTile - 1) / kTile),
                  static_cast<unsigned>(batch));
  const float4* part = static_cast<const float4*>(partial);
  const float2* src = static_cast<const float2*>(x);
  if (max_val > 255.0f) {
    quantize_planes_kernel<ushort2><<<grid, dim3(kTile, kRows), 0, s>>>(
        src, part, parts, static_cast<ushort2*>(out), static_cast<float2*>(mx),
        static_cast<float2*>(mn), static_cast<int>(frames),
        static_cast<int>(bins), max_val, ihs_passes);
  } else {
    quantize_planes_kernel<uchar2><<<grid, dim3(kTile, kRows), 0, s>>>(
        src, part, parts, static_cast<uchar2*>(out), static_cast<float2*>(mx),
        static_cast<float2*>(mn), static_cast<int>(frames),
        static_cast<int>(bins), max_val, ihs_passes);
  }
  return gomel_status();
}
