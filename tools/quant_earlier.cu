// The forms of KD (the mel PNG quantizer), KF (the phase PNG quantizer) and
// KI (the mel decode front end) that the port shipped before their Hopper
// redesign, for tools/profile_quant.py's race, chip_smoke.py's bit-equality
// check of the new KI and tests/test_torch_cuda.py. Built only by
// tools/profile_quant.py, never into the port's library. The code is
// gomel_tpu_torch/csrc/quantize.cu and mel_decode.cu as they were, entry
// points renamed:
//
//   prof_old_quantize_mel     KD before: pass 1 in 64 blocks a row of 256
//                             threads, one 4-byte load a loop trip; pass 2
//                             in 32-frame x 32-mel tiles of 32 x 8 threads,
//                             each block first folding all 64 of its row's
//                             partials, one float2 load and, after a
//                             shared-memory transpose, one uchar2 store a
//                             thread (a warp's store 64 bytes).
//   prof_old_quantize_planes  KF before: pass 1 in 64 blocks a row of 256
//                             threads, one 8-byte float2 load a loop trip;
//                             pass 2 in 32-frame x 32-bin tiles of 32 x 8
//                             threads, each block first folding all 64 of
//                             its row's partials, one float2 load and,
//                             after a shared-memory transpose, one uchar2 or
//                             ushort2 store a thread (a warp's store 64 or
//                             128 bytes).
//   prof_old_mel_to_mag       KI before: one block of 256 threads a frame;
//                             the uint8 planes read one byte a value (each
//                             frame's column of the [M, F, 2] image, rows
//                             2F bytes apart); each output reading its
//                             bin's first mel, tap count and taps from
//                             global memory; 4-byte stores.
#include <float.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;

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

__device__ __forceinline__ unsigned quantize_one(float v, float mn, float rng,
                                                 float max_val) {
  const float norm = (rng > 0.0f) ? (v - mn) / rng : 0.5f;
  float q = truncf(max_val * norm);
  q = fminf(fmaxf(q, 0.0f), max_val);
  return static_cast<unsigned>(q);
}

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

constexpr int kFloat = 0;
constexpr int kQuant8 = 1;

template <int kMode>
__global__ void mel_to_mag_kernel(const void* __restrict__ src,
                                  const float* __restrict__ mgc_max,
                                  const float* __restrict__ mgc_min,
                                  const int* __restrict__ first,
                                  const int* __restrict__ count,
                                  const float* __restrict__ taps,
                                  float* __restrict__ out, int frames,
                                  int mels, int bins, int max_taps,
                                  float max_val, float boost, float tune_mul,
                                  float tune_add) {
  extern __shared__ float e[];  // [mels][2]: exp of the frame's log-mel
  const long long frame = blockIdx.x;
  const long long bi = frame / frames;
  const long long fi = frame - bi * frames;
  float mn = 0.0f;
  float rng = 0.0f;
  if constexpr (kMode == kQuant8) {
    mn = mgc_min[bi];
    rng = __fsub_rn(mgc_max[bi], mn);  // rounded to float32 first, as in JAX
  }
  for (int j = threadIdx.x; j < 2 * mels; j += blockDim.x) {
    float v;
    if constexpr (kMode == kFloat) {
      v = static_cast<const float*>(src)[frame * 2 * mels + j];
    } else {
      const long long m = j >> 1;
      const unsigned char q = static_cast<const unsigned char*>(
          src)[((bi * mels + m) * frames + fi) * 2 + (j & 1)];
      v = __fadd_rn(__fmul_rn(__fdiv_rn(static_cast<float>(q), max_val), rng),
                    mn);
    }
    if (boost != 0.0f) v = __fadd_rn(v, boost);
    e[j] = expf(v);
  }
  __syncthreads();

  float* dst = out + frame * (bins + 1);
  for (int k = threadIdx.x; k <= bins; k += blockDim.x) {
    const int row = k < bins ? k : bins - 1;
    const int c = k < bins ? 0 : 1;
    const int f0 = first[row];
    const int cnt = count[row];
    const float* w = taps + static_cast<long long>(row) * max_taps;
    float acc = 0.0f;
    for (int t = 0; t < cnt; ++t) acc = fmaf(w[t], e[2 * (f0 + t) + c], acc);
    dst[k] = fabsf(__fdiv_rn(__fsub_rn(acc, tune_add), tune_mul));
  }
}

template <int kMode>
int launch(const void* src, const float* mx, const float* mn, const int* first,
           const int* count, const float* taps, float* out, long long blocks,
           int frames, int mels, int bins, int max_taps, float max_val,
           float boost, float tune_mul, float tune_add, cudaStream_t s) {
  const size_t smem = 2 * static_cast<size_t>(mels) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(mel_to_mag_kernel<kMode>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  mel_to_mag_kernel<kMode><<<static_cast<unsigned>(blocks), 256, smem, s>>>(
      src, mx, mn, first, count, taps, out, frames, mels, bins, max_taps,
      max_val, boost, tune_mul, tune_add);
  return gomel_status();
}

}  // namespace

// x: float32 [batch, frames, mels, 2]; true_frames: int32 [batch] (masked
// form) or null (unmasked); partial: float32 scratch [batch, parts, 2]; out:
// uint8 [batch, mels, frames, 2]; mx, mn: float32 [batch].
GOMEL_API int prof_old_quantize_mel(const void* x, const void* true_frames,
                                    void* partial, void* out, void* mx,
                                    void* mn, long long batch,
                                    long long frames, long long mels,
                                    int parts, float max_val, int device,
                                    void* stream) {
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

GOMEL_API int prof_old_quantize_planes(const void* x, const void* true_frames,
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

GOMEL_API int prof_old_mel_to_mag(int mode, const void* src, const void* mgc_max,
                               const void* mgc_min, const void* first,
                               const void* count, const void* taps, void* out,
                               long long batch, long long frames,
                               long long mels, long long bins,
                               long long max_taps, float max_val, float boost,
                               float tune_mul, float tune_add, int device,
                               void* stream) {
  cudaSetDevice(device);
  const long long blocks = batch * frames;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mx = static_cast<const float*>(mgc_max);
  const float* mn = static_cast<const float*>(mgc_min);
  const int* f = static_cast<const int*>(first);
  const int* c = static_cast<const int*>(count);
  const float* w = static_cast<const float*>(taps);
  float* o = static_cast<float*>(out);
  const int fr = static_cast<int>(frames);
  const int m = static_cast<int>(mels);
  const int b = static_cast<int>(bins);
  const int t = static_cast<int>(max_taps);
  switch (mode) {
    case kFloat:
      return launch<kFloat>(src, mx, mn, f, c, w, o, blocks, fr, m, b, t,
                            max_val, boost, tune_mul, tune_add, s);
    case kQuant8:
      return launch<kQuant8>(src, mx, mn, f, c, w, o, blocks, fr, m, b, t,
                             max_val, boost, tune_mul, tune_add, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
