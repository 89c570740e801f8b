// KD: mel PNG quantizer — per-row GLOBAL extrema (one max and one min over
//     both channels), trunc(255 * norm), transpose to uint8 planes.
// KF: phase PNG quantizer — the same with per-channel extrema, an asinh
//     prologue and uint8 or uint16 planes.
// Both run the one two-pass design below; a compile-time flag (kGlobal)
// picks KD's global extrema or KF's per-channel ones.
//
// KD replaces gomel_tpu/ops/quantize.py:63 quantize_mel_plane and :211
// quantize_mel_plane_batch (K4), the masked form being :176
// _quantize_mel_masked: input [B, F, M, 2] float32 (and frames [B] int32),
// output [B, M, F, 2] uint8 plus each row's max [B] and min [B].
// KF replaces gomel_tpu/ops/quantize.py:30 quantize_planes and :185
// quantize_planes_batch (K6), the masked form being :164
// _quantize_planes_masked (the asinh passes come before the mask): input
// [B, F, nf, 2] float32, output [B, nf, F, 2] uint8 (max_val 255) or uint16
// (HDR, max_val 65535), plus each row's per-channel maxs [B, 2] and mins
// [B, 2]. ``ihs_passes`` x asinhf is applied to every value before both the
// extrema and the quantize (recomputed in pass 2 rather than stored: the
// spectrogram is read twice either way); KD has none.
//
// Masked form (length-bucketed batches): row b's extrema come from its first
// f = min(max(frames[b], 0), F) frames only, which are the first f * X * 2
// floats of the row, so pass 1 just reduces a shorter row. Pass 2 quantizes
// all F frames with those extrema (pad frames clip), as the JAX program does.
// JAX takes the extrema of where(mask, x, -+FLT_MAX), so a row with pad
// frames (frames[b] < F) starts its reduction from the -+FLT_MAX sentinels
// instead of -+inf: a row with frames = 0 gives max -FLT_MAX and min
// +FLT_MAX, a negative range, and every pixel the midpoint.
//
// NaN: the extrema propagate NaN, as JAX's max and min do (fmaxf would drop
// it). A NaN in a counted frame makes the row's (KF: the channel's) range
// NaN, which pins norm at 0.5: every pixel 127 (or 32767). A NaN in a pad
// frame never reaches the extrema. KD's fold merges the two channels'
// extrema with the same NaN-propagating max and min, so its rules are KF's
// per-channel rules, merged.
//
// Numerics follow the JAX program exactly (quantize.py:39-47, :72-74):
// subtract, divide by the range (never a reciprocal multiply), multiply by
// max_val, truncate, clip to [0, max_val]; a range <= 0 pins norm at 0.5.
// No fused multiply-add can form (no add follows a multiply), and division
// is IEEE, so without IHS the planes equal the plain version's bit for bit;
// with it they can differ where asinhf and the plain version's asinh differ
// in the last bit and a truncation sits on that boundary. The extrema are
// exact, so any order of the reduction and of the fold gives the same bits.
//
// Bound: device memory. One read of the input and one write of the planes:
// KF 27.6 + 6.9 MB at the bench shape [2, 1122, 1536, 2], 0.0103 ms at
// 3.35 TB/s; KD 3.45 + 0.86 MB at [2, 1122, 192, 2], 0.0013 ms. The two
// passes read the input twice; at the bench shapes the second read can come
// from the 50 MB L2, at the long-form shapes (KD 103.7 MB, KF 829 MB) it
// cannot. Design, against the form both replaced (64 pass-1 blocks a row,
// one 4- or 8-byte load a loop trip; every pass-2 block folding all of its
// row's partials; 64-byte warp stores):
//   pass 1  a grid sized to the card: the SMs x the kernel's resident blocks
//           (common.cuh resident_blocks), shared by the rows, but no more
//           blocks a row than give each thread one trip of kPlanesUnroll
//           quads. A row is a head of up to 3 floats to the first 16-byte
//           boundary, quads of 4 floats (two bins' (re, im): a float4, a
//           warp's load 512 contiguous bytes, kPlanesUnroll of them in
//           flight a thread, a grid stride apart) and a tail of up to 3
//           floats; the head and tail go one float a thread. Float i of a
//           row is channel i % 2, so an odd head swaps the quads' channels.
//           Any 4-byte aligned base, any X and a masked count that ends
//           mid-quad take this one path. Each block writes its partial
//           extrema, and the last block of a row to finish (a per-row
//           ticket, atomicInc after __threadfence) folds the row's partials
//           once into mx, mn (KD: and the two channels into one); the ticket
//           wraps to 0 for the next call.
//   pass 2  tiles of kTileF = 32 frames x kTileK = 64 bins, 256 threads:
//           warp w takes the tile's 4-frame group w (and w + 8 of a 64-frame
//           tile, tools/profile_quant.py's tile_64 build), lane j its bins
//           (2j, 2j + 1): 4 16-byte loads in flight a group (warp-contiguous
//           512 bytes each) where the base is 16-byte aligned and X even,
//           else 4 float loads each; it quantizes them, packs each bin's 4
//           pixels into one 8- or 16-byte shared-memory store ([bin][frame],
//           the 4-frame slots swizzled by bin / 2 so no two lanes of a phase
//           share a bank), and after the barrier a warp stores 4-byte words
//           of the tile's bin rows: uint8 rows are 64 bytes (two pixels a
//           lane where the row starts on an even pixel, else one uchar2 a
//           lane), two rows an instruction; uint16 rows 128 bytes (one
//           ushort2 a lane), one row an instruction. 32 frames and not 64
//           (KF's earlier tile): twice the blocks, 6 and not 5 resident an
//           SM, and faster at every shape measured, KD's bench grid (108
//           tiles of 64 frames, under the 132 SMs) and KF's long form alike
//           (tools/profile_quant.py).
// What is left (tools/profile_quant.py): pass 1 alone runs near the
// one-read byte rate and a build whose pass 2 stores bytes of the input in
// place of pixels runs near the two-pass floor; the rest is pass 2's
// per-value arithmetic (the IEEE division), kept as it is so the bits stay
// JAX's.
#include <float.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kPlanesThreads = 256;
constexpr int kPlanesUnroll = 4;  // pass 1: quads a thread has in flight
constexpr int kTileF = 32;        // pass 2: frames a tile (32 or 64)
constexpr int kTileK = 64;        // pass 2: bins a tile (32 lanes x a pair)

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

// e = (max ch 0, max ch 1, min ch 0, min ch 1)
__device__ __forceinline__ void fold_pair(float4& e, float c0, float c1) {
  e.x = max_nan(e.x, c0);
  e.y = max_nan(e.y, c1);
  e.z = min_nan(e.z, c0);
  e.w = min_nan(e.w, c1);
}

__device__ __forceinline__ void block_minmax4(float4& e) {
  // e reduced over the block, result in warp 0
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

// Pass 1: grid (parts, batch). row_floats = F * X * 2; tickets: uint32
// [batch], 0 before the launch and again after it. mx_out, mn_out: float32
// [batch] (kGlobal) or [batch, 2].
template <bool kGlobal>
__global__ void __launch_bounds__(kPlanesThreads)
planes_minmax_kernel(const float* __restrict__ x, long long row_floats,
                     const int* __restrict__ frames, int n_frames,
                     long long frame_floats, int ihs_passes,
                     float4* __restrict__ partial,
                     unsigned* __restrict__ tickets,
                     float* __restrict__ mx_out, float* __restrict__ mn_out) {
  __shared__ bool s_last;
  const int b = blockIdx.y;
  const int parts = gridDim.x;
  const float* src = x + static_cast<long long>(b) * row_floats;
  float lo, hi;
  const long long count = masked_count(frames, b, row_floats, n_frames,
                                       frame_floats, lo, hi);
  float4 e = make_float4(lo, lo, hi, hi);
  const long long to_16 =
      ((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) / 4;
  const long long head = to_16 < count ? to_16 : count;
  const long long quads = (count - head) / 4;
  const bool swap = head & 1;  // the quads start on channel 1
  const float4* q4 = reinterpret_cast<const float4*>(src + head);
  const long long stride = static_cast<long long>(parts) * blockDim.x;
  for (long long q0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       q0 < quads; q0 += kPlanesUnroll * stride) {
    float4 v[kPlanesUnroll];
#pragma unroll
    for (int u = 0; u < kPlanesUnroll; ++u) {
      const long long q = q0 + u * stride;
      if (q < quads) v[u] = q4[q];
    }
#pragma unroll
    for (int u = 0; u < kPlanesUnroll; ++u) {
      if (q0 + u * stride < quads) {
        const float a = ihs_forward(v[u].x, ihs_passes);
        const float c = ihs_forward(v[u].y, ihs_passes);
        const float d = ihs_forward(v[u].z, ihs_passes);
        const float f = ihs_forward(v[u].w, ihs_passes);
        if (swap) {
          fold_pair(e, c, a);
          fold_pair(e, f, d);
        } else {
          fold_pair(e, a, c);
          fold_pair(e, d, f);
        }
      }
    }
  }
  // the head (threads 0-2 of block 0) and the tail (threads 4-6)
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const int t = threadIdx.x;
    const long long i = t < 4 ? t : head + 4 * quads + (t - 4);
    if (t < 4 ? i < head : i < count) {
      const float v = ihs_forward(src[i], ihs_passes);
      if (i & 1) {
        e.y = max_nan(e.y, v);
        e.w = min_nan(e.w, v);
      } else {
        e.x = max_nan(e.x, v);
        e.z = min_nan(e.z, v);
      }
    }
  }
  block_minmax4(e);
  if (threadIdx.x == 0) {
    partial[static_cast<long long>(b) * parts + blockIdx.x] = e;
    __threadfence();
    s_last = atomicInc(&tickets[b], static_cast<unsigned>(parts - 1)) ==
             static_cast<unsigned>(parts - 1);
  }
  __syncthreads();
  if (!s_last) return;
  // the row's last block: fold its partials once (from L2: other blocks
  // wrote them)
  e = make_float4(-INFINITY, -INFINITY, INFINITY, INFINITY);
  for (int p = threadIdx.x; p < parts; p += blockDim.x) {
    const float4 q = __ldcg(partial + static_cast<long long>(b) * parts + p);
    e.x = max_nan(e.x, q.x);
    e.y = max_nan(e.y, q.y);
    e.z = min_nan(e.z, q.z);
    e.w = min_nan(e.w, q.w);
  }
  block_minmax4(e);
  if (threadIdx.x == 0) {
    if constexpr (kGlobal) {
      mx_out[b] = max_nan(e.x, e.y);
      mn_out[b] = min_nan(e.z, e.w);
    } else {
      reinterpret_cast<float2*>(mx_out)[b] = make_float2(e.x, e.y);
      reinterpret_cast<float2*>(mn_out)[b] = make_float2(e.z, e.w);
    }
  }
}

// One pixel: channel 0 in the low half, channel 1 in the high half.
template <int kShift>
__device__ __forceinline__ unsigned planes_pixel(float v0, float v1, float mn0,
                                                 float rng0, float mn1,
                                                 float rng1, float max_val,
                                                 int ihs_passes) {
  return quantize_one(ihs_forward(v0, ihs_passes), mn0, rng0, max_val) |
         (quantize_one(ihs_forward(v1, ihs_passes), mn1, rng1, max_val)
          << kShift);
}

// Pass 2: grid (ceil(F / kTileF), ceil(X / 64), batch), 256 threads. kPix: 2
// (uint8 pixels) or 4 (uint16); kVec: 16-byte loads (x 16-byte aligned, X
// even); kGlobal: one range for both channels (KD).
template <int kPix, bool kVec, bool kGlobal>
__global__ void __launch_bounds__(kPlanesThreads)
planes_quantize_kernel(const float* __restrict__ x,
                       const float* __restrict__ mx_in,
                       const float* __restrict__ mn_in, void* __restrict__ out,
                       int frames, int bins, float max_val, int ihs_passes) {
  constexpr int kGroups = kTileF / 32;   // 4-frame groups a warp
  constexpr int kSlots = kTileF / 4;     // 4-frame slots a bin row
  constexpr int kShift = 4 * kPix;       // channel 1's bits in a pixel
  constexpr int kRowBytes = kTileF * kPix;
  constexpr int kSlot = 4 * kPix;        // 4 frames of one bin
  constexpr int kWords = kRowBytes / 4;  // 4-byte words a bin row
  constexpr int kLanes = kWords < 32 ? kWords : 32;  // lanes a bin row
  constexpr int kBins = 32 / kLanes;     // bin rows a warp's store
  static_assert(kTileF == 32 || kTileF == 64, "32- or 64-frame tiles");
  __shared__ __align__(16) unsigned char tile[kTileK * kRowBytes];
  const int b = blockIdx.z;
  const int f0 = blockIdx.x * kTileF;
  const int k0 = blockIdx.y * kTileK;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = k0 + 2 * lane;

  float4 v[kGroups][4];
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = f0 + 4 * (warp + 8 * gi) + i;
      v[gi][i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (f < frames && k < bins) {
        const float* p = x + 2 * ((static_cast<long long>(b) * frames + f) *
                                      bins + k);
        if constexpr (kVec) {
          v[gi][i] = *reinterpret_cast<const float4*>(p);
        } else {
          v[gi][i].x = p[0];
          v[gi][i].y = p[1];
          if (k + 1 < bins) {
            v[gi][i].z = p[2];
            v[gi][i].w = p[3];
          }
        }
      }
    }
  }
  float mn0, mn1, rng0, rng1;
  if constexpr (kGlobal) {
    mn0 = mn1 = mn_in[b];
    rng0 = rng1 = mx_in[b] - mn0;
  } else {
    const float2 mx = reinterpret_cast<const float2*>(mx_in)[b];
    const float2 mn = reinterpret_cast<const float2*>(mn_in)[b];
    mn0 = mn.x;
    mn1 = mn.y;
    rng0 = mx.x - mn0;
    rng1 = mx.y - mn1;
  }
  const int swz = lane & (kSlots - 1);  // rows 2 lane and 2 lane + 1
  // uint8 rows of 64 bytes: a lane's two rows lie 16 banks apart and lanes
  // l and l + 8 share a swizzle, so lanes 8-15 of a half-warp write their
  // odd row first
  const bool odd_first = kRowBytes == 64 && (lane & kSlots);
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    const int slot = (warp + 8 * gi) ^ swz;
    unsigned p0[4], p1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p0[i] = planes_pixel<kShift>(v[gi][i].x, v[gi][i].y, mn0, rng0, mn1,
                                   rng1, max_val, ihs_passes);
      p1[i] = planes_pixel<kShift>(v[gi][i].z, v[gi][i].w, mn0, rng0, mn1,
                                   rng1, max_val, ihs_passes);
    }
    unsigned char* r0 = tile + (2 * lane) * kRowBytes + slot * kSlot;
    unsigned char* r1 = r0 + kRowBytes;
    if constexpr (kPix == 2) {
      const uint2 w0 = make_uint2(p0[0] | (p0[1] << 16), p0[2] | (p0[3] << 16));
      const uint2 w1 = make_uint2(p1[0] | (p1[1] << 16), p1[2] | (p1[3] << 16));
      *reinterpret_cast<uint2*>(odd_first ? r1 : r0) = odd_first ? w1 : w0;
      *reinterpret_cast<uint2*>(odd_first ? r0 : r1) = odd_first ? w0 : w1;
    } else {
      *reinterpret_cast<uint4*>(r0) = make_uint4(p0[0], p0[1], p0[2], p0[3]);
      *reinterpret_cast<uint4*>(r1) = make_uint4(p1[0], p1[1], p1[2], p1[3]);
    }
  }
  __syncthreads();

  // a warp stores kBins bin rows an instruction, a 4-byte word a lane: warp
  // w takes bins kBins w + lane / kLanes, then 8 kBins on
  const int wl = lane % kLanes;
  for (int r = kBins * warp + lane / kLanes; r < kTileK && k0 + r < bins;
       r += 8 * kBins) {
    const long long p0 =
        (static_cast<long long>(b) * bins + k0 + r) * frames + f0;
    const unsigned char* row = tile + r * kRowBytes;
    const int s = (r >> 1) & (kSlots - 1);
#pragma unroll
    for (int h = 0; h < kWords / kLanes; ++h) {
      if constexpr (kPix == 2) {
        const int f = 2 * (wl + kLanes * h);
        const unsigned w = *reinterpret_cast<const unsigned*>(
            row + ((f >> 2) ^ s) * kSlot + (f & 3) * kPix);
        unsigned short* o = static_cast<unsigned short*>(out) + p0 + f;
        if ((p0 & 1) == 0 && f0 + f + 1 < frames) {
          *reinterpret_cast<unsigned*>(o) = w;
        } else {
          if (f0 + f < frames) o[0] = static_cast<unsigned short>(w & 0xffffu);
          if (f0 + f + 1 < frames) o[1] = static_cast<unsigned short>(w >> 16);
        }
      } else {
        const int f = wl + kLanes * h;
        if (f0 + f < frames) {
          static_cast<unsigned*>(out)[p0 + f] =
              *reinterpret_cast<const unsigned*>(
                  row + ((f >> 2) ^ s) * kSlot + (f & 3) * kPix);
        }
      }
    }
  }
}

template <int kPix, bool kGlobal>
void launch_planes_quantize(long long batch, long long frames, long long bins,
                            bool vec, const float* x, const float* mx,
                            const float* mn, void* out, float max_val,
                            int ihs_passes, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((frames + kTileF - 1) / kTileF),
                  static_cast<unsigned>((bins + kTileK - 1) / kTileK),
                  static_cast<unsigned>(batch));
  auto kernel = vec ? planes_quantize_kernel<kPix, true, kGlobal>
                    : planes_quantize_kernel<kPix, false, kGlobal>;
  kernel<<<grid, kPlanesThreads, 0, s>>>(x, mx, mn, out,
                                         static_cast<int>(frames),
                                         static_cast<int>(bins), max_val,
                                         ihs_passes);
}

// Pass 1's blocks a row: the card's resident blocks shared by the rows, at
// most one trip of kPlanesUnroll quads a thread over a whole row, at least 1.
template <bool kGlobal>
long long planes_parts(long long batch, long long row_floats, int device) {
  const long long resident = resident_blocks(
      reinterpret_cast<const void*>(planes_minmax_kernel<kGlobal>),
      kPlanesThreads, 0, device);
  long long parts = (resident + batch - 1) / batch;
  const long long per_block = static_cast<long long>(kPlanesThreads) *
                              kPlanesUnroll;
  const long long usable = (row_floats / 4 + per_block - 1) / per_block;
  if (parts > usable) parts = usable;
  return parts > 0 ? parts : 1;
}

// Both passes of KD (kGlobal) or KF on one stream.
template <bool kGlobal>
int quantize_two_pass(const void* x, const void* true_frames, void* partial,
                      void* tickets, void* out, void* mx, void* mn,
                      long long batch, long long frames, long long bins,
                      int parts, float max_val, int ihs_passes, int device,
                      void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(x);
  float* mx_f = static_cast<float*>(mx);
  float* mn_f = static_cast<float*>(mn);
  planes_minmax_kernel<kGlobal><<<dim3(static_cast<unsigned>(parts),
                                       static_cast<unsigned>(batch)),
                                  kPlanesThreads, 0, s>>>(
      src, frames * bins * 2, static_cast<const int*>(true_frames),
      static_cast<int>(frames), bins * 2, ihs_passes,
      static_cast<float4*>(partial), static_cast<unsigned*>(tickets), mx_f,
      mn_f);
  const int err = gomel_status();
  if (err != 0) return err;
  const bool vec = aligned16(src) && bins % 2 == 0;
  if constexpr (!kGlobal) {  // KD's planes are uint8 only
    if (max_val > 255.0f) {
      launch_planes_quantize<4, false>(batch, frames, bins, vec, src, mx_f,
                                       mn_f, out, max_val, ihs_passes, s);
      return gomel_status();
    }
  }
  launch_planes_quantize<2, kGlobal>(batch, frames, bins, vec, src, mx_f,
                                     mn_f, out, max_val, ihs_passes, s);
  return gomel_status();
}

}  // namespace

// parts: host int64 [1], set to pass 1's blocks a row of gomel_quantize_mel
// at this shape on ``device`` (its partials' scratch is [batch, parts, 4]
// floats). Launches nothing; the stream is unused.
GOMEL_API int gomel_quantize_mel_parts(long long batch, long long frames,
                                       long long mels, void* parts, int device,
                                       void* stream) {
  (void)stream;
  cudaSetDevice(device);
  *static_cast<long long*>(parts) =
      planes_parts<true>(batch, frames * mels * 2, device);
  return gomel_status();
}

// KD. x: float32 [batch, frames, mels, 2], any 4-byte aligned start;
// true_frames: int32 [batch] (masked form) or null (unmasked); partial:
// float32 scratch [batch, parts, 4], parts from gomel_quantize_mel_parts;
// tickets: uint32 [batch], all 0 (and 0 again when the call has run); out:
// uint8 [batch, mels, frames, 2] (max_val <= 255); mx, mn: float32 [batch].
GOMEL_API int gomel_quantize_mel(const void* x, const void* true_frames,
                                 void* partial, void* tickets, void* out,
                                 void* mx, void* mn, long long batch,
                                 long long frames, long long mels, int parts,
                                 float max_val, int device, void* stream) {
  return quantize_two_pass<true>(x, true_frames, partial, tickets, out, mx,
                                 mn, batch, frames, mels, parts, max_val, 0,
                                 device, stream);
}

// parts: host int64 [1], set to pass 1's blocks a row of
// gomel_quantize_planes at this shape on ``device`` (its partials' scratch
// is [batch, parts, 4] floats). Launches nothing; the stream is unused.
GOMEL_API int gomel_quantize_planes_parts(long long batch, long long frames,
                                          long long bins, void* parts,
                                          int device, void* stream) {
  (void)stream;
  cudaSetDevice(device);
  *static_cast<long long*>(parts) =
      planes_parts<false>(batch, frames * bins * 2, device);
  return gomel_status();
}

// KF. x: float32 [batch, frames, bins, 2], any 4-byte aligned start;
// true_frames: int32 [batch] (masked form) or null (unmasked); partial:
// float32 scratch [batch, parts, 4], parts from gomel_quantize_planes_parts;
// tickets: uint32 [batch], all 0 (and 0 again when the call has run); out:
// [batch, bins, frames, 2] uint8 (max_val <= 255) or uint16; mx, mn: float32
// [batch, 2].
GOMEL_API int gomel_quantize_planes(const void* x, const void* true_frames,
                                    void* partial, void* tickets, void* out,
                                    void* mx, void* mn, long long batch,
                                    long long frames, long long bins,
                                    int parts, float max_val,
                                    int ihs_passes, int device, void* stream) {
  return quantize_two_pass<false>(x, true_frames, partial, tickets, out, mx,
                                  mn, batch, frames, bins, parts, max_val,
                                  ihs_passes, device, stream);
}
