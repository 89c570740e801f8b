// The overlap-add body of KK (griffinlim.cu), the window sum and PCM-16
// conversion shared by KH (phase_decode.cu) and KM (shard_epilogue.cu), and
// the hop-row walk KH and KM run on.
//
// Every output sample t = i * hop + c (hop-row i, column c) has one owner, so
// there are no atomics and the sum is deterministic. It adds the
// K = ceil(n / hop) frames covering t with k ascending (frame i - k, column
// k * hop + c), from 0.0f, each add rounded on its own: the order of
// gomel_tpu/ops/istft.py:35-37, so the sum equals the plain version's bit for
// bit.
#pragma once

#include <math.h>

#include <initializer_list>

#include "common.cuh"

// KK's body: one thread a sample, every tap bounds-checked.
__device__ __forceinline__ float ola_sum(const float* __restrict__ src,
                                         long long i, int c, int frames,
                                         int n, int hop, int taps) {
  float acc = 0.0f;
  for (int k = 0; k < taps; ++k) {
    const long long fi = i - k;
    const int col = k * hop + c;
    float v = 0.0f;
    if (fi >= 0 && fi < frames && col < n) v = src[fi * n + col];
    acc = __fadd_rn(acc, v);
  }
  return acc;
}

// The window sum of ``frames`` frames at hop-row i (< frames + taps - 1),
// column c, from the [taps, hop] prefix table S[k] = sum_{j <= k} of the
// hop-rows of w^2 (gomel_tpu/ops/istft.py:51-72): head, periodic middle and
// tail rows, or the short form.
__device__ __forceinline__ float window_sum_at(const float* __restrict__ table,
                                               long long i, int c, int frames,
                                               int taps, int hop,
                                               int short_form) {
  const long long rows_out = static_cast<long long>(frames) + taps - 1;
  if (short_form) {
    const float top = table[min(i, static_cast<long long>(taps - 1)) * hop + c];
    const long long s = i - frames;
    const float sub =
        s >= 0 ? table[min(s, static_cast<long long>(taps - 1)) * hop + c]
               : 0.0f;
    return top - sub;
  }
  const float full = table[static_cast<long long>(taps - 1) * hop + c];
  if (i < taps - 1) return table[i * hop + c];
  if (i < rows_out - (taps - 1)) return full;
  return full - table[(i - (rows_out - (taps - 1))) * hop + c];
}

// gomel_tpu/ops/quantize.py:124 pcm16_encode for one sample: clip to
// [-1, 1], rintf(x * 32768) (round half to even), saturate; NaN stores 0, as
// the JAX program's conversion gives. The caller clears the finite flag.
__device__ __forceinline__ int16_t pcm16_sample(float y) {
  float q = isnan(y) ? 0.0f : fminf(fmaxf(y, -1.0f), 1.0f);
  q = fminf(fmaxf(rintf(q * 32768.0f), -32768.0f), 32767.0f);
  return static_cast<int16_t>(q);
}

// normalize_by_window_sum's three branches (gomel_tpu/ops/istft.py:202-207)
// for one sample: t / ws above the threshold, t / threshold in the fade,
// t where the window sum vanishes.
__device__ __forceinline__ float normalize_sample(float t, float ws,
                                                  float threshold) {
  return ws > threshold ? __fdiv_rn(t, ws)
                        : (ws > 1e-21f ? __fdiv_rn(t, threshold) : t);
}

// -- The hop-row walk of KH and KM ------------------------------------------
//
// No sample's position is divided (a 64-bit division is a software routine
// of several dozen instructions: the card has no 64-bit divider), and the
// accesses are 16 bytes wide where the shapes allow. A thread owns a group
// of kV adjacent columns of a hop-row (kV = 4 on the vector path: float4
// loads and stores, one 8-byte store of 4 PCM-16 samples; kV = 1 on the
// scalar path, for any shape) and walks hop-rows; its hop-row, column and
// sample index follow by adds. Adjacent threads own
// adjacent groups, so a warp reads and writes 512 contiguous bytes (vector
// path). When a hop-row has fewer groups than the block has threads, the
// block covers per_pass hop-rows at once (one 32-bit division a thread, at
// its start); block x takes passes x, x + gridDim.x, ... A thread that owns
// several groups (hop / kV > blockDim.x) walks every hop-row for one group,
// then for the next.
struct OlaThread {
  int groups;      // column groups of a hop-row: hop / kV
  int group;       // the thread's first column group
  long long row;   // its first hop-row of the walk
  long long step;  // hop-rows between two of its rows: gridDim.x * per_pass
};

// False for the threads past per_pass full hop-rows of groups.
template <int kV>
__device__ __forceinline__ bool ola_thread(int hop, OlaThread& w) {
  w.groups = hop / kV;
  int per_pass = 1, sub = 0;
  w.group = threadIdx.x;
  if (w.groups < static_cast<int>(blockDim.x)) {
    per_pass = blockDim.x / w.groups;
    sub = threadIdx.x / w.groups;
    w.group = threadIdx.x - sub * w.groups;
  }
  w.row = static_cast<long long>(blockIdx.x) * per_pass + sub;
  w.step = static_cast<long long>(gridDim.x) * per_pass;
  return sub < per_pass;
}

// kV adjacent float32 samples.
template <int kV>
struct Lanes {
  float v[kV];
};

template <int kV>
__device__ __forceinline__ Lanes<kV> load_lanes(const float* p) {
  Lanes<kV> r;
  if constexpr (kV == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.v[0] = q.x;
    r.v[1] = q.y;
    r.v[2] = q.z;
    r.v[3] = q.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int kV>
__device__ __forceinline__ void store_lanes(float* p, const Lanes<kV>& y) {
  if constexpr (kV == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(y.v[0], y.v[1], y.v[2], y.v[3]);
  } else {
    *p = y.v[0];
  }
}

template <int kV>
__device__ __forceinline__ void store_pcm16(int16_t* p, const Lanes<kV>& y) {
  if constexpr (kV == 4) {
    *reinterpret_cast<short4*>(p) =
        make_short4(pcm16_sample(y.v[0]), pcm16_sample(y.v[1]),
                    pcm16_sample(y.v[2]), pcm16_sample(y.v[3]));
  } else {
    *p = pcm16_sample(y.v[0]);
  }
}

// The window sum at hop-row i (< frames + taps - 1), columns c .. c + kV - 1.
// Hop-rows mid_lo <= i < mid_hi are the periodic middle (taps - 1 <= i <
// frames), whose value ``full``, the table's last row, the thread loaded once
// for its columns; the head and tail rows, and every row of the short form
// (mid_lo = mid_hi = 0), take window_sum_at's branches.
template <int kV>
__device__ __forceinline__ Lanes<kV> window_sum_lanes(
    const float* __restrict__ table, long long i, int c, const Lanes<kV>& full,
    long long mid_lo, long long mid_hi, int frames, int taps, int hop,
    int short_form) {
  if (i >= mid_lo && i < mid_hi) return full;
  Lanes<kV> w;
#pragma unroll
  for (int l = 0; l < kV; ++l) {
    w.v[l] = window_sum_at(table, i, c + l, frames, taps, hop, short_form);
  }
  return w;
}

// -- The launch of KH and KM (host) ---------------------------------------

// A block: a warp multiple covering a hop-row's column groups, at most 512
// threads (the kernels' __launch_bounds__).
constexpr int kOlaMaxThreads = 512;

// The walk's row when KM has no window sum to index (its Griffin-Lim
// modes): any width walks the same samples, and this one is a multiple of 4.
constexpr int kOlaPlainRow = 1024;

inline int ola_threads(int groups) {
  const int t = (groups + 31) / 32 * 32;
  return t > kOlaMaxThreads ? kOlaMaxThreads : t;
}

// The path of a launch: the vector path (kV = 4) when every extent given is
// a multiple of 4, so no group of 4 straddles a hop-row, a frame's end or a
// row of an input or output, and every pointer (null ones pass) is 16-byte
// aligned; else the scalar path (kV = 1), which takes any shape.
inline bool ola_vector(std::initializer_list<long long> extents,
                       std::initializer_list<const void*> pointers) {
  for (const long long e : extents) {
    if (e % 4 != 0) return false;
  }
  for (const void* p : pointers) {
    if (!aligned16(p)) return false;
  }
  return true;
}

// Blocks along the hop-rows of each batch row: as many as the card holds at
// once (SMs x the kernel's resident blocks an SM), shared by the batch rows,
// and no more than the walk has passes. Each block then walks rows x,
// x + gridDim.x, ... with no second wave behind it.
template <class Kernel>
inline unsigned ola_blocks(Kernel kernel, int threads, int groups,
                           long long rows, long long batch, int device) {
  const int per_pass = groups < threads ? threads / groups : 1;
  const long long passes = (rows + per_pass - 1) / per_pass;
  long long blocks =
      resident_blocks(reinterpret_cast<const void*>(kernel), threads, 0,
                      device) /
      (batch > 0 ? batch : 1);
  if (blocks > passes) blocks = passes;
  return static_cast<unsigned>(blocks > 0 ? blocks : 1);
}
