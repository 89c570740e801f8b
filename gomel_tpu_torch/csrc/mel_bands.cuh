// The mel filterbank + log of frames whose rfft magnitudes sit in shared
// memory: the band sum of KC (mel_log.cu, magnitudes loaded from device
// memory) and of the fused KB + KC launch (rfft_mag.cu, magnitudes left in
// shared memory by the FFT's epilogue).
//
// Replaces gomel_tpu/ops/mel_ops.py:98 _mel_from_mags (K3): log(max(mags @
// W_ext, 1e-5)) with W_ext [n/2 + 1, 2M] the extended weights of
// gomel_tpu/ops/mel_ops.py:35, whose column 2j + c is mel band j shifted c
// bins up (c = 0, 1). Each band is non-zero on one span of bins [lo, lo +
// width), at most a few dozen wide, so a frame needs about 4.1 K
// multiply-adds at n = 4096, M = 192, not the dense product's 787 K.
//
// The band table (built on the host by ops/mel_ops.mel_band_plan) stores
// each band once, both columns reading the same weights:
//   - bands are sorted by width and cut into groups of kMelBands = 16, so a
//     group's bands have about the same width; lanes 2i and 2i + 1 of a warp
//     take band i of the group, channel c = lane & 1;
//   - a group's weights are t-major: weight t of its band i at
//     weights[base + 16 t + i], so a warp's 32 loads of one step are one
//     64-byte run (the two channels read the same word), cached in L1 and
//     shared by every block on the SM (9.3 KB at the CLI widths, and 3 KB
//     of slots);
//   - slot i of a group is {lo, width, output column of channel 0 (-1: an
//     empty slot), base + i};
//   - the groups are balanced over kMelWarps = 4 warps: the number of groups
//     is padded with empty ones to a multiple of 4, and group positions p
//     with the same p mod 4 hold about a quarter of the frame's work (the
//     warp-steps of a group are its widest band's width).
// The block's warps walk the items (frame, group) warp, warp + warps, ...;
// every block runs a multiple of 4 warps, so warp w always takes the groups
// at positions w mod 4.
//
// Order of arithmetic: each output column is one fmaf chain from 0.0f over
// its bins in ascending order, then max(acc, 1e-5) keeping a NaN (as
// jnp.maximum), then the IEEE logf; the order of the dense product's
// non-zero terms. No accumulator is split.
#pragma once

#include <math.h>

#include "common.cuh"

constexpr int kMelBands = 16;  // bands a group: a warp's 32 lanes, 2 each
constexpr int kMelWarps = 4;   // warps a frame's groups are balanced over

// The band table on the card (ops/mel_ops.MelBandPlan).
struct MelTable {
  const int4* slots;      // [groups * kMelBands]: lo, width, column, offset
  const float* weights;   // t-major a group
  int groups;             // a multiple of kMelWarps
  int cols;               // 2M, the output row
};

// One column of kRows frames (frame r's magnitudes at mags + r * stride):
// for each, the fmaf chain over bins lo .. lo + width - 1, weight t at
// w[woff + kMelBands t], loaded once for the kRows chains; kShared: the
// table was staged in shared memory (plain loads), else read through L1
// (__ldg).
template <bool kShared, int kRows>
__device__ __forceinline__ void mel_column(const float* mags, int stride,
                                           const float* __restrict__ w,
                                           int lo, int width, int woff,
                                           float* acc) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  const float* m = mags + lo;
#pragma unroll 4
  for (int t = 0; t < width; ++t) {
    const float wt =
        kShared ? w[woff + t * kMelBands] : __ldg(&w[woff + t * kMelBands]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = fmaf(m[r * stride + t], wt, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float a = (acc[r] < 1e-5f) ? 1e-5f : acc[r];  // max, NaN kept
    acc[r] = logf(a);
  }
}

// Item (rb, p) -> the item ``warps`` on: p + warps, wrapped into the next
// row blocks.
__device__ __forceinline__ void mel_next_item(int& p, int& rb, int warps,
                                              int groups) {
  p += warps;
  while (p >= groups) {
    p -= groups;
    ++rb;
  }
}

// Every thread of the block (a multiple of kMelWarps warps): the log-mel
// rows of frames 0 .. rows - 1, frame r's magnitudes at mags + r * stride
// (shared memory), its row at out + r * cols. An item is kRows frames of
// one group: its lanes run kRows chains each (the frames past rows read
// the last frame's magnitudes and store nothing).
template <bool kShared, int kRows>
__device__ __forceinline__ void mel_band_sums(const float* mags, int stride,
                                              int rows, const MelTable& t,
                                              float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int ch = lane & 1;
  // item i = rb groups + p, i = warp, warp + warps, ...: (rb, p) carried
  // from item to item by adds, with no division an item
  if (t.groups < 1) return;
  int rb = 0, p = warp;
  while (p >= t.groups) {
    p -= t.groups;
    ++rb;
  }
  for (; rb * kRows < rows; mel_next_item(p, rb, warps, t.groups)) {
    const int4 s = kShared ? t.slots[p * kMelBands + (lane >> 1)]
                           : __ldg(&t.slots[p * kMelBands + (lane >> 1)]);
    if (s.z < 0) continue;
    const int r0 = rb * kRows;
    const int r_stride = rows - r0 >= kRows ? stride : 0;
    float acc[kRows];
    mel_column<kShared, kRows>(mags + r0 * stride, r_stride, t.weights,
                               s.x + ch, s.y, s.w, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r0 + r < rows) {
        out[static_cast<long long>(r0 + r) * t.cols + s.z + ch] = acc[r];
      }
    }
  }
}
