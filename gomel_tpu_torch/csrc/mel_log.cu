// KC: mel filterbank + log of magnitudes in device memory — log(max(mags @
// W_ext, 1e-5)).
//
// Replaces gomel_tpu/ops/mel_ops.py:98 _mel_from_mags (K3) where the
// magnitudes come from elsewhere than KB's power-of-two kernel (the mixed
// radix, the xla and mm routes, direct callers of ops/mel_ops._mel_from_mags);
// on KB's power-of-two route the fused launch of rfft_mag.cu runs the same
// band sum (mel_bands.cuh) on magnitudes that never leave shared memory.
// The output [rows, 2M] is the [B, F, M, 2] log-mel.
//
// Bound: bytes. At the mel path's 2 x 1122 frames of 4096 it reads 18.4 MB
// of magnitudes and 12 KB of band table and writes 3.4 MB: 0.0065 ms at
// 3.35 TB/s; the 4.1 K multiply-adds a frame are far below the FMA rate.
// Design: persistent blocks (SMs x resident blocks) walk tiles of frames
// x, x + gridDim.x, ... (one frame a tile at n = 4096); a tile's
// magnitudes are one contiguous span of device memory, copied with 16-byte
// cp.async into one of two shared-memory stages while the block sums the
// other, so the next tile's loads are in flight during the band sums. Rows
// start on 4-byte boundaries only (2049 floats at n = 4096): the copy
// covers the span rounded out to 16 bytes, and the sums index past the
// rounding. The band table is read through L1 (12 KB, shared by the blocks
// of an SM). Two knobs stay for tools/profile_mel.py's ablation:
// kTableShared stages the table in shared memory once a block (0.0139
// against 0.0143 ms on an H100 in one run, within the runs' spread),
// kMelRows sums a column for several frames a lane (no faster than one
// frame a tile).
#include "mel_bands.cuh"

namespace {

constexpr int kMelLogThreads = 256;
// bytes of magnitudes a tile aims at: 1 frame at n = 4096 (and 3000, and
// 16384), 8 at 512; tiles of 2, 4 and 8 frames at 4096 ran 7-95% slower on
// an H100 (tools/profile_mel.py): the band sums wait on latency, and small
// stages leave room for more blocks an SM
constexpr int kMelTileBytes = 9 * 1024;
constexpr int kMelTileMaxRows = 16;
constexpr int kMelRows = 1;  // frames a lane sums at once
constexpr bool kTableShared = false;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The 16-byte aligned span around rows [r0, r0 + nrows) of mags.
__device__ __forceinline__ const float* span_start(const float* mags,
                                                   long long r0, int bins) {
  return reinterpret_cast<const float*>(
      reinterpret_cast<uintptr_t>(mags + r0 * bins) & ~uintptr_t{15});
}

__global__ void __launch_bounds__(kMelLogThreads)
mel_log_kernel(const float* __restrict__ mags, MelTable table,
               float* __restrict__ out, long long rows, int bins,
               int tile_rows, int stage_floats, int table_floats) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (kTableShared) {
    // weights, then the slots (int4), after the two stages
    float* w = smem + 2 * stage_floats;
    for (int i = threadIdx.x; i < table_floats; i += blockDim.x) {
      w[i] = table.weights[i];
    }
    int4* sl = reinterpret_cast<int4*>(w + (table_floats + 3) / 4 * 4);
    for (int i = threadIdx.x; i < table.groups * kMelBands; i += blockDim.x) {
      sl[i] = table.slots[i];
    }
    table.weights = w;
    table.slots = sl;
  }
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  auto fetch = [&](long long tile, int stage) {
    const long long r0 = tile * tile_rows;
    const long long n = (rows - r0 < tile_rows ? rows - r0 : tile_rows) * bins;
    const float* a0 = span_start(mags, r0, bins);
    const float* end = mags + r0 * bins + n;
    const int chunks = static_cast<int>((end - a0 + 3) / 4);
    float* dst = smem + stage * stage_floats;
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      cp_async16(dst + 4 * c, a0 + 4 * c);
    }
  };
  long long tile = blockIdx.x;
  if (tile < tiles) fetch(tile, 0);
  cp_async_commit();
  for (int stage = 0; tile < tiles; tile += gridDim.x, stage ^= 1) {
    const long long next = tile + gridDim.x;
    if (next < tiles) fetch(next, stage ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // this tile's copies, not the next one's
    __syncthreads();
    const long long r0 = tile * tile_rows;
    const int nrows =
        static_cast<int>(rows - r0 < tile_rows ? rows - r0 : tile_rows);
    const int skip = static_cast<int>(mags + r0 * bins - span_start(mags, r0, bins));
    mel_band_sums<kTableShared, kMelRows>(smem + stage * stage_floats + skip,
                                          bins, nrows, table,
                                          out + r0 * table.cols);
    __syncthreads();  // the stage is read before the copy after next refills it
  }
}

}  // namespace

// mags: float32 [rows, bins] (any 4-byte aligned start); slots: int32
// [groups * 16, 4] and weights: float32 [table_floats], the band table of
// ops/mel_ops.mel_band_plan (groups a multiple of 4); out: float32
// [rows, cols].
GOMEL_API int gomel_mel_log(const void* mags, const void* slots,
                            const void* weights, int groups,
                            long long table_floats, void* out, long long rows,
                            long long bins, long long cols, int device,
                            void* stream) {
  cudaSetDevice(device);
  if (groups % kMelWarps != 0 || bins < 1 || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int tile_rows = static_cast<int>(kMelTileBytes / (bins * 4));
  if (tile_rows < 1) tile_rows = 1;
  if (tile_rows > kMelTileMaxRows) tile_rows = kMelTileMaxRows;
  // the tile's rows and up to 3 floats of rounding at each end, in 16 bytes
  const int stage_floats =
      static_cast<int>((tile_rows * bins + 8 + 3) / 4 * 4);
  size_t smem = 2 * static_cast<size_t>(stage_floats) * sizeof(float);
  if (kTableShared) {
    smem += ((table_floats + 3) / 4 * 4) * sizeof(float) +
            static_cast<size_t>(groups) * kMelBands * sizeof(int4);
  }
  const void* kernel = reinterpret_cast<const void*>(mel_log_kernel);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(mel_log_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  long long blocks = resident_blocks(kernel, kMelLogThreads, smem, device);
  if (blocks > tiles) blocks = tiles;
  const MelTable table{static_cast<const int4*>(slots),
                       static_cast<const float*>(weights), groups,
                       static_cast<int>(cols)};
  mel_log_kernel<<<static_cast<unsigned>(blocks), kMelLogThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mags), table, static_cast<float*>(out), rows,
      static_cast<int>(bins), tile_rows, stage_floats,
      static_cast<int>(table_floats));
  return gomel_status();
}
