// KB: framed, windowed real-FFT magnitude — |rfft_n(x[f*hop : f*hop+n] * w)|.
//
// Replaces gomel_tpu/ops/stft.py:35 frame_signal with the window multiply and
// gomel_tpu/ops/mxu_fft.py:140 rfft_mag (K2; reached through
// gomel_tpu/ops/fftbackend.py:65). On the TPU the FFT was a Cooley-Tukey split
// into two 32x128 dense matmuls on the matrix unit; on Hopper it is a radix-2
// Stockham FFT in shared memory, one thread block per frame (mixed radix for
// the other sizes of that split, such as n = 3000: fft_core.cuh).
//
// Precision: all arithmetic is float32 on the CUDA cores. No tensor cores and
// no TF32: an FFT below full float32 precision is catastrophic after the log
// of the mel filterbank on quiet bins. Twiddles come from a table the host
// computes in float64 and rounds to float32 (tw[j] = exp(-2 pi i j / n),
// j < n/2), not from sincosf.
//
// Algorithm (fft_core.cuh, shared with KE and KG): the n real samples are
// read as m = n/2 complex values z[k] = x[2k] + i x[2k+1] (the interleaved
// float layout IS that complex array, so the load is a plain coalesced copy
// with the window applied on the way); an m-point Stockham radix-2 FFT
// (log2 m passes between two shared buffers, natural order out) gives Z; the
// real-split post-pass forms the m + 1 rfft bins, and this kernel writes
// sqrtf(re^2 + im^2) for each.
//
// Bound: at the mel path's shape (2 x 1122 frames of 4096) the frames read
// 37 MB (the signal itself 11.5 MB; neighbouring frames overlap in L2) and the
// magnitudes write 18 MB, against about 0.5 GFLOP, so neither the memory
// (~20 us at 3.35 TB/s) nor the float32 rate bounds it; the 11 block-wide
// barriers of the radix-2 passes and shared-memory traffic do. The design
// keeps the [F, n] frame buffer out of device memory entirely (frames are
// read straight from the signal) and keeps the whole transform in one block's
// shared memory (2 x 16 KB at n = 4096). Radix-4 passes, a fused filterbank
// epilogue and several frames per block are later work.
#include "fft_core.cuh"

namespace {

template <bool kPow2>
__global__ void stft_mag_kernel(const float* __restrict__ x,
                                const float* __restrict__ window,
                                const float2* __restrict__ tw,
                                float* __restrict__ out, int frames,
                                long long batch_stride, long long hop, int m) {
  extern __shared__ float2 smem[];
  const long long frame = blockIdx.x;
  const long long bi = frame / frames;
  const long long fi = frame - bi * frames;
  load_frame(reinterpret_cast<float*>(smem), x + bi * batch_stride + fi * hop,
             window, 2 * m);
  const float2* z = complex_fft<false, kPow2>(smem, smem + m, tw, m);

  float* dst = out + frame * (m + 1);
  for (int k = threadIdx.x; k <= m; k += blockDim.x) {
    const float2 v = real_split_bin(z, tw, k, m);
    dst[k] = sqrtf(v.x * v.x + v.y * v.y);
  }
}

}  // namespace

// x: float32 signal, frame (b, f) starting at x + b*batch_stride + f*hop;
// window: float32 [n] or null; tw: float2 [n/2]; out: float32
// [batch*frames, n/2 + 1]. n must be an even size of the TPU's n1 * n2 split
// (ops/fftbackend.ct_supported; the wrapper checks).
GOMEL_API int gomel_stft_mag(const void* x, const void* window, const void* tw,
                             void* out, long long batch, long long frames,
                             long long batch_stride, long long hop, long long n,
                             int device, void* stream) {
  cudaSetDevice(device);
  const int m = static_cast<int>(n / 2);
  const size_t smem = 2 * static_cast<size_t>(m) * sizeof(float2);
  launch_frames(
      is_pow2(m) ? stft_mag_kernel<true> : stft_mag_kernel<false>,
      batch * frames, m, smem, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(x), static_cast<const float*>(window),
      static_cast<const float2*>(tw), static_cast<float*>(out),
      static_cast<int>(frames), batch_stride, hop, m);
  return gomel_status();
}
