// KE: framed, windowed real FFT as (imag, real) planes — the phase encode.
//
// Replaces gomel_tpu/ops/phase_ops.py:27 phase_encode and :55
// phase_encode_batch (K5): frames x Hann -> rfft -> (imag, real) of bins
// 1..nf. The same entry point serves gomel_tpu/ops/fftbackend.py:50
// rfft_planes on framed input (hop = n, no window, bins 0..n/2).
// On the TPU the FFT was the matrix-unit Cooley-Tukey split; here it is KB's
// float32 Stockham FFT (fft_core.cuh), one thread block per frame, the frame
// read straight from the signal with the window applied on load.
//
// Output: out[frame, j] = (Im X[first + j], Re X[first + j]) for j < count,
// as float2, so the [..., F, nf, 2] layout of the JAX op comes out directly
// (phase_ops.py:51) and the stores coalesce. Bin n/2 has Im 0.
//
// Precision: float32 on the CUDA cores only (no TF32, no tensor cores): the
// encode FFT sits before the quantizer's extrema, and the repo's rule keeps
// everything upstream of the PNG quantizer at full float32.
//
// Bound: as KB's (the 11 barrier-separated radix-2 passes and shared-memory
// traffic, not device memory): at the phase path's 2 x 1122 frames it reads
// the 11.5 MB signal (frames overlap in L2) and writes 27.6 MB of planes.
#include "fft_core.cuh"

namespace {

template <bool kPow2>
__global__ void stft_planes_kernel(const float* __restrict__ x,
                                   const float* __restrict__ window,
                                   const float2* __restrict__ tw,
                                   float2* __restrict__ out, int frames,
                                   long long batch_stride, long long hop,
                                   int m, int first, int count) {
  extern __shared__ float2 smem[];
  const long long frame = blockIdx.x;
  const long long bi = frame / frames;
  const long long fi = frame - bi * frames;
  load_frame(reinterpret_cast<float*>(smem), x + bi * batch_stride + fi * hop,
             window, 2 * m);
  const float2* z = complex_fft<false, kPow2>(smem, smem + m, tw, m);

  float2* dst = out + frame * count;
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const float2 v = real_split_bin(z, tw, first + j, m);
    dst[j] = make_float2(v.y, v.x);
  }
}

}  // namespace

// x: float32 signal, frame (b, f) starting at x + b*batch_stride + f*hop;
// window: float32 [n] or null; tw: float2 [n/2]; out: float32
// [batch*frames, count, 2] holding (im, re) of bins first..first+count-1,
// with first + count <= n/2 + 1. n must be an even size of the TPU's
// n1 * n2 split (ops/fftbackend.ct_supported; the wrapper checks).
GOMEL_API int gomel_stft_planes(const void* x, const void* window,
                                const void* tw, void* out, long long batch,
                                long long frames, long long batch_stride,
                                long long hop, long long n, int first,
                                int count, int device, void* stream) {
  cudaSetDevice(device);
  const int m = static_cast<int>(n / 2);
  const size_t smem = 2 * static_cast<size_t>(m) * sizeof(float2);
  launch_frames(
      is_pow2(m) ? stft_planes_kernel<true> : stft_planes_kernel<false>,
      batch * frames, m, smem, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(x), static_cast<const float*>(window),
      static_cast<const float2*>(tw), static_cast<float2*>(out),
      static_cast<int>(frames), batch_stride, hop, m, first, count);
  return gomel_status();
}
