// Shared declarations of the port's hand-written kernels.
//
// Every kernel is reached through a plain C entry point (no PyTorch headers),
// loaded with ctypes by gomel_tpu_torch/ops/_cuda.py. Each entry point:
//   - takes the CUDA device index and PyTorch's current stream as its last
//     two arguments, and launches on that stream without synchronising;
//   - allocates nothing: the Python wrapper allocates outputs and scratch;
//   - returns cudaGetLastError(), which the wrapper turns into an exception
//     (a launch refused for its configuration never runs, and a later
//     synchronise would not report it).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#define GOMEL_API extern "C" __attribute__((visibility("default")))

static inline int gomel_status() { return static_cast<int>(cudaGetLastError()); }

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// SMs x the kernel's resident blocks an SM at ``threads`` a block and
// ``smem`` bytes of dynamic shared memory: the grid of a persistent launch.
// Asked of the runtime once for each (device, kernel, block size, shared
// memory) and kept: none changes, and the two queries would cost every
// launch microseconds. A failed query is not kept: its error stays for the
// launch's status.
inline long long resident_blocks(const void* kernel, int threads, size_t smem,
                                 int device) {
  struct Seen {
    const void* kernel;
    int threads, device;
    size_t smem;
    long long blocks;
  };
  static std::mutex lock;
  static std::vector<Seen> seen;
  const std::lock_guard<std::mutex> hold(lock);
  for (const Seen& s : seen) {
    if (s.kernel == kernel && s.threads == threads && s.device == device &&
        s.smem == smem) {
      return s.blocks;
    }
  }
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess ||
      sms < 1 || per_sm < 1) {
    return 1;
  }
  const long long blocks = static_cast<long long>(sms) * per_sm;
  seen.push_back({kernel, threads, device, smem, blocks});
  return blocks;
}
