// Shared device helpers of the port's kernels.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>

namespace slod {

// Dynamic shared memory one CTA may opt in to on the current device
// (cudaDevAttrMaxSharedMemoryPerBlockOptin: 227 KB on an H100), queried
// once per device; 0 if the query fails.
inline size_t max_smem_optin() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      return 0;
    cache[dev] = v;
  }
  return (size_t)cache[dev];
}

// Head-room kept below max_smem_optin() for a kernel's static __shared__
// arrays when its dynamic buffer is sized against the limit.
constexpr size_t STATIC_SMEM_MARGIN = 1024;

// 16 bytes of T, for one vector load or store.
template <typename T>
struct alignas(16) Vec16 {
  T v[16 / sizeof(T)];
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Opts kernel `fn` in to `bytes` of dynamic shared memory on the current
// device (needed above 48 KB), calling cudaFuncSetAttribute only where
// `bytes` exceeds what `fn` was already opted in to there: once per kernel
// and device on a path whose sizes do not grow.  The table is shared by
// every launcher and guarded: ctypes drops the GIL during a launch, so two
// threads may launch at once.
inline cudaError_t opt_in_smem(const void* fn, size_t bytes) {
  struct Entry {
    const void* fn;
    int dev;
    size_t bytes;
  };
  static Entry done[128];
  static int n_done = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> hold(mu);
  int i = 0;
  while (i < n_done && (done[i].fn != fn || done[i].dev != dev)) ++i;
  if (i < n_done && bytes <= done[i].bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  if (i < n_done)
    done[i].bytes = bytes;
  else if (n_done < 128)
    done[n_done++] = Entry{fn, dev, bytes};
  return cudaSuccess;
}

}  // namespace slod
