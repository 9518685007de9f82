// Shared device helpers of the port's kernels.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Unpivoted Gauss-Jordan sweep inverse of one SPD (m, m) row-major matrix
// held in shared memory, by the whole CTA: M <- M^-1.  `col` and `row` are
// m-element shared scratch vectors.  Step k sweeps pivot k:
//   M[i,j] -= (M[i,k] / p) M[k,j];  row k <- row k / p;  col k <- col k / p;
//   M[k,k] <- -1 / p
// and after all m steps the matrix holds -M^-1 (the sweep operator; SPD
// pivots stay positive, so no pivoting).  This is the arithmetic of
// dealii_slod_tpu/ops/patch_solve.py: _gj_invert_spd.
template <typename T>
__device__ void gj_sweep_invert(T* M, T* col, T* row, int m) {
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int kp = 0; kp < m; ++kp) {
    for (int i = tid; i < m; i += nth) {
      col[i] = M[i * m + kp];
      row[i] = M[kp * m + i];
    }
    __syncthreads();
    const T d = T(1) / row[kp];
    for (int e = tid; e < m * m; e += nth) {
      const int i = e / m, j = e - i * m;
      T v;
      if (i == kp)
        v = (j == kp) ? -d : row[j] * d;
      else if (j == kp)
        v = col[i] * d;
      else
        v = M[e] - (col[i] * d) * row[j];
      M[e] = v;
    }
    __syncthreads();
  }
  for (int e = tid; e < m * m; e += nth) M[e] = -M[e];
  __syncthreads();
}

}  // namespace slod
