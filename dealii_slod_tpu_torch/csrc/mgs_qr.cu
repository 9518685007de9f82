// K4: two-pass modified Gram-Schmidt thin Q of a batch of (n, k) blocks.
//
// Replaces dealii_slod_tpu/ops/eig.py: mgs_qr_pallas (_mgs_kernel), the
// orthonormalization of each inverse-subspace step of the smallk spectral
// stage: X (B, n, k) -> Q (B, n, k), k <= n.  Step j of a pass scales
// column j by rsqrt(|x_j|^2 + 1e-30) (so a null column comes out exactly
// zero, the TPU kernel's guard) and removes its component from every later
// column.  What bounds it on the card: the 2k-step dependency chain (two
// CTA barriers per step), not bytes or FLOPs -- a (125, 32) f32 block is
// 16 KB and ~0.5 MFLOP per pass pair.  Design: one CTA per matrix holds
// the k columns as rows of one buffer, so global memory is touched once
// each way; warp 0 normalizes row j, then one warp per later row forms its
// coefficient (a warp reduction) and subtracts.
//
// Where the rows live, chosen by size in launch_mgs: in shared memory when
// n*k*sizeof(T) fits what one CTA can opt in to (every diffusion shape;
// elasticity in float32, k = 32: 48 KB), else in a per-CTA slice of a
// global workspace that the caller allocates (float64 elasticity, n = 375,
// k = 374: 1.12 MB per matrix, beyond the 227 KB a CTA can have).  The
// global rows stay mostly in L2; that path serves float64 correctness runs
// and its speed is not a goal.

#include "common.cuh"

namespace {

constexpr int MGS_THREADS = 512;
constexpr int PASSES = 2;

template <typename T>
__device__ __forceinline__ T rsqrt_(T x);
template <>
__device__ __forceinline__ float rsqrt_<float>(float x) {
  return rsqrtf(x);
}
template <>
__device__ __forceinline__ double rsqrt_<double>(double x) {
  return rsqrt(x);
}

// gbuf: null for the shared-memory rows, else the global workspace
// (B, k, n) of which this CTA uses its own slice.
template <typename T>
__global__ void __launch_bounds__(MGS_THREADS)
    mgs_qr_kernel(const T* __restrict__ X, T* __restrict__ Q, T* gbuf, int n,
                  int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* R = gbuf ? gbuf + (size_t)blockIdx.x * n * k
              : reinterpret_cast<T*>(smem_raw);   // k rows of n
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = MGS_THREADS / 32;
  const size_t base = (size_t)blockIdx.x * n * k;

  for (int e = tid; e < n * k; e += MGS_THREADS) {
    const int l = e / k, j = e - l * k;
    R[j * n + l] = X[base + e];
  }
  __syncthreads();

  for (int p = 0; p < PASSES; ++p) {
    for (int j = 0; j < k; ++j) {
      T* rj = R + (size_t)j * n;
      if (warp == 0) {
        T s = T(0);
        for (int l = lane; l < n; l += 32) s += rj[l] * rj[l];
        const T scale = rsqrt_<T>(slod::warp_sum(s) + T(1e-30));
        for (int l = lane; l < n; l += 32) rj[l] *= scale;
      }
      __syncthreads();
      for (int i = j + 1 + warp; i < k; i += nwarps) {
        T* ri = R + (size_t)i * n;
        T c = T(0);
        for (int l = lane; l < n; l += 32) c += ri[l] * rj[l];
        c = slod::warp_sum(c);
        for (int l = lane; l < n; l += 32) ri[l] -= c * rj[l];
      }
      __syncthreads();
    }
  }

  for (int e = tid; e < n * k; e += MGS_THREADS) {
    const int l = e / k, j = e - l * k;
    Q[base + e] = R[j * n + l];
  }
}

// Elements of global workspace per matrix: 0 when the rows fit in shared
// memory, n*k otherwise; -1 if the device cannot be queried.
template <typename T>
long long mgs_ws_elems(int n, int k) {
  const size_t lim = slod::max_smem_optin();
  if (lim == 0) return -1;
  return (size_t)n * k * sizeof(T) <= lim ? 0 : (long long)n * k;
}

template <typename T>
int launch_mgs(void* X, void* Q, void* ws, int B, int n, int k,
               void* stream) {
  if (B <= 0 || n <= 0 || k <= 0 || k > n) return (int)cudaErrorInvalidValue;
  const long long ge = mgs_ws_elems<T>(n, k);
  if (ge < 0 || (ge > 0 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = ge > 0 ? 0 : (size_t)n * k * sizeof(T);
  const cudaError_t err = slod::opt_in_smem(
      reinterpret_cast<const void*>(mgs_qr_kernel<T>), smem);
  if (err != cudaSuccess) return (int)err;
  mgs_qr_kernel<T><<<B, MGS_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)X, (T*)Q, ge > 0 ? (T*)ws : nullptr, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slod_mgs_qr_f32(void* X, void* Q, void* ws, int B, int n, int k,
                    void* stream) {
  return launch_mgs<float>(X, Q, ws, B, n, k, stream);
}
int slod_mgs_qr_f64(void* X, void* Q, void* ws, int B, int n, int k,
                    void* stream) {
  return launch_mgs<double>(X, Q, ws, B, n, k, stream);
}
long long slod_mgs_qr_ws_f32(int n, int k) { return mgs_ws_elems<float>(n, k); }
long long slod_mgs_qr_ws_f64(int n, int k) {
  return mgs_ws_elems<double>(n, k);
}

}  // extern "C"
