// K5: one-sided (Hestenes) Jacobi on PSD rows in caterpillar order, no
// rotation accumulator: for PSD input the converged rows are lambda_i v_i^T.
//
// Replaces dealii_slod_tpu/ops/eig.py: jacobi_eigh_pallas (the kernel
// closure over _caterpillar_round_nj).  Sorting and normalization
// (_finalize_rows) stay outside, in torch.
// What bounds it on the card: latency.  A (126, 126) matrix needs up to
// 12 sweeps x 125 rounds, each round one pair dot per row pair and a
// rotation of 2 x 126 values -- a chain of ~1500 dependent steps with very
// little arithmetic per step.  Design: one CTA per matrix, the n rows in
// shared memory (62 KB f32, 124 KB f64) for the whole run, so global
// memory is touched once each way.  Each round the n/2 pairs rotate in
// parallel, one warp per pair (the pair dot is a warp reduction), carried
// row norms are updated analytically and refreshed exactly at every sweep
// boundary.  The caterpillar advance only permutes a slot -> row table;
// rows never move.  eps = finfo.tiny * 1e3 and the null_rel gate of the
// convergence monitor are those of the TPU kernel.
// Stopping rule: the TPU kernel shares `off` over a block of 16 matrices;
// here each matrix stops on its own (sweeps stop once every significant
// pair's squared row-cosine in the previous sweep was below tol), i.e.
// the plain version's block=1 semantics.

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    jacobi_rows_kernel(const T* __restrict__ G, T* __restrict__ XTo,
                       T* __restrict__ XBo, int n, int sweeps, T tol,
                       T null_rel, T eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T warp_red[THREADS / 32];
  __shared__ T s_val;
  const int m = n / 2;
  T* X = reinterpret_cast<T*>(smem_raw);     // n x n, physical rows
  T* nrm = X + (size_t)n * n;                // carried row norms^2
  int* slotT = reinterpret_cast<int*>(nrm + n);
  int* slotB = slotT + m;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = THREADS / 32;
  const size_t base = (size_t)blockIdx.x * n * n;

  for (int e = tid; e < n * n; e += THREADS) X[e] = G[base + e];
  for (int i = tid; i < m; i += THREADS) {
    slotT[i] = 2 * i;
    slotB[i] = 2 * i + 1;
  }
  __syncthreads();

  // exact row norms^2, then their block max (amax2)
  auto refresh = [&]() {
    for (int r = warp; r < n; r += nwarps) {
      T s = T(0);
      for (int l = lane; l < n; l += 32) s += X[r * n + l] * X[r * n + l];
      s = slod::warp_sum(s);
      if (lane == 0) nrm[r] = s;
    }
    __syncthreads();
  };
  refresh();
  if (tid == 0) {
    T mx = T(0);
    for (int r = 0; r < n; ++r) mx = nrm[r] > mx ? nrm[r] : mx;
    s_val = mx;
  }
  __syncthreads();
  const T gate = (null_rel * s_val) * (null_rel * s_val);

  T off = T(3.4028234663852886e38);   // float32 max, as the TPU kernel
  for (int it = 0; tol > T(0) ? (it < sweeps && off > tol) : it < sweeps;
       ++it) {
    if (it > 0) refresh();
    T off_w = T(0);
    for (int rnd = 0; rnd < n - 1; ++rnd) {
      for (int q = warp; q < m; q += nwarps) {
        const int rt = slotT[q], rb = slotB[q];
        T* xt = X + rt * n;
        T* xb = X + rb * n;
        T c = T(0);
        for (int l = lane; l < n; l += 32) c += xt[l] * xb[l];
        c = slod::warp_sum(c);
        const T a = nrm[rt], b = nrm[rb];
        if (a * b > gate) {
          const T cos2 = (c * c) / (a * b + eps);
          off_w = cos2 > off_w ? cos2 : off_w;
        }
        const bool big = fabs(c) > eps;
        const T zeta = (b - a) / (T(2) * (big ? c : T(1)));
        const T sgn = zeta >= T(0) ? T(1) : T(-1);
        const T t = big ? sgn / (fabs(zeta) + sqrt(T(1) + zeta * zeta))
                        : T(0);
        const T cs = T(1) / sqrt(T(1) + t * t);
        const T sn = cs * t;
        for (int l = lane; l < n; l += 32) {
          const T u = xt[l], v = xb[l];
          xt[l] = cs * u - sn * v;
          xb[l] = sn * u + cs * v;
        }
        __syncwarp();   // every lane has read a, b before lane 0 writes
        if (lane == 0) {
          const T csnc = cs * sn * c;
          nrm[rt] = cs * cs * a - T(2) * csnc + sn * sn * b;
          nrm[rb] = sn * sn * a + T(2) * csnc + cs * cs * b;
        }
      }
      __syncthreads();
      if (m > 1) {   // caterpillar: t' = [t0, b0, t1..t_{m-2}],
                     //              b' = [b1..b_{m-1}, t_{m-1}]
        int nt = 0, nb = 0;
        if (tid < m) {
          nt = tid == 0 ? slotT[0] : (tid == 1 ? slotB[0] : slotT[tid - 1]);
          nb = tid < m - 1 ? slotB[tid + 1] : slotT[m - 1];
        }
        __syncthreads();
        if (tid < m) {
          slotT[tid] = nt;
          slotB[tid] = nb;
        }
        __syncthreads();
      }
    }
    if (lane == 0) warp_red[warp] = off_w;
    __syncthreads();
    if (tid == 0) {
      T mx = T(0);
      for (int w = 0; w < nwarps; ++w) mx = warp_red[w] > mx ? warp_red[w] : mx;
      s_val = mx;
    }
    __syncthreads();
    off = s_val;
    __syncthreads();
  }

  const size_t obase = (size_t)blockIdx.x * m * n;
  for (int e = tid; e < m * n; e += THREADS) {
    const int q = e / n, l = e - q * n;
    XTo[obase + e] = X[slotT[q] * n + l];
    XBo[obase + e] = X[slotB[q] * n + l];
  }
}

template <typename T>
int launch_jacobi(void* G, void* XT, void* XB, int B, int n, int sweeps,
                  double tol, double null_rel, double eps, void* stream) {
  if (B <= 0 || n < 2 || n % 2) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)n * n + n) * sizeof(T) + (size_t)n * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  jacobi_rows_kernel<T><<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)G, (T*)XT, (T*)XB, n, sweeps, (T)tol, (T)null_rel, (T)eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slod_jacobi_rows_f32(void* G, void* XT, void* XB, int B, int n,
                         int sweeps, double tol, double null_rel, double eps,
                         void* stream) {
  return launch_jacobi<float>(G, XT, XB, B, n, sweeps, tol, null_rel, eps,
                              stream);
}
int slod_jacobi_rows_f64(void* G, void* XT, void* XB, int B, int n,
                         int sweeps, double tol, double null_rel, double eps,
                         void* stream) {
  return launch_jacobi<double>(G, XT, XB, B, n, sweeps, tol, null_rel, eps,
                               stream);
}

}  // extern "C"
