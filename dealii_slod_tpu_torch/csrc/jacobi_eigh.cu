// K5: one-sided (Hestenes) Jacobi on PSD rows in caterpillar order, no
// rotation accumulator: for PSD input the converged rows are lambda_i v_i^T.
// K8: the same sweeps on W = Z^T Y, which the kernel builds itself.
//
// K5 replaces dealii_slod_tpu/ops/eig.py: jacobi_eigh_pallas (the kernel
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
// Where the rows live, chosen by size in rows_ws_elems: the n x n rows sit
// in shared memory when they fit what one CTA can opt in to (every
// diffusion shape; elasticity in float32, k = 32), else in a per-CTA slice
// of a global workspace the caller allocates (float64 elasticity at
// n = 374: 1.1 MB per matrix, beyond the 227 KB a CTA can have); the row
// norms and the slot tables stay in shared memory either way.  The global
// path serves float64 correctness runs; its speed is not a goal.
// Stopping rule: the TPU kernel shares `off` over a block of 16 matrices;
// here each matrix stops on its own (sweeps stop once every significant
// pair's squared row-cosine in the previous sweep was below tol), i.e.
// the plain version's block=1 semantics.
//
// K8 replaces dealii_slod_tpu/ops/eig.py: weig_pallas, which builds
// W[i, j] = sum_l ZT[i, l] YT[j, l] inside the kernel (W = Z^T G Z of the
// smallk stage, NOT symmetrized) and sweeps it in the same launch.  What
// bounds it: the same sweep latency chain on a (k, k) W; the build is
// k^2 n FMAs (32 x 32 x 125 per matrix in f32), small.  Design: one CTA per
// matrix, one warp per W entry reads a row of ZT and a row of YT straight
// from global memory (coalesced; the two inputs, 32 KB per matrix in f32
// and 248 KB in f64 at k = 124, stay in L2 and would not fit in shared
// memory next to W at f64) and writes the warp-reduced dot into the shared
// row buffer that the sweep routine below then works on.  K5 and K8 share
// that routine, so they run the same sweeps.  The TPU kernel shared its
// stop over the whole batch (grid = ()); here each matrix stops on its own.

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;

// Shared state of one CTA's sweeps over an n x n row buffer X.
template <typename T>
struct Rows {
  T* X;        // n x n, physical rows
  T* nrm;      // carried row norms^2
  int* slotT;  // caterpillar slot -> physical row, n/2 each
  int* slotB;
};

// gX: null for rows in shared memory, else the global workspace
// (B, n, n) of which this CTA uses its own slice.
template <typename T>
__device__ Rows<T> carve(unsigned char* smem, int n, T* gX) {
  Rows<T> r;
  T* s = reinterpret_cast<T*>(smem);
  if (gX) {
    r.X = gX + (size_t)blockIdx.x * n * n;
    r.nrm = s;
  } else {
    r.X = s;
    r.nrm = s + (size_t)n * n;
  }
  r.slotT = reinterpret_cast<int*>(r.nrm + n);
  r.slotB = r.slotT + n / 2;
  return r;
}

template <typename T>
size_t rows_smem(int n, bool global_rows) {
  return ((global_rows ? 0 : (size_t)n * n) + n) * sizeof(T) +
         (size_t)n * sizeof(int);
}

// Elements of global workspace per matrix: 0 when the rows fit in shared
// memory, n*n otherwise; -1 if the device cannot be queried or even the
// norms and slot tables do not fit.
template <typename T>
long long rows_ws_elems(int n) {
  const size_t lim = slod::max_smem_optin();
  if (lim <= slod::STATIC_SMEM_MARGIN) return -1;
  if (rows_smem<T>(n, false) <= lim - slod::STATIC_SMEM_MARGIN) return 0;
  if (rows_smem<T>(n, true) > lim - slod::STATIC_SMEM_MARGIN) return -1;
  return (long long)n * n;
}

// The sweeps on the rows in R.X (filled by the caller, and the caller's
// writes made visible by a __syncthreads), then the rows in slot order to
// XTo / XBo (each m x n, m = n / 2, at this CTA's offset).
template <typename T>
__device__ void jacobi_sweeps(Rows<T> R, T* __restrict__ XTo,
                              T* __restrict__ XBo, int n, int sweeps, T tol,
                              T null_rel, T eps) {
  __shared__ T warp_red[THREADS / 32];
  __shared__ T s_val;
  const int m = n / 2;
  T* X = R.X;
  T* nrm = R.nrm;
  int* slotT = R.slotT;
  int* slotB = R.slotB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = THREADS / 32;

  for (int i = tid; i < m; i += THREADS) {
    slotT[i] = 2 * i;
    slotB[i] = 2 * i + 1;
  }
  __syncthreads();

  // exact row norms^2, then their max over the matrix (amax2)
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

// K5: rows of G (B, n, n), one CTA per matrix.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    jacobi_rows_kernel(const T* __restrict__ G, T* __restrict__ XTo,
                       T* __restrict__ XBo, T* gX, int n, int sweeps, T tol,
                       T null_rel, T eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Rows<T> R = carve<T>(smem_raw, n, gX);
  const size_t base = (size_t)blockIdx.x * n * n;
  for (int e = threadIdx.x; e < n * n; e += THREADS) R.X[e] = G[base + e];
  __syncthreads();
  jacobi_sweeps<T>(R, XTo, XBo, n, sweeps, tol, null_rel, eps);
}

// K8: W = ZT YT^T from ZT, YT (B, k, nf), then the sweeps on W's rows.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    weig_kernel(const T* __restrict__ ZT, const T* __restrict__ YT,
                T* __restrict__ XTo, T* __restrict__ XBo, T* gX, int k,
                int nf, int sweeps, T tol, T null_rel, T eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Rows<T> R = carve<T>(smem_raw, k, gX);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = (size_t)blockIdx.x * k * nf;
  for (int e = warp; e < k * k; e += THREADS / 32) {
    const T* z = ZT + base + (size_t)(e / k) * nf;
    const T* y = YT + base + (size_t)(e % k) * nf;
    T s = T(0);
    for (int l = lane; l < nf; l += 32) s += z[l] * y[l];
    s = slod::warp_sum(s);
    if (lane == 0) R.X[e] = s;
  }
  __syncthreads();
  jacobi_sweeps<T>(R, XTo, XBo, k, sweeps, tol, null_rel, eps);
}

template <typename T>
int launch_jacobi(void* G, void* XT, void* XB, void* ws, int B, int n,
                  int sweeps, double tol, double null_rel, double eps,
                  void* stream) {
  if (B <= 0 || n < 2 || n % 2) return (int)cudaErrorInvalidValue;
  const long long ge = rows_ws_elems<T>(n);
  if (ge < 0 || (ge > 0 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = rows_smem<T>(n, ge > 0);
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  jacobi_rows_kernel<T><<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)G, (T*)XT, (T*)XB, ge > 0 ? (T*)ws : nullptr, n, sweeps,
      (T)tol, (T)null_rel, (T)eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_weig(void* ZT, void* YT, void* XT, void* XB, void* ws, int B,
                int k, int nf, int sweeps, double tol, double null_rel,
                double eps, void* stream) {
  if (B <= 0 || k < 2 || k % 2 || nf <= 0) return (int)cudaErrorInvalidValue;
  const long long ge = rows_ws_elems<T>(k);
  if (ge < 0 || (ge > 0 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = rows_smem<T>(k, ge > 0);
  cudaError_t err = cudaFuncSetAttribute(
      weig_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  weig_kernel<T><<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)ZT, (const T*)YT, (T*)XT, (T*)XB,
      ge > 0 ? (T*)ws : nullptr, k, nf, sweeps, (T)tol, (T)null_rel,
      (T)eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slod_jacobi_rows_f32(void* G, void* XT, void* XB, void* ws, int B, int n,
                         int sweeps, double tol, double null_rel, double eps,
                         void* stream) {
  return launch_jacobi<float>(G, XT, XB, ws, B, n, sweeps, tol, null_rel,
                              eps, stream);
}
int slod_jacobi_rows_f64(void* G, void* XT, void* XB, void* ws, int B, int n,
                         int sweeps, double tol, double null_rel, double eps,
                         void* stream) {
  return launch_jacobi<double>(G, XT, XB, ws, B, n, sweeps, tol, null_rel,
                               eps, stream);
}
int slod_weig_f32(void* ZT, void* YT, void* XT, void* XB, void* ws, int B,
                  int k, int nf, int sweeps, double tol, double null_rel,
                  double eps, void* stream) {
  return launch_weig<float>(ZT, YT, XT, XB, ws, B, k, nf, sweeps, tol,
                            null_rel, eps, stream);
}
int slod_weig_f64(void* ZT, void* YT, void* XT, void* XB, void* ws, int B,
                  int k, int nf, int sweeps, double tol, double null_rel,
                  double eps, void* stream) {
  return launch_weig<double>(ZT, YT, XT, XB, ws, B, k, nf, sweeps, tol,
                             null_rel, eps, stream);
}
// workspace elements per matrix of K5 / K8 at row length n (0: the rows
// fit in shared memory; -1: no launch can take n)
long long slod_jacobi_rows_ws_f32(int n) { return rows_ws_elems<float>(n); }
long long slod_jacobi_rows_ws_f64(int n) { return rows_ws_elems<double>(n); }

}  // extern "C"
