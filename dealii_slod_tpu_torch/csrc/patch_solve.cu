// K1: fused block-LDL^T SPD multi-RHS solve with the triple product, and
// K2: Gauss-Jordan sweep inverse of small SPD matrices.
//
// K1 replaces dealii_slod_tpu/ops/patch_solve.py: fused_spd_multirhs
// (algo="ldl": _fused_kernel_ldl_dma2 -> _fused_kernel_ldl).  Per patch p:
//   A = L D L^T (unit block-lower L, nb = 64 diagonal blocks D_j),
//   X = A^-1 B in place of B,  T = sum_j z_j^T D_j^-1 z_j = B^T A^-1 B.
// What bounds it on the card: the trailing Schur updates, ~n^3/3 FMAs per
// patch (n = 768: ~0.3 GFLOP), plus the trailing matrix streaming through
// L2 / HBM once per panel (the 768^2 f32 matrix is 2.25 MiB, far beyond one
// SM's 227 KB of shared memory, and a 128-patch chunk's 288 MiB is beyond
// the 50 MB L2).  The TPU kernel kept 4 whole matrices in VMEM; here one
// CTA per patch (a 128-patch chunk is about one CTA per SM) works in place
// on a global-memory scratch copy of A that the wrapper allocates.  For
// each panel j the CTA inverts D_j by the Gauss-Jordan sweep in shared
// memory (the device function K2 uses), then runs every product as 64x64
// output tiles staged through shared memory (16-deep k-steps, 4x4 outputs
// per thread): w_j = D_j^-1 z_j, T += z_j^T w_j, the panel
// W = A_{>j,j} D_j^-1, the Schur update of the lower block triangle only
// (upper tiles are never read), and the right-hand-side update; then the
// backward pass X_j -= L_{>j,j}^T X_{>j}.  The global workspace per patch
// holds D_j^-1, w_j and W.  Simple and right first: no tensor cores, no
// TMA, no multi-CTA split of a patch (later work).
//
// K2 replaces dealii_slod_tpu/ops/patch_solve.py: gj_inverse_pallas
// (_gj_inverse_kernel -> _gj_invert_spd), the m-step sweep on (B, m, m)
// SPD matrices padded to m = 128 with the identity.  What bounds it: the
// m-step dependency chain (two CTA barriers per step), not bytes or FLOPs.
// One CTA per matrix keeps the whole matrix in dynamic shared memory
// (64 KB f32, 128 KB f64) for all m steps, so global memory is touched
// once on the way in and once on the way out.

#include "common.cuh"

namespace {

constexpr int NB = 64;        // K1 panel width = product tile edge
constexpr int KT = 16;        // k-depth of one staged product step
constexpr int LDS = NB + 1;   // padded shared-tile row (bank spread)
constexpr int K1_THREADS = 256;
constexpr int K2_THREADS = 512;

// C (64x64, ld ldc) = (acc ? C : 0) + sign * op(A) (64xK) @ op(B) (Kx64),
// op(A)[i,k] = TA ? A[k*lda + i] : A[i*lda + k],
// op(B)[k,j] = TB ? B[j*ldb + k] : B[k*ldb + j].  K % KT == 0.
// All K1_THREADS threads of the CTA call it; `sm` holds 2*KT*LDS values.
template <typename T, bool TA, bool TB>
__device__ void tile_gemm(T* C, int ldc, const T* A, int lda, const T* B,
                          int ldb, int K, T sign, bool acc, T* sm) {
  T* As = sm;
  T* Bs = sm + KT * LDS;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  T r[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) r[i][j] = T(0);
  for (int k0 = 0; k0 < K; k0 += KT) {
    for (int e = tid; e < NB * KT; e += K1_THREADS) {
      if (TA) {
        const int i = e % NB, kk = e / NB;
        As[kk * LDS + i] = A[(size_t)(k0 + kk) * lda + i];
      } else {
        const int kk = e % KT, i = e / KT;
        As[kk * LDS + i] = A[(size_t)i * lda + k0 + kk];
      }
      if (TB) {
        const int kk = e % KT, j = e / KT;
        Bs[kk * LDS + j] = B[(size_t)j * ldb + k0 + kk];
      } else {
        const int j = e % NB, kk = e / NB;
        Bs[kk * LDS + j] = B[(size_t)(k0 + kk) * ldb + j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      T a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * LDS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * LDS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) r[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T* c = C + (size_t)(ty + 16 * i) * ldc + tx + 16 * j;
      *c = (acc ? *c : T(0)) + sign * r[i][j];
    }
}

// One CTA per patch.  A (P, n, n) scratch, factored in place (panels end
// as L); X (P, n, k) holds B on entry and X = A^-1 B on exit; Tout
// (P, k, k); work (P, NB*NB + NB*k + n*NB).  n % NB == 0, k % NB == 0.
template <typename T>
__global__ void __launch_bounds__(K1_THREADS)
    fused_ldl_kernel(T* A, T* X, T* Tout, T* work, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const size_t p = blockIdx.x;
  T* Ap = A + p * n * n;
  T* Xp = X + p * n * k;
  T* Tp = Tout + p * k * k;
  T* Dinv = work + p * (size_t)(NB * NB + NB * k + n * NB);  // NB x NB
  T* w = Dinv + NB * NB;                                       // NB x k
  T* W = w + NB * k;                                           // n x NB
  const int nblk = n / NB, ktl = k / NB;

  for (int j = 0; j < nblk; ++j) {
    const int j0 = j * NB, j1 = j0 + NB;
    // D_j^-1 by the sweep in shared memory
    T* D = sm;
    for (int e = tid; e < NB * NB; e += K1_THREADS)
      D[e] = Ap[(size_t)(j0 + e / NB) * n + j0 + e % NB];
    __syncthreads();
    slod::gj_sweep_invert(D, D + NB * NB, D + NB * NB + NB, NB);
    for (int e = tid; e < NB * NB; e += K1_THREADS) Dinv[e] = D[e];
    __syncthreads();
    // w_j = D_j^-1 z_j
    for (int ct = 0; ct < ktl; ++ct)
      tile_gemm<T, false, false>(w + ct * NB, k, Dinv, NB,
                                 Xp + (size_t)j0 * k + ct * NB, k, NB, T(1),
                                 false, sm);
    __syncthreads();
    // T (+)= z_j^T w_j
    for (int rt = 0; rt < ktl; ++rt)
      for (int ct = 0; ct < ktl; ++ct)
        tile_gemm<T, true, false>(Tp + (size_t)rt * NB * k + ct * NB, k,
                                  Xp + (size_t)j0 * k + rt * NB, k,
                                  w + ct * NB, k, NB, T(1), j > 0, sm);
    if (j + 1 < nblk) {
      // W_r = A_{r,j} D_j^-1 for the row tiles below the panel
      for (int r = j + 1; r < nblk; ++r)
        tile_gemm<T, false, false>(W + (size_t)r * NB * NB, NB,
                                   Ap + (size_t)r * NB * n + j0, n, Dinv, NB,
                                   NB, T(1), false, sm);
      __syncthreads();
      // Schur update of the lower block triangle: A_{r,c} -= W_r A_{c,j}^T
      for (int r = j + 1; r < nblk; ++r)
        for (int c = j + 1; c <= r; ++c)
          tile_gemm<T, false, true>(Ap + (size_t)r * NB * n + c * NB, n,
                                    W + (size_t)r * NB * NB, NB,
                                    Ap + (size_t)c * NB * n + j0, n, NB,
                                    T(-1), true, sm);
      // right-hand side: X_r -= W_r z_j
      for (int r = j + 1; r < nblk; ++r)
        for (int ct = 0; ct < ktl; ++ct)
          tile_gemm<T, false, false>(Xp + (size_t)r * NB * k + ct * NB, k,
                                     W + (size_t)r * NB * NB, NB,
                                     Xp + (size_t)j0 * k + ct * NB, k, NB,
                                     T(-1), true, sm);
      __syncthreads();
      // the panel becomes L_{>j,j}
      for (int e = tid; e < (n - j1) * NB; e += K1_THREADS)
        Ap[(size_t)(j1 + e / NB) * n + j0 + e % NB] =
            W[(size_t)j1 * NB + e];
    }
    __syncthreads();
    // z_j -> w_j in place
    for (int e = tid; e < NB * k; e += K1_THREADS)
      Xp[(size_t)j0 * k + e] = w[e];
    __syncthreads();
  }
  // backward: X_j -= L_{>j,j}^T X_{>j}
  for (int j = nblk - 2; j >= 0; --j) {
    const int j0 = j * NB, j1 = j0 + NB;
    for (int ct = 0; ct < ktl; ++ct)
      tile_gemm<T, true, false>(Xp + (size_t)j0 * k + ct * NB, k,
                                Ap + (size_t)j1 * n + j0, n,
                                Xp + (size_t)j1 * k + ct * NB, k, n - j1,
                                T(-1), true, sm);
    __syncthreads();
  }
}

template <typename T>
int launch_fused(void* A, void* X, void* Tm, void* work, int P, int n, int k,
                 void* stream) {
  if (n % NB || k % NB || P <= 0) return (int)cudaErrorInvalidValue;
  const size_t gj = (size_t)NB * NB + 2 * NB, tiles = 2 * KT * LDS;
  const size_t smem = (gj > tiles ? gj : tiles) * sizeof(T);
  fused_ldl_kernel<T><<<P, K1_THREADS, smem, (cudaStream_t)stream>>>(
      (T*)A, (T*)X, (T*)Tm, (T*)work, n, k);
  return (int)cudaGetLastError();
}

// One CTA per matrix: M (B, m, m) is inverted in place.
template <typename T>
__global__ void __launch_bounds__(K2_THREADS) gj_inverse_kernel(T* M, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);
  T* Mp = M + (size_t)blockIdx.x * m * m;
  for (int e = threadIdx.x; e < m * m; e += K2_THREADS) S[e] = Mp[e];
  __syncthreads();
  slod::gj_sweep_invert(S, S + m * m, S + m * m + m, m);
  for (int e = threadIdx.x; e < m * m; e += K2_THREADS) Mp[e] = S[e];
}

template <typename T>
int launch_gj(void* M, int B, int m, void* stream) {
  if (B <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)m * m + 2 * m) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      gj_inverse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gj_inverse_kernel<T><<<B, K2_THREADS, smem, (cudaStream_t)stream>>>(
      (T*)M, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slod_fused_spd_multirhs_f32(void* A, void* X, void* T, void* work, int P,
                                int n, int k, void* stream) {
  return launch_fused<float>(A, X, T, work, P, n, k, stream);
}
int slod_fused_spd_multirhs_f64(void* A, void* X, void* T, void* work, int P,
                                int n, int k, void* stream) {
  return launch_fused<double>(A, X, T, work, P, n, k, stream);
}
int slod_gj_inverse_f32(void* M, int B, int m, void* stream) {
  return launch_gj<float>(M, B, m, stream);
}
int slod_gj_inverse_f64(void* M, int B, int m, void* stream) {
  return launch_gj<double>(M, B, m, stream);
}

}  // extern "C"
