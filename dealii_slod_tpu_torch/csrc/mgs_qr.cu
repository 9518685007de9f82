// K4: two-pass modified Gram-Schmidt thin Q of a batch of (n, k) blocks.
//
// Replaces dealii_slod_tpu/ops/eig.py: mgs_qr_pallas (_mgs_kernel), the
// orthonormalization of each inverse-subspace step of the smallk spectral
// stage: X (B, n, k) -> Q (B, n, k), k <= n.  Each pass takes the columns
// in order; column j, after receiving q_0 .. q_{j-1} (each a dot and a
// subtraction), is scaled by rsqrt(|x_j|^2 + 1e-30), so a null column comes
// out exactly zero (the TPU kernel's guard).  Two passes over all k.
//
// What bounds it on the card, by regime:
// * k <= 32 (every float32 path: (128, 125, 32), (384, 375, 32)): the
//   2k-step dependent chain.  A block is 16-48 KB and ~0.5-2 MFLOP, so
//   what costs is the time between two steps.  One CTA per matrix; a warp
//   holds a block of rows in registers, a lane one column of it (32 rows a
//   warp at n = 125), or at n = 375 in float32 96 rows a warp, a lane 4
//   columns of a quarter of them (four warps, three CTAs an SM, so 384
//   matrices run in one wave).  Step j: the lanes holding column j publish
//   it in the warp's pivot vector (shared memory), each lane forms its
//   columns' parts of the Gram row s_c = x_c . x_j, the warp sums meet
//   behind one CTA barrier in a double-buffered array, and every column
//   c > j loses (s_c rs) rs x_j, rs = rsqrt(s_jj + 1e-30); column j is
//   scaled into q_j when the panel ends.  One barrier a step, no idle
//   warp, and a step loop small enough to stay in the instruction cache
//   (the chain unrolled over its 32 steps, rows a thread and a 31-shuffle
//   transposed butterfly, was 2-3x slower).  What remains: ~0.3 us of
//   dependent latency a step at n = 125 (one CTA has the SM), and at
//   n = 375 the pivot's delivery from shared memory (each lane reads its
//   rows' pivot values twice a step; four columns a lane cut that
//   traffic 4x).  The coefficient is (x_c . x_j) rs rs
//   rather than x_c . q_j: a rounding-level change; a null column still
//   gives s_jj = s_cj = 0 and an exactly zero q.
// * k > 32 (float64, where the smallk stage keeps every direction:
//   (128, 125, 124) in shared memory, (384, 375, 374) in a global
//   workspace): FLOPs (2 n k^2 a pass; 8.06e10 at the elasticity shape,
//   2.4 ms at the 34 TFLOP/s of the f64 CUDA cores, 1.2 ms at the 67 of
//   the f64 tensor cores, which MGS's order cannot use), the reads of q and
//   the traffic of the columns.  Each pass takes the columns in panels of
//   32 (the last one ragged): the panel runs the chain above in registers
//   and writes its q's to shared memory, then every later column is
//   updated once per panel, taking the panel's q's in order, each a dot
//   and a subtraction.  At n <= 128 (one CTA to an SM, latency) the whole
//   CTA updates 2 blocks of 32 later columns at once in the chain's
//   layout, one barrier per q; beyond, each warp updates its own 4 columns
//   (12 values a lane each, so each q read from shared memory serves 4
//   columns) with a shuffle all-reduce per q and no barrier, twelve
//   independent warps.  The columns live column-major, (k, n), in shared
//   memory where they fit and in the caller's global workspace (B, k, n)
//   otherwise, so a column is one contiguous stream, read and written once
//   per panel, not once per step: ~32x less traffic than a step-by-step
//   update (~10 GB a launch at (384, 375, 374) instead of ~320 GB).  The
//   products stay on CUDA cores: MGS's column order has no GEMM in it.
//
// Both regimes keep MGS's per-column order, so float64 results stay within
// summation-order rounding of the plain version; ops/eig.py:
// mgs_qr_panel_plain repeats this order on tensors.  n > 384 (3D l = 3
// elasticity's n = 1029 and beyond, which no measured path runs) takes the
// generic route: 512 threads, warp 0 normalizes column j and a warp per
// later column forms its coefficient x_i . q_j and subtracts, two CTA
// barriers a step, the columns in shared memory or the global workspace
// by the same size rule.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int PASSES = 2;
constexpr int PANEL = 32;          // columns of a panel: one a lane
constexpr int PANEL_MAX_N = 384;   // rows the panel kernel takes
constexpr int GENERIC_THREADS = 512;

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

// Where the panel kernel keeps the columns: k <= 32, one panel in
// registers for both passes; else the (k, n) columns in shared memory, or
// in the caller's global workspace.  A kernel instance per place, so every
// load and store is a shared-memory or a global one, never generic.
enum Mode { ONE_PANEL, SHARED_COLS, GLOBAL_COLS };

// The panel kernel's shape: RW rows a warp, CW panel columns a lane (1,
// or 4: a quarter of the pivot reads, a three-shuffle sum over the four
// row groups); the chain's pivot read into registers once a step (PR = 1)
// or twice from shared memory (PR = 0, fewer registers); the panel update
// either by the whole CTA on NB blocks of 32 later columns at once
// (G = 0), or by each warp on its own G later columns, E values a lane
// each; launch bounds (MAXT threads, MINB CTAs an SM).
template <typename T, int RW_, int CW_, int PR_, int NB_, int G_, int E_,
          int MAXT_, int MINB_>
struct Cfg {
  using type = T;
  static constexpr int RW = RW_, CW = CW_, CG = PANEL / CW_, A = RW_ / CW_,
                       PR = PR_, NB = NB_, G = G_, E = E_, MAXT = MAXT_,
                       MINB = MINB_;
  __host__ __device__ static int threads(int n) {
    return 32 * ((n + RW - 1) / RW);
  }
};

// Dynamic shared memory of the panel kernel, in elements: first, past
// ONE_PANEL, the panel's q's (32, ldq), ldq = rows of the CTA (zero beyond
// n); the double-buffered warp sums (2, nw, NB, 32); the warps' pivot
// columns (nw, RW); then, in SHARED_COLS, the columns (k, n).
template <typename C, int MODE>
struct Smem {
  size_t red, piv, cols, total;
  __host__ __device__ Smem(int n, int k) {
    const size_t nw = C::threads(n) / 32;
    red = MODE == ONE_PANEL ? 0 : (size_t)PANEL * nw * C::RW;
    piv = red + 2 * nw * C::NB * PANEL;
    cols = piv + nw * C::RW;
    total = cols + (MODE == SHARED_COLS ? (size_t)n * k : 0);
  }
};

// The CTA's sums of the NB values v[b] of every lane c of every warp (one
// column each), through the double-buffered shared array: one barrier.  t
// counts the CTA's steps (the parity).
template <int NB, typename T>
__device__ __forceinline__ void cta_sum(T (&v)[NB], T* red, int& t, int lane,
                                        int warp, int nw) {
  T* rb = red + (t++ & 1) * nw * NB * PANEL;
#pragma unroll
  for (int b = 0; b < NB; ++b) rb[(warp * NB + b) * PANEL + lane] = v[b];
  __syncthreads();
#pragma unroll
  for (int b = 0; b < NB; ++b) v[b] = T(0);
  for (int w = 0; w < nw; ++w)
#pragma unroll
    for (int b = 0; b < NB; ++b) v[b] += rb[(w * NB + b) * PANEL + lane];
}

// RW values from a 16-byte aligned shared vector into registers.
template <int RW, typename T>
__device__ __forceinline__ void load_vec(T (&dst)[RW], const T* src) {
  constexpr int V = 16 / sizeof(T);
  const auto* sv = reinterpret_cast<const slod::Vec16<T>*>(src);
#pragma unroll
  for (int g = 0; g < RW / V; ++g) {
    const slod::Vec16<T> v = sv[g];
#pragma unroll
    for (int e = 0; e < V; ++e) dst[g * V + e] = v.v[e];
  }
}

// Transposed butterfly over the row groups (the high lane bits, from 16
// down): p[0..2H) of each lane -> the warp's sum of p[rg] over the CW row
// groups holding the same columns; CW - 1 shuffles.
template <int H, int O, typename T>
__device__ __forceinline__ T rg_sum(T* p, int lane) {
  if constexpr (H >= 1) {
    const bool up = lane & O;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const T send = up ? p[i] : p[i + H];
      const T keep = up ? p[i + H] : p[i];
      p[i] = keep + __shfl_xor_sync(FULL, send, O);
    }
    return rg_sum<H / 2, O / 2>(p, lane);
  } else {
    return p[0];
  }
}

// Step j = jg CW + CC of the chain (CC static, so every index into the
// tile is).  The lanes holding column j publish it in the warp's pivot
// vector (shared memory), every lane reads its row group's part (16-byte
// broadcasts) and forms its columns' parts of the Gram row s_c =
// x_c . x_j, the row groups' parts meet by a transposed butterfly (none
// for CW = 1), the warp sums behind one barrier, and each column c > j
// loses (s_c rs) rs x_j, rs = rsqrt(s_jj + 1e-30).  Column j keeps x_j;
// its rs is kept for the panel's end.
template <int CC, typename C, typename T = typename C::type>
__device__ __forceinline__ void chain_step(T (&x)[C::A][C::CW],
                                           T (&rs_own)[C::CW], int jg,
                                           T* red, T* piv, int& t, int lane,
                                           int warp, int nw) {
  constexpr int A = C::A, CW = C::CW, CG = C::CG, V = 16 / sizeof(T);
  using Vec = slod::Vec16<T>;
  const int j = jg * CW + CC, cg = lane % CG, rg = lane / CG;
  Vec* pv = reinterpret_cast<Vec*>(piv + rg * A);
  if (cg == jg) {
#pragma unroll
    for (int g = 0; g < A / V; ++g) {
      Vec v;
#pragma unroll
      for (int e = 0; e < V; ++e) v.v[e] = x[g * V + e][CC];
      pv[g] = v;
    }
  }
  __syncwarp();
  T xj[C::PR ? A : 1];
  if constexpr (C::PR) {
    load_vec(xj, piv + rg * A);
    __syncwarp();                   // read before the next step rewrites it
  }
  T p[CW];
#pragma unroll
  for (int cc = 0; cc < CW; ++cc) {
    T a4[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int g = 0; g < A / V; ++g) {
      Vec v;
      if constexpr (C::PR) {
#pragma unroll
        for (int e = 0; e < V; ++e) v.v[e] = xj[g * V + e];
      } else {
        v = pv[g];
      }
#pragma unroll
      for (int e = 0; e < V; ++e)
        a4[(g * V + e) & 3] += x[g * V + e][cc] * v.v[e];
    }
    p[cc] = (a4[0] + a4[1]) + (a4[2] + a4[3]);
  }
  T s[1] = {rg_sum<CW / 2, 16>(p, lane)};   // column cg CW + rg: warp sum,
  cta_sum<1>(s, red, t, lane, warp, nw);    // then CTA sum
  const T rs = rsqrt_<T>(__shfl_sync(FULL, s[0], CC * CG + jg) + T(1e-30));
#pragma unroll
  for (int cc = 0; cc < CW; ++cc) {
    const T g = CW == 1 ? s[0] : __shfl_sync(FULL, s[0], cc * CG + cg);
    const T c = cg * CW + cc > j ? (g * rs) * rs : T(0);
#pragma unroll
    for (int gg = 0; gg < A / V; ++gg) {
      Vec v;
      if constexpr (C::PR) {
#pragma unroll
        for (int e = 0; e < V; ++e) v.v[e] = xj[gg * V + e];
      } else {
        v = pv[gg];
      }
#pragma unroll
      for (int e = 0; e < V; ++e) x[gg * V + e][cc] -= c * v.v[e];
    }
  }
  if (cg == jg) rs_own[CC] = rs;
  if constexpr (!C::PR) __syncwarp();   // read before the next step writes
}

template <int CC, typename C, typename T = typename C::type>
__device__ __forceinline__ void chain_group(T (&x)[C::A][C::CW],
                                            T (&rs_own)[C::CW], int jg,
                                            int kp, T* red, T* piv, int& t,
                                            int lane, int warp, int nw) {
  if constexpr (CC < C::CW) {
    if (jg * C::CW + CC >= kp) return;
    chain_step<CC, C>(x, rs_own, jg, red, piv, t, lane, warp, nw);
    chain_group<CC + 1, C>(x, rs_own, jg, kp, red, piv, t, lane, warp, nw);
  }
}

// MGS over one panel of kp <= 32 columns in registers, one CTA barrier a
// step.  Lane (rg, cg) = rg CG + cg of warp w holds x[a][cc]: row
// w RW + a CW + rg, panel column cg CW + cc (CW = 1: lane c, column c).
// The columns become q = x rs at the end.
template <typename C, typename T = typename C::type>
__device__ __forceinline__ void chain(T (&x)[C::A][C::CW], int kp, T* red,
                                      T* piv, int& t, int lane, int warp,
                                      int nw) {
  T rs_own[C::CW];
#pragma unroll
  for (int cc = 0; cc < C::CW; ++cc) rs_own[cc] = T(1);
  for (int jg = 0; jg * C::CW < kp; ++jg)
    chain_group<0, C>(x, rs_own, jg, kp, red, piv, t, lane, warp, nw);
#pragma unroll
  for (int a = 0; a < C::A; ++a)
#pragma unroll
    for (int cc = 0; cc < C::CW; ++cc) x[a][cc] *= rs_own[cc];
}

// The panel update by the whole CTA: NB blocks of 32 later columns in
// registers, y[b][r] (lane c: column 32 b + c of the blocks, rows as in
// chain), minus their components along the kp q's of qs ((kp, ldq), rows
// beyond n zero), in order: per q a dot of every column, one CTA sum (one
// barrier), a subtraction.  For small n, where one CTA has the SM and
// latency rules.
template <typename C, typename T = typename C::type>
__device__ __forceinline__ void apply_cta(T (&y)[C::NB][C::RW], const T* qs,
                                          int ldq, int kp, int r0, T* red,
                                          int& t, int lane, int warp,
                                          int nw) {
  constexpr int RW = C::RW, NB = C::NB;
  for (int j = 0; j < kp; ++j) {
    const T* qj = qs + (size_t)j * ldq + r0;
    T q[RW];
    load_vec(q, qj);
    T v[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      T a0 = T(0), a1 = T(0);
#pragma unroll
      for (int r = 0; r < RW; r += 2) {
        a0 += y[b][r] * q[r];
        a1 += y[b][r + 1] * q[r + 1];
      }
      v[b] = a0 + a1;
    }
    cta_sum<NB>(v, red, t, lane, warp, nw);
    load_vec(q, qj);
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int r = 0; r < RW; ++r) y[b][r] -= v[b] * q[r];
  }
}

// The panel update by each warp on its own: columns c_lo .. k-1 of cols
// ((k, n), column-major) minus their components along the kp q's of qs,
// in order; a warp takes G columns at a time, lane l holding rows
// l + 32 m (m < E) of each; per q a dot, a shuffle all-reduce and a
// subtraction, no barrier.  For the larger n, where several CTAs' worth of
// independent warps fill the SM.
template <typename C, typename T = typename C::type>
__device__ __forceinline__ void apply_warps(T* cols, const T* qs, int ldq,
                                            int n, int k, int kp, int c_lo,
                                            int lane, int warp, int nw) {
  constexpr int G = C::G, E = C::E;
  for (int c0 = c_lo + warp * G; c0 < k; c0 += nw * G) {
    T y[G][E];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int m = 0; m < E; ++m) {
        const int r = lane + 32 * m;
        y[g][m] = (c0 + g < k && r < n) ? cols[(size_t)(c0 + g) * n + r]
                                        : T(0);
      }
    for (int j = 0; j < kp; ++j) {
      T q[E];
#pragma unroll
      for (int m = 0; m < E; ++m) q[m] = qs[(size_t)j * ldq + lane + 32 * m];
      T d[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        T a = T(0);
#pragma unroll
        for (int m = 0; m < E; ++m) a += y[g][m] * q[m];
        d[g] = a;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g) d[g] += __shfl_xor_sync(FULL, d[g], o);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int m = 0; m < E; ++m) y[g][m] -= d[g] * q[m];
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int m = 0; m < E; ++m) {
        const int r = lane + 32 * m;
        if (c0 + g < k && r < n) cols[(size_t)(c0 + g) * n + r] = y[g][m];
      }
  }
}

// n <= 384.  gcols: the global workspace (B, k, n) of which this CTA uses
// its own slice (GLOBAL_COLS only).  The columns are column-major (k, n)
// in either place: one column is one contiguous stream.
template <typename C, int MODE, typename T = typename C::type>
__global__ void __launch_bounds__(C::MAXT, C::MINB)
    mgs_panel_kernel(const T* __restrict__ X, T* __restrict__ Q,
                     T* __restrict__ gcols, int n, int k) {
  constexpr int RW = C::RW, NB = C::NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5, r0 = warp * RW, ldq = nw * RW;
  const size_t base = (size_t)blockIdx.x * n * k;
  const Smem<C, MODE> L(n, k);
  T* red = sm + L.red;
  T* piv = sm + L.piv + warp * RW;
  int t = 0;                        // the CTA's steps so far
  T x[C::A][C::CW];

  if constexpr (MODE == ONE_PANEL) {   // registers for both passes
    constexpr int CW = C::CW;
    const int rg = lane / C::CG, c0 = (lane % C::CG) * CW;
#pragma unroll
    for (int a = 0; a < C::A; ++a) {
      const int row = r0 + a * CW + rg;
#pragma unroll
      for (int cc = 0; cc < CW; ++cc)
        x[a][cc] = (row < n && c0 + cc < k)
                       ? X[base + (size_t)row * k + c0 + cc]
                       : T(0);
    }
    for (int p = 0; p < PASSES; ++p)
      chain<C>(x, k, red, piv, t, lane, warp, nw);
#pragma unroll
    for (int a = 0; a < C::A; ++a) {
      const int row = r0 + a * CW + rg;
#pragma unroll
      for (int cc = 0; cc < CW; ++cc)
        if (row < n && c0 + cc < k)
          Q[base + (size_t)row * k + c0 + cc] = x[a][cc];
    }
  } else {
    static_assert(C::CW == 1, "the panels run one column a lane");
    T* qs = sm;                     // (32, ldq)
    T* cols;                        // (k, n)
    if constexpr (MODE == GLOBAL_COLS)
      cols = gcols + base;
    else
      cols = sm + L.cols;
    for (int c = 0; c < k; ++c)
      for (int r = tid; r < n; r += blockDim.x)
        cols[(size_t)c * n + r] = X[base + (size_t)r * k + c];
    __syncthreads();
    for (int p = 0; p < PASSES; ++p) {
      const bool last = p == PASSES - 1;
      for (int p0 = 0; p0 < k; p0 += PANEL) {
        const int kp = min(PANEL, k - p0);
        const bool live = lane < kp;
#pragma unroll
        for (int r = 0; r < RW; ++r)
          x[r][0] = (live && r0 + r < n)
                        ? cols[(size_t)(p0 + lane) * n + r0 + r]
                        : T(0);
        chain<C>(x, kp, red, piv, t, lane, warp, nw);
        if (live) {
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            qs[(size_t)lane * ldq + r0 + r] = x[r][0];   // zero beyond n
            if (r0 + r >= n) continue;
            if (last)
              Q[base + (size_t)(r0 + r) * k + p0 + lane] = x[r][0];
            else
              cols[(size_t)(p0 + lane) * n + r0 + r] = x[r][0];
          }
        }
        __syncthreads();            // the q's are written
        if constexpr (C::G > 0) {
          apply_warps<C>(cols, qs, ldq, n, k, kp, p0 + kp, lane, warp, nw);
        } else {
          for (int b0 = p0 + kp; b0 < k; b0 += NB * PANEL) {
            T y[NB][RW];
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              const int c = b0 + b * PANEL + lane;
#pragma unroll
              for (int r = 0; r < RW; ++r)
                y[b][r] = (c < k && r0 + r < n) ? cols[(size_t)c * n + r0 + r]
                                                : T(0);
            }
            apply_cta<C>(y, qs, ldq, kp, r0, red, t, lane, warp, nw);
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              const int c = b0 + b * PANEL + lane;
#pragma unroll
              for (int r = 0; r < RW; ++r)
                if (c < k && r0 + r < n) cols[(size_t)c * n + r0 + r] = y[b][r];
            }
          }
        }
        __syncthreads();            // the updated columns are written
      }
    }
  }
}

// n > 384: the columns of R (k rows of n) in shared memory, or in a slice
// of the global workspace (B, k, n) where they do not fit.
template <typename T>
__global__ void __launch_bounds__(GENERIC_THREADS)
    mgs_generic_kernel(const T* __restrict__ X, T* __restrict__ Q, T* gbuf,
                       int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* R = gbuf ? gbuf + (size_t)blockIdx.x * n * k
              : reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = GENERIC_THREADS / 32;
  const size_t base = (size_t)blockIdx.x * n * k;

  for (int e = tid; e < n * k; e += GENERIC_THREADS) {
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

  for (int e = tid; e < n * k; e += GENERIC_THREADS) {
    const int l = e / k, j = e - l * k;
    Q[base + e] = R[j * n + l];
  }
}

// The panel kernel's shapes (each chosen by timing on the card at the
// paths' shapes).  n <= 128: 32 rows a warp, one column a lane, up to four
// warps (one CTA has the SM); the panel update by the CTA, 2 blocks of
// later columns at once (timed on the float64 k = 124 main path; the
// float32 k > 32 instances, which no path runs, are kept for generality
// only).
// 128 < n <= 384: for k <= 32, float32 96 rows a warp and 4 columns a
// lane (four warps at n = 375, 164 registers, three CTAs an SM, so 384
// matrices run in one wave), float64 32 rows a warp (twelve warps);
// beyond, 32 rows a warp and the panel update by the warps, 4 columns a
// warp at once.
template <typename T, int MODE>
using CfgSmall =
    Cfg<T, 32, 1, 1, MODE == ONE_PANEL ? 1 : 2, 0, 0, 128, 1>;
template <typename T, int MODE>
using CfgWide = std::conditional_t<
    MODE == ONE_PANEL,
    std::conditional_t<sizeof(T) == 4, Cfg<T, 96, 4, 0, 1, 0, 0, 128, 3>,
                       Cfg<T, 32, 1, 1, 1, 0, 0, 384, 1>>,
    Cfg<T, 32, 1, 0, 1, 4, 12, 384, 1>>;

template <typename T, int MODE>
size_t panel_smem_bytes(int n, int k) {
  return (n <= 128 ? Smem<CfgSmall<T, MODE>, MODE>(n, k).total
                   : Smem<CfgWide<T, MODE>, MODE>(n, k).total) *
         sizeof(T);
}

// Elements of global workspace per matrix: 0 where the working set fits
// in registers and shared memory, n*k otherwise; -1 if the device cannot
// be queried.
template <typename T>
long long mgs_ws_elems(int n, int k) {
  const size_t lim = slod::max_smem_optin();
  if (lim == 0) return -1;
  if (n > PANEL_MAX_N)
    return (size_t)n * k * sizeof(T) <= lim ? 0 : (long long)n * k;
  if (k <= PANEL) return 0;
  return panel_smem_bytes<T, SHARED_COLS>(n, k) <= lim ? 0 : (long long)n * k;
}

template <typename C, int MODE, typename T = typename C::type>
int launch_panel(const T* X, T* Q, T* ws, int B, int n, int k,
                 cudaStream_t stream) {
  const auto kern = mgs_panel_kernel<C, MODE>;
  const size_t smem = Smem<C, MODE>(n, k).total * sizeof(T);
  const cudaError_t err =
      slod::opt_in_smem(reinterpret_cast<const void*>(kern), smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B, C::threads(n), smem, stream>>>(X, Q, ws, n, k);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int launch_mode(const T* X, T* Q, T* ws, int B, int n, int k,
                cudaStream_t st) {
  if (n <= 128)
    return launch_panel<CfgSmall<T, MODE>, MODE>(X, Q, ws, B, n, k, st);
  return launch_panel<CfgWide<T, MODE>, MODE>(X, Q, ws, B, n, k, st);
}

template <typename T>
int launch_mgs(void* X, void* Q, void* ws, int B, int n, int k,
               void* stream) {
  if (B <= 0 || n <= 0 || k <= 0 || k > n) return (int)cudaErrorInvalidValue;
  const long long ge = mgs_ws_elems<T>(n, k);
  if (ge < 0 || (ge > 0 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  T* g = ge > 0 ? (T*)ws : nullptr;
  const cudaStream_t st = (cudaStream_t)stream;
  if (n <= PANEL_MAX_N) {
    if (k <= PANEL)
      return launch_mode<T, ONE_PANEL>((const T*)X, (T*)Q, g, B, n, k, st);
    if (g == nullptr)
      return launch_mode<T, SHARED_COLS>((const T*)X, (T*)Q, g, B, n, k, st);
    return launch_mode<T, GLOBAL_COLS>((const T*)X, (T*)Q, g, B, n, k, st);
  }
  const size_t smem = g ? 0 : (size_t)n * k * sizeof(T);
  const cudaError_t err = slod::opt_in_smem(
      reinterpret_cast<const void*>(mgs_generic_kernel<T>), smem);
  if (err != cudaSuccess) return (int)err;
  mgs_generic_kernel<T><<<B, GENERIC_THREADS, smem, st>>>(
      (const T*)X, (T*)Q, g, n, k);
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
