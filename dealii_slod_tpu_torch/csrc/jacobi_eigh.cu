// K5: one-sided (Hestenes) Jacobi on PSD rows in caterpillar order, no
// rotation accumulator: for PSD input the converged rows are lambda_i v_i^T.
// K8: the same sweeps on W = Z^T Y, which the kernel builds itself.
//
// K5 replaces dealii_slod_tpu/ops/eig.py: jacobi_eigh_pallas (the kernel
// closure over _caterpillar_round_nj).  Given `lam` and `V`, a launch also
// does what the plain version's _finalize_rows does in torch (eigenvalues =
// row norms, eigenvectors = rows over their norms, sorted descending with
// ties in row order, the rows beyond n0 dropped) and writes those instead
// of the rows: on the card that glue is about ten small launches, whose
// host time outweighs the kernel's at n = 32.
// What bounds it on the card: latency.  A sweep is n - 1 dependent rounds,
// each one pair dot per row pair, the rotation's few divisions and square
// roots, and a rotation of 2 n values -- little arithmetic per step (a
// 32 x 32 W: ~2 sweeps of 31 rounds; the 126 x 126 factor rows: up to 11
// sweeps of 125).  So the design removes what stands between two rounds.
// Two routines, chosen by n in launch_jacobi:
//
// * n = 32 (the smallk stage's W): one warp per matrix, no shared rows and
//   no CTA barrier.  Lane l holds element l of every row (column l of the
//   32 rows) in registers, kept in caterpillar slot order: slot 2q / 2q + 1
//   is pair q's top / bottom row, and the tournament advance is a fixed
//   permutation of the registers, so every row index is static.  A round
//   forms its 16 pair dots with one transposed butterfly across the warp
//   (16 shuffles; lane l ends with the dot of pair l / 2), lanes 2q and
//   2q + 1 compute pair q's cosine and sine, publish them in a per-warp
//   shared vector, and every lane rotates its 32 elements.  The carried
//   row norms travel with their slots (lane l holds slot l's, one shuffle
//   per round), refreshed exactly at every sweep boundary by a 32-value
//   butterfly.  Four matrices per CTA, so 384 matrices fill the card in
//   one wave.
// * other n (the Jacobi route's 126 x 126 factor rows; K8): one CTA per
//   matrix, the rows in shared memory for the whole run, so global memory
//   is touched once each way.  The rows never move: the row a slot holds
//   at round r is computed in closed form (slot_top / slot_bot: the
//   caterpillar with slot t0 fixed rotates the other 2m - 1 slots by one
//   each round), so a round ends in one CTA barrier and nothing else; the
//   sweep's `off` max and the first sweep's amax2 are warp-shuffle maxima.
//   At n <= 128 (RegRows) the rows are padded with zero columns to 128
//   (64 KB f32, 128 KB f64) and a group of lanes takes each pair (8 lanes
//   in f32: all 63 pairs of n = 126 at once, 504 threads; 16 in f64):
//   each lane loads its four 16-byte chunks of both rows into registers
//   once per round, forms its part of the dot, and after the group's
//   shuffle sum writes the rotated chunks back.  A round moves all n^2
//   values through shared memory and back; that traffic and the per-pair
//   rotation arithmetic are what it costs.  Beyond 128 (LoopRows) a warp
//   per pair walks the rows at stride n with a runtime loop, in shared
//   memory where they fit, else in a per-CTA slice of a global workspace
//   the caller allocates (float64 elasticity at n = 374: 1.1 MB per
//   matrix, beyond the 227 KB a CTA can have; rows_ws_elems decides).
//   The global rows serve float64 correctness runs; their speed is not a
//   goal.
//
// Both routines run the plain version's rounds in its order (the same
// pairs, the same formulas for the cosine and sine: eps = finfo.tiny * 1e3,
// the `big` guard, the zeta sign rule), carry the row norms analytically
// within a sweep and refresh them exactly at every sweep boundary, and
// keep the TPU kernel's null_rel gate of the convergence monitor.
// Stopping rule: the TPU kernel shares `off` over a block of 16 matrices;
// here each matrix stops on its own (sweeps stop once every significant
// pair's squared row-cosine in the previous sweep was below tol), i.e.
// the plain version's block=1 semantics.  `counts`, where given, receives
// the sweeps each matrix ran.
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
// row buffer that the CTA routine above then sweeps, with a warp per pair
// walking the rows (LoopRows) at every k: in RegRows' float32 order of
// summation some of the main path's W (not symmetric) stop a sweep apart
// from the plain version and miss the float32 gate.  The TPU kernel shared
// its stop over the whole batch (grid = ()); here each matrix stops on its
// own.  K8 always writes the sorted eigenpairs.

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_MATS = 4;      // n = 32: matrices (warps) per CTA
constexpr double F32_MAX = 3.4028234663852886e38;  // the TPU kernel's start

template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T x, y;
};

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T w = __shfl_xor_sync(FULL, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// Sum over the G lanes of an aligned lane group (G a power of two <= 32).
template <int G, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Transposed butterfly: v[0..K) on every lane of the warp (K = 32 or 16)
// -> the sum over the warp of v[lane * K / 32] (K = 32: of v[lane];
// K = 16: of v[lane / 2], on both lanes of the pair).  Level O keeps the
// half of the remaining H + H values that lane bit O selects and adds the
// partner's other half: K - 1 shuffles, plus one for K = 16.  Written as
// compile-time recursion so that every index into v is static and v
// stays in registers.
template <int H, int O, typename T>
__device__ __forceinline__ T reduce_scatter_level(T* v, int lane) {
  if constexpr (H >= 1) {
    const bool up = lane & O;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const T send = up ? v[j] : v[j + H];
      const T keep = up ? v[j + H] : v[j];
      v[j] = keep + __shfl_xor_sync(FULL, send, O);
    }
    return reduce_scatter_level<H / 2, O / 2>(v, lane);
  } else if constexpr (O >= 1) {
    v[0] += __shfl_xor_sync(FULL, v[0], O);
    return reduce_scatter_level<0, O / 2>(v, lane);
  } else {
    return v[0];
  }
}

template <int K, typename T>
__device__ __forceinline__ T reduce_scatter(T* v, int lane) {
  static_assert(K == 32 || K == 16, "one value per lane or per lane pair");
  return reduce_scatter_level<K / 2, 16>(v, lane);
}

// Lane l: the exact norm^2 of the row in slot l of x (x[s]: this lane's
// element of the row in slot s).
template <int N, typename T>
__device__ __forceinline__ T slot_norm(const T* x, int lane) {
  T v[N];
#pragma unroll
  for (int s = 0; s < N; ++s) v[s] = x[s] * x[s];
  return reduce_scatter<N>(v, lane);
}

// One pair's rotation from its dot c and carried norms a (top), b (bottom):
// the formulas of the plain version; folds the squared row-cosine of a
// significant pair into off.
template <typename T>
struct Rot {
  T cs, sn, csnc;
};

template <typename T>
__device__ __forceinline__ Rot<T> rotation(T c, T a, T b, T gate, T eps,
                                           T& off) {
  if (a * b > gate) {
    const T cos2 = (c * c) / (a * b + eps);
    off = cos2 > off ? cos2 : off;
  }
  const bool big = fabs(c) > eps;
  const T zeta = (b - a) / (T(2) * (big ? c : T(1)));
  const T sgn = zeta >= T(0) ? T(1) : T(-1);
  const T t = big ? sgn / (fabs(zeta) + sqrt(T(1) + zeta * zeta)) : T(0);
  Rot<T> r;
  r.cs = T(1) / sqrt(T(1) + t * t);
  r.sn = r.cs * t;
  r.csnc = r.cs * r.sn * c;
  return r;
}

// The place of the row in caterpillar slot s (top slot q / bottom slot q,
// m pairs) in the plain version's cat([XT, XB]): what breaks ties of the
// sort.
__device__ __forceinline__ int cat_index(int s, int m) {
  return (s & 1) ? m + (s >> 1) : (s >> 1);
}

// ---------------------------------------------------------------------------
// n = 32: one warp per matrix, the rows in registers
// ---------------------------------------------------------------------------

// The eigenpairs of matrix b from its final rows x (as in the kernel
// below): lane l takes slot l's exact norm and its rank in the descending
// order, then writes element l of every row over its norm into column
// `rank` of V (row l); ranks >= n0 and lanes >= n0 are dropped.
template <int N, typename T>
__device__ __forceinline__ void finalize_warp(const T* x, int lane, int b,
                                              int n0, T* __restrict__ lam,
                                              T* __restrict__ V) {
  const T lv = sqrt(slot_norm<N>(x, lane));
  const int me = cat_index(lane, N / 2);
  int rank = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T lj = __shfl_sync(FULL, lv, j);
    rank += (lj > lv || (lj == lv && cat_index(j, N / 2) < me)) ? 1 : 0;
  }
  if (rank < n0) lam[(size_t)b * n0 + rank] = lv;
  const T den = lv > T(1e-30) ? lv : T(1e-30);
  T* vrow = V + ((size_t)b * n0 + lane) * n0;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const int rs = __shfl_sync(FULL, rank, s);
    const T ds = __shfl_sync(FULL, den, s);
    if (lane < n0 && rs < n0) vrow[rs] = x[s] / ds;
  }
}

template <typename T>
__global__ void __launch_bounds__(WARP_MATS * 32)
    jacobi_rows_warp32(const T* __restrict__ G, T* __restrict__ XTo,
                       T* __restrict__ XBo, int* __restrict__ counts,
                       T* __restrict__ lam, T* __restrict__ V, int B, int n0,
                       int sweeps, T tol, T null_rel, T eps) {
  constexpr int N = 32, M = N / 2;
  __shared__ __align__(16) T bc[WARP_MATS][N];   // (cs, sn) of each pair
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.x * WARP_MATS + w;
  if (b >= B) return;
  T* bcw = bc[w];
  T x[N];                     // x[s]: element `lane` of the row in slot s
  const T* g = G + (size_t)b * N * N;
#pragma unroll
  for (int s = 0; s < N; ++s) x[s] = g[s * N + lane];

  T nrm = slot_norm<N>(x, lane);
  const T amax2 = warp_max(nrm);
  const T gate = (null_rel * amax2) * (null_rel * amax2);
  const bool top = (lane & 1) == 0;
  // the caterpillar advance: slot `lane` takes slot src's contents
  //   t' = [t0, b0, t1..t_{m-2}],  b' = [b1..b_{m-1}, t_{m-1}]
  const int src = top ? (lane == 0 ? 0 : (lane == 2 ? 1 : lane - 2))
                      : (lane == N - 1 ? N - 2 : lane + 2);

  T off = T(F32_MAX);
  int it = 0;
  for (; tol > T(0) ? (it < sweeps && off > tol) : it < sweeps; ++it) {
    if (it > 0) nrm = slot_norm<N>(x, lane);
    T off_w = T(0);
    for (int rnd = 0; rnd < N - 1; ++rnd) {
      T v[M];
#pragma unroll
      for (int q = 0; q < M; ++q) v[q] = x[2 * q] * x[2 * q + 1];
      const T c = reduce_scatter<M>(v, lane);      // pair lane / 2
      const T other = __shfl_xor_sync(FULL, nrm, 1);
      const T a = top ? nrm : other, bn = top ? other : nrm;
      const Rot<T> r = rotation(c, a, bn, gate, eps, off_w);
      const T nn = top ? r.cs * r.cs * a - T(2) * r.csnc + r.sn * r.sn * bn
                       : r.sn * r.sn * a + T(2) * r.csnc + r.cs * r.cs * bn;
      __syncwarp();           // the previous round's reads of bcw are done
      if (top) {
        Pair<T> p;
        p.x = r.cs;
        p.y = r.sn;
        *reinterpret_cast<Pair<T>*>(bcw + lane) = p;
      }
      __syncwarp();
      nrm = __shfl_sync(FULL, nn, src);
      T y[N];
#pragma unroll
      for (int q = 0; q < M; ++q) {
        const Pair<T> p = *reinterpret_cast<const Pair<T>*>(bcw + 2 * q);
        const T u = x[2 * q], vb = x[2 * q + 1];
        y[2 * q] = p.x * u - p.y * vb;
        y[2 * q + 1] = p.y * u + p.x * vb;
      }
      x[0] = y[0];
      x[2] = y[1];
#pragma unroll
      for (int i = 2; i < M; ++i) x[2 * i] = y[2 * i - 2];
#pragma unroll
      for (int i = 0; i < M - 1; ++i) x[2 * i + 1] = y[2 * i + 3];
      x[N - 1] = y[N - 2];
    }
    off = warp_max(off_w);
  }

  if (counts != nullptr && lane == 0) counts[b] = it;
  if (lam != nullptr) {
    finalize_warp<N>(x, lane, b, n0, lam, V);
    return;
  }
  const size_t obase = (size_t)b * M * N;
#pragma unroll
  for (int q = 0; q < M; ++q) {
    XTo[obase + q * N + lane] = x[2 * q];
    XBo[obase + q * N + lane] = x[2 * q + 1];
  }
}

// ---------------------------------------------------------------------------
// Other n: one CTA per matrix, a lane group per pair, rows that never move
// ---------------------------------------------------------------------------

// The caterpillar in closed form (m = n / 2 pairs, round r in [0, 2m - 1)):
// slot t0 always holds row 0; the other 2m - 1 slots, taken in the ring
// order t1 .. t_{m-1}, b_{m-1} .. b0, each pass their row one place along
// the ring per round.  ring_row(p) is the row at ring place p at round 0
// (t_j = 2j, b_j = 2j + 1).  The Python twin is ops/eig.py:
// caterpillar_slots.
__device__ __forceinline__ int ring_row(int p, int m) {
  return p < m - 1 ? 2 * (p + 1) : 2 * (2 * m - 2 - p) + 1;
}
__device__ __forceinline__ int slot_top(int q, int r, int m) {
  if (q == 0) return 0;
  int p = q - 1 - r;
  if (p < 0) p += 2 * m - 1;
  return ring_row(p, m);
}
__device__ __forceinline__ int slot_bot(int q, int r, int m) {
  int p = 2 * m - 2 - q - r;
  if (p < 0) p += 2 * m - 1;
  return ring_row(p, m);
}

// How a lane group of LANES threads holds the two rows of a pair during a
// round: load, dot, norms, rotate-and-store.
//
// RegRows: rows of n <= 128 in shared memory at stride LD = 128 (columns
// n .. 127 zero, which every rotation keeps zero); lane gl of a group of
// LANES = 8 (f32) or 16 (f64) loads 16-byte chunks gl, gl + LANES,
// gl + 2 LANES, gl + 3 LANES of both rows into registers once per round
// (E = 16 or 8 elements a row), forms its part of the dot from them and
// writes the rotated chunks back: two vector loads and two vector stores
// per chunk and round.
template <typename T>
struct RegRows {
  static constexpr int W = 16 / sizeof(T), CH = 4, LANES = 32 / W;
  static constexpr int E = W * CH, LD = LANES * E;
  // 2 E values a thread want more than the 64 registers of a 1024-thread
  // CTA: cap the CTA at 512 threads (groups then take several pairs)
  static constexpr int MAX_THREADS = 512;
  __host__ __device__ static constexpr int ld(int) { return LD; }
  T t[E], b[E];
  slod::Vec16<T>* pt;
  slod::Vec16<T>* pb;
  __device__ __forceinline__ void load(T* X, int, int rt, int rb, int gl) {
    pt = reinterpret_cast<slod::Vec16<T>*>(X + (size_t)rt * LD) + gl;
    pb = reinterpret_cast<slod::Vec16<T>*>(X + (size_t)rb * LD) + gl;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const slod::Vec16<T> u = pt[c * LANES], v = pb[c * LANES];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        t[c * W + e] = u.v[e];
        b[c * W + e] = v.v[e];
      }
    }
  }
  __device__ __forceinline__ T dot() const {
    T s = T(0);
#pragma unroll
    for (int i = 0; i < E; ++i) s += t[i] * b[i];
    return s;
  }
  __device__ __forceinline__ void norms(T& st, T& sb) const {
    st = sb = T(0);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      st += t[i] * t[i];
      sb += b[i] * b[i];
    }
  }
  __device__ __forceinline__ void rotate(T cs, T sn) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      slod::Vec16<T> u, v;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const T x = t[c * W + e], y = b[c * W + e];
        u.v[e] = cs * x - sn * y;
        v.v[e] = sn * x + cs * y;
      }
      pt[c * LANES] = u;
      pb[c * LANES] = v;
    }
  }
};

// LoopRows: rows of length n at stride n, walked by a warp per pair with a
// runtime loop: K5 at n > 128 (in the global workspace where the rows of a
// CTA outgrow shared memory: float64 at n = 374), and K8 at every k.
template <typename T>
struct LoopRows {
  static constexpr int LANES = 32, MAX_THREADS = 1024;
  __host__ __device__ static constexpr int ld(int n) { return n; }
  T* pt;
  T* pb;
  int n, gl;
  __device__ __forceinline__ void load(T* X, int n_, int rt, int rb,
                                       int gl_) {
    n = n_;
    gl = gl_;
    pt = X + (size_t)rt * n;
    pb = X + (size_t)rb * n;
  }
  __device__ __forceinline__ T dot() const {
    T s = T(0);
    for (int l = gl; l < n; l += LANES) s += pt[l] * pb[l];
    return s;
  }
  __device__ __forceinline__ void norms(T& st, T& sb) const {
    st = sb = T(0);
    for (int l = gl; l < n; l += LANES) {
      st += pt[l] * pt[l];
      sb += pb[l] * pb[l];
    }
  }
  __device__ __forceinline__ void rotate(T cs, T sn) {
    for (int l = gl; l < n; l += LANES) {
      const T x = pt[l], y = pb[l];
      pt[l] = cs * x - sn * y;
      pb[l] = sn * x + cs * y;
    }
  }
};

// K5's row stride: RegRows' 128 up to n = 128 (every diffusion shape),
// LoopRows' n beyond.
template <typename T>
int k5_ld(int n) {
  return n <= RegRows<T>::LD ? RegRows<T>::LD : n;
}

// Shared memory of the CTA routine with rows of stride ld: the rows (unless
// they are in the global workspace), the norms and the sort order.
template <typename T>
size_t rows_smem(int n, int ld, bool global_rows) {
  return ((global_rows ? 0 : (size_t)n * ld) + n) * sizeof(T) +
         (size_t)n * sizeof(int);
}

// Elements of global workspace per matrix: 0 when the rows (stride ld)
// fit in shared memory, n*n (the rows at stride n) otherwise; -1 if the
// device cannot be queried or even the norms do not fit.
template <typename T>
long long rows_ws_elems(int n, int ld) {
  const size_t lim = slod::max_smem_optin();
  if (lim <= slod::STATIC_SMEM_MARGIN) return -1;
  if (rows_smem<T>(n, ld, false) <= lim - slod::STATIC_SMEM_MARGIN) return 0;
  if (rows_smem<T>(n, n, true) > lim - slod::STATIC_SMEM_MARGIN) return -1;
  return (long long)n * n;
}

inline int cta_threads(int m, int lanes, int max_threads) {
  const int t = (m * lanes + 31) / 32 * 32;
  return t < max_threads ? t : max_threads;
}

// The sweeps on the n x n rows X (stride R::ld(n); shared memory, or this
// CTA's slice of the global workspace; filled by the caller, whose writes
// a __syncthreads made visible), norms^2 in nrm (shared, n, followed by n
// ints for the sort order), then the rows in slot order to XTo / XBo (each
// m x n, m = n / 2, at this CTA's offset), or, given lam, the sorted
// eigenpairs to lam (n0) and V (n0 x n0).  A group of R::LANES lanes takes
// each pair.
template <typename T, class R>
__device__ void jacobi_sweeps(T* X, T* nrm, T* __restrict__ XTo,
                              T* __restrict__ XBo, int* counts,
                              T* __restrict__ lam, T* __restrict__ V, int n,
                              int n0, int sweeps, T tol, T null_rel, T eps) {
  constexpr int G = R::LANES;
  __shared__ T red[32];
  const int m = n / 2, ld = R::ld(n);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int gl = tid % G, grp = tid / G, ngrp = blockDim.x / G;
  const int iters = (m + ngrp - 1) / ngrp;    // pairs per group

  // exact norms^2 of every row (the slot map is the identity at a sweep
  // boundary: group q takes rows 2q, 2q + 1); returns the largest this
  // thread saw.  Visible after the caller's next __syncthreads.
  auto refresh = [&]() {
    T mx = T(0);
    for (int k = 0; k < iters; ++k) {
      const int q = grp + k * ngrp;
      T s0 = T(0), s1 = T(0);
      if (q < m) {
        R r;
        r.load(X, n, 2 * q, 2 * q + 1, gl);
        r.norms(s0, s1);
      }
      s0 = group_sum<G>(s0);
      s1 = group_sum<G>(s1);
      if (q < m && gl == 0) {
        nrm[2 * q] = s0;
        nrm[2 * q + 1] = s1;
      }
      mx = s0 > mx ? s0 : mx;
      mx = s1 > mx ? s1 : mx;
    }
    return mx;
  };
  // the CTA's max of v (>= 0): one __syncthreads
  auto block_max = [&](T v) {
    v = warp_max(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    return warp_max(lane < nwarps ? red[lane] : T(0));
  };

  const T amax2 = block_max(refresh());
  const T gate = (null_rel * amax2) * (null_rel * amax2);
  T off = T(F32_MAX);
  int it = 0;
  while (tol > T(0) ? (it < sweeps && off > tol) : it < sweeps) {
    T off_w = T(0);
    for (int rnd = 0; rnd < n - 1; ++rnd) {
      for (int k = 0; k < iters; ++k) {
        const int q = grp + k * ngrp;
        const bool act = q < m;
        const int rt = act ? slot_top(q, rnd, m) : 0;
        const int rb = act ? slot_bot(q, rnd, m) : 1;
        R rows;
        T c = T(0), a = T(0), b = T(0);
        if (act) {
          rows.load(X, n, rt, rb, gl);
          c = rows.dot();
          a = nrm[rt];
          b = nrm[rb];
        }
        c = group_sum<G>(c);
        Rot<T> r{T(0), T(0), T(0)};
        if (act) {
          r = rotation(c, a, b, gate, eps, off_w);
          rows.rotate(r.cs, r.sn);
        }
        __syncwarp();   // every lane has read a, b before lane 0 writes
        if (act && gl == 0) {
          nrm[rt] = r.cs * r.cs * a - T(2) * r.csnc + r.sn * r.sn * b;
          nrm[rb] = r.sn * r.sn * a + T(2) * r.csnc + r.cs * r.cs * b;
        }
      }
      __syncthreads();
    }
    ++it;
    refresh();
    off = block_max(off_w);
  }
  if (counts != nullptr && tid == 0) counts[blockIdx.x] = it;

  if (lam != nullptr) {
    // nrm holds the exact norms^2 of the final rows (the last refresh, made
    // visible by block_max's barrier); row i is slot i at a sweep boundary
    int* ord = reinterpret_cast<int*>(nrm + n);
    for (int i = tid; i < n; i += blockDim.x) nrm[i] = sqrt(nrm[i]);
    __syncthreads();
    for (int i = tid; i < n; i += blockDim.x) {
      const T li = nrm[i];
      const int me = cat_index(i, m);
      int rank = 0;
      for (int j = 0; j < n; ++j)
        rank += (nrm[j] > li || (nrm[j] == li && cat_index(j, m) < me)) ? 1
                                                                          : 0;
      ord[rank] = i;
    }
    __syncthreads();
    const size_t lb = (size_t)blockIdx.x * n0;
    for (int r = tid; r < n0; r += blockDim.x) lam[lb + r] = nrm[ord[r]];
    T* Vb = V + lb * n0;
    for (int e = tid; e < n0 * n0; e += blockDim.x) {
      const int c = e / n0, i = ord[e - c * n0];
      const T li = nrm[i];
      Vb[e] = X[(size_t)i * ld + c] / (li > T(1e-30) ? li : T(1e-30));
    }
    return;
  }
  const size_t obase = (size_t)blockIdx.x * m * n;
  for (int e = tid; e < m * n; e += blockDim.x) {
    const int q = e / n, l = e - q * n;
    XTo[obase + e] = X[(size_t)2 * q * ld + l];
    XBo[obase + e] = X[(size_t)(2 * q + 1) * ld + l];
  }
}

// gX: null for rows in shared memory, else the global workspace (B, n, n)
// of which this CTA uses its own slice.  Returns the rows; nrm (and the
// order after it) follow them in shared memory.
template <typename T>
__device__ T* carve(unsigned char* smem, int rows_elems, T* gX, T*& nrm) {
  T* s = reinterpret_cast<T*>(smem);
  if (gX) {
    nrm = s;
    return gX + (size_t)blockIdx.x * rows_elems;
  }
  nrm = s + rows_elems;
  return s;
}

// K5: rows of G (B, n, n), one CTA per matrix.
template <typename T, class R>
__global__ void __launch_bounds__(R::MAX_THREADS)
    jacobi_rows_kernel(const T* __restrict__ Gm, T* __restrict__ XTo,
                       T* __restrict__ XBo, T* gX, int* counts,
                       T* __restrict__ lam, T* __restrict__ V, int n, int n0,
                       int sweeps, T tol, T null_rel, T eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = R::ld(n);
  T* nrm;
  T* X = carve<T>(smem_raw, n * ld, gX, nrm);
  const T* g = Gm + (size_t)blockIdx.x * n * n;
  for (int e = threadIdx.x; e < n * ld; e += blockDim.x) {
    const int r = e / ld, l = e - r * ld;
    X[e] = l < n ? g[r * n + l] : T(0);
  }
  __syncthreads();
  jacobi_sweeps<T, R>(X, nrm, XTo, XBo, counts, lam, V, n, n0, sweeps, tol,
                      null_rel, eps);
}

// K8: W = ZT YT^T from ZT, YT (B, k, nf), then the sweeps on W's rows with
// a warp per pair (LoopRows, see the note at the top), then the sorted
// eigenpairs to lam (B, k), V (B, k, k).  All 32 warps build W (k^2 dots of
// length nf); the sweeps take a warp per pair, the rest idle.
template <typename T>
__global__ void __launch_bounds__(LoopRows<T>::MAX_THREADS)
    weig_kernel(const T* __restrict__ ZT, const T* __restrict__ YT,
                T* __restrict__ lam, T* __restrict__ V, T* gX, int k, int nf,
                int sweeps, T tol, T null_rel, T eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* nrm;
  T* X = carve<T>(smem_raw, k * k, gX, nrm);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t base = (size_t)blockIdx.x * k * nf;
  for (int e = warp; e < k * k; e += nwarps) {
    const T* z = ZT + base + (size_t)(e / k) * nf;
    const T* y = YT + base + (size_t)(e % k) * nf;
    T s = T(0);
    for (int l = lane; l < nf; l += 32) s += z[l] * y[l];
    s = slod::warp_sum(s);
    if (lane == 0) X[e] = s;
  }
  __syncthreads();
  jacobi_sweeps<T, LoopRows<T>>(X, nrm, nullptr, nullptr, nullptr, lam, V,
                                k, k, sweeps, tol, null_rel, eps);
}

template <typename T, class R>
int launch_rows(const T* G, T* XT, T* XB, T* ws, int* counts, T* lam, T* V,
                int B, int n, int n0, int sweeps, T tol, T null_rel, T eps,
                size_t smem, cudaStream_t stream) {
  const cudaError_t err = slod::opt_in_smem(
      reinterpret_cast<const void*>(jacobi_rows_kernel<T, R>), smem);
  if (err != cudaSuccess) return (int)err;
  jacobi_rows_kernel<T, R>
      <<<B, cta_threads(n / 2, R::LANES, R::MAX_THREADS), smem, stream>>>(
          G, XT, XB, ws, counts, lam, V, n, n0, sweeps, tol, null_rel, eps);
  return (int)cudaGetLastError();
}

// lam / V null: the rows to XT / XB; else the n0 sorted eigenpairs (n0 is
// n, or n - 1 where the caller padded an odd n with a zero row) to lam, V.
template <typename T>
int launch_jacobi(void* G, void* XT, void* XB, void* ws, void* counts,
                  void* lam, void* V, int B, int n, int n0, int sweeps,
                  double tol, double null_rel, double eps, void* stream) {
  if (B <= 0 || n < 2 || n % 2) return (int)cudaErrorInvalidValue;
  if (lam != nullptr ? (V == nullptr || n0 < n - 1 || n0 > n)
                     : (XT == nullptr || XB == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 32) {
    jacobi_rows_warp32<T>
        <<<(B + WARP_MATS - 1) / WARP_MATS, WARP_MATS * 32, 0,
           (cudaStream_t)stream>>>((const T*)G, (T*)XT, (T*)XB, (int*)counts,
                                   (T*)lam, (T*)V, B, n0, sweeps, (T)tol,
                                   (T)null_rel, (T)eps);
    return (int)cudaGetLastError();
  }
  const int ld = k5_ld<T>(n);
  const long long ge = rows_ws_elems<T>(n, ld);
  if (ge < 0 || (ge > 0 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  auto launch = n <= RegRows<T>::LD ? &launch_rows<T, RegRows<T>>
                                    : &launch_rows<T, LoopRows<T>>;
  return launch((const T*)G, (T*)XT, (T*)XB, ge > 0 ? (T*)ws : nullptr,
                (int*)counts, (T*)lam, (T*)V, B, n, n0, sweeps, (T)tol,
                (T)null_rel, (T)eps, rows_smem<T>(n, ld, ge > 0),
                (cudaStream_t)stream);
}

template <typename T>
int launch_weig(void* ZT, void* YT, void* lam, void* V, void* ws, int B,
                int k, int nf, int sweeps, double tol, double null_rel,
                double eps, void* stream) {
  if (B <= 0 || k < 2 || k % 2 || nf <= 0) return (int)cudaErrorInvalidValue;
  const long long ge = rows_ws_elems<T>(k, k);
  if (ge < 0 || (ge > 0 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = rows_smem<T>(k, k, ge > 0);
  const cudaError_t err = slod::opt_in_smem(
      reinterpret_cast<const void*>(weig_kernel<T>), smem);
  if (err != cudaSuccess) return (int)err;
  weig_kernel<T><<<B, LoopRows<T>::MAX_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)ZT, (const T*)YT, (T*)lam, (T*)V, ge > 0 ? (T*)ws : nullptr,
      k, nf, sweeps, (T)tol, (T)null_rel, (T)eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slod_jacobi_rows_f32(void* G, void* XT, void* XB, void* ws, void* counts,
                         void* lam, void* V, int B, int n, int n0,
                         int sweeps, double tol, double null_rel, double eps,
                         void* stream) {
  return launch_jacobi<float>(G, XT, XB, ws, counts, lam, V, B, n, n0, sweeps,
                              tol, null_rel, eps, stream);
}
int slod_jacobi_rows_f64(void* G, void* XT, void* XB, void* ws, void* counts,
                         void* lam, void* V, int B, int n, int n0,
                         int sweeps, double tol, double null_rel, double eps,
                         void* stream) {
  return launch_jacobi<double>(G, XT, XB, ws, counts, lam, V, B, n, n0,
                               sweeps, tol, null_rel, eps, stream);
}
int slod_weig_f32(void* ZT, void* YT, void* lam, void* V, void* ws, int B,
                  int k, int nf, int sweeps, double tol, double null_rel,
                  double eps, void* stream) {
  return launch_weig<float>(ZT, YT, lam, V, ws, B, k, nf, sweeps, tol,
                            null_rel, eps, stream);
}
int slod_weig_f64(void* ZT, void* YT, void* lam, void* V, void* ws, int B,
                  int k, int nf, int sweeps, double tol, double null_rel,
                  double eps, void* stream) {
  return launch_weig<double>(ZT, YT, lam, V, ws, B, k, nf, sweeps, tol,
                             null_rel, eps, stream);
}
// workspace elements per matrix of K5 / K8 at row length n (0: the rows
// fit in shared memory; -1: no launch can take n)
long long slod_jacobi_rows_ws_f32(int n) {
  return n == 32 ? 0 : rows_ws_elems<float>(n, k5_ld<float>(n));
}
long long slod_jacobi_rows_ws_f64(int n) {
  return n == 32 ? 0 : rows_ws_elems<double>(n, k5_ld<double>(n));
}
long long slod_weig_ws_f32(int k) { return rows_ws_elems<float>(k, k); }
long long slod_weig_ws_f64(int k) { return rows_ws_elems<double>(k, k); }

}  // extern "C"
