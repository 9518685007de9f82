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
// sweeps of 125; the float64 elasticity W, 374 x 374: ~5-6 sweeps of 373).
// So the design removes what stands between two rounds.  Three routines,
// chosen by n and the type alone (jacobi_route):
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
// * rows that fit one CTA's shared memory (the Jacobi route's 126 x 126
//   factor rows; K8): one CTA per matrix, the rows in shared memory for the
//   whole run, so global memory is touched once each way.  The rows never
//   move: the row a slot holds at round r is computed in closed form
//   (slot_top / slot_bot: the caterpillar with slot t0 fixed rotates the
//   other 2m - 1 slots by one each round), so a round ends in one CTA
//   barrier and nothing else; the sweep's `off` max and the first sweep's
//   amax2 are warp-shuffle maxima.  At n <= 128 (RegRows) the rows are
//   padded with zero columns to 128 (64 KB f32, 128 KB f64) and a group of
//   lanes takes each pair (8 lanes in f32: all 63 pairs of n = 126 at
//   once, 504 threads; 16 in f64): each lane loads its four 16-byte chunks
//   of both rows into registers once per round, forms its part of the dot,
//   and after the group's shuffle sum writes the rotated chunks back.  A
//   round moves all n^2 values through shared memory and back; that
//   traffic and the per-pair rotation arithmetic are what it costs.
//   Beyond 128 (LoopRows) a warp per pair walks the rows at stride n with
//   a runtime loop.
// * rows beyond one CTA's shared memory (the float64 elasticity W at
//   n = 374: 1.1 MB, where a CTA has 227 KB): a thread-block cluster per
//   matrix, the rows in registers (jacobi_cluster_kernel).  A warp holds
//   the four rows of two consecutive caterpillar pairs, lane l elements
//   2 l, 2 l + 1, 64 + 2 l, ... of each, and the rows travel with their
//   slots as in the n = 32 routine, so a pair's dot is one warp's
//   lane-strided sums and butterfly, and nothing is re-read to form it.
//   Of a warp's four rows two move to the neighbour warps each round
//   (16-byte pieces through an inbox in shared memory, one CTA barrier a
//   round) and two stay in registers; at a CTA's edge the row goes to the
//   neighbour CTA through distributed shared memory by asynchronous stores
//   (st.async) counted on the receiver's mbarrier, so the sender never
//   waits.  The two dots share one transposed butterfly and each half-warp
//   computes one pair's rotation, with rsqrt for the cosine as the plain
//   version writes it.  The sweep's `off` and amax2 are cluster maxima,
//   one cluster barrier a sweep.  What the card showed
//   (scripts/dsmem_bench.py; H100 80GB HBM3, 700 W): a load from a
//   neighbour CTA's shared memory takes ~95-107 ns where one from a CTA's
//   own takes ~19, a cluster barrier ~0.73-0.77 us, and with twelve
//   independent loads in flight a thread reads a neighbour's shared memory
//   at 22-32 GB/s an SM against ~150 for its own (the same
//   ld.shared::cluster instruction).  A design in which CTAs own the rows
//   and a pair's warp reads and writes them where they lie would move most
//   rows through distributed shared memory and cross a cluster barrier
//   every round; it was not built.  This one sends two rows per CTA edge a
//   round and crosses the cluster once a sweep.  A round is
//   bound by latency: the dots, the rotation's divide / square-root
//   chain and the rows' moves, each a few hundred cycles.  The largest
//   cluster that takes n is used (16 CTAs of 6 warps at 374: the fewer
//   rows an SM moves a round, the shorter the round).  The route takes
//   n <= 384 (12 values of a row a lane; the rows of 16 CTAs' registers).
//   Beyond, LoopRows walks the rows in a per-CTA slice of a global
//   workspace the caller allocates (jacobi_route decides; no path runs
//   it).

// All routines run the plain version's rounds in its order (the same
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
// bounds it: the same sweep latency chain on a (k, k) W; the build is k^2
// nf FMAs (32 x 32 x 125 per matrix on the main path; 40 GFLOP on the 384
// float64 W at k = 374), small beside the sweeps.  Design: K8 takes K5's
// float64 route at row length k (jacobi_route) and builds W in the same
// launch straight into the storage that route sweeps (FactorSrc), never as
// a matrix in global memory: at k = 32 the warp forms W on the tensor
// cores (DMMA) from chunks of ZT and YT staged in its own shared memory
// and hands it over there so that lane l holds column l (its V leaves
// through the same memory in coalesced rows); at k <= 128 (the float64
// k = 124) the CTA forms the padded rows in shared memory by a tiled
// product over chunks of nf staged for the whole CTA (ZT and YT, 248 KB at
// k = 124, do not fit beside the 128 KB of rows); at k = 374 each CTA of
// the cluster builds the rows its warps hold into their registers, in the
// route's layout, from chunks of its ZT rows and of YT staged in the
// memory its inboxes later use, so the route needs no workspace.  K8
// builds and sweeps in float64 at either input type (with that type's eps
// and null_rel) and rounds only the eigenpairs to it: in float32
// arithmetic the adaptive stop falls a sweep apart from the float64 plain
// version's on ~0.4% of the main path's W,
// whatever the order of summation (the rows' own rounding, ~1e-6 of their
// norms after a few dozen rotations, moves a pair's squared cosine by
// ~1e-3 of itself near tol; summing the pair dots or the norms in float64
// did not change that), and a matrix that stops a sweep early put its
// chunk up to 7x over the float32 gate (error against the float64 plain
// version <= 4x the float32 plain version's + 1e-6; chip_smoke.py reads it
// on every chunk of the weig path).  In float64 the kernel stops where the
// float64 plain version does.  The TPU kernel shared its stop over the
// whole batch (grid = ()); here each matrix stops on its own.  K8 always
// writes the sorted eigenpairs.

#include <cooperative_groups.h>

#include <algorithm>

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

__device__ __forceinline__ double recip(double x) { return __drcp_rn(x); }
__device__ __forceinline__ float recip(float x) { return __frcp_rn(x); }

// One pair's rotation from its dot c and carried norms a (top), b (bottom):
// the formulas of the plain version; folds the squared row-cosine of a
// significant pair into off.  kRsqrt (the cluster route) shortens the chain
// of long-latency steps: sgn / x as sgn times the correctly rounded
// reciprocal (the same value), and the cosine as rsqrt(1 + t^2), as the
// plain version writes it (torch.rsqrt), instead of 1 / sqrt: one division
// fewer.
template <typename T>
struct Rot {
  T cs, sn, csnc;
};

template <typename T, bool kRsqrt = false>
__device__ __forceinline__ Rot<T> rotation(T c, T a, T b, T gate, T eps,
                                           T& off) {
  if (a * b > gate) {
    const T cos2 = (c * c) / (a * b + eps);
    off = cos2 > off ? cos2 : off;
  }
  const bool big = fabs(c) > eps;
  const T zeta = (b - a) / (T(2) * (big ? c : T(1)));
  const T sgn = zeta >= T(0) ? T(1) : T(-1);
  Rot<T> r;
  if constexpr (kRsqrt) {
    const T t = big ? sgn * recip(fabs(zeta) + sqrt(T(1) + zeta * zeta))
                    : T(0);
    r.cs = rsqrt(T(1) + t * t);
    r.sn = r.cs * t;
  } else {
    const T t = big ? sgn / (fabs(zeta) + sqrt(T(1) + zeta * zeta)) : T(0);
    r.cs = T(1) / sqrt(T(1) + t * t);
    r.sn = r.cs * t;
  }
  r.csnc = r.cs * r.sn * c;
  return r;
}

// The place of the row in caterpillar slot s (top slot q / bottom slot q,
// m pairs) in the plain version's cat([XT, XB]): what breaks ties of the
// sort.
__device__ __forceinline__ int cat_index(int s, int m) {
  return (s & 1) ? m + (s >> 1) : (s >> 1);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// one value from global to shared memory, asynchronously (4 or 8 bytes:
// rows of 125 / 375 float32 values lie only on 4-byte boundaries)
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"((int)sizeof(T))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// d += a b on the tensor cores (DMMA): an 8 x 8 float64 tile, k = 4
__device__ __forceinline__ void dmma(double* d, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1}, {%2}, {%3}, {%0,%1};"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// ---------------------------------------------------------------------------
// Where the rows come from.  K5 reads them (RowsSrc: G (B, n, n)); K8
// builds them (FactorSrc: W = ZT YT^T from ZT, YT (B, n, nf), W[i, j] =
// ZT[i] . YT[j], not symmetrized) straight into the storage each routine
// sweeps: the n = 32 routine's registers (fill_warp32), the CTA routine's
// rows (fill_rows), the cluster route's registers (fill_cluster).  The
// *_stage members give the dynamic shared memory a fill stages in (bytes).
// ---------------------------------------------------------------------------

template <typename T>
struct RowsSrc {
  using Out = T;
  static constexpr bool kRsqrt = false;   // the n = 32 rotation's form
  const T* G;
  static size_t warp32_stage() { return 0; }
  template <class R>
  static size_t rows_stage() { return 0; }
  static size_t cluster_stage(int, int) { return 0; }

  __device__ __forceinline__ T* vtile(unsigned char*, int) const {
    return nullptr;
  }
  // x[s]: element `lane` of row s of matrix b
  __device__ __forceinline__ void fill_warp32(T* x, int b, int lane, int,
                                              unsigned char*) const {
    const T* g = G + (size_t)b * 32 * 32;
#pragma unroll
    for (int s = 0; s < 32; ++s) x[s] = g[s * 32 + lane];
  }
  // the n rows of matrix b at stride R::ld(n), columns n .. ld - 1 zero
  template <class R>
  __device__ __forceinline__ void fill_rows(T* X, int n, int b,
                                            unsigned char*) const {
    const int ld = R::ld(n);
    const T* g = G + (size_t)b * n * n;
    for (int e = threadIdx.x; e < n * ld; e += blockDim.x) {
      const int r = e / ld, l = e - r * ld;
      X[e] = l < n ? g[r * n + l] : T(0);
    }
  }
  // the cluster route's four rows of a warp (pairs p0, p1; see
  // jacobi_cluster_kernel), lane's elements col(j), zero beyond n
  template <int J, class Col>
  __device__ __forceinline__ void fill_cluster(T* t0, T* b0, T* t1, T* b1,
                                               Col col, int b, int n, int p0,
                                               int p1, int, int,
                                               unsigned char*) const {
    const int m = n / 2;
    const bool act = p0 < m, has1 = p1 < m;
    const T* g = G + (size_t)b * n * n;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = col(j);
      const bool ok = c < n;
      t0[j] = ok && act ? g[(size_t)(2 * p0) * n + c] : T(0);
      b0[j] = ok && act ? g[(size_t)(2 * p0 + 1) * n + c] : T(0);
      t1[j] = ok && has1 ? g[(size_t)(2 * p1) * n + c] : T(0);
      b1[j] = ok && has1 ? g[(size_t)(2 * p1 + 1) * n + c] : T(0);
    }
  }
};

// K8's build: W = ZT YT^T from ZT, YT (B, n, nf) of type In (float32 or
// float64) into float64 rows (K8 sweeps in float64 at either input type,
// see the note at the top).  Every W entry is a dot of length nf summed in
// float64, by FMAs or by DMMA (which rounds as a chain of FMAs does; the
// products of float32 inputs are exact); the factors reach shared memory
// by cp.async, a value at a time (rows of 125 / 375 float32 values lie only
// on 4-byte boundaries), in chunks of nf.
template <typename In>
struct FactorSrc {
  using Out = In;
  // the n = 32 routine's rotation form (rotation): the cosine as
  // rsqrt(1 + t^2), as the plain version writes it
  static constexpr bool kRsqrt = true;
  const In* ZT;
  const In* YT;
  int nf;
  static constexpr int WI = 16 / (int)sizeof(In);   // inputs in 16 bytes

  // n = 32: the warp forms its matrix's W on the tensor cores (DMMA,
  // mma.m8n8k4.f64: a 4 x 4 grid of 8 x 8 tiles, 16 products a k-step of
  // 4, each tile's sum rounded as a chain of FMAs in the order of l) from
  // chunks of WFC values of ZT's and YT's rows staged in its own shared
  // memory, WNS buffers (the next chunks' copies in flight while one is
  // summed; stride 36: fragment loads without bank conflicts), then
  // passes the tiles through shared memory so that lane l holds column l,
  // x[s] = W[s, l] = ZT[s] . YT[l], the layout the routine sweeps.
  static constexpr int WFC = 32, WLD = 36, WLDW = 40;
  static constexpr int WNS = sizeof(In) == 4 ? 4 : 2;    // 74 / 147 KB a CTA
  static constexpr int WSTAGE = 2 * 32 * WLD;            // In values
  static constexpr size_t WWARP = WNS * WSTAGE * sizeof(In);
  static_assert(WWARP >= 32 * WLDW * sizeof(double), "W fits the stages");
  static size_t warp32_stage() { return (size_t)WARP_MATS * WWARP; }
  // the finalize's tile for V (finalize_warp): warp w's stages, free again
  __device__ __forceinline__ double* vtile(unsigned char* smem, int w) const {
    return reinterpret_cast<double*>(smem + (size_t)w * WWARP);
  }
  __device__ __forceinline__ void fill_warp32(double* x, int b, int lane,
                                              int w,
                                              unsigned char* smem) const {
    constexpr int N = 32;
    In* st = reinterpret_cast<In*>(smem + (size_t)w * WWARP);
    const In* zt = ZT + (size_t)b * N * nf;
    const In* yt = YT + (size_t)b * N * nf;
    // rows of ZT then of YT, value c0 + lane of each to column lane
    auto fetch = [&](int c0, In* s) {
      if (c0 + lane < nf) {
        for (int r = 0; r < N; ++r) {
          cp_async(s + r * WLD + lane, zt + (size_t)r * nf + c0 + lane);
          cp_async(s + (N + r) * WLD + lane, yt + (size_t)r * nf + c0 + lane);
        }
      }
      cp_async_commit();
    };
    const int fr = lane >> 2, fk = lane & 3;   // a fragment's row, k
    double acc[4][4][2];
#pragma unroll
    for (int R = 0; R < 4; ++R)
#pragma unroll
      for (int C = 0; C < 4; ++C) acc[R][C][0] = acc[R][C][1] = 0.0;
#pragma unroll
    for (int c = 0; c < WNS - 1; ++c) fetch(c * WFC, st + c * WSTAGE);
    for (int c0 = 0, ci = 0; c0 < nf; c0 += WFC, ++ci) {
      // chunk ci + WNS - 1 (an empty group past the end), then chunk ci in
      fetch(c0 + (WNS - 1) * WFC, st + (ci + WNS - 1) % WNS * WSTAGE);
      cp_async_wait<WNS - 1>();
      __syncwarp();
      const In* zs = st + ci % WNS * WSTAGE;
      const In* ys = zs + N * WLD;
      const int nc = min(WFC, nf - c0);
      for (int k0 = 0; k0 < nc; k0 += 4) {
        const bool in = k0 + fk < nc;           // beyond: zero
        double a[4], bb[4];
#pragma unroll
        for (int R = 0; R < 4; ++R) {
          a[R] = in ? (double)zs[(8 * R + fr) * WLD + k0 + fk] : 0.0;
          bb[R] = in ? (double)ys[(8 * R + fr) * WLD + k0 + fk] : 0.0;
        }
#pragma unroll
        for (int R = 0; R < 4; ++R)
#pragma unroll
          for (int C = 0; C < 4; ++C) dmma(acc[R][C], a[R], bb[C]);
      }
      __syncwarp();             // this chunk's reads are done
    }
    // tile (R, C): lane holds W[8 R + fr][8 C + 2 fk + {0, 1}]
    double* ws = reinterpret_cast<double*>(st);
#pragma unroll
    for (int R = 0; R < 4; ++R)
#pragma unroll
      for (int C = 0; C < 4; ++C)
        *reinterpret_cast<Pair<double>*>(ws + (8 * R + fr) * WLDW + 8 * C +
                                         2 * fk) =
            Pair<double>{acc[R][C][0], acc[R][C][1]};
    __syncwarp();
#pragma unroll
    for (int s = 0; s < N; ++s) x[s] = ws[s * WLDW + lane];
  }

  // The CTA routine.  RegRows (rows padded to 128): a tiled product, a
  // warp 8 rows by the 128 columns lane + 32 j, summed in registers over
  // chunks of RFC values staged for the whole CTA as zs[i][r] = ZT[r][c0 +
  // i] and ys[i][c] = YT[c][c0 + i] (rows n .. 127 zero: W's pad columns).
  // LoopRows: a warp per W entry, read from global memory.
  static constexpr int RFC = 32, RB = 8;
  template <class R>
  static size_t rows_stage() {
    if constexpr (R::kPadded)
      return (size_t)2 * RFC * (R::LD + WI) * sizeof(In);
    else
      return 0;
  }
  template <class R>
  __device__ __forceinline__ void fill_rows(double* X, int n, int b,
                                            unsigned char* smem) const {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nw = blockDim.x >> 5;
    const In* zt = ZT + (size_t)b * n * nf;
    const In* yt = YT + (size_t)b * n * nf;
    if constexpr (!R::kPadded) {
      for (int e = warp; e < n * n; e += nw) {
        const In* z = zt + (size_t)(e / n) * nf;
        const In* y = yt + (size_t)(e % n) * nf;
        double s = 0.0;
        for (int l = lane; l < nf; l += 32)
          s = fma((double)z[l], (double)y[l], s);
        s = slod::warp_sum(s);
        if (lane == 0) X[e] = s;
      }
    } else {
      constexpr int LD = R::LD, SLD = LD + WI;
      In* zs = reinterpret_cast<In*>(smem);
      In* ys = zs + RFC * SLD;
      for (int e = tid; e < RFC * (LD - n); e += blockDim.x) {
        const int i = e / (LD - n), r = n + e % (LD - n);
        zs[i * SLD + r] = In(0);
        ys[i * SLD + r] = In(0);
      }
      const int nrb = (n + RB - 1) / RB;
      const int passes = (nrb + nw - 1) / nw;
      for (int p = 0; p < passes; ++p) {
        const int rb = warp + p * nw;
        double acc[RB][4];
#pragma unroll
        for (int a = 0; a < RB; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[a][j] = 0.0;
        for (int c0 = 0; c0 < nf; c0 += RFC) {
          const int nc = min(RFC, nf - c0);
          __syncthreads();      // the previous chunk's reads are done
          for (int e = tid; e < n * nc; e += blockDim.x) {
            const int r = e / nc, i = e - r * nc;
            cp_async(zs + i * SLD + r, zt + (size_t)r * nf + c0 + i);
            cp_async(ys + i * SLD + r, yt + (size_t)r * nf + c0 + i);
          }
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          if (rb < nrb) {
            for (int i = 0; i < nc; ++i) {
              const slod::Vec16<In>* zr =
                  reinterpret_cast<const slod::Vec16<In>*>(zs + i * SLD +
                                                           rb * RB);
              double z[RB], y[4];
#pragma unroll
              for (int v = 0; v < RB / WI; ++v) {
                const slod::Vec16<In> zz = zr[v];
#pragma unroll
                for (int e = 0; e < WI; ++e) z[v * WI + e] = zz.v[e];
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) y[j] = ys[i * SLD + lane + 32 * j];
#pragma unroll
              for (int a = 0; a < RB; ++a)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  acc[a][j] = fma(z[a], y[j], acc[a][j]);
            }
          }
        }
        if (rb < nrb) {
#pragma unroll
          for (int a = 0; a < RB; ++a) {
            const int r = rb * RB + a;
            if (r < n) {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                X[(size_t)r * LD + lane + 32 * j] = acc[a][j];
            }
          }
        }
      }
    }
  }

  // The cluster route: each CTA builds the 2 P rows its warps hold (rows
  // rank 2 P + 4 w .. + 3 on warp w), lane l its elements col(j), in
  // registers.  Chunks of CFC values are staged for the whole CTA: the
  // CTA's ZT rows as zs[i][q] = ZT[rank 2 P + q][c0 + i] (a warp's four
  // values one or two 16-byte broadcasts) and YT as ys[i][c] = YT[c][c0 +
  // i] (a lane's pair of columns one 16-byte / 8-byte load; columns n ..
  // 32 J + 1 zero).  The staging lies where the inboxes will be: no CTA
  // sends a row before every CTA of the cluster has passed the cluster
  // barrier that follows the build.
  static constexpr int CFC = 16;
  static size_t cluster_stage(int P, int J) {
    return (size_t)CFC * (2 * P + 32 * J + 2) * sizeof(In);
  }
  template <int J, class Col>
  __device__ __forceinline__ void fill_cluster(double* t0, double* b0,
                                               double* t1, double* b1,
                                               Col col, int b, int n, int,
                                               int, int rank, int P,
                                               unsigned char* smem) const {
    const int rows = 2 * P, ldy = 32 * J + 2;
    const int tid = threadIdx.x, warp = tid >> 5;
    const int r0 = rank * rows;
    const int here = min(rows, n - r0);    // rows of W in this CTA (> 0)
    In* zs = reinterpret_cast<In*>(smem);
    In* ys = zs + CFC * rows;
    const In* zt = ZT + ((size_t)b * n + r0) * nf;
    const In* yt = YT + (size_t)b * n * nf;
    for (int e = tid; e < CFC * (rows - here); e += blockDim.x) {
      const int i = e / (rows - here);
      zs[i * rows + here + e - i * (rows - here)] = In(0);
    }
    for (int e = tid; e < CFC * (ldy - n); e += blockDim.x) {
      const int i = e / (ldy - n);
      ys[i * ldy + n + e - i * (ldy - n)] = In(0);
    }
#pragma unroll
    for (int j = 0; j < J; ++j) t0[j] = b0[j] = t1[j] = b1[j] = 0.0;
    for (int c0 = 0; c0 < nf; c0 += CFC) {
      const int nc = min(CFC, nf - c0);
      __syncthreads();          // the previous chunk's reads are done
      for (int e = tid; e < here * nc; e += blockDim.x) {
        const int q = e / nc, i = e - q * nc;
        cp_async(zs + i * rows + q, zt + (size_t)q * nf + c0 + i);
      }
      for (int e = tid; e < n * nc; e += blockDim.x) {
        const int c = e / nc, i = e - c * nc;
        cp_async(ys + i * ldy + c, yt + (size_t)c * nf + c0 + i);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int i = 0; i < nc; ++i) {
        double z[4];
        const slod::Vec16<In>* zr =
            reinterpret_cast<const slod::Vec16<In>*>(zs + i * rows + 4 * warp);
#pragma unroll
        for (int v = 0; v < 4 / WI; ++v) {
          const slod::Vec16<In> zz = zr[v];
#pragma unroll
          for (int e = 0; e < WI; ++e) z[v * WI + e] = zz.v[e];
        }
        const In* yr = ys + i * ldy;
#pragma unroll
        for (int j = 0; j < J; j += 2) {
          const Pair<In> p = *reinterpret_cast<const Pair<In>*>(yr + col(j));
          const double y0 = p.x, y1 = p.y;
          t0[j] = fma(z[0], y0, t0[j]);
          t0[j + 1] = fma(z[0], y1, t0[j + 1]);
          b0[j] = fma(z[1], y0, b0[j]);
          b0[j + 1] = fma(z[1], y1, b0[j + 1]);
          t1[j] = fma(z[2], y0, t1[j]);
          t1[j + 1] = fma(z[2], y1, t1[j + 1]);
          b1[j] = fma(z[3], y0, b1[j]);
          b1[j + 1] = fma(z[3], y1, b1[j + 1]);
        }
      }
    }
  }
};

// ---------------------------------------------------------------------------
// n = 32: one warp per matrix, the rows in registers
// ---------------------------------------------------------------------------

// The eigenpairs of matrix b from its final rows x (as in the kernel
// below): lane l takes slot l's exact norm and its rank in the descending
// order, then writes element l of every row over its norm into column
// `rank` of V (row l); ranks >= n0 and lanes >= n0 are dropped.  Given
// `tile` (N x (N + 1) values of this warp's shared memory), the rows
// over their norms (times the norm's reciprocal) go there first, and V
// leaves in whole rows, one coalesced store a row.
template <int N, typename T, typename TO>
__device__ __forceinline__ void finalize_warp(const T* x, int lane, int b,
                                              int n0, TO* __restrict__ lam,
                                              TO* __restrict__ V, T* tile) {
  const T lv = sqrt(slot_norm<N>(x, lane));
  const int me = cat_index(lane, N / 2);
  int rank = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T lj = __shfl_sync(FULL, lv, j);
    rank += (lj > lv || (lj == lv && cat_index(j, N / 2) < me)) ? 1 : 0;
  }
  if (rank < n0) lam[(size_t)b * n0 + rank] = (TO)lv;
  const T den = lv > T(1e-30) ? lv : T(1e-30);
  if (tile != nullptr) {
    const T inv = T(1) / den;
#pragma unroll
    for (int s = 0; s < N; ++s) {
      const int rs = __shfl_sync(FULL, rank, s);
      tile[lane * (N + 1) + rs] = x[s] * __shfl_sync(FULL, inv, s);
    }
    __syncwarp();
    if (lane < n0)
      for (int r = 0; r < n0; ++r)
        V[((size_t)b * n0 + r) * n0 + lane] = (TO)tile[r * (N + 1) + lane];
    return;
  }
  TO* vrow = V + ((size_t)b * n0 + lane) * n0;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const int rs = __shfl_sync(FULL, rank, s);
    const T ds = __shfl_sync(FULL, den, s);
    if (lane < n0 && rs < n0) vrow[rs] = (TO)(x[s] / ds);
  }
}

template <typename T, class Src>
__global__ void __launch_bounds__(WARP_MATS * 32)
    jacobi_rows_warp32(Src in, T* __restrict__ XTo, T* __restrict__ XBo,
                       int* __restrict__ counts,
                       typename Src::Out* __restrict__ lam,
                       typename Src::Out* __restrict__ V, int B, int n0,
                       int sweeps, T tol, T null_rel, T eps) {
  constexpr int N = 32, M = N / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(16) T bc[WARP_MATS][N];   // (cs, sn) of each pair
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.x * WARP_MATS + w;
  if (b >= B) return;
  T* bcw = bc[w];
  T x[N];                     // x[s]: element `lane` of the row in slot s
  in.fill_warp32(x, b, lane, w, smem_raw);

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
      const Rot<T> r = rotation<T, Src::kRsqrt>(c, a, bn, gate, eps, off_w);
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
    finalize_warp<N>(x, lane, b, n0, lam, V, in.vtile(smem_raw, w));
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
  static constexpr bool kPadded = true;
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
  static constexpr bool kPadded = false;
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

// Shared memory of the CTA routine with rows of stride ld: the rows (unless
// they are in the global workspace), the norms and the sort order.
template <typename T>
__host__ __device__ size_t rows_smem(int n, int ld, bool global_rows) {
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

// where a fill's staging starts after `bytes` of shared memory
__host__ __device__ inline size_t stage_offset(size_t bytes) {
  return (bytes + 15) / 16 * 16;
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
template <typename T, class R, typename TO>
__device__ void jacobi_sweeps(T* X, T* nrm, T* __restrict__ XTo,
                              T* __restrict__ XBo, int* counts,
                              TO* __restrict__ lam, TO* __restrict__ V, int n,
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
    for (int r = tid; r < n0; r += blockDim.x) lam[lb + r] = (TO)nrm[ord[r]];
    TO* Vb = V + lb * n0;
    for (int e = tid; e < n0 * n0; e += blockDim.x) {
      const int c = e / n0, i = ord[e - c * n0];
      const T li = nrm[i];
      Vb[e] = (TO)(X[(size_t)i * ld + c] / (li > T(1e-30) ? li : T(1e-30)));
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

// One CTA per matrix: the rows from `in` into X, then the sweeps.  A fill's
// staging follows the rows, the norms and the sort order in shared memory
// (at rows_smem(n, ld, gX != null), rounded up to 16 bytes).
template <typename T, class R, class Src>
__global__ void __launch_bounds__(R::MAX_THREADS)
    jacobi_rows_kernel(Src in, T* __restrict__ XTo, T* __restrict__ XBo,
                       T* gX, int* counts, typename Src::Out* __restrict__ lam,
                       typename Src::Out* __restrict__ V, int n, int n0,
                       int sweeps, T tol, T null_rel, T eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = R::ld(n);
  T* nrm;
  T* X = carve<T>(smem_raw, n * ld, gX, nrm);
  in.template fill_rows<R>(
      X, n, blockIdx.x,
      smem_raw + stage_offset(rows_smem<T>(n, ld, gX != nullptr)));
  __syncthreads();
  jacobi_sweeps<T, R>(X, nrm, XTo, XBo, counts, lam, V, n, n0, sweeps, tol,
                      null_rel, eps);
}

// ---------------------------------------------------------------------------
// K5 beyond one CTA's shared memory: a thread-block cluster per matrix, the
// rows in registers, travelling with their caterpillar slots
// ---------------------------------------------------------------------------

// Cluster sizes the route may take, largest first (16 is beyond the
// portable 8 and needs cudaFuncAttributeNonPortableClusterSizeAllowed), and
// the row lengths of its instances (J values of a row per lane: n <= 32 J).
constexpr int CL_SIZES[] = {16, 8, 4, 2};
constexpr int CL_ROWS[] = {8, 12};

// Threads a CTA of the instance with rows of J values a lane may have: the
// 4 J values of the warp's four rows plus ~56 registers for the rest, in
// multiples of 128 (ptxas divides the register file by the launch bound
// rounded up to 128 threads).
template <typename T, int J>
constexpr int cl_max_threads() {
  constexpr int t = 65536 / (4 * J * (int)sizeof(T) / 4 + 56) / 128 * 128;
  return t < 1024 ? t : 1024;
}
template <typename T>
int cl_max_threads_rt(int J) {
  return J == 8 ? cl_max_threads<T, 8>() : cl_max_threads<T, 12>();
}

// The cluster's layout of an n x n matrix: S CTAs; CTA k takes the P
// consecutive pairs (caterpillar slots) k P .. k P + P - 1 (fewer in the
// last), warp w of it the two pairs k P + 2 w and k P + 2 w + 1, lane l
// J elements of their four rows (2 l, 2 l + 1, 64 + 2 l, ...).  Each warp
// has an inbox per direction in shared memory, two buffers of LDI values
// (a row and its norm).  The Python twin is ops/eig.py: k5_cluster_plan.
struct ClusterPlan {
  int S = 0, P = 0, J = 0, threads = 0, ldi = 0;
  size_t smem = 0;
};

// Shared memory of a CTA of W warps: the inboxes, and the n norms of the
// final sort.
template <typename T>
size_t cluster_smem(int n, int warps) {
  return ((size_t)warps * 4 * (n + 2) + n) * sizeof(T);
}

// The largest cluster of CL_SIZES in which no CTA is empty, whose CTA's
// warps fit the instance's thread limit (the registers holding the rows)
// and whose inboxes fit in a CTA's shared memory: the more CTAs share a
// matrix, the fewer rows each SM moves a round (at 374 x 374 float64, 16
// CTAs of 6 warps took 4.42 ms of device time on 4 W where 8 CTAs of 12
// took 5.93, and 142.5-142.8 ms on 384 W where 8 took 148.5; H100 80GB
// HBM3, 700 W, chip_smoke.py on a copy from scripts/k5_cluster_variant.py).
// S = 0: no cluster takes n.
template <typename T>
ClusterPlan cluster_plan(int n) {
  ClusterPlan p;
  const size_t lim = slod::max_smem_optin();
  if (lim <= slod::STATIC_SMEM_MARGIN || n < 4 || n % 2) return p;
  int J = 0;
  for (int j : CL_ROWS)
    if (J == 0 && 32 * j >= n) J = j;
  if (J == 0) return p;
  const int m = n / 2;
  for (int S : CL_SIZES) {
    int P = (m + S - 1) / S;
    P += P & 1;
    if ((S - 1) * P >= m) continue;          // a CTA would hold no pair
    const int threads = P / 2 * 32;
    const size_t smem = cluster_smem<T>(n, P / 2);
    if (threads > cl_max_threads_rt<T>(J) ||
        smem > lim - slod::STATIC_SMEM_MARGIN)
      continue;
    p.S = S;
    p.P = P;
    p.J = J;
    p.threads = threads;
    p.ldi = n + 2;
    p.smem = smem;
    return p;
  }
  return p;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the shared::cluster address of shared address `a` in CTA `rank`
__device__ __forceinline__ unsigned mapa(unsigned a, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
// an asynchronous store into another CTA's shared memory that counts its
// bytes on that CTA's mbarrier (both shared::cluster addresses)
__device__ __forceinline__ void st_async(unsigned a, double v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];" ::"r"(a), "l"(__double_as_longlong(v)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(unsigned a, float v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(a), "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}
// the same for two consecutive values (one 16-byte / 8-byte store)
__device__ __forceinline__ void st_async2(unsigned a, double x, double y,
                                          unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b64 [%0], "
      "{%1, %2}, [%3];" ::"r"(a), "l"(__double_as_longlong(x)),
      "l"(__double_as_longlong(y)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async2(unsigned a, float x, float y,
                                          unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];" ::"r"(a), "r"(__float_as_uint(x)),
      "r"(__float_as_uint(y)), "r"(bar)
      : "memory");
}
// the arrival that opens an mbarrier phase expecting `bytes`
__device__ __forceinline__ void arm(unsigned bar, unsigned bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}"
      ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void wait_parity(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT_%=:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n\t"
      "@!done bra WAIT_%=;\n\t}"
      :: "r"(bar), "r"(parity) : "memory");
}

// One matrix per cluster of S CTAs (grid B S, cluster dims S).  The rows
// travel with their caterpillar slots, as in the n = 32 routine: after a
// round pair q's top row moves to pair q + 1 and its bottom row to pair
// q - 1 (pair 0 keeps its top and passes its bottom to pair 1's top; pair
// m - 1's top becomes its bottom).  A warp holds two consecutive pairs, so
// one of each pair's two moves stays in its registers; the other goes to
// the neighbour warp's inbox (double-buffered by round parity, one CTA
// barrier a round), and at a CTA's edge into the neighbour CTA's inbox
// through distributed shared memory by asynchronous stores (st.async) that
// count their bytes on the receiver's mbarrier, so the sender never waits
// for them: a CTA waits only for its two neighbours' rows, never for the
// whole cluster.  A pair's dot is one warp's: each lane's partial sum
// over its elements, then the butterfly.  The sweep's `off` and the first
// sweep's amax2 are cluster maxima (one cluster barrier a sweep).
template <typename T, int J, class Src>
__global__ void __launch_bounds__(cl_max_threads<T, J>(), 1)
    jacobi_cluster_kernel(Src in, T* __restrict__ XTo, T* __restrict__ XBo,
                          int* __restrict__ counts,
                          typename Src::Out* __restrict__ lam,
                          typename Src::Out* __restrict__ V, int n, int n0,
                          int S, int P, int ldi, int sweeps, T tol,
                          T null_rel, T eps) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[32];
  __shared__ T cmax[2];
  __shared__ __align__(8) unsigned long long bar[4];  // top 0/1, bottom 0/1
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / S, m = n / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int p0 = rank * P + 2 * warp, p1 = p0 + 1;
  const bool act = p0 < m, has1 = p1 < m;
  // inboxes: warp w's top inbox (rows arriving from the left) at
  // box + (4 w + buf) ldi, its bottom inbox at box + (4 w + 2 + buf) ldi
  T* box = reinterpret_cast<T*>(smem_raw);
  T* nall = box + (size_t)nwarps * 4 * ldi;
  auto top_in = [&](int w, int buf) { return box + (size_t)(4 * w + buf) * ldi; };
  auto bot_in = [&](int w, int buf) {
    return box + (size_t)(4 * w + 2 + buf) * ldi;
  };
  // where this warp's rows come from and go to (-1: nowhere / kept)
  const bool left_remote = warp == 0 && rank > 0;      // t0 from CTA rank-1
  const bool right_remote = warp == nwarps - 1 && rank < S - 1;
  const bool recv_top = act && p0 > 0;                  // t0 from p0 - 1
  const bool recv_bot = has1 && p1 < m - 1;             // b1 from p1 + 1
  const bool send_right = recv_bot;   // t1 to p1 + 1 (p1 + 1 < m)
  const bool send_left = recv_top;    // b0 to p0 - 1

  // lane l holds elements 2 l, 2 l + 1, 64 + 2 l, 64 + 2 l + 1, ... of a
  // row (J of them; pairs of consecutive values, so that a row moves in
  // 16-byte pieces); n is even, so a pair lies wholly inside or beyond it
  auto col = [&](int j) { return 64 * (j >> 1) + 2 * lane + (j & 1); };
  // a row and its norm from a neighbour CTA: (n + 1) values on bar[]
  const unsigned row_bytes = (unsigned)((n + 1) * sizeof(T));
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          smem_addr(&bar[i])));
      if (i < 2 ? rank > 0 : rank < S - 1) arm(smem_addr(&bar[i]), row_bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // this lane's part of row x (on lane 0 also its norm) into inbox d: plain
  // stores, or, where `peer` >= 0, asynchronous stores into the same inbox
  // of CTA peer that count their bytes on its mbarrier *pbar
  auto send = [&](const T* x, T nrm, T* d, int peer, unsigned long long* pbar) {
    if (peer < 0) {
#pragma unroll
      for (int j = 0; j < J; j += 2)
        if (col(j) < n)
          *reinterpret_cast<Pair<T>*>(d + col(j)) = Pair<T>{x[j], x[j + 1]};
      if (lane == 0) d[n] = nrm;
      return;
    }
    const unsigned base = mapa(smem_addr(d), peer);
    const unsigned rb = mapa(smem_addr(pbar), peer);
#pragma unroll
    for (int j = 0; j < J; j += 2)
      if (col(j) < n)
        st_async2(base + (unsigned)(col(j) * sizeof(T)), x[j], x[j + 1], rb);
    if (lane == 0) st_async(base + (unsigned)(n * sizeof(T)), nrm, rb);
  };

  T t0[J], b0[J], t1[J], b1[J];
  in.template fill_cluster<J>(t0, b0, t1, b1, col, b, n, p0, p1, rank, P,
                              smem_raw);
  // exact norms^2 of the four rows (zero-padded beyond n: adding 0 changes
  // no partial sum), lane-strided then the warp butterfly
  T na0, nb0, na1, nb1;
  auto refresh = [&]() {
    T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      s0 += t0[j] * t0[j];
      s1 += b0[j] * b0[j];
      s2 += t1[j] * t1[j];
      s3 += b1[j] * b1[j];
    }
    na0 = group_sum<32>(s0);
    nb0 = group_sum<32>(s1);
    na1 = group_sum<32>(s2);
    nb1 = group_sum<32>(s3);
  };
  int cm = 0;   // cluster maxima so far; slot cm & 1 is this one's
  auto cluster_max = [&](T v) {
    v = warp_max(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    v = warp_max(lane < nwarps ? red[lane] : T(0));
    if (threadIdx.x == 0) cmax[cm & 1] = v;
    cluster_barrier();
    T mx = T(0);
    for (int k = 0; k < S; ++k) {
      const T o = cluster.map_shared_rank(cmax, k)[cm & 1];
      mx = o > mx ? o : mx;
    }
    ++cm;
    return mx;
  };

  refresh();
  T mine = T(0);
  if (act) mine = na0 > nb0 ? na0 : nb0;
  if (has1) {
    mine = na1 > mine ? na1 : mine;
    mine = nb1 > mine ? nb1 : mine;
  }
  // (the cluster barrier in cluster_max also publishes the mbarriers'
  // initialization to the cluster before any remote arrival)
  const T amax2 = cluster_max(mine);
  const T gate = (null_rel * amax2) * (null_rel * amax2);
  T off = T(F32_MAX);
  int it = 0, gr = 0;   // gr: rounds so far
  while (tol > T(0) ? (it < sweeps && off > tol) : it < sweeps) {
    T off_w = T(0);
    for (int rnd = 0; rnd < n - 1; ++rnd, ++gr) {
      const int buf = (gr + 1) & 1;                 // the next round's
      if (act) {
        T s0 = T(0), s1 = T(0);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          s0 += t0[j] * b0[j];
          s1 += t1[j] * b1[j];
        }
        // the two dots in one transposed butterfly: after the first level
        // lanes 0-15 carry pair p0's sums, lanes 16-31 pair p1's (the same
        // additions, in the same order, as a butterfly on each); then each
        // half computes its pair's rotation (zeros where there is no p1: no
        // rotation, no `off`), and the warp shares them: half the shuffles
        // and half the rotation arithmetic a warp would issue
        const bool hi = lane & 16;
        T c = (hi ? s1 : s0) + __shfl_xor_sync(FULL, hi ? s0 : s1, 16);
        c = group_sum<16>(c);
        const Rot<T> r = rotation<T, true>(c, hi ? na1 : na0,
                                           hi ? nb1 : nb0, gate, eps, off_w);
        Rot<T> r0, r1;
        r0.cs = __shfl_sync(FULL, r.cs, 0);
        r0.sn = __shfl_sync(FULL, r.sn, 0);
        r0.csnc = __shfl_sync(FULL, r.csnc, 0);
        r1.cs = __shfl_sync(FULL, r.cs, 16);
        r1.sn = __shfl_sync(FULL, r.sn, 16);
        r1.csnc = __shfl_sync(FULL, r.csnc, 16);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const T x0 = t0[j], y0 = b0[j], x1 = t1[j], y1 = b1[j];
          t0[j] = r0.cs * x0 - r0.sn * y0;
          b0[j] = r0.sn * x0 + r0.cs * y0;
          t1[j] = r1.cs * x1 - r1.sn * y1;
          b1[j] = r1.sn * x1 + r1.cs * y1;
        }
        const T a0 = r0.cs * r0.cs * na0 - T(2) * r0.csnc + r0.sn * r0.sn * nb0;
        const T c0 = r0.sn * r0.sn * na0 + T(2) * r0.csnc + r0.cs * r0.cs * nb0;
        const T a1 = r1.cs * r1.cs * na1 - T(2) * r1.csnc + r1.sn * r1.sn * nb1;
        const T c1 = r1.sn * r1.sn * na1 + T(2) * r1.csnc + r1.cs * r1.cs * nb1;
        // out: t1 to the right (pair p1 + 1's top), b0 to the left (pair
        // p0 - 1's bottom)
        if (send_right)
          send(t1, a1, right_remote ? top_in(0, buf) : top_in(warp + 1, buf),
               right_remote ? rank + 1 : -1, &bar[buf]);
        if (send_left)
          send(b0, c0,
               left_remote ? bot_in(nwarps - 1, buf) : bot_in(warp - 1, buf),
               left_remote ? rank - 1 : -1, &bar[2 + buf]);
        // in registers: t1 <- t0 (b0 for pair 0), b0 <- b1, and at the
        // ring's end b1 <- t1 (pair m - 1) or b0 <- t0 (m - 1 = p0)
        if (has1) {
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const T ot0 = t0[j], ob0 = b0[j], ot1 = t1[j];
            t1[j] = p0 == 0 ? ob0 : ot0;
            b0[j] = b1[j];
            if (!recv_bot) b1[j] = ot1;
          }
          const T oa0 = a0;
          na1 = p0 == 0 ? c0 : oa0;
          nb0 = c1;
          if (!recv_bot) nb1 = a1;
          na0 = a0;            // pair 0 keeps its top
        } else {
#pragma unroll
          for (int j = 0; j < J; ++j) b0[j] = t0[j];
          nb0 = a0;
          na0 = a0;
        }
      }
      __syncthreads();
      // in: t0 from the left, b1 from the right (the next round's rows)
      if (recv_top) {
        if (left_remote) wait_parity(smem_addr(&bar[buf]), (gr >> 1) & 1);
        const T* s = top_in(warp, buf);
#pragma unroll
        for (int j = 0; j < J; j += 2) {
          const Pair<T> v = col(j) < n
                                ? *reinterpret_cast<const Pair<T>*>(s + col(j))
                                : Pair<T>{T(0), T(0)};
          t0[j] = v.x;
          t0[j + 1] = v.y;
        }
        na0 = s[n];
        if (left_remote && lane == 0) arm(smem_addr(&bar[buf]), row_bytes);
      }
      if (recv_bot) {
        if (right_remote)
          wait_parity(smem_addr(&bar[2 + buf]), (gr >> 1) & 1);
        const T* s = bot_in(warp, buf);
#pragma unroll
        for (int j = 0; j < J; j += 2) {
          const Pair<T> v = col(j) < n
                                ? *reinterpret_cast<const Pair<T>*>(s + col(j))
                                : Pair<T>{T(0), T(0)};
          b1[j] = v.x;
          b1[j + 1] = v.y;
        }
        nb1 = s[n];
        if (right_remote && lane == 0)
          arm(smem_addr(&bar[2 + buf]), row_bytes);
      }
    }
    ++it;
    refresh();
    off = cluster_max(off_w);
  }
  if (counts != nullptr && rank == 0 && threadIdx.x == 0) counts[b] = it;

  if (lam == nullptr) {
    // slot q holds row q again after whole sweeps
    if (act) {
      T* xt = XTo + ((size_t)b * m + p0) * n;
      T* xb = XBo + ((size_t)b * m + p0) * n;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = col(j);
        if (c < n) {
          xt[c] = t0[j];
          xb[c] = b0[j];
          if (has1) {
            xt[n + c] = t1[j];
            xb[n + c] = b1[j];
          }
        }
      }
    }
    cluster_barrier();   // no CTA exits while another may still read it
    return;
  }
  // the sorted eigenpairs: every CTA gathers all n norms (from each row's
  // CTA), ranks its own rows and writes their eigenvalues and V's columns
  const T l0 = sqrt(na0), l1 = sqrt(nb0), l2 = sqrt(na1), l3 = sqrt(nb1);
  if (act && lane == 0) {
    nall[2 * p0] = l0;
    nall[2 * p0 + 1] = l1;
    if (has1) {
      nall[2 * p1] = l2;
      nall[2 * p1 + 1] = l3;
    }
  }
  cluster_barrier();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int owner = (i / 2) / P;
    if (owner != rank) nall[i] = cluster.map_shared_rank(nall, owner)[i];
  }
  cluster_barrier();   // every remote read is done: CTAs may finish alone
  if (!act) return;
  // lane k < 4 ranks row 2 p0 + k
  int rk = 0;
  const int mine_row = 2 * p0 + (lane & 3);
  if (lane < 4 && mine_row < n) {
    const T li = nall[mine_row];
    const int me = cat_index(mine_row, m);
    for (int j = 0; j < n; ++j)
      rk += (nall[j] > li || (nall[j] == li && cat_index(j, m) < me)) ? 1
                                                                      : 0;
  }
  const size_t lb = (size_t)b * n0;
  typename Src::Out* Vb = V + lb * n0;
  auto write = [&](const T* x, int k, T li) {
    const int r = __shfl_sync(FULL, rk, k);
    if (2 * p0 + k >= n || r >= n0) return;
    if (lane == 0) lam[lb + r] = (typename Src::Out)li;
    const T den = li > T(1e-30) ? li : T(1e-30);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = col(j);
      if (c < n0) Vb[(size_t)c * n0 + r] = (typename Src::Out)(x[j] / den);
    }
  };
  write(t0, 0, l0);
  write(b0, 1, l1);
  if (has1) {
    write(t1, 2, l2);
    write(b1, 3, l3);
  }
}

template <typename T, int J, class Src>
int launch_cluster_j(const ClusterPlan& p, const Src& src, T* XT, T* XB,
                     int* counts, typename Src::Out* lam,
                     typename Src::Out* V, int B, int n, int n0,
                     int sweeps, T tol, T null_rel, T eps,
                     cudaStream_t stream) {
  auto kern = jacobi_cluster_kernel<T, J, Src>;
  const void* fn = reinterpret_cast<const void*>(kern);
  const size_t smem = std::max(p.smem, Src::cluster_stage(p.P, J));
  if (smem > slod::max_smem_optin() - slod::STATIC_SMEM_MARGIN)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = slod::opt_in_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  if (p.S > 8) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.S);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster of this size and shared memory that no GPC can hold would
  // never run: refuse it
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kern, src, XT, XB, counts, lam, V, n, n0,
                           p.S, p.P, p.ldi, sweeps, tol, null_rel, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, class Src>
int launch_cluster(const ClusterPlan& p, const Src& src, T* XT, T* XB,
                   int* counts, typename Src::Out* lam, typename Src::Out* V,
                   int B, int n, int n0, int sweeps, T tol, T null_rel, T eps,
                   cudaStream_t stream) {
  return p.J == 8
             ? launch_cluster_j<T, 8>(p, src, XT, XB, counts, lam, V, B, n,
                                      n0, sweeps, tol, null_rel, eps, stream)
             : launch_cluster_j<T, 12>(p, src, XT, XB, counts, lam, V, B, n,
                                       n0, sweeps, tol, null_rel, eps,
                                       stream);
}

template <typename T, class R, class Src>
int launch_rows(const Src& src, T* XT, T* XB, T* ws, int* counts,
                typename Src::Out* lam, typename Src::Out* V, int B, int n,
                int n0, int sweeps, T tol, T null_rel, T eps,
                cudaStream_t stream) {
  const size_t smem =
      stage_offset(rows_smem<T>(n, R::ld(n), ws != nullptr)) +
      Src::template rows_stage<R>();
  if (smem > slod::max_smem_optin() - slod::STATIC_SMEM_MARGIN)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = slod::opt_in_smem(
      reinterpret_cast<const void*>(jacobi_rows_kernel<T, R, Src>), smem);
  if (err != cudaSuccess) return (int)err;
  jacobi_rows_kernel<T, R, Src>
      <<<B, cta_threads(n / 2, R::LANES, R::MAX_THREADS), smem, stream>>>(
          src, XT, XB, ws, counts, lam, V, n, n0, sweeps, tol, null_rel, eps);
  return (int)cudaGetLastError();
}

template <typename T, class Src>
int launch_warp32(const Src& src, T* XT, T* XB, int* counts,
                  typename Src::Out* lam, typename Src::Out* V, int B, int n0,
                  int sweeps, T tol, T null_rel, T eps, cudaStream_t stream) {
  const size_t smem = Src::warp32_stage();
  if (smem > 0) {
    const cudaError_t err = slod::opt_in_smem(
        reinterpret_cast<const void*>(jacobi_rows_warp32<T, Src>), smem);
    if (err != cudaSuccess) return (int)err;
  }
  jacobi_rows_warp32<T, Src>
      <<<(B + WARP_MATS - 1) / WARP_MATS, WARP_MATS * 32, smem, stream>>>(
          src, XT, XB, counts, lam, V, B, n0, sweeps, tol, null_rel, eps);
  return (int)cudaGetLastError();
}

// The route of K5 and K8 at row length n, picked by n and T alone: n = 32
// the warp routine; n <= 128 RegRows; LoopRows while its rows fit one
// CTA's shared memory; then the cluster (cluster_plan); LoopRows on global
// rows beyond (a workspace of n * n per matrix).  ROUTE_NONE: no launch
// takes n.  The Python twin is ops/eig.py: k5_route.
enum Route {
  ROUTE_NONE = -1,
  ROUTE_WARP = 0,
  ROUTE_REG_ROWS = 1,
  ROUTE_LOOP_ROWS = 2,
  ROUTE_CLUSTER = 3,
  ROUTE_GLOBAL_ROWS = 4
};

template <typename T>
Route jacobi_route(int n) {
  if (n < 2 || n % 2) return ROUTE_NONE;
  if (n == 32) return ROUTE_WARP;
  if (n <= RegRows<T>::LD)
    return rows_ws_elems<T>(n, RegRows<T>::LD) == 0 ? ROUTE_REG_ROWS
                                                   : ROUTE_NONE;
  const long long ge = rows_ws_elems<T>(n, n);
  if (ge == 0) return ROUTE_LOOP_ROWS;
  if (ge < 0) return ROUTE_NONE;
  return cluster_plan<T>(n).S > 0 ? ROUTE_CLUSTER : ROUTE_GLOBAL_ROWS;
}

// Elements of global workspace per matrix at row length n: n * n on
// global rows, 0 on every other route, -1 where no launch takes n.
template <typename T>
long long route_ws_elems(int n) {
  const Route r = jacobi_route<T>(n);
  return r == ROUTE_NONE ? -1
         : r == ROUTE_GLOBAL_ROWS ? (long long)n * n
                                   : 0;
}

// The launch on n rows from src (lam / V null: the rows to XT / XB; else
// the n0 sorted eigenpairs to lam, V).
template <typename T, class Src>
int launch_route(const Src& src, T* XT, T* XB, T* ws, int* counts,
                 typename Src::Out* lam, typename Src::Out* V, int B, int n,
                 int n0, int sweeps, T tol, T null_rel, T eps,
                 cudaStream_t stream) {
  switch (jacobi_route<T>(n)) {
    case ROUTE_WARP:
      return launch_warp32<T>(src, XT, XB, counts, lam, V, B, n0, sweeps, tol,
                              null_rel, eps, stream);
    case ROUTE_REG_ROWS:
      return launch_rows<T, RegRows<T>>(src, XT, XB, nullptr, counts, lam, V,
                                        B, n, n0, sweeps, tol, null_rel, eps,
                                        stream);
    case ROUTE_LOOP_ROWS:
      return launch_rows<T, LoopRows<T>>(src, XT, XB, nullptr, counts, lam, V,
                                         B, n, n0, sweeps, tol, null_rel, eps,
                                         stream);
    case ROUTE_CLUSTER:
      return launch_cluster<T>(cluster_plan<T>(n), src, XT, XB, counts, lam,
                               V, B, n, n0, sweeps, tol, null_rel, eps,
                               stream);
    case ROUTE_GLOBAL_ROWS:
      if (ws == nullptr) return (int)cudaErrorInvalidValue;
      return launch_rows<T, LoopRows<T>>(src, XT, XB, ws, counts, lam, V, B,
                                         n, n0, sweeps, tol, null_rel, eps,
                                         stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K5: lam / V null: the rows to XT / XB; else the n0 sorted eigenpairs (n0
// is n, or n - 1 where the caller padded an odd n with a zero row) to lam,
// V.
template <typename T>
int launch_jacobi(void* G, void* XT, void* XB, void* ws, void* counts,
                  void* lam, void* V, int B, int n, int n0, int sweeps,
                  double tol, double null_rel, double eps, void* stream) {
  if (B <= 0 || n < 2 || n % 2) return (int)cudaErrorInvalidValue;
  if (lam != nullptr ? (V == nullptr || n0 < n - 1 || n0 > n)
                     : (XT == nullptr || XB == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_route<T>(RowsSrc<T>{(const T*)G}, (T*)XT, (T*)XB, (T*)ws,
                         (int*)counts, (T*)lam, (T*)V, B, n, n0, sweeps,
                         (T)tol, (T)null_rel, (T)eps, (cudaStream_t)stream);
}

// K8: W = ZT YT^T from ZT, YT (B, k, nf) of type In, built in the launch
// into the storage of K5's float64 route at k, then its sweeps in float64,
// then the sorted eigenpairs to lam (B, k), V (B, k, k) in type In; ws (on
// global rows only) holds float64 values.
template <typename In>
int launch_weig(void* ZT, void* YT, void* counts, void* lam, void* V,
                void* ws, int B, int k, int nf, int sweeps, double tol,
                double null_rel, double eps, void* stream) {
  if (B <= 0 || k < 2 || k % 2 || nf <= 0 || lam == nullptr || V == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_route<double>(
      FactorSrc<In>{(const In*)ZT, (const In*)YT, nf}, nullptr, nullptr,
      (double*)ws, (int*)counts, (In*)lam, (In*)V, B, k, k, sweeps, tol,
      null_rel, eps, (cudaStream_t)stream);
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
int slod_weig_f32(void* ZT, void* YT, void* counts, void* lam, void* V,
                  void* ws, int B, int k, int nf, int sweeps, double tol,
                  double null_rel, double eps, void* stream) {
  return launch_weig<float>(ZT, YT, counts, lam, V, ws, B, k, nf, sweeps, tol,
                            null_rel, eps, stream);
}
int slod_weig_f64(void* ZT, void* YT, void* counts, void* lam, void* V,
                  void* ws, int B, int k, int nf, int sweeps, double tol,
                  double null_rel, double eps, void* stream) {
  return launch_weig<double>(ZT, YT, counts, lam, V, ws, B, k, nf, sweeps,
                             tol, null_rel, eps, stream);
}
// workspace elements per matrix of K5 / K8 at row length n (0: the rows
// fit in shared memory or in a cluster's registers; -1: no launch can
// take n)
long long slod_jacobi_rows_ws_f32(int n) { return route_ws_elems<float>(n); }
long long slod_jacobi_rows_ws_f64(int n) { return route_ws_elems<double>(n); }
// K8 sweeps in float64 at either input type: its workspace (float64
// elements per matrix) and route (Route: -1 none, 0 warp, 1 RegRows, 2
// LoopRows, 3 cluster, 4 global rows) are K5's float64 ones at k
long long slod_weig_ws_f32(int k) { return route_ws_elems<double>(k); }
long long slod_weig_ws_f64(int k) { return route_ws_elems<double>(k); }
long long slod_weig_route_f32(int k) { return jacobi_route<double>(k); }
long long slod_weig_route_f64(int k) { return jacobi_route<double>(k); }
// the cluster size K5 / K8 take at row length n (0: not the cluster route)
long long slod_jacobi_rows_cluster_f32(int n) {
  return jacobi_route<float>(n) == ROUTE_CLUSTER ? cluster_plan<float>(n).S
                                                 : 0;
}
long long slod_jacobi_rows_cluster_f64(int n) {
  return jacobi_route<double>(n) == ROUTE_CLUSTER ? cluster_plan<double>(n).S
                                                  : 0;
}

}  // extern "C"
