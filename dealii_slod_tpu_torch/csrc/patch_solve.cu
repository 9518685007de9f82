// K1: fused block-LDL^T SPD multi-RHS solve with the triple product,
// K6: its solve-only instance, and
// K2: Gauss-Jordan sweep inverse of small SPD matrices.
//
// K1 replaces dealii_slod_tpu/ops/patch_solve.py: fused_spd_multirhs
// (algo="ldl": _fused_kernel_ldl_dma2 -> _fused_kernel_ldl).  Per patch p:
//   A = L D L^T (unit block-lower L, 64 x 64 diagonal blocks D_j),
//   X = A^-1 B in place of B,  T = z^T D^-1 z = B^T A^-1 B  (L z = B).
// K6 replaces dealii_slod_tpu/ops/patch_solve.py: spd_multirhs_solve_dma
// (_fused_kernel_ldl_dma_nt, col_blocked=True), the solve-only leaf of the
// recursive 2x2 Schur split (fused_spd_multirhs_split) of the 3D elasticity
// patch solve: X = A^-1 B, no T.  It is the same kernel without the triple
// product (the WITH_T template flag).
//
// What bounds it on the card: operations, n^3/3 FLOPs of the factor plus
// 2 n^2 k of the two substitutions per patch (n = 768, k = 128: 0.3 GFLOP;
// the elasticity leaves, k up to 1856: ~2.3 GFLOP), on a matrix of
// 2.25 MiB (n = 768) that does not fit one SM's 227 KB of shared memory,
// in a chunk of 128 patches whose 288 MiB do not fit the 50 MB L2.  So
// every product streams its operands from L2 / HBM while it computes, and
// every output is written once.  The design:
//
// * One CTA of 8 warps per patch, the factor in place on a scratch copy of
//   A.  Left-looking: block column j is produced by ONE accumulation over
//   all earlier panels, A'[r, j] = A[r, j] - sum_{i<j} L[r, i] U[i, j] for
//   all r >= j (K = 64 j, accumulators in registers, written once), where
//   U[i, j] = D_i L[j, i]^T = A'[j, i]^T is kept in the otherwise unused
//   upper block triangle of the scratch (written, transposed, by the same
//   epilogue).  So both operands of every long product are plain row-major
//   strips of the scratch, and nothing is read-modified-written per panel.
//   D_j is inverted by the Gauss-Jordan sweep with the block in registers
//   (gj_sweep_invert64) and L[r, j] = A'[r, j] D_j^-1 follows (K = 64).
// * Substitutions by block rows of 128: z_r = B_r - L[r, <r] z_{<r}
//   (K = 64 r) with a K = 64 correction inside the pair; backward with the
//   upper triangle, x_r = D_r^-1 (z_r - U[r, >r] x_{>r}), so the backward
//   operand is a row-major strip too and no transposed read of L is
//   needed.  K1's triple product is one product at the end of the forward
//   pass, T = z^T w with K = n and w_r = D_r^-1 z_r kept in the workspace.
//   The arithmetic is that of the right-looking block LDL^T this replaces;
//   only the order of summation differs (each output sums its panels in
//   one register accumulation instead of one rounding per panel).
// * Every product goes through one CTA-level routine (cta_gemm): operand
//   tiles of 32 (f32) or 16 (f64) k-steps move through a 4-stage ring in
//   dynamic shared memory, filled by 16-byte cp.async copies that are two
//   to three stages ahead of the multiply and are started in slices between
//   its k-steps; all tiles of one call run as one flat pipeline, so the
//   ring stays full across output tiles; the addend of an output tile is
//   prefetched into L2 when the tile starts and read in one batch ahead of
//   the stores.  CTA tiles are 256 x 64 (block columns) or 128 x 128
//   (substitutions, T), warp tiles 32 x 64.
// * The multiply is on the tensor cores: float32 as the 3xTF32 split
//   (a = a_hi + a_lo, three mma.sync.m16n8k8.tf32 products per step, the
//   low-order terms first, f32 accumulators; each 32-deep stage sums in a
//   fresh accumulator that is added to the running sum with a rounded f32
//   add, which keeps the tensor core's truncating accumulation short: on
//   random SPD blocks the X error is 1.3e-6 with it, 3.5e-6 without,
//   7e-4 with a single TF32 pass; the plain float32 Cholesky: 4e-7),
//   float64 as mma.sync.m8n8k4.f64 (DMMA, which rounds as a chain of FMAs
//   in the same order does).  Shared-memory strides are chosen so that the
//   fragment loads are bank-conflict free.
// What holds it back now (NVIDIA H100 80GB HBM3, 700 W, f32): a ring stage
// of 128 x 128 x 32 FMAs takes ~3600 cycles, of which the 384 mma.sync per
// scheduler are ~1350 (the two low-order passes cost ~890): with two warps
// per scheduler the fragment loads (24 per k-step and warp), the hi / lo
// split (72) and the 48 mma.sync wait on each other rather than overlap,
// and every stage ends in a CTA barrier.  Sixteen warps with 32 x 32 warp
// tiles were tried and were 7% slower (128 registers a thread: spills,
// and more fragment loads and splits per mma).  wgmma, which takes its
// operands from shared memory but wants TF32 operands K-major (the
// right-hand-side strips are not), is the next step.
// The global workspace per patch holds D_j^-1 (n x 64), one 128-row block
// of right-hand sides, and for K1 w (n x k): ldl_work_elems.  Not
// done: a thread-block cluster per patch for batches far below the SM
// count, and overlapping the 64-step sweep of D_j (~7% of K1 at n = 768)
// with the next block column's loads.
//
// K2 replaces dealii_slod_tpu/ops/patch_solve.py: gj_inverse_pallas
// (_gj_inverse_kernel -> _gj_invert_spd), the m-step sweep on (B, m, m)
// SPD matrices padded to m = 128 with the identity.  What bounds it: the
// 128-step dependency chain, not bytes (64 KB a matrix in f32) or FLOPs
// (2 m^3 = 4.2 MFLOP).  Design (that of gj_sweep_invert64 below, at
// m = 128): one CTA per matrix reads A (m0 <= 128, through its batch and
// row strides, so a pivot block of a larger matrix needs no copy) into
// registers as its identity extension to 128, keeps it there for all 128
// steps and writes the m0 x m0 inverse to a separate output; thread
// (ty, tx) holds the TM x TN tile at (TM ty, TN tx) (f32: 8 x 8 tiles,
// 256 threads; f64: 8 x 4, 512 threads).  Per step the owners publish the
// pivot row and column to double-buffered shared vectors, one CTA
// barrier, every thread applies the rank-1 update to its tile, and the
// owners overwrite the pivot row, column and element.  Each element goes
// through the sweep's arithmetic in the same order as in the plain
// version (the rank-1 update M - (col d) row, the row and column scaled
// by d, the pivot -d, the final negation).  What holds it back now
// (NVIDIA H100 80GB HBM3, 700 W): ~700 cycles a step, the chain barrier
// -> pivot load -> division -> 64 FMAs a thread -> the owners' stores ->
// barrier, with two warps a scheduler to hide it; a batch of 384 takes
// two waves (114 registers a thread: two CTAs an SM).

#include "common.cuh"

#include <cstdint>

namespace {

constexpr int NB = 64;            // panel width of the block LDL^T
constexpr int LDL_THREADS = 256;  // 8 warps per patch
constexpr int LDL_STAGES = 4;     // operand ring depth
constexpr int LOAD_SLICES = 4;    // a stage's loads, started between k-steps
constexpr int GJ_M = 128;         // K2 sweeps A extended to 128 x 128

template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T x, y;
};

// Tile geometry by element type: 16-byte chunks, 128-byte k-rows, and the
// row paddings that make the fragment loads conflict free (row-major
// [m][k] tiles: stride BK + 4; [k][n] tiles: stride = 8 (f32) or 4 (f64)
// modulo 32 four-byte banks / 16 eight-byte banks).
template <typename T>
struct Geo {
  static constexpr int CH = 16 / sizeof(T);
  static constexpr int BK = 128 / sizeof(T);
  static constexpr int PADA = 4;
  static constexpr int PADB = 32 / sizeof(T);
};

// CTA tile of WM x WN warps, each a 32 x 64 warp tile.
template <int WM_, int WN_>
struct Cfg {
  static constexpr int WM = WM_, WN = WN_;
  static constexpr int BM = 32 * WM_, BN = 64 * WN_;
  static_assert(WM_ * WN_ * 32 == LDL_THREADS, "8 warps");
};
using CfgCol = Cfg<8, 1>;  // 256 x 64: block columns of the factor
using CfgSq = Cfg<4, 2>;   // 128 x 128: substitutions and T

template <typename T, class C, bool TA>
struct StageGeo {
  using G = Geo<T>;
  // A tile: [BM][BK + PADA], or, transposed in global memory, [BK][BM + PADB]
  static constexpr int SA = TA ? C::BM + G::PADB : G::BK + G::PADA;
  static constexpr int SB = C::BN + G::PADB;
  static constexpr int A_ELEMS = TA ? G::BK * SA : C::BM * SA;
  static constexpr int ELEMS = A_ELEMS + G::BK * SB;
};

template <typename T>
constexpr size_t ldl_smem_bytes() {
  size_t a = StageGeo<T, CfgCol, false>::ELEMS;
  size_t b = StageGeo<T, CfgSq, false>::ELEMS;
  size_t c = StageGeo<T, CfgSq, true>::ELEMS;
  size_t m = a > b ? a : b;
  m = m > c ? m : c;
  size_t ring = m * LDL_STAGES, gj = (size_t)4 * NB;
  return (ring > gj ? ring : gj) * sizeof(T);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* gmem) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(gmem));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits, to nearest, ties
// away from zero: what cvt.rna.tf32.f32 gives for finite x, in two integer
// operations instead of the five the conversion compiles to), lo the
// exact remainder, whose low 13 bits the tensor core drops.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_f64(double* d, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// The multiply of one ring stage on a 32 x 64 warp tile at (wr, wc) of the
// CTA tile: acc (64 per thread) += A(32 x BK) B(BK x 64).  `pair` maps the
// pair of accumulators (2 ip, 2 ip + 1) to the (row, even column) of the
// warp tile they hold; both are neighbours in a row.
template <typename T>
struct WarpMath;

// float32 on the tensor cores, 3xTF32: 2 x 8 tiles of m16n8k8.
template <>
struct WarpMath<float> {
  template <bool TA, int SA, int SB, class F>
  static __device__ __forceinline__ void stage(float (&acc)[64],
                                               const float* As,
                                               const float* Bs, int wr,
                                               int wc, int lane, F&& slice) {
    constexpr int BK = Geo<float>::BK;
    static_assert(BK / 8 == LOAD_SLICES, "a load slice per k-step");
    const int g = lane >> 2, t = lane & 3;
    float tmp[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) tmp[i] = 0.f;
#pragma unroll
    for (int kb = 0; kb < BK; kb += 8) {
      slice(kb / 8);
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wr + mt * 16 + g;
        float x[4];
        if (!TA) {
          x[0] = As[r * SA + kb + t];
          x[1] = As[(r + 8) * SA + kb + t];
          x[2] = As[r * SA + kb + t + 4];
          x[3] = As[(r + 8) * SA + kb + t + 4];
        } else {
          x[0] = As[(kb + t) * SA + r];
          x[1] = As[(kb + t) * SA + r + 8];
          x[2] = As[(kb + t + 4) * SA + r];
          x[3] = As[(kb + t + 4) * SA + r + 8];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(x[q], ah[mt][q], al[mt][q]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = wc + nt * 8 + g;
        uint32_t bh[2], bl[2];
        split_tf32(Bs[(kb + t) * SB + c], bh[0], bl[0]);
        split_tf32(Bs[(kb + t + 4) * SB + c], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float* d = tmp + (mt * 8 + nt) * 4;
          mma_tf32(d, al[mt], bh);
          mma_tf32(d, ah[mt], bl);
          mma_tf32(d, ah[mt], bh);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += tmp[i];
  }
  static __device__ __forceinline__ void pair(int ip, int lane, int& row,
                                              int& col) {
    const int g = lane >> 2, t = lane & 3;
    const int h = ip & 1, nt = (ip >> 1) & 7, mt = ip >> 4;
    row = mt * 16 + g + 8 * h;
    col = nt * 8 + 2 * t;
  }
};

// float64 on the tensor cores (DMMA): 4 x 8 tiles of m8n8k4.
template <>
struct WarpMath<double> {
  template <bool TA, int SA, int SB, class F>
  static __device__ __forceinline__ void stage(double (&acc)[64],
                                               const double* As,
                                               const double* Bs, int wr,
                                               int wc, int lane, F&& slice) {
    constexpr int BK = Geo<double>::BK;
    static_assert(BK / 4 == LOAD_SLICES, "a load slice per k-step");
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kb = 0; kb < BK; kb += 4) {
      slice(kb / 4);
      double a[4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wr + mt * 8 + g;
        a[mt] = TA ? As[(kb + t) * SA + r] : As[r * SA + kb + t];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const double b = Bs[(kb + t) * SB + wc + nt * 8 + g];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          mma_f64(acc + (mt * 8 + nt) * 2, a[mt], b);
      }
    }
  }
  static __device__ __forceinline__ void pair(int ip, int lane, int& row,
                                              int& col) {
    const int g = lane >> 2, t = lane & 3;
    row = (ip >> 3) * 8 + g;
    col = (ip & 7) * 8 + 2 * t;
  }
};

// Slice `sl` of LOAD_SLICES of the copies that fill one ring stage with the
// operand tiles of output tile (m0, n0) at depth k0 (the multiply starts a
// slice between its k-steps, so the copies are spread among the
// tensor-core operations instead of preceding them).  Rows of A beyond M
// and columns of B beyond N are not loaded (the warps that would use them
// do no work).
template <typename T, class C, bool TA>
__device__ __forceinline__ void load_stage(int sl, T* st, const T* A,
                                           int lda, const T* B, int ldb,
                                           int m0, int n0, int k0, int M,
                                           int N) {
  using G = Geo<T>;
  using S = StageGeo<T, C, TA>;
  constexpr int CPRA = (TA ? C::BM : G::BK) / G::CH;   // chunks per row
  constexpr int CPRB = C::BN / G::CH;
  constexpr int NA = (TA ? G::BK : C::BM) * CPRA / LDL_THREADS;
  constexpr int NBI = G::BK * CPRB / LDL_THREADS;
  static_assert((TA ? G::BK : C::BM) * CPRA % LDL_THREADS == 0 &&
                    G::BK * CPRB % LDL_THREADS == 0,
                "whole rounds of the CTA");
  T* As = st;
  T* Bs = st + S::A_ELEMS;
  const int lo = sl * (NA + NBI) / LOAD_SLICES;
  const int hi = (sl + 1) * (NA + NBI) / LOAD_SLICES;
#pragma unroll
  for (int it = lo; it < hi; ++it) {
    if (it < NA) {
      const int e = threadIdx.x + it * LDL_THREADS;
      const int r = e / CPRA, c = (e % CPRA) * G::CH;
      if (!TA) {
        if (m0 + r < M)
          cp_async16(As + r * S::SA + c,
                     A + (size_t)(m0 + r) * lda + k0 + c);
      } else {
        if (m0 + c < M)
          cp_async16(As + r * S::SA + c,
                     A + (size_t)(k0 + r) * lda + m0 + c);
      }
    } else {
      const int e = threadIdx.x + (it - NA) * LDL_THREADS;
      const int kk = e / CPRB, c = (e % CPRB) * G::CH;
      if (n0 + c < N)
        cp_async16(Bs + kk * S::SB + c,
                   B + (size_t)(k0 + kk) * ldb + n0 + c);
    }
  }
}

// C (M x N, ld ldc) = (C0 ? C0 : 0) + sgn * op(A) (M x K) @ B (K x N) by
// the whole CTA; op(A)[m, k] = TA ? A[k * lda + m] : A[m * lda + k],
// B[k, n] = B[k * ldb + n].  M, N and K are multiples of 64, K > 0.  Where
// Ct is given, the result's rows m >= ct_from are also written transposed,
// Ct[n * ldct + m].  C may alias C0, and A or B where every k-step of an
// output tile is loaded before the tile is stored and other tiles' stores
// touch other rows / columns (K <= ring depth times BK, or disjoint).
// Ends with a CTA barrier: the stores are visible to the next call.
template <typename T, class C, bool TA>
__device__ __noinline__ void cta_gemm(T* Cp, int ldc, const T* C0, int ldc0,
                                      const T* A, int lda, const T* B,
                                      int ldb, int M, int N, int K, T sgn,
                                      T* Ct, int ldct, int ct_from) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  using G = Geo<T>;
  using S = StageGeo<T, C, TA>;
  using W = WarpMath<T>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int tilesN = (N + C::BN - 1) / C::BN;
  const int tilesM = (M + C::BM - 1) / C::BM;
  const int KT = K / G::BK;
  const int total = tilesM * tilesN * KT;

  int ls = 0, lkt = 0, ltm = 0, ltn = 0;   // the loads' position
  auto advance_loads = [&]() {
    if (++lkt == KT) {
      lkt = 0;
      if (++ltn == tilesN) {
        ltn = 0;
        ++ltm;
      }
    }
    ++ls;
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < LDL_STAGES - 1; ++i) {
    if (ls < total) {
#pragma unroll
      for (int q = 0; q < LOAD_SLICES; ++q)
        load_stage<T, C, TA>(q, sm + (ls % LDL_STAGES) * S::ELEMS, A, lda, B,
                             ldb, ltm * C::BM, ltn * C::BN, lkt * G::BK, M,
                             N);
    }
    advance_loads();
  }

  T acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = T(0);
  int kt = 0, tm = 0, tn = 0;              // the multiply's position
  for (int s = 0; s < total; ++s) {
    cp_async_wait<LDL_STAGES - 2>();
    __syncthreads();
    // the stage read in the last round is free: refill it during this one
    const bool more = ls < total;
    T* lst = sm + (ls % LDL_STAGES) * S::ELEMS;
    const int lm0 = ltm * C::BM, ln0 = ltn * C::BN, lk0 = lkt * G::BK;
    auto slice = [&](int q) {
      if (more)
        load_stage<T, C, TA>(q, lst, A, lda, B, ldb, lm0, ln0, lk0, M, N);
    };
    const int mw = tm * C::BM + wm * 32, nw = tn * C::BN + wn * 64;
    const bool active = mw < M && nw < N;
    if (active && kt == 0 && C0 != nullptr) {
      // the epilogue's addend: ask L2 for it while the tile accumulates
#pragma unroll
      for (int ip = 0; ip < 32; ++ip) {
        int r, c;
        W::pair(ip, lane, r, c);
        prefetch_l2(C0 + (size_t)(mw + r) * ldc0 + nw + c);
      }
    }
    if (active) {
      const T* st = sm + (s % LDL_STAGES) * S::ELEMS;
      W::template stage<TA, S::SA, S::SB>(acc, st, st + S::A_ELEMS, wm * 32,
                                          wn * 64, lane, slice);
    } else {
#pragma unroll
      for (int q = 0; q < LOAD_SLICES; ++q) slice(q);
    }
    advance_loads();
    if (++kt == KT) {
      if (active) {
        // C0 is read in batches ahead of the stores (C may alias C0, so
        // the compiler would otherwise order each load after a store)
        constexpr int EB = 64 / sizeof(T);
#pragma unroll
        for (int ib = 0; ib < 32; ib += EB) {
          Pair<T> q[EB];
#pragma unroll
          for (int u = 0; u < EB; ++u) {
            int r, c;
            W::pair(ib + u, lane, r, c);
            if (C0 != nullptr)
              q[u] = *reinterpret_cast<const Pair<T>*>(
                  C0 + (size_t)(mw + r) * ldc0 + nw + c);
            else
              q[u].x = q[u].y = T(0);
          }
#pragma unroll
          for (int u = 0; u < EB; ++u) {
            int r, c;
            W::pair(ib + u, lane, r, c);
            const int m = mw + r, nn = nw + c;
            Pair<T> o;
            o.x = q[u].x + sgn * acc[2 * (ib + u)];
            o.y = q[u].y + sgn * acc[2 * (ib + u) + 1];
            *reinterpret_cast<Pair<T>*>(Cp + (size_t)m * ldc + nn) = o;
            if (Ct != nullptr && m >= ct_from) {
              Ct[(size_t)nn * ldct + m] = o.x;
              Ct[(size_t)(nn + 1) * ldct + m] = o.y;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = T(0);
      kt = 0;
      if (++tn == tilesN) {
        tn = 0;
        ++tm;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Unpivoted Gauss-Jordan sweep inverse of one SPD 64 x 64 block (the
// arithmetic of gj_inverse_plain, step for step) by the CTA's 256
// threads: thread (ty, tx) of a 16 x 16 grid keeps the 4 x 4 block at
// (4 ty, 4 tx) in registers for all 64 steps.  Per step the owners publish
// the pivot row and column in shared memory (`rc`, 4 x 64, double
// buffered: one barrier per step), every thread applies the rank-1 update
// to its whole block, and the owners then overwrite the pivot row, column
// and element; the four steps of one owner are unrolled, so every register
// index is static.  D (ld ldd, global) -> Dout (ld 64, global).
template <typename T>
__device__ void gj_sweep_invert64(const T* D, int ldd, T* Dout, T* rc) {
  static_assert(NB == 64 && LDL_THREADS == 256, "a 16 x 16 grid of 4 x 4");
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  T m[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      m[i][j] = D[(size_t)(4 * ty + i) * ldd + 4 * tx + j];
  for (int kb = 0; kb < NB / 4; ++kb) {
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      const int kp = 4 * kb + kq;
      T* row = rc + (kp & 1) * 2 * NB;
      T* col = row + NB;
      if (ty == kb) {
#pragma unroll
        for (int j = 0; j < 4; ++j) row[4 * tx + j] = m[kq][j];
      }
      if (tx == kb) {
#pragma unroll
        for (int i = 0; i < 4; ++i) col[4 * ty + i] = m[i][kq];
      }
      __syncthreads();
      const T d = T(1) / row[kp];
      T r[4], c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = row[4 * tx + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] = col[4 * ty + i] * d;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) m[i][j] -= c[i] * r[j];
      if (ty == kb) {
#pragma unroll
        for (int j = 0; j < 4; ++j) m[kq][j] = r[j] * d;
      }
      if (tx == kb) {
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i][kq] = c[i];
      }
      if (ty == kb && tx == kb) m[kq][kq] = -d;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Dout[(4 * ty + i) * NB + 4 * tx + j] = -m[i][j];
  __syncthreads();
}

// Global workspace elements per patch: D_j^-1 (n x NB), one 2 NB-row block
// of right-hand sides, and with the triple product w (n x k).
__host__ __device__ inline size_t ldl_work_elems(int n, int k, bool with_t) {
  return (size_t)n * NB + (size_t)2 * NB * k + (with_t ? (size_t)n * k : 0);
}

// One CTA per patch.  A (P, n, n) scratch, factored in place (lower block
// triangle L, upper block triangle U = (L D)^T, diagonal blocks D_j; only
// the lower block triangle of the input is read); X (P, n, k) holds B on
// entry and X = A^-1 B on exit; Tout (P, k, k), written only WITH_T (K1;
// K6 passes none); work (P, ldl_work_elems).  n % NB == 0, k % NB == 0.
template <typename T, bool WITH_T>
__global__ void __launch_bounds__(LDL_THREADS, 1)
    fused_ldl_kernel(T* A, T* X, T* Tout, T* work, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const size_t p = blockIdx.x;
  T* Ap = A + p * n * n;
  T* Xp = X + p * n * k;
  T* Dinv = work + p * ldl_work_elems(n, k, WITH_T);  // n x NB
  T* tmp = Dinv + (size_t)n * NB;                      // 2 NB x k
  T* Wp = tmp + (size_t)2 * NB * k;                    // n x k (WITH_T)
  const T one = T(1), neg = T(-1);
  constexpr T* none = nullptr;

  // ---- factor, one block column at a time
  for (int j0 = 0; j0 < n; j0 += NB) {
    const int j1 = j0 + NB;
    T* Ajj = Ap + (size_t)j0 * n + j0;
    if (j0 == 0) {
      // U[0, r] = A[r, 0]^T
      for (int e = tid; e < (n - NB) * NB; e += LDL_THREADS) {
        const int m = NB + e / NB, c = e % NB;
        Ap[(size_t)c * n + m] = Ap[(size_t)m * n + c];
      }
    } else {
      // A'[r, j] = A[r, j] - L[r, <j] U[<j, j] for r >= j; U[j, r] = A'^T
      cta_gemm<T, CfgCol, false>(Ajj, n, Ajj, n, Ap + (size_t)j0 * n,
                                       n, Ap + j0, n, n - j0, NB, j0, neg,
                                       Ajj, n, NB);
    }
    // D_j^-1 by the sweep, in registers
    T* Dj = Dinv + (size_t)j0 * NB;
    gj_sweep_invert64(Ajj, n, Dj, sm);
    // L[r, j] = A'[r, j] D_j^-1 for r > j, in place
    if (j1 < n) {
      T* Lj = Ap + (size_t)j1 * n + j0;
      cta_gemm<T, CfgCol, false>(Lj, n, none, 0, Lj, n, Dj, NB,
                                       n - j1, NB, NB, one, none, 0, 0);
    }
  }

  // ---- forward by block rows of 2 NB: z in place of B (and w = D^-1 z)
  for (int r0 = 0; r0 < n; r0 += 2 * NB) {
    const int Mr = (n - r0 < 2 * NB) ? NB : 2 * NB;
    T* Xr = Xp + (size_t)r0 * k;
    if (r0 > 0)
      cta_gemm<T, CfgSq, false>(Xr, k, Xr, k, Ap + (size_t)r0 * n, n,
                                      Xp, k, Mr, k, r0, neg, none, 0, 0);
    if (Mr == 2 * NB)
      cta_gemm<T, CfgSq, false>(
          Xr + (size_t)NB * k, k, Xr + (size_t)NB * k, k,
          Ap + (size_t)(r0 + NB) * n + r0, n, Xr, k, NB, k, NB, neg, none, 0,
          0);
    if constexpr (WITH_T) {
      for (int b = 0; b < Mr; b += NB)
        cta_gemm<T, CfgSq, false>(
            Wp + (size_t)(r0 + b) * k, k, none, 0,
            Dinv + (size_t)(r0 + b) * NB, NB, Xr + (size_t)b * k, k, NB, k,
            NB, one, none, 0, 0);
    }
  }
  // ---- T = z^T w
  if constexpr (WITH_T) {
    cta_gemm<T, CfgSq, true>(Tout + p * k * k, k, none, 0, Xp, k, Wp,
                                   k, k, k, n, one, none, 0, 0);
  }
  // ---- backward by block rows of 2 NB: x_r = D_r^-1 (z_r - U[r, >r] x_>r)
  for (int hi = n; hi > 0;) {
    const int Mr = (hi < 2 * NB) ? NB : 2 * NB;
    const int r0 = hi - Mr;
    T* Xr = Xp + (size_t)r0 * k;
    const T* src = Xr;
    if (hi < n) {
      cta_gemm<T, CfgSq, false>(tmp, k, Xr, k,
                                      Ap + (size_t)r0 * n + hi, n,
                                      Xp + (size_t)hi * k, k, Mr, k, n - hi,
                                      neg, none, 0, 0);
      src = tmp;
    }
    if (Mr == 2 * NB) {
      T* Xs = Xr + (size_t)NB * k;      // the pair's second block row
      cta_gemm<T, CfgSq, false>(Xs, k, none, 0,
                                      Dinv + (size_t)(r0 + NB) * NB, NB,
                                      src + (size_t)NB * k, k, NB, k, NB,
                                      one, none, 0, 0);
      cta_gemm<T, CfgSq, false>(tmp, k, src, k,
                                      Ap + (size_t)r0 * n + r0 + NB, n, Xs,
                                      k, NB, k, NB, neg, none, 0, 0);
      src = tmp;
    }
    cta_gemm<T, CfgSq, false>(Xr, k, none, 0,
                                    Dinv + (size_t)r0 * NB, NB, src, k, NB,
                                    k, NB, one, none, 0, 0);
    hi = r0;
  }
}

template <typename T, bool WITH_T>
int launch_fused(void* A, void* X, void* Tm, void* work, int P, int n, int k,
                 void* stream) {
  if (n % NB || k % NB || P <= 0 || n <= 0 || k <= 0)
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = ldl_smem_bytes<T>();
  const cudaError_t err = slod::opt_in_smem(
      reinterpret_cast<const void*>(fused_ldl_kernel<T, WITH_T>), smem);
  if (err != cudaSuccess) return (int)err;
  fused_ldl_kernel<T, WITH_T><<<P, LDL_THREADS, smem, (cudaStream_t)stream>>>(
      (T*)A, (T*)X, (T*)Tm, (T*)work, n, k);
  return (int)cudaGetLastError();
}

// COUNT elements between registers and 16-byte aligned shared memory
template <typename T, int COUNT>
__device__ __forceinline__ void load16(T* dst, const T* src) {
  constexpr int W = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < COUNT / W; ++u) {
    const slod::Vec16<T> q = reinterpret_cast<const slod::Vec16<T>*>(src)[u];
#pragma unroll
    for (int e = 0; e < W; ++e) dst[u * W + e] = q.v[e];
  }
}
template <typename T, int COUNT>
__device__ __forceinline__ void store16(T* dst, const T* src) {
  constexpr int W = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < COUNT / W; ++u) {
    slod::Vec16<T> q;
#pragma unroll
    for (int e = 0; e < W; ++e) q.v[e] = src[u * W + e];
    reinterpret_cast<slod::Vec16<T>*>(dst)[u] = q;
  }
}

// One CTA per matrix: A (batch stride sA, row stride ldA, m0 <= 128) ->
// Out (B, m0, m0) = A^-1.  The matrix sits in registers as a 128 x 128
// identity extension of A, (128 / TM) x (128 / TN) tiles of TM x TN; the
// L steps of one owner block are unrolled, so every register index is
// static.  The extension keeps the padded coordinates decoupled, so the
// leading block comes out exactly as an m0-step sweep would leave it.
template <typename T, int TM, int TN>
__global__ void __launch_bounds__((GJ_M / TM) * (GJ_M / TN))
    gj_inverse_kernel(const T* __restrict__ A, T* __restrict__ Out, int m0,
                      long long sA, int ldA) {
  constexpr int GN = GJ_M / TN;
  constexpr int L = TM > TN ? TM : TN;
  __shared__ __align__(16) T rc[2][2][GJ_M];   // [step parity][row, col]
  const int ty = threadIdx.x / GN, tx = threadIdx.x % GN;
  const T* Ap = A + (size_t)blockIdx.x * sA;
  T m[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = TM * ty + i, c = TN * tx + j;
      m[i][j] = (r < m0 && c < m0) ? Ap[(size_t)r * ldA + c]
                                   : T(r == c ? 1 : 0);
    }
  for (int kb = 0; kb < GJ_M / L; ++kb) {
#pragma unroll
    for (int kq = 0; kq < L; ++kq) {
      const int kp = kb * L + kq;
      const int ri = kq % TM, cj = kq % TN;
      const bool row_owner = ty == kp / TM, col_owner = tx == kp / TN;
      T* row = rc[kq & 1][0];
      T* col = rc[kq & 1][1];
      if (row_owner) store16<T, TN>(row + TN * tx, m[ri]);
      if (col_owner) {
        T cv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) cv[i] = m[i][cj];
        store16<T, TM>(col + TM * ty, cv);
      }
      __syncthreads();
      const T d = T(1) / row[kp];
      T r[TN], c[TM];
      load16<T, TN>(r, row + TN * tx);
      load16<T, TM>(c, col + TM * ty);
#pragma unroll
      for (int i = 0; i < TM; ++i) c[i] *= d;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) m[i][j] -= c[i] * r[j];
      if (row_owner) {
#pragma unroll
        for (int j = 0; j < TN; ++j) m[ri][j] = r[j] * d;
      }
      if (col_owner) {
#pragma unroll
        for (int i = 0; i < TM; ++i) m[i][cj] = c[i];
      }
      if (row_owner && col_owner) m[ri][cj] = -d;
    }
  }
  T* Op = Out + (size_t)blockIdx.x * m0 * m0;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = TM * ty + i, c = TN * tx + j;
      if (r < m0 && c < m0) Op[(size_t)r * m0 + c] = -m[i][j];
    }
}

// The tile of one thread: 8 x 8 in f32 (256 threads), 8 x 4 in f64 (512).
template <typename T>
struct GjTile {
  static constexpr int TM = 8, TN = sizeof(T) == 4 ? 8 : 4;
};

// No dynamic shared memory (the 2 KB / 4 KB pivot vectors are static), so
// no opt-in to set.
template <typename T>
int launch_gj(void* A, void* Out, int B, int m0, long long sA, int ldA,
              void* stream) {
  if (B <= 0 || m0 <= 0 || m0 > GJ_M || ldA < m0 || sA < (long long)m0 * ldA)
    return (int)cudaErrorInvalidValue;
  constexpr int TM = GjTile<T>::TM, TN = GjTile<T>::TN;
  gj_inverse_kernel<T, TM, TN>
      <<<B, (GJ_M / TM) * (GJ_M / TN), 0, (cudaStream_t)stream>>>(
          (const T*)A, (T*)Out, m0, sA, ldA);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slod_fused_spd_multirhs_f32(void* A, void* X, void* T, void* work, int P,
                                int n, int k, void* stream) {
  return launch_fused<float, true>(A, X, T, work, P, n, k, stream);
}
int slod_fused_spd_multirhs_f64(void* A, void* X, void* T, void* work, int P,
                                int n, int k, void* stream) {
  return launch_fused<double, true>(A, X, T, work, P, n, k, stream);
}
int slod_spd_multirhs_solve_f32(void* A, void* X, void* work, int P, int n,
                                int k, void* stream) {
  return launch_fused<float, false>(A, X, nullptr, work, P, n, k, stream);
}
int slod_spd_multirhs_solve_f64(void* A, void* X, void* work, int P, int n,
                                int k, void* stream) {
  return launch_fused<double, false>(A, X, nullptr, work, P, n, k, stream);
}
// Global workspace elements per patch that a launch at (n, k) takes.
long long slod_fused_spd_multirhs_ws_f32(int n, int k) {
  return (long long)ldl_work_elems(n, k, true);
}
long long slod_fused_spd_multirhs_ws_f64(int n, int k) {
  return (long long)ldl_work_elems(n, k, true);
}
long long slod_spd_multirhs_solve_ws_f32(int n, int k) {
  return (long long)ldl_work_elems(n, k, false);
}
long long slod_spd_multirhs_solve_ws_f64(int n, int k) {
  return (long long)ldl_work_elems(n, k, false);
}
int slod_gj_inverse_f32(void* A, void* Out, int B, int m0, long long sA,
                        int ldA, void* stream) {
  return launch_gj<float>(A, Out, B, m0, sA, ldA, stream);
}
int slod_gj_inverse_f64(void* A, void* Out, int B, int m0, long long sA,
                        int ldA, void* stream) {
  return launch_gj<double>(A, Out, B, m0, sA, ldA, stream);
}

}  // extern "C"
