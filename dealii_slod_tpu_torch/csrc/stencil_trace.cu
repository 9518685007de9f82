// K3 (C = 1) and K7 (C = 2, 3): the banded stencil trace product of
// C-component patches,
//   S[b, c, n, j] = sum_o sum_d band[b, n, o*C*C + c*C + d]
//                              * Xp[b, d, n + off_o, j],
// o over the 3^dim nodal-stencil offsets (off_o already includes the
// zero-padding shift of the node axis), C a template parameter.
//
// What it replaces (dealii_slod_tpu/ops/assembly.py: stencil_trace_pallas):
// K3 the C = 1 kernel of impl="c1"/"c1roll" (_stencil_trace_c1, its
// pallas_call at line 409); K7 the C > 1 kernels, impl="unroll"/
// "unrollslice" (_stencil_trace_unroll, pallas_call at 481, which the 3D
// elasticity chunk runs) and the offset-grid kernel of impl="slice"/"roll"
// (pallas_call at 584).  One contract, one kernel template over C.  The
// TPU kernels keep a patch's whole (nNp, kt) X block in VMEM and add 3^dim
// statically shifted slices of it; their rotate / slice tricks and the
// offset grid axis have no counterpart here.
//
// What bounds it on the card.  At the diffusion chunk (B = 128, nN = 1331,
// k = 125, 27 offsets) bytes: band + X + S once is 0.2 GB, 0.06 ms at
// 3.35 TB/s, against 1.2 GFLOP.  At the 3D elasticity chunk (C = 3,
// k = 375) both: 1.85 GB (0.55 ms) and 31 GFLOP (0.46 ms at 67 TFLOP/s of
// f32 FMA), so once X is read few times the limits are the FMA rate and
// the shared-memory loads that feed it.  A thread per output that reads its
// 3^dim C shifted X rows from global memory fetches every X row 27 (C = 1)
// or 81 (C = 3) times through L2 and re-reads its band row per column.
//
// The design (trace_tiled).  One CTA per (patch b, tile of TN consecutive
// flat nodes, tile of KT = 32 J columns), the column tiles of one (b, node
// tile) adjacent in launch order so the band comes from HBM about once.
// The offsets come in dx-triples (off, off + 1, off + 2); triples whose
// rows lie within GROUP_SPAN of each other form a group (on the 11^3
// canvas: the three dz planes, each spanning 24 rows), and each (group,
// component d) is one stage: the TN + span X rows of component d that the
// group's offsets reach from the tile, and with d = 0 the tile's band
// values of the group, two stages in shared memory, one in flight while
// the other is read.  X rows of 125 / 375 f32 start on 4-byte boundaries
// only, so a row is staged by one bulk copy (the TMA unit, completing on
// an mbarrier) of the 16-byte-aligned span around its KT columns, its
// misalignment recomputed where it is read: no padding copy of X, and no
// per-element copy instructions (4-byte cp.async, the first version, left
// the copies as slow as the FMAs).  A lane owns J columns (lane + 32 jj:
// conflict-free rows), a warp R consecutive nodes; per triple a thread
// loads an (R + 2)-row window of X per column once and uses each value for
// up to 3 dx neighbours and all C outputs, and each band value (a
// warp-uniform, broadcast load, the C values of one (node, offset, d) as
// one vector) for its J columns: per triple and stage R + 2 X loads per
// column and 3 R band loads feed 3 R J C FMAs.  S is written once, with
// streaming stores.  Per output the terms sum in (group, d, offset) order.
// What bounds it now: neither the FMAs nor the copies alone; on the H100,
// f32, each alone takes half or more of the kernel's time
// (scripts/trace_bench.py), and more CTAs per SM overlap them better than
// a deeper ring.
// For k below TILE_MIN_K (the A phi calls, k = C) a column tile would idle
// most of its lanes: trace_per_output keeps one thread per output (b, n,
// j) computing its C outputs, each X load used for every c.

#include "common.cuh"

namespace {

constexpr int MAX_OFFS = 27;
constexpr int MAX_TRIPLES = MAX_OFFS / 3;
constexpr int THREADS = 256;        // trace_per_output's block
constexpr int TILE_MIN_K = 16;      // below: trace_per_output
constexpr int GROUP_SPAN = 32;      // rows one staged window may add

struct Offsets {
  int v[MAX_OFFS];
};

// Runs of consecutive dx-triples sharing one staged X window: group g holds
// triples first[g] .. first[g + 1] - 1, its offsets lie in
// [lo[g], lo[g] + span[g]].
struct Groups {
  int n;
  int first[MAX_TRIPLES + 1];
  int lo[MAX_TRIPLES];
  int span[MAX_TRIPLES];
};

// R nodes per warp, J columns per lane, WARPS warps: TN = WARPS R nodes and
// KT = 32 J columns per CTA; MIN_BLOCKS CTAs per SM asked of the compiler.
// Chosen on the H100 at the diffusion (C = 1) and elasticity (C = 3)
// chunks, f32, among variants that scripts/trace_bench.py builds.
template <typename T, int C>
struct Tile {
  static constexpr int R = C == 1 ? 8 : 6, J = sizeof(T) == 4 ? 4 : 2;
  static constexpr int WARPS = C == 1 ? 8 : 4, MIN_BLOCKS = C == 1 ? 1 : 3;
};

// stages in shared memory: one read while the next is copied (a third
// in flight was slower)
constexpr int NBUF = 2;

// shared-memory pitch of the C band values of one (node, offset, d)
template <int C>
constexpr int BAND_PITCH = C == 3 ? 4 : C;

template <typename T>
__device__ __forceinline__ void cp_async_zfill(T* smem, const T* gmem,
                                               bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(gmem), "n"((int)sizeof(T)),
               "r"(valid ? (int)sizeof(T) : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// the one arrival of a phase, announcing the bytes its copies bring
__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// one bulk copy (the TMA unit) of `bytes` (a multiple of 16) from 16-byte
// aligned global memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the C band values at p (16-byte aligned where C = 3)
template <typename T, int C>
__device__ __forceinline__ void load_band(const T* p, T (&v)[C]) {
  if constexpr (C == 3) {
    const slod::Vec16<T> a = *reinterpret_cast<const slod::Vec16<T>*>(p);
    if constexpr (sizeof(T) == 4) {
      v[0] = a.v[0], v[1] = a.v[1], v[2] = a.v[2];
    } else {
      v[0] = a.v[0], v[1] = a.v[1], v[2] = p[2];
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = p[c];
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(Tile<T, C>::WARPS * 32,
                                  Tile<T, C>::MIN_BLOCKS)
    trace_tiled(const T* __restrict__ band, const T* __restrict__ Xp,
                T* __restrict__ S, int nN, int nNp, int k, int n_off,
                long long x_elems, int n_jt, int n_nt, int xrows, int bmax,
                Offsets offs, Groups grp) {
  using TL = Tile<T, C>;
  constexpr int R = TL::R, J = TL::J, WARPS = TL::WARPS, NT = WARPS * 32;
  constexpr int TN = WARPS * R, KT = 32 * J, CP = BAND_PITCH<C>;
  constexpr int CC = C * C;
  // a staged X row: the KT columns from the 16-byte boundary at or before
  // column j0, so XV - 1 elements of slack
  constexpr int XV = 16 / sizeof(T), P = KT + XV;
  constexpr unsigned ROW_BYTES = P * sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long bar[NBUF];  // per X buffer
  T* xs = reinterpret_cast<T*>(smem_raw);          // [NBUF][xrows][P]
  T* bs = xs + NBUF * xrows * P;                   // [NBUF][TN][bmax][C][CP]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = warp * R;
  const int jt = blockIdx.x % n_jt, rest = blockIdx.x / n_jt;
  const int n0 = (rest % n_nt) * TN, b = rest / n_nt, j0 = jt * KT;
  const int n_stages = grp.n * C;

  // stage s = (group g, component d): X rows of d into X buffer s % NBUF,
  // a bulk copy of ROW_BYTES per row (row r's column j0 lands at
  // r P + its misalignment); the rows whose copy would pass the end of Xp
  // (the last ones) by 4- or 8-byte cp.async.  Rows past nNp are copied
  // or left stale: only nodes past nN read them.  With d = 0 also the
  // group's band values into band buffer g % NBUF.
  auto x_row0 = [&](int s) {
    const int g = s / C, d = s - g * C;
    return Xp + ((long long)(b * C + d) * nNp + n0 + grp.lo[g]) * k + j0;
  };
  const char* x_end = reinterpret_cast<const char*>(Xp + x_elems);
  auto load_stage = [&](int s) {
    const int g = s / C, d = s - g * C, lo = grp.lo[g];
    const int rows = TN + grp.span[g];
    T* xd = xs + (s % NBUF) * xrows * P;
    const T* xsrc = x_row0(s);
    auto aligned = [&](int row) {
      return reinterpret_cast<const char*>(
          (reinterpret_cast<unsigned long long>(xsrc + (long long)row * k)) &
          ~15ull);
    };
    int n_bulk = rows;
    while (n_bulk > 0 && aligned(n_bulk - 1) + ROW_BYTES > x_end) --n_bulk;
    if (tid == 0) mbar_arrive_tx(&bar[s % NBUF], n_bulk * ROW_BYTES);
    for (int row = tid; row < rows; row += NT) {
      T* dst = xd + row * P;
      if (row < n_bulk) {
        bulk_copy(dst, aligned(row), ROW_BYTES, &bar[s % NBUF]);
      } else if (n0 + lo + row < nNp) {
        const T* src = xsrc + (long long)row * k;
        const int m =
            (int)((reinterpret_cast<unsigned long long>(src) & 15) /
                  sizeof(T));
        for (int col = 0; col < KT && j0 + col < k; ++col)
          cp_async_zfill(dst + m + col, src + col, true);
      }
    }
    if (d == 0) {
      // a warp copies a node's band values of the group, a lane each
      const int o0 = 3 * grp.first[g];
      const int no = 3 * (grp.first[g + 1] - grp.first[g]), per = no * CC;
      for (int i = warp; i < TN; i += WARPS) {
        const bool ok = n0 + i < nN;
        T* bd = bs + (g % NBUF) * TN * bmax * C * CP + i * no * C * CP;
        const T* bsrc =
            band + ((long long)b * nN + n0 + i) * n_off * CC + o0 * CC;
        for (int e = lane; e < per; e += 32) {
          const int o = e / CC, c = (e - o * CC) / C, dd = e % C;
          cp_async_zfill(bd + (o * C + dd) * CP + c, ok ? bsrc + e : band, ok);
        }
      }
    }
    cp_async_commit();
  };

  T acc[R][J][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int jj = 0; jj < J; ++jj)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][jj][c] = T(0);

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < NBUF; ++i) mbar_init(&bar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every stage commits one cp.async group, empty past the last stage
  for (int s = 0; s < NBUF - 1; ++s)
    if (s < n_stages) load_stage(s); else cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    if (s + NBUF - 1 < n_stages)
      load_stage(s + NBUF - 1);
    else
      cp_async_commit();
    cp_async_wait<NBUF - 1>();
    mbar_wait(&bar[s % NBUF], (s / NBUF) & 1);
    __syncthreads();
    const int g = s / C, d = s - g * C, lo = grp.lo[g];
    const int t0 = grp.first[g], t1 = grp.first[g + 1], no = 3 * (t1 - t0);
    const T* xw = xs + (s % NBUF) * xrows * P + lane;
    const T* bb = bs + (g % NBUF) * TN * bmax * C * CP + d * CP;
    // row r's misalignment in elements: (x_row0 + r k) mod XV
    const unsigned mis0 = (unsigned)(
        reinterpret_cast<unsigned long long>(x_row0(s)) / sizeof(T));
    auto triple = [&](int t) {
      const int row0 = i0 + offs.v[3 * t] - lo;
      T x[J][R + 2];
#pragma unroll
      for (int q = 0; q < R + 2; ++q) {
        const int row = row0 + q;
        const T* xr = xw + row * P + ((mis0 + (unsigned)row * k) & (XV - 1));
#pragma unroll
        for (int jj = 0; jj < J; ++jj) x[jj][q] = xr[32 * jj];
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          T bv[C];
          load_band<T, C>(bb + ((i0 + r) * no + 3 * (t - t0) + dx) * C * CP,
                          bv);
#pragma unroll
          for (int c = 0; c < C; ++c)
#pragma unroll
            for (int jj = 0; jj < J; ++jj)
              acc[r][jj][c] += bv[c] * x[jj][r + dx];
        }
    };
    if (t1 - t0 == 3) {
      // the 3^dim stencil's groups: unrolled, so the next triple's loads
      // can start under this one's FMAs
#pragma unroll
      for (int u = 0; u < 3; ++u) triple(t0 + u);
    } else {
      for (int t = t0; t < t1; ++t) triple(t);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = n0 + i0 + r;
    if (n >= nN) break;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      T* sp = S + ((long long)(b * C + c) * nN + n) * k + j0 + lane;
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
        if (j0 + lane + 32 * jj < k) __stcs(sp + 32 * jj, acc[r][jj][c]);
    }
  }
}

// One thread per output node and column (b, n, j), j fastest, computing all
// C outputs of the node: each shifted load is used for every c.
template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
    trace_per_output(const T* __restrict__ band, const T* __restrict__ Xp,
                     T* __restrict__ S, long long total, int nN, int nNp,
                     int k, int n_off, Offsets offs) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int j = (int)(idx % k);
  const long long t = idx / k;
  const int n = (int)(t % nN);
  const long long b = t / nN;
  const T* bp = band + (b * nN + n) * n_off * C * C;
  const T* xp = Xp + b * C * nNp * k + j;
  T acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = T(0);
  for (int o = 0; o < n_off; ++o) {
    const long long row = (long long)(n + offs.v[o]) * k;
    const T* bo = bp + o * C * C;
#pragma unroll
    for (int d = 0; d < C; ++d) {
      const T x = xp[(long long)d * nNp * k + row];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += bo[c * C + d] * x;
    }
  }
  T* sp = S + b * C * nN * k + (long long)n * k + j;
#pragma unroll
  for (int c = 0; c < C; ++c) sp[(long long)c * nN * k] = acc[c];
}

// The triples and their groups of the offsets, false where the offsets do
// not come as dx-triples (off, off + 1, off + 2).
bool make_groups(const Offsets& offs, int n_off, Groups* grp) {
  if (n_off % 3) return false;
  const int nt = n_off / 3;
  int lo = 0, hi = 0;
  grp->n = 0;
  for (int t = 0; t < nt; ++t) {
    const int a = offs.v[3 * t];
    if (offs.v[3 * t + 1] != a + 1 || offs.v[3 * t + 2] != a + 2)
      return false;
    const int nlo = lo < a ? lo : a, nhi = hi > a + 2 ? hi : a + 2;
    if (grp->n > 0 && nhi - nlo <= GROUP_SPAN + 2) {
      lo = nlo, hi = nhi;
    } else {
      if (grp->n > 0) grp->span[grp->n - 1] = hi - lo;
      grp->first[grp->n++] = t;
      lo = a, hi = a + 2;
    }
    grp->lo[grp->n - 1] = lo;
  }
  grp->span[grp->n - 1] = hi - lo;
  grp->first[grp->n] = nt;
  return true;
}

// trace_tiled where k, the offsets and its shared memory allow; returns
// -1 where they do not (the caller takes trace_per_output), else the
// launch's error code.
template <typename T, int C>
int launch_tiled(const T* band, const T* Xp, T* S, int B, int nN, int nNp,
                 int k, int n_off, const Offsets& offs, cudaStream_t st) {
  using TL = Tile<T, C>;
  constexpr int TN = TL::WARPS * TL::R, KT = 32 * TL::J;
  Groups grp;
  if (k < TILE_MIN_K || !make_groups(offs, n_off, &grp)) return -1;
  int span = 0, bmax = 0;
  for (int g = 0; g < grp.n; ++g) {
    span = span > grp.span[g] ? span : grp.span[g];
    const int no = 3 * (grp.first[g + 1] - grp.first[g]);
    bmax = bmax > no ? bmax : no;
  }
  const int xrows = TN + span;
  const size_t smem = (NBUF * (size_t)xrows * (KT + 16 / sizeof(T)) +
                       NBUF * (size_t)TN * bmax * C * BAND_PITCH<C>) *
                      sizeof(T);
  if (smem + slod::STATIC_SMEM_MARGIN > slod::max_smem_optin()) return -1;
  const int n_jt = (k + KT - 1) / KT, n_nt = (nN + TN - 1) / TN;
  const long long blocks = (long long)B * n_nt * n_jt;
  if (blocks > 0x7fffffffLL) return -1;
  const cudaError_t err =
      slod::opt_in_smem((const void*)trace_tiled<T, C>, smem);
  if (err != cudaSuccess) return (int)err;
  trace_tiled<T, C><<<(unsigned)blocks, TL::WARPS * 32, smem, st>>>(
      band, Xp, S, nN, nNp, k, n_off, (long long)B * C * nNp * k, n_jt, n_nt,
      xrows, bmax, offs, grp);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int launch_c(const T* band, const T* Xp, T* S, int B, int nN, int nNp,
             int k, int n_off, const Offsets& offs, cudaStream_t stream) {
  const int rc =
      launch_tiled<T, C>(band, Xp, S, B, nN, nNp, k, n_off, offs, stream);
  if (rc >= 0) return rc;
  const long long total = (long long)B * nN * k;
  const long long blocks = (total + THREADS - 1) / THREADS;
  trace_per_output<T, C><<<(unsigned)blocks, THREADS, 0, stream>>>(
      band, Xp, S, total, nN, nNp, k, n_off, offs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_trace(void* band, void* Xp, void* S, int B, int C, int nN,
                 int nNp, int k, int n_off, const int* offs_host,
                 void* stream) {
  if (n_off < 1 || n_off > MAX_OFFS || B <= 0 || k <= 0 || nN <= 0)
    return (int)cudaErrorInvalidValue;
  Offsets offs;
  for (int o = 0; o < n_off; ++o) offs.v[o] = offs_host[o];
  const T* b = (const T*)band;
  const T* x = (const T*)Xp;
  T* s = (T*)S;
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1:
      return launch_c<T, 1>(b, x, s, B, nN, nNp, k, n_off, offs, st);
    case 2:
      return launch_c<T, 2>(b, x, s, B, nN, nNp, k, n_off, offs, st);
    case 3:
      return launch_c<T, 3>(b, x, s, B, nN, nNp, k, n_off, offs, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int slod_stencil_trace_f32(void* band, void* Xp, void* S, int B, int C,
                           int nN, int nNp, int k, int n_off, void* offs,
                           void* stream) {
  return launch_trace<float>(band, Xp, S, B, C, nN, nNp, k, n_off,
                             (const int*)offs, stream);
}
int slod_stencil_trace_f64(void* band, void* Xp, void* S, int B, int C,
                           int nN, int nNp, int k, int n_off, void* offs,
                           void* stream) {
  return launch_trace<double>(band, Xp, S, B, C, nN, nNp, k, n_off,
                              (const int*)offs, stream);
}

}  // extern "C"
