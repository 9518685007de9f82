// K3 (C = 1) and K7 (C = 2, 3): the banded stencil trace product of
// C-component patches,
//   S[b, c, n, j] = sum_o sum_d band[b, n, o*C*C + c*C + d]
//                              * Xp[b, d, n + off_o, j],
// o over the 3^dim nodal-stencil offsets (off_o already includes the
// zero-padding shift of the node axis), C a template parameter.
//
// K3 replaces dealii_slod_tpu/ops/assembly.py: stencil_trace_pallas with
// impl="c1"/"c1roll" (_stencil_trace_c1 -> _stencil_trace_c1_kernel); its
// C = 1 instance keeps K3's arithmetic order and launch name.  K7 replaces
// the C > 1 forms of the same function: impl="unroll"/"unrollslice"
// (_stencil_trace_unroll -> _stencil_trace_unroll_kernel, which the 3D
// elasticity chunk runs) and the offset-grid kernel of impl="slice"/"roll"
// (_stencil_trace_kernel / _stencil_trace_kernel_roll): one contract, one
// kernel.
// What bounds it on the card: bytes.  At the diffusion chunk (B=128,
// nN=1331, k=125, 27 offsets) each output costs 2*27 flops against one band
// row and 27 reads of shifted X rows; at the 3D elasticity chunk (C=3,
// k=375) 2*243 flops per node against 81 shifted X reads and a 243-wide
// band row.  One patch's X block (0.8 / 7.2 MB f32) and band (0.14 /
// 1.3 MB) stay L2-resident while its rows are in flight, so HBM sees
// ~(band + X + S) once.  The design is one thread per output node and
// column (b, n, j), j fastest, computing all C outputs of the node: each
// shifted load Xp[b, d, n + off_o, j] is read once and used for every c
// (3^dim C loads and 3^dim C^2 FMAs per thread), every load of a warp is a
// contiguous run of j (coalesced), and the C accumulators live in
// registers.  The TPU kernels' rotate/slice tricks and the offset grid
// axis have no counterpart to port.

#include "common.cuh"

namespace {

constexpr int MAX_OFFS = 27;
constexpr int THREADS = 256;

struct Offsets {
  int v[MAX_OFFS];
};

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
    stencil_trace_kernel(const T* __restrict__ band, const T* __restrict__ Xp,
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
  if constexpr (C == 1) {
    T acc = bp[0] * xp[(long long)(n + offs.v[0]) * k];
    for (int o = 1; o < n_off; ++o)
      acc += bp[o] * xp[(long long)(n + offs.v[o]) * k];
    S[idx] = acc;
  } else {
    // per c the terms sum in (o, d) order, as the TPU kernel's chain
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
}

template <typename T, int C>
int launch_c(const T* band, const T* Xp, T* S, long long total, int nN,
             int nNp, int k, int n_off, const Offsets& offs,
             cudaStream_t stream) {
  const long long blocks = (total + THREADS - 1) / THREADS;
  stencil_trace_kernel<T, C><<<(unsigned)blocks, THREADS, 0, stream>>>(
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
  const long long total = (long long)B * nN * k;
  const T* b = (const T*)band;
  const T* x = (const T*)Xp;
  T* s = (T*)S;
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1:
      return launch_c<T, 1>(b, x, s, total, nN, nNp, k, n_off, offs, st);
    case 2:
      return launch_c<T, 2>(b, x, s, total, nN, nNp, k, n_off, offs, st);
    case 3:
      return launch_c<T, 3>(b, x, s, total, nN, nNp, k, n_off, offs, st);
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
