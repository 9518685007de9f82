// K3: banded stencil trace product for scalar patches,
//   S[b, n, j] = sum_o band[b, n, o] * Xp[b, n + off_o, j],
// o over the 3^dim nodal-stencil offsets (off_o already includes the
// zero-padding shift of the node axis).
//
// Replaces dealii_slod_tpu/ops/assembly.py: stencil_trace_pallas with
// impl="c1"/"c1roll" (_stencil_trace_c1 -> _stencil_trace_c1_kernel).
// What bounds it on the card: bytes.  At the main-path chunk
// (B=128, nN=1331, k=125, 27 offsets) it does 2*27 flops per output against
// one band row and 27 reads of shifted X rows per output row; the X block
// of one patch (~0.8 MB f32) and its band (~0.14 MB) stay L2-resident
// while its rows are in flight, so HBM sees ~(band + X + S) once.  The
// design is one thread per output (b, n, j) with j fastest: the 27 shifted
// X reads of a warp are each a contiguous run of j, so every load
// coalesces, and the FMA chain runs in registers.  The TPU kernel's
// rotate/slice tricks have no counterpart to port.

#include "common.cuh"

namespace {

constexpr int MAX_OFFS = 27;
constexpr int THREADS = 256;

struct Offsets {
  int v[MAX_OFFS];
};

template <typename T>
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
  const T* bp = band + (b * nN + n) * n_off;
  const T* xp = Xp + b * nNp * k + j;
  T acc = bp[0] * xp[(long long)(n + offs.v[0]) * k];
  for (int o = 1; o < n_off; ++o)
    acc += bp[o] * xp[(long long)(n + offs.v[o]) * k];
  S[idx] = acc;
}

template <typename T>
int launch_trace(void* band, void* Xp, void* S, int B, int nN, int nNp, int k,
                 int n_off, const int* offs_host, void* stream) {
  if (n_off < 1 || n_off > MAX_OFFS || B <= 0 || k <= 0)
    return (int)cudaErrorInvalidValue;
  Offsets offs;
  for (int o = 0; o < n_off; ++o) offs.v[o] = offs_host[o];
  const long long total = (long long)B * nN * k;
  const long long blocks = (total + THREADS - 1) / THREADS;
  stencil_trace_kernel<T><<<(unsigned)blocks, THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const T*)band, (const T*)Xp, (T*)S, total, nN, nNp, k, n_off, offs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slod_stencil_trace_f32(void* band, void* Xp, void* S, int B, int nN,
                           int nNp, int k, int n_off, void* offs,
                           void* stream) {
  return launch_trace<float>(band, Xp, S, B, nN, nNp, k, n_off,
                             (const int*)offs, stream);
}
int slod_stencil_trace_f64(void* band, void* Xp, void* S, int B, int nN,
                           int nNp, int k, int n_off, void* offs,
                           void* stream) {
  return launch_trace<double>(band, Xp, S, B, nN, nNp, k, n_off,
                              (const int*)offs, stream);
}

}  // extern "C"
