#!/usr/bin/env python3
"""Measure what a thread-block cluster's distributed shared memory offers on
the card: the read rate and the latency of a CTA's own shared memory and of
a neighbour CTA's, and the time of one cluster barrier.

    python3 scripts/dsmem_bench.py

* rate: every CTA (1024 threads, one CTA an SM) reads 96 KB of doubles 64
  times with ``ld.shared::cluster.f64``, from its own shared memory or from
  the next CTA's of its cluster (2, 8 and 16 CTAs), the same instruction in
  both; each pass starts 256 words on from the last, so every pass loads
  anew.  Each thread issues its 12 loads of a pass before it uses one, into
  12 independent sums ("12 chains") or into one sum that every add waits
  on ("1 chain").  Rates are per SM; as many clusters as the card holds
  at once (``cudaOccupancyMaxActiveClusters``) run in one wave.
* latency: one thread of one cluster follows a chain of indices through
  its own or the neighbour's shared memory (each load's address is the
  previous load's value): ns per load.
* cluster barrier: ``barrier.cluster.arrive.release`` +
  ``barrier.cluster.wait.acquire`` in clusters of 8 CTAs of 768 threads
  and of 16 of 384, back to back: ns each.

Times are CUDA events over calls queued behind a spin kernel, after one
warm-up.  The source is built with the port's nvcc flags into
``dealii_slod_tpu_torch/_build/dsmem_bench/`` and loaded with ctypes.
Needs an NVIDIA GPU and nvcc; imports no JAX.
"""

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "dealii_slod_tpu_torch", "_build", "dsmem_bench")

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
constexpr int THREADS = 1024, WORDS = 12288, PER = WORDS / THREADS;
constexpr int SMEM = 116 * 1024;   // over half an SM's 228 KB: one CTA an SM
constexpr int CHASE = 4096;        // the index chain's length

__device__ unsigned cluster_addr(const void* p, unsigned rank) {
  unsigned a = (unsigned)__cvta_generic_to_shared(p), r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}
__device__ double ld_f64(unsigned a) {
  double v;
  asm volatile("ld.shared::cluster.f64 %0, [%1];" : "=d"(v) : "r"(a));
  return v;
}
__device__ unsigned ld_u32(unsigned a) {
  unsigned v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}
__device__ unsigned peer(cg::cluster_group& cl, int remote) {
  return remote ? (cl.block_rank() + 1) % cl.num_blocks() : cl.block_rank();
}

template <int CHAINS>
__global__ void __launch_bounds__(THREADS)
    dsmem_read(double* out, int remote, int reps) {
  extern __shared__ double buf[];
  cg::cluster_group cl = cg::this_cluster();
  for (int i = threadIdx.x; i < WORDS; i += THREADS) buf[i] = i;
  cl.sync();
  const unsigned base = cluster_addr(buf, peer(cl, remote));
  double s[CHAINS] = {};
  for (int r = 0; r < reps; ++r) {
    // pass r starts 256 r words on (mod WORDS): its addresses differ from
    // the last pass's, so the compiler cannot keep the loads out of the loop
    const int i0 = threadIdx.x + (r * 256) % WORDS;
    double v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      int i = i0 + k * THREADS;
      i -= i >= WORDS ? WORDS : 0;
      v[k] = ld_f64(base + i * 8);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) s[k % CHAINS] += v[k];
  }
  double t = 0;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) t += s[k];
  cl.sync();
  if (t == -1.0) out[blockIdx.x] = t;
}

__global__ void dsmem_chase(unsigned* out, int remote, int steps) {
  extern __shared__ unsigned ibuf[];
  cg::cluster_group cl = cg::this_cluster();
  for (int i = threadIdx.x; i < CHASE; i += blockDim.x)
    ibuf[i] = (i + 97) % CHASE;
  cl.sync();
  if (threadIdx.x == 0) {
    const unsigned base = cluster_addr(ibuf, peer(cl, remote));
    unsigned j = 0;
    for (int s = 0; s < steps; ++s) j = ld_u32(base + j * 4);
    out[blockIdx.x] = j;
  }
  cl.sync();
}

__global__ void cluster_barriers(int* out, int reps) {
  for (int r = 0; r < reps; ++r)
    asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (threadIdx.x == 0 && reps < 0) out[blockIdx.x] = reps;
}

template <typename K, typename... A>
int launch(K kern, int S, int clusters, int threads, int smem, void* stream,
           A... args) {
  const void* fn = reinterpret_cast<const void*>(kern);
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = S;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t c = {};
  c.blockDim = dim3(threads);
  c.dynamicSmemBytes = smem;
  c.stream = (cudaStream_t)stream;
  c.attrs = a;
  c.numAttrs = 1;
  if (clusters <= 0) {   // as many clusters as the card holds at once
    c.gridDim = dim3(S);
    cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kern, &c);
    if (e != cudaSuccess) return -(int)e;
    return clusters;
  }
  c.gridDim = dim3(S * clusters);
  cudaError_t e = cudaLaunchKernelEx(&c, kern, args...);
  return e != cudaSuccess ? -(int)e : -(int)cudaGetLastError();
}

// each returns the clusters the card holds at once when clusters <= 0,
// else minus the launch's error (0: launched)
extern "C" int run_read(int chains, int S, int clusters, int remote,
                        int reps, void* out, void* stream) {
  return chains == 1
             ? launch(dsmem_read<1>, S, clusters, THREADS, SMEM, stream,
                      (double*)out, remote, reps)
             : launch(dsmem_read<PER>, S, clusters, THREADS, SMEM, stream,
                      (double*)out, remote, reps);
}
extern "C" int run_chase(int S, int remote, int steps, void* out,
                         void* stream) {
  return launch(dsmem_chase, S, 1, 32, CHASE * 4, stream, (unsigned*)out,
                remote, steps);
}
extern "C" int run_barriers(int S, int threads, int clusters, int reps,
                            void* out, void* stream) {
  return launch(cluster_barriers, S, clusters, threads, 0, stream,
                (int*)out, reps);
}
"""


def build():
    sys.path.insert(0, HERE)
    from dealii_slod_tpu_torch.utils import kernels
    os.makedirs(OUT, exist_ok=True)
    src, lib = os.path.join(OUT, "dsmem.cu"), os.path.join(OUT, "lib.so")
    with open(src, "w") as fh:
        fh.write(SOURCE)
    p = subprocess.run([kernels._find_nvcc(), *kernels.NVCC_FLAGS, "-shared",
                        "-o", lib, src], capture_output=True, text=True)
    if p.returncode:
        print((p.stdout + p.stderr)[-3000:])
        raise SystemExit(1)
    return ctypes.CDLL(lib)


def device_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(50_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def launched(rc, what):
    if rc:
        raise RuntimeError(f"{what}: launch failed ({-rc})")


def main():
    import torch
    if not torch.cuda.is_available():
        print("dsmem_bench: torch sees no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    lib = build()
    for f in (lib.run_read, lib.run_chase, lib.run_barriers):
        f.restype = ctypes.c_int
    lib.run_read.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    lib.run_chase.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.run_barriers.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    out = torch.zeros(4096, dtype=torch.float64, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    reps = 64
    for S in (2, 8, 16):
        for chains in (12, 1):
            cl = lib.run_read(chains, S, 0, 0, reps, out.data_ptr(), st)
            if cl < 1:
                raise RuntimeError(f"no cluster of {S} fits ({cl})")
            for remote in (0, 1):
                ms = device_ms(lambda: launched(lib.run_read(
                    chains, S, cl, remote, reps, out.data_ptr(), st),
                    "read"), 5)
                gbs = 96 * 1024 * reps / (ms * 1e-3) / 1e9
                print(f"[dsmem] read rate: cluster {S} ({cl} clusters at "
                      f"once), {chains} chain{'s' if chains > 1 else ''}, "
                      f"{'a neighbour' if remote else 'its own'} shared "
                      f"memory: {ms:.4f} ms, {gbs:.1f} GB/s per SM [{card}]")
    steps = 100_000
    for S in (2, 16):
        for remote in (0, 1):
            ms = device_ms(lambda: launched(lib.run_chase(
                S, remote, steps, out.data_ptr(), st), "chase"), 3)
            print(f"[dsmem] latency: cluster {S}, "
                  f"{'a neighbour' if remote else 'its own'} shared memory: "
                  f"{ms * 1e6 / steps:.1f} ns a load [{card}]")
    for S, threads in ((8, 768), (16, 384)):
        r = 20000
        cl = lib.run_barriers(S, threads, 0, r, out.data_ptr(), st)
        ms = device_ms(lambda: launched(lib.run_barriers(
            S, threads, cl, r, out.data_ptr(), st), "barrier"), 3)
        print(f"[dsmem] cluster barrier: {cl} clusters of {S} CTAs of "
              f"{threads} threads: {ms * 1e6 / r:.1f} ns each [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
