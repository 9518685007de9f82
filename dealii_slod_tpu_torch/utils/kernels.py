"""Build, load and launch the port's CUDA kernels (``csrc/``).

Counterpart of ``dealii_slod_tpu/utils/native.py`` for the device: at first
use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one compiler
process per source, all started together) and links the objects into one
shared library with a plain C interface, kept under
``dealii_slod_tpu_torch/_build/`` in a directory named by a hash of the
sources and flags, and loaded with ctypes.  Nothing here swallows an error: a missing ``nvcc``, a failed build,
a failed load or a non-zero ``cudaGetLastError()`` after a launch raises.

``launches`` counts, per kernel, the launches that went through ``launch``;
a run that must show it used the kernels resets it and reads it back.
Under a profiler each launch is also a ``launch`` span (``utils/timers``)
with the kernel's name as its ``kernel`` attribute, a leaf under the
solver stage that launched it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter

import torch

from dealii_slod_tpu_torch.utils.timers import span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
LIB_NAME = "libslod_kernels.so"

# C entry points: argument codes p = pointer, i = int, l = long long,
# d = double; every
# entry point also takes the CUDA stream last and returns cudaGetLastError()
_SIGNATURES = {
    "slod_fused_spd_multirhs": "ppppiii",
    "slod_spd_multirhs_solve": "pppiii",
    "slod_gj_inverse": "ppiili",
    "slod_stencil_trace": "pppiiiiiip",
    "slod_jacobi_rows": "pppppppiiiiddd",
    "slod_mgs_qr": "pppiii",
    "slod_weig": "ppppppiiiiddd",
}
# size queries (no stream; return a long long): global workspace elements
# per matrix that a launch at these sizes needs, 0 where shared memory
# holds the working set, -1 where no launch can take the sizes
_QUERIES = {
    "slod_fused_spd_multirhs_ws": "ii",
    "slod_spd_multirhs_solve_ws": "ii",
    "slod_mgs_qr_ws": "ii",
    "slod_jacobi_rows_ws": "i",
    "slod_weig_ws": "i",
    # not workspaces: the thread-block cluster size of K5's / K8's launch
    # at row length n, 0 where they take another route; the route K8 takes
    # at k (csrc/jacobi_eigh.cu: Route; ops/eig.py: K5_ROUTES)
    "slod_jacobi_rows_cluster": "i",
    "slod_weig_route": "i",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
           "d": ctypes.c_double}

launches: Counter = Counter()
_lib = None
_answers: dict = {}           # query(): the size queries' answers


def reset_launch_counts() -> None:
    launches.clear()


def _sources():
    return sorted(f for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _sources():
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        nvcc = cand if os.path.exists(cand) else None
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin): cannot build csrc/")
    return nvcc


def build() -> str:
    """Compile ``csrc/*.cu`` (once per source hash); return the library
    path.  Each source compiles in its own ``nvcc`` process, all at once;
    the compilers' output, including ``-Xptxas=-v`` register and
    shared-memory usage, is kept in ``build.log`` beside the library."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc, tag = _find_nvcc(), f"tmp{os.getpid()}"
    objs, procs = [], []
    for f in _sources():
        if f.endswith(".cu"):
            objs.append(os.path.join(out_dir, f"{f[:-3]}.{tag}.o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1],
                   os.path.join(CSRC, f)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    tmp = f"{lib_path}.{tag}"
    steps = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    if all(rc == 0 for _, _, rc in steps):
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        p = subprocess.run(cmd, capture_output=True, text=True)
        steps.append((cmd, p.stdout + p.stderr, p.returncode))
    with open(os.path.join(out_dir, "build.log"), "w") as fh:
        for cmd, out, _ in steps:
            fh.write(" ".join(cmd) + "\n" + out)
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    failed = [(cmd, out, rc) for cmd, out, rc in steps if rc != 0]
    if failed:
        cmd, out, rc = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n"
                           f"{out[-4000:]}")
    os.replace(tmp, lib_path)     # atomic: concurrent builds agree
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for base, codes in _SIGNATURES.items():
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{base}_{suffix}")
                fn.argtypes = [_CTYPES[c] for c in codes] + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
        for base, codes in _QUERIES.items():
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{base}_{suffix}")
                fn.argtypes = [_CTYPES[c] for c in codes]
                fn.restype = ctypes.c_longlong
        lib.slod_error_string.argtypes = [ctypes.c_int]
        lib.slod_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def suffix(dtype: torch.dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"kernels take float32 or float64, not {dtype}")


def check_cuda(name: str, *tensors: torch.Tensor,
               contiguous: bool = True) -> None:
    """Device / dtype (/ contiguity, for tensors a kernel reads in place)
    checks shared by the wrappers."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device, got {t.device}")
        if t.dtype != tensors[0].dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype}, "
                            f"{tensors[0].dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    suffix(tensors[0].dtype)


def query(entry: str, dtype: torch.dtype, device: torch.device,
          *sizes) -> int:
    """The answer of the size query ``{entry}_{f32|f64}`` (one of
    ``_QUERIES``) at ``sizes`` on ``device``, asked once per entry, dtype,
    device and sizes."""
    key = (entry, dtype, device, sizes)
    ans = _answers.get(key)
    if ans is None:
        fn = getattr(library(), f"{entry}_{suffix(dtype)}")
        with torch.cuda.device(device):
            ans = _answers[key] = int(fn(*sizes))
    return ans


def workspace(name: str, entry: str, dtype: torch.dtype,
              device: torch.device, batch: int, *sizes):
    """The global workspace a launch of ``entry`` at ``sizes`` takes on
    ``device`` (the size rule is the C++ launcher's, ``{entry}_ws``, asked
    once per entry, dtype, device and sizes): a (batch * elements,) tensor,
    or None where shared memory holds the working set.  Raises where no
    launch can take the sizes."""
    elems = query(f"{entry}_ws", dtype, device, *sizes)
    if elems < 0:
        raise RuntimeError(f"{name}: no launch takes sizes {sizes} in "
                           f"{dtype} on {device}")
    if elems == 0:
        return None
    return torch.empty((batch * elems,), dtype=dtype, device=device)


def launch(name: str, entry: str, dtype: torch.dtype, device: torch.device,
           *args) -> None:
    """Call ``{entry}_{f32|f64}`` on ``device``'s current stream and raise
    on a non-zero ``cudaGetLastError()``; count the launch."""
    fn = getattr(library(), f"{entry}_{suffix(dtype)}")
    with span("launch", kernel=name), torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        msg = library().slod_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err})")
    launches[name] += 1
