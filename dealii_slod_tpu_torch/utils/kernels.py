"""Build, load and launch the port's CUDA kernels (``csrc/``).

Counterpart of ``dealii_slod_tpu/utils/native.py`` for the device: at first
use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared
library with a plain C interface, kept under ``dealii_slod_tpu_torch/_build/``
in a directory named by a hash of the sources and flags, and loaded with
ctypes.  Nothing here swallows an error: a missing ``nvcc``, a failed build,
a failed load or a non-zero ``cudaGetLastError()`` after a launch raises.

``launches`` counts, per kernel, the launches that went through ``launch``;
a run that must show it used the kernels resets it and reads it back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
LIB_NAME = "libslod_kernels.so"

# C entry points: argument codes p = pointer, i = int, d = double; every
# entry point also takes the CUDA stream last and returns cudaGetLastError()
_SIGNATURES = {
    "slod_fused_spd_multirhs": "ppppiii",
    "slod_gj_inverse": "pii",
    "slod_stencil_trace": "pppiiiiip",
    "slod_jacobi_rows": "pppiiiddd",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "d": ctypes.c_double}

launches: Counter = Counter()
_lib = None


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
    path.  The compiler's output, including ``-Xptxas=-v`` register and
    shared-memory usage, is kept in ``build.log`` beside the library."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.tmp{os.getpid()}"
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", tmp] + [
        os.path.join(CSRC, f) for f in _sources() if f.endswith(".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(out_dir, "build.log"), "w") as fh:
        fh.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
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


def launch(name: str, entry: str, dtype: torch.dtype, device: torch.device,
           *args) -> None:
    """Call ``{entry}_{f32|f64}`` on ``device``'s current stream and raise
    on a non-zero ``cudaGetLastError()``; count the launch."""
    fn = getattr(library(), f"{entry}_{suffix(dtype)}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        msg = library().slod_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err})")
    launches[name] += 1
