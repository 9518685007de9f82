"""ctypes bindings to the native C++ runtime components (``native/``).

Builds ``libslod_native.so`` on first use (g++ available in the image); all
callers fall back to the pure-NumPy/Python implementations when the library
cannot be built, so the package never hard-depends on a compiler."""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libslod_native.so")

_lib = None
_tried = False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library; None on failure."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        src = os.path.join(_NATIVE_DIR, "slod_native.cpp")
        if (not os.path.exists(_LIB_PATH)
                or (os.path.exists(src) and os.path.getmtime(src)
                    > os.path.getmtime(_LIB_PATH))):
            if not os.path.exists(src):
                return None
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-std=c++17", "-shared",
                 "-o", _LIB_PATH, src],
                check=True, capture_output=True, timeout=120)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.build_patches.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)]
        lib.write_vtu_binary.restype = ctypes.c_int
        lib.fold_window_index.argtypes = [
            ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def fold_window_index(cols, oks, extents):
    """Native outer-sum fold of per-axis window columns (the
    LODSolver-ctor hotspot at scale; see grid.clipped_window_index).

    ``cols[d]``: (P, extents[d]) int32 stride-scaled clipped columns;
    ``oks[d]``: matching in-bounds bools.  Returns (idx (P, K) int32,
    valid (P, K) bool) with axis 0 fastest, or None when the native
    library is unavailable (callers fall back to the NumPy fold)."""
    lib = load()
    dim = len(cols)
    if lib is None or dim > 3:
        return None
    P = cols[0].shape[0]
    ext = np.asarray(extents, dtype=np.int32)
    K = int(np.prod(ext))
    cols_cat = np.ascontiguousarray(
        np.concatenate([c.astype(np.int32) for c in cols], axis=1))
    oks_cat = np.ascontiguousarray(
        np.concatenate([o.astype(np.uint8) for o in oks], axis=1))
    idx = np.empty((P, K), dtype=np.int32)
    valid = np.empty((P, K), dtype=np.uint8)
    lib.fold_window_index(
        P, dim, ext.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cols_cat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        oks_cat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return idx, valid.astype(bool)


def build_patches(dim: int, n_coarse: int, ell: int):
    """Native patch-topology builder; returns (lo, shape, central,
    side_is_domain) or None if the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    P = n_coarse ** dim
    lo = np.empty((P, dim), dtype=np.int32)
    shape = np.empty((P, dim), dtype=np.int32)
    central = np.empty(P, dtype=np.int32)
    sides = np.empty((P, 2 * dim), dtype=np.uint8)
    lib.build_patches(
        dim, n_coarse, ell,
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        shape.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        central.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        sides.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return lo, shape, central, sides.astype(bool)


def write_vtu_binary(path: str, points3: np.ndarray, cells: np.ndarray,
                     vtk_cell_type: int,
                     point_data: dict, cell_data: dict) -> bool:
    """Native appended-raw-binary VTU writer; False if unavailable."""
    lib = load()
    if lib is None:
        return False
    pts = np.ascontiguousarray(points3, dtype=np.float64)
    cls = np.ascontiguousarray(cells, dtype=np.int64)
    n_pts, n_cells = len(pts), len(cls)

    def pack(data):
        arrs, comps, names = [], [], []
        for name, v in (data or {}).items():
            v = np.asarray(v, dtype=np.float64)
            if v.ndim == 1:
                v = v[:, None]
            if v.shape[1] == 2:
                v = np.concatenate([v, np.zeros((len(v), 1))], axis=1)
            arrs.append(np.ascontiguousarray(v))
            comps.append(v.shape[1])
            names.append(name)
        flat = (np.concatenate([a.ravel() for a in arrs])
                if arrs else np.empty(0))
        return (np.ascontiguousarray(flat),
                np.asarray(comps, dtype=np.int64), "\n".join(names))

    pflat, pcomps, pnames = pack(point_data)
    cflat, ccomps, cnames = pack(cell_data)
    rc = lib.write_vtu_binary(
        path.encode(), pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(n_pts),
        cls.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n_cells), ctypes.c_int(cls.shape[1]),
        ctypes.c_int(vtk_cell_type),
        pflat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        pcomps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int(len(pcomps)), pnames.encode(),
        cflat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ccomps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int(len(ccomps)), cnames.encode())
    return rc == 0
