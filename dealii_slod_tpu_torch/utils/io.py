"""VTU / field output.

Replaces the reference's DataOut VTU writers (``output_coarse_results``
source/LOD.cc:248-293, the fine-field output in ``compare_lod_with_fem``
LOD.cc:1262-1377, and the coefficient output
``create_random_problem_coefficients`` include/Diffusion.h:70-108):
ParaView-readable XML UnstructuredGrid files written from the structured
grid's index arrays.  Pure-Python ASCII VTU here; the native C++ binary
writer (``native/``) is used when built."""

from __future__ import annotations

import io
import os
from typing import Dict, Optional

import numpy as np

from dealii_slod_tpu_torch.grid import GridSpec, cartesian_coords, global_connectivity

# VTK cell types and corner orderings from our axis0-fastest bit order
_VTK_QUAD = 9
_VTK_HEXAHEDRON = 12
_QUAD_ORDER = [0, 1, 3, 2]
_HEX_ORDER = [0, 1, 3, 2, 4, 5, 7, 6]


def _as3(points: np.ndarray) -> np.ndarray:
    out = np.zeros((len(points), 3))
    out[:, :points.shape[1]] = points
    return out


def _pad_components(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v)
    if v.ndim == 1:
        return v[:, None]
    if v.shape[1] == 2:
        return np.concatenate([v, np.zeros((len(v), 1))], axis=1)
    return v


def write_vtu(path: str, points: np.ndarray, cells: np.ndarray, dim: int,
              point_data: Optional[Dict[str, np.ndarray]] = None,
              cell_data: Optional[Dict[str, np.ndarray]] = None) -> str:
    """Write an XML .vtu file (ASCII).  ``points`` (n, dim), ``cells``
    (m, 2^dim) in axis0-fastest corner order."""
    order = _QUAD_ORDER if dim == 2 else _HEX_ORDER
    ctype = _VTK_QUAD if dim == 2 else _VTK_HEXAHEDRON
    pts3 = _as3(points)
    cells_v = np.asarray(cells)[:, order]
    n_pts, n_cells = len(pts3), len(cells_v)
    k = cells_v.shape[1]

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # prefer the native binary writer (native/slod_native.cpp)
    try:
        from dealii_slod_tpu_torch.utils import native
        if native.write_vtu_binary(path, pts3, cells_v, ctype,
                                   point_data or {}, cell_data or {}):
            return path
    except Exception:
        pass

    buf = io.StringIO()
    w = buf.write
    w('<?xml version="1.0"?>\n')
    w('<VTKFile type="UnstructuredGrid" version="0.1" '
      'byte_order="LittleEndian">\n')
    w('  <UnstructuredGrid>\n')
    w(f'    <Piece NumberOfPoints="{n_pts}" NumberOfCells="{n_cells}">\n')
    w('      <Points>\n')
    w('        <DataArray type="Float64" NumberOfComponents="3" '
      'format="ascii">\n')
    np.savetxt(buf, pts3, fmt="%.16g")
    w('        </DataArray>\n      </Points>\n')
    w('      <Cells>\n')
    w('        <DataArray type="Int64" Name="connectivity" format="ascii">\n')
    np.savetxt(buf, cells_v, fmt="%d")
    w('        </DataArray>\n')
    w('        <DataArray type="Int64" Name="offsets" format="ascii">\n')
    np.savetxt(buf, np.arange(1, n_cells + 1) * k, fmt="%d")
    w('        </DataArray>\n')
    w('        <DataArray type="UInt8" Name="types" format="ascii">\n')
    np.savetxt(buf, np.full(n_cells, ctype), fmt="%d")
    w('        </DataArray>\n      </Cells>\n')

    def data_block(tag, data):
        w(f'      <{tag}>\n')
        for name, v in (data or {}).items():
            v = _pad_components(v)
            nc = v.shape[1]
            w(f'        <DataArray type="Float64" Name="{name}" '
              f'NumberOfComponents="{nc}" format="ascii">\n')
            np.savetxt(buf, v, fmt="%.16g")
            w('        </DataArray>\n')
        w(f'      </{tag}>\n')

    data_block("PointData", point_data)
    data_block("CellData", cell_data)
    w('    </Piece>\n  </UnstructuredGrid>\n</VTKFile>\n')

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(buf.getvalue())
    return path


def write_fine_grid_vtu(path: str, grid: GridSpec,
                        point_data: Dict[str, np.ndarray]) -> str:
    """Fine-grid output: nodes + Q1 subcells (reference fine VTU,
    LOD.cc:1369-1372)."""
    return write_vtu(path, grid.node_coords(), global_connectivity(grid),
                     grid.dim, point_data=point_data)


def write_coarse_grid_vtu(path: str, grid: GridSpec,
                          cell_data: Dict[str, np.ndarray]) -> str:
    """Coarse-grid output: one value per coarse cell (the reference's DGQ0
    coarse solution, LOD.cc:248-293)."""
    N = grid.n_coarse
    gH = GridSpec(grid.dim, N, 1, grid.n_components)
    return write_vtu(path, gH.node_coords(), global_connectivity(gH),
                     grid.dim, cell_data=cell_data)


def write_subcell_field_vtu(path: str, grid: GridSpec,
                            cell_data: Dict[str, np.ndarray]) -> str:
    """Per-fine-subcell (DGQ0-style) field output — used for coefficient
    fields (reference *_coefficients.vtu, Diffusion.h:95-107)."""
    return write_vtu(path, grid.node_coords(), global_connectivity(grid),
                     grid.dim, cell_data=cell_data)
