"""Per-shape-class basis construction, ``kernel_mode="classes"``
(counterpart of ``dealii_slod_tpu/models/basis.py``: ``_class_patch_fn``,
``_build_class_kernel``, ``_class_inputs``, ``_compute_basis_classes``).

The exact-size form of the reference algorithm (source/LOD.cc:296-768):
the patches are grouped by their window shape, and each group runs in
chunks, batched over its patches, with every window's true size, no masks
and no padding.  Per chunk:

1. the subcell matrices scatter-added into the dense patch stiffness A
   (``assemble_dense_batch``);
2. X = A_int^-1 PT_int by a Cholesky solve on the interior block (the
   reference's row-cleared operator, LOD.cc:512-546), T = PT_int^T X / H^dim
   and T^-1 by ``torch.linalg.inv``;
3. SLOD (unless the patch covers the domain, LOD.cc:563-564): the boundary
   trace BD = (S_b X - PT_b) T^-1, F = BD^T BD, one Gram per component, its
   SVD with the relative cut ``sig > thr * sig[0]`` (LOD.cc:667) and the
   latched sigma-truncation loop (LOD.cc:703-725);
4. the normalized candidates, A_semi phi (A phi, domain-boundary rows
   zeroed, LOD.cc:758-765), placed into the canvases at each patch's offset
   by precomputed flat canvas indices.

No kernel runs here: this route is the oracle that the uniform kernel
route is held to (on the CPU in ``tests/test_torch_routes.py``, on the
card in ``chip_smoke.py``).  It never dedups, as in the reference."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dealii_slod_tpu_torch.grid import ShapeClass, ravel
from dealii_slod_tpu_torch.ops.assembly import (assemble_dense_batch,
                                                make_subcell_matrices)
from dealii_slod_tpu_torch.ops.eig import _truncation_scan
from dealii_slod_tpu_torch.ops.solvers import cholesky_solve


@dataclasses.dataclass
class ClassTables:
    """One shape class's static tables and per-patch inputs (tensors on the
    solver's device)."""

    sc: ShapeClass
    slod: bool                  # SLOD stabilization for this class
    pids: torch.Tensor          # (B,) patch ids
    gsub: torch.Tensor          # (B, n_sub) global subcell of each subcell
    is99: torch.Tensor          # (B, n_edge) patch-boundary edge nodes
    isdom: torch.Tensor         # (B, n_edge) domain-boundary edge nodes
    central: torch.Tensor       # (B,) local index of the central cell
    canvas_idx: torch.Tensor    # (B, n_nodes) canvas node of each node
    flat_idx: torch.Tensor
    int_dofs: torch.Tensor
    edge_dofs: torch.Tensor
    edge_nodes: torch.Tensor
    PT: torch.Tensor            # (nD, cD)
    PT_int: torch.Tensor        # (nI, cD)


def class_tables(solver, ci: int) -> ClassTables:
    """Shape class ``ci``'s tables and per-patch inputs: patch ids, subcell
    gather indices (with the reference's full-size-patch stiffness cache,
    LOD.cc:354-361), edge flags, central cell and canvas nodes."""
    topo, cfg, dev = solver.topo, solver.cfg, solver.device
    sc = topo.classes[ci]
    pids = topo.patches_by_class[ci]
    gsub = topo.global_subcell_indices(pids, sc).astype(np.int64)
    if (solver._stiffness_cache_ok()
            and sc.n_cells_local == (2 * cfg.oversampling + 1) ** cfg.dim):
        gsub = np.broadcast_to(gsub[:1], gsub.shape)
    is99, isdom = topo.edge_node_flags(pids, sc)
    canvas_idx = ravel(sc.node_coords_local[None, :, :]
                       + solver.canvas_off[pids][:, None, :],
                       solver.canvas_dims)

    def ti(a, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    return ClassTables(
        sc=sc,
        slod=bool(cfg.lod_stabilization and cfg.oversampling > 0
                  and sc.n_cells_local != solver.grid.n_cells),
        pids=ti(pids), gsub=ti(gsub), is99=ti(is99, torch.bool),
        isdom=ti(isdom, torch.bool),
        central=ti(topo.central_cell_local[pids]),
        canvas_idx=ti(canvas_idx), flat_idx=ti(sc.assembly_flat_idx),
        int_dofs=ti(sc.interior_dof_indices()),
        edge_dofs=ti(sc.edge_dof_indices()), edge_nodes=ti(sc.edge_nodes),
        PT=ti(sc.PT, solver.dtype), PT_int=ti(sc.PT_interior, solver.dtype))


def stabilized_coefficients(Fm, onehot, thr):
    """The SLOD coefficients of one component (LOD.cc:660-725): the Gram
    G = diag(m) F diag(m) and g0 = F e_cen * m, m = 1 - e_cen, its SVD
    pseudo-inverse with the relative cut ``sig > thr * sig[0]``, then the
    latched sigma-truncation loop.  Fm (B, cD, cD), onehot (B, cD) ->
    dvec (B, cD), zero at the centre."""
    cm = 1.0 - onehot
    G = Fm * cm[:, :, None] * cm[:, None, :]
    g0 = (Fm @ onehot[:, :, None])[:, :, 0] * cm
    U, sig, Vh = torch.linalg.svd(G)
    inv_sig = torch.where(sig > thr * sig[:, :1], 1.0 / sig, 0.0)
    uv = (U.mT @ g0[:, :, None])[:, :, 0]
    terms = (inv_sig * uv)[:, :, None] * Vh                  # rows i
    return _truncation_scan(-terms.sum(1), terms.flip(1)) * cm


def class_chunk(solver, ct: ClassTables, coefs, rows: slice):
    """One chunk ``rows`` of a class's patches -> canvases (Phi, APhi)
    (b, canvas_n, C, C)."""
    C, dt = solver.C, solver.dtype
    sc = ct.sc
    nD, cD = sc.n_fine_dofs_local, sc.n_coarse_dofs_local
    cw = {k: coefs[k][ct.gsub[rows]] for k in solver.coef_names}
    A = assemble_dense_batch(make_subcell_matrices(solver.et, cw),
                             ct.flat_idx, nD)                  # (b, nD, nD)
    b = A.shape[0]
    A_int = A[:, ct.int_dofs][:, :, ct.int_dofs]
    X = cholesky_solve(torch.linalg.cholesky(A_int),
                       ct.PT_int.expand(b, -1, -1))            # (b, nI, cD)
    Hdim = solver.grid.H ** solver.cfg.dim                     # LOD.cc:548
    Tinv = torch.linalg.inv((ct.PT_int.mT @ X) / Hdim)
    cens = ct.central[rows, None] * C + torch.arange(C, device=A.device)
    onehots = (torch.arange(cD, device=A.device)[None, :, None]
               == cens[:, None, :]).to(dt)                    # (b, cD, C)
    Dm = onehots
    if ct.slod:
        mask99 = ct.is99[rows].repeat_interleave(C, dim=1).to(dt)
        S_edge = A[:, ct.edge_dofs][:, :, ct.int_dofs] * mask99[:, :, None]
        PT_edge = ct.PT[ct.edge_dofs][None] * mask99[:, :, None]
        BD = (S_edge @ X - PT_edge) @ Tinv
        Fm = BD.mT @ BD
        Dm = onehots + torch.stack(
            [stabilized_coefficients(Fm, onehots[:, :, d],
                                     solver.cfg.svd_threshold)
             for d in range(C)], dim=-1)
    phi_int = X @ (Tinv @ Dm)                                  # (b, nI, C)
    phi_int = phi_int / torch.sqrt((phi_int ** 2).sum(1, keepdim=True))
    phi = A.new_zeros((b, nD, C))
    phi[:, ct.int_dofs] = phi_int
    Aphi = A @ phi
    dom = torch.zeros((b, sc.n_nodes_local), dtype=torch.bool,
                      device=A.device)
    dom[:, ct.edge_nodes] = ct.isdom[rows]
    Aphi = torch.where(dom.repeat_interleave(C, dim=1)[:, :, None], 0.0,
                       Aphi)

    def to_canvas(v):
        canvas = v.new_zeros((b, solver.canvas_n, C, C))
        canvas[torch.arange(b, device=v.device)[:, None],
               ct.canvas_idx[rows]] = v.reshape(b, sc.n_nodes_local, C, C)
        return canvas

    return to_canvas(phi), to_canvas(Aphi)


def compute_basis(solver, coefs, rows=None):
    """Canvases (P, canvas_n, C, C) of every patch, class by class in
    chunks of ``cfg.patch_chunk`` patches (0 = the whole class); with
    ``rows`` = (a, b) only the patches a .. b-1, each class building the
    ones it holds, and the canvases are those rows."""
    a, b = rows or (0, solver.topo.n_patches)
    C = solver.C
    Phi = torch.zeros((b - a, solver.canvas_n, C, C), dtype=solver.dtype,
                      device=solver.device)
    APhi = torch.zeros_like(Phi)
    for ci in range(len(solver.topo.classes)):
        if ci not in solver._class_tables:
            solver._class_tables[ci] = class_tables(solver, ci)
        ct = solver._class_tables[ci]
        # a class's patch ids are ascending: its share is one range
        lo_c, hi_c = (int(i) for i in np.searchsorted(
            solver.topo.patches_by_class[ci], (a, b)))
        step = solver.cfg.patch_chunk or (hi_c - lo_c)
        for lo in range(lo_c, hi_c, step):
            sl = slice(lo, min(hi_c, lo + step))
            Phi[ct.pids[sl] - a], APhi[ct.pids[sl] - a] = class_chunk(
                solver, ct, coefs, sl)
    return Phi, APhi
