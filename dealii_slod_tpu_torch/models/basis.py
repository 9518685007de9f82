"""Batched SLOD basis construction on the padded canvas — the hot
per-patch loop (counterpart of ``dealii_slod_tpu/models/basis.py``: the
uniform kernel's chunk form, ``_uniform_chunk_fn`` with the fused patch
solver and the split Jacobi spectral stage).

Every patch is padded to the full (2l+1)-cell canvas window and its real
window is described by data (``nlo``/``nhi`` node bounds, domain-side
flags): fake subcells get zero coefficients, fake and boundary dofs
identity rows, fake coarse cells an identity diagonal in the triple
product.  Each function below works on a batch (chunk) of B patches.

Per chunk (reference source/LOD.cc:296-768):

1. ``prep``: bands, the SPD interior block A, the masked projection PT;
2. X = A^-1 PT and T = PT^T X (K1), T^-1 (K2);
3. the patch-boundary trace S = A X (K3) and the Gram F = BD^T BD;
4. the Gram's eigenpairs (K5 on its Cholesky factor);
5. the truncated pseudo-inverse solve, the candidate, and A phi (K3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from dealii_slod_tpu.grid import cartesian_coords
from dealii_slod_tpu.grid import rev_dims as _rev
from dealii_slod_tpu_torch.ops.assembly import (assemble_bands,
                                                band_placement_matrix,
                                                bands_to_dense_mm,
                                                make_band_tensors,
                                                stencil_trace)
from dealii_slod_tpu_torch.ops.eig import jacobi_eigh_factor
from dealii_slod_tpu_torch.ops.patch_solve import (fused_spd_multirhs,
                                                   spd_inverse_schur)


@dataclasses.dataclass
class UniformTables:
    """Static per-canvas data shared by every patch (tensors on the
    solver's device)."""

    dim: int
    s: int
    n_nodes: int
    cD: int
    nI: int
    Hdim: float
    thr: float
    sweeps: int
    eig_tol: float
    eig_block: int
    center_cell: int
    grid_rev: tuple
    sub_dims: np.ndarray
    band_tensors: dict          # name -> (2^dim, nq, 3^dim, 1, 1)
    center_o: int
    placement: tuple            # (P, shift, nN) of the interior grid
    offs_flat: tuple
    shiftN: int
    node_coords: torch.Tensor   # (n_nodes, dim)
    sub_coords: torch.Tensor    # (n_sub, dim)
    cell_lo: torch.Tensor       # (cD, dim)
    int_coords: torch.Tensor    # (n_int, dim)
    nb_coords: torch.Tensor     # (n_int, 3^dim, dim) stencil neighbours
    PT: torch.Tensor            # (nD, cD)
    PT_I: torch.Tensor          # (nI, cD)

    @property
    def inner(self):
        return (slice(None),) + (slice(1, -1),) * self.dim


def uniform_tables(cfg, grid, et, sc, center_cell, device, dtype,
                   eig_block) -> UniformTables:
    dim, s = cfg.dim, cfg.n_subdivisions
    offs = cartesian_coords(np.full(dim, 3)) - 1
    node_dims = sc.node_dims_local
    strides = np.concatenate([[1], np.cumprod(node_dims[:-1])]).astype(int)
    int_coords = sc.node_coords_local[sc.interior_nodes]

    def ti(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def tf(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    P, shift, nN = band_placement_matrix(node_dims - 2)

    return UniformTables(
        dim=dim, s=s, n_nodes=sc.n_nodes_local,
        cD=sc.n_coarse_dofs_local, nI=len(sc.interior_nodes),
        Hdim=grid.H ** dim, thr=cfg.svd_threshold, sweeps=cfg.eig_sweeps,
        eig_tol=cfg.eig_tol, eig_block=eig_block, center_cell=center_cell,
        grid_rev=_rev(node_dims), sub_dims=sc.sub_dims_local.copy(),
        band_tensors={k: tf(v) for k, v in make_band_tensors(et).items()},
        center_o=int(np.nonzero((offs == 0).all(axis=1))[0][0]),
        placement=(tf(P), shift, nN),
        offs_flat=tuple(int(o) for o in offs @ strides),
        shiftN=int(strides.sum()),
        node_coords=ti(sc.node_coords_local), sub_coords=ti(sc.sub_coords),
        cell_lo=ti(cartesian_coords(sc.cell_dims_local) * s),
        int_coords=ti(int_coords),
        nb_coords=ti(int_coords[:, None, :] + offs[None, :, :]),
        PT=tf(sc.PT), PT_I=tf(sc.PT[sc.interior_dof_indices()]))


def _inside(coords, lo, hi, strict):
    """(B, n, dim) box test of ``coords`` (n, dim) or (n, o, dim) against
    per-patch bounds (B, dim), reduced over the dim axis."""
    shape = (lo.shape[0],) + (1,) * (coords.dim() - 1) + (lo.shape[1],)
    lo, hi = lo.view(shape), hi.view(shape)
    c = coords[None]
    ok = (c > lo) & (c < hi) if strict else (c >= lo) & (c <= hi)
    return ok.all(-1)


def prep(tab: UniformTables, coef, nlo, nhi):
    """Assembled operators and masks for a chunk of patch windows:
    ``band`` (B, nN, 3^dim) over all canvas nodes (unmasked, the operator
    the trace / premultiply products apply), ``A_solve`` (B, nI, nI) the
    window-interior SPD block (row-cleared reference operator, unit
    diagonal on masked rows, LOD.cc:537-546), ``PT_m`` (B, nI, cD) and the
    coarse-cell validity ``cvd`` (B, cD)."""
    dt = tab.PT.dtype
    in_sub = _inside(tab.sub_coords, nlo, nhi - 1, strict=False)
    coefs = {"alpha": coef * in_sub[..., None].to(dt)}
    node_int = _inside(tab.int_coords, nlo, nhi, strict=True)
    m = node_int.to(dt)                                       # (B, n_int)
    band = assemble_bands(coefs, tab.band_tensors, tab.sub_dims)
    B = band.shape[0]
    band_I = band.reshape((B,) + tab.grid_rev + (-1,))[tab.inner]
    band_I = band_I.reshape(B, tab.nI, -1)
    nb_in = _inside(tab.nb_coords, nlo, nhi, strict=True).to(dt)
    band_s = band_I * (m[:, :, None] * nb_in)
    band_s[:, :, tab.center_o] += 1.0 - m
    A_solve = bands_to_dense_mm(band_s, *tab.placement)
    cell_valid = ((tab.cell_lo[None] >= nlo[:, None])
                  & (tab.cell_lo[None] + tab.s <= nhi[:, None])).all(-1)
    cvd = cell_valid.to(dt)                                   # (B, cD)
    PT_m = tab.PT_I[None] * m[:, :, None] * cvd[:, None, :]
    return band, A_solve, PT_m, cvd


def edge_masks(tab: UniformTables, nlo, nhi, sides):
    """Per-node domain-boundary (id 0) and patch-boundary (id 99) flags of
    each patch window (B, nN); corners may be both (LODtools.h:367-369)."""
    nc = tab.node_coords[None]
    lo, hi = nlo[:, None, :], nhi[:, None, :]
    node_in = _inside(tab.node_coords, nlo, nhi, strict=False)
    on_lo, on_hi = nc == lo, nc == hi
    sd_lo, sd_hi = sides[:, None, 0::2], sides[:, None, 1::2]
    isdom = ((on_lo & sd_lo) | (on_hi & sd_hi)).any(-1) & node_in
    is99 = ((on_lo & ~sd_lo) | (on_hi & ~sd_hi)).any(-1) & node_in
    return isdom, is99


def scatter_interior(tab: UniformTables, v):
    """(B, nI, k) -> (B, nD, k) zero-extended onto the canvas nodes."""
    B, _, k = v.shape
    z = v.new_zeros((B,) + tab.grid_rev + (k,))
    z[tab.inner] = v.reshape((B,) + tuple(g - 2 for g in tab.grid_rev)
                             + (k,))
    return z.reshape(B, tab.n_nodes, k)


def stencil_apply(tab: UniformTables, band, X_int):
    """Y = A[:, interior] @ X through the nodal stencil (K3): band
    (B, nN, 3^dim), X (B, nI, k) -> (B, nN, k).  Wrap-around flat positions
    read the zero padding or carry zero band weight."""
    Xz = scatter_interior(tab, X_int)
    Xp = F.pad(Xz, (0, 0, tab.shiftN, tab.shiftN))[:, None]
    return stencil_trace(band.contiguous(), Xp, tab.shiftN,
                         tab.offs_flat)[:, 0]


def trace_S_chunk(tab: UniformTables, band, X, nlo, nhi, sides):
    """99-boundary trace product S = A X (reference boundary-trace rows,
    LOD.cc:520-528) -> (S99 (B, nD, k), is99d (B, nD))."""
    _, is99 = edge_masks(tab, nlo, nhi, sides)
    is99d = is99.to(X.dtype)
    return stencil_apply(tab, band, X) * is99d[:, :, None], is99d


def finish_pre_from_S(tab: UniformTables, S99, Tinv, cvd, is99d):
    """Gram G = diag(m) F diag(m) and projection g0 = m * F[:, cen] of the
    SLOD least squares, F = BD^T BD with BD = (S - PT_b) T^-1
    (LOD.cc:596-671).  Returns (B, 1, cD, cD) and (B, 1, cD)."""
    PT_b = tab.PT[None] * is99d[:, :, None] * cvd[:, None, :]
    BD = (S99 - PT_b) @ Tinv
    Fm = BD.mT @ BD
    cen = tab.center_cell
    onehot = torch.zeros(tab.cD, dtype=cvd.dtype, device=cvd.device)
    onehot[cen] = 1.0
    colmask = (1.0 - onehot)[None] * cvd
    G = Fm * colmask[:, :, None] * colmask[:, None, :]
    g0 = Fm[:, :, cen] * colmask
    return G[:, None], g0[:, None]


def _truncation_scan(d0, rev_terms):
    """The sigma-truncation conditioning loop (LOD.cc:703-725): starting at
    ``d0``, add the smallest-sigma contributions one by one while
    ||d||_inf >= 0.5.  The latched scan is evaluated at once: the partial
    sums of all prefixes, then the first that passes the test."""
    K = rev_terms.shape[1]
    partial = torch.cumsum(torch.cat([d0[:, None], rev_terms], dim=1), dim=1)
    ok = partial[:, :K].abs().amax(-1) < 0.5                   # (B, K)
    first = torch.where(ok.any(1), ok.to(torch.int8).argmax(1), K)
    return partial[torch.arange(d0.shape[0], device=d0.device), first]


def finish_post(tab: UniformTables, band, Ainv_PT, Tinv, lam, V, g0, cvd,
                nlo, nhi, sides):
    """Truncated pseudo-inverse solve, stabilized candidate, and the
    canvases phi, A_semi phi (LOD.cc:727-765) -> (B, nN, 1, 1) each."""
    isdom, _ = edge_masks(tab, nlo, nhi, sides)
    cen = tab.center_cell
    onehot = torch.zeros(tab.cD, dtype=cvd.dtype, device=cvd.device)
    onehot[cen] = 1.0
    colmask = (1.0 - onehot)[None] * cvd
    lam, V, g0 = lam[:, 0], V[:, 0], g0[:, 0]
    inv_sig = torch.where(lam > tab.thr * lam[:, :1], 1.0 / lam, 0.0)
    uv = torch.einsum("bij,bi->bj", V, g0)                    # V^T g0
    terms = (inv_sig * uv)[:, :, None] * V.mT                 # rows i
    dvec = _truncation_scan(-terms.sum(1), terms.flip(1))
    c = Tinv @ (onehot[None] + dvec * colmask)[:, :, None]    # (B, cD, 1)
    phi_int = Ainv_PT @ c                                     # (B, nI, 1)
    phi_int = phi_int / torch.sqrt((phi_int ** 2).sum(1, keepdim=True))
    phi = scatter_interior(tab, phi_int)
    # A_semi phi == A[:, interior] phi_int with domain-boundary rows zeroed
    Aphi = stencil_apply(tab, band, phi_int)
    Aphi = torch.where(isdom[:, :, None], 0.0, Aphi)
    B = phi.shape[0]
    return phi.reshape(B, tab.n_nodes, 1, 1), Aphi.reshape(B, tab.n_nodes,
                                                           1, 1)


def uniform_chunk(tab: UniformTables, coef, nlo, nhi, sides):
    """One chunk of patches: coefficient windows (B, n_sub, nq) and window
    data -> (Phi, APhi) canvases (B, nN, 1, 1) (``_uniform_chunk_fn``)."""
    band, A_solve, PT_m, cvd = prep(tab, coef, nlo, nhi)
    Ainv_PT, T_raw = fused_spd_multirhs(A_solve, PT_m)
    T = T_raw / tab.Hdim + torch.diag_embed(1.0 - cvd)
    Tinv = spd_inverse_schur(T)
    S99, is99d = trace_S_chunk(tab, band, Ainv_PT, nlo, nhi, sides)
    G, g0 = finish_pre_from_S(tab, S99, Tinv, cvd, is99d)
    B = G.shape[0]
    lam, V = jacobi_eigh_factor(G.reshape(B, tab.cD, tab.cD),
                                sweeps=tab.sweeps, tol=tab.eig_tol,
                                block=tab.eig_block)
    return finish_post(tab, band, Ainv_PT, Tinv, lam[:, None], V[:, None],
                       g0, cvd, nlo, nhi, sides)


def window_stack(X, win: int, s: int, ell: int):
    """Per-patch lattice windows: ``X`` (grid_1, ..., grid_dim, tail) on
    the full fine lattice (cells or nodes, array axes slowest-first) ->
    (P, win^dim, tail), for each patch the size-``win`` window anchored at
    ``(center - ell) * s`` per axis, zero outside the domain (pad + one
    strided unfold per axis)."""
    dim = X.dim() - 1
    pad = ell * s
    Xp = F.pad(X, (0, 0) + (pad, pad) * dim)
    for a in range(dim):
        Xp = Xp.unfold(a, win, s)      # (.., n_a, .., tail, w_0 .. w_a)
    Xp = Xp.permute(tuple(range(dim)) + tuple(range(dim + 1, 2 * dim + 1))
                    + (dim,))
    P = int(np.prod(Xp.shape[:dim]))
    return Xp.reshape(P, win ** dim, X.shape[-1])


def coef_windows(cfg, grid, coef):
    """Patch-subcell coefficient windows (n_fine_cells, nq) ->
    (P, n_sub, nq); out-of-domain subcells are zero."""
    win = (2 * cfg.oversampling + 1) * cfg.n_subdivisions
    X = coef.reshape(_rev(grid.fine_cell_dims) + (coef.shape[-1],))
    return window_stack(X, win, cfg.n_subdivisions, cfg.oversampling)


def rhs_windows(cfg, grid, fem_rhs):
    """Canvas-node windows of the fine rhs (n_nodes, C) -> (P, canvas_n,
    C); out-of-domain canvas nodes are zero (every consumer multiplies by a
    basis canvas that vanishes there)."""
    win = (2 * cfg.oversampling + 1) * cfg.n_subdivisions + 1
    X = fem_rhs.reshape(_rev(grid.node_dims) + (fem_rhs.shape[-1],))
    return window_stack(X, win, cfg.n_subdivisions, cfg.oversampling)
