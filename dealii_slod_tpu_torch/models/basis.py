"""Batched SLOD basis construction on the padded canvas — the hot
per-patch loop (counterpart of ``dealii_slod_tpu/models/basis.py``: the
uniform kernel's chunk form, ``_uniform_chunk_fn``), for scalar
diffusion (C = 1) and linear elasticity (C = dim): plain LOD, or SLOD with
the smallk, Jacobi or ``eigh`` spectral stage.  Dofs are
node-major with the components interleaved (node * C + c); the trace works
on (B, C, nN, k).

Every patch is padded to the full (2l+1)-cell canvas window and its real
window is described by data (``nlo``/``nhi`` node bounds, domain-side
flags): fake subcells get zero coefficients, fake and boundary dofs
identity rows, fake coarse cells an identity diagonal in the triple
product.  Each function below works on a batch (chunk) of B patches.

Per chunk (reference source/LOD.cc:296-768):

1. ``prep``: bands (or, with ``assembly_mode="scatter"``, the dense
   interior rows of the scatter-added stiffness), the SPD interior block
   A, the masked projection PT;
2. X = A^-1 PT and T = PT^T X (K1, the Schur split with K6 leaves, the
   panel LDL^T with K2 on its diagonal blocks, or ``patch_solver="lax"``'s
   per-patch Cholesky solve), T^-1 (K2, blocked beyond 128);
3. SLOD only: the patch-boundary trace S = A X (K3 / K7; under
   ``trace_kernel="off"`` their plain version; with the scatter
   assembly a contraction of the dense rows) and the Gram
   F = BD^T BD, C Grams per patch from one F;
4. SLOD only: the stabilization coefficients dvec on the B C Grams: the
   smallk stage (K2, K4, K5 or K8 on the smallest directions), the Jacobi
   stage (K5 on the Gram's Cholesky factor) or the ``eigh`` stage
   (``eig_solver="lapack"`` / ``"lax"``: the Gram's full eigendecomposition
   by ``torch.linalg.eigh``, as JAX computes it in XLA), each but smallk
   followed by the truncated pseudo-inverse solve;
5. the C candidates (plain LOD: X T^-1 at the centre dofs) and A phi
   (as the trace).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from dealii_slod_tpu_torch.grid import cartesian_coords
from dealii_slod_tpu_torch.grid import rev_dims as _rev
from dealii_slod_tpu_torch.ops.assembly import (assemble_bands,
                                                assemble_dense_batch,
                                                band_placement_matrix,
                                                bands_to_dense_mm,
                                                make_band_tensors,
                                                make_subcell_matrices,
                                                stencil_trace,
                                                stencil_trace_plain)
from dealii_slod_tpu_torch.ops.eig import (_truncation_scan,
                                           jacobi_eigh_factor,
                                           smallk_truncated_dvec)
from dealii_slod_tpu_torch.ops.patch_solve import (fused_spd_multirhs,
                                                   fused_spd_multirhs_plain,
                                                   fused_spd_multirhs_split,
                                                   k1_operand_n,
                                                   panel_spd_multirhs,
                                                   spd_inverse_schur)
from dealii_slod_tpu_torch.utils.timers import count, span

# coefficient windows of one coefficient beyond this size are cut per chunk
# under ``window_chunk="auto"`` (the reference's _WINDOW_SLAB_BYTES)
WINDOW_SLAB_BYTES = 256 * 2 ** 20


def smallk_k_eff(cD: int, dtype: torch.dtype, smallk_dirs: int) -> int:
    """Direction count of the smallk spectral stage: all directions for
    small Grams (cD <= 64) and in float64 (where the jitter floor does not
    stop the truncation loop early, so a capped k could run out of
    directions), else ``smallk_dirs``."""
    return cD if (cD <= 64 or dtype == torch.float64) else smallk_dirs


@dataclasses.dataclass
class UniformTables:
    """Static per-canvas data shared by every patch (tensors on the
    solver's device)."""

    dim: int
    s: int
    C: int                      # solution components
    n_nodes: int
    cD: int                     # coarse dofs (cells * C)
    n_int: int                  # interior canvas nodes
    nI: int                     # interior dofs (n_int * C)
    solver_mode: str            # "fused" (K1), "fused_split" (K6 leaves),
                                # "panel" (K2 diagonal blocks) or "lax"
                                # (per-patch Cholesky)
    k1_n: int                   # prep's A_solve: K1's padded (B, k1_n,
                                # k1_n) operand, factored in place (the
                                # card's "fused" route), or 0: (B, nI, nI)
    panel_nb: int               # split rule / panel block size
    scatter: bool               # assembly_mode "scatter": dense rows
    trace_kernel: bool          # K3 / K7 (else the plain scan, "off")
    Hdim: float
    thr: float
    sweeps: int
    eig_tol: float
    eig_block: int | None       # plain-version stop sharing (None: as JAX)
    slod: bool                  # SLOD stabilization (else plain LOD)
    spec_mode: str              # "smallk", "jacobi", "lapack" or "lax"
    k_eff: int                  # smallk directions
    smallk_power: int
    smallk_tol: float
    smallk_weig: bool
    center_cell: int
    grid_rev: tuple
    sub_dims: np.ndarray
    band_tensors: dict          # name -> (2^dim, nq, 3^dim, C, C)
    et: object                  # element tensors (the scatter assembly)
    flat_idx: torch.Tensor      # scatter-add targets of the subcells
    coef_names: list            # sorted coefficient names (band sum order)
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
                   eig_block, spec_mode, solver_mode,
                   coef_names) -> UniformTables:
    dim, s, C = cfg.dim, cfg.n_subdivisions, et.n_components
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
        dim=dim, s=s, C=C, n_nodes=sc.n_nodes_local,
        cD=sc.n_coarse_dofs_local, n_int=len(sc.interior_nodes),
        nI=len(sc.interior_nodes) * C, solver_mode=solver_mode,
        k1_n=(k1_operand_n(len(sc.interior_nodes) * C)
              if solver_mode == "fused" and torch.device(device).type
              == "cuda" else 0),
        panel_nb=cfg.panel_nb, scatter=cfg.assembly_mode != "banded",
        trace_kernel=cfg.trace_kernel in ("auto", "on"),
        Hdim=grid.H ** dim, thr=cfg.svd_threshold, sweeps=cfg.eig_sweeps,
        eig_tol=cfg.eig_tol, eig_block=eig_block,
        slod=bool(cfg.lod_stabilization and cfg.oversampling > 0),
        spec_mode=spec_mode,
        k_eff=smallk_k_eff(sc.n_coarse_dofs_local, dtype, cfg.smallk_dirs),
        smallk_power=cfg.smallk_power, smallk_tol=cfg.smallk_tol,
        smallk_weig=cfg.smallk_weig, center_cell=center_cell,
        grid_rev=_rev(node_dims), sub_dims=sc.sub_dims_local.copy(),
        band_tensors={k: tf(v) for k, v in make_band_tensors(et).items()},
        et=et, flat_idx=ti(sc.assembly_flat_idx),
        coef_names=list(coef_names),
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


def prep(tab: UniformTables, coefs, nlo, nhi):
    """Assembled operators and masks for a chunk of patch windows from the
    coefficient windows ``coefs`` (name -> (B, n_sub, nq)): the operator
    ``op`` that the trace and A phi apply (``apply_A``: the band (B, nN,
    3^dim C^2) over all canvas nodes, unmasked; under
    ``assembly_mode="scatter"`` the dense interior rows A_rows_I (B, nI,
    nD)), ``A_solve`` (B, nI, nI) the window-interior SPD block
    (row-cleared reference operator, unit diagonal on masked rows,
    LOD.cc:537-546; where ``tab.k1_n`` is set, assembled as K1's padded
    operand (B, k1_n, k1_n), ``ops/assembly.py: bands_to_dense_mm``),
    ``PT_m`` (B, nI, cD) and the coarse-dof validity ``cvd`` (B, cD)."""
    dt, C = tab.PT.dtype, tab.C
    in_sub = _inside(tab.sub_coords, nlo, nhi - 1, strict=False)
    coefs = {k: coefs[k] * in_sub[..., None].to(dt) for k in tab.coef_names}
    node_int = _inside(tab.int_coords, nlo, nhi, strict=True)
    m = node_int.to(dt)                                       # (B, n_int)
    m_d = m.repeat_interleave(C, dim=1)                       # (B, nI)
    cell_valid = ((tab.cell_lo[None] >= nlo[:, None])
                  & (tab.cell_lo[None] + tab.s <= nhi[:, None])).all(-1)
    cvd = cell_valid.to(dt).repeat_interleave(C, dim=1)       # (B, cD)
    PT_m = tab.PT_I[None] * m_d[:, :, None] * cvd[:, None, :]
    if tab.scatter:
        op, A_solve = _prep_scatter(tab, coefs, m_d)
        return op, A_solve, PT_m, cvd
    band = assemble_bands(coefs, tab.band_tensors, tab.sub_dims)
    B = band.shape[0]
    band_I = band.reshape((B,) + tab.grid_rev + (-1,))[tab.inner]
    band_I = band_I.reshape(B, tab.n_int, -1, C, C)
    nb_in = _inside(tab.nb_coords, nlo, nhi, strict=True).to(dt)
    band_s = band_I * (m[:, :, None] * nb_in)[..., None, None]
    eye = torch.eye(C, dtype=dt, device=band.device)
    band_s[:, :, tab.center_o] += eye * (1.0 - m)[:, :, None, None]
    A_solve = bands_to_dense_mm(band_s, *tab.placement, n=tab.k1_n or None)
    return band, A_solve, PT_m, cvd


def _prep_scatter(tab: UniformTables, coefs, m_d):
    """The scatter assembly's operators (``assembly_mode="scatter"``): the
    subcell matrices scatter-added into the dense canvas stiffness, its
    interior rows A_rows_I (B, nI, nD) and the masked interior block
    A_solve (B, nI, nI), or K1's padded operand (B, k1_n, k1_n) where
    ``tab.k1_n`` is set (the block written into its leading corner)."""
    Ksub = make_subcell_matrices(tab.et, coefs)
    B, nD, nI = Ksub.shape[0], tab.n_nodes * tab.C, tab.nI
    A = assemble_dense_batch(Ksub, tab.flat_idx, nD)
    rows = A.reshape((B,) + tab.grid_rev + (tab.C, nD))[tab.inner]
    rows = rows.reshape(B, nI, nD)
    A_II = rows.reshape((B, nI) + tab.grid_rev + (tab.C,))[
        (slice(None),) + tab.inner].reshape(B, nI, nI)
    if not tab.k1_n:
        A_solve = (A_II * m_d[:, :, None] * m_d[:, None, :]
                   + torch.diag_embed(1.0 - m_d))
        return rows, A_solve
    A_solve = A_II.new_zeros((B, tab.k1_n, tab.k1_n))
    torch.mul(A_II * m_d[:, :, None], m_d[:, None, :],
              out=A_solve[:, :nI, :nI])
    diag = A_solve.diagonal(dim1=1, dim2=2)
    diag[:, :nI] += 1.0 - m_d
    diag[:, nI:].fill_(1.0)
    return rows, A_solve


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
    """(B, nI, k) -> (B, nD, k) zero-extended onto the canvas dofs."""
    B, _, k = v.shape
    z = v.new_zeros((B,) + tab.grid_rev + (tab.C, k))
    z[tab.inner] = v.reshape((B,) + tuple(g - 2 for g in tab.grid_rev)
                             + (tab.C, k))
    return z.reshape(B, tab.n_nodes * tab.C, k)


def stencil_apply(tab: UniformTables, band, X_int):
    """Y = A[:, interior] @ X through the nodal stencil (K3 / K7; under
    ``trace_kernel="off"`` their plain version, the scan of ordinary
    tensor ops that JAX runs in XLA, one accumulator per component): band
    (B, nN, 3^dim C^2), X (B, nI, k) -> (B, nD, k).  The dofs go to the
    trace's (B, C, nN, k) layout and back.  Wrap-around flat positions read
    the zero padding or carry zero band weight."""
    B, _, k = X_int.shape
    C, nN = tab.C, tab.n_nodes
    Xz = scatter_interior(tab, X_int).reshape(B, nN, C, k).transpose(1, 2)
    Xp = F.pad(Xz, (0, 0, tab.shiftN, tab.shiftN))
    trace = stencil_trace if tab.trace_kernel else stencil_trace_plain
    S = trace(band.contiguous(), Xp.contiguous(), tab.shiftN,
              tab.offs_flat)                                  # (B, C, nN, k)
    return S.transpose(1, 2).reshape(B, nN * C, k)


def apply_A(tab: UniformTables, op, X_int):
    """Y = A[:, interior] @ X (B, nI, k) -> (B, nD, k) with the operator
    ``prep`` returned: the band through ``stencil_apply``, or the dense
    interior rows A_rows_I contracted (their transpose is A[:, interior]
    by symmetry; ``assembly_mode="scatter"``)."""
    if tab.scatter:
        return torch.einsum("bin,bik->bnk", op, X_int)
    return stencil_apply(tab, op, X_int)


def trace_S_chunk(tab: UniformTables, band, X, nlo, nhi, sides):
    """99-boundary trace product S = A X (reference boundary-trace rows,
    LOD.cc:520-528) -> (S99 (B, nD, k), is99d (B, nD))."""
    _, is99 = edge_masks(tab, nlo, nhi, sides)
    is99d = is99.to(X.dtype).repeat_interleave(tab.C, dim=1)
    return apply_A(tab, band, X) * is99d[:, :, None], is99d


def _center_masks(tab: UniformTables, cvd):
    """One-hot columns of the C central coarse dofs (cD, C) and the
    per-component column masks (1 - onehot) * cvd (B, cD, C)."""
    cens = tab.center_cell * tab.C + torch.arange(tab.C, device=cvd.device)
    ar = torch.arange(tab.cD, device=cvd.device)
    onehots = (ar[:, None] == cens[None, :]).to(cvd.dtype)
    return onehots, (1.0 - onehots)[None] * cvd[:, :, None]


def finish_pre_from_S(tab: UniformTables, S99, Tinv, cvd, is99d):
    """Grams G_d = diag(m_d) F diag(m_d) and projections g0_d = m_d *
    F[:, cen_d] of the SLOD least squares, one per component d, from one
    F = BD^T BD with BD = (S - PT_b) T^-1 (LOD.cc:596-671).  Returns
    (B, C, cD, cD) and (B, C, cD)."""
    PT_b = tab.PT[None] * is99d[:, :, None] * cvd[:, None, :]
    BD = (S99 - PT_b) @ Tinv
    Fm = BD.mT @ BD
    _, colmasks = _center_masks(tab, cvd)
    Gs, g0s = [], []
    for d in range(tab.C):
        cm = colmasks[:, :, d]
        Gs.append(Fm * cm[:, :, None] * cm[:, None, :])
        g0s.append(Fm[:, :, tab.center_cell * tab.C + d] * cm)
    return torch.stack(Gs, dim=1), torch.stack(g0s, dim=1)


def jacobi_dvec(tab: UniformTables, lam, V, g0):
    """Stabilization coefficients from the Gram's full eigendecomposition
    (the Jacobi or the eigh stage): the truncated pseudo-inverse solve and
    the sigma-truncation loop (LOD.cc:667-725).  lam (B, cD) descending, V
    (B, cD, cD), g0 (B, cD) -> dvec (B, cD)."""
    inv_sig = torch.where(lam > tab.thr * lam[:, :1], 1.0 / lam, 0.0)
    uv = torch.einsum("bij,bi->bj", V, g0)                    # V^T g0
    terms = (inv_sig * uv)[:, :, None] * V.mT                 # rows i
    return _truncation_scan(-terms.sum(1), terms.flip(1))


def finish_post_dvec(tab: UniformTables, band, Ainv_PT, Tinv, dvec, cvd,
                     nlo, nhi, sides):
    """The C stabilized candidates from the coefficients dvec (B, C, cD),
    all in one matmul chain, and the canvases phi, A_semi phi
    (LOD.cc:727-765) -> (B, nN, C, C) each.  ``dvec`` None is plain LOD:
    the one-hot columns alone, phi = X T^-1 at the centre dofs
    (LOD.cc:727-757 without the stabilization)."""
    isdom, _ = edge_masks(tab, nlo, nhi, sides)
    onehots, colmasks = _center_masks(tab, cvd)
    Dm = onehots[None] if dvec is None else \
        onehots[None] + dvec.mT * colmasks                    # (B, cD, C)
    phi_int = Ainv_PT @ (Tinv @ Dm)                           # (B, nI, C)
    phi_int = phi_int / torch.sqrt((phi_int ** 2).sum(1, keepdim=True))
    phi = scatter_interior(tab, phi_int)
    # A_semi phi == A[:, interior] phi_int with domain-boundary rows zeroed
    Aphi = apply_A(tab, band, phi_int)
    isdom_d = isdom.repeat_interleave(tab.C, dim=1)
    Aphi = torch.where(isdom_d[:, :, None], 0.0, Aphi)
    B, C = phi.shape[0], tab.C
    return (phi.reshape(B, tab.n_nodes, C, C),
            Aphi.reshape(B, tab.n_nodes, C, C))


def patch_solve(tab: UniformTables, A_solve, PT_m):
    """(X = A^-1 PT, T = PT^T X) by K1 (``"fused"``; where ``tab.k1_n``
    is set, on its padded operand, factored in place), by the Schur split
    with K6 leaves (``"fused_split"``), by the panel LDL^T with K2 on its
    diagonal blocks (``"panel"``) or by a per-patch Cholesky solve
    (``"lax"``: XLA's Cholesky in the reference, the library's here).
    Counts the chunk's patches (``patch_solve.patches``) and, where K1
    took the whole block in place, ``patch_solve.whole_block``."""
    count("patch_solve.patches", PT_m.shape[0])
    if tab.k1_n:
        count("patch_solve.whole_block", PT_m.shape[0])
        return fused_spd_multirhs(A_solve, PT_m, in_place=True)
    if tab.solver_mode == "fused_split":
        return fused_spd_multirhs_split(A_solve, PT_m, nb=tab.panel_nb)
    if tab.solver_mode == "panel":
        return panel_spd_multirhs(A_solve, PT_m, nb=tab.panel_nb)
    if tab.solver_mode == "lax":
        return fused_spd_multirhs_plain(A_solve, PT_m)
    return fused_spd_multirhs(A_solve, PT_m)


def spectral_dvec(tab: UniformTables, G, g0):
    """The stabilization coefficients (B C, cD) of the Grams G (B C, cD,
    cD) and projections g0 (B C, cD) by the stage ``tab.spec_mode``
    names."""
    if tab.spec_mode == "smallk":
        return smallk_truncated_dvec(G, g0, k=tab.k_eff,
                                     power_steps=tab.smallk_power,
                                     small_tol=tab.smallk_tol,
                                     weig_fused=tab.smallk_weig,
                                     block=tab.eig_block)
    if tab.spec_mode == "jacobi":
        lam, V = jacobi_eigh_factor(G, sweeps=tab.sweeps, tol=tab.eig_tol,
                                    block=tab.eig_block or 16)
    else:
        # the eigh stage: G is PSD, so its eigenpairs are its singular
        # triplets (descending, as the reference reorders them)
        lam, V = torch.linalg.eigh(G)
        if G.is_cuda:
            count("host_syncs", 1)  # the card's eigh checks its result
        lam, V = lam.flip(-1), V.flip(-1)
    return jacobi_dvec(tab, lam, V, g0)


def uniform_chunk(tab: UniformTables, coefs, nlo, nhi, sides, out):
    """One chunk of patches: coefficient windows (name -> (B, n_sub, nq))
    and window data -> the (Phi, APhi) canvases (B, nN, C, C), written into
    ``out`` = (Phi rows, APhi rows) (``_uniform_chunk_fn``).  Its stages
    are the spans ``assemble``, ``patch_solve``, ``stabilize`` (SLOD only)
    and ``canvas`` (``utils/timers``)."""
    with span("assemble"):
        band, A_solve, PT_m, cvd = prep(tab, coefs, nlo, nhi)
    with span("patch_solve"):
        Ainv_PT, T_raw = patch_solve(tab, A_solve, PT_m)
        del A_solve
        T = T_raw / tab.Hdim + torch.diag_embed(1.0 - cvd)
        Tinv = spd_inverse_schur(T)
    dvec = None
    if tab.slod:
        with span("stabilize"):
            S99, is99d = trace_S_chunk(tab, band, Ainv_PT, nlo, nhi, sides)
            G, g0 = finish_pre_from_S(tab, S99, Tinv, cvd, is99d)
            del S99
            B, C = G.shape[:2]
            dvec = spectral_dvec(tab, G.reshape(B * C, tab.cD, tab.cD),
                                 g0.reshape(B * C, tab.cD)).reshape(
                                     B, C, tab.cD)
    with span("canvas"):
        phi, aphi = finish_post_dvec(tab, band, Ainv_PT, Tinv, dvec, cvd,
                                     nlo, nhi, sides)
        out[0].copy_(phi)
        out[1].copy_(aphi)


def window_stack(X, win: int, s: int, ell: int):
    """Per-patch lattice windows: ``X`` (grid_1, ..., grid_dim, tail) on
    the full fine lattice (cells or nodes, array axes slowest-first) ->
    (P, win^dim, tail), for each patch the size-``win`` window anchored at
    ``(center - ell) * s`` per axis, zero outside the domain (pad + one
    strided unfold per axis)."""
    dim = X.dim() - 1
    pad = ell * s
    return _unfold_windows(F.pad(X, (0, 0) + (pad, pad) * dim), win, s)


def _unfold_windows(Xp, win: int, s: int):
    """The size-``win`` windows at stride ``s`` of the padded lattice Xp
    (n_1, ..., n_dim, tail) -> (windows, win^dim, tail), x fastest."""
    dim = Xp.dim() - 1
    tail = Xp.shape[-1]
    for a in range(dim):
        Xp = Xp.unfold(a, win, s)      # (.., n_a, .., tail, w_0 .. w_a)
    Xp = Xp.permute(tuple(range(dim)) + tuple(range(dim + 1, 2 * dim + 1))
                    + (dim,))
    P = int(np.prod(Xp.shape[:dim]))
    return Xp.reshape(P, win ** dim, tail)


def coef_lattice(cfg, grid, coef):
    """The zero-padded fine-cell coefficient lattice (grid_1 + 2p, ...,
    grid_dim + 2p, nq), p = l s: the source of ``window_stack_chunk``."""
    pad = cfg.oversampling * cfg.n_subdivisions
    X = coef.reshape(_rev(grid.fine_cell_dims) + (coef.shape[-1],))
    return F.pad(X, (0, 0) + (pad, pad) * cfg.dim)


def window_chunk_rows(cfg, B: int, n_chunks: int):
    """Patch x-rows per chunk where each of ``n_chunks`` equal chunks of
    the B lex-ordered patches covers whole consecutive x-rows of the full
    patch lattice, without straddling a z-plane in 3D; else None."""
    N = cfg.n_coarse
    if cfg.dim < 2 or B != N ** cfg.dim or n_chunks <= 1:
        return None
    chunk, rem = divmod(B, n_chunks)
    if rem or chunk % N:
        return None
    R = chunk // N
    if cfg.dim == 3 and N % R:
        return None
    return R


def window_stack_chunk(Xpad, chunk_idx: int, R: int, win: int, s: int):
    """The coefficient windows of chunk ``chunk_idx`` of ``R`` patch
    x-rows (``window_chunk_rows``), cut from the padded lattice Xpad
    (``coef_lattice``) -> (R N, win^dim, tail): the rows of
    ``coef_windows`` for those patches, bit for bit (the same unfold on
    the chunk's sub-lattice)."""
    dim = Xpad.dim() - 1
    nx = Xpad.shape[-2]
    if dim == 2:
        y0 = chunk_idx * R
        sub = Xpad[y0 * s:y0 * s + s * (R - 1) + win]
    else:
        rows = chunk_idx * R
        N = (nx - win) // s + 1
        z0, y0 = rows // N, rows % N
        sub = Xpad[z0 * s:z0 * s + win, y0 * s:y0 * s + s * (R - 1) + win]
    return _unfold_windows(sub, win, s)


def window_rows(Xpad, rows: tuple, win: int, s: int):
    """Rows [a, b) of ``_unfold_windows(Xpad, win, s)`` (the windows of
    patches a .. b-1 in lex order), cut from the planes of the slowest
    axis that they touch: a patch range's windows without the others'."""
    a, b = rows
    n_w = [(n - win) // s + 1 for n in Xpad.shape[:-1]]
    plane = int(np.prod(n_w[1:]))
    z0, z1 = a // plane, (b - 1) // plane + 1
    sub = Xpad[z0 * s:(z1 - 1) * s + win]
    return _unfold_windows(sub, win, s)[a - z0 * plane:b - z0 * plane]


def coef_windows(cfg, grid, coef, rows: tuple | None = None):
    """Patch-subcell coefficient windows (n_fine_cells, nq) ->
    (P, n_sub, nq); out-of-domain subcells are zero.  ``rows`` = [a, b):
    only patches a .. b-1."""
    win = (2 * cfg.oversampling + 1) * cfg.n_subdivisions
    if rows is not None:
        return window_rows(coef_lattice(cfg, grid, coef), rows, win,
                           cfg.n_subdivisions)
    X = coef.reshape(_rev(grid.fine_cell_dims) + (coef.shape[-1],))
    return window_stack(X, win, cfg.n_subdivisions, cfg.oversampling)


def rhs_windows(cfg, grid, fem_rhs, rows: tuple | None = None):
    """Canvas-node windows of the fine rhs (n_nodes, C) -> (P, canvas_n,
    C); out-of-domain canvas nodes are zero (every consumer multiplies by a
    basis canvas that vanishes there).  ``rows`` as ``coef_windows``."""
    win = (2 * cfg.oversampling + 1) * cfg.n_subdivisions + 1
    X = fem_rhs.reshape(_rev(grid.node_dims) + (fem_rhs.shape[-1],))
    if rows is not None:
        pad = cfg.oversampling * cfg.n_subdivisions
        return window_rows(F.pad(X, (0, 0) + (pad, pad) * cfg.dim), rows,
                           win, cfg.n_subdivisions)
    return window_stack(X, win, cfg.n_subdivisions, cfg.oversampling)
