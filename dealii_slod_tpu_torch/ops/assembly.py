"""Banded Q_iso_Q1 assembly, the dense scatter assembly, the global load
vector / fine operator, and kernels K3 / K7, the stencil trace
(counterpart of ``dealii_slod_tpu/ops/assembly.py``).

On the uniform subcell grid the patch stiffness is a 3^dim-point nodal
stencil of C x C blocks: ``band[i, o, c, d] = sum_{name, r, q}
coef_name[subcell(i, r), q] * T_name[r, q, o, c, d]`` with r the 2^dim
subcells adjacent to node i and T read off the reference element matrix
(``make_band_tensors``): ``alpha`` for scalar diffusion (C = 1), with
``creact`` (the mass tensor) for reaction-diffusion, ``lam`` and ``mu``
for linear elasticity (C = dim).  Everything downstream consumes the
band, flat as (nN, 3^dim * C * C) with column o*C*C + c*C + d; the
dense SPD interior block is placed from it by the banded-stride embedding
(``bands_to_dense_mm``), dofs interleaved as node * C + c.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dealii_slod_tpu_torch.grid import cartesian_coords
from dealii_slod_tpu_torch.utils import kernels
from dealii_slod_tpu_torch.ops import element

ElementTensors = element.ElementTensors


def make_band_tensors(et: ElementTensors) -> Dict[str, np.ndarray]:
    """Constant nodal-stencil tensors per coefficient name, name -> T of
    shape (2^dim, nq, 3^dim, C, C): T[r, q, o] = K[q, a(r), b(r, o)] with
    a(r) the local corner of the node in relative subcell r and
    b = a + delta_o (zero when b leaves the subcell)."""
    dim, C = et.dim, et.n_components
    m = 2 ** dim
    nq = m
    rs = cartesian_coords(np.full(dim, 2))
    offs = cartesian_coords(np.full(dim, 3)) - 1
    pow2 = 2 ** np.arange(dim)

    def band_of(K):
        K5 = K.reshape(nq, m, C, m, C)
        T = np.zeros((m, nq, len(offs), C, C))
        for ri, r in enumerate(rs):
            a_vec = 1 - r
            a = int(a_vec @ pow2)
            for oi, o in enumerate(offs):
                b_vec = a_vec + o
                if ((b_vec >= 0) & (b_vec <= 1)).all():
                    T[ri, :, oi] = K5[:, a, :, int(b_vec @ pow2), :]
        return T

    if C == 1:
        return {"alpha": band_of(et.K_grad), "creact": band_of(et.M)}
    return {"mu": band_of(et.K_mu), "lam": band_of(et.K_lam)}


def node_subcell_windows(coef: torch.Tensor, sub_dims) -> torch.Tensor:
    """Subcell coefficient windows around each node: ``coef``
    (B, n_sub, nq) on a grid of ``sub_dims`` subcells per axis (x-fastest)
    -> (B, n_nodes, 2^dim, nq), the 2^dim adjacent subcells of each node
    (r x-fastest, zero off the grid).  Pad + static slices."""
    dim = len(sub_dims)
    B, _, nq = coef.shape
    grid_rev = tuple(int(d) for d in np.asarray(sub_dims)[::-1])
    node_rev = tuple(d + 1 for d in grid_rev)
    c = coef.reshape((B,) + grid_rev + (nq,)).movedim(-1, 1)
    c = torch.nn.functional.pad(c, (1, 1) * dim)
    parts = []
    for r in cartesian_coords(np.full(dim, 2)):
        # array axes are (z, y, x): spatial axis a sits at array axis dim-a
        idx = (slice(None), slice(None)) + tuple(
            slice(int(r[a]), int(r[a]) + node_rev[dim - 1 - a])
            for a in range(dim - 1, -1, -1))
        parts.append(c[idx])
    W = torch.stack(parts, dim=2)                     # (B, nq, m, nodes..)
    return W.reshape(B, nq, len(parts), -1).permute(0, 3, 2, 1)


def assemble_bands(coefs: Dict[str, torch.Tensor], band_tensors,
                   sub_dims) -> torch.Tensor:
    """Nodal-stencil bands (B, n_nodes, 3^dim * C * C), flat column
    o*C*C + c*C + d, from subcell quadrature coefficients (B, n_sub, nq)
    per name (summed in the order of ``coefs``)."""
    out = None
    for name, coef in coefs.items():
        W = node_subcell_windows(coef, sub_dims)      # (B, n, r, q)
        T = torch.as_tensor(band_tensors[name], dtype=coef.dtype,
                            device=coef.device)
        T = T.reshape(T.shape[0], T.shape[1], -1)     # (r, q, o*C*C)
        term = torch.einsum("bnrq,rqx->bnx", W, T)
        out = term if out is None else out + term
    return out


def band_placement_matrix(node_dims) -> tuple:
    """Constant (3^dim, nN + 1) 0/1 placement matrix for the banded-stride
    embedding: column ``shift + s_o`` of a width-(nN+1) row buffer holds
    offset o (s_o = delta_o . strides, shift = sum strides).  Returns
    (P, shift, nN)."""
    dims = np.asarray(node_dims, dtype=int)
    strides = np.concatenate([[1], np.cumprod(dims[:-1])]).astype(int)
    offs = cartesian_coords(np.full(len(dims), 3)) - 1
    s = offs @ strides
    shift = int(strides.sum())
    nN = int(dims.prod())
    P = np.zeros((len(offs), nN + 1), np.float32)
    P[np.arange(len(offs)), s + shift] = 1.0
    return P, shift, nN


def bands_to_dense_mm(band: torch.Tensor, P, shift: int, nN: int,
                      n: int | None = None) -> torch.Tensor:
    """Dense (B, nN C, nN C) matrices from bands (B, nN, 3^dim) (C = 1) or
    (B, nN, 3^dim, C, C) by the banded-stride embedding.  Row group i (its
    C dense rows) is one width-C(W + 1) buffer row in which entry
    ((i, c), (i + delta_o, d)) sits at column c*W + (s_o + shift)*C + d
    (W the dense row width, nN C), and the dense matrix is one flat slice
    of the buffer from shift*C on (for C = 1: row i's width-(nN+1) block,
    ``band[i] @ P``).  P's rows are one-hot with distinct columns, so the
    values are placed by index (no multiply), each buffer entry at most
    once; wrap-around placements carry zero band values.  ``P`` may be a
    tensor on the band's device (no host copy per call).

    With ``n`` (>= nN C): the (B, n, n) operand that K1 factors in place
    (``ops/patch_solve.py: fused_spd_multirhs``), contiguous, the same
    values in its leading block, zeros beside it and a unit diagonal on
    the rows past nN C.  Where n > nN C the embedding runs at W = n, its
    buffer rows laid over the operand's own storage (a patch's nN rows of
    C(n + 1) fit its n x n block), so no dense copy is made; the diagonal
    is a fill, with no host scalar to copy.  At n = nN C the block is
    copied once into its contiguous operand."""
    Bn = band.shape[0]
    C = 1 if band.dim() == 3 else band.shape[-1]
    N = nN * C
    W = n or N
    cols = torch.as_tensor(P, device=band.device).argmax(1)
    if C > 1:
        cc = torch.arange(C, device=band.device)
        cols = (cc[None, :, None] * W + cols[:, None, None] * C
                + cc[None, None, :]).reshape(-1)      # (o, c, d) flat
    if W == N:
        buf = band.new_zeros((Bn, nN, C * (W + 1)))
        buf[:, :, cols] = band.reshape(Bn, nN, -1)
        A = buf.reshape(Bn, -1)[:, shift * C:shift * C + N * W].reshape(
            Bn, N, W)
        return A if n is None else A.contiguous()
    # the operand starts at a 64-element boundary of its storage, past the
    # first buffer row's shift * C leading entries
    lead = -(-shift * C // 64) * 64
    flat = band.new_zeros(lead + Bn * n * n)
    buf = flat.as_strided((Bn, nN, C * (n + 1)), (n * n, C * (n + 1), 1),
                          lead - shift * C)
    buf[:, :, cols] = band.reshape(Bn, nN, -1)
    out = flat[lead:].view(Bn, n, n)
    out.diagonal(dim1=1, dim2=2)[:, N:].fill_(1.0)
    return out


# ---------------------------------------------------------------------------
# K3 / K7: stencil trace
# ---------------------------------------------------------------------------

def stencil_trace_plain(band: torch.Tensor, Xp: torch.Tensor, shiftN: int,
                        offs_flat) -> torch.Tensor:
    """Plain version of K3 / K7: the 3^dim C^2-term shifted FMA chain
    S[b, c, n, :] = sum_{o, d} band[b, n, o*C*C + c*C + d]
    * Xp[b, d, n + shiftN + off_o, :], per c in (o, d) order."""
    B, C, _, k = Xp.shape
    nN = band.shape[1]
    bandr = band.reshape(B, nN, len(offs_flat), C, C)
    out = []
    for c in range(C):
        acc = None
        for oi, off in enumerate(offs_flat):
            s0 = shiftN + int(off)
            for d in range(C):
                t = bandr[:, :, oi, c, d, None] * Xp[:, d, s0:s0 + nN, :]
                acc = t if acc is None else acc + t
        out.append(acc)
    return torch.stack(out, dim=1)


def stencil_trace(band: torch.Tensor, Xp: torch.Tensor, shiftN: int,
                  offs_flat) -> torch.Tensor:
    """Kernels K3 (C = 1) and K7 (C = 2, 3) (replace ``dealii_slod_tpu/ops/
    assembly.py: stencil_trace_pallas``: C = 1 ``impl="c1"/"c1roll"``, and
    the C > 1 ``impl`` values, unrolled and offset-grid alike).

    band (B, nN, 3^dim * C * C) flat with column o*C*C + c*C + d, Xp
    (B, C, nNp, k) zero-padded by ``shiftN`` on the node axis -> S
    (B, C, nN, k).  A CPU tensor takes the plain version; a CUDA tensor
    launches ``csrc/stencil_trace.cu``."""
    if not Xp.is_cuda:
        return stencil_trace_plain(band, Xp, shiftN, offs_flat)
    B, C, nNp, k = Xp.shape
    nN, n_off = band.shape[1], len(offs_flat)
    if (C not in (1, 2, 3) or band.shape[0] != B
            or band.shape[2] != n_off * C * C or n_off > 27):
        raise ValueError(f"stencil_trace: band {tuple(band.shape)} and Xp "
                         f"{tuple(Xp.shape)} do not match (C in 1..3, <= 27 "
                         f"offsets)")
    offs = np.asarray([shiftN + int(o) for o in offs_flat], np.int32)
    if offs.min() < 0 or offs.max() + nN > nNp:
        raise ValueError("stencil_trace: shifted windows leave the padding")
    kernels.check_cuda("stencil_trace", band, Xp)
    S = torch.empty((B, C, nN, k), dtype=Xp.dtype, device=Xp.device)
    kernels.launch("K3 stencil_trace" if C == 1 else "K7 stencil_trace",
                   "slod_stencil_trace", Xp.dtype, Xp.device,
                   band.data_ptr(), Xp.data_ptr(), S.data_ptr(), B, C, nN,
                   nNp, k, n_off, offs.ctypes.data)
    return S


# ---------------------------------------------------------------------------
# Global fine grid: subcell matrices, load vector and the fine operator
# ---------------------------------------------------------------------------

def check_coefs(what: str, coefs) -> None:
    if set(coefs) not in ({"alpha"}, {"alpha", "creact"}, {"lam", "mu"}):
        raise ValueError(
            f"{what}: coefficients {sorted(coefs)}; a problem names "
            "'alpha' (diffusion), 'alpha' and 'creact' (reaction-"
            "diffusion) or 'lam' and 'mu' (elasticity)")


def make_subcell_matrices(et: ElementTensors,
                          coefs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-subcell element stiffness matrices from coefficient values
    (..., n_sub, nq): ``alpha`` (scalar diffusion; with ``creact`` the
    creact-weighted mass term is added, reaction-diffusion) or ``mu`` /
    ``lam`` (linear elasticity) -> (..., n_sub, m C, m C), local dof =
    node * C + component."""
    check_coefs("make_subcell_matrices", coefs)
    c0 = next(iter(coefs.values()))

    def t(a):
        return torch.as_tensor(a, dtype=c0.dtype, device=c0.device)

    if "alpha" in coefs:
        out = torch.einsum("...sq,qij->...sij", coefs["alpha"], t(et.K_grad))
        if "creact" in coefs:
            out = out + torch.einsum("...sq,qij->...sij", coefs["creact"],
                                     t(et.M))
        return out
    return (torch.einsum("...sq,qIJ->...sIJ", coefs["mu"], t(et.K_mu))
            + torch.einsum("...sq,qIJ->...sIJ", coefs["lam"], t(et.K_lam)))


def assemble_dense_batch(Ksub: torch.Tensor, flat_idx: torch.Tensor,
                         n_dofs: int) -> torch.Tensor:
    """Scatter-add each patch's subcell matrices (B, n_sub, mD, mD) into a
    dense (B, n_dofs, n_dofs) patch stiffness, unconstrained (reference
    ``assemble_dense`` / ``assemble_dense_batch``, LOD.cc:440-444);
    ``flat_idx`` holds the static row * n_dofs + col of every entry
    (``ShapeClass.assembly_flat_idx``).  On CUDA ``index_add_`` adds in no
    fixed order: the sums agree to rounding."""
    B = Ksub.shape[0]
    A = Ksub.new_zeros((B, n_dofs * n_dofs))
    A.index_add_(1, flat_idx, Ksub.reshape(B, -1))
    return A.reshape(B, n_dofs, n_dofs)


class FineOperator:
    """Matrix-free global Q_iso_Q1 stiffness operator on the fine grid:
    u -> scatter_add(conn, Ksub(coefs) @ gather(conn, u)), scalar diffusion
    (``alpha``), reaction-diffusion (``alpha``, ``creact``: the stiffness
    plus the creact-weighted mass term) or linear elasticity (``mu``,
    ``lam``).  With ``dirichlet_mask`` ((n_nodes,) bool, True on
    constrained nodes) the call is the constrained operator: zero boundary
    values in, identity rows out (the reference's AffineConstraints
    elimination)."""

    def __init__(self, et: ElementTensors, conn: torch.Tensor,
                 coefs: Dict[str, torch.Tensor],
                 dirichlet_mask: torch.Tensor | None = None):
        check_coefs("FineOperator", coefs)
        self.conn = conn.long()
        self.coefs = coefs
        self.dirichlet_mask = dirichlet_mask
        c0 = next(iter(coefs.values()))

        def t(a):
            return torch.as_tensor(a, dtype=c0.dtype, device=c0.device)

        self._K = {"alpha": t(et.K_grad)} if "alpha" in coefs else {
            "mu": t(et.K_mu), "lam": t(et.K_lam)}
        self._M = t(et.M) if "creact" in coefs else None

    def _apply_raw(self, u: torch.Tensor) -> torch.Tensor:
        """Unconstrained matvec, u: (n_nodes, C) -> (n_nodes, C)."""
        if "alpha" in self.coefs:
            ue = u[self.conn, 0]                             # (n_sub, m)
            out_s = torch.einsum("sq,qij,sj->si", self.coefs["alpha"],
                                 self._K["alpha"], ue)
            if self._M is not None:
                out_s = out_s + torch.einsum("sq,qij,sj->si",
                                             self.coefs["creact"], self._M,
                                             ue)
            out = torch.zeros_like(u[:, 0])
            out.index_add_(0, self.conn.reshape(-1), out_s.reshape(-1))
            return out[:, None]
        ue = u[self.conn]                                    # (n_sub, m, C)
        uflat = ue.reshape(ue.shape[0], -1)                  # (n_sub, m C)
        out_flat = None
        for name in ("mu", "lam"):
            Ksub = torch.einsum("sq,qIJ->sIJ", self.coefs[name],
                                self._K[name])
            term = torch.einsum("sIJ,sJ->sI", Ksub, uflat)
            out_flat = term if out_flat is None else out_flat + term
        out = torch.zeros_like(u)
        out.index_add_(0, self.conn.reshape(-1),
                       out_flat.reshape(-1, u.shape[1]))
        return out

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        """Constrained matvec: the interior operator on interior dofs,
        identity rows on Dirichlet dofs."""
        if self.dirichlet_mask is None:
            return self._apply_raw(u)
        mask = self.dirichlet_mask[:, None]
        out = self._apply_raw(torch.where(mask, 0.0, u))
        return torch.where(mask, u, out)

    def diagonal(self) -> torch.Tensor:
        """Assembled matrix diagonal (n_nodes, C), 1 on Dirichlet dofs (the
        Jacobi preconditioner)."""
        n_nodes = (len(self.dirichlet_mask) if self.dirichlet_mask is not None
                   else int(self.conn.max()) + 1)
        if "alpha" in self.coefs:
            dloc = torch.einsum("sq,qii->si", self.coefs["alpha"],
                                self._K["alpha"])
            if self._M is not None:
                dloc = dloc + torch.einsum("sq,qii->si",
                                           self.coefs["creact"], self._M)
            dloc = dloc[..., None]
        else:
            dloc = sum(torch.einsum("sq,qII->sI", self.coefs[name],
                                    self._K[name])
                       for name in ("mu", "lam"))
            dloc = dloc.reshape(dloc.shape[0], self.conn.shape[1], -1)
        d = dloc.new_zeros((n_nodes, dloc.shape[-1]))
        d.index_add_(0, self.conn.reshape(-1),
                     dloc.reshape(-1, dloc.shape[-1]))
        if self.dirichlet_mask is not None:
            d = torch.where(self.dirichlet_mask[:, None], 1.0, d)
        return d


def assemble_load_vector(et: ElementTensors, conn: torch.Tensor,
                         f_q: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Global load vector rhs[i, c] = int phi_i f_c from ``f_q``
    (n_fine_cells, nq, C) right-hand-side values at quadrature points."""
    R = torch.as_tensor(et.R, dtype=f_q.dtype, device=f_q.device)
    rhs_e = torch.einsum("qi,sqc->sic", R, f_q)              # (n_sub, m, C)
    rhs = f_q.new_zeros((n_nodes, f_q.shape[-1]))
    rhs.index_add_(0, conn.long().reshape(-1),
                   rhs_e.reshape(-1, f_q.shape[-1]))
    return rhs
