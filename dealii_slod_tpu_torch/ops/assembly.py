"""Banded Q_iso_Q1 assembly, the global load vector / fine operator, and
kernel K3, the stencil trace (counterpart of ``dealii_slod_tpu/ops/
assembly.py``).

On the uniform subcell grid the patch stiffness is a 3^dim-point nodal
stencil: ``band[i, o] = sum_{r, q} alpha[subcell(i, r), q] * T[r, q, o]``
with r the 2^dim subcells adjacent to node i and T read off the reference
element matrix (``make_band_tensors``).  Everything downstream consumes the
band; the dense SPD interior block is placed from it by the banded-stride
embedding (``bands_to_dense_mm``).  Scalar problems (C = 1) only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dealii_slod_tpu.grid import cartesian_coords
from dealii_slod_tpu_torch.utils import kernels
from dealii_slod_tpu_torch.utils.reference import element

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
    """Nodal-stencil bands (B, n_nodes, 3^dim) of scalar problems from
    subcell quadrature coefficients (B, n_sub, nq) per name."""
    out = None
    for name, coef in coefs.items():
        W = node_subcell_windows(coef, sub_dims)      # (B, n, r, q)
        T = torch.as_tensor(band_tensors[name][..., 0, 0], dtype=coef.dtype,
                            device=coef.device)
        term = torch.einsum("bnrq,rqo->bno", W, T)
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


def bands_to_dense_mm(band: torch.Tensor, P, shift: int, nN: int
                      ) -> torch.Tensor:
    """Dense (B, nN, nN) matrices from bands (B, nN, 3^dim) by the
    banded-stride embedding: row i's width-(nN+1) buffer block is
    ``band[i] @ P`` and the dense matrix is one flat slice of the
    (nN, nN+1) buffer.  P's rows are one-hot with distinct columns, so the
    product is placed by index (the same values, no multiply).  ``P`` may
    be a tensor on the band's device (no host copy per call)."""
    Bn = band.shape[0]
    cols = torch.as_tensor(P, device=band.device).argmax(1)
    buf = band.new_zeros((Bn, nN, nN + 1))
    buf[:, :, cols] = band
    return buf.reshape(Bn, -1)[:, shift:shift + nN * nN].reshape(Bn, nN, nN)


# ---------------------------------------------------------------------------
# K3: stencil trace
# ---------------------------------------------------------------------------

def stencil_trace_plain(band: torch.Tensor, Xp: torch.Tensor, shiftN: int,
                        offs_flat) -> torch.Tensor:
    """Plain version of K3: the 3^dim-term shifted FMA chain
    S[b, 0, n, :] = sum_o band[b, n, o] * Xp[b, 0, n + shiftN + off_o, :]."""
    nN = band.shape[1]
    acc = None
    for oi, off in enumerate(offs_flat):
        s0 = shiftN + int(off)
        t = band[:, :, oi, None] * Xp[:, 0, s0:s0 + nN, :]
        acc = t if acc is None else acc + t
    return acc[:, None]


def stencil_trace(band: torch.Tensor, Xp: torch.Tensor, shiftN: int,
                  offs_flat) -> torch.Tensor:
    """Kernel K3 (replaces ``dealii_slod_tpu/ops/assembly.py:
    stencil_trace_pallas``, C = 1, ``impl="c1"/"c1roll"``).

    band (B, nN, 3^dim), Xp (B, 1, nNp, k) zero-padded by ``shiftN`` on the
    node axis -> S (B, 1, nN, k).  A CPU tensor takes the plain version; a
    CUDA tensor launches ``csrc/stencil_trace.cu``."""
    if not Xp.is_cuda:
        return stencil_trace_plain(band, Xp, shiftN, offs_flat)
    B, C, nNp, k = Xp.shape
    nN, n_off = band.shape[1], band.shape[2]
    if C != 1 or band.shape[0] != B or n_off != len(offs_flat) or n_off > 27:
        raise ValueError(f"stencil_trace: band {tuple(band.shape)} and Xp "
                         f"{tuple(Xp.shape)} do not match (C = 1, <= 27 "
                         f"offsets)")
    offs = np.asarray([shiftN + int(o) for o in offs_flat], np.int32)
    if offs.min() < 0 or offs.max() + nN > nNp:
        raise ValueError("stencil_trace: shifted windows leave the padding")
    kernels.check_cuda("stencil_trace", band, Xp)
    S = torch.empty((B, 1, nN, k), dtype=Xp.dtype, device=Xp.device)
    kernels.launch("K3 stencil_trace", "slod_stencil_trace", Xp.dtype,
                   Xp.device, band.data_ptr(), Xp.data_ptr(), S.data_ptr(),
                   B, nN, nNp, k, n_off, offs.ctypes.data)
    return S


# ---------------------------------------------------------------------------
# Global fine grid: load vector and the unconstrained operator
# ---------------------------------------------------------------------------

class FineOperator:
    """Matrix-free global Q_iso_Q1 stiffness operator on the fine grid
    (scalar diffusion): u -> scatter_add(conn, Ksub(alpha) @ gather(conn,
    u)).  Only the unconstrained matvec is ported (the lifting of the
    Dirichlet data in ``assemble_fine_rhs``)."""

    def __init__(self, et: ElementTensors, conn: torch.Tensor,
                 coefs: Dict[str, torch.Tensor]):
        if set(coefs) != {"alpha"}:
            raise NotImplementedError(
                "FineOperator: only scalar diffusion ('alpha') is ported "
                "(ROADMAP.md Queue 1 item 12)")
        self.conn = conn.long()
        self.alpha = coefs["alpha"]
        self._K = torch.as_tensor(et.K_grad, dtype=self.alpha.dtype,
                                  device=self.alpha.device)

    def _apply_raw(self, u: torch.Tensor) -> torch.Tensor:
        """Unconstrained matvec, u: (n_nodes, 1) -> (n_nodes, 1)."""
        ue = u[self.conn, 0]                                 # (n_sub, m)
        out_s = torch.einsum("sq,qij,sj->si", self.alpha, self._K, ue)
        out = torch.zeros_like(u[:, 0])
        out.index_add_(0, self.conn.reshape(-1), out_s.reshape(-1))
        return out[:, None]


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
