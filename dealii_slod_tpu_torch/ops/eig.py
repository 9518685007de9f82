"""One-sided Jacobi eigensolver for PSD matrices: kernel K5 and the factor
form used by the SLOD spectral stage (counterpart of
``dealii_slod_tpu/ops/eig.py: jacobi_eigh_pallas, jacobi_eigh_factor``).

The working rows sit in the caterpillar (top, bottom) pair layout: rows
2k / 2k+1 are pair k, every round rotates all pairs at once, and the
tournament advance is a fixed shift.  No rotation accumulator is kept: for
PSD input the converged rows are lambda_i v_i^T (``_finalize_rows``)."""

from __future__ import annotations

import numpy as np
import torch

from dealii_slod_tpu_torch.utils import kernels

_F32_MAX = float(np.finfo(np.float32).max)


def _eps(dtype: torch.dtype) -> float:
    return float(np.finfo("float64" if dtype == torch.float64
                          else "float32").tiny * 1e3)


def _default_null_rel(dtype: torch.dtype) -> float:
    return 1e-14 if dtype == torch.float64 else 1e-9


def _caterpillar_round_nj(XT, XB, a, b, eps, off=None, amax2=None,
                          null_rel=1e-9):
    """One parallel round on (B, m, n) top/bottom rows with carried row
    norms a, b (B, m, 1); folds the round's largest significant squared
    row-cosine into ``off`` (B,) when given."""
    c = torch.sum(XT * XB, dim=-1, keepdim=True)
    if off is not None:
        cos2 = (c * c) / (a * b + eps)
        cos2 = torch.where(a * b > (null_rel * amax2) ** 2, cos2, 0.0)
        off = torch.maximum(off, cos2.amax(dim=(1, 2)))
    big = torch.abs(c) > eps
    safe_c = torch.where(big, c, 1.0)
    zeta = (b - a) / (2.0 * safe_c)
    sgn = torch.where(zeta >= 0, 1.0, -1.0).to(zeta.dtype)
    t = sgn / (torch.abs(zeta) + torch.sqrt(1.0 + zeta * zeta))
    t = torch.where(big, t, 0.0)
    cs = torch.rsqrt(1.0 + t * t)
    sn = cs * t
    nT = cs * XT - sn * XB
    nB = sn * XT + cs * XB
    csnc = cs * sn * c
    a2 = cs * cs * a - 2.0 * csnc + sn * sn * b
    b2 = sn * sn * a + 2.0 * csnc + cs * cs * b

    def advance(T, Bm):
        if T.shape[1] == 1:
            return T, Bm
        return (torch.cat([T[:, :1], Bm[:, :1], T[:, 1:-1]], dim=1),
                torch.cat([Bm[:, 1:], T[:, -1:]], dim=1))

    XT, XB = advance(nT, nB)
    a, b = advance(a2, b2)
    return XT, XB, a, b, off


def jacobi_rows_plain(G: torch.Tensor, sweeps: int, block: int, tol: float,
                      null_rel: float):
    """Plain version of K5 on (B, n, n) PSD matrices, n even -> final
    (XT, XB) rows.  ``block`` consecutive matrices share the adaptive stop
    (``off`` is a max over the block, as in the TPU kernel); the CUDA kernel
    stops each matrix on its own, i.e. equals ``block=1``."""
    B0, n, _ = G.shape
    B = -(-B0 // block) * block
    if B != B0:
        G = torch.cat([G, G.new_zeros((B - B0, n, n))])
    eps = _eps(G.dtype)
    XT, XB = G[:, 0::2, :].clone(), G[:, 1::2, :].clone()

    def norms(XT, XB):
        return (torch.sum(XT * XT, -1, keepdim=True),
                torch.sum(XB * XB, -1, keepdim=True))

    if tol <= 0.0:
        for _ in range(sweeps):
            a, b = norms(XT, XB)
            for _ in range(n - 1):
                XT, XB, a, b, _ = _caterpillar_round_nj(XT, XB, a, b, eps)
        return XT[:B0], XB[:B0]

    a0, b0 = norms(XT, XB)
    amax2 = torch.amax(torch.maximum(a0, b0), dim=-2, keepdim=True)
    n_blk = B // block
    active = torch.ones(n_blk, dtype=torch.bool, device=G.device)
    off_blk = torch.full((n_blk,), _F32_MAX, dtype=G.dtype, device=G.device)
    for it in range(sweeps):
        active = active & (off_blk > tol)
        if not bool(active.any()):
            break
        XT0, XB0 = XT, XB
        a, b = norms(XT, XB)
        off = G.new_zeros(B)
        for _ in range(n - 1):
            XT, XB, a, b, off = _caterpillar_round_nj(
                XT, XB, a, b, eps, off=off, amax2=amax2, null_rel=null_rel)
        act = active.repeat_interleave(block)[:, None, None]
        XT = torch.where(act, XT, XT0)
        XB = torch.where(act, XB, XB0)
        off_blk = torch.where(active, off.view(n_blk, block).amax(1),
                              off_blk)
    return XT[:B0], XB[:B0]


def _jacobi_rows_cuda(G: torch.Tensor, sweeps: int, tol: float,
                      null_rel: float):
    B, n, _ = G.shape
    kernels.check_cuda("jacobi_eigh", G)
    XT = torch.empty((B, n // 2, n), dtype=G.dtype, device=G.device)
    XB = torch.empty_like(XT)
    kernels.launch("K5 jacobi_eigh", "slod_jacobi_rows", G.dtype, G.device,
                   G.data_ptr(), XT.data_ptr(), XB.data_ptr(), B, n,
                   sweeps, float(tol), float(null_rel), _eps(G.dtype))
    return XT, XB


def _finalize_rows(XT, XB, n0, batch_shape):
    """Eigenvalues = row norms, eigenvectors = normalized rows, sorted
    descending; zero rows (the odd-n pad row) sort last and are dropped."""
    X = torch.cat([XT, XB], dim=1)
    lam = torch.sqrt(torch.sum(X * X, dim=-1))
    order = torch.argsort(-lam, dim=-1, stable=True)[:, :n0]
    lam_s = torch.take_along_dim(lam, order, dim=-1)
    X_s = torch.take_along_dim(X, order[:, :, None], dim=1)[:, :, :n0]
    V = (X_s / torch.clamp(lam_s[:, :, None], min=1e-30)).mT
    return (lam_s.reshape(batch_shape + (n0,)),
            V.reshape(batch_shape + (n0, n0)))


def jacobi_eigh(G: torch.Tensor, sweeps: int = 12, block: int = 16,
                tol: float = 0.0, null_rel: float | None = None):
    """Kernel K5 (replaces ``dealii_slod_tpu/ops/eig.py:
    jacobi_eigh_pallas``): eigenvalues descending and eigenvectors as
    columns of PSD (..., n, n) matrices.  ``tol > 0`` stops adaptively once
    every significant pair's squared row-cosine in the previous sweep was
    below ``tol`` (``sweeps`` is the maximum).  ``block`` applies to the
    plain version only (CPU tensors); the kernel stops each matrix on its
    own."""
    if null_rel is None:
        null_rel = _default_null_rel(G.dtype)
    batch_shape = tuple(G.shape[:-2])
    n0 = G.shape[-1]
    G = G.reshape(-1, n0, n0)
    n = n0 + n0 % 2
    if n != n0:
        Gp = G.new_zeros((G.shape[0], n, n))
        Gp[:, :n0, :n0] = G
        G = Gp
    G = G.contiguous()
    if G.is_cuda:
        XT, XB = _jacobi_rows_cuda(G, sweeps, tol, null_rel)
    else:
        XT, XB = jacobi_rows_plain(G, sweeps, block, tol, null_rel)
    return _finalize_rows(XT, XB, n0, batch_shape)


def jacobi_eigh_factor(G: torch.Tensor, sweeps: int = 12, block: int = 16,
                       tol: float = 0.0, jitter: float | None = None,
                       null_rel: float | None = None):
    """Factor-form spectral decomposition of PSD matrices: K5 on the
    transposed Cholesky factor of the relatively ``jitter``-regularized G
    (Demmel-Veselic: the sweeps see the square root of G's dynamic range).
    Returns (eigenvalues descending, eigenvectors as columns)."""
    if jitter is None:
        jitter = 1e-13 if G.dtype == torch.float64 else 1e-6
    dmax = torch.diagonal(G, dim1=-2, dim2=-1).abs().amax(-1, keepdim=True)
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    L, _ = torch.linalg.cholesky_ex(G + (jitter * dmax)[..., None] * eye)
    s, U = jacobi_eigh(L.mT, sweeps=sweeps, tol=tol, block=block,
                       null_rel=null_rel)
    return s * s, U
