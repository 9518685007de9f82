"""Batched SPD patch solves: kernel K1 (fused block-LDL^T multi-RHS solve
with the triple product) and kernel K2 (Gauss-Jordan sweep inverse)
(counterpart of ``dealii_slod_tpu/ops/patch_solve.py``).

Each wrapper takes its plain PyTorch version for a CPU tensor and launches
its CUDA kernel (``csrc/patch_solve.cu``) for a CUDA tensor."""

from __future__ import annotations

import torch

from dealii_slod_tpu_torch.utils import kernels

NB = 64          # K1 panel width (the kernel's tile size)
GJ_PAD = 128     # K2 pads m up to a multiple of this


def _pad_spd(A: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n0, n0) -> (B, n, n), unit diagonal on the padded rows (the
    padded coordinates stay decoupled, so the leading block is solved or
    inverted exactly)."""
    B, n0, _ = A.shape
    Ap = A.new_zeros((B, n, n))
    Ap[:, :n0, :n0] = A
    idx = torch.arange(n0, n, device=A.device)
    Ap[:, idx, idx] = 1.0
    return Ap


# ---------------------------------------------------------------------------
# K1: fused SPD multi-RHS solve + triple product
# ---------------------------------------------------------------------------

def fused_spd_multirhs_plain(A: torch.Tensor, B: torch.Tensor):
    """Plain version of K1: Cholesky solve, X = A^-1 B, T = B^T X."""
    L = torch.linalg.cholesky(A)
    X = torch.cholesky_solve(B, L)
    return X, B.mT @ X


def fused_spd_multirhs(A: torch.Tensor, B: torch.Tensor):
    """Kernel K1 (replaces ``dealii_slod_tpu/ops/patch_solve.py:
    fused_spd_multirhs``, ``algo="ldl"``, nb = 64).

    A (P, n, n) SPD, B (P, n, k) -> (X = A^-1 B (P, n, k),
    T = B^T A^-1 B (P, k, k)).  On CUDA, n and k are padded to multiples
    of 64 (unit diagonal on padded rows, zero right-hand sides) and one CTA
    factors each patch in place on a scratch copy of A."""
    if not A.is_cuda:
        return fused_spd_multirhs_plain(A, B)
    P, n0, _ = A.shape
    k0 = B.shape[-1]
    if B.shape[:2] != (P, n0) or A.shape[2] != n0:
        raise ValueError(f"fused_spd_multirhs: A {tuple(A.shape)} and B "
                         f"{tuple(B.shape)} do not match")
    # A and B are copied into the padded, contiguous operands below
    kernels.check_cuda("fused_spd_multirhs", A, B, contiguous=False)
    n = -(-n0 // NB) * NB
    k = -(-k0 // NB) * NB
    A_scr = _pad_spd(A, n)                 # factored in place
    X = B.new_zeros((P, n, k))             # B -> z -> w -> X in place
    X[:, :n0, :k0] = B
    T = torch.empty((P, k, k), dtype=A.dtype, device=A.device)
    work = torch.empty((P, NB * (NB + k + n)), dtype=A.dtype,
                       device=A.device)
    kernels.launch("K1 fused_spd_multirhs", "slod_fused_spd_multirhs",
                   A.dtype, A.device, A_scr.data_ptr(), X.data_ptr(),
                   T.data_ptr(), work.data_ptr(), P, n, k)
    return X[:, :n0, :k0].contiguous(), T[:, :k0, :k0].contiguous()


# ---------------------------------------------------------------------------
# K2: Gauss-Jordan sweep inverse of SPD matrices
# ---------------------------------------------------------------------------

def gj_inverse_plain(A: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: the unpivoted Gauss-Jordan sweep on tensors
    (stable for SPD input: the pivots stay positive under sweeps)."""
    M = A.clone()
    n = M.shape[-1]
    for k in range(n):
        colk = M[:, :, k:k + 1].clone()
        rowk = M[:, k:k + 1, :].clone()
        d = 1.0 / rowk[:, :, k:k + 1]
        M = M - (colk * d) * rowk
        M[:, k:k + 1, :] = rowk * d
        M[:, :, k:k + 1] = colk * d
        M[:, k, k] = -d[:, 0, 0]
    return -M


def gj_inverse(A: torch.Tensor) -> torch.Tensor:
    """Kernel K2 (replaces ``dealii_slod_tpu/ops/patch_solve.py:
    gj_inverse_pallas``): (B, m, m) SPD -> inverse.  On CUDA, m is padded
    to 128 with the identity and one CTA sweeps each matrix in shared
    memory."""
    if not A.is_cuda:
        return gj_inverse_plain(A)
    Bn, m0, _ = A.shape
    m = -(-m0 // GJ_PAD) * GJ_PAD
    if m > GJ_PAD:
        raise ValueError(f"gj_inverse: m = {m0} > {GJ_PAD}")
    kernels.check_cuda("gj_inverse", A, contiguous=False)
    M = _pad_spd(A, m)                     # inverted in place
    kernels.launch("K2 gj_inverse", "slod_gj_inverse", A.dtype, A.device,
                   M.data_ptr(), Bn, m)
    return M[:, :m0, :m0].contiguous()


def spd_inverse_schur(M: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse (counterpart of ``spd_inverse_schur``): at
    n <= 128 it is one K2 sweep; the blocked form for larger n is not
    ported yet."""
    if M.shape[-1] > GJ_PAD:
        raise NotImplementedError(
            "spd_inverse_schur for n > 128 (the blocked sweep of the "
            "elasticity path) is not ported (ROADMAP.md Queue 1 item 9)")
    return gj_inverse(M)
