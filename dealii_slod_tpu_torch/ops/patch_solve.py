"""Batched SPD patch solves: kernel K1 (fused block-LDL^T multi-RHS solve
with the triple product), kernel K6 (its solve-only instance, the leaf of
the 2x2 Schur split that the elasticity patch solve takes), kernel K2
(Gauss-Jordan sweep inverse, the blocked sweep built on it) and the panel
LDL^T whose diagonal blocks K2 inverts (counterpart of
``dealii_slod_tpu/ops/patch_solve.py``).

Each wrapper takes its plain PyTorch version for a CPU tensor and launches
its CUDA kernel (``csrc/patch_solve.cu``) for a CUDA tensor."""

from __future__ import annotations

import torch

from dealii_slod_tpu_torch.utils import kernels

NB = 64          # K1 / K6 panel width (the kernels' tile size)
GJ_PAD = 128     # K2's size: it takes m <= 128 (the blocked inverse's pivot)

# The reference's leaf budget of the Schur split: the TPU's scoped-VMEM
# budget for one solve-only call (scratch A, 4 n^2 B, plus scratch X,
# 4 n k B, in float32 whatever the dtype).  It is kept so that the port
# splits exactly where the reference does and runs the same leaves; the
# card itself has no such limit.
SOLVE_VMEM_BUDGET = int(9.5e6)


def _pad_spd(A: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n0, n0) -> (B, n, n), unit diagonal on the padded rows (the
    padded coordinates stay decoupled, so the leading block is solved or
    inverted exactly)."""
    B, n0, _ = A.shape
    Ap = A.new_empty((B, n, n))
    Ap[:, :n0, :n0] = A
    if n > n0:
        Ap[:, n0:, :] = 0.0
        Ap[:, :n0, n0:] = 0.0
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


def _ldl_operands(name: str, A: torch.Tensor, B: torch.Tensor):
    """K1's and K6's operands on CUDA: n and k padded to multiples of 64
    (unit diagonal on padded rows, zero right-hand sides), the scratch
    copy of A that the kernel factors in place, X holding B (B -> z -> X
    in place) and the per-patch workspace, whose size is the C++
    launcher's rule (``slod_{name}_ws``: D_j^-1, one 128-row block of
    right-hand sides and, with the triple product, w)."""
    P, n0, _ = A.shape
    k0 = B.shape[-1]
    if B.shape[:2] != (P, n0) or A.shape[2] != n0:
        raise ValueError(f"{name}: A {tuple(A.shape)} and B "
                         f"{tuple(B.shape)} do not match")
    # A and B are copied into the padded, contiguous operands below
    kernels.check_cuda(name, A, B, contiguous=False)
    n = -(-n0 // NB) * NB
    k = -(-k0 // NB) * NB
    X = B.new_empty((P, n, k))
    X[:, :n0, :k0] = B
    if n > n0:
        X[:, n0:, :] = 0.0
    if k > k0:
        X[:, :n0, k0:] = 0.0
    work = kernels.workspace(name, f"slod_{name}", A.dtype, A.device, P, n, k)
    return _pad_spd(A, n), X, work


def fused_ldl_blocked_plain(A: torch.Tensor, B: torch.Tensor,
                            with_T: bool = True, matmul=None):
    """The arithmetic of K1 / K6 on tensors, in the kernels' order of
    summation: the left-looking block LDL^T (64 x 64 diagonal blocks
    inverted by the sweep, the upper block triangle holding
    U = (L D)^T), the substitutions by block rows of 128 and T = z^T w as
    one product.  Every product goes through ``matmul`` (default
    ``torch.matmul``), so a test can put an emulated product in its place.
    Only tests and ``chip_smoke.py`` call it, to localise a wrong panel.
    -> (X, T), or X where ``with_T`` is False."""
    mm = matmul or torch.matmul
    P, n0, _ = A.shape
    n = -(-n0 // NB) * NB
    A = _pad_spd(A, n)
    X = B.new_zeros((P, n, B.shape[-1]))
    X[:, :n0] = B
    Dinv = []
    for j0 in range(0, n, NB):
        j1 = j0 + NB
        if j0 == 0:
            A[:, :NB, NB:] = A[:, NB:, :NB].mT
        else:
            col = A[:, j0:, j0:j1] - mm(A[:, j0:, :j0], A[:, :j0, j0:j1])
            A[:, j0:, j0:j1] = col
            A[:, j0:j1, j1:] = col[:, NB:].mT
        Dinv.append(gj_inverse_plain(A[:, j0:j1, j0:j1]))
        if j1 < n:
            A[:, j1:, j0:j1] = mm(A[:, j1:, j0:j1], Dinv[-1])
    W = torch.empty_like(X) if with_T else None
    for r0 in range(0, n, 2 * NB):
        r1, r2 = r0 + NB, min(r0 + 2 * NB, n)
        if r0 > 0:
            X[:, r0:r2] = X[:, r0:r2] - mm(A[:, r0:r2, :r0], X[:, :r0])
        if r2 > r1:
            X[:, r1:r2] = X[:, r1:r2] - mm(A[:, r1:r2, r0:r1], X[:, r0:r1])
        if with_T:
            for b0 in range(r0, r2, NB):
                W[:, b0:b0 + NB] = mm(Dinv[b0 // NB], X[:, b0:b0 + NB])
    T = mm(X.mT, W) if with_T else None
    hi = n
    while hi > 0:
        r0 = hi - (NB if hi < 2 * NB else 2 * NB)
        r1 = r0 + NB
        y = X[:, r0:hi]
        if hi < n:
            y = y - mm(A[:, r0:hi, hi:], X[:, hi:])
        if hi > r1:
            X[:, r1:hi] = mm(Dinv[r1 // NB], y[:, NB:])
            y = y[:, :NB] - mm(A[:, r0:r1, r1:hi], X[:, r1:hi])
        X[:, r0:r1] = mm(Dinv[r0 // NB], y)
        hi = r0
    X = X[:, :n0]
    return (X, T) if with_T else X


def fused_spd_multirhs(A: torch.Tensor, B: torch.Tensor):
    """Kernel K1 (replaces ``dealii_slod_tpu/ops/patch_solve.py:
    fused_spd_multirhs``, ``algo="ldl"``, nb = 64).

    A (P, n, n) SPD, B (P, n, k) -> (X = A^-1 B (P, n, k),
    T = B^T A^-1 B (P, k, k)).  On CUDA, n and k are padded to multiples
    of 64 and one CTA factors each patch in place on a scratch copy of A
    (``_ldl_operands``)."""
    if not A.is_cuda:
        return fused_spd_multirhs_plain(A, B)
    A_scr, X, work = _ldl_operands("fused_spd_multirhs", A, B)
    P, n, k = X.shape
    T = torch.empty((P, k, k), dtype=A.dtype, device=A.device)
    kernels.launch("K1 fused_spd_multirhs", "slod_fused_spd_multirhs",
                   A.dtype, A.device, A_scr.data_ptr(), X.data_ptr(),
                   T.data_ptr(), work.data_ptr(), P, n, k)
    n0, k0 = B.shape[1:]
    return X[:, :n0, :k0].contiguous(), T[:, :k0, :k0].contiguous()


# ---------------------------------------------------------------------------
# K6: solve-only leaf, and the recursive 2x2 Schur split
# ---------------------------------------------------------------------------

def spd_multirhs_solve_plain(A: torch.Tensor, B: torch.Tensor):
    """Plain version of K6: Cholesky solve, X = A^-1 B."""
    return torch.cholesky_solve(B, torch.linalg.cholesky(A))


def spd_multirhs_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Kernel K6 (replaces ``dealii_slod_tpu/ops/patch_solve.py:
    spd_multirhs_solve_dma``): A (P, n, n) SPD, B (P, n, k) -> X = A^-1 B.
    On CUDA, one CTA factors each patch in place on a scratch copy of A, as
    K1 does (``_ldl_operands``), without the triple product."""
    if not A.is_cuda:
        return spd_multirhs_solve_plain(A, B)
    A_scr, X, work = _ldl_operands("spd_multirhs_solve", A, B)
    P, n, k = X.shape
    kernels.launch("K6 spd_multirhs_solve", "slod_spd_multirhs_solve",
                   A.dtype, A.device, A_scr.data_ptr(), X.data_ptr(),
                   work.data_ptr(), P, n, k)
    n0, k0 = B.shape[1:]
    return X[:, :n0, :k0]


def _solve_fits(n: int, k: int, nb: int) -> bool:
    """The reference's leaf test: does one solve-only call at (n, k) fit
    ``SOLVE_VMEM_BUDGET`` (n padded to ``nb``, k to 128)."""
    np_ = -(-n // nb) * nb
    kp = -(-k // 128) * 128
    return 4 * (np_ * np_ + np_ * kp) <= SOLVE_VMEM_BUDGET


def _solve_rec(A: torch.Tensor, B: torch.Tensor, nb: int,
               leaf=None) -> torch.Tensor:
    """Solve-only A^-1 B by recursive 2x2 block-Cholesky (Schur) splits
    until each sub-solve passes ``_solve_fits`` (the reference's rule, its
    search kept as it is: the LAST fitting leading block wins, and a
    right-hand side too wide for any block is halved).  The leaves run
    ``leaf`` (default K6, ``spd_multirhs_solve``); the Schur formation and
    the back-substitution are batched matmuls."""
    leaf = leaf or spd_multirhs_solve
    P, n0, _ = A.shape
    k0 = B.shape[-1]
    if _solve_fits(n0, k0, nb):
        return leaf(A, B)
    n1 = 0                   # the test is not monotone in cand: last wins
    for cand in range(nb, n0, nb):
        if _solve_fits(cand, (n0 - cand) + k0, nb):
            n1 = cand
    if n1 == 0:
        # RHS too wide even for the smallest block: split the RHS columns
        half = -(-k0 // 256) * 128
        return torch.cat([_solve_rec(A, B[:, :, :half], nb, leaf),
                          _solve_rec(A, B[:, :, half:], nb, leaf)], dim=-1)
    A11 = A[:, :n1, :n1]
    A12 = A[:, :n1, n1:]
    A22 = A[:, n1:, n1:]
    U = _solve_rec(A11, torch.cat([A12, B[:, :n1, :]], dim=-1), nb, leaf)
    n2 = n0 - n1
    U_A = U[:, :, :n2]                       # A11^-1 A12
    U_B = U[:, :, n2:]                       # A11^-1 B1
    S = A22 - A12.mT @ U_A
    Y = B[:, n1:, :] - A12.mT @ U_B
    del U
    X2 = _solve_rec(S, Y, nb, leaf)
    del S, Y
    X1 = U_B - U_A @ X2
    return torch.cat([X1, X2], dim=1)


def split_leaves(n0: int, k0: int, nb: int) -> list:
    """The (n, k) of each leaf, in call order, that ``_solve_rec`` runs for
    an (n0, n0) block and k0 right-hand sides: ``_solve_rec`` itself on
    shape-only (meta) tensors, its leaf recording the shapes."""
    leaves = []

    def record(A, B):
        leaves.append((A.shape[-1], B.shape[-1]))
        return torch.empty_like(B)

    _solve_rec(torch.empty((1, n0, n0), device="meta"),
               torch.empty((1, n0, k0), device="meta"), nb, record)
    return leaves


def fused_spd_multirhs_split(A: torch.Tensor, B: torch.Tensor,
                             nb: int = 128, leaf=None):
    """K1's contract for patch blocks past the reference's leaf budget
    (3D elasticity: n = 3 * 729 = 2187), by exact recursive 2x2
    block-Cholesky (Schur) splits (``_solve_rec``; ``leaf`` default K6)
    -> (X = A^-1 B, T = 0.5 (B^T X + (B^T X)^T)).  ``nb``
    (``cfg.panel_nb``) drives the split rule; the leaf kernel's tile stays
    64.  On the 3D elasticity chunk the leaves are (768, 1794),
    (1152, 642) and (267, 375)."""
    X = _solve_rec(A, B, nb, leaf)
    T = B.mT @ X
    return X, 0.5 * (T + T.mT)


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
    gj_inverse_pallas``): (B, m, m) SPD, m <= 128 -> inverse (a new
    contiguous tensor).  On CUDA one CTA sweeps each matrix in registers as
    its identity extension to 128; A is read through its batch and row
    strides (a pivot block of a larger matrix is not copied)."""
    if not A.is_cuda:
        return gj_inverse_plain(A)
    Bn, m0, _ = A.shape
    if m0 > GJ_PAD:
        raise ValueError(f"gj_inverse: m = {m0} > {GJ_PAD}")
    kernels.check_cuda("gj_inverse", A, contiguous=False)
    sb, sr, sc = A.stride()
    if sc != 1 or sr < m0 or (Bn > 1 and sb < m0 * sr):
        A = A.contiguous()
        sb, sr, _ = A.stride()
    out = torch.empty((Bn, m0, m0), dtype=A.dtype, device=A.device)
    kernels.launch("K2 gj_inverse", "slod_gj_inverse", A.dtype, A.device,
                   A.data_ptr(), out.data_ptr(), Bn, m0,
                   sb if Bn > 1 else m0 * sr, sr)
    return out


def spd_inverse_schur(M: torch.Tensor, nb: int = GJ_PAD) -> torch.Tensor:
    """Batched SPD inverse (counterpart of ``spd_inverse_schur``): at
    n <= 128 one K2 sweep; beyond, the blocked Gauss-Jordan sweep: M is
    identity-extended to a multiple of ``nb`` and each nb x nb pivot block
    is inverted by K2, the rank-nb row / column / corner updates by batched
    matmuls in full precision (TF32 stays off; the reference pins HIGHEST
    there, the updates cancel like the sweep's rank-1 updates)."""
    B0, n0, _ = M.shape
    if n0 <= nb:
        return gj_inverse(M)
    n = -(-n0 // nb) * nb
    if n != n0:
        M = _pad_spd(M, n)
    for k0 in range(0, n, nb):
        k1 = k0 + nb
        Pi = gj_inverse(M[:, k0:k1, k0:k1])
        colk = M[:, :, k0:k1]                              # (B, n, nb)
        rowk = M[:, k0:k1, :]                              # (B, nb, n)
        CPi = colk @ Pi
        M2 = M - CPi @ rowk
        M2[:, :, k0:k1] = CPi
        M2[:, k0:k1, :] = Pi @ rowk
        M2[:, k0:k1, k0:k1] = -Pi
        M = M2
    return -M[:, :n0, :n0]


# ---------------------------------------------------------------------------
# The panel route: block LDL^T by batched products, K2 on the diagonal
# ---------------------------------------------------------------------------

def panel_spd_multirhs(A: torch.Tensor, B: torch.Tensor, nb: int = 128):
    """K1's contract by a right-looking block LDL^T at the level of batched
    products (counterpart of ``panel_spd_multirhs``): A (P, n, n) SPD, B
    (P, n, k) -> (X = A^-1 B, T = 0.5 (B^T X + (B^T X)^T)).

    A is identity-extended to a multiple of ``nb``.  Each panel step
    inverts its nb x nb diagonal block on K2 (``gj_inverse``; beyond 128
    the blocked sweep ``spd_inverse_schur``, K2 on 128-pivots, where the
    reference's scalar sweep pads any nb), then scales the panel and
    updates the trailing block by one batched product each over the whole
    batch.  The forward, block-diagonal and backward solves and T are
    batched products too."""
    P, n0, _ = A.shape
    k = B.shape[-1]
    n = -(-n0 // nb) * nb
    W = _pad_spd(A, n)                     # a copy: factored in place
    Z = B.new_zeros((P, n, k))
    Z[:, :n0] = B
    inv = gj_inverse if nb <= GJ_PAD else spd_inverse_schur
    Ls, Dinvs = [], []
    for j0 in range(0, n, nb):
        j1 = j0 + nb
        Dinvs.append(inv(W[:, j0:j1, j0:j1]))
        if j1 < n:
            Wj = W[:, j1:, j0:j1]
            Ls.append(Wj @ Dinvs[-1])
            W[:, j1:, j1:] -= Ls[-1] @ Wj.mT
    del W
    for j, Lj in enumerate(Ls):            # L z = B
        Z[:, (j + 1) * nb:] -= Lj @ Z[:, j * nb:(j + 1) * nb]
    X = (torch.stack(Dinvs, dim=1) @ Z.reshape(P, n // nb, nb, k)).reshape(
        P, n, k)                           # w = D^-1 z
    for j in range(len(Ls) - 1, -1, -1):   # L^T x = w
        X[:, j * nb:(j + 1) * nb] -= Ls[j].mT @ X[:, (j + 1) * nb:]
    X = X[:, :n0]
    T = B.mT @ X
    return X, 0.5 * (T + T.mT)


def panel_k2_launches(n0: int, nb: int) -> int:
    """K2 launches of one ``panel_spd_multirhs`` call on an (n0, n0)
    block: one per diagonal block, or one per 128-pivot of each block
    where nb > 128."""
    per_block = 1 if nb <= GJ_PAD else -(-nb // GJ_PAD)
    return -(-n0 // nb) * per_block
