"""One-sided Jacobi eigensolver for PSD matrices (kernel K5), its factor
form used by the Jacobi spectral stage, and the smallk spectral stage with
its kernels K4 (MGS2 thin-Q) and K8 (W build fused with K5's sweeps)
(counterpart of ``dealii_slod_tpu/ops/eig.py: jacobi_eigh_pallas,
jacobi_eigh_factor, mgs_qr_pallas, weig_pallas, smallk_truncated_dvec``).

The working rows sit in the caterpillar (top, bottom) pair layout: rows
2k / 2k+1 are pair k, every round rotates all pairs at once, and the
tournament advance is a fixed shift.  No rotation accumulator is kept: for
PSD input the converged rows are lambda_i v_i^T (``_finalize_rows``; the
CUDA kernels sort and normalize them themselves).

Each kernel wrapper takes its plain PyTorch version for a CPU tensor and
launches its CUDA kernel for a CUDA tensor."""

from __future__ import annotations

import functools

import numpy as np
import torch

from dealii_slod_tpu_torch.ops.patch_solve import spd_inverse_schur
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


def _launch_k5(G, sweeps, tol, null_rel, XT=None, XB=None, cnt=None,
               lam=None, V=None):
    """K5 on the (B, n, n) rows G, n even: the final rows to XT, XB, or the
    sorted eigenpairs to lam (B, n0), V (B, n0, n0); the sweeps each matrix
    ran to cnt where given."""
    B, n, _ = G.shape
    kernels.check_cuda("jacobi_eigh", G)
    ws = kernels.workspace("K5 jacobi_eigh", "slod_jacobi_rows", G.dtype,
                           G.device, B, n)
    kernels.launch("K5 jacobi_eigh", "slod_jacobi_rows", G.dtype, G.device,
                   G.data_ptr(), _ptr(XT), _ptr(XB), _ptr(ws), _ptr(cnt),
                   _ptr(lam), _ptr(V), B, n,
                   n if lam is None else lam.shape[-1], sweeps, float(tol),
                   float(null_rel), _eps(G.dtype))


def _jacobi_rows_cuda(G: torch.Tensor, sweeps: int, tol: float,
                      null_rel: float, counts: bool = False):
    """K5's launch on (B, n, n) rows -> (XT, XB), and with ``counts`` the
    sweeps each matrix ran (B,) int32 as a third output."""
    B, n, _ = G.shape
    XT = torch.empty((B, n // 2, n), dtype=G.dtype, device=G.device)
    XB = torch.empty_like(XT)
    cnt = (torch.empty(B, dtype=torch.int32, device=G.device) if counts
           else None)
    _launch_k5(G, sweeps, tol, null_rel, XT=XT, XB=XB, cnt=cnt)
    return (XT, XB, cnt) if counts else (XT, XB)


def _jacobi_eigh_cuda(G: torch.Tensor, n0: int, sweeps: int, tol: float,
                      null_rel: float):
    """K5 with the sort and normalization in the kernel: (B, n, n) rows, n
    even, of which n0 (n, or n - 1 after an odd n's zero pad) are the
    matrix's -> what ``_finalize_rows`` gives from the rows: eigenvalues
    descending (B, n0), eigenvectors as columns (B, n0, n0)."""
    B = G.shape[0]
    lam = torch.empty((B, n0), dtype=G.dtype, device=G.device)
    V = torch.empty((B, n0, n0), dtype=G.dtype, device=G.device)
    _launch_k5(G, sweeps, tol, null_rel, lam=lam, V=V)
    return lam, V


def caterpillar_slots(n: int, r: int):
    """The rows (numbered as at round 0: top slot q holds row 2q, bottom
    slot q row 2q + 1) that the caterpillar's top and bottom slots hold
    after ``r`` advances, n even -> (top, bottom), lists of n / 2.  Top
    slot 0 keeps row 0; the other n - 1 slots, in the ring order t1 ..
    t_{m-1}, b_{m-1} .. b0, pass their row one place along the ring per
    round.  This closed form is what K5's CTA routine computes
    (``csrc/jacobi_eigh.cu: slot_top, slot_bot``) instead of moving rows
    as ``_caterpillar_round_nj`` does."""
    m = n // 2
    ring = 2 * m - 1

    def ring_row(p):
        return 2 * (p + 1) if p < m - 1 else 2 * (2 * m - 2 - p) + 1

    top = [0] + [ring_row((q - 1 - r) % ring) for q in range(1, m)]
    bot = [ring_row((2 * m - 2 - q - r) % ring) for q in range(m)]
    return top, bot


# K5's cluster route (csrc/jacobi_eigh.cu: CL_SIZES, CL_ROWS, cluster_plan)
K5_CLUSTER_SIZES = (16, 8, 4, 2)
K5_CLUSTER_ROWS = (8, 12)
H100_SMEM_OPTIN = 232448      # cudaDevAttrMaxSharedMemoryPerBlockOptin
_STATIC_SMEM_MARGIN = 1024    # csrc/common.cuh: STATIC_SMEM_MARGIN


def k5_cluster_layout(n: int, itemsize: int, S: int,
                      smem_limit: int = H100_SMEM_OPTIN):
    """The layout of an n x n matrix (n even) of ``itemsize``-byte values
    on a cluster of S CTAs in K5's cluster route, or None where it does not
    fit.  Lane l of a warp holds elements 2 l, 2 l + 1, 64 + 2 l, ... of
    its rows (J of them, J the smallest of ``K5_CLUSTER_ROWS`` with
    32 J >= n); a warp holds two consecutive pairs (caterpillar slots), a
    CTA P of them (P = ceil(m / S) rounded up to even, m = n / 2).  It fits
    where no CTA is empty, the P / 2 warps stay within the instance's
    thread limit (65536 registers over 4 J values of the rows plus 56, in
    multiples of 128 threads) and the inboxes (four rows of n + 2 values a
    warp) and the n final norms fit ``smem_limit`` less the static margin.
    Returns a dict (S, P, J, threads, ldi, smem) or None."""
    J = next((j for j in K5_CLUSTER_ROWS if 32 * j >= n), None)
    if J is None or n < 4 or n % 2:
        return None
    m = n // 2
    limit = min(1024, 65536 // (4 * J * itemsize // 4 + 56) // 128 * 128)
    P = -(-m // S)
    P += P % 2
    threads = P // 2 * 32
    smem = (P // 2 * 4 * (n + 2) + n) * itemsize
    if ((S - 1) * P < m and threads <= limit
            and smem <= smem_limit - _STATIC_SMEM_MARGIN):
        return dict(S=S, P=P, J=J, threads=threads, ldi=n + 2, smem=smem)
    return None


def k5_cluster_plan(n: int, itemsize: int,
                    smem_limit: int = H100_SMEM_OPTIN):
    """The layout K5's cluster route gives an n x n matrix, the twin of
    ``csrc/jacobi_eigh.cu: cluster_plan``: ``k5_cluster_layout`` at the
    largest of ``K5_CLUSTER_SIZES`` that fits, or None."""
    return next((p for S in K5_CLUSTER_SIZES
                 if (p := k5_cluster_layout(n, itemsize, S, smem_limit))
                 is not None), None)


# the routes of K5 and K8 (csrc/jacobi_eigh.cu: Route, in its order)
K5_ROUTES = ("warp", "rows", "loop rows", "cluster", "global rows")


def k5_route(n: int, itemsize: int):
    """The route K5 takes at row length n, the twin of
    ``csrc/jacobi_eigh.cu: jacobi_route``: "warp" at n = 32 (a warp per
    matrix, rows in registers), "rows" at n <= 128 (RegRows: rows padded
    to 128 in one CTA's shared memory), "loop rows" while the n x n rows,
    their norms and the sort order fit one CTA's shared memory, then
    "cluster" where ``k5_cluster_plan`` lays n out, else "global rows" (a
    workspace of n * n per matrix); None for odd n or where not even the
    norms fit."""
    if n < 2 or n % 2:
        return None
    if n == 32:
        return "warp"
    lim = H100_SMEM_OPTIN - _STATIC_SMEM_MARGIN

    def rows_smem(ld, global_rows):
        return ((0 if global_rows else n * ld) + n) * itemsize + 4 * n

    if n <= 128:
        return "rows" if rows_smem(128, False) <= lim else None
    if rows_smem(n, False) <= lim:
        return "loop rows"
    if rows_smem(n, True) > lim:
        return None
    if k5_cluster_plan(n, itemsize) is not None:
        return "cluster"
    return "global rows"


def k8_route(k: int):
    """The route K8 takes at k, the twin of ``csrc/jacobi_eigh.cu:
    launch_weig``: K8 sweeps in float64 at either input type, so it takes
    K5's float64 route at row length k (``k5_route(k, 8)``), with W built
    in the launch into that route's storage.  (At every k a path runs, and
    at the k of ``tests/test_torch_kernels.py::test_k8_route_is_k5_rule``,
    K5's float32 route is the same.)"""
    return k5_route(k, 8)


def k5_cluster_maps(n: int, plan: dict, r: int):
    """Who holds what in K5's cluster route under ``plan`` at round ``r``:
    (for each pair q its (CTA, warp, which of the warp's two pairs): CTA
    q // P, warp (q % P) // 2, q % 2, the same in every round; the CTA
    holding each row at round r: its slot's pair's, the rows travelling
    with their caterpillar slots)."""
    P = plan["P"]
    pair_warp = [(q // P, (q % P) // 2, q % 2) for q in range(n // 2)]
    top, bot = caterpillar_slots(n, r)
    row_cta = [0] * n
    for q, (t, b) in enumerate(zip(top, bot)):
        row_cta[t] = row_cta[b] = q // P
    return pair_warp, row_cta


def _ptr(ws: torch.Tensor | None) -> int:
    """Address of a kernel workspace or optional output (0: none; a kernel
    given no workspace works in shared memory or registers)."""
    return 0 if ws is None else ws.data_ptr()


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
        lam, V = _jacobi_eigh_cuda(G, n0, sweeps, tol, null_rel)
        return (lam.reshape(batch_shape + (n0,)),
                V.reshape(batch_shape + (n0, n0)))
    XT, XB = jacobi_rows_plain(G, sweeps, block, tol, null_rel)
    return _finalize_rows(XT, XB, n0, batch_shape)


# the Grams' regularization G + jitter max|diag G| I of the Jacobi and
# smallk stages, by dtype (the reference's eig.py constants)
JITTER = {torch.float32: 1e-6, torch.float64: 1e-13}


def jacobi_eigh_factor(G: torch.Tensor, sweeps: int = 12, block: int = 16,
                       tol: float = 0.0, jitter: float | None = None,
                       null_rel: float | None = None):
    """Factor-form spectral decomposition of PSD matrices: K5 on the
    transposed Cholesky factor of the relatively ``jitter``-regularized G
    (Demmel-Veselic: the sweeps see the square root of G's dynamic range).
    Returns (eigenvalues descending, eigenvectors as columns)."""
    if jitter is None:
        jitter = JITTER[G.dtype]
    dmax = torch.diagonal(G, dim1=-2, dim2=-1).abs().amax(-1, keepdim=True)
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    L, _ = torch.linalg.cholesky_ex(G + (jitter * dmax)[..., None] * eye)
    s, U = jacobi_eigh(L.mT, sweeps=sweeps, tol=tol, block=block,
                       null_rel=null_rel)
    return s * s, U


# ---------------------------------------------------------------------------
# K4: two-pass modified Gram-Schmidt thin Q
# ---------------------------------------------------------------------------

def mgs_qr_plain(X: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: two sweeps of modified Gram-Schmidt over the k
    columns of X (B, n, k).  A column is scaled by
    ``rsqrt(|x|^2 + 1e-30)``, so a null column comes out exactly zero (where
    a Householder QR would complete the basis)."""
    Q = X.clone()
    k = Q.shape[-1]
    for _ in range(2):
        for j in range(k):
            q = Q[:, :, j]
            q = q * torch.rsqrt((q * q).sum(1, keepdim=True) + 1e-30)
            Q[:, :, j] = q
            if j + 1 < k:
                rest = Q[:, :, j + 1:]
                coef = (rest * q[:, :, None]).sum(1, keepdim=True)
                Q[:, :, j + 1:] = rest - coef * q[:, :, None]
    return Q


MGS_PANEL = 32          # K4's panel width (csrc/mgs_qr.cu: PANEL)


def mgs_qr_panel_plain(X: torch.Tensor, panel: int = MGS_PANEL):
    """K4's order of operations at n <= 384 on tensors: the same two MGS
    passes as ``mgs_qr_plain``, each column receiving q_0 .. q_{j-1} in
    order, with the columns taken in panels of ``panel``.  Inside a panel
    step j forms the Gram row s_i = x_i . x_j (i >= j), rs = rsqrt(s_jj +
    1e-30), and subtracts (s_ij rs) rs x_j from each later column of the
    panel; x_j becomes q_j = x_j rs when the panel ends.  The columns after
    the panel then receive the panel's q's one by one, each as x_i . q_j
    and a subtraction."""
    Q = X.clone()
    k = Q.shape[-1]
    for _ in range(2):
        for p0 in range(0, k, panel):
            p1 = min(p0 + panel, k)
            scale = []
            for j in range(p0, p1):
                xj = Q[:, :, j:j + 1]
                s = (Q[:, :, j:p1] * xj).sum(1, keepdim=True)
                rs = torch.rsqrt(s[:, :, :1] + 1e-30)
                scale.append(rs)
                Q[:, :, j + 1:p1] -= ((s[:, :, 1:] * rs) * rs) * xj
            Q[:, :, p0:p1] *= torch.cat(scale, dim=2)
            if p1 < k:
                for j in range(p0, p1):
                    q = Q[:, :, j:j + 1]
                    coef = (Q[:, :, p1:] * q).sum(1, keepdim=True)
                    Q[:, :, p1:] -= coef * q
    return Q


def mgs_qr(X: torch.Tensor) -> torch.Tensor:
    """Kernel K4 (replaces ``dealii_slod_tpu/ops/eig.py: mgs_qr_pallas``):
    the thin Q of X (B, n, k) by two-pass modified Gram-Schmidt, the same
    contract as a Householder thin Q up to column signs and the completion
    of a rank-deficient block (a null column gives a zero column).  On CUDA
    one CTA per matrix, a warp holding a block of rows, a lane one column
    of it (four in the float32 chain at n = 375).
    For k <= 32 (the float32 paths) it is bound by the 2k-step chain: the
    columns stay in registers and a step is one CTA-wide sum of the Gram
    row (one barrier), so what costs is each step's latency and, at
    n = 375, the pivot column's delivery from shared memory.  For k > 32
    (float64 keeps every direction) it is bound by FLOPs and the reads of
    q: each pass runs that chain on panels of 32 columns, then updates
    every later column once per panel (by the whole CTA at n <= 128, by
    each warp on its own columns beyond); the columns sit in shared memory
    where they fit and in a global workspace otherwise (the kernel's size
    rule).  At n <= 384 the kernel sums in ``mgs_qr_panel_plain``'s order;
    beyond, a warp per later column and step in ``mgs_qr_plain``'s."""
    if not X.is_cuda:
        return mgs_qr_plain(X)
    B, n, k = X.shape
    kernels.check_cuda("mgs_qr", X, contiguous=False)
    X = X.contiguous()
    Q = torch.empty_like(X)
    ws = kernels.workspace("K4 mgs_qr", "slod_mgs_qr", X.dtype, X.device, B,
                           n, k)
    kernels.launch("K4 mgs_qr", "slod_mgs_qr", X.dtype, X.device,
                   X.data_ptr(), Q.data_ptr(), _ptr(ws), B, n, k)
    return Q


# ---------------------------------------------------------------------------
# K8: W = Z^T Y built in the kernel, then K5's sweeps
# ---------------------------------------------------------------------------

def weig_plain(ZT: torch.Tensor, YT: torch.Tensor, sweeps: int = 8,
               tol: float = 0.0, null_rel: float | None = None,
               block: int | None = None):
    """Plain version of K8: W = ZT YT^T (W[i, j] = sum_l ZT[i, l] YT[j, l],
    not symmetrized) by ``bmm``, then K5's plain sweeps on its rows.
    ``block`` matrices share the adaptive stop; the default is the whole
    batch, as the TPU kernel's single grid step shares it."""
    if null_rel is None:
        null_rel = _default_null_rel(ZT.dtype)
    B, k, _ = ZT.shape
    W = torch.bmm(ZT, YT.mT)
    XT, XB = jacobi_rows_plain(W, sweeps, block or B, tol, null_rel)
    return _finalize_rows(XT, XB, k, (B,))


def _weig_cuda(ZT: torch.Tensor, YT: torch.Tensor, sweeps: int, tol: float,
               null_rel: float, counts: bool = False):
    """K8's launch on contiguous ZT, YT (B, k, n) on the card -> (lam, V),
    and with ``counts`` the sweeps each matrix ran (B,) int32 as a third
    output."""
    B, k, n = ZT.shape
    kernels.check_cuda("weig", ZT, YT)
    lam = torch.empty((B, k), dtype=ZT.dtype, device=ZT.device)
    V = torch.empty((B, k, k), dtype=ZT.dtype, device=ZT.device)
    cnt = (torch.empty(B, dtype=torch.int32, device=ZT.device) if counts
           else None)
    # K8 works in float64 at either input type: so do its global rows
    ws = kernels.workspace("K8 weig", "slod_weig", torch.float64, ZT.device,
                           B, k)
    kernels.launch("K8 weig", "slod_weig", ZT.dtype, ZT.device,
                   ZT.data_ptr(), YT.data_ptr(), _ptr(cnt), lam.data_ptr(),
                   V.data_ptr(), _ptr(ws), B, k, n, sweeps, float(tol),
                   float(null_rel), _eps(ZT.dtype))
    return (lam, V, cnt) if counts else (lam, V)


def weig(ZT: torch.Tensor, YT: torch.Tensor, sweeps: int = 8,
         tol: float = 0.0, null_rel: float | None = None,
         block: int | None = None):
    """Kernel K8 (replaces ``dealii_slod_tpu/ops/eig.py: weig_pallas``): the
    eigenpairs of W = Z^T Y from the transposed factors ZT, YT (B, k, n),
    k even, for W = Z^T G Z with G SPD.  Returns (eigenvalues descending
    (B, k), eigenvectors as columns (B, k, k)).  On CUDA the launch takes
    K5's float64 route at row length k (``k8_route``) and builds W, not
    symmetrized, straight into the storage that route sweeps: at k = 32 a
    warp per matrix forms W on the tensor cores and hands it over so that
    lane l holds column l; at k <= 128 one CTA per matrix, W's rows formed
    in shared memory by a tiled product; at k = 374 a thread-block cluster
    per matrix, each CTA forming the rows its warps hold in registers (no
    workspace); beyond, a warp per W entry into LoopRows' rows.  W is
    summed, and swept, in float64 at either input type, and the eigenpairs
    are rounded to the input type once: in float32 arithmetic (the plain
    version's, or any order of summation the kernel could take) the
    adaptive stop falls a sweep apart from the float64 plain version's on
    a few in a thousand of the main path's W, which puts some chunks over
    the float32 gate.  Each matrix stops on its own and the kernel writes
    the sorted, normalized eigenpairs.  ``block`` applies to the plain
    version only."""
    B, k, n = ZT.shape
    if k % 2 or YT.shape != ZT.shape:
        raise ValueError(f"weig: ZT {tuple(ZT.shape)}, YT {tuple(YT.shape)}"
                         " must match, with k even")
    if not ZT.is_cuda:
        return weig_plain(ZT, YT, sweeps, tol, null_rel, block)
    if null_rel is None:
        null_rel = _default_null_rel(ZT.dtype)
    kernels.check_cuda("weig", ZT, YT, contiguous=False)
    return _weig_cuda(ZT.contiguous(), YT.contiguous(), sweeps, tol,
                      null_rel)


# ---------------------------------------------------------------------------
# The smallk spectral stage
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def smallk_start(n: int, k: int, dtype, device) -> torch.Tensor:
    """The deterministic shared orthonormal start block Z0 (n, k) of the
    inverse subspace iteration (the reference's exact constant).  Cached,
    read-only: a host-to-device copy from pageable memory per chunk would
    make the host wait for the device to drain before every chunk."""
    rng = np.random.default_rng(0)
    Z0 = np.linalg.qr(rng.standard_normal((n, k)))[0]
    return torch.as_tensor(Z0, dtype=dtype, device=device)


def smallk_truncated_dvec(G: torch.Tensor, g0: torch.Tensor, k: int = 32,
                          power_steps: int = 3, small_tol: float = 0.0,
                          weig_fused: bool = False,
                          block: int | None = None) -> torch.Tensor:
    """SLOD stabilization coefficients from the smallest ``k`` spectral
    directions of the Grams G (B, n, n) with projections g0 (B, n) -> dvec
    (B, n): the Tikhonov solve ``d0 = -(G + delta I)^-1 g0`` (K2), then
    ``power_steps`` inverse subspace steps ``Z = K4((G + delta I)^-1 Z)``
    from a fixed start, the Rayleigh-Ritz pairs of W = Z^T (G + delta I) Z
    (8 sweeps at most of K5 on the symmetrized W, or of K8 building W
    itself when ``weig_fused``), and the reference's latched ascending removal scan
    ``d <- d - v_i (v_i^T d0)`` while ||d||_inf >= 0.5 (LOD.cc:703-725).

    A zero Gram (a patch covering the whole domain) gives dvec = 0 and
    stays finite.  ``block``: matrices sharing the W-stage Jacobi stop in
    the plain versions (None: as the TPU kernels, ``min(B, 1024)`` for K5
    and the whole batch for K8; 1: each on its own, as the CUDA kernels).
    """
    B, n, _ = G.shape
    dt, dev = G.dtype, G.device
    jitter = JITTER[dt]
    dmax = torch.diagonal(G, dim1=-2, dim2=-1).abs().amax(-1)
    ok = dmax > 0
    delta = jitter * torch.where(ok, dmax, 1.0)
    Gj = G + delta[:, None, None] * torch.eye(n, dtype=dt, device=dev)
    Ginv = spd_inverse_schur(Gj)
    d0 = -torch.einsum("bij,bj->bi", Ginv, g0)
    d0 = torch.where(ok[:, None], d0, 0.0)
    k = min(int(k), n)
    k -= k % 2
    if k <= 0:
        return d0
    Z = smallk_start(n, k, dt, dev).expand(B, n, k)
    for _ in range(max(1, power_steps)):
        Z = mgs_qr(Ginv @ Z)
    if weig_fused:
        ZT = Z.mT.contiguous()                          # (B, k, n)
        lw, U = weig(ZT, ZT @ Gj, sweeps=8, tol=small_tol, block=block)
    else:
        W = Z.mT @ Gj @ Z
        W = 0.5 * (W + W.mT)
        lw, U = jacobi_eigh(W, sweeps=8, tol=small_tol,
                            block=block or min(B, 1024))
    V = Z @ U                                           # descending lambda
    V = V * torch.rsqrt((V * V).sum(1, keepdim=True) + 1e-30)
    proj = torch.einsum("bik,bi->bk", V, d0)            # (B, k)
    rev_terms = -(V * proj[:, None, :]).mT.flip(1)      # ascending, (B, k, n)
    dvec = _truncation_scan(d0, rev_terms)
    return torch.where(ok[:, None], dvec, 0.0)


def _truncation_scan(d0, rev_terms):
    """The sigma-truncation conditioning loop (LOD.cc:703-725): starting at
    ``d0``, add the terms ``rev_terms`` (B, K, n) one by one while
    ||d||_inf >= 0.5.  The latched scan is evaluated at once: the partial
    sums of all prefixes, then the first that passes the test."""
    K = rev_terms.shape[1]
    partial = torch.cumsum(torch.cat([d0[:, None], rev_terms], dim=1), dim=1)
    ok = partial[:, :K].abs().amax(-1) < 0.5                   # (B, K)
    first = torch.where(ok.any(1), ok.to(torch.int8).argmax(1), K)
    return partial[torch.arange(d0.shape[0], device=d0.device), first]
