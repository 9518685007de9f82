"""The port's CUDA kernels against their plain versions, and a small f64
step on the card against the same step on the CPU.  These need an NVIDIA
GPU with nvcc (the kernels build at first use) and skip elsewhere:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu_torch.config import ReductionControl, SLODConfig
from dealii_slod_tpu_torch.grid import cartesian_coords
from dealii_slod_tpu_torch.ops import assembly, eig, patch_solve
from dealii_slod_tpu_torch.utils import kernels

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def spd(rng, B, n):
    M = rng.standard_normal((B, n, n))
    return torch.from_numpy(M @ M.transpose(0, 2, 1) / n + np.eye(n))


@pytest.mark.parametrize("n0", [100, 250])
def test_k1_matches_plain(cuda, n0):
    rng = np.random.default_rng(n0)
    A, B = spd(rng, 5, n0).to(cuda), torch.from_numpy(
        rng.standard_normal((5, n0, 60))).to(cuda)
    X, T = patch_solve.fused_spd_multirhs(A, B)
    Xr, Tr = patch_solve.fused_spd_multirhs_plain(A, B)
    assert rel(X, Xr) <= 1e-10 and rel(T, Tr) <= 1e-10


def _gate(dtype, plain_err):
    """float64 within 1e-10 of the float64 plain version; float32 against it
    within 4x the float32 plain version's own error + 1e-6."""
    return 1e-10 if dtype == torch.float64 else 4 * plain_err + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 3, 384])
@pytest.mark.parametrize("m", [1, 5, 64, 125, 128])
def test_k2_matches_plain(cuda, m, B, dtype):
    """The register-tiled sweep (the kernel extends m to 128 with the
    identity), over batches below and above one CTA per SM; also on a
    strided view (the leading block of a larger batch, read in place)."""
    A = spd(np.random.default_rng(1000 * m + B), B, m).to(cuda)
    ref = patch_solve.gj_inverse_plain(A)
    a = A.to(dtype)
    big = torch.zeros((B, m + 3, m + 5), dtype=dtype, device=cuda)
    big[:, :m, :m] = a
    kernels.reset_launch_counts()
    out = patch_solve.gj_inverse(a)
    out_view = patch_solve.gj_inverse(big[:, :m, :m])
    assert kernels.launches["K2 gj_inverse"] == 2 and out.shape == A.shape
    assert torch.equal(out, out_view)
    plain_err = rel(patch_solve.gj_inverse_plain(a).double(), ref)
    err = rel(out.double(), ref)
    assert err <= _gate(dtype, plain_err), (err, plain_err)


@pytest.mark.parametrize("n0, k0", [(300, 17), (700, 500)])
def test_k6_matches_plain(cuda, n0, k0):
    """The solve-only leaf, padded n and a wide right-hand side."""
    rng = np.random.default_rng(n0)
    A, B = spd(rng, 3, n0).to(cuda), torch.from_numpy(
        rng.standard_normal((3, n0, k0))).to(cuda)
    kernels.reset_launch_counts()
    X = patch_solve.spd_multirhs_solve(A, B)
    assert kernels.launches["K6 spd_multirhs_solve"] == 1
    assert rel(X, patch_solve.spd_multirhs_solve_plain(A, B)) <= 1e-10


def _spd_on(device, seed, P, n, k):
    """SPD blocks and right-hand sides made on the device from a seed, in
    float64."""
    gen = torch.Generator(device=device).manual_seed(seed)
    M = torch.randn((P, n, n), generator=gen, device=device,
                    dtype=torch.float64)
    A = M @ M.mT / n + torch.eye(n, device=device, dtype=torch.float64)
    return A, torch.randn((P, n, k), generator=gen, device=device,
                          dtype=torch.float64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k0", [3, 125, 375, 642])
@pytest.mark.parametrize("n0", [64, 125, 267, 729, 1152])
def test_k1_k6_shapes_match_plain(cuda, n0, k0, dtype):
    """K1 and K6 over batch sizes below, at and above one CTA per SM, padded
    and unpadded n and k, one to eighteen panels.  float64 within 1e-10 of
    the plain version; float32 against the float64 plain version within 4x
    the float32 plain version's own error + 1e-6 (the summation order
    differs, the arithmetic does not)."""
    for P in (1, 3, 128, 200):
        A, B = _spd_on(cuda, 1000 * n0 + k0 + P, P, n0, k0)
        Xr, Tr = patch_solve.fused_spd_multirhs_plain(A, B)
        a, b = A.to(dtype), B.to(dtype)
        kernels.reset_launch_counts()
        X, T = patch_solve.fused_spd_multirhs(a, b)
        X6 = patch_solve.spd_multirhs_solve(a, b)
        assert kernels.launches["K1 fused_spd_multirhs"] == 1
        assert kernels.launches["K6 spd_multirhs_solve"] == 1
        assert X.shape == X6.shape == Xr.shape and T.shape == Tr.shape
        errs = (rel(X.double(), Xr), rel(T.double(), Tr),
                rel(X6.double(), Xr))
        if dtype == torch.float64:
            bounds = (1e-10,) * 3
        else:
            Xp, Tp = patch_solve.fused_spd_multirhs_plain(a, b)
            bx = 4 * rel(Xp.double(), Xr) + 1e-6
            bounds = (bx, 4 * rel(Tp.double(), Tr) + 1e-6, bx)
        assert all(e <= b_ for e, b_ in zip(errs, bounds)), (P, errs, bounds)


def test_split_on_k6_leaves_matches_plain(cuda):
    """The recursive Schur split at n = 1500 (two K6 leaves) against one
    Cholesky solve, X and T."""
    rng = np.random.default_rng(5)
    A, B = spd(rng, 2, 1500).to(cuda), torch.from_numpy(
        rng.standard_normal((2, 1500, 40))).to(cuda)
    kernels.reset_launch_counts()
    X, T = patch_solve.fused_spd_multirhs_split(A, B)
    Xr, Tr = patch_solve.fused_spd_multirhs_plain(A, B)
    assert kernels.launches["K6 spd_multirhs_solve"] == len(
        patch_solve.split_leaves(1500, 40, 128)) == 2
    assert rel(X, Xr) <= 1e-10 and rel(T, Tr) <= 1e-10


def _trace_inputs(rng, dims, C, B, k, dtype):
    """band (B, nN, 3^dim C^2) and Xp (B, C, nN + 2 shiftN, k) on a canvas
    of ``dims`` nodes per axis (x fastest), the stencil offsets in the
    port's order and the shift."""
    dims = np.asarray(dims)
    strides = np.concatenate([[1], np.cumprod(dims[:-1])])
    offs = tuple(int(o) for o in
                 (cartesian_coords(np.full(len(dims), 3)) - 1) @ strides)
    shiftN, nN = int(strides.sum()), int(dims.prod())
    band = torch.from_numpy(rng.standard_normal(
        (B, nN, 3 ** len(dims) * C * C)))
    Xp = torch.nn.functional.pad(
        torch.from_numpy(rng.standard_normal((B, C, nN, k))),
        (0, 0, shiftN, shiftN))
    return band.to(dtype), Xp.to(dtype), shiftN, offs


def _trace_gate(dtype, band, Xp, shiftN, offs, ref):
    """float64 within 1e-12 of the float64 plain version; float32 within
    4x the float32 plain version's own error + 1e-6."""
    if dtype == torch.float64:
        return 1e-12
    return 4 * rel(assembly.stencil_trace_plain(band, Xp, shiftN, offs)
                   .double(), ref) + 1e-6


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [1, 3, 20, 125])
@pytest.mark.parametrize("dim, C, n", [(3, 1, 7), (2, 2, 7), (3, 3, 7),
                                       (3, 1, 11), (3, 3, 11), (2, 2, 37)])
def test_k3_k7_match_plain(cuda, dim, C, n, k, dtype):
    """K3 (C = 1) and K7 (C = 2, 3) on an n^dim canvas (7^3 and 11^3 = 1331
    nodes, 37^2 = 1369: none a multiple of the 64-node tile; 11^3 is the
    main path's, shiftN 133), k on both sides of the per-output routine's
    threshold (16: the A phi calls' k = C) and at the main path's 125."""
    rng = np.random.default_rng(2 + C + n + k)
    band, Xp, shiftN, offs = _trace_inputs(rng, (n,) * dim, C, 2, k,
                                           torch.float64)
    ref = assembly.stencil_trace_plain(band.to(cuda), Xp.to(cuda), shiftN,
                                       offs)
    band, Xp = band.to(cuda, dtype), Xp.to(cuda, dtype)
    kernels.reset_launch_counts()
    S = assembly.stencil_trace(band, Xp, shiftN, offs)
    assert kernels.launches["K3 stencil_trace" if C == 1
                            else "K7 stencil_trace"] == 1
    assert S.dtype == dtype and S.shape == ref.shape
    assert rel(S.double(), ref) <= _trace_gate(dtype, band, Xp, shiftN,
                                               offs, ref)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("C", [1, 3])
def test_k3_k7_any_offset_order(cuda, C, dtype):
    """Offsets that do not come as dx-triples (the stencil's order shuffled,
    band columns with them) take the per-output routine at k = 125."""
    rng = np.random.default_rng(40 + C)
    band, Xp, shiftN, offs = _trace_inputs(rng, (9, 8, 7), C, 3, 125,
                                           torch.float64)
    perm = rng.permutation(len(offs))
    offs = tuple(offs[i] for i in perm)
    band = band.reshape(3, band.shape[1], len(perm), C * C)[:, :, perm]
    band = band.reshape(3, band.shape[1], -1).contiguous()
    ref = assembly.stencil_trace_plain(band.to(cuda), Xp.to(cuda), shiftN,
                                       offs)
    band, Xp = band.to(cuda, dtype), Xp.to(cuda, dtype)
    S = assembly.stencil_trace(band, Xp, shiftN, offs)
    assert rel(S.double(), ref) <= _trace_gate(dtype, band, Xp, shiftN,
                                               offs, ref)


def _k5_inputs(rng, B, n, deficient):
    """PSD (B, n, n) in a random basis with the spectrum linspace(0.1, 1, n)
    (n <= 32), or for larger n linspace(0.1, 0.5, n - 12) and twelve values
    from 0.55 to 1, so that some eigenpairs lie more than 1e-2 lambda_max
    from their neighbours and the float32 vectors are compared too;
    ``deficient``: rows and columns 0 and n // 2 (n > 2: also n - 1) zeroed
    in every matrix, and the last matrix all zero."""
    Q, _ = np.linalg.qr(rng.standard_normal((B, n, n)))
    spec = (np.linspace(0.1, 1.0, n) if n <= 32 else np.concatenate(
        [np.linspace(0.1, 0.5, n - 12), np.linspace(0.55, 1.0, 12)]))
    G = (Q * spec) @ Q.transpose(0, 2, 1)
    if deficient:
        idx = sorted({0, n // 2, n - 1} if n > 2 else {1})
        G[:, idx, :] = 0.0
        G[:, :, idx] = 0.0
        G[-1] = 0.0
    return torch.from_numpy(G)


def _k5_plain(g, tol):
    """The plain K5 (block=1, at most 30 sweeps) on the card, sorted."""
    XT, XB = eig.jacobi_rows_plain(g, 30, 1, tol,
                                   eig._default_null_rel(g.dtype))
    return eig._finalize_rows(XT, XB, g.shape[-1], (g.shape[0],))


def _k5_errs(out, ref, sep_rel):
    """(eigenvalue error relative to lambda_max, error of the eigenvectors,
    up to sign, of eigenpairs separated from their neighbours by more than
    sep_rel lambda_max; a zero matrix's lambda_max counts as 1e-300)."""
    lam, V = (t.double() for t in out)
    lam_r, V_r = ref
    lmax = lam_r[:, :1].clamp_min(1e-300)
    e_lam = float(((lam - lam_r).abs() / lmax).max())
    gaps = (lam_r[:, :, None] - lam_r[:, None, :]).abs() / lmax[:, :, None]
    gaps = gaps + torch.eye(gaps.shape[-1], dtype=gaps.dtype,
                            device=gaps.device) * 1e300
    sep = (gaps.amin(-1) > sep_rel)[:, None, :]
    sgn = torch.sign((V * V_r).sum(-2, keepdim=True))
    return e_lam, float(((V * sgn - V_r).abs() * sep).max())


# the kernel's sorted eigenpairs against _finalize_rows on its rows: the
# norms' order of summation differs, so eigenpairs nearer than this
# (relative to lambda_max) may swap, and agree to about it
_SAME = {torch.float32: 1e-5, torch.float64: 1e-12}


def _same_as_rows(out, XT, XB, n0):
    """(eigenvalue, separated-eigenvector) differences between the kernel's
    own sort and normalization ``out`` and ``_finalize_rows`` on the rows
    (XT, XB) of the same matrices."""
    ref = eig._finalize_rows(XT, XB, n0, (XT.shape[0],))
    return _k5_errs(out, tuple(t.double() for t in ref),
                    100 * _SAME[XT.dtype])


@pytest.mark.parametrize("deficient", [False, True])
@pytest.mark.parametrize("tol", [0.0, 3e-6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 5, 384])
@pytest.mark.parametrize("n", [2, 30, 32, 126])
def test_k5_matches_plain_block1(cuda, n, B, dtype, tol, deficient):
    """K5 against the plain version with each matrix stopping on its own
    (block=1), at most 30 sweeps: n = 32 runs the warp-per-matrix routine,
    the other n the CTA routine.  float64: eigenvalues within 1e-10 of
    lambda_max, separated eigenvectors within 1e-8; float32 against the
    float64 plain version within 4x the float32 plain version's error +
    1e-6.  Zero rows stay exactly zero (no rotation touches them).  The
    kernel's own sort and normalization agree with ``_finalize_rows`` on
    the rows it writes otherwise (the norms' order of summation differs).
    Every matrix reports the sweeps it ran."""
    G = _k5_inputs(np.random.default_rng(n * B), B, n, deficient).to(cuda)
    ref = _k5_plain(G, tol)
    g = G.to(dtype)
    kernels.reset_launch_counts()
    out = eig.jacobi_eigh(g, sweeps=30, tol=tol)
    assert kernels.launches["K5 jacobi_eigh"] == 1
    sep = 1e-6 if dtype == torch.float64 else 1e-2
    e_lam, e_vec = _k5_errs(out, ref, sep)
    if dtype == torch.float64:
        assert e_lam <= 1e-10 and e_vec <= 1e-8, (e_lam, e_vec)
    else:
        base = max(_k5_errs(_k5_plain(g, tol), ref, sep))
        assert max(e_lam, e_vec) <= 4 * base + 1e-6, (e_lam, e_vec, base)
    if deficient:
        assert bool((out[0][-1] == 0).all()) and bool((out[1][-1] == 0).all())
    XT, XB, counts = eig._jacobi_rows_cuda(g, 30, tol,
                                           eig._default_null_rel(dtype),
                                           counts=True)
    assert max(_same_as_rows(out, XT, XB, n)) <= _SAME[dtype]
    assert counts.shape == (B,) and bool((counts >= 1).all())
    assert bool((counts <= 30).all()) and (tol > 0 or bool((counts == 30)
                                                            .all()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n0", [31, 125])
def test_k5_odd_n_drops_pad_row(cuda, n0, dtype):
    """An odd n is padded with a zero row and column (n0 = 31: the warp
    routine, 125: the CTA routine); the kernel's sort drops the pad row as
    ``_finalize_rows`` does on the padded rows."""
    G = _k5_inputs(np.random.default_rng(n0), 6, n0, False).to(cuda)
    g = G.to(dtype)
    lam, V = eig.jacobi_eigh(g, sweeps=30, tol=3e-6)
    assert lam.shape == (6, n0) and V.shape == (6, n0, n0)
    gp = torch.nn.functional.pad(g, (0, 1, 0, 1))
    XT, XB = eig._jacobi_rows_cuda(gp, 30, 3e-6, eig._default_null_rel(dtype))
    assert max(_same_as_rows((lam, V), XT, XB, n0)) <= _SAME[dtype]


def test_k5_converged_matches_plain(cuda):
    """30 fixed sweeps (converged) on a logspace spectrum at n = 125 (padded
    to 126): with the adaptive stop at 3e-6 this random spectrum's
    early-stopped vectors move ~4e-7 under a 1e-15 input perturbation, so
    only a converged run compares at 1e-8."""
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.standard_normal((9, 125, 125)))
    G = torch.from_numpy((Q * np.logspace(-3, 0, 125)) @ Q.transpose(0, 2, 1))
    lam, V = eig.jacobi_eigh(G.to(cuda), sweeps=30)
    lam_r, V_r = eig.jacobi_eigh(G, sweeps=30, block=1)
    assert rel(lam.cpu(), lam_r) <= 1e-10
    sgn = torch.sign((V.cpu() * V_r).sum(-2, keepdim=True))
    assert float((V.cpu() * sgn - V_r).abs().max()) <= 1e-8


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n, k", [
    (125, 32), (125, 124),                     # the existing cases
    (125, 22), (375, 22), (375, 32),           # the chain in registers
    (125, 33), (125, 125),                     # panels, columns in shared
    (375, 33), (375, 124), (375, 374), (375, 375),  # panels, global columns
    (500, 40)])                                # n > 384: the generic route
def test_k4_matches_plain(cuda, n, k, dtype):
    """MGS2 on a well-conditioned block (columns scaled by
    logspace(0, -5)): the same arithmetic in another summation order.
    float64 within 1e-10 of the plain version and, at n <= 384, of its
    twin in the kernel's order; float32 within 4x the plain float32
    version's error + 1e-6 of the plain float64 one."""
    rng = np.random.default_rng(k)
    X = torch.from_numpy(rng.standard_normal((6, n, k))
                         * np.logspace(0, -5, k))
    X[1, :, 4] = 0.0                         # a null column stays zero
    kernels.reset_launch_counts()
    Q = eig.mgs_qr(X.to(cuda, dtype)).cpu()
    assert kernels.launches["K4 mgs_qr"] == 1
    ref = eig.mgs_qr_plain(X)
    err = rel(Q.double(), ref)
    plain_err = rel(eig.mgs_qr_plain(X.to(cuda, dtype)).cpu().double(), ref)
    assert err <= _gate(dtype, plain_err), (err, plain_err)
    if dtype == torch.float64 and n <= 384:
        assert rel(Q, eig.mgs_qr_panel_plain(X)) <= 1e-10
    assert bool((Q[1, :, 4] == 0).all())


@pytest.mark.parametrize("n, k", [(125, 124), (375, 374)])
def test_k4_null_columns_across_panels(cuda, n, k):
    """Null columns in the first panel, on a panel boundary and in the last
    panel stay exactly zero (float64, columns in shared memory and in the
    global workspace)."""
    rng = np.random.default_rng(n)
    X = torch.from_numpy(rng.standard_normal((2, n, k))
                         * np.logspace(0, -5, k))
    null = [3, 32, k - 1]
    X[:, :, null] = 0.0
    Q = eig.mgs_qr(X.to(cuda)).cpu()
    assert bool((Q[:, :, null] == 0).all())
    assert rel(Q, eig.mgs_qr_panel_plain(X)) <= 1e-10


def test_k4_k5_global_rows_match_plain(cuda):
    """Float64 at the elasticity Gram size, n = 375, k = 374: the columns
    do not fit in one CTA's shared memory, so K4 works in a global
    workspace; K5's 374 x 374 rows take a thread-block cluster, which
    needs none."""
    rng = np.random.default_rng(374)
    X = torch.from_numpy(rng.standard_normal((2, 375, 374))
                         * np.logspace(0, -3, 374))
    assert kernels.workspace("K4", "slod_mgs_qr", X.dtype, cuda, 2, 375,
                             374).numel() == 2 * 375 * 374
    assert kernels.workspace("K4", "slod_mgs_qr", X.dtype, cuda, 2, 375,
                             32) is None            # fits: shared memory
    assert kernels.workspace("K5", "slod_jacobi_rows", X.dtype, cuda, 2,
                             374) is None           # a cluster's rows
    assert rel(eig.mgs_qr(X.to(cuda)).cpu(), eig.mgs_qr_plain(X)) <= 1e-10
    Q, _ = np.linalg.qr(rng.standard_normal((2, 374, 374)))
    G = torch.from_numpy((Q * np.logspace(-3, 0, 374)) @ Q.transpose(0, 2, 1))
    lam, V = eig.jacobi_eigh(G.to(cuda), sweeps=30)
    lam_r, V_r = eig.jacobi_eigh(G, sweeps=30, block=1)
    assert rel(lam.cpu(), lam_r) <= 1e-10
    sgn = torch.sign((V.cpu() * V_r).sum(-2, keepdim=True))
    assert float((V.cpu() * sgn - V_r).abs().max()) <= 1e-8


def _plain_sweeps(g, sweeps, tol):
    """The sweeps each matrix of g (B, n, n) runs in the plain version under
    the per-matrix stop (block=1): its loop, counting."""
    B, n, _ = g.shape
    null_rel, eps = eig._default_null_rel(g.dtype), eig._eps(g.dtype)
    XT, XB = g[:, 0::2].clone(), g[:, 1::2].clone()
    a0, b0 = (XT * XT).sum(-1, keepdim=True), (XB * XB).sum(-1, keepdim=True)
    amax2 = torch.maximum(a0, b0).amax(-2, keepdim=True)
    off = torch.full((B,), eig._F32_MAX, dtype=g.dtype, device=g.device)
    active = torch.ones(B, dtype=torch.bool, device=g.device)
    count = torch.zeros(B, dtype=torch.int64, device=g.device)
    for _ in range(sweeps):
        active = active & (off > tol)
        if not bool(active.any()):
            break
        count += active
        XT0, XB0 = XT, XB
        a, b = (XT * XT).sum(-1, keepdim=True), (XB * XB).sum(-1, keepdim=True)
        o = g.new_zeros(B)
        for _ in range(n - 1):
            XT, XB, a, b, o = eig._caterpillar_round_nj(
                XT, XB, a, b, eps, off=o, amax2=amax2, null_rel=null_rel)
        act = active[:, None, None]
        XT, XB = torch.where(act, XT, XT0), torch.where(act, XB, XB0)
        off = torch.where(active, o, off)
    return count.cpu()


def _w_like(rng, B, n, deficient):
    """B PSD (n, n) W built as the smallk stage builds them: G (n + 1) x
    (n + 1) with eigenvalues logspace(-13, 0) in a random basis, three
    inverse subspace steps on n directions from a fixed start, W = Z^T G
    Z (these stop after ~5-7 sweeps at tol 3e-6, as the path's W do);
    ``deficient``: rows and columns 0, n // 2 and n - 1 zeroed, and the
    last matrix all zero."""
    Q, _ = np.linalg.qr(rng.standard_normal((B, n + 1, n + 1)))
    G = (Q * np.logspace(-13, 0, n + 1)) @ Q.transpose(0, 2, 1)
    Gi = np.linalg.inv(G)
    Z = np.broadcast_to(np.linalg.qr(rng.standard_normal((n + 1, n)))[0],
                        (B, n + 1, n))
    for _ in range(3):
        Z = np.linalg.qr(Gi @ Z)[0]
    W = Z.transpose(0, 2, 1) @ G @ Z
    W = 0.5 * (W + W.transpose(0, 2, 1))
    if deficient:
        idx = [0, n // 2, n - 1]
        W[:, idx, :] = 0.0
        W[:, :, idx] = 0.0
        W[-1] = 0.0
    return torch.from_numpy(np.ascontiguousarray(W))


@pytest.mark.parametrize("deficient", [False, True])
@pytest.mark.parametrize("n, dtype", [(374, torch.float64),
                                      (376, torch.float32),
                                      (200, torch.float64)])
def test_k5_cluster_matches_plain_block1(cuda, n, dtype, deficient):
    """K5's thread-block cluster route (rows beyond one CTA's shared
    memory: the float64 elasticity W at 374, float32 at 376, float64 at
    200) on W built as the smallk stage builds them, against the plain
    version with each matrix stopping on its own (block=1, tol 3e-6, at
    most 30 sweeps), to the tolerances of ``test_k5_matches_plain_block1``;
    no workspace, the cluster size of ``eig.k5_cluster_plan``, the sweeps
    each matrix ran equal to the plain version's in the same dtype, and
    the kernel's sort agreeing with ``_finalize_rows`` on the rows it
    writes.  (On ``_k5_inputs``' spectrum, 362 of 374 eigenvalues within
    0.1-0.5, the sweeps stop at tol 3e-6 far from convergence, where two
    summation orders part by ~5e-10 in the eigenvalues: the converged
    comparison at 374 is ``test_k4_k5_global_rows_match_plain``'s.)"""
    B = 3
    G = _w_like(np.random.default_rng(n), B, n, deficient).to(cuda)
    g = G.to(dtype)
    S = kernels.query("slod_jacobi_rows_cluster", dtype, cuda, n)
    assert S > 0 and S == eig.k5_cluster_plan(n, g.element_size())["S"]
    assert kernels.workspace("K5", "slod_jacobi_rows", dtype, cuda, B,
                             n) is None
    ref = _k5_plain(G, 3e-6)
    kernels.reset_launch_counts()
    out = eig.jacobi_eigh(g, sweeps=30, tol=3e-6)
    assert kernels.launches["K5 jacobi_eigh"] == 1
    sep = 1e-6 if dtype == torch.float64 else 1e-2
    e_lam, e_vec = _k5_errs(out, ref, sep)
    if dtype == torch.float64:
        assert e_lam <= 1e-10 and e_vec <= 1e-8, (e_lam, e_vec)
    else:
        base = max(_k5_errs(_k5_plain(g, 3e-6), ref, sep))
        assert max(e_lam, e_vec) <= 4 * base + 1e-6, (e_lam, e_vec, base)
    if deficient:
        assert bool((out[0][-1] == 0).all()) and bool((out[1][-1] == 0).all())
    XT, XB, counts = eig._jacobi_rows_cuda(g, 30, 3e-6,
                                           eig._default_null_rel(dtype),
                                           counts=True)
    assert max(_same_as_rows(out, XT, XB, n)) <= _SAME[dtype]
    assert torch.equal(counts.cpu().long(), _plain_sweeps(g, 30, 3e-6))


def test_k5_global_rows_beyond_cluster(cuda):
    """Float64 at n = 700: no cluster holds the rows (the twin agrees), so
    K5 keeps LoopRows on a global workspace; against the plain version on a
    W built as the smallk stage builds them."""
    n = 700
    assert kernels.query("slod_jacobi_rows_cluster", torch.float64, cuda,
                         n) == 0
    assert eig.k5_cluster_plan(n, 8) is None
    assert kernels.workspace("K5", "slod_jacobi_rows", torch.float64, cuda,
                             1, n).numel() == n * n
    G = _w_like(np.random.default_rng(n), 1, n, False).to(cuda)
    e_lam, e_vec = _k5_errs(eig.jacobi_eigh(G, sweeps=30, tol=3e-6),
                            _k5_plain(G, 3e-6), 1e-6)
    assert e_lam <= 1e-10 and e_vec <= 1e-8, (e_lam, e_vec)


def _weig_like(rng, B, n, k, floor):
    """Factors as the smallk stage forms them: G (n, n) with eigenvalues
    logspace(floor, 0) in a random basis, three inverse subspace steps on
    k directions from a fixed start (Z from QR), ZT = Z^T and YT = ZT G."""
    Q, _ = np.linalg.qr(rng.standard_normal((B, n, n)))
    G = (Q * np.logspace(floor, 0, n)) @ Q.transpose(0, 2, 1)
    Gi = np.linalg.inv(G)
    Z = np.broadcast_to(np.linalg.qr(rng.standard_normal((n, k)))[0],
                        (B, n, k))
    for _ in range(3):
        Z = np.linalg.qr(Gi @ Z)[0]
    ZT = np.ascontiguousarray(Z.transpose(0, 2, 1))
    return torch.from_numpy(ZT), torch.from_numpy(ZT @ G)


# (n, k, dtype, tol, inputs): the first three on Grams of random factors
# (A A^T), the others path-like (_weig_like) at the shapes of the weig
# paths: main (125, 32), elasticity (375, 32), float64 main (125, 124) and
# float64 elasticity (375, 374)
_K8_CASES = [(125, 8, torch.float64, 0.0, "gram"),
             (125, 32, torch.float64, 3e-6, "gram"),
             (125, 124, torch.float64, 3e-6, "gram")] + [
    (n, k, dt, 3e-6, "path") for n, k, dt in [
        (125, 32, torch.float32), (125, 32, torch.float64),
        (375, 32, torch.float32), (375, 32, torch.float64),
        (125, 124, torch.float64), (375, 374, torch.float64)]]


@pytest.mark.parametrize("n, k, dtype, tol, inputs", _K8_CASES)
def test_k8_matches_plain_block1(cuda, n, k, dtype, tol, inputs):
    """W built in the kernel, then the sweeps (each matrix stops on its
    own, the plain version's block=1, at most 30 sweeps), on the route
    ``eig.k8_route`` names (the launcher's ``slod_weig_route``; no
    workspace except on global rows).  Grams of random factors: eigenvalues
    within 1e-10, vectors within 1e-8 of the float64 plain version.
    Path-like factors: float64 as ``test_k5_matches_plain_block1``,
    float32 within 4x the float32 plain version's error + 1e-6 of the
    float64 one; the sweeps each matrix ran equal the plain version's on
    the same inputs in float64, the type K8 sweeps in."""
    route = eig.k8_route(k)
    assert eig.K5_ROUTES[kernels.query("slod_weig_route", dtype, cuda,
                                       k)] == route
    ws = kernels.workspace("K8", "slod_weig", dtype, cuda, 1, k)
    assert (ws is not None) == (route == "global rows")
    rng = np.random.default_rng(k)
    if inputs == "gram":
        A = rng.standard_normal((5, n, n))
        Z = np.linalg.qr(rng.standard_normal((5, n, k)))[0]
        ZT = torch.from_numpy(Z.transpose(0, 2, 1).copy())
        YT = ZT @ torch.from_numpy(A @ A.transpose(0, 2, 1))
        lam, U = eig.weig(ZT.to(cuda), YT.to(cuda), sweeps=30, tol=tol)
        lam_r, U_r = eig.weig_plain(ZT, YT, sweeps=30, tol=tol, block=1)
        assert rel(lam.cpu(), lam_r) <= 1e-10
        sgn = torch.sign((U.cpu() * U_r).sum(-2, keepdim=True))
        assert float((U.cpu() * sgn - U_r).abs().max()) <= 1e-8
        return
    ZT, YT = (t.to(cuda) for t in _weig_like(
        rng, 3, n, k, -13 if dtype == torch.float64 else -6))
    ref = eig.weig_plain(ZT, YT, sweeps=30, tol=tol, block=1)
    zt, yt = ZT.to(dtype), YT.to(dtype)
    kernels.reset_launch_counts()
    out = eig.weig(zt, yt, sweeps=30, tol=tol)
    assert kernels.launches["K8 weig"] == 1
    sep = 1e-6 if dtype == torch.float64 else 1e-2
    e_lam, e_vec = _k5_errs(out, ref, sep)
    if dtype == torch.float64:
        assert e_lam <= 1e-10 and e_vec <= 1e-8, (e_lam, e_vec)
    else:
        plain = eig.weig_plain(zt, yt, sweeps=30, tol=tol, block=1)
        base = max(_k5_errs(plain, ref, sep))
        assert max(e_lam, e_vec) <= 4 * base + 1e-6, (e_lam, e_vec, base)
    counts = eig._weig_cuda(zt, yt, 30, tol, eig._default_null_rel(dtype),
                            counts=True)[2]
    assert torch.equal(counts.cpu().long(), _plain_sweeps(
        torch.bmm(zt.double(), yt.double().mT), 30, tol))


@pytest.mark.parametrize("eig_solver", ["jacobi", "smallk"])
def test_small_step_gpu_matches_cpu(cuda, eig_solver):
    """2D refine-2 l=1 in f64: CPU (plain versions, per-matrix Jacobi
    stop) and GPU (kernels) agree; every kernel of the route launched."""
    cfg = SLODConfig(dim=2, n_global_refinements=2, n_subdivisions=2,
                     oversampling=1, lod_stabilization=True,
                     constant_coefficients=False, coef_refinement=2,
                     dtype="float64", patch_chunk=8, eig_solver=eig_solver,
                     patch_solver="fused", eig_tol=3e-6, smallk_tol=3e-6,
                     coarse_solver=ReductionControl(200, 1e-12, 1e-12))
    out = {}
    kernels.reset_launch_counts()
    for dev in ("cpu", cuda):
        s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device=dev,
                         verbose=False, eig_block=1)
        s.assemble_fine_rhs()
        u, _ = s.build_step()(s.coef_q, s.fem_rhs)
        out[str(dev)] = s.prolong_lod_solution().cpu()
    assert rel(out["cuda"], out["cpu"]) <= 1e-8
    names = ["K1 fused_spd_multirhs", "K2 gj_inverse", "K3 stencil_trace",
             "K5 jacobi_eigh"]
    if eig_solver == "smallk":
        names.append("K4 mgs_qr")
    assert all(kernels.launches[k] > 0 for k in names)


def test_small_elasticity_step_gpu_matches_cpu(cuda):
    """3D refine-2 l=1 elasticity (C = 3) in f64 on the Schur-split route
    with the smallk stage: CPU and GPU agree; K2, K4, K5, K6, K7 launched
    (n = 375 > 128: the blocked T^-1 runs K2 on three pivots)."""
    cfg = SLODConfig(dim=3, n_global_refinements=2, n_subdivisions=2,
                     oversampling=1, lod_stabilization=True,
                     constant_coefficients=False, coef_refinement=3,
                     dtype="float64", patch_chunk=32, rhs="1; 1; 1",
                     eig_solver="smallk", patch_solver="fused_split",
                     smallk_tol=3e-6,
                     coarse_solver=ReductionControl(200, 1e-12, 1e-12))
    out = {}
    kernels.reset_launch_counts()
    for dev in ("cpu", cuda):
        s = pt.LODSolver(cfg, pt.ElasticityProblem(cfg), device=dev,
                         verbose=False, eig_block=1)
        s.assemble_fine_rhs()
        s.build_step()(s.coef_q, s.fem_rhs)
        out[str(dev)] = s.prolong_lod_solution().cpu()
    assert rel(out["cuda"], out["cpu"]) <= 1e-8
    assert all(kernels.launches[k] > 0 for k in (
        "K2 gj_inverse", "K4 mgs_qr", "K5 jacobi_eigh",
        "K6 spd_multirhs_solve", "K7 stencil_trace"))


def test_default_run_gpu_matches_cpu(cuda):
    """``run()`` on ``SLODConfig()`` (2D plain LOD, float64) on the card:
    the golden fem rhs l2 norm and dof counts, every table equal to the CPU
    run's to 1e-10, and K1, K2, K3 launched."""
    cfg = SLODConfig()
    out = {}
    kernels.reset_launch_counts()
    for dev in ("cpu", cuda):
        s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device=dev,
                         verbose=False)
        out[str(dev)] = s.run()
        assert abs(float(torch.linalg.norm(s.fem_rhs)) - 0.109375) <= 1e-15
        assert s.fem_solution.numel() == 81
        assert s.coarse_solution.numel() == 16
    assert list(out["cuda"]) == list(out["cpu"])
    for key, t in out["cpu"].items():
        if not hasattr(t, "rows"):
            continue
        got = out["cuda"][key].rows[0][2]
        for name, v in t.rows[0][2].items():
            assert abs(got[name] - v) <= 1e-10 * abs(v), (key, name)
    assert all(kernels.launches[k] > 0 for k in (
        "K1 fused_spd_multirhs", "K2 gj_inverse", "K3 stencil_trace"))


def test_trace_counters_match_the_profilers_trace(cuda, tmp_path):
    """Traced steps on the card (stencil-matvec CG, K1 on padded patch
    blocks): ``h2d_bytes`` is the trace's host-to-device copy bytes, and
    ``host_syncs`` its stream synchronisations inside the port's ranges.
    The first step after the basis and the coarse operator were built
    uploads the stencil tables (two pageable copies that wait) besides the
    CG's stop tests; the second uploads nothing (the tables stay on the
    card, and K1's padded operand is assembled there, so no pad uploads a
    scalar) and waits only on the stop tests."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from dealii_slod_tpu_torch.utils import timers
    cfg = SLODConfig(dim=3, n_global_refinements=2, oversampling=2,
                     lod_stabilization=True, constant_coefficients=False,
                     coef_seed=3, dtype="float32", patch_chunk=32,
                     coarse_dense_cap=8,
                     coarse_solver=ReductionControl(500, 1e-8, 1e-8))
    s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device=cuda,
                     verbose=False)
    s.assemble_fine_rhs()
    step = s.build_step()
    # the basis' and the stencil build's tables, and every kernel's build,
    # before the first traced step; the coarse solve has not run yet
    s.compute_basis()
    s.assemble_coarse_operator()
    torch.cuda.synchronize()

    def traced(k):
        timers.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(s.coef_q, s.fem_rhs)
            torch.cuda.synchronize()
        path = tmp_path / f"trace{k}.json"
        prof.export_chrome_trace(str(path))
        ev = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
        names = {r.name for r in timers.records()}
        ranges = [(e["ts"], e["ts"] + e["dur"], e.get("tid")) for e in ev
                  if e.get("cat") == "user_annotation"
                  and e["name"] in names]
        syncs = sum(1 for e in ev if e["name"] == "cudaStreamSynchronize"
                    and any(a <= e["ts"] < b and t == e.get("tid")
                            for a, b, t in ranges))
        h2d = sum(int(e["args"]["bytes"]) for e in ev
                  if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"])
        c = timers.counters()
        timers.clear()
        return c, syncs, h2d, int(s.coarse_cg.n_iter)

    tables = s.stencil_nbr_np.nbytes + s.stencil_valid_np.nbytes
    c, syncs, h2d, n = traced(1)
    assert sum(c.get("h2d_bytes", {}).values()) == h2d == tables > 0
    assert sum(c["host_syncs"].values()) == syncs
    # the stop tests and the two tables' uploads
    assert syncs == -(-n // 8) + 1 + 2
    c, syncs, h2d, n = traced(2)
    assert sum(c.get("h2d_bytes", {}).values()) == h2d == 0
    assert sum(c["host_syncs"].values()) == syncs
    # the stop tests alone
    assert syncs == -(-n // 8) + 1


def test_coarse_cg_graph_replays_match_eager(cuda):
    """3D refine-2 l=1 elasticity (C = 3) in float32 on the stencil-matvec
    CG (``coarse_dense_cap`` below the 192 coarse dofs): three coarse
    solves on one operator run eagerly, capture, then replay (read from
    ``cg.graph_iterations``), each with the eager CG's iteration count and
    answer; two replayed answers are distinct tensors that each match
    their own eager answer; an in-place change of the operator falls back
    to an eager solve."""
    from torch.profiler import ProfilerActivity, profile

    from dealii_slod_tpu_torch.models.coarse import CoarseSystem
    from dealii_slod_tpu_torch.ops.solvers import cg
    from dealii_slod_tpu_torch.utils import timers
    cfg = SLODConfig(dim=3, n_global_refinements=2, n_subdivisions=2,
                     oversampling=1, lod_stabilization=True,
                     constant_coefficients=False, coef_refinement=3,
                     dtype="float32", patch_chunk=32, rhs="1; 1; 1",
                     eig_solver="smallk", patch_solver="fused_split",
                     coarse_dense_cap=8,
                     coarse_solver=ReductionControl(500, 1e-6, 1e-6))
    s = pt.LODSolver(cfg, pt.ElasticityProblem(cfg), device=cuda,
                     verbose=False)
    s.assemble_fine_rhs()
    s.compute_basis()
    A = s.assemble_coarse_operator()
    assert s.topo.n_patches * s.C > cfg.coarse_dense_cap
    rc = cfg.coarse_solver

    def eager(b):
        diag = torch.einsum("pdd->pd", A[:, s.center_offset_idx])
        return cg(CoarseSystem(s, A).matvec, b, max_steps=rc.max_steps,
                  tolerance=rc.tolerance, reduce=rc.reduce,
                  precond=lambda r: r / diag)

    def solve(b):
        timers.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            res = CoarseSystem(s, A).cg(b)
            torch.cuda.synchronize()
        c = timers.counters()
        timers.clear()
        return res, sum(c.get("cg.graph_iterations", {}).values()), sum(
            c["cg.enqueued"].values())

    gen = torch.Generator(device=cuda).manual_seed(5)
    rhs = [torch.randn(A.shape[0], s.C, device=cuda, generator=gen)
           for _ in range(5)]
    answers = []
    for i, b in enumerate(rhs[:4]):
        res, graph_it, enq = solve(b)
        ref = eager(b)
        assert int(res.n_iter) == int(ref.n_iter) > 8
        assert rel(res.x, ref.x) <= 1e-6
        assert bool(res.converged)
        assert graph_it == (0 if i == 0 else enq) and enq > 0
        answers.append(res.x)
    plan = s._graph_plans._plan
    assert plan is not None and plan.captured
    statics = {t.data_ptr() for t in plan._state}
    assert len({x.data_ptr() for x in answers}) == 4
    assert not statics & {x.data_ptr() for x in answers}
    assert rel(answers[2], eager(rhs[2]).x) <= 1e-6
    assert float((answers[2] - answers[3]).abs().max()) > 0
    A.mul_(1.0)                          # in place: a new operator version
    res, graph_it, enq = solve(rhs[4])
    assert graph_it == 0 and enq > 0
    assert rel(res.x, eager(rhs[4]).x) <= 1e-6
    assert s._graph_plans._plan is None


def _card_chunk(elastic, p0=16, B=16):
    """A float32 card solver (3D refine-2, l = 2: the 2187 / 729 blocks of
    the benchmark's configurations, windows clipped by the 4^3 grid), its
    tables and the prep of patches p0 .. p0+B-1."""
    from dealii_slod_tpu_torch.models import basis
    cfg = SLODConfig(dim=3, n_global_refinements=2, n_subdivisions=2,
                     oversampling=2, lod_stabilization=True,
                     constant_coefficients=False, coef_refinement=3,
                     coef_seed=7, dtype="float32", patch_chunk=B,
                     rhs="1; 1; 1" if elastic else "1")
    s = pt.LODSolver(cfg, (pt.ElasticityProblem if elastic
                           else pt.DiffusionProblem)(cfg), device="cuda",
                     verbose=False)
    tab = s._uniform_tables()
    _, nlo, nhi, sides = s._uniform_inputs()
    sel = slice(p0, p0 + B)
    cw = {k: basis.coef_windows(cfg, s.grid, s.coef_q[k])[sel]
          for k in tab.coef_names}
    lo, hi, sd = (torch.as_tensor(a[sel], device="cuda")
                  for a in (nlo, nhi, sides))
    return s, tab, cw, lo, hi, sd


def test_elasticity_chunk_on_the_whole_block(cuda):
    """The card's float32 route for 3D l = 2 elasticity: K1 on the whole
    (2187 -> 2240) block, factored in place on prep's padded operand, one
    launch; X and T against the float64 plain solve within the float32
    gate (4x the float32 plain version's error + 1e-6), and within it of
    the Schur split on K6 leaves."""
    from dealii_slod_tpu_torch.models import basis
    s, tab, cw, lo, hi, _ = _card_chunk(True)
    assert s.solver_mode == "fused" and tab.k1_n == 2240 and tab.nI == 2187
    _, Ap, PT_m, _ = basis.prep(tab, cw, lo, hi)
    assert Ap.shape == (16, 2240, 2240) and Ap.is_contiguous()
    A = Ap[:, :tab.nI, :tab.nI].clone()
    Xr, Tr = patch_solve.fused_spd_multirhs_plain(A.double(), PT_m.double())
    Xp, Tp = patch_solve.fused_spd_multirhs_plain(A, PT_m)
    kernels.reset_launch_counts()
    X, T = basis.patch_solve(tab, Ap, PT_m)
    assert kernels.launches["K1 fused_spd_multirhs"] == 1
    assert kernels.launches["K6 spd_multirhs_solve"] == 0
    Xs, Ts = patch_solve.fused_spd_multirhs_split(A, PT_m)
    for out, plain, ref in ((X, Xp, Xr), (T, Tp, Tr), (Xs, Xp, Xr),
                            (Ts, Tp, Tr)):
        assert rel(out.double(), ref) <= 4 * rel(plain.double(), ref) + 1e-6


def test_diffusion_k1_in_place_is_bitwise_the_copied_route(cuda):
    """Diffusion's K1 on prep's padded operand in place gives X and T
    bit for bit those of K1 on the unpadded block through its padded
    copy: the kernel sees the same values (the operands differ only in
    the sign of some zeros, where masked placements land)."""
    import dataclasses

    from dealii_slod_tpu_torch.models import basis
    s, tab, cw, lo, hi, _ = _card_chunk(False)
    assert s.solver_mode == "fused" and tab.k1_n == 768
    _, Ap, PT_m, _ = basis.prep(tab, cw, lo, hi)
    _, A, _, _ = basis.prep(dataclasses.replace(tab, k1_n=0), cw, lo, hi)
    assert A.shape == (16, 729, 729)
    X0, T0 = patch_solve.fused_spd_multirhs(A, PT_m)
    X1, T1 = patch_solve.fused_spd_multirhs(Ap, PT_m, in_place=True)
    for a, b in ((X1, X0), (T1, T0)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_diffusion_chunk_makes_no_host_sync(cuda):
    """A traced diffusion chunk on the card (K1 on the padded operand,
    T^-1 and (G + delta I)^-1 at 125 <= 128: no pad) counts no host sync
    and no upload; the chunk counts its patches, all on the whole
    block."""
    from torch.profiler import ProfilerActivity, profile

    from dealii_slod_tpu_torch.models import basis
    from dealii_slod_tpu_torch.utils import timers
    s, tab, cw, lo, hi, sd = _card_chunk(False)
    out = tuple(torch.empty((16, tab.n_nodes, 1, 1), device=cuda)
                for _ in range(2))
    basis.uniform_chunk(tab, cw, lo, hi, sd, out)
    torch.cuda.synchronize()
    timers.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        basis.uniform_chunk(tab, cw, lo, hi, sd, out)
        torch.cuda.synchronize()
    c = timers.counters()
    timers.clear()
    assert "host_syncs" not in c and "h2d_bytes" not in c
    assert c["patch_solve.patches"] == c["patch_solve.whole_block"] == {
        "patch_solve": 16}
