"""Each kernel module of the PyTorch port against the JAX function on the
same seeded inputs, in float64 on the CPU: the port's wrappers take their
plain versions for CPU tensors, the JAX side runs its Pallas kernels in
interpret mode (as the JAX package's own tests run them).  JAX's
``mgs_qr_pallas`` runs a Householder QR there, so K4 is held to its
contract (orthonormality, span, Q up to column signs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_slod_tpu.grid import cartesian_coords
from dealii_slod_tpu.ops import assembly as jax_assembly
from dealii_slod_tpu.ops import eig as jax_eig
from dealii_slod_tpu.ops import patch_solve as jax_ps
from dealii_slod_tpu.ops import solvers as jax_solvers
from dealii_slod_tpu.ops.element import ElementTensors as JaxElement
from dealii_slod_tpu_torch.ops import assembly, eig, patch_solve, solvers
from dealii_slod_tpu_torch.ops.element import ElementTensors

torch.set_num_threads(2)


def rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def spd(rng, B, n):
    M = rng.standard_normal((B, n, n))
    return M @ M.transpose(0, 2, 1) / n + np.eye(n)


@pytest.mark.parametrize("n0", [100, 250])
def test_fused_spd_multirhs_matches_jax(n0):
    """K1: X = A^-1 B and T = B^T A^-1 B (n and the batch padded on the
    JAX side: nb=64, bs=4, P=6), to 1e-10."""
    rng = np.random.default_rng(n0)
    A, B = spd(rng, 6, n0), rng.standard_normal((6, n0, 60))
    jX, jT = jax_ps.fused_spd_multirhs(jnp.asarray(A), jnp.asarray(B),
                                       nb=64, bs=4, interpret=True)
    X, T = patch_solve.fused_spd_multirhs(torch.from_numpy(A),
                                          torch.from_numpy(B))
    assert rel(X, jX) <= 1e-10
    assert rel(T, jT) <= 1e-10


@pytest.mark.parametrize("with_T", [True, False])
@pytest.mark.parametrize("n0", [100, 250, 150])
def test_fused_ldl_blocked_plain_matches_jax(n0, with_T):
    """The CUDA kernel's order of summation on tensors (left-looking block
    LDL^T, substitutions by 128-row block rows, T = z^T w as one product):
    against the Cholesky plain version and against JAX's K1 (solve-only:
    JAX's K6 leaf), in float64 to 1e-10.  n0 = 150 is no multiple of the
    panel and spans three panels."""
    rng = np.random.default_rng(n0)
    A, B = spd(rng, 6, n0), rng.standard_normal((6, n0, 60))
    tA, tB = torch.from_numpy(A), torch.from_numpy(B)
    Xp, Tp = patch_solve.fused_spd_multirhs_plain(tA, tB)
    out = patch_solve.fused_ldl_blocked_plain(tA, tB, with_T=with_T)
    if with_T:
        jX, jT = jax_ps.fused_spd_multirhs(jnp.asarray(A), jnp.asarray(B),
                                           nb=64, bs=4, interpret=True)
        X, T = out
        assert T.shape == (6, 60, 60)
        assert rel(T, Tp) <= 1e-10 and rel(T, jT) <= 1e-10
    else:
        jX = jax_ps.spd_multirhs_solve_dma(jnp.asarray(A), jnp.asarray(B),
                                           interpret=True)
        X = out
    assert X.shape == (6, n0, 60)
    assert rel(X, Xp) <= 1e-10 and rel(X, jX) <= 1e-10


def _tf32(x):
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_drop(x):
    """float32 -> TF32 by dropping the low 13 mantissa bits, as the tensor
    core reads an operand that was not rounded first."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """The kernels' float32 product on the tensor cores, emulated: a = a_hi
    + a_lo (a_hi rounded to TF32, the remainder's low bits dropped), b
    likewise, three TF32 products with float32 accumulation, the low-order
    terms first."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32_drop(a - ah), _tf32_drop(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _real_patch_operators():
    """SPD patch blocks A (8, 729, 729) and right-hand sides PT of eight
    patches of the small 3D refine-2 l=2 configuration (coef_refinement 3,
    seed 3), assembled by the port's CPU pipeline, in float64."""
    import dealii_slod_tpu_torch as pt
    from dealii_slod_tpu_torch.models import basis
    cfg = pt.SLODConfig(dim=3, n_global_refinements=2, n_subdivisions=2,
                        oversampling=2, lod_stabilization=True,
                        constant_coefficients=False, coef_seed=3,
                        coef_refinement=3, dtype="float64",
                        eig_solver="smallk", patch_solver="fused")
    s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                     verbose=False)
    tab = s._uniform_tables()
    _, nlo, nhi, _ = s._uniform_inputs_t()
    sel = torch.arange(0, 64, 8) + torch.arange(8) % 4
    cw = basis.coef_windows(cfg, s.grid, s.coef_q["alpha"])[sel]
    _, A, PT_m, _ = basis.prep(tab, {"alpha": cw}, nlo[sel], nhi[sel])
    return A, PT_m


def test_3xtf32_split_keeps_f32_accuracy_single_pass_does_not():
    """Why K1 / K6 split their float32 operands: through the blocked
    version on real patch operators, the 3xTF32 product keeps X within the
    gate the card check applies (error against float64 <= 4x the plain
    float32 version's + 1e-6), and a single TF32 pass does not (the Schur
    updates cancel)."""
    A, B = _real_patch_operators()
    assert A.shape[-1] >= 3 * patch_solve.NB
    Xr, Tr = patch_solve.fused_spd_multirhs_plain(A, B)
    a, b = A.float(), B.float()
    Xp, Tp = patch_solve.fused_spd_multirhs_plain(a, b)
    gate_x = 4 * rel(Xp.double(), Xr) + 1e-6
    gate_t = 4 * rel(Tp.double(), Tr) + 1e-6
    X3, T3 = patch_solve.fused_ldl_blocked_plain(a, b, matmul=_mm_3xtf32)
    assert rel(X3.double(), Xr) <= gate_x
    assert rel(T3.double(), Tr) <= gate_t
    X1, _ = patch_solve.fused_ldl_blocked_plain(a, b, matmul=_mm_1xtf32)
    assert rel(X1.double(), Xr) > gate_x


def test_gj_inverse_matches_jax():
    """K2: the Gauss-Jordan sweep inverse (JAX pads 125 -> 128), 1e-10."""
    rng = np.random.default_rng(1)
    A = spd(rng, 5, 125)
    jinv = jax_ps.gj_inverse_pallas(jnp.asarray(A), interpret=True)
    inv = patch_solve.spd_inverse_schur(torch.from_numpy(A))
    assert rel(inv, jinv) <= 1e-10
    assert rel(inv, np.linalg.inv(A)) <= 1e-10


def test_stencil_trace_matches_jax():
    """K3 on a 3D canvas (7^3 nodes, 27 offsets), to 1e-12."""
    rng = np.random.default_rng(2)
    dims = np.array([7, 7, 7])
    strides = np.concatenate([[1], np.cumprod(dims[:-1])])
    offs = tuple(int(o) for o in
                 (cartesian_coords(np.full(3, 3)) - 1) @ strides)
    shiftN = int(strides.sum())
    nN, B, k = int(dims.prod()), 3, 20
    band = rng.standard_normal((B, nN, 27))
    X = rng.standard_normal((B, 1, nN, k))
    Xp = np.pad(X, ((0, 0), (0, 0), (shiftN, shiftN), (0, 0)))
    jS = jax_assembly.stencil_trace_pallas(jnp.asarray(band), jnp.asarray(Xp),
                                           shiftN, offs, interpret=True,
                                           impl="c1")
    S = assembly.stencil_trace(torch.from_numpy(band), torch.from_numpy(Xp),
                               shiftN, offs)
    assert S.shape == jS.shape
    assert rel(S, jS) <= 1e-12


def _trace_inputs(rng, dim, C, B=2, k=20):
    """band (B, nN, 3^dim C^2) flat and Xp (B, C, nNp, k) on a 7^dim
    canvas, the shift and the flat offsets."""
    dims = np.full(dim, 7)
    strides = np.concatenate([[1], np.cumprod(dims[:-1])])
    offs = tuple(int(o) for o in
                 (cartesian_coords(np.full(dim, 3)) - 1) @ strides)
    shiftN, nN = int(strides.sum()), int(dims.prod())
    band = rng.standard_normal((B, nN, 3 ** dim * C * C))
    X = rng.standard_normal((B, C, nN, k))
    Xp = np.pad(X, ((0, 0), (0, 0), (shiftN, shiftN), (0, 0)))
    return band, Xp, shiftN, offs


@pytest.mark.parametrize("impl", ["unrollslice", "slice"])
@pytest.mark.parametrize("dim", [2, 3])
def test_stencil_trace_c_generic_matches_jax(dim, impl):
    """K7's contract at C = dim (2D: 9 offsets, 3D: 27), S (B, C, nN, k),
    against JAX's unrolled kernel and its offset-grid kernel in interpret
    mode, to 1e-12."""
    band, Xp, shiftN, offs = _trace_inputs(np.random.default_rng(dim), dim,
                                           dim)
    jS = jax_assembly.stencil_trace_pallas(jnp.asarray(band),
                                           jnp.asarray(Xp), shiftN, offs,
                                           interpret=True, impl=impl)
    S = assembly.stencil_trace(torch.from_numpy(band), torch.from_numpy(Xp),
                               shiftN, offs)
    assert S.shape == jS.shape == (2, dim, 7 ** dim, 20)
    assert rel(S, jS) <= 1e-12


def test_spd_multirhs_solve_matches_jax():
    """K6's contract X = A^-1 B (JAX's interpret mode solves with LAPACK),
    at (3, 300, 17), to 1e-10."""
    rng = np.random.default_rng(12)
    A, B = spd(rng, 3, 300), rng.standard_normal((3, 300, 17))
    jX = jax_ps.spd_multirhs_solve_dma(jnp.asarray(A), jnp.asarray(B),
                                       interpret=True)
    X = patch_solve.spd_multirhs_solve(torch.from_numpy(A),
                                       torch.from_numpy(B))
    assert rel(X, jX) <= 1e-10


def _record_leaves(monkeypatch) -> list:
    """Wrap the port's leaf solve to record each leaf's (n, k)."""
    leaves, leaf = [], patch_solve.spd_multirhs_solve

    def record(A, B):
        leaves.append((A.shape[-1], B.shape[-1]))
        return leaf(A, B)

    monkeypatch.setattr(patch_solve, "spd_multirhs_solve", record)
    return leaves


def test_fused_spd_multirhs_split_matches_jax(monkeypatch):
    """The recursive 2x2 Schur split at P = 2, n = 1500, k = 40, where the
    reference's leaf budget recurses: X and T to 1e-10, and the same
    leaves as JAX's (its leaf kernel wrapped to record the shapes)."""
    rng = np.random.default_rng(13)
    A, B = spd(rng, 2, 1500), rng.standard_normal((2, 1500, 40))
    jX, jT = jax_ps.fused_spd_multirhs_split(jnp.asarray(A), jnp.asarray(B),
                                             nb=128)
    jleaves = []
    leaf = jax_ps.spd_multirhs_solve_dma

    def record(A, B, **kw):
        jleaves.append((A.shape[-1], B.shape[-1]))
        return leaf(A, B, **kw)

    monkeypatch.setattr(jax_ps, "spd_multirhs_solve_dma", record)
    jax_ps._solve_rec(jnp.asarray(A), jnp.asarray(B), 128)
    leaves = _record_leaves(monkeypatch)
    X, T = patch_solve.fused_spd_multirhs_split(
        torch.from_numpy(A), torch.from_numpy(B), nb=128)
    assert rel(X, jX) <= 1e-10
    assert rel(T, jT) <= 1e-10
    assert leaves == jleaves == [(1408, 132), (92, 40)]
    assert patch_solve.split_leaves(1500, 40, 128) == leaves


@pytest.mark.parametrize("n, k, expect", [
    (2187, 375, [(768, 1794), (1152, 642), (267, 375)]),   # 3D elasticity
    (100, 20000, [(100, 10112), (100, 9888)]),             # RHS halved
])
def test_split_leaves_rule_matches_jax(monkeypatch, n, k, expect):
    """``split_leaves`` (the rule alone) gives the leaves that JAX's
    recursion and the port's run, in order (identity A, one patch; JAX's
    leaf replaced by a recorder)."""
    jleaves = []

    def record(A, B, **kw):
        jleaves.append((A.shape[-1], B.shape[-1]))
        return jnp.zeros(B.shape, B.dtype)

    monkeypatch.setattr(jax_ps, "spd_multirhs_solve_dma", record)
    jax_ps._solve_rec(jnp.eye(n)[None], jnp.zeros((1, n, k)), 128)
    leaves = _record_leaves(monkeypatch)
    patch_solve._solve_rec(torch.eye(n, dtype=torch.float64)[None],
                           torch.zeros((1, n, k), dtype=torch.float64), 128)
    assert patch_solve.split_leaves(n, k, 128) == leaves == jleaves == expect


@pytest.mark.parametrize("n", [375, 200])
def test_blocked_spd_inverse_schur_matches_jax(n):
    """The blocked Gauss-Jordan sweep for n > 128 (K2 on each 128-pivot,
    rank-128 updates), at (4, n), to 1e-10 relative."""
    A = spd(np.random.default_rng(n), 4, n)
    jinv = jax_ps.spd_inverse_schur(jnp.asarray(A))
    inv = patch_solve.spd_inverse_schur(torch.from_numpy(A))
    assert rel(inv, jinv) <= 1e-10
    assert rel(inv, np.linalg.inv(A)) <= 1e-10


def _psd(rng, B, n):
    Q, _ = np.linalg.qr(rng.standard_normal((B, n, n)))
    lam = np.logspace(-3, 0, n)
    return (Q * lam[None, None, :]) @ Q.transpose(0, 2, 1), lam


def _check_eig(lam, V, jlam, jV):
    jlam, jV = np.asarray(jlam), np.asarray(jV)
    assert float(np.abs(lam.numpy() - jlam).max()
                 / np.abs(jlam).max()) <= 1e-10
    sgn = np.sign((V.numpy() * jV).sum(-2, keepdims=True))
    assert float(np.abs(V.numpy() * sgn - jV).max()) <= 1e-8


@pytest.mark.parametrize("tol, sweeps", [(0.0, 20), (3e-6, 30)])
def test_jacobi_eigh_matches_jax(tol, sweeps):
    """K5 at n=125 (odd: one zero pad row, sorted last and dropped), 20
    matrices in blocks of 16 sharing the adaptive stop, fixed and adaptive
    sweep counts: eigenvalues to 1e-10 of lambda_max, vectors up to
    sign.  (12 fixed sweeps leave these spectra unconverged; 20 do not.)"""
    rng = np.random.default_rng(3)
    G, _ = _psd(rng, 20, 125)
    jlam, jV = jax_eig.jacobi_eigh_pallas(jnp.asarray(G), sweeps=sweeps,
                                          block=16, tol=tol)
    lam, V = eig.jacobi_eigh(torch.from_numpy(G), sweeps=sweeps, block=16,
                             tol=tol)
    _check_eig(lam, V, jlam, jV)


def test_jacobi_eigh_factor_matches_jax():
    """The factor form (K5 on the jittered Cholesky factor's transpose)."""
    rng = np.random.default_rng(4)
    G, lam_true = _psd(rng, 17, 125)
    jlam, jV = jax_eig.jacobi_eigh_factor(jnp.asarray(G), sweeps=30,
                                          tol=3e-6)
    lam, V = eig.jacobi_eigh_factor(torch.from_numpy(G), sweeps=30,
                                    tol=3e-6)
    _check_eig(lam, V, jlam, jV)
    assert np.abs(lam.numpy() - lam_true[::-1]).max() <= 1e-9


@pytest.mark.parametrize("n, r", [(n, r) for n in (2, 4, 32, 126)
                                  for r in range(n - 1)]
                         + [(374, r) for r in (0, 1, 186, 372)])
def test_caterpillar_slots_match_plain_advance(n, r):
    """K5's CTA routine never moves a row: it computes the row that each
    caterpillar slot holds at round r in closed form (``caterpillar_slots``,
    the twin of ``csrc/jacobi_eigh.cu: slot_top, slot_bot``).  The plain
    version moves the rows: r of its rounds on the rows of the identity
    (pairwise orthogonal, so no rotation changes them) give its slot
    tables, which the closed form must equal."""
    eye = torch.eye(n, dtype=torch.float64)
    XT, XB = eye[None, 0::2].clone(), eye[None, 1::2].clone()
    a = torch.ones((1, n // 2, 1), dtype=torch.float64)
    b = a.clone()
    for _ in range(r):
        XT, XB, a, b, _ = eig._caterpillar_round_nj(
            XT, XB, a, b, eig._eps(torch.float64))
    top, bot = eig.caterpillar_slots(n, r)
    assert torch.equal(XT[0], eye[top]) and torch.equal(XB[0], eye[bot])
    assert eig.caterpillar_slots(n, r + n - 1) == (top, bot)   # period n-1


def _k5_cluster_cases():
    """(n, itemsize, S): every cluster size K5's cluster route can lay out
    at n in {126, 374, 376} in float32 and float64."""
    return [(n, size, S) for n in (126, 374, 376) for size in (4, 8)
            for S in sorted(eig.K5_CLUSTER_SIZES)
            if eig.k5_cluster_layout(n, size, S) is not None]


@pytest.mark.parametrize("n, itemsize, S", _k5_cluster_cases())
def test_k5_cluster_maps_cover_every_round(n, itemsize, S):
    """K5's cluster route (``k5_cluster_layout`` / ``k5_cluster_maps``, the
    twins of ``csrc/jacobi_eigh.cu: cluster_plan`` and the kernel's index
    arithmetic; ``k5_cluster_plan`` takes the largest size that fits), in
    every round: every row in exactly one pair, every pair
    on exactly one warp of one CTA (one of the warp's two pairs, within the
    CTA's threads), no CTA holding more rows than its slice of 2 P, no CTA
    empty, and between two rounds only the two rows at each CTA edge
    changing CTA (what the kernel sends through distributed shared
    memory).  The plan's inboxes fit the card's shared memory."""
    plan = eig.k5_cluster_layout(n, itemsize, S)
    assert plan["S"] == S and plan["P"] % 2 == 0
    assert eig.k5_cluster_plan(n, itemsize)["S"] >= S
    P, m = plan["P"], n // 2
    assert plan["smem"] <= eig.H100_SMEM_OPTIN - 1024
    assert plan["threads"] == P // 2 * 32 <= 1024
    assert 32 * plan["J"] >= n
    prev = None
    for r in range(n):
        pair_warp, row_cta = eig.k5_cluster_maps(n, plan, r)
        top, bot = eig.caterpillar_slots(n, r)
        assert sorted(top + bot) == list(range(n))
        assert len(set(pair_warp)) == m
        assert all(w < P // 2 and h in (0, 1) for _, w, h in pair_warp)
        assert sorted({k for k, _, _ in pair_warp}) == list(range(S))
        assert max(row_cta.count(k) for k in range(S)) <= 2 * P
        if prev is not None:
            moved = sum(a != b for a, b in zip(prev, row_cta))
            assert moved == 2 * (S - 1)
        prev = row_cta


def test_jacobi_eigh_matches_jax_at_path_shape():
    """K5 at the float64 elasticity W shape (374 x 374) with the smallk W's
    settings (8 sweeps at most, tol 3e-6, each matrix stopping on its own):
    two W built as the smallk stage builds them (a PSD G of 375 x 375 with
    eigenvalues logspace(-13, 0), three inverse subspace steps on 374
    directions, W = Z^T G Z); eigenvalues to 1e-10 of lambda_max, vectors
    up to sign."""
    rng = np.random.default_rng(374)
    n, k = 375, 374
    Q, _ = np.linalg.qr(rng.standard_normal((2, n, n)))
    G = (Q * np.logspace(-13, 0, n)) @ Q.transpose(0, 2, 1)
    Gi = np.linalg.inv(G)
    Z = np.broadcast_to(np.linalg.qr(rng.standard_normal((n, k)))[0],
                        (2, n, k))
    for _ in range(3):
        Z = np.linalg.qr(Gi @ Z)[0]
    W = Z.transpose(0, 2, 1) @ G @ Z
    W = 0.5 * (W + W.transpose(0, 2, 1))
    jlam, jV = jax_eig.jacobi_eigh_pallas(jnp.asarray(W), sweeps=8, block=1,
                                          tol=3e-6)
    lam, V = eig.jacobi_eigh(torch.from_numpy(W), sweeps=8, block=1,
                             tol=3e-6)
    _check_eig(lam, V, jlam, jV)


def test_band_assembly_matches_jax():
    """ops/assembly: node windows, bands and the banded-stride dense
    embedding against the JAX functions (the embedding moves values:
    exact up to the band's own rounding)."""
    rng = np.random.default_rng(5)
    sub_dims = np.array([4, 3, 5])
    coef = rng.uniform(1, 10, (int(sub_dims.prod()), 8))
    tens = assembly.make_band_tensors(ElementTensors(3, 0.125, 1))
    jtens = jax_assembly.make_band_tensors(JaxElement(3, 0.125, 1))
    for k in tens:
        np.testing.assert_array_equal(tens[k], jtens[k])
    band = assembly.assemble_bands({"alpha": torch.from_numpy(coef)[None]},
                                   tens, sub_dims)[0]
    jband = jax_assembly.assemble_bands({"alpha": jnp.asarray(coef)}, jtens,
                                        sub_dims)
    assert rel(band, np.asarray(jband)[..., 0, 0]) <= 1e-14
    node_dims = sub_dims + 1
    place = assembly.band_placement_matrix(node_dims)
    dense = assembly.bands_to_dense_mm(band[None], *place)[0]
    jdense = jax_assembly.bands_to_dense_mm(jband, *place)
    assert rel(dense, jdense) <= 1e-14
    np.testing.assert_allclose(dense.numpy(), dense.numpy().T, atol=1e-12)


def test_cg_matches_jax():
    """ops/solvers: preconditioned CG with ReductionControl stopping gives
    JAX's iterate and exact iteration count (chunks of 8)."""
    rng = np.random.default_rng(6)
    A = spd(rng, 1, 80)[0] + np.diag(np.linspace(0, 50, 80))
    b = rng.standard_normal((80, 1))
    d = np.diag(A)[:, None]
    jr = jax_solvers.cg(lambda u: jnp.asarray(A) @ u, jnp.asarray(b),
                        max_steps=200, tolerance=1e-30, reduce=1e-9,
                        precond=lambda r: r / jnp.asarray(d))
    At, dt = torch.from_numpy(A), torch.from_numpy(d.copy())
    r = solvers.cg(lambda u: At @ u, torch.from_numpy(b), max_steps=200,
                   tolerance=1e-30, reduce=1e-9, precond=lambda r: r / dt)
    assert int(r.n_iter) == int(jr.n_iter) and bool(r.converged)
    assert rel(r.x, jr.x) <= 1e-10


# ---------------------------------------------------------------------------
# K4, K8 and the smallk spectral stage
# ---------------------------------------------------------------------------

def _log_scaled(rng, B, n, k):
    """Columns scaled by logspace(0, -5): the subspace-iteration regime."""
    return rng.standard_normal((B, n, k)) * np.logspace(0, -5, k)


def test_mgs_qr_matches_jax():
    """K4 at (7, 125, 32), f64: orthonormal to 1e-12, spanning X to 1e-10,
    and JAX's Householder Q up to column signs to 1e-10."""
    X = _log_scaled(np.random.default_rng(7), 7, 125, 32)
    Q = eig.mgs_qr(torch.from_numpy(X)).numpy()
    jQ = np.asarray(jax_eig.mgs_qr_pallas(jnp.asarray(X), interpret=True))
    QtQ = np.einsum("bni,bnj->bij", Q, Q)
    assert np.abs(QtQ - np.eye(32)).max() <= 1e-12
    X2 = np.einsum("bni,bmi,bmk->bnk", Q, Q, X)
    assert np.abs(X2 - X).max() / np.abs(X).max() <= 1e-10
    sgn = np.sign((Q * jQ).sum(1, keepdims=True))
    assert np.abs(Q * sgn - jQ).max() <= 1e-10


def test_mgs_qr_null_column_stays_zero():
    """A zero column gives an exactly zero column (Householder would
    complete the basis); the others stay orthonormal."""
    X = _log_scaled(np.random.default_rng(8), 3, 40, 8)
    X[:, :, 3] = 0.0
    Q = eig.mgs_qr(torch.from_numpy(X)).numpy()
    assert np.all(Q[:, :, 3] == 0.0)
    live = [0, 1, 2, 4, 5, 6, 7]
    QtQ = np.einsum("bni,bnj->bij", Q[:, :, live], Q[:, :, live])
    assert np.abs(QtQ - np.eye(7)).max() <= 1e-12


def _check_eig_sep(lam, V, jlam, jV, sep_rel=1e-6):
    """Eigenvalues to 1e-10 of lambda_max; eigenvectors up to sign where
    the pair is separated from its neighbours by more than sep_rel of
    lambda_max (clustered vectors are fixed only up to a rotation)."""
    lam, V = lam.numpy(), V.numpy()
    jlam, jV = np.asarray(jlam), np.asarray(jV)
    lmax = jlam[:, :1]
    assert np.abs(lam - jlam).max() / lmax.max() <= 1e-10
    gaps = np.abs(jlam[:, :, None] - jlam[:, None, :]) / lmax[:, :, None]
    gaps += np.eye(gaps.shape[-1]) * 1e300
    sep = gaps.min(-1) > sep_rel
    cos = np.abs((V * jV).sum(1))
    assert ((1.0 - cos) * sep).max() <= 1e-10


def _weig_inputs(rng, B, n, k):
    A = rng.standard_normal((B, n, n))
    G = A @ A.transpose(0, 2, 1)
    Z = np.linalg.qr(rng.standard_normal((B, n, k)))[0]
    ZT = Z.transpose(0, 2, 1).copy()
    return ZT, ZT @ G


@pytest.mark.parametrize("B, n, k, tol", [(6, 40, 8, 0.0), (6, 40, 8, 3e-6),
                                          (5, 125, 32, 3e-6),
                                          (2, 125, 124, 3e-6),
                                          (2, 375, 32, 3e-6),
                                          (1, 375, 374, 3e-6)])
def test_weig_matches_jax(B, n, k, tol):
    """K8: W = Z^T (G Z) built from the transposed factors, then the sweeps
    with the stop shared over the batch (the inputs of
    tests/test_smallk_path.py, in f64, the main-path k = 32, n = 125, and
    the shapes of the other weig paths: the float64 main step's k = 124,
    the elasticity Grams' n = 375 at k = 32 and, in float64, k = 374).
    At most 12 sweeps; at k = 374 these W need 18 (12 leave them
    unconverged, where two orders of summation part by ~6e-5 of lambda_max),
    so there at most 30."""
    ZT, YT = _weig_inputs(np.random.default_rng(11), B, n, k)
    sweeps = 30 if k > 128 else 12
    jlam, jU = jax_eig.weig_pallas(jnp.asarray(ZT), jnp.asarray(YT),
                                   sweeps=sweeps, tol=tol)
    lam, U = eig.weig(torch.from_numpy(ZT), torch.from_numpy(YT),
                      sweeps=sweeps, tol=tol)
    _check_eig_sep(lam, U, jlam, jU)


# K5's route at row length n (csrc/jacobi_eigh.cu: jacobi_route) on an
# H100's 227 KB of shared memory: n = 32 a warp, n <= 128 RegRows,
# LoopRows while the rows fit one CTA (float32 n <= 238, float64 n <= 168),
# a thread-block cluster up to n = 384, global rows beyond
_ROUTES = {2: "rows", 8: "rows", 32: "warp", 124: "rows", 126: "rows",
           128: "rows", 130: "loop rows", 374: "cluster", 384: "cluster",
           386: "global rows"}


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("k", sorted(_ROUTES))
def test_k8_route_is_k5_rule(k, itemsize):
    """K8 takes K5's route at row length k, picked by k alone (K8 sweeps in
    float64 at either input type, so its rule is K5's float64 one, which
    at these k names the same route as K5's float32 one): the twin
    ``eig.k8_route`` equals ``eig.k5_route`` (the twin of the launchers'
    ``jacobi_route``) at both item sizes, and both give the route the rule
    names; the cluster route has a plan (``k5_cluster_plan``)."""
    route = eig.k8_route(k)
    assert route == eig.k5_route(k, itemsize) == _ROUTES[k]
    assert route in eig.K5_ROUTES
    if route == "cluster":
        assert eig.k5_cluster_plan(k, itemsize) is not None


def _real_grams():
    """SLOD Grams G (6, 125, 125) and projections g0 of six 3D l=2 patches
    (corner, edges, interior; coef_refinement 3, seed 3), built by the
    port's own CPU pipeline: inputs for both stages."""
    import dealii_slod_tpu_torch as pt
    from dealii_slod_tpu_torch.models import basis
    cfg = pt.SLODConfig(dim=3, n_global_refinements=3, n_subdivisions=2,
                        oversampling=2, lod_stabilization=True,
                        constant_coefficients=False, coef_seed=3,
                        coef_refinement=3, dtype="float64",
                        eig_solver="smallk", patch_solver="fused")
    s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                     verbose=False)
    tab = s._uniform_tables()
    _, nlo, nhi, sides = s._uniform_inputs_t()
    sel = torch.tensor([0, 9, 73, 146, 219, 292])
    cw = basis.coef_windows(cfg, s.grid, s.coef_q["alpha"])[sel]
    nlo, nhi, sides = nlo[sel], nhi[sel], sides[sel]
    band, A, PT_m, cvd = basis.prep(tab, {"alpha": cw}, nlo, nhi)
    X, T_raw = patch_solve.fused_spd_multirhs(A, PT_m)
    Tinv = patch_solve.spd_inverse_schur(T_raw / tab.Hdim
                                         + torch.diag_embed(1.0 - cvd))
    S99, is99d = basis.trace_S_chunk(tab, band, X, nlo, nhi, sides)
    G, g0 = basis.finish_pre_from_S(tab, S99, Tinv, cvd, is99d)
    return G[:, 0].numpy(), g0[:, 0].numpy()


@pytest.fixture(scope="module")
def real_grams():
    return _real_grams()


def _jax_dvec(G, g0, **kw):
    return np.asarray(jax_eig.smallk_truncated_dvec(jnp.asarray(G),
                                                    jnp.asarray(g0), **kw))


@pytest.mark.parametrize("k", [32, 124])
@pytest.mark.parametrize("tol", [0.0, 3e-6])
@pytest.mark.parametrize("weig", [False, True])
def test_smallk_truncated_dvec_matches_jax(real_grams, k, tol, weig):
    """The whole stage on real 125x125 Grams.  The stage is as rounding-
    sensitive as its Grams are ill-conditioned (zero eigenvalues at the
    jitter floor, unconverged directions where k = 32 runs out): JAX's own
    dvec moves by ~5e-8 to 1e-7 when G moves by 1e-15 relative, and the
    port differs from it by 5e-9 to 9e-8.  The bound is 10x that
    sensitivity, measured here, and never below 1e-10; the test below
    holds dvec to 1e-10 where the Grams are well-conditioned."""
    G, g0 = real_grams
    kw = dict(k=k, small_tol=tol)
    jd = _jax_dvec(G, g0, weig=weig, **kw)
    pert = G * (1 + 1e-15 * np.random.default_rng(1).standard_normal(G.shape))
    pert = 0.5 * (pert + pert.transpose(0, 2, 1))
    sens = rel(_jax_dvec(pert, g0, weig=weig, **kw), jd)
    d = eig.smallk_truncated_dvec(torch.from_numpy(G), torch.from_numpy(g0),
                                  weig_fused=weig, **kw)
    assert rel(d, jd) <= max(1e-10, 10 * sens)


def _separated_grams(B=6, n=125):
    """SPD Grams with eigenvalues logspace(-4, 0) (condition 1e4, so the
    Tikhonov solve moves by only ~1e-11 under a 1e-15 input change) and
    projections g0 whose d0 has large components on the 4b smallest
    eigenvectors of matrix b: the scan removes up to 20 directions."""
    rng = np.random.default_rng(21)
    Q = np.linalg.qr(rng.standard_normal((B, n, n)))[0]
    G = (Q * np.logspace(-4, 0, n)) @ Q.transpose(0, 2, 1)
    G = 0.5 * (G + G.transpose(0, 2, 1))
    d = 0.3 * rng.uniform(-1, 1, (B, n))
    for b in range(B):
        d[b] += 20 * Q[b, :, :4 * b] @ rng.uniform(0.5, 1.0, 4 * b)
    return G, -np.einsum("bij,bj->bi", G, d)


@pytest.mark.parametrize("k", [32, 124])
@pytest.mark.parametrize("weig", [False, True])
def test_smallk_truncated_dvec_separated_spectrum(k, weig):
    """The whole stage on well-conditioned (B, 125, 125) Grams: dvec equal
    to JAX's to 1e-10."""
    G, g0 = _separated_grams()
    kw = dict(k=k, small_tol=3e-6)
    d = eig.smallk_truncated_dvec(torch.from_numpy(G), torch.from_numpy(g0),
                                  weig_fused=weig, **kw)
    assert rel(d, _jax_dvec(G, g0, weig=weig, **kw)) <= 1e-10


def test_smallk_zero_gram_gives_zero_dvec():
    """A zero Gram (a patch covering the domain) in a batch of regular
    ones (the batch of tests/test_eig.py): dvec = 0 there, finite, and the
    regular rows equal JAX's to 1e-10."""
    rng = np.random.default_rng(0)
    n = 24
    M = rng.standard_normal((n, n))
    G_ok = M @ M.T + n * np.eye(n)
    G = np.stack([G_ok, np.zeros((n, n)), G_ok])
    g0 = np.stack([G_ok @ rng.standard_normal(n) * 1e-3, np.zeros(n),
                   G_ok @ rng.standard_normal(n) * 1e-3])
    d = eig.smallk_truncated_dvec(torch.from_numpy(G), torch.from_numpy(g0),
                                  k=8).numpy()
    assert np.isfinite(d).all()
    assert np.all(d[1] == 0.0)
    assert rel(d, _jax_dvec(G, g0, k=8)) <= 1e-10
