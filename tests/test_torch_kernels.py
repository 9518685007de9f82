"""Each kernel module of the PyTorch port against the JAX function on the
same seeded inputs, in float64 on the CPU: the port's wrappers take their
plain versions for CPU tensors, the JAX side runs its Pallas kernels in
interpret mode (as the JAX package's own tests run them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_slod_tpu.grid import cartesian_coords
from dealii_slod_tpu.ops import assembly as jax_assembly
from dealii_slod_tpu.ops import eig as jax_eig
from dealii_slod_tpu.ops import patch_solve as jax_ps
from dealii_slod_tpu.ops import solvers as jax_solvers
from dealii_slod_tpu.ops.element import ElementTensors
from dealii_slod_tpu_torch.ops import assembly, eig, patch_solve, solvers

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


def test_band_assembly_matches_jax():
    """ops/assembly: node windows, bands and the banded-stride dense
    embedding against the JAX functions (the embedding moves values:
    exact up to the band's own rounding)."""
    rng = np.random.default_rng(5)
    et = ElementTensors(3, 0.125, 1)
    sub_dims = np.array([4, 3, 5])
    coef = rng.uniform(1, 10, (int(sub_dims.prod()), 8))
    tens = assembly.make_band_tensors(et)
    jtens = jax_assembly.make_band_tensors(et)
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
