"""The port's CUDA kernels against their plain versions, and a small f64
step on the card against the same step on the CPU.  These need an NVIDIA
GPU with nvcc (the kernels build at first use) and skip elsewhere:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu.config import ReductionControl, SLODConfig
from dealii_slod_tpu.grid import cartesian_coords
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


def test_k2_matches_plain(cuda):
    A = spd(np.random.default_rng(1), 7, 125).to(cuda)
    assert rel(patch_solve.gj_inverse(A),
               patch_solve.gj_inverse_plain(A)) <= 1e-10


def test_k3_matches_plain(cuda):
    rng = np.random.default_rng(2)
    dims = np.array([7, 7, 7])
    strides = np.concatenate([[1], np.cumprod(dims[:-1])])
    offs = tuple(int(o) for o in
                 (cartesian_coords(np.full(3, 3)) - 1) @ strides)
    shiftN, nN = int(strides.sum()), int(dims.prod())
    band = torch.from_numpy(rng.standard_normal((3, nN, 27))).to(cuda)
    Xp = torch.nn.functional.pad(
        torch.from_numpy(rng.standard_normal((3, 1, nN, 20))),
        (0, 0, shiftN, shiftN)).to(cuda)
    S = assembly.stencil_trace(band, Xp, shiftN, offs)
    assert rel(S, assembly.stencil_trace_plain(band, Xp, shiftN,
                                               offs)) <= 1e-12


def test_k5_matches_plain_block1(cuda):
    """30 fixed sweeps (converged): with the adaptive stop at 3e-6 this
    random spectrum's early-stopped vectors move ~4e-7 under a 1e-15 input
    perturbation, so only a converged run compares at 1e-8."""
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.standard_normal((9, 125, 125)))
    G = torch.from_numpy((Q * np.logspace(-3, 0, 125)) @ Q.transpose(0, 2, 1))
    lam, V = eig.jacobi_eigh(G.to(cuda), sweeps=30)
    lam_r, V_r = eig.jacobi_eigh(G, sweeps=30, block=1)
    assert rel(lam.cpu(), lam_r) <= 1e-10
    sgn = torch.sign((V.cpu() * V_r).sum(-2, keepdim=True))
    assert float((V.cpu() * sgn - V_r).abs().max()) <= 1e-8


def test_small_step_gpu_matches_cpu(cuda):
    """2D refine-2 l=1 in f64: CPU (plain versions, per-matrix Jacobi
    stop) and GPU (kernels) agree; every kernel was launched."""
    cfg = SLODConfig(dim=2, n_global_refinements=2, n_subdivisions=2,
                     oversampling=1, lod_stabilization=True,
                     constant_coefficients=False, coef_refinement=2,
                     dtype="float64", patch_chunk=8, eig_solver="jacobi",
                     patch_solver="fused", eig_tol=3e-6,
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
    assert all(kernels.launches[k] > 0 for k in (
        "K1 fused_spd_multirhs", "K2 gj_inverse", "K3 stencil_trace",
        "K5 jacobi_eigh"))
