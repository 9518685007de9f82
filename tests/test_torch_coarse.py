"""The coarse system's owner (``models/coarse.py: CoarseSystem``) on the
CPU: the load server answers a load as the step does on every coarse
route, and the direct solve and the fine solve's two-level
preconditioner share one dense factor, the preconditioner's arithmetic
unchanged.  Tiny 2D configurations; ~3 s on one worker."""

import dataclasses
import gc
import weakref

import numpy as np
import torch

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu_torch.models import stencil
from dealii_slod_tpu_torch.models.coarse import CoarseSystem
from dealii_slod_tpu_torch.ops.solvers import cholesky_solve

torch.set_num_threads(2)


def solver(**kw):
    """2D refine-2 l=2 SLOD in float64 (16 coarse dofs), its fine rhs
    assembled."""
    cfg = pt.SLODConfig(**{**dict(
        dim=2, n_global_refinements=2, oversampling=2,
        lod_stabilization=True, constant_coefficients=False, coef_seed=3,
        patch_chunk=16, eig_solver="smallk",
        coarse_solver=pt.ReductionControl(500, 1e-10, 1e-10)), **kw})
    s = pt.LODSolver(cfg, pt.DiffusionProblem(cfg), device="cpu",
                     verbose=False)
    s.assemble_fine_rhs()
    return s


def test_load_server_answers_as_the_step():
    """On the direct route, the dense-matrix CG and the stencil-matvec CG
    (``coarse_dense_cap`` below the 16 coarse dofs), ``load_server()``
    answers a load with the coarse solution that ``build_step()``'s step
    gives for it, bit for bit, call after call; ``serve.mode`` names the
    route, and "direct" above the cap runs CG.  No reference cycle: a
    solved coarse system, and the solver with its server, free as soon as
    their last user drops them (a cycle kept each step's operator until a
    full collection)."""
    rng = np.random.default_rng(0)
    gc.disable()
    try:
        for kw, mode in ((dict(coarse_solve="direct"), "direct"),
                         (dict(coarse_solve="cg"), "cg"),
                         (dict(coarse_dense_cap=8), "cg"),
                         (dict(coarse_solve="direct", coarse_dense_cap=8),
                          "cg")):
            s = solver(**kw)
            f = torch.from_numpy(rng.standard_normal((s.grid.n_nodes, s.C)))
            x, _ = s.build_step()(s.coef_q, f)
            assert (s.coarse_cg is None) == (mode == "direct")
            serve = s.load_server()
            assert serve.mode == mode
            for _ in range(2):
                assert torch.equal(serve(f), x)
            system = CoarseSystem(s, s.A_stencil)
            system.solve(s.Phi, f)
            refs = [weakref.ref(o) for o in (system, s, s._coarse_system())]
            del system, s, serve
            assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_direct_solve_and_two_level_precond_share_one_factor(monkeypatch):
    """With ``coarse_solve="direct"`` and the two-level fine
    preconditioner, ``solve_coarse``, a load server and ``solve_fine_fem``
    on one operator factor the coarse matrix once (``torch.linalg.
    cholesky`` counted).  The preconditioner's output is bit for bit
    r / diag + C A_LOD^-1 C^T r with A_LOD^-1 by that factor's two
    triangular solves, and past ``two_level_dense_cap`` by the degree-16
    Chebyshev polynomial of the stencil matvec."""
    s = solver(coarse_solve="direct", fine_preconditioner="two_level")
    s.compute_basis()
    s.assemble_coarse_operator()
    cholesky, calls = torch.linalg.cholesky, []

    def counting(A, *a, **kw):
        calls.append(tuple(A.shape))
        return cholesky(A, *a, **kw)

    with monkeypatch.context() as m:
        m.setattr(torch.linalg, "cholesky", counting)
        x = s.solve_coarse()
        assert torch.equal(s.load_server()(s.fem_rhs), x)
        s.solve_fine_fem()
        assert bool(s.fine_cg.converged)
    assert calls == [(16, 16)]

    P, C, A_st = s.topo.n_patches, s.C, s.A_stencil
    gidx = s.canvas_gidx.reshape(-1)
    rng = np.random.default_rng(1)
    r = torch.from_numpy(rng.standard_normal((s.grid.n_nodes, C)))
    diag = torch.from_numpy(rng.uniform(1.0, 2.0, (s.grid.n_nodes, C)))

    def two_level(coarse_solve):
        rc = torch.einsum("pncd,pnc->pd", s.Phi, r[s.canvas_gidx])
        vals = torch.einsum("pncd,pd->pnc", s.Phi, coarse_solve(rc))
        coarse = torch.zeros_like(r)
        coarse.index_add_(0, gidx, vals.reshape(-1, C))
        return r / diag + torch.where(s.fine_bnd[:, None], 0.0, coarse)

    L = cholesky(s.coarse_dense_matrix(A_st))
    dense = two_level(lambda rc: cholesky_solve(
        L, rc.reshape(-1, 1))[:, 0].reshape(P, C))
    assert torch.equal(s._coarse_system().two_level_precond(diag)(r), dense)

    lmax = float(A_st.abs().sum(dim=(1, 3)).max())
    lmin = lmax / 30.0
    theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
    nbr = torch.from_numpy(s.stencil_nbr_np)
    valid = torch.from_numpy(s.stencil_valid_np)

    def chebyshev(rc):
        y = rc / theta
        d = y
        sigma = theta / delta
        rho = 1.0 / sigma
        for _ in range(15):
            rho_new = 1.0 / (2.0 * sigma - rho)
            res = rc - stencil.coarse_matvec_with(A_st, y, nbr, valid)
            d = rho_new * (2.0 / delta * res + rho * d)
            y = y + d
            rho = rho_new
        return y

    monkeypatch.setattr(s, "cfg",
                        dataclasses.replace(s.cfg, two_level_dense_cap=0))
    precond = CoarseSystem(s, A_st).two_level_precond(diag)
    assert torch.equal(precond(r), two_level(chebyshev))
