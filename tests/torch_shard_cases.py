"""What the spawned gloo ranks of ``tests/test_torch_sharding.py`` run (the
ranks import this module by name; it imports no jax, so a rank starts
quickly).  ``run_group`` runs every case of one rank count and rank 0
writes the results to one file, which the tests read."""

from __future__ import annotations

import contextlib
import io
import os

import numpy as np
import torch
import torch.distributed as dist

import dealii_slod_tpu_torch as pt
from dealii_slod_tpu_torch.ops.solvers import cg
from dealii_slod_tpu_torch.parallel import (make_mesh, shard_patches,
                                            stack_fields, sweep_step)
from dealii_slod_tpu_torch.parallel.mesh import all_gather_rows, spawn

# the CG run to a tolerance at which the sum order is the limit
TIGHT = (800, 1e-13, 1e-13)
# both packages' SLODConfig keyword arguments (the JAX side forced onto the
# port's routes); the dry run's solver (__graft_entry__.py:35-46) in
# float64, with the coarse CG to TIGHT
BASE = dict(n_subdivisions=2, lod_stabilization=True, rhs="1", bc="0",
            constant_coefficients=False, coef_seed=0, dtype="float64",
            solve_fine_problem=False, eig_solver="smallk",
            patch_solver="fused", trace_kernel="on", coarse_solver=TIGHT)
ELASTIC = dict(dim=2, n_global_refinements=2, oversampling=1, patch_chunk=8,
               rhs="1; 1", patch_solver="fused_split")
# case -> (SLODConfig keyword arguments beyond BASE, elasticity)
STEPS = {
    # the dry run's configurations (__graft_entry__.py:112-128; the 3D
    # one in one chunk, which JAX compiles faster, not four)
    "3d-r2-l1": (dict(dim=3, n_global_refinements=2, oversampling=1,
                      patch_chunk=64), False),
    "2d-r4-l2": (dict(dim=2, n_global_refinements=4, oversampling=2,
                      patch_chunk=32), False),
    # tests/test_sharding_elasticity.py's configuration
    "2d-elasticity": (ELASTIC, True),
    "direct": (dict(ELASTIC, coarse_solve="direct"), True),
    "classes": (dict(dim=2, n_global_refinements=3, oversampling=1,
                     patch_chunk=16, kernel_mode="classes",
                     eig_solver="lapack"), False),
}
# the same configurations on other coarse routes, held to the JAX step of
# the case named (the builds and the matvecs agree to rounding): the
# plane-chunked stencil build on a slab, and the stencil matvec (more
# coarse dofs than coarse_dense_cap) with u gathered a matvec
ROUTES = {
    "planes": ("3d-r2-l1", dict(stencil_side_budget_mb=0)),
    "stencil-matvec": ("2d-elasticity", dict(coarse_dense_cap=16)),
}
SWEEP_SAMPLES = 4
# MC_SHARD=2 against the JAX script at this size, float64 on the CPU
MC_ENV = dict(MC_DIM="2", MC_REFINE="2", MC_SAMPLES="4", MC_DTYPE="float64",
              MC_FIELD="random")


def port_solver(name, verbose=False):
    """The port's solver of a case on the CPU, its fine rhs assembled."""
    base, extra = ROUTES.get(name, (name, {}))
    kw, elastic = STEPS[base]
    kw = dict(BASE, **kw, **extra)
    cfg = pt.SLODConfig(**dict(kw, coarse_solver=pt.ReductionControl(
        *kw["coarse_solver"])))
    problem = (pt.ElasticityProblem if elastic else pt.DiffusionProblem)(cfg)
    s = pt.LODSolver(cfg, problem, device="cpu", verbose=verbose,
                     eig_block=1)
    s.assemble_fine_rhs()
    return s


def sweep_fields(s):
    """SWEEP_SAMPLES fields: the solver's coefficients, each scaled by a
    seeded lognormal factor per quadrature point (numpy)."""
    rng = np.random.default_rng(5)
    return [{k: v.numpy() * np.exp(0.3 * rng.standard_normal(v.shape))
             for k, v in s.coef_q.items()} for _ in range(SWEEP_SAMPLES)]


def gathered(obj):
    """Every rank's ``obj``, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def step_case(name):
    """The sharded step of a case."""
    s = port_solver(name)
    u, A_st = s.build_step(make_mesh(device="cpu"))(s.coef_q, s.fem_rhs)
    out = dict(u=u.full_tensor(), A_st=A_st.full_tensor(),
               placements=[type(u.placements[0]).__name__,
                           type(A_st.placements[0]).__name__],
               local_rows=gathered(u.to_local().shape[0]),
               halo_bytes=gathered(s.halo_bytes),
               canvas_bytes=(s.Phi.element_size() * s.canvas_n * s.C * s.C
                             * 2),
               iters=gathered(None if s.coarse_cg is None
                              else int(s.coarse_cg.n_iter)))
    return out


def uneven_case():
    """2D elasticity (16 patches) on 3 ranks: every rank computes every
    patch, the outputs are replicated, and the solver logs the warning."""
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        s = port_solver("2d-elasticity", verbose=True)
        u, A_st = s.build_step(make_mesh(device="cpu"))(s.coef_q, s.fem_rhs)
    return dict(u=u.full_tensor(), A_st=A_st.full_tensor(),
                placements=[type(u.placements[0]).__name__,
                           type(A_st.placements[0]).__name__],
                log=text.getvalue())


def single_case():
    """The port's single-device steps of every case and its unsharded
    sweep, the cases dealt round-robin over the ranks: name -> (u, A_st);
    and for "2d-r4-l2" under "sens" the larger relative change of u and
    A_st when the coefficients move by 1e-15 relative."""
    n, r = dist.get_world_size(), dist.get_rank()
    out = {}
    for i, name in enumerate(list(STEPS) + ["sweep"]):
        if i % n != r:
            continue
        s = port_solver("2d-elasticity" if name == "sweep" else name)
        if name == "sweep":
            out[name] = sweep_step(s)(stack_fields(sweep_fields(s)),
                                      s.fem_rhs)
            continue
        step = s.build_step()
        out[name] = u, A_st = step(s.coef_q, s.fem_rhs)
        if name == "2d-r4-l2":
            gen = torch.Generator().manual_seed(0)
            pu, pA = step({k: v * (1 + 1e-15 * torch.randn(
                v.shape, generator=gen, dtype=v.dtype))
                for k, v in s.coef_q.items()}, s.fem_rhs)
            out["sens"] = max(float((a - b).abs().max() / b.abs().max())
                              for a, b in ((pu, u), (pA, A_st)))
    return {k: v for part in gathered(out) for k, v in part.items()}


def helpers_case():
    """``shard_patches``, ``replicate`` and ``full_tensor`` on a 1-D mesh:
    a leading dim that divides the mesh is sharded, one that does not is
    replicated, and ``full_tensor`` gives the whole array back."""
    from dealii_slod_tpu_torch.parallel.mesh import (full_tensor,
                                                     replicate)
    mesh = make_mesh(device="cpu")
    n = dist.get_world_size()
    out = {}
    for rows in (2 * n, 2 * n + 1):
        x = torch.arange(rows * 3, dtype=torch.float64).reshape(rows, 3)
        d = shard_patches(mesh, x)
        out[rows] = (type(d.placements[0]).__name__,
                     d.to_local().shape[0],
                     bool(torch.equal(full_tensor(d), x)))
    out["replicate"] = bool(torch.equal(
        full_tensor(replicate(mesh, torch.ones(2))), torch.ones(2)))
    return out


def failing_rank():
    """Rank 1 raises; rank 0 waits in a collective that never completes:
    ``spawn`` must end it and raise the failure."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 raises on purpose")
    dist.barrier()


def refusal_case():
    """What a sharded step refuses, as (exception type name, message)."""
    s = port_solver("2d-elasticity")
    n = dist.get_world_size()
    out = {}
    for key, call in (
            ("n_devices", lambda: make_mesh(n + 1, device="cpu")),
            ("axis", lambda: s.build_step(make_mesh(axis="samples",
                                                    device="cpu"))),
            ("sweep-axis", lambda: sweep_step(s, make_mesh(device="cpu"),
                                              axis="samples")),
            ("not-a-mesh", lambda: s.build_step(object()))):
        try:
            call()
            out[key] = None
        except (TypeError, ValueError) as exc:
            out[key] = (type(exc).__name__, str(exc))
    return out


def cg_case():
    """tests/test_distributed_cg.py's system (64 x 64 SPD, seed 3), rows
    sharded: each rank holds its row block and rows of b, the matvec
    gathers x; against the dense solve."""
    n_rows = 64
    rng = np.random.default_rng(3)
    M = rng.standard_normal((n_rows, n_rows))
    A = M @ M.T + n_rows * np.eye(n_rows)
    b = rng.standard_normal(n_rows)
    group = make_mesh(device="cpu").get_group()
    n, r = dist.get_world_size(), dist.get_rank()
    rows = slice(r * n_rows // n, (r + 1) * n_rows // n)
    A_rows = torch.from_numpy(A[rows])
    res = cg(lambda x: A_rows @ all_gather_rows(x, group),
             torch.from_numpy(b[rows]), max_steps=200, tolerance=1e-12,
             reduce=1e-14, group=group)
    x = all_gather_rows(res.x, group)
    return dict(x=x, x_ref=np.linalg.solve(A, b),
                iters=gathered(int(res.n_iter)),
                converged=gathered(bool(res.converged)))


def sweep_case():
    """The sharded sweep over SWEEP_SAMPLES fields of the 2D elasticity
    case, the sample axis sharded."""
    s = port_solver("2d-elasticity")
    batch = stack_fields(sweep_fields(s))
    mesh = make_mesh(axis="samples", device="cpu")
    u, A_st = sweep_step(s, mesh, axis="samples")(batch, s.fem_rhs)
    return dict(u=u.full_tensor(), A_st=A_st.full_tensor(),
                placements=type(u.placements[0]).__name__,
                local_samples=gathered(u.to_local().shape[0]))


def mc_case():
    """MC_SHARD=2 through the example's ``main`` in this group (the path
    ``torchrun`` takes), its printed lines captured."""
    from dealii_slod_tpu_torch.examples import monte_carlo
    os.environ.update(MC_ENV, MC_SHARD=str(dist.get_world_size()))
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = monte_carlo.main(["--device", "cpu"])
    return dict(qoi=out["qoi"], samples_per_rank=gathered(
        out["samples_per_rank"]), log=text.getvalue())


def run_group(path, cases):
    """One rank of a group: every case in ``cases``; rank 0 saves them."""
    torch.set_num_threads(1)
    fns = dict(uneven=uneven_case, refusals=refusal_case, cg=cg_case,
               sweep=sweep_case, mc=mc_case, single=single_case,
               helpers=helpers_case)
    out = {c: (step_case(c) if c in STEPS or c in ROUTES else fns[c]())
           for c in cases}
    if dist.get_rank() == 0:
        torch.save(out, path)


def run(path, n, cases):
    """Spawn ``n`` gloo CPU ranks running ``cases``; the results' file."""
    spawn(run_group, n, "cpu", path, cases)
    return path


def run_failing():
    """``spawn`` of ``failing_rank`` on 2 gloo CPU ranks: the exception
    it raises, as (type name, message)."""
    try:
        spawn(failing_rank, 2, "cpu")
    except RuntimeError as exc:
        return type(exc).__name__, str(exc)
    return None
