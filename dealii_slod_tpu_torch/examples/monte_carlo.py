"""Monte-Carlo over random coefficient fields (counterpart of
``examples/monte_carlo.py``).

The reference rebuilds every patch mesh, sparse matrix and direct
factorization per coefficient sample (source/LOD.cc:296-768 re-runs in
full).  Here the end-to-end SLOD step (basis construction -> coarse stencil
operator -> CG solve) is one function of the coefficient tensors
(``LODSolver.build_step``), so a Monte-Carlo study builds its tables once
and then streams fields through the step's kernels.

Prints the first call's wall, the per-sample walls and the spread of the
quantity of interest mean(u_H) (the mean coarse response) across samples.

    python -m dealii_slod_tpu_torch.examples.monte_carlo             # card
    MC_DIM=3 MC_REFINE=4 MC_SAMPLES=32 MC_FIELD=lognormal \\
        python -m dealii_slod_tpu_torch.examples.monte_carlo
    python -m dealii_slod_tpu_torch.examples.monte_carlo --device cpu
    MC_SHARD=2 python -m dealii_slod_tpu_torch.examples.monte_carlo
    torchrun --nproc-per-node 2 -m \\
        dealii_slod_tpu_torch.examples.monte_carlo              # MC_SHARD=2

Environment: MC_DIM (2), MC_REFINE (4), MC_SAMPLES (8), MC_CONTRAST (1e2),
MC_COEF_REFINE (4), MC_DTYPE (float32 on the card, float64 on the CPU),
MC_FIELD ("random": the reference-style i.i.d. piecewise-constant field,
sampled on the host; "lognormal": correlated Gaussian log-fields sampled
on the run's device by ``models.coefficients.lognormal_lattice_batch``),
MC_CORR_LEN (0.1), MC_SHARD (N: the sample axis sharded over N ranks,
``parallel.sweep_step(mesh=...)``: each rank runs its share of the
samples, and rank 0 prints the first call's wall, the batch's wall and
the QoIs.  The ranks are started by ``parallel.mesh.spawn``, each on a
card of its own or, where there are fewer cards than ranks, sharing them
over gloo;
under ``torchrun`` the ranks are torchrun's and MC_SHARD defaults to its
world size).
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import numpy as np
import torch


def lattice_index(points, refinement: int, device) -> torch.Tensor:
    """Flat index into an (N^dim) lattice (N = 2^refinement, x fastest) of
    the lattice cell holding each point (..., dim), as the JAX script looks
    its sampler's fields up."""
    N = 2 ** refinement
    eta = 1.0 / N
    idx = np.clip((np.asarray(points) / eta).astype(np.int64), 0, N - 1)
    return torch.as_tensor((idx * N ** np.arange(idx.shape[-1])).sum(-1),
                           device=device)


def setup(device) -> dict:
    """The run's configuration from the MC_* environment, its solver on
    ``device`` (fine rhs assembled) and ``field(seed)`` -> the sample's
    coefficients on that device (MC_FIELD=lognormal: the device sampler's
    lattices for seeds 0 .. MC_SAMPLES, drawn here)."""
    from dealii_slod_tpu_torch import (DiffusionProblem, LODSolver,
                                       ReductionControl, SLODConfig)
    from dealii_slod_tpu_torch.models.coefficients import (
        RandomField, lognormal_lattice_batch)

    dim = int(os.environ.get("MC_DIM", 2))
    refine = int(os.environ.get("MC_REFINE", 4))
    n_samples = int(os.environ.get("MC_SAMPLES", 8))
    contrast = float(os.environ.get("MC_CONTRAST", 1e2))
    coef_ref = int(os.environ.get("MC_COEF_REFINE", 4))
    field_kind = os.environ.get("MC_FIELD", "random")
    dev = torch.device(device)

    cfg = SLODConfig(
        dim=dim, n_global_refinements=refine, n_subdivisions=2,
        oversampling=2, lod_stabilization=True,
        constant_coefficients=False, coef_seed=0, coef_refinement=coef_ref,
        coef_min=1.0, coef_max=contrast, rhs="1", bc="0",
        dtype=os.environ.get("MC_DTYPE", "float64" if dev.type == "cpu"
                             else "float32"),
        solve_fine_problem=False,
        coarse_solver=ReductionControl(500, 1e-6, 1e-6))
    solver = LODSolver(cfg, DiffusionProblem(cfg), device=dev,
                       verbose=False)
    solver.assemble_fine_rhs()

    lattice, sampler_s = None, 0.0
    if field_kind == "lognormal":
        corr = float(os.environ.get("MC_CORR_LEN", 0.1))
        flat_idx = lattice_index(solver.qpts, coef_ref, dev)
        gen = torch.Generator(device=dev).manual_seed(cfg.coef_seed)
        t0 = time.perf_counter()
        lattice = lognormal_lattice_batch(
            gen, n_samples + 1, coef_ref, dim, cfg.coef_min, cfg.coef_max,
            corr_len=corr, device=dev)
        float(lattice[0, 0])                  # syncs the card
        sampler_s = time.perf_counter() - t0

        def field(seed):
            return {"alpha": lattice[seed, flat_idx].to(solver.dtype)}
    else:
        def field(seed):
            f = RandomField(cfg.coef_min, cfg.coef_max, coef_ref, dim,
                            seed=seed, sampler="numpy")
            return {"alpha": torch.as_tensor(f(solver.qpts),
                                             dtype=solver.dtype, device=dev)}
    return dict(dim=dim, refine=refine, n_samples=n_samples,
                contrast=contrast, field_kind=field_kind, solver=solver,
                field=field, lattice=lattice, sampler_s=sampler_s)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)
    import torch.distributed as dist

    ranks = dist.is_initialized() or "WORLD_SIZE" in os.environ
    n_shard = int(os.environ.get("MC_SHARD", 0) or (
        os.environ.get("WORLD_SIZE", 0) if ranks else 0))
    if n_shard and not ranks:
        # one process per rank; the parent builds the kernels once first
        from dealii_slod_tpu_torch.parallel.mesh import spawn
        if torch.device(args.device).type == "cuda":
            from dealii_slod_tpu_torch.utils import kernels
            kernels.library()
        out = spawn(functools.partial(_rank_main, ["--device", args.device]),
                    n_shard, args.device)
        return dict(out[0].value, launches=[r.launches for r in out])
    mesh = None
    if n_shard:
        # before the solver: a rank's tensors go to the rank's card
        from dealii_slod_tpu_torch.parallel import make_mesh
        mesh = make_mesh(n_shard, axis="samples", device=args.device)
    run = setup(args.device)
    if mesh is not None:
        return _sharded(run, mesh)
    solver, field, n_samples = run["solver"], run["field"], run["n_samples"]
    rhs, dev = solver.fem_rhs, solver.device
    step = solver.build_step()

    # the first call, on sample 0, builds the tables
    t0 = time.perf_counter()
    u0, _ = step(field(0), rhs)
    float(u0.sum())                           # syncs the card
    first_s = time.perf_counter() - t0

    qoi, walls = [], []
    for s in range(n_samples):
        t0 = time.perf_counter()
        u, _ = step(field(s + 1), rhs)
        q = float(u.mean())                   # QoI: mean coarse response
        walls.append(time.perf_counter() - t0)
        qoi.append(q)

    q = np.array(qoi)
    print(f"config: dim={run['dim']} refine={run['refine']} "
          f"patches={solver.topo.n_patches} contrast={run['contrast']:g} "
          f"dtype={solver.cfg.dtype} field={run['field_kind']} "
          f"device={dev.type}")
    if run["lattice"] is not None:
        print(f"sampler ({n_samples + 1} fields on the {dev.type}): "
              f"{run['sampler_s'] * 1e3:.1f} ms")
    print(f"first call (once): {first_s:.2f} s")
    print(f"per-sample: median {np.median(walls) * 1e3:.1f} ms "
          f"(min {min(walls) * 1e3:.1f}, max {max(walls) * 1e3:.1f}) "
          f"over {n_samples} fields")
    print(f"QoI mean(u_H): mean {q.mean():.6e}  std {q.std():.2e}  "
          f"rel spread {q.std() / abs(q.mean()):.3f}")
    return dict(qoi=qoi, walls=walls, first_s=first_s,
                sampler_s=run["sampler_s"], lattice=run["lattice"],
                solver=solver, field=field)


def _sharded(run, mesh):
    """MC_SHARD: the samples 1 .. MC_SAMPLES of ``setup``'s run sharded
    over ``mesh``'s ranks (the JAX script's MC_SHARD branch): the sweep's
    first call, then the same batch again, timed to the QoIs on rank 0."""
    import torch.distributed as dist

    from dealii_slod_tpu_torch.parallel import stack_fields, sweep_step
    from dealii_slod_tpu_torch.parallel.mesh import full_tensor
    solver, n_samples, n_shard = run["solver"], run["n_samples"], mesh.size()
    sw = sweep_step(solver, mesh=mesh, axis="samples")
    batch = stack_fields([run["field"](s + 1) for s in range(n_samples)])
    walls = []
    for _ in range(2):                      # the first call, then steady
        t0 = time.perf_counter()
        u, _ = sw(batch, solver.fem_rhs)
        q = full_tensor(u).mean(dim=(1, 2)).cpu().numpy()
        walls.append(time.perf_counter() - t0)
    first_s, wall = walls
    if dist.get_rank() == 0:
        print(f"config: dim={run['dim']} refine={run['refine']} "
              f"patches={solver.topo.n_patches} "
              f"contrast={run['contrast']:g} samples={n_samples} sharded "
              f"over {n_shard} ranks ({dist.get_backend()}, "
              f"{solver.device.type})")
        print(f"first call (once): {first_s:.2f} s")
        print(f"batch of {n_samples}: {wall * 1e3:.1f} ms "
              f"({wall / n_samples * 1e3:.2f} ms/sample)")
        print(f"QoI mean(u_H): mean {q.mean():.6e}  std {q.std():.2e}")
    return dict(qoi=[float(v) for v in q], first_s=first_s, wall=wall,
                samples_per_rank=u.to_local().shape[0], solver=solver)


def _rank_main(argv):
    """One spawned rank of MC_SHARD: ``main`` in the rank's process group;
    the picklable part of its result."""
    out = main(argv)
    return {k: v for k, v in out.items() if k != "solver"}


if __name__ == "__main__":
    main()
