"""Sample-axis sweeps: Monte-Carlo / parameter studies over a batch of
coefficient fields (counterpart of ``dealii_slod_tpu/parallel/sweep.py``).

The end-to-end SLOD step (``LODSolver.build_step``) is a function of the
coefficient tensors, so a batch of S fields is a new leading axis.  On one
card the sweep runs the solver's step once per sample and stacks the
results: the step's kernels are launches of their own that
``torch.func.vmap`` cannot batch.  Over a mesh (``parallel.mesh``) each
rank runs its own contiguous share of the samples, with no communication:
a scaling axis the reference's patch partitioning has no counterpart
for."""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from dealii_slod_tpu_torch.parallel.mesh import check_mesh


def sweep_step(solver, mesh=None, axis: str = "patches"):
    """Return ``step(coefs_stacked, fem_rhs) -> (u (S, P, C), A_stencil
    (S, P, S_off, C, C))``, each entry of ``coefs_stacked`` with a leading
    sample axis S.  It runs where ``solver`` runs (the card unless the
    solver was built for the CPU): the fields are moved to the solver's
    device and dtype one sample at a time.

    With ``mesh`` (a ``DeviceMesh`` whose dimension ``axis`` the samples
    are sharded over; every rank passes the whole batch) rank r runs the
    samples [r S / n, (r + 1) S / n) and the outputs are ``DTensor``s,
    ``Shard(0)``; when S does not divide the mesh, every rank runs every
    sample and the outputs are ``Replicate()``."""
    base = solver.build_step()
    names = list(solver.coef_names)

    def run(coefs, fem_rhs, lo, hi):
        us, As = [], []
        for i in range(lo, hi):
            u, A_st = base({k: coefs[k][i].to(solver.device, solver.dtype)
                            for k in names}, fem_rhs)
            us.append(u)
            As.append(A_st)
        return torch.stack(us), torch.stack(As)

    def stacked(coefs, fem_rhs):
        return run(coefs, fem_rhs, 0, len(coefs[names[0]]))

    if mesh is None:
        return stacked
    check_mesh(mesh, axis, solver.device)
    n, r = mesh.size(), mesh.get_local_rank(axis)

    def sharded(coefs, fem_rhs):
        S = len(coefs[names[0]])
        if S % n:
            solver.log(f"WARNING: {S} samples not divisible by {n} "
                       "devices; every rank runs every sample")
            out = run(coefs, fem_rhs, 0, S)
            place = [Replicate()]
        else:
            out = run(coefs, fem_rhs, r * S // n, (r + 1) * S // n)
            place = [Shard(0)]
        return tuple(DTensor.from_local(x, mesh, place, run_check=False)
                     for x in out)

    return sharded


def stack_fields(field_dicts):
    """[{name: (n_sub, nq)}, ...] -> {name: (S, n_sub, nq)}."""
    names = field_dicts[0].keys()
    return {k: torch.stack([torch.as_tensor(d[k]) for d in field_dicts])
            for k in names}
