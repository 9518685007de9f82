"""Sample-axis sweeps: Monte-Carlo / parameter studies over a batch of
coefficient fields (counterpart of ``dealii_slod_tpu/parallel/sweep.py``).

The end-to-end SLOD step (``LODSolver.build_step``) is a function of the
coefficient tensors, so a batch of S fields is a new leading axis.  On one
card the sweep runs the solver's step once per sample and stacks the
results: the step's kernels are launches of their own that
``torch.func.vmap`` cannot batch.  Sharding the sample axis over several
cards (the reference's ``mesh``) is not ported."""

from __future__ import annotations

import torch

from dealii_slod_tpu_torch.models.lod import SCALING, _not_ported


def sweep_step(solver, mesh=None, axis: str = "patches"):
    """Return ``step(coefs_stacked, fem_rhs) -> (u (S, P, C), A_stencil
    (S, P, S_off, C, C))``, each entry of ``coefs_stacked`` with a leading
    sample axis S.  It runs where ``solver`` runs (the card unless the
    solver was built for the CPU): the fields are moved to the solver's
    device and dtype one sample at a time.  ``mesh`` other than None (the
    sharded sweep) raises ``NotImplementedError``."""
    if mesh is not None:
        _not_ported(f"sweep_step(mesh=..., axis={axis!r}) (the sharded "
                    "sample-axis sweep)", SCALING)
    base = solver.build_step()
    names = list(solver.coef_names)

    def stacked(coefs, fem_rhs):
        us, As = [], []
        for i in range(len(coefs[names[0]])):
            u, A_st = base({k: coefs[k][i].to(solver.device, solver.dtype)
                            for k in names}, fem_rhs)
            us.append(u)
            As.append(A_st)
        return torch.stack(us), torch.stack(As)

    return stacked


def stack_fields(field_dicts):
    """[{name: (n_sub, nq)}, ...] -> {name: (S, n_sub, nq)}."""
    names = field_dicts[0].keys()
    return {k: torch.stack([torch.as_tensor(d[k]) for d in field_dicts])
            for k in names}
