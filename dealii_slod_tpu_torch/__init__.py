"""dealii_slod_tpu_torch — PyTorch / CUDA port of ``dealii_slod_tpu``.

The JAX package ``dealii_slod_tpu`` is the reference; this package runs the
same mathematics in PyTorch, with every Pallas kernel on its path rewritten
as a hand-written CUDA kernel for NVIDIA Hopper (``csrc/``, built with nvcc
for ``sm_90a`` at first use).  Plain tensor code is PyTorch.

The package imports ``torch`` and numpy, and never ``jax``: from the JAX
package it only uses the numpy-only modules ``config`` and ``grid``, and the
element tensors and coefficient samplers, loaded from their files
(``utils/reference.py``).

What runs today is the SLOD diffusion step that ``bench.py`` times::

    s = LODSolver(cfg, DiffusionProblem(cfg), device="cuda")
    s.assemble_fine_rhs()
    step = s.build_step()
    u, A_st = step(s.coef_q, s.fem_rhs)

with ``eig_solver="jacobi"`` and the fused patch solver.  Every other knob
value raises ``NotImplementedError`` naming its ROADMAP.md entry.
"""

__version__ = "0.1.0"

from dealii_slod_tpu.config import ReductionControl, SLODConfig
from dealii_slod_tpu_torch.models.diffusion import DiffusionProblem
from dealii_slod_tpu_torch.models.lod import LODSolver
from dealii_slod_tpu_torch.utils.state import load_state

__all__ = [
    "DiffusionProblem",
    "LODSolver",
    "ReductionControl",
    "SLODConfig",
    "load_state",
]
