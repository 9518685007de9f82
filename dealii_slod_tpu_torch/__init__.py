"""dealii_slod_tpu_torch — PyTorch / CUDA port of ``dealii_slod_tpu``.

The JAX package ``dealii_slod_tpu`` is the reference; this package runs the
same mathematics in PyTorch, with every Pallas kernel on its path rewritten
as a hand-written CUDA kernel for NVIDIA Hopper (``csrc/``, built with nvcc
for ``sm_90a`` at first use).  Plain tensor code is PyTorch.

The package imports ``torch`` and numpy, and nothing of ``jax`` or of the
JAX package: the host-side modules it shares with the reference (``config``,
``grid``, ``ops/element``, ``models/coefficients``) are its own copies.

What runs today is the SLOD step that ``bench.py`` times, for scalar
diffusion and for linear elasticity (C = dim components), with its default
knobs (``eig_solver="auto"``: the smallk spectral stage on the card in
float32; ``patch_solver="auto"``: the fused patch solve, or its 2x2 Schur
split where the patch block is too large, as 3D elasticity's) or
``eig_solver="jacobi"``::

    s = LODSolver(cfg, DiffusionProblem(cfg))          # on the card
    s = LODSolver(cfg, ElasticityProblem(cfg))         # or elasticity
    s.assemble_fine_rhs()
    step = s.build_step()
    u, A_st = step(s.coef_q, s.fem_rhs)

``LODSolver`` runs on the card unless given ``device="cpu"``.  Every other
knob value raises ``NotImplementedError`` naming its ROADMAP.md entry.
"""

__version__ = "0.1.0"

from dealii_slod_tpu_torch.config import ReductionControl, SLODConfig
from dealii_slod_tpu_torch.models.diffusion import DiffusionProblem
from dealii_slod_tpu_torch.models.elasticity import ElasticityProblem
from dealii_slod_tpu_torch.models.lod import LODSolver
from dealii_slod_tpu_torch.utils.state import load_state

__all__ = [
    "DiffusionProblem",
    "ElasticityProblem",
    "LODSolver",
    "ReductionControl",
    "SLODConfig",
    "load_state",
]
