"""dealii_slod_tpu_torch — PyTorch / CUDA port of ``dealii_slod_tpu``.

The JAX package ``dealii_slod_tpu`` is the reference; this package runs the
same mathematics in PyTorch, with every Pallas kernel on its path rewritten
as a hand-written CUDA kernel for NVIDIA Hopper (``csrc/``, built with nvcc
for ``sm_90a`` at first use).  Plain tensor code is PyTorch.

The package imports ``torch`` and numpy, and nothing of ``jax`` or of the
JAX package: the host-side modules it shares with the reference (``config``,
``grid``, ``ops/element``, ``models/coefficients``) are its own copies.

What runs: the reference's whole pipeline, ``LODSolver.run()`` (basis,
coarse operator and solve, the fine and coarse FEM comparison solves, the
error tables, VTU output), for scalar diffusion, reaction-diffusion
(``ReactionDiffusionProblem``: a mass term weighted by ``cfg.reaction``)
and linear elasticity (C = dim components), plain LOD
(``SLODConfig()``'s default) or SLOD, on
the reference's knobs: ``eig_solver="auto"`` is the smallk spectral stage
on the card in float32 and the ``eigh`` stage ("lapack") elsewhere, also
"smallk", "jacobi", "lapack" / "lax"; ``patch_solver="auto"`` is the
fused patch solve on the whole block on the card in float32 (up to
``models.lod.K1_WHOLE_MAX_N``) and elsewhere the reference's size rule
(the fused patch solve, its 2x2 Schur split where the block is too
large, as 3D elasticity's), also "fused_split", "lax" (the per-patch
Cholesky solve) and "panel"; ``kernel_mode="classes"``,
``assembly_mode="scatter"``, ``trace_kernel="off"`` and
``coarse_solve="direct"``; basis checkpoints (``utils/checkpoint.py``),
the sample-axis sweep over a batch of coefficient fields
(``parallel.sweep_step``, with the device sampler
``models.coefficients.lognormal_lattice_batch``) and the examples
(``python -m dealii_slod_tpu_torch.examples.<name>``: convergence_study,
multi_rhs, monte_carlo)::

    cfg = SLODConfig()                                  # 2D plain LOD, f64
    results = LODSolver(cfg, DiffusionProblem(cfg)).run()   # on the card
    s = LODSolver(cfg, ElasticityProblem(cfg), device="cpu")
    s.assemble_fine_rhs()
    u, A_st = s.build_step()(s.coef_q, s.fem_rhs)       # the step alone

and the command line, ``python -m dealii_slod_tpu_torch.cli
diffusion|elasticity|reaction [file.prm] [--device cpu]``.  ``LODSolver``,
the sweep, the examples and the CLI run on the card unless given
``device="cpu"``.  The scaling axes run over ``torch.distributed``
(``parallel/mesh.py``): ``build_step(mesh)`` shards the patch axis and
``sweep_step(solver, mesh, axis="samples")`` the sample axis over the
ranks of a ``DeviceMesh`` (``parallel.make_mesh``), started by
``parallel.mesh.spawn`` or ``torchrun``; the outputs are ``DTensor``s.
"""

__version__ = "0.1.0"

from dealii_slod_tpu_torch.config import ReductionControl, SLODConfig
from dealii_slod_tpu_torch.grid import GridSpec, PatchTopology
from dealii_slod_tpu_torch.models.diffusion import DiffusionProblem
from dealii_slod_tpu_torch.models.elasticity import ElasticityProblem
from dealii_slod_tpu_torch.models.lod import LODSolver
from dealii_slod_tpu_torch.models.reaction import ReactionDiffusionProblem
from dealii_slod_tpu_torch.utils.errors import ConvergenceTable, error_norms
from dealii_slod_tpu_torch.utils.state import load_state

__all__ = [
    "ConvergenceTable",
    "DiffusionProblem",
    "ElasticityProblem",
    "GridSpec",
    "LODSolver",
    "PatchTopology",
    "ReactionDiffusionProblem",
    "ReductionControl",
    "SLODConfig",
    "error_norms",
    "load_state",
]
