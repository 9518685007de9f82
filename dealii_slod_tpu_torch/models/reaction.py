"""Reaction-diffusion problem -div(alpha grad u) + c u = f (the port's copy
of ``dealii_slod_tpu/models/reaction.py``).

Beyond the reference's physics set (it ships Diffusion.h / Elasticity.h
only): a new bilinear-form term is one extra (coefficient, element-tensor)
pair ("creact" -> the mass tensor ``ElementTensors.M``), and the pipeline
(banded patch assembly, SLOD stabilization, stencil coarse operator,
matrix-free fine solve) picks it up with no other changes.

The diffusion coefficient follows the reference's ``problem_parameter``
machinery (Diffusion.h:7-54 semantics via ``make_field``); the reaction
coefficient ``c(x) >= 0`` is the parsed symbolic function ``cfg.reaction``
(default "1")."""

from __future__ import annotations

import numpy as np

from dealii_slod_tpu_torch.config import ParsedFunction, SLODConfig
from dealii_slod_tpu_torch.models.coefficients import make_field


class ReactionDiffusionProblem:
    name = "ReactionDiffusion"

    def __init__(self, cfg: SLODConfig):
        self.cfg = cfg
        self.n_components = 1
        self.alpha = make_field(cfg, cfg.dim)
        self.creact = ParsedFunction(cfg.reaction, 1, cfg.dim)

    def coefficients(self, points: np.ndarray) -> dict:
        """Coefficient values at quadrature points (..., dim)."""
        return {"alpha": self.alpha(points),
                "creact": self.creact(points)[..., 0]}

    def is_constant(self) -> bool:
        """Constant-coefficient patch dedup is only valid when BOTH fields
        are spatially constant (alpha a constant field, c(x) an expression
        with no spatial variables)."""
        exprs = getattr(self.creact, "_exprs", None)
        c_const = exprs is not None and all(
            not ({"x", "y", "z"} & set(code.co_names)) for code in exprs)
        return getattr(self.alpha, "values", 0) is None and c_const
