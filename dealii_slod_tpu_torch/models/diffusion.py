"""Scalar diffusion problem -div(alpha grad u) = f (counterpart of
``dealii_slod_tpu/models/diffusion.py``, re-declared so that the port does
not import the JAX package's ``models``)."""

from __future__ import annotations

import numpy as np

from dealii_slod_tpu.config import SLODConfig
from dealii_slod_tpu_torch.utils.reference import coefficients


class DiffusionProblem:
    name = "Diffusion"

    def __init__(self, cfg: SLODConfig):
        self.cfg = cfg
        self.n_components = 1
        self.alpha = coefficients.make_field(cfg, cfg.dim)

    def coefficients(self, points: np.ndarray) -> dict:
        """Coefficient values at quadrature points (..., dim) -> {..., }."""
        return {"alpha": self.alpha(points)}

    def is_constant(self) -> bool:
        return getattr(self.alpha, "values", 0) is None
