"""Linear elasticity problem -div(2 mu eps(u) + lambda div(u) I) = f
(counterpart of ``dealii_slod_tpu/models/elasticity.py``, reference
``ElasticityProblem<dim>``, include/Elasticity.h:92-438): dim solution
components and the Lame coefficient fields ``lam`` / ``mu``."""

from __future__ import annotations

import dataclasses

import numpy as np

from dealii_slod_tpu_torch.config import SLODConfig
from dealii_slod_tpu_torch.models.coefficients import GlibcRand, make_field


class ElasticityProblem:
    name = "Elasticity"

    def __init__(self, cfg: SLODConfig):
        # the reference uses refinement 6 for the Lame fields
        if cfg.coef_refinement == 8:
            cfg = dataclasses.replace(cfg, coef_refinement=6)
        self.cfg = cfg
        self.n_components = cfg.dim
        # the reference draws Lambda then Mu from the same rand() stream
        # (Elasticity.h:104-105 construction order)
        stream = GlibcRand() if cfg.reference_parity else None
        if stream is not None and cfg.coef_rand_offset:
            stream.draw(cfg.coef_rand_offset)
        self.lam = make_field(cfg, cfg.dim, seed_offset=0, stream=stream)
        self.mu = make_field(cfg, cfg.dim, seed_offset=1, stream=stream)

    def coefficients(self, points: np.ndarray) -> dict:
        """Lame coefficient values at quadrature points (..., dim)."""
        return {"lam": self.lam(points), "mu": self.mu(points)}

    def is_constant(self) -> bool:
        return (getattr(self.lam, "values", 0) is None
                and getattr(self.mu, "values", 0) is None)
