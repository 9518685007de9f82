"""I.i.d. uniform piecewise-constant fields: one value in [min, max) for
every cell of a lattice of 2^refinement cells per axis, read at each
Gauss point by the lattice cell that holds it (the upstream's
``Alpha(min, max)``, ``source/LOD.cc``)."""

import numpy as np
import torch


class Law:
    def __init__(self, params: dict, points: np.ndarray, device, dtype):
        """``points``: (fine cells, Gauss points, dim) in the unit cube."""
        dim = points.shape[-1]
        N = 2 ** params["refinement"]
        idx = np.clip((points * N).astype(np.int64), 0, N - 1)
        self.size = N ** dim
        self.index = torch.as_tensor((idx * N ** np.arange(dim)).sum(-1),
                                     device=device)
        self.lo, self.hi = params["min"], params["max"]
        self.device, self.dtype = device, dtype

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        """One field (fine cells, Gauss points) from ``gen``."""
        v = torch.rand(self.size, generator=gen, dtype=self.dtype,
                       device=self.device)
        return (self.lo + (self.hi - self.lo) * v)[self.index]
