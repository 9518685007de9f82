"""The state a step consumes, carried across from numpy.

The system has no weights: a step's inputs are the coefficient values at
the quadrature points (``coef_q``) and the eliminated fine right-hand side
(``fem_rhs``).  ``load_state`` turns those (for example the JAX solver's,
as numpy) into the port's tensors; the basis canvases ``Phi`` / ``APhi``
may come along so that the coarse stages can be fed a given basis."""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch


class State(NamedTuple):
    coef_q: Dict[str, torch.Tensor]
    fem_rhs: torch.Tensor
    Phi: Optional[torch.Tensor] = None
    APhi: Optional[torch.Tensor] = None


def load_state(coef_q: Mapping[str, np.ndarray], fem_rhs: np.ndarray,
               device, dtype: torch.dtype,
               Phi: Optional[np.ndarray] = None,
               APhi: Optional[np.ndarray] = None) -> State:
    def t(a):
        return (None if a is None
                else torch.as_tensor(np.asarray(a), dtype=dtype,
                                     device=device).contiguous())

    return State({k: t(v) for k, v in coef_q.items()}, t(fem_rhs), t(Phi),
                 t(APhi))
