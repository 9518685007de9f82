"""Error norms by fine-grid quadrature and convergence tables (counterpart
of ``dealii_slod_tpu/utils/errors.py``, the same printed text): L2,
H1-seminorm and Linfty of the difference between a fine nodal field and
either an exact (parsed) function or another nodal field, integrated with
the tensor-product Gauss rule of the assembly.

A nodal-vs-nodal difference of CUDA tensors is integrated on the card:
only the per-cell sums come back, to be summed in float64 on the host (the
reference's ``_device_norms``).  Everything else runs in numpy."""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from dealii_slod_tpu_torch.config import ParsedFunction
from dealii_slod_tpu_torch.ops.element import ElementTensors


def host_array(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _fd_gradient(fn: ParsedFunction, points: np.ndarray,
                 eps: float = 1e-6) -> np.ndarray:
    """(..., dim) -> (..., C, dim) central finite-difference gradient of a
    parsed function."""
    dim = points.shape[-1]
    grads = []
    for k in range(dim):
        dp = np.zeros(dim)
        dp[k] = eps
        grads.append((fn(points + dp) - fn(points - dp)) / (2 * eps))
    return np.stack(grads, axis=-1)


def fe_values_at_quadrature(et: ElementTensors, conn: np.ndarray,
                            u: np.ndarray):
    """Nodal field -> (values, gradients) at all quadrature points.

    u: (n_nodes, C) -> values (n_sub, nq, C), grads (n_sub, nq, C, dim)."""
    ue = np.asarray(u)[conn]                       # (n_sub, m, C)
    vals = np.einsum("qi,sic->sqc", et.V, ue)
    grads = np.einsum("qik,sic->sqck", et.G, ue)
    return vals, grads


def _device_norms(et: ElementTensors, conn, u: torch.Tensor,
                  other: torch.Tensor):
    """Per-cell quadrature sums of the three norms on u's device
    (nodal-vs-nodal), summed in float64 on the host."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=u.dtype, device=u.device)

    conn = torch.as_tensor(conn, device=u.device).long()
    de = (u - other.to(u.device, u.dtype))[conn]   # (n_sub, m, C)
    ev = torch.einsum("qi,sic->sqc", t(et.V), de)
    eg = torch.einsum("qik,sic->sqck", t(et.G), de)
    w = t(et.w)
    l2c = torch.einsum("q,sqc->s", w, ev ** 2)
    h1c = torch.einsum("q,sqck->s", w, eg ** 2)
    l2 = float(np.sqrt(host_array(l2c).astype(np.float64).sum()))
    h1s = float(np.sqrt(host_array(h1c).astype(np.float64).sum()))
    return l2, h1s, float(ev.abs().max())


def error_norms(grid, et: ElementTensors, conn, u,
                exact: Optional[ParsedFunction] = None,
                other=None,
                qpts: Optional[np.ndarray] = None) -> Dict[str, float]:
    """L2 / H1 / H1-semi / Linfty norms of (u - exact) or (u - other)."""
    if (other is not None and isinstance(u, torch.Tensor)
            and u.device.type == "cuda"):
        l2, h1s, linf = _device_norms(et, conn, u, torch.as_tensor(other))
        h1 = float(np.sqrt(l2 * l2 + h1s * h1s))
        return {"L2": l2, "H1": h1, "H1_semi": h1s, "Linfty": linf}
    conn = host_array(conn)
    vals, grads = fe_values_at_quadrature(et, conn, host_array(u))
    if other is not None:
        ovals, ograds = fe_values_at_quadrature(et, conn, host_array(other))
    else:
        assert exact is not None and qpts is not None
        ovals = exact(qpts)
        ograds = _fd_gradient(exact, qpts)
    ev = vals - ovals
    eg = grads - ograds
    w = et.w                                       # (nq,)
    l2 = float(np.sqrt(np.einsum("q,sqc->", w, ev ** 2)))
    h1s = float(np.sqrt(np.einsum("q,sqck->", w, eg ** 2)))
    linf = float(np.abs(ev).max())
    # deal.II's H1_norm includes the L2 part
    h1 = float(np.sqrt(l2 * l2 + h1s * h1s))
    return {"L2": l2, "H1": h1, "H1_semi": h1s, "Linfty": linf}


class ConvergenceTable:
    """Accumulates (cells, dofs, norms) rows and prints an aligned table
    (the reference's ParsedConvergenceTable output).  With two or more rows
    and a known ``dim``, each norm column gains a rate column: the observed
    order ``log(e_prev/e_cur) / log(h_prev/h_cur)`` with
    ``h ~ cells^(-1/dim)``."""

    def __init__(self, label: str, dim: int | None = None):
        self.label = label
        self.dim = dim
        self.rows = []

    def add_row(self, cells: int, dofs: int, norms: Dict[str, float]):
        self.rows.append((cells, dofs, dict(norms)))

    def rates(self) -> list:
        """Per-row dict of observed orders (first row: None entries)."""
        out = [{k: None for k in self.rows[0][2]}] if self.rows else []
        for (c0, _, n0), (c1, _, n1) in zip(self.rows, self.rows[1:]):
            d = self.dim or 1
            ratio = (c1 / c0) ** (1.0 / d)          # h0/h1
            row = {}
            for k in n1:
                e0, e1 = n0.get(k), n1[k]
                row[k] = (math.log(e0 / e1) / math.log(ratio)
                          if e0 and e1 and e0 > 0 and e1 > 0 and ratio != 1
                          else None)
            out.append(row)
        return out

    def __str__(self) -> str:
        if not self.rows:
            return f"[{self.label}] (empty)"
        keys = list(self.rows[0][2].keys())
        with_rates = len(self.rows) > 1 and self.dim is not None
        head = f"{'cells':>8} {'dofs':>10} " + " ".join(
            f"{self.label}_{k:>10}" + (f" {'rate':>6}" if with_rates else "")
            for k in keys)
        lines = [head]
        rates = self.rates() if with_rates else None
        for i, (cells, dofs, norms) in enumerate(self.rows):
            cols = []
            for k in keys:
                cols.append(f"{norms[k]:>{11 + len(self.label)}.6e}")
                if with_rates:
                    r = rates[i][k]
                    cols.append(f"{r:>6.2f}" if r is not None else f"{'-':>6}")
            lines.append(f"{cells:>8} {dofs:>10} " + " ".join(cols))
        return "\n".join(lines)
