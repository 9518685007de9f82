"""Basis / coarse-operator checkpoints (counterpart of
``dealii_slod_tpu/utils/checkpoint.py``).

The basis canvases and the stencil coarse operator depend only on the
configuration and the coefficients, so a serving process can save them once
and answer new right-hand sides without the basis stage.  The file is the
reference's ``np.savez_compressed`` layout (``fingerprint``, ``Phi``,
``APhi`` and, once assembled, ``A_stencil``), so a file that either package
writes loads into the other."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from dealii_slod_tpu_torch.utils.errors import host_array


def _config_fingerprint(cfg, n_components: int) -> str:
    payload = {
        "dim": cfg.dim, "n_coarse": cfg.n_coarse,
        "n_subdivisions": cfg.n_subdivisions,
        "oversampling": cfg.oversampling,
        "lod_stabilization": cfg.lod_stabilization,
        "constant_coefficients": cfg.constant_coefficients,
        "coef": [cfg.coef_min, cfg.coef_max, cfg.coef_refinement,
                 cfg.coef_seed, bool(cfg.reference_parity)],
        "coef_field": cfg.coef_field,
        "svd_threshold": cfg.svd_threshold,
        "eig_solver": cfg.eig_solver,
        "n_components": n_components,
        "dtype": cfg.dtype,
    }
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()


def save_basis(solver, path: str) -> str:
    """Save the basis canvases (and the stencil operator if assembled)."""
    data = {
        "fingerprint": np.frombuffer(
            _config_fingerprint(solver.cfg, solver.C).encode(),
            dtype=np.uint8),
        "Phi": host_array(solver.Phi),
        "APhi": host_array(solver.APhi),
    }
    if hasattr(solver, "A_stencil"):
        data["A_stencil"] = host_array(solver.A_stencil)
    np.savez_compressed(path, **data)
    return path


def load_basis(solver, path: str) -> bool:
    """Load basis canvases into the solver, as tensors on its device in its
    dtype; returns False on a configuration mismatch (fingerprint check)
    instead of loading stale data."""
    with np.load(path) as z:
        fp = bytes(z["fingerprint"]).decode()
        if fp != _config_fingerprint(solver.cfg, solver.C):
            return False

        def t(name):
            return torch.as_tensor(z[name], dtype=solver.dtype,
                                   device=solver.device)

        solver.Phi, solver.APhi = t("Phi"), t("APhi")
        if "A_stencil" in z:
            solver.A_stencil = t("A_stencil")
    return True
