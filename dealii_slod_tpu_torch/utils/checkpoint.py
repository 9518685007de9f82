"""Basis / coarse-operator checkpoints (counterpart of
``dealii_slod_tpu/utils/checkpoint.py``).

The basis canvases and the stencil coarse operator depend only on the
configuration and the coefficients, so a serving process can save them once
and answer new right-hand sides without the basis stage.  The file is the
reference's ``np.savez_compressed`` layout (``fingerprint``, ``Phi``,
``APhi`` and, once assembled, ``A_stencil``), so a file that either package
writes loads into the other.

The fingerprint is the reference's, byte for byte, and it leaves out
settings that change the basis.  So the port writes one more key,
``settings``: a JSON object of what else changes ``Phi``, ``APhi`` or
``A_stencil`` beyond rounding.  ``load_basis`` refuses a file whose
``settings`` differ from the solver's.  The JAX loader reads only its
named keys, so it still loads the port's files.  A file without
``settings`` was written by the JAX package: it is loaded on the
fingerprint alone, as the JAX package loads it, and a basis built for
another reaction c(x), lognormal correlation length or spectral setting
loads without complaint.  Rebuild the basis when in doubt.

What ``settings`` holds, and why:

- ``problem``: the problem's name.  C is in the fingerprint, but
  diffusion and reaction-diffusion both have C = 1, and the reaction's
  mass term changes every patch matrix.
- ``reaction``: c(x), read only by a problem with a ``creact``
  coefficient (None otherwise).  A string or a number is stored as it is;
  a callable cannot be compared, so it is stored as a token that no other
  solver produces, and such a file is always refused.
- ``coef_corr_len``: the lognormal field's correlation length.
- ``coef_rand_offset``: the draws the glibc-parity field skips.
- ``smallk_dirs``, ``smallk_power``, ``smallk_tol``: the smallk stage's
  direction count (read in float32 when the Gram is larger than 64), its
  inverse-power steps and its W-stage Jacobi stop.
- ``eig_tol``, ``eig_sweeps``: the Jacobi stage's stop and sweep cap.
- ``spectral_stage``: the stage ``eig_solver`` resolves to on the
  solver's device (``spectral_mode``).  The fingerprint holds "auto",
  which is smallk on the card in float32 and the eigh stage elsewhere.

The fields are stored whether or not the solver's route reads them, so
changing one that the route ignores refuses the file too.

What stays out, and why:

- In the fingerprint already: ``dim``, ``n_global_refinements``,
  ``n_subdivisions``, ``oversampling``, ``lod_stabilization``,
  ``constant_coefficients``, ``coef_min``, ``coef_max``,
  ``coef_refinement``, ``coef_seed``, ``reference_parity``,
  ``coef_field``, ``svd_threshold``, ``eig_solver``, ``dtype``, and C.
  The Lamé fields come from the coefficient fields above.
- ``n_components``: the solver takes C from the problem.
- ``rhs``, ``bc``, ``exact_solution``: the basis and A_st do not depend on
  them (the boundary lifting enters the fine rhs only).
- Routes of the same algebra, whose bases agree to rounding (where the
  SLOD truncation sits at rounding, the prolonged fields agree, as
  ``tests/test_torch_routes.py`` holds them): ``kernel_mode``,
  ``patch_solver``, ``trace_kernel``, ``trace_impl``, ``assembly_mode``,
  ``coef_windows``, ``window_chunk``, ``patch_chunk``, ``chunk_scan``,
  ``smallk_weig``, ``stencil_side_budget_mb`` and the TPU variants
  ``fused_block``, ``fused_nb``, ``fused_algo``, ``solver_gj2``,
  ``split_bs``, ``panel_nb``, ``panel_gj_bs``.  The solver argument
  ``eig_block`` moves the Jacobi stop within ``eig_tol`` / ``smallk_tol``.
- ``matmul_precision``: the port does not honour it (full float32
  products either way).
- Solves and output after the basis: ``fine_solver``, ``coarse_solver``,
  ``fine_preconditioner``, ``two_level_dense_cap``, ``coarse_solve``,
  ``coarse_dense_cap``, ``solve_fine_problem``, ``output_directory``,
  ``output_name``, ``write_output``, ``profile_dir``, ``error_norms``,
  ``mesh_axis``, ``n_devices``."""

from __future__ import annotations

import hashlib
import json
import uuid

import numpy as np
import torch

from dealii_slod_tpu_torch.utils.errors import host_array

# SLODConfig fields of the ``settings`` key, beside the problem, c(x) and
# the resolved spectral stage (see the module docstring)
SETTINGS_FIELDS = ("coef_corr_len", "coef_rand_offset", "smallk_dirs",
                   "smallk_power", "smallk_tol", "eig_tol", "eig_sweeps")


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


def _function_key(spec):
    """A function spec as JSON: strings and numbers as they are (lists of
    them too), anything else as a token that never matches."""
    if spec is None or isinstance(spec, (str, int, float)):
        return spec
    if isinstance(spec, (list, tuple)) and all(
            isinstance(s, (str, int, float)) for s in spec):
        return list(spec)
    return f"function {uuid.uuid4().hex}"


def _settings(solver) -> dict:
    """The solver's ``settings`` key, as JSON reads it back."""
    cfg = solver.cfg
    out = {name: getattr(cfg, name) for name in SETTINGS_FIELDS}
    out["problem"] = getattr(solver.problem, "name",
                             type(solver.problem).__name__)
    out["reaction"] = (_function_key(cfg.reaction)
                       if "creact" in solver.coef_names else None)
    out["spectral_stage"] = solver.spec_mode
    return json.loads(json.dumps(out, sort_keys=True))


def _as_bytes(text: str) -> np.ndarray:
    return np.frombuffer(text.encode(), dtype=np.uint8)


def save_basis(solver, path: str) -> str:
    """Save the basis canvases (and the stencil operator if assembled),
    with the fingerprint and the ``settings`` key."""
    data = {
        "fingerprint": _as_bytes(_config_fingerprint(solver.cfg, solver.C)),
        "settings": _as_bytes(json.dumps(_settings(solver), sort_keys=True)),
        "Phi": host_array(solver.Phi),
        "APhi": host_array(solver.APhi),
    }
    if hasattr(solver, "A_stencil"):
        data["A_stencil"] = host_array(solver.A_stencil)
    np.savez_compressed(path, **data)
    return path


def load_basis(solver, path: str) -> bool:
    """Load basis canvases into the solver, as tensors on its device in its
    dtype; returns False instead of loading stale data when the
    fingerprint differs, or when the file has a ``settings`` key that
    differs from the solver's.  A file without that key (the JAX
    package's) loads on the fingerprint alone."""
    with np.load(path) as z:
        fp = bytes(z["fingerprint"]).decode()
        if fp != _config_fingerprint(solver.cfg, solver.C):
            return False
        if ("settings" in z and json.loads(bytes(z["settings"]).decode())
                != _settings(solver)):
            return False

        def t(name):
            return torch.as_tensor(z[name], dtype=solver.dtype,
                                   device=solver.device)

        solver.Phi, solver.APhi = t("Phi"), t("APhi")
        if "A_stencil" in z:
            solver.A_stencil = t("A_stencil")
    return True
