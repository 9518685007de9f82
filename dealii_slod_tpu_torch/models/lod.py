"""The LOD / SLOD pipeline on a torch device (counterpart of
``dealii_slod_tpu/models/lod.py``): batched basis construction in chunks,
the stencil coarse operator, the coarse CG solve, the fine and coarse FEM
comparison solves, the error tables, VTU output and ``run()``.

The tables are tensors on the ``device`` given to the constructor, the
card unless the caller asks for the CPU.  The ported routes are 3D / 2D
scalar diffusion (C = 1) and linear elasticity (C = dim), plain LOD or
SLOD, with the fused patch solver, its 2x2 Schur split, the panel LDL^T
or the per-patch Cholesky solve (``patch_solver="auto"`` picks by the
reference's size rule), the smallk, Jacobi or ``eigh`` spectral stage
(``eig_solver="auto"``: smallk on the card in float32, ``eigh`` ("lapack")
elsewhere), the banded or the scatter assembly, the trace kernel or its
scan, the coarse CG or the direct coarse solve; ``kernel_mode="classes"``
builds the basis per patch shape class (``models/classes.py``), and on a
constant field the uniform route builds one patch per window signature.
The coefficient sets other than diffusion's and elasticity's and the
sharded step raise ``NotImplementedError`` naming their ROADMAP.md
entry."""

from __future__ import annotations

import contextlib
import functools
import os
import warnings

import numpy as np
import torch

from dealii_slod_tpu_torch.config import ParsedFunction, SLODConfig
from dealii_slod_tpu_torch.grid import (GridSpec, PatchTopology,
                                        ShapeClass, cartesian_coords,
                                        clipped_window_index,
                                        global_connectivity, ravel)
from dealii_slod_tpu_torch.models import basis, classes, stencil
from dealii_slod_tpu_torch.ops import element
from dealii_slod_tpu_torch.ops.assembly import (FineOperator,
                                                assemble_load_vector,
                                                make_subcell_matrices)
from dealii_slod_tpu_torch.ops.solvers import (cg, cholesky_solve,
                                               dense_dirichlet_solve)
from dealii_slod_tpu_torch.utils import errors
from dealii_slod_tpu_torch.utils.errors import ConvergenceTable, host_array
from dealii_slod_tpu_torch.utils.timers import StageTimer

# the ROADMAP.md Queue 1 entries that the refusals below name, by title
REACTION = "reaction-diffusion and the device sampler"
SCALING = "scaling axes"


@contextlib.contextmanager
def full_f32_matmuls():
    """cuBLAS and cuDNN float32 products in full float32 (TF32 off) inside
    the block, the caller's ``allow_tf32`` flags restored on the way out,
    also when the block raises.  A flag that is already off is left
    untouched."""
    flags = [f for f in (torch.backends.cuda.matmul, torch.backends.cudnn)
             if f.allow_tf32]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f in flags:
            f.allow_tf32 = True


def _full_f32(method):
    """Runs a ``LODSolver`` method on the card under ``full_f32_matmuls``
    (the reference scopes its matmul precision the same way, to the step
    and to the basis stage)."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        if self.device.type != "cuda":
            return method(self, *args, **kwargs)
        with full_f32_matmuls():
            return method(self, *args, **kwargs)
    return run


def _not_ported(what: str, title: str):
    raise NotImplementedError(f"{what} is not ported yet "
                              f"(ROADMAP.md Queue 1: {title})")


def spectral_mode(cfg: SLODConfig, device: torch.device) -> str:
    """The spectral stage ``eig_solver`` names on ``device``: "auto" is
    "smallk" on the card in float32 and "lapack" elsewhere (the JAX rule,
    ``models/basis.py: _uniform_core``, with the card as the
    accelerator)."""
    if cfg.eig_solver != "auto":
        return cfg.eig_solver
    return ("smallk" if device.type == "cuda" and cfg.dtype == "float32"
            else "lapack")


def patch_solver_mode(cfg: SLODConfig, C: int, sc: ShapeClass) -> str:
    """The patch solver ``patch_solver`` names: "auto" applies the
    reference's size rule (``models/basis.py: _fused_solver_mode``) on any
    device and dtype -- "fused" when the fused kernel's estimate fits
    12 MiB (3D l=2 diffusion sits exactly at it), else "fused_split" when
    a half split fits 13 MiB (3D l=2 elasticity), else "lax" (the
    per-patch Cholesky solve).  The rule only picks the structure the
    reference's accelerator path runs; the card has no such limits.  A
    named solver other than "fused", "fused_split" and "panel" is "lax",
    as in the reference ("panel": ``ops/patch_solve.py:
    panel_spd_multirhs``)."""
    mode = cfg.patch_solver
    if mode != "auto":
        return mode if mode in ("fused", "fused_split", "panel") else "lax"
    n = -(-sc.n_interior * C // 128) * 128
    k = -(-sc.n_coarse_dofs_local // 128) * 128
    bs = max(1, cfg.fused_block)
    rhs_bufs = 2 if bs >= 4 else 4
    if 4 * (bs * n * n + rhs_bufs * bs * n * k) <= 12 * 2 ** 20:
        return "fused"
    n1 = 128 * (-(-n // 256))
    k1 = -(-(n - n1 + sc.n_coarse_dofs_local) // 128) * 128
    return "fused_split" if 4 * (n1 * n1 + n1 * k1) <= 13 * 2 ** 20 \
        else "lax"


def check_supported(cfg: SLODConfig, problem, device: torch.device) -> None:
    """Refuse what the port does not implement; warn on the TPU variants
    of a kernel's contract (K9), which run on that contract's kernel."""
    C = problem.n_components
    if C not in (1, cfg.dim):
        raise NotImplementedError(f"C = {C} components in {cfg.dim}D: the "
                                  "reference's problems have C = 1 or dim")
    if cfg.dtype not in ("float32", "float64"):
        raise ValueError(f"dtype {cfg.dtype!r}")
    if (cfg.fused_algo != "ldl" or cfg.fused_block != 4 or cfg.solver_gj2
            or cfg.split_bs != 4 or cfg.fused_nb != 64
            or cfg.panel_gj_bs != 16):
        # TPU VMEM-placement / batching / tiling / issue-order variants of
        # K1's, K6's and K2's contracts (K9)
        warnings.warn(
            f"fused_algo={cfg.fused_algo!r}, fused_block={cfg.fused_block},"
            f" fused_nb={cfg.fused_nb}, solver_gj2={cfg.solver_gj2}, "
            f"split_bs={cfg.split_bs}, panel_gj_bs={cfg.panel_gj_bs} are "
            "TPU variants of the patch solve; the CUDA kernels K1 (its "
            "panel is 64), K6 and K2 serve them all", stacklevel=3)
    if cfg.solver_gj2 and cfg.patch_solver == "panel":
        warnings.warn("solver_gj2=True has no effect with patch_solver="
                      "'panel' (scalar GJ pivot inverses run)", stacklevel=3)
    if cfg.matmul_precision not in ("high", "highest"):
        # JAX's bf16 passes; the port's float32 GEMMs are full float32 and
        # K1 / K6 multiply in 3xTF32, which serves "high" and "highest"
        warnings.warn(
            f"matmul_precision={cfg.matmul_precision!r} is not honoured: "
            "the port runs full-float32 GEMMs (K1 / K6 in 3xTF32), as for "
            "'high' / 'highest'", stacklevel=3)
    if cfg.trace_impl not in ("slice", "c1"):
        # TPU rotate / unroll variants of the trace's contract (K9)
        warnings.warn(
            f"trace_impl={cfg.trace_impl!r} is a TPU variant of the stencil "
            "trace; the CUDA kernel K3 (C = 1) / K7 (C > 1) serves every "
            "impl value", stacklevel=3)


class LODSolver:
    """The SLOD pipeline (diffusion or elasticity) on one torch device, the
    card unless ``device="cpu"`` is asked for.

    ``eig_block``: matrices that share the adaptive Jacobi stop in the
    plain versions of K5 and K8 (CPU tensors).  None does what the TPU
    kernels did: blocks of 16 on the Jacobi route, ``min(B, 1024)`` for
    smallk's W stage and the whole chunk for K8; 1 is what the CUDA
    kernels do (each matrix stops on its own)."""

    def __init__(self, cfg: SLODConfig, problem, device="cuda", verbose=True,
                 eig_block: int | None = None):
        self.device = torch.device(device)
        check_supported(cfg, problem, self.device)
        self.spec_mode = spectral_mode(cfg, self.device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device='cuda' asked for, but torch "
                                   "sees no CUDA device")
        self.cfg = cfg
        self.problem = problem
        self.verbose = verbose
        self.eig_block = eig_block
        self.log = print if verbose else (lambda *a: None)
        self.timer = StageTimer(self.device)
        self.C = C = problem.n_components
        self.grid = GridSpec(cfg.dim, cfg.n_coarse, cfg.n_subdivisions, C)
        self.dtype = (torch.float64 if cfg.dtype == "float64"
                      else torch.float32)
        dev, dt = self.device, self.dtype

        with self.timer.section("1: create patches"):
            self.topo = PatchTopology(self.grid, cfg.oversampling)
        self.et = element.ElementTensors(cfg.dim, self.grid.h, C)
        self.qpts = element.quad_points_global(self.grid)
        self.coef_q = {k: torch.as_tensor(v, dtype=dt, device=dev)
                       for k, v in problem.coefficients(self.qpts).items()}
        self.coef_names = sorted(self.coef_q)
        if self.coef_names != (["alpha"] if C == 1 else ["lam", "mu"]):
            _not_ported(f"coefficients {self.coef_names}", REACTION)
        self.conn = torch.as_tensor(global_connectivity(self.grid),
                                    device=dev)

        # canvas geometry: every basis function lives on a fixed
        # (2l+1)s+1 per-axis node grid anchored at (center - l)*s
        ell, s = cfg.oversampling, cfg.n_subdivisions
        self.canvas_dims = np.full(cfg.dim, (2 * ell + 1) * s + 1,
                                   dtype=np.int64)
        self.canvas_n = int(self.canvas_dims.prod())
        centers = cartesian_coords(self.grid.cell_dims)
        self.anchor_nodes = (centers - ell) * s
        self.canvas_off = (ell - (centers - self.topo.patch_lo)) * s
        gidx, _ = clipped_window_index(self.anchor_nodes, self.canvas_dims,
                                       self.grid.node_dims)
        self.canvas_gidx = torch.as_tensor(gidx, dtype=torch.int64,
                                           device=dev)

        # stencil neighbours: windows of q and p overlap iff
        # |center_p - center_q|_inf <= 2l
        R = min(2 * ell, cfg.n_coarse - 1)
        self.stencil_R = R
        self.stencil_offsets = cartesian_coords(np.full(cfg.dim,
                                                        2 * R + 1)) - R
        self.n_stencil = len(self.stencil_offsets)
        nb, valid = clipped_window_index(centers - R,
                                         np.full(cfg.dim, 2 * R + 1),
                                         self.grid.cell_dims)
        self.stencil_nbr_np = np.where(valid, nb, 0).astype(np.int64)
        self.stencil_valid_np = valid
        self.center_offset_idx = int(np.nonzero(
            (self.stencil_offsets == 0).all(axis=1))[0][0])

        self.canvas_class = ShapeClass((2 * ell + 1,) * cfg.dim, self.grid)
        self.solver_mode = patch_solver_mode(cfg, C, self.canvas_class)
        self.canvas_center_cell = int(ravel(np.full(cfg.dim, ell),
                                            np.full(cfg.dim, 2 * ell + 1)))
        self._tables = None
        self._inputs = None
        self._dedup = None
        self._class_tables = {}
        self._stencil_tables = None
        self._placement = None

    def parse(self, spec):
        return ParsedFunction(spec, self.C, self.cfg.dim)

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=self.device,
                               dtype=dtype or self.dtype)

    # ------------------------------------------------------------------
    # Right-hand side
    # ------------------------------------------------------------------

    @_full_f32
    def assemble_fine_rhs(self):
        """Eliminated fine FEM right-hand side (reference LOD.cc:1050-
        1063): load vector minus the lifting of the Dirichlet data (the
        global nodal interpolant of g), zero at constrained rows."""
        cfg = self.cfg
        f_q = self._t(self.parse(cfg.rhs)(self.qpts))
        load = assemble_load_vector(self.et, self.conn, f_q,
                                    self.grid.n_nodes)
        bnd = self._t(self.grid.boundary_node_mask(), torch.bool)
        g = self._t(self.parse(cfg.bc)(self.grid.node_coords()))
        op_raw = FineOperator(self.et, self.conn, self.coef_q)
        rhs = torch.where(bnd[:, None], 0.0, load - op_raw._apply_raw(g))
        self.fine_bnd = bnd
        self.fine_bc_values = g
        self.fem_rhs = rhs
        return rhs

    # ------------------------------------------------------------------
    # Basis, coarse operator, coarse solve
    # ------------------------------------------------------------------

    def _uniform_tables(self):
        if self._tables is None:
            self._tables = basis.uniform_tables(
                self.cfg, self.grid, self.et, self.canvas_class,
                self.canvas_center_cell, self.device, self.dtype,
                self.eig_block, self.spec_mode, self.solver_mode,
                self.coef_names)
        return self._tables

    def _use_coef_windows(self) -> bool:
        """Plain geometric windows, except under the reference's constant-
        coefficient stiffness-cache semantics (LOD.cc:354-361)."""
        return self.cfg.coef_windows and not self.cfg.constant_coefficients

    def _stiffness_cache_ok(self) -> bool:
        if not self.cfg.constant_coefficients:
            return False
        if self.cfg.reference_parity:
            return True
        return self.problem.is_constant()

    def _uniform_inputs(self):
        """Per-patch inputs (numpy): canvas-subcell gather indices (with
        the full-size-patch cache semantics), window node bounds in canvas
        coordinates, domain-side flags."""
        g, topo, cfg = self.grid, self.topo, self.cfg
        coords = (self.canvas_class.sub_coords[None, :, :]
                  + self.anchor_nodes[:, None, :])
        coords = np.clip(coords, 0, g.fine_cells_per_axis - 1)
        gsub = ravel(coords, g.fine_cell_dims).astype(np.int64)
        if self._stiffness_cache_ok():
            full = (topo.patch_shape == 2 * cfg.oversampling + 1).all(axis=1)
            if full.any():
                gsub[full] = gsub[int(np.nonzero(full)[0][0])]
        nlo = self.canvas_off
        nhi = self.canvas_off + topo.patch_shape * cfg.n_subdivisions
        return gsub, nlo, nhi, topo.side_is_domain

    def _uniform_inputs_t(self):
        """``_uniform_inputs`` as device tensors (built once; the gather
        indices only where the coefficient windows do not apply)."""
        if self._inputs is None:
            gsub, nlo, nhi, sides = self._uniform_inputs()
            self._inputs = (
                None if self._use_coef_windows()
                else self._t(gsub, torch.int64),
                self._t(nlo, torch.int64), self._t(nhi, torch.int64),
                self._t(sides, torch.bool))
        return self._inputs

    def _patch_dedup(self, nlo, nhi, sides):
        """On a constant coefficient field the basis depends only on the
        window geometry and the domain-side flags: the unique (nlo, nhi,
        sides) rows (``np.unique``, as the reference's ``_patch_dedup``)
        -> (representative patch of each, inverse index (P,)), or None
        when the field is not constant."""
        if not self.problem.is_constant():
            return None
        key = np.concatenate([nlo, nhi, sides.astype(nlo.dtype)], axis=1)
        _, rep, inv = np.unique(key, axis=0, return_index=True,
                                return_inverse=True)
        return rep, inv.reshape(-1)

    def _dedup_inputs_t(self):
        """The uniform inputs of the unique window signatures as device
        tensors, with the inverse index; None without dedup (built once)."""
        if self._dedup is None:
            gsub, nlo, nhi, sides = self._uniform_inputs()
            dedup = self._patch_dedup(nlo, nhi, sides)
            self._dedup = False
            if dedup is not None:
                rep, inv = dedup
                self._dedup = (self._t(gsub[rep], torch.int64),
                               self._t(nlo[rep], torch.int64),
                               self._t(nhi[rep], torch.int64),
                               self._t(sides[rep], torch.bool),
                               self._t(inv, torch.int64))
        return self._dedup or None

    @_full_f32
    def compute_basis(self, coefs=None):
        """Basis canvases ``self.Phi`` / ``self.APhi`` (P, canvas_n, C, C),
        chunk by chunk (``cfg.patch_chunk`` patches; 0 = all at once).

        Without ``coefs`` (the solver's own field) a constant field builds
        only the unique window signatures and gathers them back with one
        index (the coefficient windows are off then, as in the
        reference); fields passed in (``build_step``) are never deduped.
        ``self.basis_patches`` is the number of patches built."""
        if self.cfg.kernel_mode != "uniform":
            Phi, APhi = classes.compute_basis(
                self, self.coef_q if coefs is None else coefs)
            self.Phi, self.APhi = Phi, APhi
            self.basis_patches = self.topo.n_patches
            return Phi, APhi
        dedup = self._dedup_inputs_t() if coefs is None else None
        coefs = self.coef_q if coefs is None else coefs
        tab = self._uniform_tables()
        if dedup is None:
            gsub, nlo_t, nhi_t, sides_t = self._uniform_inputs_t()
        else:
            gsub, nlo_t, nhi_t, sides_t, inv = dedup
        cw = {k: (basis.coef_windows(self.cfg, self.grid, coefs[k])
                  if gsub is None else coefs[k][gsub])
              for k in self.coef_names}
        B, C = len(nlo_t), self.C
        Phi = torch.empty((B, self.canvas_n, C, C), dtype=self.dtype,
                          device=self.device)
        APhi = torch.empty_like(Phi)
        step = self.cfg.patch_chunk or B
        for lo in range(0, B, step):
            hi = min(B, lo + step)
            Phi[lo:hi], APhi[lo:hi] = basis.uniform_chunk(
                tab, {k: v[lo:hi] for k, v in cw.items()}, nlo_t[lo:hi],
                nhi_t[lo:hi], sides_t[lo:hi])
        if dedup is not None:
            Phi, APhi = Phi[inv], APhi[inv]
        self.Phi, self.APhi = Phi, APhi
        self.basis_patches = B
        return Phi, APhi

    def _stencil_build(self, Phi, APhi):
        if self._stencil_tables is None:
            self._stencil_tables = stencil.stencil_tables(
                self.cfg, self.grid, self.canvas_dims, self.stencil_offsets,
                self.device, self.dtype)
        return stencil.stencil_build_cells(Phi, APhi, self._stencil_tables)

    @_full_f32
    def assemble_coarse_operator(self):
        """A_LOD as a stencil (P, S, C, C) from ``self.Phi`` / ``APhi``."""
        self.A_stencil = self._stencil_build(self.Phi, self.APhi)
        return self.A_stencil

    @_full_f32
    def coarse_dense_matrix(self, A_st):
        if self._placement is None:
            self._placement = stencil.dense_placement(
                self.stencil_nbr_np, self.stencil_valid_np, self.device)
        return stencil.coarse_dense_matrix(A_st, self._placement)

    def _coarse_matvec_fn(self, A_st):
        """Dense matvec below ``coarse_dense_cap`` (the matrix is built
        once, outside the CG loop), stencil matvec beyond."""
        if self.topo.n_patches * self.C <= self.cfg.coarse_dense_cap:
            Ad = self.coarse_dense_matrix(A_st)
            return lambda u: (Ad @ u.reshape(-1)).reshape(u.shape)
        nbr = self._t(self.stencil_nbr_np, torch.int64)
        valid = self._t(self.stencil_valid_np, torch.bool)
        return lambda u: stencil.coarse_matvec_with(A_st, u, nbr, valid)

    def _coarse_cg(self, A_st, rhs_c):
        # block-diagonal Jacobi: the C x C centre block's diagonal
        diag = torch.einsum("pdd->pd", A_st[:, self.center_offset_idx])
        rc = self.cfg.coarse_solver
        return cg(self._coarse_matvec_fn(A_st), rhs_c,
                  max_steps=rc.max_steps, tolerance=rc.tolerance,
                  reduce=rc.reduce, precond=lambda r: r / diag)

    def _use_direct_coarse(self) -> bool:
        """``coarse_solve="direct"`` applies up to ``coarse_dense_cap``
        coarse dofs; CG, the reference's own solver, beyond."""
        return (self.cfg.coarse_solve == "direct"
                and self.topo.n_patches * self.C <= self.cfg.coarse_dense_cap)

    @_full_f32
    def _coarse_direct_fn(self, A_st):
        """rhs (P, C) -> A_LOD^-1 rhs by one dense Cholesky factor of the
        coarse matrix, made here once, and two triangular solves a call."""
        L = torch.linalg.cholesky(self.coarse_dense_matrix(A_st))

        def solve(rhs):
            return cholesky_solve(L, rhs.reshape(-1, 1)).reshape(rhs.shape)

        return solve

    def _solve_coarse_system(self, A_st, rhs_c):
        """The coarse solution and the CG result (None on the direct
        route)."""
        if self._use_direct_coarse():
            return self._coarse_direct_fn(A_st)(rhs_c), None
        res = self._coarse_cg(A_st, rhs_c)
        return res.x, res

    def _coarse_rhs(self, Phi, fem_rhs):
        """C^T f: the rhs's canvas windows (zero outside the domain), or
        on the classes route the clipped gather ``fem_rhs[canvas_gidx]``
        as the reference's; the canvases vanish where the two differ."""
        if self.cfg.kernel_mode == "uniform":
            f_at = basis.rhs_windows(self.cfg, self.grid, fem_rhs)
        else:
            f_at = fem_rhs[self.canvas_gidx]
        return torch.einsum("pncd,pnc->pd", Phi, f_at)

    @_full_f32
    def solve_coarse(self):
        """Coarse LOD solve (reference LOD.cc:976-1002): rhs = C^T f, then
        CG with Jacobi on the coarse operator, or the direct solve
        (``coarse_solve="direct"`` below the cap; ``coarse_cg`` None)."""
        rhs_c = self._coarse_rhs(self.Phi, self.fem_rhs)
        self.coarse_rhs = rhs_c
        self.log(f"     rhs l2 norm = {float(torch.linalg.norm(rhs_c)):.6g}")
        x, self.coarse_cg = self._solve_coarse_system(self.A_stencil, rhs_c)
        self.coarse_solution = x
        self.log(f"   size of u {x.numel()}")
        return x

    @_full_f32
    def prolong_lod_solution(self):
        """lod_solution = C u + g: the u-weighted basis canvases scattered
        onto the fine grid (reference LOD.cc:1251) plus the Dirichlet
        lifting that ``assemble_fine_rhs`` eliminated."""
        vals = torch.einsum("pncd,pd->pnc", self.Phi, self.coarse_solution)
        out = torch.zeros((self.grid.n_nodes, self.C), dtype=self.dtype,
                          device=self.device)
        out.index_add_(0, self.canvas_gidx.reshape(-1),
                       vals.reshape(-1, self.C))
        if hasattr(self, "fine_bc_values"):
            out = out + self.fine_bc_values
        self.lod_solution = out
        return out

    # ------------------------------------------------------------------
    # Fine FEM comparison solve (reference LOD.cc:1004-1094)
    # ------------------------------------------------------------------

    def _two_level_precond(self, diag):
        """Additive two-level preconditioner for the fine solve,
        M^-1 r = r / diag + C A_LOD^-1 C^T r, with the LOD space as the
        coarse correction: the coarse matrix densified on the device from
        the stencil and factored once by Cholesky."""
        P, C = self.topo.n_patches, self.C
        L = torch.linalg.cholesky(self.coarse_dense_matrix(self.A_stencil))

        def coarse_solve(rc):
            return cholesky_solve(L, rc.reshape(-1, 1))[:, 0].reshape(P, C)

        return self._two_level_from(coarse_solve, diag)

    def _two_level_precond_stencil(self, diag):
        """The cap-free variant of ``_two_level_precond``: the coarse
        correction is a degree-16 Chebyshev polynomial of the stencil
        operator on [lmax / 30, lmax], lmax by Gershgorin row sums (linear
        and SPD, a valid PCG preconditioner)."""
        A_st = self.A_stencil
        lmax = float(A_st.abs().sum(dim=(1, 3)).max())
        lmin = lmax / 30.0
        theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
        nbr = self._t(self.stencil_nbr_np, torch.int64)
        valid = self._t(self.stencil_valid_np, torch.bool)

        degree = 16

        def coarse_solve(rc):
            # Chebyshev iteration for A y = rc on [lmin, lmax]
            y = rc / theta
            d = y
            sigma = theta / delta
            rho = 1.0 / sigma
            for _ in range(degree - 1):
                rho_new = 1.0 / (2.0 * sigma - rho)
                r = rc - stencil.coarse_matvec_with(A_st, y, nbr, valid)
                d = rho_new * (2.0 / delta * r + rho * d)
                y = y + d
                rho = rho_new
            return y

        return self._two_level_from(coarse_solve, diag)

    def _two_level_from(self, coarse_solve, diag):
        gidx = self.canvas_gidx.reshape(-1)

        def precond(r):
            rc = torch.einsum("pncd,pnc->pd", self.Phi,
                              r[self.canvas_gidx])                # C^T r
            vals = torch.einsum("pncd,pd->pnc", self.Phi, coarse_solve(rc))
            coarse = torch.zeros_like(r)
            coarse.index_add_(0, gidx, vals.reshape(-1, self.C))  # C y
            coarse = torch.where(self.fine_bnd[:, None], 0.0, coarse)
            return r / diag + coarse

        return precond

    @_full_f32
    def solve_fine_fem(self):
        """Fine-scale FEM solve: CG with Jacobi, or with the LOD-space
        two-level preconditioner (``fine_preconditioner="two_level"``:
        direct coarse factor up to ``two_level_dense_cap`` coarse dofs,
        the stencil Chebyshev correction beyond)."""
        cfg = self.cfg
        op = FineOperator(self.et, self.conn, self.coef_q,
                          dirichlet_mask=self.fine_bnd)
        d = op.diagonal()
        if (cfg.fine_preconditioner == "two_level"
                and hasattr(self, "A_stencil")):
            if self.topo.n_patches * self.C <= cfg.two_level_dense_cap:
                precond = self._two_level_precond(d)
            else:
                precond = self._two_level_precond_stencil(d)
        else:
            precond = lambda r: r / d                            # noqa: E731
        rc = cfg.fine_solver
        res = cg(op, self.fem_rhs, max_steps=rc.max_steps,
                 tolerance=rc.tolerance, reduce=rc.reduce, precond=precond)
        # res.x is the eliminated correction (zero at Dirichlet rows)
        u = res.x + self.fine_bc_values
        self.fem_solution = u
        self.fine_cg = res
        if not bool(res.converged):
            self.log(f"WARNING: fine CG did not converge in {rc.max_steps} "
                     f"iterations (residual {float(res.residual):.3e})")
        return u

    # ------------------------------------------------------------------
    # Coarse FEM comparison (reference LOD.cc:1103-1237)
    # ------------------------------------------------------------------

    @_full_f32
    def solve_coarse_fem(self):
        """Q1 FEM on the coarse grid: a dense direct solve up to 6000 dofs,
        CG with Jacobi on the constrained operator beyond; interpolated to
        the fine nodes."""
        cfg, C, dt = self.cfg, self.C, self.dtype
        N = cfg.n_coarse
        gH = GridSpec(cfg.dim, N, 1, C)
        etH = element.ElementTensors(cfg.dim, gH.h, C)
        connH = global_connectivity(gH)
        connH_t = self._t(connH, torch.int64)
        qptsH = element.quad_points_global(gH)
        coefsH = {k: self._t(v)
                  for k, v in self.problem.coefficients(qptsH).items()}
        f_qH = self._t(self.parse(cfg.rhs)(qptsH))
        rhsH = assemble_load_vector(etH, connH_t, f_qH, gH.n_nodes)
        bndH = self._t(gH.boundary_node_mask(), torch.bool)
        gvals = self._t(self.parse(cfg.bc)(gH.node_coords()))

        n_dofs = gH.n_fine_dofs
        if n_dofs <= 6000:
            # dense direct solve (reference SolverDirect, LOD.cc:1191-1195)
            m = 2 ** cfg.dim
            conn_dof = (connH[:, :, None] * C + np.arange(C)[None, None, :]
                        ).reshape(len(connH), m * C).astype(np.int64)
            flat = conn_dof[:, :, None] * n_dofs + conn_dof[:, None, :]
            Ksub = make_subcell_matrices(etH, coefsH)
            A = Ksub.new_zeros(n_dofs * n_dofs)
            A.index_add_(0, self._t(flat.reshape(-1), torch.int64),
                         Ksub.reshape(-1))
            uH = dense_dirichlet_solve(
                A.reshape(n_dofs, n_dofs), rhsH.reshape(-1),
                bndH.repeat_interleave(C), gvals.reshape(-1)).reshape(-1, C)
        else:
            opH = FineOperator(etH, connH_t, coefsH, dirichlet_mask=bndH)
            g_ext = torch.where(bndH[:, None], gvals, 0.0)
            rhsE = torch.where(bndH[:, None], 0.0,
                               rhsH - opH._apply_raw(g_ext))
            dH = opH.diagonal()
            res = cg(opH, rhsE, max_steps=2000, tolerance=1e-12,
                     reduce=1e-14, precond=lambda r: r / dH)
            uH = torch.where(bndH[:, None], g_ext, res.x)

        # Q1 prolongation coarse nodes -> fine nodes (FETools::interpolate,
        # LOD.cc:1201-1204)
        s = cfg.n_subdivisions
        f_coords = cartesian_coords(self.grid.node_dims)
        cell = np.minimum(f_coords // s, N - 1)
        tloc = (f_coords - cell * s) / s                      # (n_nodes, dim)
        bits = cartesian_coords(np.full(cfg.dim, 2))          # (m, dim)
        idxH = ravel(cell[:, None, :] + bits[None, :, :], gH.node_dims)
        wts = np.prod(np.where(bits[None, :, :] == 1, tloc[:, None, :],
                               1.0 - tloc[:, None, :]), axis=-1)
        uH_fine = torch.einsum("nm,nmc->nc", self._t(wts, dt),
                               uH[self._t(idxH, torch.int64)])
        self.coarse_fem_solution = uH
        self.coarse_fem_on_fine = uH_fine
        return uH, uH_fine

    # ------------------------------------------------------------------
    # Output (reference output_coarse_results LOD.cc:248-293, fine VTU
    # LOD.cc:1262-1377, coefficients VTU Diffusion.h:70-108, parameter dump
    # LOD.cc:60-62)
    # ------------------------------------------------------------------

    def write_outputs(self):
        from dealii_slod_tpu_torch.utils.io import (write_coarse_grid_vtu,
                                                    write_fine_grid_vtu,
                                                    write_subcell_field_vtu)
        cfg = self.cfg
        out, name = cfg.output_directory, cfg.output_name
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"used_parameters_{cfg.dim}.prm"),
                  "w") as f:
            f.write(cfg.to_prm())

        # coefficient fields at fine-subcell resolution
        centers = (cartesian_coords(self.grid.fine_cell_dims) + 0.5) \
            * self.grid.h
        coef_cells = {k: np.asarray(f) for k, f in
                      self.problem.coefficients(centers).items()}
        write_subcell_field_vtu(os.path.join(out, f"{name}_coefficients.vtu"),
                                self.grid, coef_cells)

        # fine fields
        node_xy = self.grid.node_coords()
        pd = {}
        if hasattr(self, "fem_solution"):
            pd["fem_reference"] = host_array(self.fem_solution)
        pd["exact_solution"] = self.parse(cfg.exact_solution)(node_xy)
        pd["exact_rhs"] = self.parse(cfg.rhs)(node_xy)
        if hasattr(self, "lod_solution"):
            pd["lod_solution"] = host_array(self.lod_solution)
        if hasattr(self, "coarse_fem_on_fine"):
            pd["fem_coarse_solution"] = host_array(self.coarse_fem_on_fine)
        write_fine_grid_vtu(os.path.join(out, f"{name}_fine.vtu"),
                            self.grid, pd)

        # coarse (per-cell DGQ0) fields
        if hasattr(self, "coarse_solution"):
            cell_centers = (cartesian_coords(self.grid.cell_dims) + 0.5) \
                * self.grid.H
            cd = {"LOD_solution": host_array(self.coarse_solution),
                  "exact_solution":
                      self.parse(cfg.exact_solution)(cell_centers)}
            write_coarse_grid_vtu(os.path.join(out, f"{name}_coarse.vtu"),
                                  self.grid, cd)

    # ------------------------------------------------------------------
    # Full pipeline (reference LOD::run, LOD.cc:1423-1467)
    # ------------------------------------------------------------------

    def run(self) -> dict:
        """The whole pipeline; with ``cfg.profile_dir`` under
        ``torch.profiler``, its chrome trace written there as
        ``trace.json``."""
        if not self.cfg.profile_dir:
            return self._run()
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            out = self._run()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.cfg.profile_dir,
                                              "trace.json"))
        return out

    def _run(self) -> dict:
        cfg, g = self.cfg, self.grid
        self.log(f"Running LOD {self.problem.name} problem in {cfg.dim}D")
        sizes = self.topo.patch_sizes()
        self.log(f"Number of coarse cell = {g.n_cells}, "
                 f"number of patches = {self.topo.n_patches} "
                 f"(locally owned: {self.topo.n_patches}) ")
        self.log(f"Patches size in ({sizes.min()}, {sizes.max()})")

        with self.timer.section("2: compute basis functions"):
            self.compute_basis()
        with self.timer.section("3: assemble global matrix"):
            self.assemble_coarse_operator()
        with self.timer.section("4: assemble fine FEM"):
            self.assemble_fine_rhs()
        self.log(f"     fem rhs l2 norm = "
                 f"{float(torch.linalg.norm(self.fem_rhs)):.6g}")

        results: dict = {}
        exact = self.parse(cfg.exact_solution)

        def table(label, dofs, u, **kw):
            # the configured norms (LOD.h:150-156)
            d = errors.error_norms(g, self.et, self.conn, u, **kw)
            t = ConvergenceTable(label, dim=cfg.dim)
            t.add_row(g.n_cells, dofs,
                      {k: d[k] for k in cfg.error_norms if k in d})
            return t

        if cfg.solve_fine_problem:
            with self.timer.section("4: solve fine FEM"):
                self.solve_fine_fem()
            self.log(f"   size of fem u {self.fem_solution.numel()}")
            if cfg.constant_coefficients:
                results["error_FEMh_exact"] = table(
                    "errFEMh", g.n_fine_dofs, self.fem_solution,
                    exact=exact, qpts=self.qpts)

        with self.timer.section("4: solve coarse LOD"):
            self.solve_coarse()
        with self.timer.section("5: prolong + compare"):
            self.prolong_lod_solution()

        if cfg.constant_coefficients:
            results["error_LOD_exact"] = table(
                "errLOD", g.n_coarse_dofs, self.lod_solution, exact=exact,
                qpts=self.qpts)
        if cfg.solve_fine_problem:
            results["error_LOD_FEMh"] = table(
                "errLOD", g.n_coarse_dofs, self.lod_solution,
                other=self.fem_solution)

        # coarse Q1 FEM comparison: the reference runs it for spacedim == 2
        # only (LOD.cc:1103)
        if self.C == 2 or (self.C == cfg.dim and cfg.dim > 1):
            with self.timer.section("4: coarse FEM comparison"):
                self.solve_coarse_fem()
            if cfg.solve_fine_problem:
                results["error_FEMH_FEMh"] = table(
                    "errFEM", g.n_coarse_dofs, self.coarse_fem_on_fine,
                    other=self.fem_solution)
            if cfg.constant_coefficients:
                results["error_FEMH_exact"] = table(
                    "errFEM", g.n_coarse_dofs, self.coarse_fem_on_fine,
                    exact=exact, qpts=self.qpts)

        for key, label in [("error_LOD_exact", "SLOD vs exact solution"),
                           ("error_FEMH_exact", "FEM(H) vs exact solution"),
                           ("error_FEMh_exact", "FEMh vs exact solution"),
                           ("error_FEMH_FEMh", "FEM(H) vs reference FEM(h)"),
                           ("error_LOD_FEMh", "SLOD vs reference FEM(h)")]:
            if key in results:
                self.log(label)
                self.log(str(results[key]))

        if cfg.write_output:
            with self.timer.section("6: fine output"):
                self.write_outputs()

        if self.verbose:
            self.log(self.timer.summary())
        results["coarse_solution"] = self.coarse_solution
        results["lod_solution"] = self.lod_solution
        if cfg.solve_fine_problem:
            results["fem_solution"] = self.fem_solution
        return results

    # ------------------------------------------------------------------
    # The pipeline step
    # ------------------------------------------------------------------

    def build_step(self, mesh=None):
        """Return the end-to-end step

            step(coefs: {name: (n_fine_cells, nq)}, fem_rhs: (n_nodes, C))
                -> (coarse solution (P, C), A_stencil (P, S, C, C))

        covering basis construction -> coarse-operator assembly -> CG (or
        the direct coarse solve).  The step also leaves ``Phi``, ``APhi``,
        ``A_stencil``, ``coarse_solution`` and ``coarse_cg`` on the solver,
        so that ``prolong_lod_solution`` can follow it.  On the card the step, as
        every public stage, runs under ``full_f32_matmuls``."""
        if mesh is not None:
            _not_ported("build_step(mesh=...) (patch-axis sharding)",
                        SCALING)
        return self._step

    @_full_f32
    def _step(self, coefs, fem_rhs):
        Phi, _ = self.compute_basis(coefs)
        A_st = self.assemble_coarse_operator()
        x, res = self._solve_coarse_system(A_st,
                                           self._coarse_rhs(Phi, fem_rhs))
        self.coarse_solution, self.coarse_cg = x, res
        return x, A_st
