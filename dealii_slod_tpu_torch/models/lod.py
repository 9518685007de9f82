"""The SLOD pipeline step on a torch device (counterpart of
``dealii_slod_tpu/models/lod.py``): batched basis construction in chunks,
the stencil coarse operator, and the coarse CG solve.

The tables are tensors on the ``device`` given to the constructor; there is
no default device.  Only the route of the 3D/2D scalar diffusion SLOD step
with the fused patch solver and the Jacobi spectral stage is ported; every
other knob value raises ``NotImplementedError`` naming its ROADMAP.md
entry."""

from __future__ import annotations

import warnings

import numpy as np
import torch

from dealii_slod_tpu.config import ParsedFunction, SLODConfig
from dealii_slod_tpu.grid import (GridSpec, PatchTopology, ShapeClass,
                                  cartesian_coords, clipped_window_index,
                                  global_connectivity, ravel)
from dealii_slod_tpu_torch.models import basis, stencil
from dealii_slod_tpu_torch.ops.assembly import (FineOperator,
                                                assemble_load_vector)
from dealii_slod_tpu_torch.ops.solvers import cg
from dealii_slod_tpu_torch.utils.reference import element
from dealii_slod_tpu_torch.utils.timers import StageTimer


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet "
                              f"(ROADMAP.md Queue 1 item {item})")


def check_supported(cfg: SLODConfig, problem) -> None:
    """Refuse every knob value the port does not implement."""
    if problem.n_components != 1:
        _not_ported("C > 1 (elasticity)", "9")
    if cfg.kernel_mode != "uniform":
        _not_ported(f"kernel_mode={cfg.kernel_mode!r}", "10")
    if not (cfg.lod_stabilization and cfg.oversampling > 0):
        _not_ported("LOD without SLOD stabilization", "10")
    if cfg.eig_solver != "jacobi":
        _not_ported(f"eig_solver={cfg.eig_solver!r} (only 'jacobi')",
                    "6" if cfg.eig_solver in ("auto", "smallk") else "10")
    if cfg.patch_solver not in ("auto", "fused"):
        _not_ported(f"patch_solver={cfg.patch_solver!r}",
                    "9" if cfg.patch_solver == "fused_split" else "10")
    if cfg.fused_nb != 64:
        _not_ported(f"fused_nb={cfg.fused_nb} (the kernel's panel is 64)",
                    "10")
    if cfg.trace_kernel == "off":
        _not_ported("trace_kernel='off' (the per-patch scan route)", "10")
    if cfg.assembly_mode != "banded":
        _not_ported(f"assembly_mode={cfg.assembly_mode!r}", "10")
    if cfg.coarse_solve != "cg":
        _not_ported(f"coarse_solve={cfg.coarse_solve!r}", "7")
    if cfg.dtype not in ("float32", "float64"):
        raise ValueError(f"dtype {cfg.dtype!r}")
    if (cfg.fused_algo != "ldl" or cfg.fused_block != 4 or cfg.solver_gj2):
        # TPU VMEM-placement / issue-order variants of K1's contract (K9)
        warnings.warn(
            f"fused_algo={cfg.fused_algo!r}, fused_block={cfg.fused_block},"
            f" solver_gj2={cfg.solver_gj2} are TPU variants of the fused "
            "patch solve; the one CUDA kernel K1 serves them all",
            stacklevel=3)


class LODSolver:
    """The SLOD diffusion pipeline on one torch device.

    ``eig_block``: matrices that share the adaptive Jacobi stop in the
    plain version of K5 (CPU tensors); 16 is the TPU kernel's block, 1
    what the CUDA kernel does (each matrix stops on its own)."""

    def __init__(self, cfg: SLODConfig, problem, device, verbose=True,
                 eig_block: int = 16):
        check_supported(cfg, problem)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device='cuda' asked for, but torch "
                                   "sees no CUDA device")
            # JAX's f32 path ran bf16x3 matmuls; the port runs full f32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
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
        if self.coef_names != ["alpha"]:
            _not_ported(f"coefficients {self.coef_names}", "12")
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
        self.canvas_center_cell = int(ravel(np.full(cfg.dim, ell),
                                            np.full(cfg.dim, 2 * ell + 1)))
        self._tables = None
        self._inputs = None
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
                self.eig_block)
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

    def compute_basis(self, coefs=None):
        """Basis canvases ``self.Phi`` / ``self.APhi`` (P, canvas_n, 1, 1),
        chunk by chunk (``cfg.patch_chunk`` patches; 0 = all at once)."""
        coef = (self.coef_q if coefs is None else coefs)["alpha"]
        tab = self._uniform_tables()
        gsub, nlo_t, nhi_t, sides_t = self._uniform_inputs_t()
        cw = (basis.coef_windows(self.cfg, self.grid, coef) if gsub is None
              else coef[gsub])
        P = self.topo.n_patches
        Phi = torch.empty((P, self.canvas_n, 1, 1), dtype=self.dtype,
                          device=self.device)
        APhi = torch.empty_like(Phi)
        step = self.cfg.patch_chunk or P
        for lo in range(0, P, step):
            hi = min(P, lo + step)
            Phi[lo:hi], APhi[lo:hi] = basis.uniform_chunk(
                tab, cw[lo:hi], nlo_t[lo:hi], nhi_t[lo:hi], sides_t[lo:hi])
        self.Phi, self.APhi = Phi, APhi
        return Phi, APhi

    def _stencil_build(self, Phi, APhi):
        if self._stencil_tables is None:
            self._stencil_tables = stencil.stencil_tables(
                self.cfg, self.grid, self.canvas_dims, self.stencil_offsets,
                self.device, self.dtype)
        return stencil.stencil_build_cells(Phi, APhi, self._stencil_tables)

    def assemble_coarse_operator(self):
        """A_LOD as a stencil (P, S, 1, 1) from ``self.Phi`` / ``APhi``."""
        self.A_stencil = self._stencil_build(self.Phi, self.APhi)
        return self.A_stencil

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
        diag = A_st[:, self.center_offset_idx, 0, 0][:, None]
        rc = self.cfg.coarse_solver
        return cg(self._coarse_matvec_fn(A_st), rhs_c,
                  max_steps=rc.max_steps, tolerance=rc.tolerance,
                  reduce=rc.reduce, precond=lambda r: r / diag)

    def _coarse_rhs(self, Phi, fem_rhs):
        f_at = basis.rhs_windows(self.cfg, self.grid, fem_rhs)
        return torch.einsum("pncd,pnc->pd", Phi, f_at)

    def solve_coarse(self):
        """Coarse LOD solve (reference LOD.cc:976-1002): rhs = C^T f, then
        CG with Jacobi on the coarse operator."""
        rhs_c = self._coarse_rhs(self.Phi, self.fem_rhs)
        self.coarse_rhs = rhs_c
        self.log(f"     rhs l2 norm = {float(torch.linalg.norm(rhs_c)):.6g}")
        res = self._coarse_cg(self.A_stencil, rhs_c)
        self.coarse_solution = res.x
        self.coarse_cg = res
        return res.x

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
    # The pipeline step
    # ------------------------------------------------------------------

    def build_step(self, mesh=None):
        """Return the end-to-end step

            step(coefs: {"alpha": (n_fine_cells, nq)}, fem_rhs: (n_nodes, 1))
                -> (coarse solution (P, 1), A_stencil (P, S, 1, 1))

        covering basis construction -> coarse-operator assembly -> CG.
        The step also leaves ``Phi``, ``APhi``, ``A_stencil``,
        ``coarse_solution`` and ``coarse_cg`` on the solver, so that
        ``prolong_lod_solution`` can follow it."""
        if mesh is not None:
            _not_ported("build_step(mesh=...) (patch-axis sharding)", "13")

        def step(coefs, fem_rhs):
            Phi, _ = self.compute_basis(coefs)
            A_st = self.assemble_coarse_operator()
            res = self._coarse_cg(A_st, self._coarse_rhs(Phi, fem_rhs))
            self.coarse_solution, self.coarse_cg = res.x, res
            return res.x, A_st

        return step
