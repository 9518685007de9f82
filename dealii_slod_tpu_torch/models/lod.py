"""The LOD / SLOD pipeline on a torch device (counterpart of
``dealii_slod_tpu/models/lod.py``): batched basis construction in chunks,
the stencil coarse operator, the coarse CG solve, the fine and coarse FEM
comparison solves, the error tables, VTU output and ``run()``.

The tables are tensors on the ``device`` given to the constructor, the
card unless the caller asks for the CPU.  The ported routes are 3D / 2D
scalar diffusion and reaction-diffusion (C = 1) and linear elasticity
(C = dim), plain LOD or SLOD, with the fused patch solver, its 2x2 Schur
split, the panel LDL^T or the per-patch Cholesky solve
(``patch_solver="auto"``: K1 on the whole block on the card in float32
up to ``K1_WHOLE_MAX_N``, else the reference's size rule), the
smallk, Jacobi or ``eigh`` spectral stage
(``eig_solver="auto"``: smallk on the card in float32, ``eigh`` ("lapack")
elsewhere), the banded or the scatter assembly, the trace kernel or its
scan, the coarse CG or the direct coarse solve; ``kernel_mode="classes"``
builds the basis per patch shape class (``models/classes.py``), and on a
constant field the uniform route builds one patch per window signature.
``build_step(mesh)`` shards the patch axis over the ranks of a
``DeviceMesh`` (``parallel/mesh.py``): each rank builds its own patches'
basis, receives its neighbours' canvases for the coarse stencil rows it
owns, and runs its rows of the coarse CG with the dot products summed
over the ranks."""

from __future__ import annotations

import contextlib
import functools
import os
import warnings

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard

from dealii_slod_tpu_torch.config import ParsedFunction, SLODConfig
from dealii_slod_tpu_torch.grid import (GridSpec, PatchTopology,
                                        ShapeClass, cartesian_coords,
                                        clipped_window_index,
                                        global_connectivity, ravel)
from dealii_slod_tpu_torch.models import basis, classes, coarse, stencil
from dealii_slod_tpu_torch.ops import element
from dealii_slod_tpu_torch.ops.assembly import (FineOperator,
                                                assemble_load_vector,
                                                check_coefs,
                                                make_subcell_matrices)
from dealii_slod_tpu_torch.ops.patch_solve import k1_operand_n
from dealii_slod_tpu_torch.ops.solvers import (GraphPlans, cg,
                                               dense_dirichlet_solve)
from dealii_slod_tpu_torch.parallel.mesh import (check_mesh, exchange_rows,
                                                 replicate)
from dealii_slod_tpu_torch.utils import errors
from dealii_slod_tpu_torch.utils.errors import ConvergenceTable, host_array
from dealii_slod_tpu_torch.utils.timers import StageTimer, count, span, spanned

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


def spectral_mode(cfg: SLODConfig, device: torch.device) -> str:
    """The spectral stage ``eig_solver`` names on ``device``: "auto" is
    "smallk" on the card in float32 and "lapack" elsewhere (the JAX rule,
    ``models/basis.py: _uniform_core``, with the card as the
    accelerator)."""
    if cfg.eig_solver != "auto":
        return cfg.eig_solver
    return ("smallk" if device.type == "cuda" and cfg.dtype == "float32"
            else "lapack")


# The largest padded block K1 takes whole on the card in float32 under
# patch_solver="auto" (``patch_solver_mode``).
K1_WHOLE_MAX_N = 2240


def patch_solver_mode(cfg: SLODConfig, C: int, sc: ShapeClass,
                      device=None) -> str:
    """The patch solver ``patch_solver`` names.  "auto" on a CUDA
    ``device`` in float32 is "fused" (K1 on the whole block) wherever the
    block, padded to K1's panel (``ops/patch_solve.py: k1_operand_n``),
    is at most ``K1_WHOLE_MAX_N``.  The card has no scoped-memory limit,
    and there K1 on the whole block, factored in place, beat the Schur
    split on K6 leaves at both padded-2240 blocks the port runs (NVIDIA
    H100 80GB HBM3, 700 W, float32, 128 patches a chunk, CUDA events,
    ``chip_smoke.py: patch_route_times``): 3D l=2 elasticity (2187, k 375)
    24.78 ms against the split's 39.27, 3D l=3 diffusion (2197, k 343)
    25.01 against 36.39.  No larger block was timed, so the constant
    stops there.  Float64 keeps the reference's rule, and so the split on
    K6 leaves: that is the route ``chip_smoke.py``'s float64 K6 gates and
    the float64 card paths hold to their answers.  K1 whole is faster
    in float64 too (the same card: 49.56 ms against 60.76 at 2187, 49.39
    against 56.48 at 2197), so moving float64 is open.
    Elsewhere (no device, the CPU, float64, or a larger block) "auto"
    applies the reference's size rule (``models/basis.py:
    _fused_solver_mode``): "fused" when the fused kernel's estimate fits
    12 MiB (3D l=2 diffusion sits exactly at it), else "fused_split" when
    a half split fits 13 MiB (3D l=2 elasticity), else "lax" (the
    per-patch Cholesky solve).  A named solver other than "fused",
    "fused_split" and "panel" is "lax", as in the reference ("panel":
    ``ops/patch_solve.py: panel_spd_multirhs``)."""
    mode = cfg.patch_solver
    if mode != "auto":
        return mode if mode in ("fused", "fused_split", "panel") else "lax"
    if (device is not None and torch.device(device).type == "cuda"
            and cfg.dtype == "float32"
            and k1_operand_n(sc.n_interior * C) <= K1_WHOLE_MAX_N):
        return "fused"
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
    of a kernel's contract (K9), which run on that contract's kernel.

    ``chunk_scan`` picks the reference's dispatch of the chunk loop (one
    ``lax.scan``, or a Python loop of jitted chunks); the port's chunk
    loop is a host loop at either value, which is what
    ``chunk_scan=False`` runs."""
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
    """The SLOD pipeline (diffusion, reaction-diffusion or elasticity) on
    one torch device, the card unless ``device="cpu"`` is asked for.

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
        check_coefs("LODSolver", self.coef_q)
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
        self.solver_mode = patch_solver_mode(cfg, C, self.canvas_class,
                                             self.device)
        self.canvas_center_cell = int(ravel(np.full(cfg.dim, ell),
                                            np.full(cfg.dim, 2 * ell + 1)))
        self._tables = None
        self._inputs = None
        self._dedup = None
        self._class_tables = {}
        self._stencil_tables = None
        self._slab_tables = {}
        self._placement = None
        self._gather = None
        self._coarse = None
        self._graph_plans = GraphPlans()

    def parse(self, spec):
        return ParsedFunction(spec, self.C, self.cfg.dim)

    def _t(self, a, dtype=None):
        """The host array ``a`` as a tensor on the solver's device; its
        bytes count as ``h2d_bytes`` under a profiler, and on the card the
        copy from pageable memory, which waits, as a host sync."""
        t = torch.as_tensor(np.asarray(a), device=self.device,
                            dtype=dtype or self.dtype)
        count("h2d_bytes", t.nbytes)
        if t.is_cuda:
            count("host_syncs", 1)
        return t

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
    @spanned("basis")
    def compute_basis(self, coefs=None, rows=None):
        """Basis canvases ``self.Phi`` / ``self.APhi`` (P, canvas_n, C, C),
        chunk by chunk (``cfg.patch_chunk`` patches; 0 = all at once).

        Without ``coefs`` (the solver's own field) a constant field builds
        only the unique window signatures and gathers them back with one
        index (the coefficient windows are off then, as in the
        reference); fields passed in (``build_step``) are never deduped.
        ``rows`` = (a, b) builds the patches a .. b-1 alone (a rank's
        share of the sharded step), and the canvases are those rows.
        ``self.basis_patches`` is the number of patches built.

        The build is the span ``basis`` (``utils/timers``); on the uniform
        route the chunk stages ``assemble`` (coefficient windows, then
        ``basis.prep``), ``patch_solve``, ``stabilize`` and ``canvas``
        (``basis.uniform_chunk``) tile it.  Where each chunk's windows are
        cut from the padded lattice, the lattice build and each cut are a
        ``windows`` span inside ``assemble``, and ``window_bytes`` counts
        the bytes cut."""
        if self.cfg.kernel_mode != "uniform":
            Phi, APhi = classes.compute_basis(
                self, self.coef_q if coefs is None else coefs, rows)
            self.Phi, self.APhi = Phi, APhi
            self.basis_patches = len(Phi)
            return Phi, APhi
        dedup = (self._dedup_inputs_t() if coefs is None and rows is None
                 else None)
        coefs = self.coef_q if coefs is None else coefs
        tab = self._uniform_tables()
        if dedup is None:
            gsub, nlo_t, nhi_t, sides_t = self._uniform_inputs_t()
        else:
            gsub, nlo_t, nhi_t, sides_t, inv = dedup
        a, b = rows or (0, len(nlo_t))
        B, C = b - a, self.C
        step = self.cfg.patch_chunk or B
        # per-chunk windows where the chunks are the reference's chunks
        # (the chunk index counts from patch 0)
        wrows = (self._window_chunk_rows(coefs, len(nlo_t), step)
                 if gsub is None and a % step == 0 and B % step == 0
                 else None)
        if wrows is not None:
            with span("assemble"), span("windows"):
                lattices = {k: basis.coef_lattice(self.cfg, self.grid,
                                                  coefs[k])
                            for k in self.coef_names}
            win = (2 * self.cfg.oversampling + 1) * self.cfg.n_subdivisions

            def windows(lo, hi):
                with span("windows"):
                    cut = {k: basis.window_stack_chunk(
                        L, lo // step, wrows, win, self.cfg.n_subdivisions)
                        for k, L in lattices.items()}
                    count("window_bytes", sum(v.nbytes for v in cut.values()))
                return cut
        else:
            with span("assemble"):
                cw = {k: (basis.coef_windows(self.cfg, self.grid, coefs[k],
                                             rows)
                          if gsub is None else coefs[k][gsub[a:b]])
                      for k in self.coef_names}

            def windows(lo, hi):
                return {k: v[lo - a:hi - a] for k, v in cw.items()}
        Phi = torch.empty((B, self.canvas_n, C, C), dtype=self.dtype,
                          device=self.device)
        APhi = torch.empty_like(Phi)
        for lo in range(a, b, step):
            hi = min(b, lo + step)
            with span("assemble"):
                cw_chunk = windows(lo, hi)
            basis.uniform_chunk(tab, cw_chunk, nlo_t[lo:hi], nhi_t[lo:hi],
                                sides_t[lo:hi],
                                (Phi[lo - a:hi - a], APhi[lo - a:hi - a]))
        if dedup is not None:
            with span("canvas"):
                Phi, APhi = Phi[inv], APhi[inv]
        self.Phi, self.APhi = Phi, APhi
        self.basis_patches = B
        return Phi, APhi

    def _window_chunk_rows(self, coefs, B: int, step: int):
        """Patch x-rows per chunk when each chunk's coefficient windows
        are cut from the padded lattice in the chunk loop (the reference's
        gate, ``models/lod.py``'s in-body window extraction), else None:
        ``window_chunk`` "off" never, "on" whenever the chunks tile whole
        x-rows (``basis.window_chunk_rows``), "auto" then only where the
        whole windows of some coefficient would exceed 256 MiB."""
        mode = self.cfg.window_chunk
        if mode == "off" or B % step:
            return None
        rows = basis.window_chunk_rows(self.cfg, B, B // step)
        if rows is None or mode != "auto":
            return rows
        win = (2 * self.cfg.oversampling + 1) * self.cfg.n_subdivisions
        full = max(B * win ** self.cfg.dim * coefs[k].shape[-1]
                   * coefs[k].element_size() for k in self.coef_names)
        return rows if full > basis.WINDOW_SLAB_BYTES else None

    @spanned("coarse_op")
    def _stencil_build(self, Phi, APhi, slab=None):
        """A_st from the canvases of every patch, or on a ``stencil_slab``
        its rows from the slab's canvases."""
        if slab is None:
            if self._stencil_tables is None:
                self._stencil_tables = stencil.stencil_tables(
                    self.cfg, self.grid, self.canvas_dims,
                    self.stencil_offsets, self.device, self.dtype)
            tab = self._stencil_tables
        else:
            key = slab["rows"]
            if key not in self._slab_tables:
                self._slab_tables[key] = stencil.stencil_tables(
                    self.cfg, self.grid, self.canvas_dims,
                    self.stencil_offsets, self.device, self.dtype, slab)
            tab = self._slab_tables[key]
        return stencil.stencil_build(Phi, APhi, tab, self.cfg, self.dtype)

    @_full_f32
    def assemble_coarse_operator(self):
        """A_LOD as a stencil (P, S, C, C) from ``self.Phi`` / ``APhi``."""
        self.A_stencil = self._stencil_build(self.Phi, self.APhi)
        return self.A_stencil

    @_full_f32
    def coarse_dense_matrix(self, A_st, rows=None):
        """The dense coarse matrix (P C, P C), or its rows of the patches
        ``rows`` = (a, b) from those rows of A_st."""
        if rows is not None:
            a, b = rows
            place = stencil.dense_placement(self.stencil_nbr_np[a:b],
                                            self.stencil_valid_np[a:b],
                                            self.device)
            return stencil.coarse_dense_matrix(A_st, place,
                                               self.topo.n_patches)
        if self._placement is None:
            self._placement = stencil.dense_placement(
                self.stencil_nbr_np, self.stencil_valid_np, self.device)
        return stencil.coarse_dense_matrix(A_st, self._placement)

    def _coarse_system(self):
        """``A_stencil``'s coarse system, kept per operator (one factor)."""
        c, A = self._coarse, self.A_stencil
        if c is None or c.A_st is not A or c.version != A._version:
            c = self._coarse = coarse.CoarseSystem(self, A)
        return c

    @_full_f32
    def solve_coarse(self):
        """Coarse LOD solve (reference LOD.cc:976-1002): rhs = C^T f, then
        CG with Jacobi on the coarse operator, or the direct solve
        (``coarse_solve="direct"`` below the cap; ``coarse_cg`` None)."""
        x, self.coarse_rhs, self.coarse_cg = self._coarse_system().solve(
            self.Phi, self.fem_rhs)
        if self.verbose:
            self.log(f"     rhs l2 norm = "
                     f"{float(torch.linalg.norm(self.coarse_rhs)):.6g}")
        self.coarse_solution = x
        self.log(f"   size of u {x.numel()}")
        return x

    @_full_f32
    def load_server(self, mode=None):
        """The load-case entry on the current basis and coarse operator:
        ``serve(fem_rhs (n_nodes, C)) -> coarse solution (P, C)``; ``mode``
        "direct" (up to ``coarse_dense_cap``, else CG), "cg" or None
        (``cfg.coarse_solve``), ``serve.mode`` the one that runs.  Route,
        tables and factor are made here; a call is one ``coarse_solve``."""
        system = self._coarse_system()
        direct = coarse.route(self.cfg, system.n_dofs, mode)[1]
        _ = system.factor if direct else system.matvec
        solve = system.solve

        def serve(fem_rhs):
            with full_f32_matmuls():
                return solve(self.Phi, fem_rhs, direct)[0]

        serve.mode = "direct" if direct else "cg"
        return serve

    @_full_f32
    @spanned("prolong")
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

    @_full_f32
    def solve_fine_fem(self):
        """Fine-scale FEM solve: CG with Jacobi, or with the LOD-space
        two-level preconditioner (``fine_preconditioner="two_level"``,
        ``coarse.CoarseSystem.two_level_precond``)."""
        cfg = self.cfg
        op = FineOperator(self.et, self.conn, self.coef_q,
                          dirichlet_mask=self.fine_bnd)
        d = op.diagonal()
        if (cfg.fine_preconditioner == "two_level"
                and hasattr(self, "A_stencil")):
            precond = self._coarse_system().two_level_precond(d)
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
        if self.verbose:
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
        every public stage, runs under ``full_f32_matmuls``.

        With ``mesh`` (a ``DeviceMesh``, ``parallel.make_mesh``; every rank
        calls the step with the whole field and rhs) the patch axis is
        sharded over the mesh's ``cfg.mesh_axis`` dimension, the
        reference's MPI patch partitioning (source/LOD.cc:116-118): with
        P % n == 0 rank r owns the patches [r P / n, (r + 1) P / n) and the
        outputs are ``DTensor``s, ``Shard(0)`` (``full_tensor()``, or
        ``parallel.mesh.full_tensor`` over gloo on a card, gives the global
        arrays); ``Phi``, ``APhi``, ``A_stencil`` and
        ``coarse_solution`` left on the solver are the rank's own rows, so
        ``prolong_lod_solution`` does not follow a sharded step.  Otherwise
        every rank computes every patch, as the reference replicates, and
        the outputs are ``Replicate()``.  A ``mesh`` that is not a
        ``DeviceMesh`` raises ``TypeError``; one on another device type
        than the solver's, or without that dimension, ``ValueError``."""
        if mesh is None:
            return self._step
        axis = self.cfg.mesh_axis
        check_mesh(mesh, axis, self.device)
        n, P = mesh.size(), self.topo.n_patches
        if P % n:
            # correct but not parallel: make it visible, as the reference
            self.log(f"WARNING: leading axis {P} not divisible by {n} "
                     "devices; array left replicated")

            def replicated(coefs, fem_rhs):
                self.halo_bytes = 0
                return tuple(replicate(mesh, x)
                             for x in self._step(coefs, fem_rhs))

            return replicated
        return functools.partial(self._sharded_step, mesh, axis)

    @_full_f32
    @spanned("step")
    def _step(self, coefs, fem_rhs):
        Phi, _ = self.compute_basis(coefs)
        A_st = self.assemble_coarse_operator()
        x, _, res = coarse.CoarseSystem(self, A_st).solve(Phi, fem_rhs)
        self.coarse_solution, self.coarse_cg = x, res
        return x, A_st

    @_full_f32
    @spanned("step")
    def _sharded_step(self, mesh, axis, coefs, fem_rhs):
        """One rank's share of the step over ``mesh``: the basis of its
        patches; the canvases of the patches within 2 l planes of them
        from the ranks that own them (point to point; ``halo_bytes`` says
        how much came in); its rows of A_st on that slab
        (``stencil_slab``, the byte rule read on the global P); its share
        of the coarse solve (``coarse.CoarseSystem``; the CG's dots summed
        over the ranks)."""
        group = mesh.get_group(axis)
        n, r = mesh.size(), mesh.get_local_rank(axis)
        P = self.topo.n_patches
        owned = [(t * P // n, (t + 1) * P // n) for t in range(n)]
        slabs = [stencil.stencil_slab(self.cfg, P, o) for o in owned]
        rows = owned[r]
        Phi, APhi = self.compute_basis(coefs, rows)
        need = [sl["patches"] for sl in slabs]
        Phi_s, b_phi = exchange_rows(Phi, owned, need, group)
        APhi_s, b_aphi = exchange_rows(APhi, owned, need, group)
        self.halo_bytes = b_phi + b_aphi
        A_st = self._stencil_build(Phi_s, APhi_s, slabs[r])
        del Phi_s, APhi_s
        self.A_stencil = A_st
        x, _, res = coarse.CoarseSystem(self, A_st, rows, group).solve(
            Phi, fem_rhs)
        self.coarse_solution, self.coarse_cg = x, res
        return tuple(DTensor.from_local(v, mesh, [Shard(0)], run_check=False)
                     for v in (x, A_st))
