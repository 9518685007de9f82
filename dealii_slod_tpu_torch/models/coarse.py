"""The coarse LOD system A_LOD x = C^T f: one owner for its route, its
applies, its dense Cholesky factor and its solve, spans and counters."""

from __future__ import annotations

import functools
import weakref

import torch

from dealii_slod_tpu_torch.models import basis, stencil
from dealii_slod_tpu_torch.ops import solvers
from dealii_slod_tpu_torch.parallel.mesh import all_gather_rows
from dealii_slod_tpu_torch.utils.timers import count, span, spanned


def route(cfg, n_dofs: int, mode: str | None = None) -> tuple[bool, bool]:
    """(dense, direct): the dense matrix up to ``coarse_dense_cap`` dofs; the
    direct solve where ``mode`` (None: ``cfg.coarse_solve``) is "direct" and
    the matrix dense, else CG (an uncapped factor is a multi-GB one)."""
    dense = n_dofs <= cfg.coarse_dense_cap
    return dense, dense and (mode or cfg.coarse_solve) == "direct"


def _cholesky_apply(L, rhs):
    return solvers.cholesky_solve(L, rhs.reshape(-1, 1)).reshape(rhs.shape)


class CoarseSystem:
    """The coarse system of one operator ``A_st`` (P, S, C, C) of an
    ``LODSolver``, its route decided once.  Sharded (``rows``, ``group``):
    the rank's rows of A_st and of each vector; the matvec gathers the
    whole u, the direct route the whole A_st and rhs."""

    def __init__(self, solver, A_st, rows=None, group=None):
        # no cycles (a proxy, closures without self): a system frees at once
        s = self.s = weakref.proxy(solver)
        self.A_st, self.version = A_st, A_st._version
        self.rows, self.group = rows, group
        self._sl = slice(None) if rows is None else slice(*rows)
        self.n_dofs = s.topo.n_patches * s.C
        self.dense, self.direct = route(s.cfg, self.n_dofs)
        self.graphs = (s.device.type == "cuda" and group is None
                       and not self.dense)
        # block-diagonal Jacobi: the C x C centre block's diagonal (a view)
        self.diag = torch.einsum("pdd->pd", A_st[:, s.center_offset_idx])
        self._whole = ((lambda u: u) if group is None
                       else (lambda u: all_gather_rows(u, group)))

    @functools.cached_property
    def stencil_matvec(self):
        """u -> A u by stencil neighbours, whose tables stay on the solver
        from their first use: a captured graph reads them in place."""
        s = self.s
        if s._gather is None:
            s._gather = (s._t(s.stencil_nbr_np, torch.int64),
                         s._t(s.stencil_valid_np, torch.bool))
        nbr, valid = (t[self._sl] for t in s._gather)
        A_st, whole = self.A_st, self._whole
        return lambda u: stencil.coarse_matvec_with(A_st, whole(u), nbr,
                                                    valid)

    @functools.cached_property
    def matvec(self):
        """The CG's matvec, on the dense route by the dense matrix."""
        if not self.dense:
            return self.stencil_matvec
        whole = self._whole
        Ad = self.s.coarse_dense_matrix(self.A_st, self.rows)
        return lambda u: (Ad @ whole(u).reshape(-1)).reshape(u.shape)

    @functools.cached_property
    def factor(self):
        """The whole coarse matrix's Cholesky factor (not the matrix)."""
        A = self._whole(self.A_st)
        L = torch.linalg.cholesky(self.s.coarse_dense_matrix(A))
        if L.is_cuda:
            count("host_syncs", 1)  # the card's factor checks its result
        return L

    def plan(self):
        """The CG's ``GraphPlans`` plan (None: eager); a graph holds its
        stopping rule and matmul precision, so the key does too."""
        if not self.graphs:
            return None
        rc = self.s.cfg.coarse_solver
        return self.s._graph_plans.plan(
            self.A_st, self.rows, (rc.max_steps, rc.tolerance, rc.reduce),
            torch.backends.cuda.matmul.allow_tf32)

    @spanned("cg")
    def cg(self, rhs_c) -> solvers.CGResult:
        rc, diag = self.s.cfg.coarse_solver, self.diag
        return solvers.cg(self.matvec, rhs_c, max_steps=rc.max_steps,
                          tolerance=rc.tolerance, reduce=rc.reduce,
                          precond=lambda r: r / diag, group=self.group,
                          graph=self.plan())

    @spanned("coarse_rhs")
    def rhs(self, Phi, fem_rhs):
        """C^T f: the rhs's canvas windows (zero outside the domain), or
        on the classes route the clipped gather ``fem_rhs[canvas_gidx]``
        as the reference's; the canvases vanish where the two differ.
        Sharded, the rank's rows, whose canvases ``Phi`` holds."""
        s = self.s
        if s.cfg.kernel_mode == "uniform":
            f_at = basis.rhs_windows(s.cfg, s.grid, fem_rhs, self.rows)
        else:
            f_at = fem_rhs[s.canvas_gidx[self._sl]]
        return torch.einsum("pncd,pnc->pd", Phi, f_at)

    def solve(self, Phi, fem_rhs, direct: bool | None = None):
        """(x, C^T f, the CG result or None): the span ``coarse_solve``;
        ``direct`` None takes the configured route."""
        with span("coarse_solve"):
            rhs_c = self.rhs(Phi, fem_rhs)
            if not (self.direct if direct is None else direct):
                res = self.cg(rhs_c)
                return res.x, rhs_c, res
            return self.direct_solve(rhs_c), rhs_c, None

    def direct_solve(self, rhs_c):
        """A_LOD^-1 rhs_c by ``factor`` (the span ``direct``)."""
        L, whole = self.factor, self._whole(rhs_c)
        with span("direct"):
            x = _cholesky_apply(L, whole)
        return x if self.rows is None else x[self._sl]

    def two_level_precond(self, diag):
        """The fine solve's M^-1 r = r / diag + C A_LOD^-1 C^T r: A_LOD^-1
        by ``factor`` up to ``two_level_dense_cap`` coarse dofs, else a
        degree-16 Chebyshev polynomial of ``stencil_matvec`` on [lmax / 30,
        lmax], lmax by Gershgorin row sums (linear and SPD: PCG-valid)."""
        s = self.s
        if self.n_dofs <= s.cfg.two_level_dense_cap:
            coarse_solve = functools.partial(_cholesky_apply, self.factor)
        else:
            lmax = float(self.A_st.abs().sum(dim=(1, 3)).max())
            lmin = lmax / 30.0
            theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
            matvec = self.stencil_matvec

            def coarse_solve(rc):
                # Chebyshev iteration for A y = rc on [lmin, lmax]
                y = d = rc / theta
                sigma = theta / delta
                rho = 1.0 / sigma
                for _ in range(16 - 1):
                    rho_new = 1.0 / (2.0 * sigma - rho)
                    r = rc - matvec(y)
                    d = rho_new * (2.0 / delta * r + rho * d)
                    y = y + d
                    rho = rho_new
                return y

        gidx = s.canvas_gidx.reshape(-1)

        def precond(r):
            rc = torch.einsum("pncd,pnc->pd", s.Phi,
                              r[s.canvas_gidx])                  # C^T r
            vals = torch.einsum("pncd,pd->pnc", s.Phi, coarse_solve(rc))
            coarse = torch.zeros_like(r)
            coarse.index_add_(0, gidx, vals.reshape(-1, s.C))    # C y
            coarse = torch.where(s.fine_bnd[:, None], 0.0, coarse)
            return r / diag + coarse

        return precond
