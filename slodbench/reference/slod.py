"""The plain reference the benchmark holds the port's answers to.

A straightforward SLOD solver in plain PyTorch and NumPy, written apart
from the program: it imports nothing of the port, takes none of its tables,
and works every patch on its own exact window (no padding, no masks, no
kernels).  Given the coefficient fields at the quadrature points of every
fine cell and a fine load vector, it returns the prolonged fine field.

Per patch (a coarse cell ``c`` and its window of coarse cells within
``ell`` of it, clipped to the domain):

1. the Q1 stiffness of the window's fine subcells, assembled densely;
2. X = A_int^-1 PT_int (Cholesky), T = PT_int^T X / H^dim, T^-1;
3. SLOD: BD = (S X - PT_b) T^-1 on the patch-boundary rows, F = BD^T BD,
   one Gram G_d and projection g0_d per component d, and the smallk
   spectral stage on the Gram laid on the (2 ell + 1)^dim-cell canvas:
   d0 = -(G + delta I)^-1 g0, ``power`` inverse subspace steps from the
   fixed start block, the Rayleigh-Ritz pairs of W = Z^T (G + delta I) Z by
   ``torch.linalg.eigh``, and the latched removal of the smallest
   directions while ||d||_inf >= 0.5;
4. phi = X T^-1 (e_c + d), normalized; A phi with domain-boundary rows
   zeroed.

Then A_LOD = Phi^T (A Phi), the coarse rhs Phi^T f, an exact Cholesky solve
and the field Phi u.  The spectral stage follows the rule of the
precision the configuration states (``rule``): float32 keeps 32
directions of Grams with more than 64 coarse dofs and adds the jitter
1e-6 max|diag G|, float64 keeps every direction and adds 1e-13.

Orderings are those of the inputs' interface: lexicographic with axis 0
fastest for coarse cells, fine cells, nodes, a cell's corners and its 2^dim
Gauss points; dof = node * C + component."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

JITTER = {"float32": 1e-6, "float64": 1e-13}


def lex(dims) -> np.ndarray:
    """All integer coordinates of a box, (prod(dims), dim), axis 0
    fastest."""
    dims = [int(d) for d in dims]
    grids = np.meshgrid(*[np.arange(d) for d in dims[::-1]], indexing="ij")
    return np.stack([g.reshape(-1) for g in grids[::-1]], axis=-1)


def ravel(coords: np.ndarray, dims) -> np.ndarray:
    strides = np.cumprod([1] + [int(d) for d in dims[:-1]])
    return (np.asarray(coords) * strides).sum(-1)


def q1_tensors(dim: int, h: float, C: int) -> dict:
    """Per Gauss point stiffness tensors of a Q1 subcell of side h, two
    Gauss points per axis: diffusion {"alpha": grad N_i . grad N_j w};
    elasticity (C = dim) {"mu": mu (grad N_i . grad N_j d_ab + d_b N_i d_a
    N_j) w, "lam": d_a N_i d_b N_j w} for dofs (i, a), (j, b)."""
    g = np.array([0.5 - 0.5 / np.sqrt(3.0), 0.5 + 0.5 / np.sqrt(3.0)])
    bits = lex([2] * dim)                                 # corners = qpoints
    t = g[bits]                                           # (nq, dim)
    vals = np.where(bits[None, :, :] == 1, t[:, None, :], 1 - t[:, None, :])
    sign = np.where(bits == 1, 1.0, -1.0)                 # (m, dim)
    grad = np.empty((len(t), len(bits), dim))             # (nq, m, dim)
    for k in range(dim):
        others = np.delete(vals, k, axis=2).prod(axis=2)
        grad[:, :, k] = sign[None, :, k] * others / h
    w = (h / 2.0) ** dim
    if C == 1:
        return {"alpha": np.einsum("qik,qjk->qij", grad, grad) * w}
    m = len(bits)
    gg = np.einsum("qik,qjk->qij", grad, grad)
    mu = (np.einsum("qij,ab->qiajb", gg, np.eye(C))
          + np.einsum("qib,qja->qiajb", grad, grad)) * w
    lam = np.einsum("qia,qjb->qiajb", grad, grad) * w
    return {"mu": mu.reshape(-1, m * C, m * C),
            "lam": lam.reshape(-1, m * C, m * C)}


def cho_solve(L, B):
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, Y, upper=True)


def spd_inverse(A):
    return torch.cholesky_inverse(torch.linalg.cholesky(A))


def truncate(d0, terms):
    """d0 plus the terms (B, K, n) one by one while ||d||_inf >= 0.5."""
    K = terms.shape[1]
    partial = torch.cumsum(torch.cat([d0[:, None], terms], 1), 1)
    ok = partial[:, :K].abs().amax(-1) < 0.5
    first = torch.where(ok.any(1), ok.to(torch.int8).argmax(1), K)
    return partial[torch.arange(len(d0), device=d0.device), first]


def smallk(G, g0, k: int, power: int, jitter: float):
    """The smallk stabilization coefficients of Grams G (B, n, n) and
    projections g0 (B, n)."""
    B, n, _ = G.shape
    dmax = torch.diagonal(G, dim1=-2, dim2=-1).abs().amax(-1)
    ok = dmax > 0
    eye = torch.eye(n, dtype=G.dtype, device=G.device)
    Gj = G + (jitter * torch.where(ok, dmax, 1.0))[:, None, None] * eye
    Ginv = spd_inverse(Gj)
    d0 = torch.where(ok[:, None], -(Ginv @ g0[:, :, None])[:, :, 0], 0.0)
    k = min(k, n)
    k -= k % 2
    if k <= 0:
        return d0
    Z0 = np.linalg.qr(np.random.default_rng(0).standard_normal((n, k)))[0]
    Z = torch.as_tensor(Z0, dtype=G.dtype, device=G.device).expand(B, n, k)
    for _ in range(max(1, power)):
        Z = torch.linalg.qr(Ginv @ Z)[0]
    W = Z.mT @ Gj @ Z
    _, U = torch.linalg.eigh(0.5 * (W + W.mT))              # ascending
    V = Z @ U
    V = V * torch.rsqrt((V * V).sum(1, keepdim=True) + 1e-30)
    proj = (V.mT @ d0[:, :, None])[:, :, 0]
    dvec = truncate(d0, -(V * proj[:, None, :]).mT)
    return torch.where(ok[:, None], dvec, 0.0)


class _Window:
    """The static data of one window shape (coarse cells per axis)."""

    def __init__(self, shape, s: int, C: int, h: float):
        dim = len(shape)
        self.shape = np.asarray(shape)
        nd = self.shape * s + 1
        self.node_dims = nd
        nodes = lex(nd)
        self.nodes = nodes
        self.n_nodes = len(nodes)
        edge = ((nodes == 0) | (nodes == nd - 1)).any(-1)
        self.inner = np.nonzero(~edge)[0]
        self.edge = np.nonzero(edge)[0]
        self.edge_low = nodes[self.edge] == 0                 # (n_edge, dim)
        self.edge_high = nodes[self.edge] == nd - 1
        subs = lex(self.shape * s)
        self.subs = subs
        corners = subs[:, None, :] + lex([2] * dim)[None]
        conn = ravel(corners, nd)                             # (n_sub, m)
        cdof = (conn[:, :, None] * C + np.arange(C)).reshape(len(subs), -1)
        nD = self.n_nodes * C
        self.flat = (cdof[:, :, None] * nD + cdof[:, None, :]).reshape(-1)
        self.cells = lex(self.shape)
        # P^T: trapezoid weights of each node over each coarse cell's closure
        tw = np.ones(s + 1)
        tw[0] = tw[-1] = 0.5
        PT = np.ones((self.n_nodes, len(self.cells)))
        for k in range(dim):
            r = nodes[:, None, k] - self.cells[None, :, k] * s
            PT *= np.where((r >= 0) & (r <= s), tw[np.clip(r, 0, s)] * h,
                           0.0)
        PTd = np.einsum("nc,de->ndce", PT, np.eye(C)).reshape(
            nD, len(self.cells) * C)
        self.idof = (self.inner[:, None] * C + np.arange(C)).reshape(-1)
        self.edof = (self.edge[:, None] * C + np.arange(C)).reshape(-1)
        self.PT_int = PTd[self.idof]
        self.PT_edge = PTd[self.edof]


class ReferenceSLOD:
    """SLOD on the unit cube with ``n_coarse`` coarse cells per axis, each
    cut into ``n_sub`` fine Q1 subcells per axis, oversampling ``ell``, C
    components (1: diffusion with coefficient "alpha"; dim: elasticity with
    "lam" and "mu"), homogeneous Dirichlet data, on ``device`` in ``dtype``.
    ``tf32`` runs the float32 products in TF32 (the control)."""

    def __init__(self, dim: int, n_coarse: int, n_sub: int, ell: int,
                 C: int, device, dtype=torch.float64, rule: str = "float32",
                 smallk_dirs: int = 32, smallk_power: int = 3,
                 slod: bool = True, tf32: bool = False, chunk_bytes=2 ** 31):
        self.dim, self.N, self.s, self.ell, self.C = dim, n_coarse, n_sub, \
            ell, C
        self.device, self.dtype = torch.device(device), dtype
        self.rule, self.dirs, self.power = rule, smallk_dirs, smallk_power
        self.slod, self.tf32, self.chunk_bytes = slod, tf32, chunk_bytes
        self.h = 1.0 / (n_coarse * n_sub)
        self.H = 1.0 / n_coarse
        self.nn = n_coarse * n_sub + 1                        # nodes per axis
        self.n_nodes = self.nn ** dim
        self.base = {k: self._t(v)
                     for k, v in q1_tensors(dim, self.h, C).items()}
        centers = lex([n_coarse] * dim)
        self.centers = centers
        self.lo = np.clip(centers - ell, 0, None)
        self.hi = np.clip(centers + ell, None, n_coarse - 1)
        shapes = self.hi - self.lo + 1
        self.groups = {}
        for p, sh in enumerate(map(tuple, shapes)):
            self.groups.setdefault(sh, []).append(p)
        self.windows = {sh: _Window(sh, n_sub, C, self.h)
                        for sh in self.groups}

    @classmethod
    def of_settings(cls, st: dict, C: int, device, dtype=torch.float64,
                    tf32: bool = False):
        """The reference of a configuration's ``settings`` (``SLODConfig``
        keywords), its spectral stage on the rule of the settings'
        ``dtype``."""
        return cls(st["dim"], 2 ** st["n_global_refinements"],
                   st["n_subdivisions"], st["oversampling"], C, device,
                   dtype=dtype, rule=st["dtype"],
                   smallk_dirs=st["smallk_dirs"],
                   smallk_power=st["smallk_power"],
                   slod=st["lod_stabilization"], tf32=tf32)

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype,
                               device=self.device)

    @contextlib.contextmanager
    def _precision(self):
        flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
        old = [f.allow_tf32 for f in flags]
        for f in flags:
            f.allow_tf32 = self.tf32
        try:
            yield
        finally:
            for f, o in zip(flags, old):
                f.allow_tf32 = o

    # -- the basis ----------------------------------------------------------

    def build(self, coefs: dict):
        """The basis of every patch and the coarse matrix's Cholesky
        factor, from the coefficients {name: (n_fine_cells, nq)}."""
        coefs = {k: v.to(device=self.device, dtype=self.dtype)
                 for k, v in coefs.items()}
        rows, cols, vals, arows, avals = [], [], [], [], []
        with self._precision():
            for sh, pids in self.groups.items():
                win = self.windows[sh]
                nD = win.n_nodes * self.C
                step = max(1, int(self.chunk_bytes // (nD * nD * 8)))
                for a in range(0, len(pids), step):
                    p = np.asarray(pids[a:a + step])
                    phi, aphi = self._chunk(win, p, coefs)
                    g_int, g_all = self._global_dofs(win, p)
                    rows.append(g_int)
                    vals.append(phi)
                    arows.append(g_all)
                    avals.append(aphi)
                    cols.append(p)
            self.phi = (rows, vals, cols)
            M = self._coarse_matrix(rows, vals, cols, arows, avals)
            self.L = torch.linalg.cholesky(M)
        return self

    def _global_dofs(self, win, p):
        origin = self.lo[p] * self.s                              # (b, dim)
        nodes = ravel(origin[:, None, :] + win.nodes[None], [self.nn] *
                      self.dim)                                   # (b, n)
        dofs = (nodes[:, :, None] * self.C + np.arange(self.C)).reshape(
            len(p), -1)
        return (self._t(dofs[:, win.idof], torch.int64),
                self._t(dofs, torch.int64))

    def _chunk(self, win, p, coefs):
        """phi (b, nI, C) on the window's interior dofs and A phi (b, nD,
        C) on all its dofs, for the patches ``p`` of window ``win``."""
        C, b, dt = self.C, len(p), self.dtype
        fine = [self.N * self.s] * self.dim
        gsub = self._t(ravel(self.lo[p][:, None, :] * self.s
                             + win.subs[None], fine), torch.int64)
        K = sum(torch.einsum("bsq,qij->bsij", coefs[k][gsub], self.base[k])
                for k in self.base)
        nD = win.n_nodes * C
        A = K.new_zeros((b, nD * nD))
        A.index_add_(1, self._t(win.flat, torch.int64), K.reshape(b, -1))
        A = A.reshape(b, nD, nD)
        del K
        idof = self._t(win.idof, torch.int64)
        A_cols = A[:, :, idof]                                   # (b, nD, nI)
        PT_int = self._t(win.PT_int)
        X = cho_solve(torch.linalg.cholesky(A_cols[:, idof]),
                      PT_int.expand(b, -1, -1))
        T = PT_int.mT @ X / self.H ** self.dim
        Tinv = spd_inverse(T)
        cD = T.shape[-1]
        cen = ravel(self.centers[p] - self.lo[p], win.shape)       # (b,)
        cen_dof = self._t(cen[:, None] * C + np.arange(C), torch.int64)
        onehot = (torch.arange(cD, device=self.device)[None, :, None]
                  == cen_dof[:, None, :]).to(dt)                  # (b, cD, C)
        D = onehot
        if self.slod and len(win.cells) < self.N ** self.dim:
            D = onehot + self._stabilize(win, p, A_cols, X, Tinv, onehot)
        phi = X @ (Tinv @ D)
        phi = phi / torch.sqrt((phi * phi).sum(1, keepdim=True))
        aphi = A_cols @ phi
        dom = self._t(self._domain_dofs(win, p), torch.bool)
        aphi = torch.where(dom[:, :, None], 0.0, aphi)
        return phi, aphi

    def _edge_flags(self, win, p):
        """(patch-boundary, domain-boundary) flags of the window's edge
        nodes, (b, n_edge) each; a corner may be both."""
        dom_lo = (self.lo[p] == 0)[:, None, :]
        dom_hi = (self.hi[p] == self.N - 1)[:, None, :]
        lo, hi = win.edge_low[None], win.edge_high[None]
        is99 = ((lo & ~dom_lo) | (hi & ~dom_hi)).any(-1)
        is0 = ((lo & dom_lo) | (hi & dom_hi)).any(-1)
        return is99, is0

    def _domain_dofs(self, win, p):
        _, is0 = self._edge_flags(win, p)
        flags = np.zeros((len(p), win.n_nodes), bool)
        flags[:, win.edge] = is0
        return np.repeat(flags, self.C, axis=1)

    def _stabilize(self, win, p, A_cols, X, Tinv, onehot):
        """The stabilization coefficients (b, cD, C), zero at the centre."""
        C, b = self.C, len(p)
        is99, _ = self._edge_flags(win, p)
        m99 = self._t(np.repeat(is99, C, axis=1))[:, :, None]
        S = A_cols[:, self._t(win.edof, torch.int64)] * m99
        BD = (S @ X - self._t(win.PT_edge)[None] * m99) @ Tinv
        F = BD.mT @ BD
        cm = 1.0 - onehot                                         # (b, cD, C)
        G = torch.stack([F * cm[:, :, d, None] * cm[:, None, :, d]
                         for d in range(C)], 1)
        g0 = torch.stack([(F @ onehot[:, :, d, None])[:, :, 0] * cm[:, :, d]
                          for d in range(C)], 1)
        # lay each Gram on the canvas of (2 ell + 1)^dim cells
        side = 2 * self.ell + 1
        off = self.lo[p] - (self.centers[p] - self.ell)
        cells = ravel(win.cells[None] + off[:, None, :], [side] * self.dim)
        cdof = self._t((cells[:, :, None] * C + np.arange(C)).reshape(b, -1),
                       torch.int64)                               # (b, cD)
        n = side ** self.dim * C
        cD = cdof.shape[1]
        Gp = G.new_zeros((b, C, n, n))
        bi = torch.arange(b, device=self.device)[:, None, None, None]
        di = torch.arange(C, device=self.device)[None, :, None, None]
        Gp[bi, di, cdof[:, None, :, None], cdof[:, None, None, :]] = G
        gp = g0.new_zeros((b, C, n))
        gp[bi[..., 0], di[..., 0], cdof[:, None, :]] = g0
        k = n if (n <= 64 or self.rule == "float64") else self.dirs
        d = smallk(Gp.reshape(b * C, n, n), gp.reshape(b * C, n), k,
                   self.power, JITTER[self.rule]).reshape(b, C, n)
        d = torch.gather(d, 2, cdof[:, None, :].expand(b, C, cD))
        return d.mT * cm

    def _coarse_matrix(self, rows, vals, cols, arows, avals):
        """A_LOD = Phi^T (A Phi), dense (P C, P C)."""
        C, P = self.C, self.N ** self.dim
        nd = self.n_nodes * C
        r, c, v = [], [], []
        for g, ph, p in zip(rows, vals, cols):
            col = self._t(p[:, None] * C + np.arange(C), torch.int64)
            r.append(col[:, None, :].expand(ph.shape).reshape(-1))
            c.append(g[:, :, None].expand(ph.shape).reshape(-1))
            v.append(ph.reshape(-1))
        PhiT = torch.sparse_coo_tensor(torch.stack([torch.cat(r),
                                                    torch.cat(c)]),
                                       torch.cat(v), (P * C, nd),
                                       check_invariants=True).coalesce()
        M = torch.empty((P * C, P * C), dtype=self.dtype, device=self.device)
        width = max(C, int(2 ** 30 // (nd * 8)) // C * C)
        for c0 in range(0, P * C, width):
            c1 = min(P * C, c0 + width)
            block = M.new_zeros((nd, c1 - c0))
            for g, ah, p in zip(arows, avals, cols):
                sel = (p * C >= c0) & (p * C < c1)
                if not sel.any():
                    continue
                st = self._t(np.nonzero(sel)[0], torch.int64)
                cc = self._t(p[sel][:, None] * C + np.arange(C) - c0,
                             torch.int64)
                block[g[st][:, :, None], cc[:, None, :]] = ah[st]
            M[:, c0:c1] = torch.sparse.mm(PhiT, block)
        return 0.5 * (M + M.mT)

    # -- the coarse solve and the field ------------------------------------

    def solve(self, f: torch.Tensor) -> torch.Tensor:
        """The prolonged field (n_nodes, C) of the fine load vector f
        (n_nodes, C), zero at Dirichlet nodes."""
        f = f.to(device=self.device, dtype=self.dtype).reshape(-1)
        rows, vals, cols = self.phi
        C, P = self.C, self.N ** self.dim
        with self._precision():
            rhs = torch.zeros((P, C), dtype=self.dtype, device=self.device)
            for g, ph, p in zip(rows, vals, cols):
                rhs[self._t(p, torch.int64)] = torch.einsum("bnd,bn->bd", ph,
                                                            f[g])
            u = cho_solve(self.L, rhs.reshape(-1, 1)).reshape(P, C)
            out = torch.zeros(self.n_nodes * C, dtype=self.dtype,
                              device=self.device)
            for g, ph, p in zip(rows, vals, cols):
                out.index_add_(0, g.reshape(-1), torch.einsum(
                    "bnd,bd->bn", ph, u[self._t(p, torch.int64)]).reshape(-1))
        return out.reshape(self.n_nodes, C)

    def load_vector(self, values) -> torch.Tensor:
        """The fine load vector (n_nodes, C) of a constant right-hand side
        ``values`` (one per component): the integral of each Q1 hat
        function, zero at Dirichlet nodes."""
        n = self.N * self.s
        cells = lex([n] * self.dim)
        corners = ravel(cells[:, None, :] + lex([2] * self.dim)[None],
                        [self.nn] * self.dim)
        hat = np.zeros(self.n_nodes)
        np.add.at(hat, corners.reshape(-1), self.h ** self.dim / 2 ** self.dim)
        coords = lex([self.nn] * self.dim)
        bnd = ((coords == 0) | (coords == n)).any(-1)
        hat[bnd] = 0.0
        return self._t(hat[:, None] * np.asarray(values, float)[None, :])
