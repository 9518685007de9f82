"""Stencil-form coarse operator (counterpart of ``dealii_slod_tpu/models/
stencil.py``): ``A_LOD[q, p] = phi_q . (A phi_p)`` (reference
``assemble_global_matrix``, source/LOD.cc:860-973) as a (P, S, C, C)
stencil over relative window offsets, built cell by cell from the basis
canvases, and the coarse matvec that drives the CG.  C solution components
(C = 1 diffusion, C = dim elasticity); coarse dofs are patch-major,
p * C + d."""

from __future__ import annotations

import numpy as np
import torch

from dealii_slod_tpu_torch.grid import cartesian_coords, ravel
from dealii_slod_tpu_torch.utils.timers import count, span


def cell_tables(cfg, grid, canvas_dims, stencil_offsets) -> dict:
    """Static tables for the cell-decomposed build (numpy).

    Every global fine node is owned by exactly one coarse cell
    (own(g) = clip(g // s, 0, N-1) per axis), so ``A_LOD[q, p] = sum_e
    sum_{g owned by e} phi_q(g) Aphi_p(g)``.  phi needs the K window slots
    of its patch; Aphi is nonzero on the window edge, whose top-face nodes
    belong to the cell one slot beyond the canvas, hence the extended
    (2l+2)-slot grid K2 with the out-of-canvas node layers masked."""
    ell, s, N, dim = (cfg.oversampling, cfg.n_subdivisions, cfg.n_coarse,
                      cfg.dim)
    K = (2 * ell + 1) ** dim
    ks = cartesian_coords(np.full(dim, 2 * ell + 1))
    K2 = (2 * ell + 2) ** dim
    ks2 = cartesian_coords(np.full(dim, 2 * ell + 2))
    oo = cartesian_coords(np.full(dim, s + 1))
    O = len(oo)
    cells = cartesian_coords(grid.cell_dims)

    def patch_table(slots):
        node_co = slots[:, None, :] * s + oo[None, :, :]
        in_canvas = (node_co <= (2 * ell + 1) * s).all(-1)
        cnode = ravel(np.minimum(node_co, (2 * ell + 1) * s), canvas_dims)
        return cnode.astype(np.int64), in_canvas

    cnode1, incv1 = patch_table(ks)
    cnode2, incv2 = patch_table(ks2)
    top = cells == N - 1
    own = np.logical_or(oo[None, :, :] < s, top[:, None, :]).all(-1)
    # slot (in the extended grid) of the neighbour p = q + delta covering
    # the same cell: k2 = k1 - delta
    k2map = np.full((K, len(stencil_offsets)), -1, dtype=np.int64)
    for k1 in range(K):
        tgt = ks[k1][None, :] - stencil_offsets
        ok = ((tgt >= 0) & (tgt <= 2 * ell + 1)).all(-1)
        k2map[k1, ok] = ravel(tgt[ok], np.full(dim, 2 * ell + 2))
    return dict(cnode1=cnode1, incv1=incv1, cnode2=cnode2, incv2=incv2,
                own=own, k2map=k2map, K=K, K2=K2, O=O)


def slot_match_matrix(tab: dict, n_stencil: int) -> np.ndarray:
    """0/1 matrix M[(k1, k2), j] of the relation k2 == k1 - delta_j: the
    slot correlation of the build is one matmul with it."""
    K, K2 = tab["K"], tab["K2"]
    M3 = np.zeros((K, K2, n_stencil), dtype=np.float32)
    k1, j = np.nonzero(tab["k2map"] >= 0)
    M3[k1, tab["k2map"][k1, j], j] = 1.0
    return M3.reshape(K * K2, n_stencil)


def shift_index(N: int, dim: int, ell: int, slot_dims: int, sign: int,
                device, dtype, rows: tuple | None = None,
                src_rows: tuple | None = None):
    """Static gather of the slot-indexed lattice shift (``_shift_slots``)
    of an (E, slots, rest) table: sign=+1: out[e, k] = X[e + (ell - k), k];
    sign=-1: out[q, k] = X[q + (k - ell), k]; zero where the shifted cell
    leaves the lattice.  Returns (source rows (E, slots), validity).

    On a slab (the sharded build): ``rows`` = [r0, r1) keeps the output
    rows of those lattice ids, and X holds only the lattice ids
    ``src_rows`` = [s0, s1), so the sources count from s0 and a source
    outside them is zero as well."""
    cells = cartesian_coords(np.full(dim, N))
    if rows is not None:
        cells = cells[rows[0]:rows[1]]
    slots = cartesian_coords(np.full(dim, slot_dims))
    src = cells[:, None, :] + sign * (ell - slots[None, :, :])
    valid = ((src >= 0) & (src < N)).all(-1)
    src_flat = ravel(np.clip(src, 0, N - 1), np.full(dim, N))
    if src_rows is not None:
        valid &= (src_flat >= src_rows[0]) & (src_flat < src_rows[1])
        src_flat = np.clip(src_flat - src_rows[0], 0,
                           src_rows[1] - src_rows[0] - 1)
    return (torch.as_tensor(src_flat, device=device),
            torch.as_tensor(valid, dtype=dtype, device=device))


def stencil_slab(cfg, P: int, rows: tuple) -> dict:
    """The lattice ids that the rows [a, b) of A_st read, as whole planes
    of the slowest axis (patch ids are x-fastest, so a range of rows covers
    consecutive planes; a range that starts or ends mid-plane widens to
    the whole plane): the cells within l of a row (the patch-row read) and
    the patches within 2 l of a row (the side tables read patches within
    l of a cell), clipped to the domain.  The A phi side also reads patch
    e - l - 1 for cell e, but only into slot pairs whose offset lies
    beyond the stencil, which the slab's tables mask."""
    N, dim, ell = cfg.n_coarse, cfg.dim, cfg.oversampling
    plane = N ** (dim - 1)
    z0, z1 = rows[0] // plane, (rows[1] - 1) // plane + 1

    def widen(w):
        return (max(0, z0 - w) * plane, min(N, z1 + w) * plane)

    return dict(rows=tuple(rows), cells=widen(ell), patches=widen(2 * ell),
                P=P)


def shift_slots(X, index, lo: int = 0):
    """Apply a ``shift_index`` gather to X (E, slots, rest...) whose slot
    axis holds the slots ``lo .. lo + X.shape[1] - 1`` of the index's
    slot grid: the slot base of a chunk of slots (``_shift_slots_flat``'s
    ``slot_base``)."""
    src, valid = index
    n = X.shape[1]
    src, valid = src[:, lo:lo + n], valid[:, lo:lo + n]
    k = torch.arange(n, device=X.device)[None, :]
    return X[src, k].mul_(valid[(...,) + (None,) * (X.dim() - 2)])


def stencil_tables(cfg, grid, canvas_dims, stencil_offsets, device,
                   dtype, slab: dict | None = None) -> dict:
    """``cell_tables`` and ``slot_match_matrix`` as device tensors, with
    the three lattice-shift gathers of the build.  With a ``stencil_slab``
    the tables build the rows ``slab["rows"]`` of A_st from the canvases
    of the patches ``slab["patches"]`` alone."""
    tab = cell_tables(cfg, grid, canvas_dims, stencil_offsets)
    N, dim, ell = cfg.n_coarse, cfg.dim, cfg.oversampling
    kappa = 2 * ell + 1
    out = dict(K=tab["K"], K2=tab["K2"], O=tab["O"], dim=dim, kappa=kappa,
               P=N ** dim if slab is None else slab["P"])
    for w in ("1", "2"):
        out["cnode" + w] = torch.as_tensor(tab["cnode" + w].reshape(-1),
                                           device=device)
        out["incv" + w] = torch.as_tensor(tab["incv" + w].reshape(-1),
                                          dtype=dtype, device=device)
    sl = slab or {}
    cells, patches = sl.get("cells"), sl.get("patches")
    own = tab["own"] if cells is None else tab["own"][cells[0]:cells[1]]
    out["own"] = torch.as_tensor(own, dtype=dtype, device=device)
    out["shift1"] = shift_index(N, dim, ell, kappa, 1, device, dtype,
                                cells, patches)
    out["shift2"] = shift_index(N, dim, ell, kappa + 1, 1, device, dtype,
                                cells, patches)
    # the patch-row read G2[q, k] = T[e(q, k), k], e = q + ks[k] - ell
    # (the reference's e_idx / evalid)
    out["shift_rows"] = shift_index(N, dim, ell, kappa, -1, device, dtype,
                                    sl.get("rows"), cells)
    out["M3"] = torch.as_tensor(
        slot_match_matrix(tab, len(stencil_offsets)), dtype=dtype,
        device=device)
    return out


def stencil_plan(cfg, P: int, C: int, item: int) -> tuple:
    """The reference's choice of build (``_stencil_build``), from shapes:
    ("planes", zk, zm) when the whole side tables, P (K + K2) O C^2 items,
    exceed ``cfg.stencil_side_budget_mb`` MiB, else ("cells", n_chunks)
    with the (P, K, K2, C, C) intermediate cut into ~1 GiB K chunks."""
    dim, kappa = cfg.dim, 2 * cfg.oversampling + 1
    K, K2 = kappa ** dim, (kappa + 1) ** dim
    O = (cfg.n_subdivisions + 1) ** dim
    CC = C * C
    budget = cfg.stencil_side_budget_mb * (1 << 20)
    if P * (K + K2) * O * CC * item > budget:
        return ("planes",) + planes_chunks(P, CC, kappa, dim, O, item,
                                           budget)
    t_bytes = P * K * K2 * CC * item
    return ("cells", min(K, max(1, -(-t_bytes // (1 << 30)))))


def planes_chunks(P: int, CC: int, kappa: int, dim: int, O: int, item: int,
                  budget_bytes: int) -> tuple:
    """Slot z-planes per chunk (zk of the phi side, zm of the A phi
    side) of the plane-chunked build: each side's chunk within a quarter
    of the budget, their (P, zk plane1, zm plane2, C, C) product within
    half of it (``_stencil_build_cells_planes``'s caps)."""
    plane1, plane2 = kappa ** (dim - 1), (kappa + 1) ** (dim - 1)

    def planes_within(n_planes, per_plane_bytes):
        cap = max(1, int(budget_bytes // 4 // max(1, per_plane_bytes)))
        return min(n_planes, cap)

    zk = planes_within(kappa, P * plane1 * O * CC * item)
    zm = planes_within(kappa + 1, P * plane2 * O * CC * item)
    while zk * zm > 1 and (P * zk * plane1 * zm * plane2 * CC * item
                           > budget_bytes // 2):
        if zk >= zm and zk > 1:
            zk -= 1
        elif zm > 1:
            zm -= 1
        else:
            break
    return zk, zm


def stencil_build(Phi, APhi, tab: dict, cfg, dtype):
    """The coarse operator (P, S, C, C) by the build ``stencil_plan``
    picks for these shapes: the reference's rule to the byte, so both
    packages take the same branch on every configuration.  On a slab
    (``stencil_tables(..., slab=...)``) the rule reads the global P, and
    the branch runs on the slab's canvases."""
    C = Phi.shape[-1]
    plan = stencil_plan(cfg, tab["P"], C, torch.finfo(dtype).bits // 8)
    if plan[0] == "planes":
        return stencil_build_cells_planes(
            Phi, APhi, tab, cfg.stencil_side_budget_mb * (1 << 20))
    return stencil_build_cells(Phi, APhi, tab, n_chunks=plan[1])


def _side_table(X, tab, which, shift):
    """Canvas picks of side ``which`` ("1": the K phi slots, "2": the K2
    A phi slots) aligned onto the cell lattice: X (P, nN, C, C) ->
    (E, slots, O C C)."""
    P, C = X.shape[0], X.shape[-1]
    Y = (X.reshape(P, -1, C * C)[:, tab["cnode" + which]]
         * tab["incv" + which][None, :, None])
    return shift_slots(Y.reshape(P, -1, tab["O"] * C * C), tab[shift])


def stencil_build_cells(Phi, APhi, tab: dict, n_chunks: int = 1):
    """Cell-decomposed stencil build (``_stencil_build_cells``) with the
    ``stencil_tables`` ``tab``, canvases (P, nN, C, C):

    1. canvas picks Y[q, (k, o)] = Phi_q[cnode(k, o)] per side,
    2. lattice alignment Pc[e, k, o] = Y[e + (ell - k), k, o],
    3. owned-node contraction T[e, k, d, m, f] = sum_{o, c}
       Pc[e, k, o, c, d] Ac[e, m, o, c, f],
    4. patch rows G2[q, k1] = T[q + (k1 - ell), k1],
    5. slot correlation as one 0/1 matmul -> A_st (P, S, C, C).

    Steps 3-5 run per contiguous chunk of ceil(K / n_chunks) phi slots and
    add into A_st: the K axis is independent through steps 3-4 and the
    indicator product sums over it, so neither T nor G2 is ever whole
    (``n_chunks`` = 1 builds them whole; the sums agree to rounding).
    Each chunk is a ``stencil_chunk`` span and one ``stencil.chunks``
    count (``utils/timers``)."""
    C = Phi.shape[-1]
    K, K2, O = tab["K"], tab["K2"], tab["O"]
    E, Q = len(tab["own"]), len(tab["shift_rows"][0])      # cells, rows
    Pc = _side_table(Phi, tab, "1", "shift1")              # (E, K, O C C)
    # owned-node mask on one side only (idempotent in the product)
    Ac = _side_table(APhi, tab, "2", "shift2").reshape(E, K2, O, C * C) \
        * tab["own"][:, None, :, None]
    # (e, k, o, c, d) -> (e, (k, d), (o, c)): the contraction is one bmm
    Pc = Pc.reshape(E, K, O, C, C).permute(0, 1, 4, 2, 3).reshape(
        E, K * C, O * C)
    Ac = Ac.reshape(E, K2, O, C, C).permute(0, 1, 4, 2, 3).reshape(
        E, K2 * C, O * C)
    Kc = -(-K // max(1, n_chunks))
    A_st = None
    for k0 in range(0, K, Kc):
        k1 = min(K, k0 + Kc)
        with span("stencil_chunk"):
            count("stencil.chunks", 1)
            Tk = Pc[:, k0 * C:k1 * C] @ Ac.mT              # (E, Kc d, K2 f)
            G2 = shift_slots(Tk.reshape(E, k1 - k0, -1), tab["shift_rows"],
                             k0)
            del Tk
            # (q, k, d, m, f) -> (q, d, f, (k, m)) against the indicator
            # rows of this K range (the flat row index (k, m) is k-major)
            G2 = G2.reshape(Q, k1 - k0, C, K2, C).permute(0, 2, 4, 1, 3) \
                .reshape(Q, C * C, (k1 - k0) * K2)
            part = G2 @ tab["M3"][k0 * K2:k1 * K2]         # (P, C C, S)
            del G2
            A_st = part if A_st is None else A_st.add_(part)
    return A_st.mT.reshape(Q, -1, C, C)


def stencil_build_cells_planes(Phi, APhi, tab: dict, budget_bytes: int):
    """Plane-chunked cells build (``_stencil_build_cells_planes``): the
    algebra of ``stencil_build_cells``, with both side tables built and
    consumed one range of slot z-planes at a time (the slowest slot axis:
    a contiguous range of the flat slot index), so that no whole side
    table exists; ``planes_chunks`` sizes the ranges.  The canvas nodes
    are gathered once per (side, range), and the basis-column pairs
    (d, f) are a loop.  The ranges are sized for the tables' global P,
    also on a slab.  Eager execution runs the ranges one after the
    other and ``del`` frees each one's tables before the next: the
    reference needs optimization barriers for that.  Each pair of ranges
    (an A phi range and a phi range) is a ``stencil_chunk`` span and one
    ``stencil.chunks`` count; the A phi range's node gather precedes its
    pairs."""
    P, C = Phi.shape[0], Phi.shape[-1]
    K, K2, O = tab["K"], tab["K2"], tab["O"]
    Q = len(tab["shift_rows"][0])
    dim, kappa = tab["dim"], tab["kappa"]
    zk, zm = planes_chunks(tab["P"], C * C, kappa, dim, O,
                           Phi.element_size(), budget_bytes)
    plane1, plane2 = kappa ** (dim - 1), (kappa + 1) ** (dim - 1)
    S = tab["M3"].shape[-1]
    M3 = tab["M3"].reshape(K, K2, S)
    own_oc = tab["own"].repeat_interleave(C, dim=1)[:, None, :]  # (E,1,OC)
    A_st = Phi.new_zeros((Q, C, C, S))

    def side(X, which, shift, lo, hi, col):
        """(E, hi - lo, O C) table of basis column ``col`` from the
        range's node gather X (P, (hi - lo) O, C, C)."""
        Y = X[..., col] * tab["incv" + which][lo * O:hi * O][None, :, None]
        return shift_slots(Y.reshape(P, hi - lo, O * C), tab[shift], lo)

    for mz0 in range(0, kappa + 1, zm):
        mlo, mhi = mz0 * plane2, min(kappa + 1, mz0 + zm) * plane2
        Ac4 = APhi[:, tab["cnode2"][mlo * O:mhi * O]]
        for kz0 in range(0, kappa, zk):
            klo, khi = kz0 * plane1, min(kappa, kz0 + zk) * plane1
            with span("stencil_chunk"):
                count("stencil.chunks", 1)
                Pc4 = Phi[:, tab["cnode1"][klo * O:khi * O]]
                pc = [side(Pc4, "1", "shift1", klo, khi, d)
                      for d in range(C)]
                del Pc4
                M3blk = M3[klo:khi, mlo:mhi].reshape(-1, S)
                for f in range(C):
                    Ac_f = side(Ac4, "2", "shift2", mlo, mhi, f).mul_(own_oc)
                    for d in range(C):
                        Tk = pc[d] @ Ac_f.mT               # (E, kc, mc)
                        G2 = shift_slots(Tk, tab["shift_rows"], klo)
                        del Tk
                        A_st[:, d, f] += G2.reshape(Q, -1) @ M3blk
                        del G2
                    del Ac_f
                del pc
        del Ac4
    return A_st.permute(0, 3, 1, 2).contiguous()


def dense_placement(stencil_nbr: np.ndarray, stencil_valid: np.ndarray,
                    device):
    """Placement of the valid stencil slots in the dense coarse matrix:
    every valid (row q, slot k) is the distinct block (q, nbr[q, k]).
    Returns (q, k, col) index tensors."""
    q, k = np.nonzero(stencil_valid)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (q, k, stencil_nbr[q, k]))


def coarse_dense_matrix(A_st, placement, n_cols: int | None = None
                        ) -> torch.Tensor:
    """Dense (P C, P C) coarse operator from the stencil blocks (P, S, C, C)
    (one static, collision-free scatter of C x C blocks); on a rank's rows
    of A_st (Q, S, C, C) and their placement, its (Q C, n_cols C) rows."""
    q, k, col = placement
    Q, C = A_st.shape[0], A_st.shape[-1]
    P = Q if n_cols is None else n_cols
    dense = A_st.new_zeros((Q, C, P, C))
    dense[q, :, col, :] = A_st[q, k]
    return dense.reshape(Q * C, P * C)


def coarse_matvec_with(A_st, u, nbr: torch.Tensor, valid: torch.Tensor):
    """Stencil matvec A_LOD u: u (P, C) -> (P, C), neighbour values
    gathered per stencil slot (zero off the lattice)."""
    u_nb = u[nbr] * valid[:, :, None].to(u.dtype)           # (P, S, C)
    return torch.einsum("psde,pse->pd", A_st, u_nb)
