"""Stencil-form coarse operator (counterpart of ``dealii_slod_tpu/models/
stencil.py``): ``A_LOD[q, p] = phi_q . (A phi_p)`` (reference
``assemble_global_matrix``, source/LOD.cc:860-973) as a (P, S, C, C)
stencil over relative window offsets, built cell by cell from the basis
canvases, and the coarse matvec that drives the CG.  Scalar problems
(C = 1)."""

from __future__ import annotations

import numpy as np
import torch

from dealii_slod_tpu.grid import cartesian_coords, ravel


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
                device, dtype):
    """Static gather of the slot-indexed lattice shift (``_shift_slots``)
    of an (E, slots, rest) table: sign=+1: out[e, k] = X[e + (ell - k), k];
    sign=-1: out[q, k] = X[q + (k - ell), k]; zero where the shifted cell
    leaves the lattice.  Returns (source rows (E, slots), validity)."""
    cells = cartesian_coords(np.full(dim, N))
    slots = cartesian_coords(np.full(dim, slot_dims))
    src = cells[:, None, :] + sign * (ell - slots[None, :, :])
    valid = ((src >= 0) & (src < N)).all(-1)
    src_flat = ravel(np.clip(src, 0, N - 1), np.full(dim, N))
    return (torch.as_tensor(src_flat, device=device),
            torch.as_tensor(valid, dtype=dtype, device=device))


def shift_slots(X, index):
    """Apply a ``shift_index`` gather to X (E, slots, rest...)."""
    src, valid = index
    k = torch.arange(X.shape[1], device=X.device)[None, :]
    return X[src, k] * valid[(...,) + (None,) * (X.dim() - 2)]


def stencil_tables(cfg, grid, canvas_dims, stencil_offsets, device,
                   dtype) -> dict:
    """``cell_tables`` and ``slot_match_matrix`` as device tensors, with
    the three lattice-shift gathers of the build."""
    tab = cell_tables(cfg, grid, canvas_dims, stencil_offsets)
    N, dim, ell = cfg.n_coarse, cfg.dim, cfg.oversampling
    kappa = 2 * ell + 1
    out = dict(K=tab["K"], K2=tab["K2"], O=tab["O"])
    for w in ("1", "2"):
        out["cnode" + w] = torch.as_tensor(tab["cnode" + w].reshape(-1),
                                           device=device)
        out["incv" + w] = torch.as_tensor(tab["incv" + w].reshape(-1),
                                          dtype=dtype, device=device)
    out["own"] = torch.as_tensor(tab["own"], dtype=dtype, device=device)
    out["shift1"] = shift_index(N, dim, ell, kappa, 1, device, dtype)
    out["shift2"] = shift_index(N, dim, ell, kappa + 1, 1, device, dtype)
    out["shift_rows"] = shift_index(N, dim, ell, kappa, -1, device, dtype)
    out["M3"] = torch.as_tensor(
        slot_match_matrix(tab, len(stencil_offsets)), dtype=dtype,
        device=device)
    return out


def stencil_build_cells(Phi, APhi, tab: dict):
    """Cell-decomposed stencil build (``_stencil_build_cells``) with the
    ``stencil_tables`` ``tab``:

    1. canvas picks Y[q, (k, o)] = Phi_q[cnode(k, o)] per side,
    2. lattice alignment Pc[e, k, o] = Y[e + (ell - k), k, o],
    3. owned-node contraction T[e, k, m] = sum_o Pc[e, k, o] Ac[e, m, o],
    4. patch rows G2[q, k1] = T[q + (k1 - ell), k1],
    5. slot correlation as one 0/1 matmul -> A_st (P, S, 1, 1)."""
    P = Phi.shape[0]
    K, K2, O = tab["K"], tab["K2"], tab["O"]

    def side_table(X, which, shift):
        Y = X.reshape(P, -1)[:, tab["cnode" + which]] * tab["incv" + which]
        return shift_slots(Y.reshape(P, -1, O), tab[shift])

    Pc = side_table(Phi, "1", "shift1")                    # (E, K, O)
    # owned-node mask on one side only (idempotent in the product)
    Ac = side_table(APhi, "2", "shift2") * tab["own"][:, None, :]
    Tk = Pc @ Ac.mT                                        # (E, K, K2)
    G2 = shift_slots(Tk, tab["shift_rows"])
    A_st = G2.reshape(P, K * K2) @ tab["M3"]
    return A_st.reshape(P, -1, 1, 1)


def dense_placement(stencil_nbr: np.ndarray, stencil_valid: np.ndarray,
                    device):
    """Placement of the valid stencil slots in the dense (P, P) coarse
    matrix: every valid (row q, slot k) is the distinct entry
    (q, nbr[q, k]).  Returns (q, k, col) index tensors."""
    q, k = np.nonzero(stencil_valid)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (q, k, stencil_nbr[q, k]))


def coarse_dense_matrix(A_st, placement) -> torch.Tensor:
    """Dense (P, P) coarse operator from the stencil blocks (one static,
    collision-free scatter)."""
    q, k, col = placement
    P = A_st.shape[0]
    dense = A_st.new_zeros((P, P))
    dense[q, col] = A_st[q, k, 0, 0]
    return dense


def coarse_matvec_with(A_st, u, nbr: torch.Tensor, valid: torch.Tensor):
    """Stencil matvec A_LOD u: u (P, C) -> (P, C), neighbour values
    gathered per stencil slot (zero off the lattice)."""
    u_nb = u[nbr] * valid[:, :, None].to(u.dtype)           # (P, S, C)
    return torch.einsum("psde,pse->pd", A_st, u_nb)
