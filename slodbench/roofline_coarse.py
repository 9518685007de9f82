"""Operation and byte counts of the coarse layers' contract work, for the
``coarse_op_roofline`` and ``coarse_solve_roofline`` metrics.

The least time of a layer's work is ``roofline.by`` of its FLOPs and
bytes against the card's peaks for the configuration's type: every value
that can be nonzero read once, every output written once.  A patch's
basis function phi lives on the interior nodes of its own window (the
coarse cells within ``ell`` of it, clipped to the domain), and A phi on
the window's nodes inside the domain; nothing counts the canvas padding,
the build's (P, K, K2) intermediate, its 0/1 indicator product, or the
neighbour and validity tables, which are implementation choices.

Each count is a product over the axes of sums over one axis: a window is
a box, and the stencil's neighbours of a patch are the box of patches
within 2 ``ell`` of it."""

from __future__ import annotations

import numpy as np

import roofline


def axis_supports(n_coarse: int, s: int, ell: int):
    """Per coarse cell c of one axis: the node ranges [a, b] (inclusive)
    of phi_c (its window's interior) and of A phi_c (its window's nodes
    inside the domain)."""
    c = np.arange(n_coarse)
    lo = np.clip(c - ell, 0, None)
    hi = np.clip(c + ell, None, n_coarse - 1)
    phi = (lo * s + 1, (hi + 1) * s - 1)
    aphi = (np.maximum(lo * s, 1), np.minimum((hi + 1) * s, n_coarse * s - 1))
    return phi, aphi


def axis_sums(n_coarse: int, s: int, ell: int) -> dict:
    """One axis's sums: ``phi`` and ``aphi`` the support sizes over the
    patches, ``overlap`` the overlaps of phi_q with A phi_p over every
    stencil pair (|p - q| <= 2 ell)."""
    (pa, pb), (aa, ab) = axis_supports(n_coarse, s, ell)
    q, p = np.meshgrid(np.arange(n_coarse), np.arange(n_coarse),
                       indexing="ij")
    ov = np.minimum(pb[q], ab[p]) - np.maximum(pa[q], aa[p]) + 1
    ov = np.where(np.abs(p - q) <= 2 * ell, np.clip(ov, 0, None), 0)
    return dict(phi=int((pb - pa + 1).sum()), aphi=int((ab - aa + 1).sum()),
                overlap=int(ov.sum()))


def _sums(dim, n_coarse, s, ell):
    one = axis_sums(n_coarse, s, ell)
    return {k: v ** dim for k, v in one.items()}


def stencil_size(dim: int, ell: int) -> int:
    """Slots S of A_st a patch, (4 ell + 1)^dim."""
    return (4 * ell + 1) ** dim


def coarse_op_work(dim: int, n_coarse: int, s: int, ell: int, C: int,
                   itemsize: int = 4):
    """(FLOPs, bytes) of A_st[q, p] = sum_g phi_q(g) . (A phi_p)(g) for
    every patch q and stencil neighbour p: the contraction over each
    fine node of the two supports' overlap (each node once, by the cell
    that owns it; 2 C^3 a node: components d, f, summed over c); phi and
    A phi read once, A_st (P, S, C, C) written once."""
    sm = _sums(dim, n_coarse, s, ell)
    P = n_coarse ** dim
    flops = 2.0 * C ** 3 * sm["overlap"]
    nbytes = itemsize * (C * C * (sm["phi"] + sm["aphi"])
                         + P * stencil_size(dim, ell) * C * C)
    return flops, nbytes


def coarse_solve_work(dim: int, n_coarse: int, s: int, ell: int, C: int,
                      iterations: float, itemsize: int = 4):
    """(FLOPs, bytes) of the coarse solve: C^T f (phi and the load on
    phi's support read once, the coarse rhs written), then per issued CG
    iteration the stencil matvec (A_st (P, S, C, C) and u read, A u
    written) and the CG's vectors x, r and p read and written once."""
    sm = _sums(dim, n_coarse, s, ell)
    P, S = n_coarse ** dim, stencil_size(dim, ell)
    rhs_flops = 2.0 * C * C * sm["phi"]
    rhs_bytes = itemsize * (C * C * sm["phi"] + C * sm["phi"] + P * C)
    it_flops = 2.0 * P * S * C * C
    it_bytes = itemsize * (P * S * C * C + 2 * P * C + 6 * P * C)
    return (rhs_flops + iterations * it_flops,
            rhs_bytes + iterations * it_bytes)


def args(conf: dict) -> dict:
    """The work functions' shape arguments for a configuration file."""
    st = conf["settings"]
    return dict(dim=st["dim"], n_coarse=2 ** st["n_global_refinements"],
                s=st["n_subdivisions"], ell=st["oversampling"],
                C=st["dim"] if conf["problem"] == "elasticity" else 1,
                itemsize=roofline.itemsize(conf))


def least_s(conf: dict, work) -> float:
    """The least time (s) of ``work`` = (FLOPs, bytes) against the card's
    peaks for the configuration's type."""
    peak = roofline.PEAK_FLOPS_BY_ITEMSIZE[roofline.itemsize(conf)]
    return roofline.by(*work, peak)[0] / 1e3


def share(ctx, layer: str, least: float):
    """100 x the least time a solve over the device-busy time inside the
    benchmark's ``layer`` spans a solve; None where no such span ran or
    the device was idle in it."""
    busy = ctx["trace"]["busy_in"].get(layer)
    spans = ctx["spans"].get(layer)
    if not busy or not spans:
        return None
    return 100.0 * least / (busy / len(spans))
