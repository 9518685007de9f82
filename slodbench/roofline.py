"""Operation and byte counts, and the card's peaks, for the roofline
metrics.

``by`` and the kernel formulas are the arithmetic that gave the bounds of
the port's kernel table (PERF.md): the least time of a kernel's work is
the larger of its FLOPs over the compute peak and its bytes over the
memory bandwidth, each input read once and each output written once.
``launch_work`` reads a hand kernel's sizes from its launch arguments;
``basis_work`` counts the basis stage's contract at every patch's own
window, unpadded, which is the least any implementation of the stage has
to do."""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM published peaks: float32 outside the tensor cores (and
# float64 on them), HBM3 bandwidth
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the fastest float32-accurate products on the card: 3xTF32 on the tensor
# cores (495 / 3 TFLOP/s); a float32 kernel's share is read against it, a
# float64 kernel's against the float64 tensor-core rate
PEAK_FLOPS_BY_ITEMSIZE = {4: 495e12 / 3, 8: 67e12}


def by(flops: float, nbytes: float, peak: float = PEAK_FLOPS):
    """The least time (ms) of work of ``flops`` operations moving
    ``nbytes`` bytes, and what bounds it."""
    t_f, t_b = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_f, "operations") if t_f >= t_b else (t_b, "bytes")


def sweep_flops(sweeps: float, n: int, matrices: int = 1) -> float:
    """One-sided Jacobi on n x n rows: per sweep the row norms (2 n^2) and
    n - 1 rounds of n / 2 pair dots and rotations (4 n^2 (n - 1)), plus the
    initial norms."""
    return (sweeps * (2 * n * n + 4 * n * n * (n - 1)) * matrices
            + 2 * n * n * matrices)


def k1_work(B, n, k, f=4):
    """SPD multi-rhs solve with T = B^T X (K1): LDL^T, two sweeps, T."""
    return (B * (n ** 3 / 3 + 2 * n * n * k + 2 * n * k * k),
            B * f * (n * n + 2 * n * k + k * k))


def k6_work(B, n, k, f=4):
    """SPD multi-rhs solve alone (K6)."""
    return B * (n ** 3 / 3 + 2 * n * n * k), B * f * (n * n + 2 * n * k)


def k2_work(B, m, f=4):
    """Gauss-Jordan inverse of m x m matrices (K2)."""
    return B * 2 * m ** 3, B * f * 2 * m * m


def trace_work(B, C, nN, nNp, k, n_off, f=4):
    """Banded stencil product over nN nodes, n_off offsets, k columns (K3
    at C = 1, K7)."""
    return (B * nN * k * 2 * n_off * C * C,
            B * f * (nN * n_off * C * C + C * nNp * k + C * nN * k))


def k4_work(B, n, k, f=4):
    """Two-pass modified Gram-Schmidt thin Q of n x k (K4)."""
    return B * 4 * n * k * k, B * f * 2 * n * k


def k5_work(B, n, f=4, sweeps=1):
    """Jacobi eigenpairs of n x n rows (K5), ``sweeps`` sweeps."""
    return sweep_flops(sweeps, n, B), B * f * 2 * n * n


def k8_work(B, k, n, f=4, sweeps=1):
    """W = Z^T Y built (2 k^2 n) and swept (K8)."""
    return (B * 2.0 * k * k * n + sweep_flops(sweeps, k, B),
            B * f * (2 * k * n + k * k + k))


def launch_work(entry: str, itemsize: int, args: tuple):
    """(FLOPs, bytes) of one launch of the C entry point ``entry`` from its
    arguments (pointers first, then sizes, as ``utils/kernels.py``'s
    signatures).  Jacobi sweeps count one sweep a matrix, the least any
    input needs.  None for an entry this table does not know."""
    f = itemsize
    if entry == "slod_fused_spd_multirhs":
        B, n, k = args[4:7]
        return k1_work(B, n, k, f)
    if entry == "slod_spd_multirhs_solve":
        B, n, k = args[3:6]
        return k6_work(B, n, k, f)
    if entry == "slod_gj_inverse":
        return k2_work(args[2], args[3], f)
    if entry == "slod_stencil_trace":
        B, C, nN, nNp, k, n_off = args[3:9]
        return trace_work(B, C, nN, nNp, k, n_off, f)
    if entry == "slod_mgs_qr":
        B, n, k = args[3:6]
        return k4_work(B, n, k, f)
    if entry == "slod_jacobi_rows":
        B, n = args[7:9]
        return k5_work(B, n, f)
    if entry == "slod_weig":
        B, k, n = args[6:9]
        return k8_work(B, k, n, f)
    return None


def launch_bound_s(entry: str, itemsize: int, args: tuple):
    """The least time (s) of one launch, against the peaks of its type."""
    work = launch_work(entry, itemsize, args)
    if work is None:
        return None
    return by(*work, PEAK_FLOPS_BY_ITEMSIZE[itemsize])[0] / 1e3


# ---------------------------------------------------------------------------
# the basis stage's contract
# ---------------------------------------------------------------------------

def _lex(dims):
    grids = np.meshgrid(*[np.arange(int(d)) for d in dims[::-1]],
                        indexing="ij")
    return np.stack([g.reshape(-1) for g in grids[::-1]], axis=-1)


def basis_parts(dim: int, n_coarse: int, s: int, ell: int, C: int,
                slod: bool = True, dirs: int = 32, power: int = 3,
                n_coefs: int = 1, itemsize: int = 4) -> dict:
    """The basis stage's work, part by part, summed over every patch at
    its own window (unpadded): name -> (FLOPs, bytes).

    - ``patch_solve``: Cholesky of the nI x nI interior block (nI^3 / 3),
      X = A^-1 PT (2 nI^2 cD), T = PT^T X (2 nI cD^2);
    - ``t_inverse``: T^-1 (cD^3, an SPD inverse);
    - ``trace``: S = A X on the patch-boundary rows (2 n99 C 3^dim C cD)
      and A phi on every window node (2 nN C 3^dim C C);
    - ``grams``: BD = (S - PT_b) T^-1 (2 n99 C cD^2), F = BD^T BD
      (n99 C cD^2, one triangle);
    - ``g_inverse``: (G + delta I)^-1 and d0, per component (cD^3 + 2 cD^2);
    - ``qr``: per component and subspace step, (G + delta I)^-1 Z
      (2 cD^2 k) and the thin Q (4 cD k^2);
    - ``w_eig``: W = Z^T G Z (2 cD^2 k + 2 cD k^2), one Jacobi sweep on W,
      V = Z U (2 cD k^2);
    - ``candidates``: T^-1 D (2 cD^2 C), X (T^-1 D) (2 nI cD C).

    Bytes: the coefficient windows read once, phi and A phi written once.
    k is ``dirs`` beyond 64 coarse dofs (the float32 rule), else cD."""
    centers = _lex([n_coarse] * dim)
    lo = np.clip(centers - ell, 0, None)
    hi = np.clip(centers + ell, None, n_coarse - 1)
    shape = hi - lo + 1
    lo_in = lo > 0                      # patch sides inside the domain
    hi_in = hi < n_coarse - 1
    keys, counts = np.unique(np.concatenate([shape, lo_in, hi_in], axis=1),
                             axis=0, return_counts=True)
    stencil = 3 ** dim * C
    parts = dict.fromkeys(("patch_solve", "t_inverse", "trace", "grams",
                           "g_inverse", "qr", "w_eig", "candidates"), 0.0)
    nbytes = 0.0
    for key, cnt in zip(keys, counts):
        sh = key[:dim]
        li, hi_ = key[dim:2 * dim].astype(bool), key[2 * dim:].astype(bool)
        nd = sh * s + 1
        nN = int(nd.prod())
        nI = int((nd - 2).prod()) * C
        cD = int(sh.prod()) * C
        nodes = _lex(nd)
        n99 = int(((nodes == 0) & li | (nodes == nd - 1) & hi_).any(-1)
                  .sum()) * C
        k = cD if cD <= 64 else min(dirs, cD)
        k -= k % 2
        p = {"patch_solve": nI ** 3 / 3 + 2 * nI * nI * cD
                            + 2 * nI * cD * cD,
             "t_inverse": cD ** 3,
             "trace": 2 * nN * C * stencil * C,
             "candidates": 2 * cD * cD * C + 2 * nI * cD * C}
        if slod and cD < n_coarse ** dim * C:
            p["trace"] += 2 * n99 * stencil * cD
            p["grams"] = 3 * n99 * cD * cD
            p["g_inverse"] = C * (cD ** 3 + 2 * cD * cD)
            p["qr"] = C * power * (2 * cD * cD * k + 4 * cD * k * k)
            p["w_eig"] = C * (2 * cD * cD * k + 2 * cD * k * k
                              + sweep_flops(1, k) + 2 * cD * k * k)
        for name, v in p.items():
            parts[name] += cnt * v
        n_sub = int((sh * s).prod())
        nbytes += cnt * itemsize * (n_sub * 2 ** dim * n_coefs
                                    + 2 * nN * C * C)
    return {name: (v, nbytes if name == "patch_solve" else 0.0)
            for name, v in parts.items()}


def basis_work(**kw):
    """(FLOPs, bytes) of the whole basis stage (``basis_parts`` summed)."""
    parts = basis_parts(**kw)
    return (sum(v[0] for v in parts.values()),
            sum(v[1] for v in parts.values()))


def itemsize(conf: dict) -> int:
    return 8 if conf["settings"]["dtype"] == "float64" else 4


def basis_args(conf: dict) -> dict:
    """``basis_parts``'s arguments for a configuration file's settings:
    float32 keeps ``smallk_dirs`` directions, float64 every one."""
    st = conf["settings"]
    return dict(dim=st["dim"], n_coarse=2 ** st["n_global_refinements"],
                s=st["n_subdivisions"], ell=st["oversampling"],
                C=st["dim"] if conf["problem"] == "elasticity" else 1,
                slod=st["lod_stabilization"],
                dirs=st["smallk_dirs"] if itemsize(conf) == 4 else 2 ** 30,
                power=st["smallk_power"],
                n_coefs=len(conf["coefficients"]["names"]),
                itemsize=itemsize(conf))
