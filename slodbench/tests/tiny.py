"""Small configurations of the cells for CPU tests."""

import copy


def tiny(conf: dict, dim: int = 2, refine: int = 3, dtype=None,
         ell: int = 2) -> dict:
    """The configuration cut to ``dim``-D, 2^refine coarse cells per axis,
    oversampling ``ell``, the smallk stage named (the CPU's "auto" is
    eigh), whole-batch chunks,
    and the per-patch Cholesky solve for elasticity (the Schur split's
    plain version is slow on a CPU)."""
    c = copy.deepcopy(conf)
    st = c["settings"]
    C = dim if c["problem"] == "elasticity" else 1
    st.update(dim=dim, n_global_refinements=refine, coef_refinement=refine + 1,
              oversampling=ell, eig_solver="smallk", patch_chunk=0,
              rhs="; ".join(["1"] * C))
    if dtype:
        st["dtype"] = dtype
    if C > 1:
        st["patch_solver"] = "lax"
    c["coefficients"]["refinement"] = refine + 1
    return c
