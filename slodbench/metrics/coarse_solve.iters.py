"""coarse_solve.iters: coarse CG iterations per solve (the solver's own
``coarse_cg.n_iter``), the mean over the traced solves (None where no
solve ran CG)."""


def read(ctx):
    v = ctx["counters"].get("coarse_solve.iters")
    return sum(v) / len(v) if v else None
