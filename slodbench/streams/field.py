"""A new coefficient field every solve (every coefficient the
configuration names), the configuration's own right-hand side:
``LODSolver.build_step()``'s step, then ``prolong_lod_solution()``;
traced, the public stage calls that the step makes."""


def draw(inputs, i: int):
    return inputs.field(i)


class Stream:
    def __init__(self, solver, inputs):
        self.s = solver
        self.fem_rhs = solver.assemble_fine_rhs()
        self.step = solver.build_step()

    def solve(self, coefs):
        self.step(coefs, self.fem_rhs)
        return self.s.prolong_lod_solution()

    def traced(self, coefs, span, counters):
        s = self.s
        with span("basis"):
            s.compute_basis(coefs)
        with span("coarse_op"):
            s.assemble_coarse_operator()
        with span("coarse_solve"):
            s.solve_coarse()
        with span("prolong"):
            u = s.prolong_lod_solution()
        counters.setdefault("coarse_solve.iters", []).append(
            int(s.coarse_cg.n_iter))
        return u


def reference(ref, conf: dict, inputs, indices) -> list:
    """The reference's fields of the solves ``indices``: a new basis
    each, the configuration's constant right-hand side."""
    values = [float(v) for v in conf["settings"]["rhs"].split(";")]
    f = ref.load_vector(values)
    out = []
    for i in indices:
        ref.build(inputs.field(i))
        out.append(ref.solve(f).double().cpu())
    return out
