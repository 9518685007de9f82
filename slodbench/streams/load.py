"""One coefficient field, its basis and coarse operator built in set-up;
a new fine load vector every solve through the port's load-case entry
(``examples/multi_rhs.py: serve_fn``: the direct solve where the coarse
system fits ``coarse_dense_cap``, CG beyond), then
``prolong_lod_solution()``."""


def draw(inputs, i: int):
    return inputs.load(i)


class Stream:
    def __init__(self, solver, inputs):
        from dealii_slod_tpu_torch.examples.multi_rhs import serve_fn
        self.s = solver
        solver.assemble_fine_rhs()
        solver.compute_basis(inputs.field(0, setup=True))
        solver.assemble_coarse_operator()
        fits = solver.topo.n_patches * solver.C <= solver.cfg.coarse_dense_cap
        self.serve = serve_fn(solver, "direct" if fits else "cg")

    def solve(self, f):
        self.s.coarse_solution = self.serve(f)
        return self.s.prolong_lod_solution()

    def traced(self, f, span, counters):
        with span("coarse_solve"):
            self.s.coarse_solution = self.serve(f)
        with span("prolong"):
            return self.s.prolong_lod_solution()


def reference(ref, conf: dict, inputs, indices) -> list:
    """The reference's fields of the solves ``indices``: one basis of the
    set-up field, a new load each."""
    ref.build(inputs.field(0, setup=True))
    return [ref.solve(inputs.load(i)).double().cpu() for i in indices]
