"""basis.patch_solve.whole_pct: the share of the window's patches whose
patch solve ran as one K1 launch on the whole block, factored in place on
the padded operand the assembly wrote, in %: 100 (sum of
``patch_solve.whole_block``) / sum of ``patch_solve.patches``.  None where
no patch solve was counted: a window with no basis build, or a port that
does not count its patch solves."""

import program_trace


def read(ctx):
    patches = program_trace.counter_total("patch_solve.patches")
    if not patches:
        return None
    return 100.0 * program_trace.counter_total(
        "patch_solve.whole_block") / patches
