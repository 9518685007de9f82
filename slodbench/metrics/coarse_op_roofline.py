"""coarse_op_roofline: the stencil build's share of its roofline, in %:
the least time of its contract work a solve (``roofline_coarse.
coarse_op_work``: phi and A phi read once, A_st written once, the
contraction over each stencil pair's support overlap) over the
device-busy time inside the ``coarse_op`` spans a solve.  None where no
coarse_op span ran."""

import roofline_coarse as rc


def read(ctx):
    conf = ctx["conf"]
    least = rc.least_s(conf, rc.coarse_op_work(**rc.args(conf)))
    return rc.share(ctx, "coarse_op", least)
