"""basis_roofline: the basis stage's share of its roofline, in %: the
least time of the stage's contract work per solve (``roofline.
basis_work``: every patch at its own window, unpadded, against the
card's peaks for the configuration's type) over the device-busy time
inside the ``basis`` spans per solve.  None where no basis span ran."""

import roofline


def read(ctx):
    busy = ctx["trace"]["busy_in"].get("basis")
    if not busy or not ctx["spans"].get("basis"):
        return None
    flops, nbytes = roofline.basis_work(**roofline.basis_args(ctx["conf"]))
    itemsize = roofline.itemsize(ctx["conf"])
    t = roofline.by(flops, nbytes, roofline.PEAK_FLOPS_BY_ITEMSIZE[itemsize])
    return 100.0 * t[0] / 1e3 / (busy / len(ctx["spans"]["basis"]))
