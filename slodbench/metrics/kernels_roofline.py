"""kernels_roofline: the hand kernels' share of their roofline, in %:
the sum over every launch through ``utils/kernels.launch`` in the traced
window of its least time (``roofline.launch_bound_s``: its work from its
launch sizes, against the card's peaks for its type) over the sum of
those launches' device time.  None where no hand kernel ran."""

import roofline


def read(ctx):
    bound = dev = 0.0
    for (entry, itemsize, args), t in zip(ctx["records"],
                                          ctx["trace"]["launch_s"]):
        b = roofline.launch_bound_s(entry, itemsize, args)
        if b is None or t is None:
            continue
        bound += b
        dev += t
    return 100.0 * bound / dev if dev > 0 else None
