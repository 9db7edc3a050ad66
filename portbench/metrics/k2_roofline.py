"""k2_roofline (%, device trace): K2's device time in the traced window
against the least time of its factors: every launch of a fit cell factors
the (lanes, n, n) Grams."""

from portbench.harness import roofline, work


def read(run):
    s = work.fit_shape(run)
    return work.fit_roofline(run, work.K2, roofline.k2(s["lanes"], s["n"]))
