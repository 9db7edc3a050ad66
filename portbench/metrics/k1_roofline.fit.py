"""k1_roofline.fit (%, device trace): K1's device time in the traced window
against the least time of the Grams it built: every launch of a fit cell
is one (lanes, n, n) Gram in d dimensions."""

from portbench.harness import roofline, work


def read(run):
    s = work.fit_shape(run)
    return work.fit_roofline(run, work.K1, roofline.k1(
        s["lanes"], s["n"], s["n"], s["d"], gram=True))
