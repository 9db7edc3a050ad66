"""k3_roofline (%, device trace): K3's device time in the traced window
against the least time of its panels: every launch of a fit cell factors
and inverts the (restarts, b, b) diagonal panels of one block column."""

from portbench.harness import roofline, work


def read(run):
    s = work.fit_shape(run)
    return work.fit_roofline(run, work.K3, roofline.k3(s["lanes"], s["b"]))
