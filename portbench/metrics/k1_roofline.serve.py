"""k1_roofline.serve (%, device trace): K1's device time in the traced
window against the least time of the requests' cross covariances: one
(n, m) block a request of m points, its inputs read once."""

from portbench.harness import roofline, work


def read(run):
    s = work.serve_shape(run)
    return work.serve_roofline(
        run, work.K1,
        lambda m: roofline.k1(1, s["n"], m, s["d"], gram=False))
