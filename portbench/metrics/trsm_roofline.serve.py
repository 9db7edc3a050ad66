"""trsm_roofline.serve (%, device trace): the device time of what the
library's triangular solves (aten::linalg_solve_triangular) launched in the
traced window, against n^2 m operations and the bytes of L's triangle and
of the right-hand side of each request of m points."""

from portbench.harness import roofline, work


def read(run):
    s = work.serve_shape(run)
    return work.serve_roofline(run, work.TRSM_OP,
                               lambda m: roofline.trsm(s["n"], m), by_op=True)
