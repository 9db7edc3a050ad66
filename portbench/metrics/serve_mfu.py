"""serve_mfu (%): the operations the window's answered query points need
(harness/roofline.py serve_point_flops: n^2 for the triangular solve, the
cross covariances, the mean, variance and GLS terms) over the window's
time at the card's FP32 peak (67 TFLOP/s)."""

from portbench.harness import roofline, work


def read(run):
    if not run.window_s:
        return None
    s = work.serve_shape(run)
    flops = run.record["points"] * roofline.serve_point_flops(s["n"], s["d"],
                                                              s["p"])
    return 100.0 * flops / (run.window_s * roofline.H100_FP32_FLOPS)
