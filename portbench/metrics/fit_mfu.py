"""fit_mfu (%): the operations the window's objective evaluations need
(harness/roofline.py: n^3 and its O(n^2 d) terms a lane's value and
gradient, n^3/3 and its terms a value alone) over the window's time at the
card's FP32 peak (67 TFLOP/s). The count depends on n, d and the program's
evaluation counts only, not on how the program computes them."""

from portbench.harness import roofline, work


def read(run):
    r = run.record
    if not r.get("fits"):
        return None
    s = work.fit_shape(run)
    flops = s["lanes"] * (
        r["n_vg"] * roofline.lml_vg_flops(s["n"], s["d"], s["p"])
        + r["n_v"] * roofline.lml_value_flops(s["n"], s["d"], s["p"]))
    return 100.0 * flops / (run.window_s * roofline.H100_FP32_FLOPS)
