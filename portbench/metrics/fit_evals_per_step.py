"""fit_evals_per_step (program counter): the objective evaluations (value
and gradient, and value alone) per optimizer step over the window's fits,
from each fit's `FitResult.stats` (n_vg_calls + n_v_calls over n_steps)."""


def read(run):
    r = run.record
    if not r.get("n_steps"):
        return None
    return (r["n_vg"] + r["n_v"]) / r["n_steps"]
