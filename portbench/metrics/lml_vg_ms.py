"""lml_vg_ms (ms, host clock, a span of the benchmark's own): one value and
gradient of `models.gp.log_marginal_likelihood` on the cell's data at the
cell's batch of lanes, at the hyperparameters the last fit reached, after
the window and outside the profiler: host clock to synchronize(), over
repeats that span 0.3 s or more."""


def read(run):
    return run.record.get("lml_vg_ms")
