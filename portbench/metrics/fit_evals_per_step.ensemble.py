"""fit_evals_per_step.ensemble: fit_evals_per_step (metrics/fit_evals_per_step.py) in the ensemble fit cells, whose
host-paced spread would set a loose bound for the single-design fit's."""

from portbench.harness import cell

read = cell.load_module(cell.HERE / "metrics" / "fit_evals_per_step.py").read
