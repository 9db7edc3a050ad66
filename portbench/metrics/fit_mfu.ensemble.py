"""fit_mfu.ensemble: fit_mfu (metrics/fit_mfu.py) in the ensemble fit cells, whose
host-paced spread would set a loose bound for the single-design fit's."""

from portbench.harness import cell

read = cell.load_module(cell.HERE / "metrics" / "fit_mfu.py").read
