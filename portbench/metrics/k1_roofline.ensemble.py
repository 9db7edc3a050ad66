"""k1_roofline.ensemble: k1_roofline.fit (metrics/k1_roofline.fit.py) in
the ensemble fit cells, which report fit_step_ms.ensemble."""

from portbench.harness import cell

read = cell.load_module(cell.HERE / "metrics" / "k1_roofline.fit.py").read
