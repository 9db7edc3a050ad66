"""device_idle.ensemble: device_idle.fit (metrics/device_idle.fit.py) in
the ensemble fit cells, which report fit_step_ms.ensemble."""

from portbench.harness import cell

read = cell.load_module(cell.HERE / "metrics" / "device_idle.fit.py").read
