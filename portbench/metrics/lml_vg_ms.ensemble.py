"""lml_vg_ms.ensemble: lml_vg_ms (metrics/lml_vg_ms.py) in the ensemble fit cells, whose
host-paced spread would set a loose bound for the single-design fit's."""

from portbench.harness import cell

read = cell.load_module(cell.HERE / "metrics" / "lml_vg_ms.py").read
