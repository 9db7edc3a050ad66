"""The PyTorch and CUDA port's benchmark: one cell of BENCHMARK.json a run
(`portbench/run.py`); see portbench/README.md."""
