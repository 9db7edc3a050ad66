"""On the card: one short run of each cell through the benchmark's command,
correct and with its metrics. Skips without a CUDA device."""

import json
import subprocess
import sys

import pytest
import torch

from portbench.harness import cell

CELLS = [w["name"] for w in cell.load_json(cell.ROOT / "BENCHMARK.json")
         ["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         "3000000019", "--seconds", "2", "--trace", "0"],
        cwd=cell.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert "setup_s" in res["metrics"]
