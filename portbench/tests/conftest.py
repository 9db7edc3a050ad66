"""Tiny configurations of the cells, for runs on the CPU."""

import copy
import sys
import pathlib

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from portbench.harness import cell  # noqa: E402

# the same shapes' kinds at a size the CPU runs in seconds: config 4 keeps
# its K3 route (N above pallas_cholesky_max_n, panels of cholesky_block)
TINY = {
    "c4_large_n": {"data": {"n": 256},
                   "gp": {"cholesky_block": 64, "pallas_cholesky_max_n": 64,
                          "max_opt_steps": 12, "predict_query_chunk": 64}},
    "c5_ensemble": {"data": {"members": 16}, "gp": {"max_opt_steps": 15}},
}
TINY_TRAFFIC = {"serve_loop": {"requests": [[4, 40], [8, 1], [300, 2]],
                               "pool": 2048}}


def tiny_run(cell_name: str, seed: int, trace: bool = False,
             seconds: float = 0.2) -> cell.Run:
    wl = cell.load_json(cell.HERE / "workloads" / f"{cell_name}.json")
    cfg = copy.deepcopy(cell.load_json(cell.HERE / "configs"
                                       / f"{wl['config']}.json"))
    for key, over in TINY[wl["config"]].items():
        cfg[key].update(over)
    run = cell.new_run(cell_name, seed, seconds, trace, "cpu", config=cfg)
    run.traffic = dict(run.traffic,
                       **TINY_TRAFFIC.get(run.traffic["driver"], {}))
    # the tiny runs draw every input from the test's seed: a traffic's
    # fixed inputs are chosen at the cell's own size
    for key in ("data_seed", "starts_seed"):
        run.traffic.pop(key, None)
    return run


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
