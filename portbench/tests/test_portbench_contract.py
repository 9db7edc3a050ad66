"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by name."""

import re
import subprocess
import sys

import pytest
import torch

from portbench.harness import cell

BENCH = cell.load_json(cell.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((cell.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200
                    assert "\n" not in e[text] and "\t" not in e[text]
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    wl = cell.load_json(cell.HERE / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips", "why"):
        assert wl[key] == entry[key], key
    cfg_entry = next(c for c in BENCH["configs"]
                     if c["name"] == entry["config"])
    cfg = cell.load_json(cell.ROOT / cfg_entry["file"])
    assert cfg["name"] == cfg_entry["name"]
    assert cfg["source"] == cfg_entry["source"]
    assert cfg["reduced"] == cfg_entry["reduced"]
    traffic = cell.load_json(cell.HERE / "traffic" / f"{entry['traffic']}.json")
    assert (cell.HERE / "drivers" / f"{traffic['driver']}.py").exists()
    assert (cell.HERE / "data" / f"{cfg['data']['kind']}.py").exists()
    if traffic["driver"] == "fit_loop":
        drv = cell.load_module(cell.HERE / "drivers" / "fit_loop.py")
        assert cfg["fit"]["entry"] in drv.ENTRIES
    for kind in ("end_to_end", "per_layer"):
        run = cell.Run(name, wl, cfg, traffic, 0, 1.0, kind == "per_layer",
                       None)
        metrics = cell.cell_metrics(run)
        assert metrics, kind
        for m in metrics:
            assert (cell.HERE / "metrics" / f"{m['name']}.py").exists()
    e2e = {m["name"] for m in cell.cell_metrics(
        cell.Run(name, wl, cfg, traffic, 0, 1.0, False, None))}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in cell.cell_metrics(cell.Run(name, wl, cfg, traffic, 0, 1.0, True,
                                        None)):
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_every_config_used_and_listed_in_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("portbench/")


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_check_limits_named_by_every_cell():
    for name in CELLS:
        wl = cell.load_json(cell.HERE / "workloads" / f"{name}.json")
        assert wl["limits"] and all(v >= 0 for v in wl["limits"].values())


def test_run_without_a_card_prints_no_result():
    """Without a CUDA device a run exits with another code than 0 and
    prints nothing on standard output (the CPU is never a fallback)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 33 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cell.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_every_file_is_used_by_a_cell_or_a_metric():
    """No configuration, data recipe, traffic mix, driver, cell or metric
    reader lies in the benchmark's folders without a cell that runs it."""
    used = {("metrics", m["name"])
            for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for w in BENCH["workloads"]:
        traffic = cell.load_json(cell.HERE / "traffic" / f"{w['traffic']}.json")
        cfg = cell.load_json(cell.HERE / "configs" / f"{w['config']}.json")
        used |= {("workloads", w["name"]), ("traffic", w["traffic"]),
                 ("configs", w["config"]), ("drivers", traffic["driver"]),
                 ("data", cfg["data"]["kind"])}
    for sub in ("workloads", "traffic", "configs", "drivers", "data",
                "metrics"):
        for f in (cell.HERE / sub).iterdir():
            if f.suffix in (".json", ".py") and f.name != "__init__.py":
                assert (sub, f.name[:-len(f.suffix)]) in used, f
