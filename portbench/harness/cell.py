"""One run of one cell: find its files by name, set it up, measure its
window, check what the window produced against the plain reference, read
its metrics, and print the result line.

A cell `<cell>` is `portbench/workloads/<cell>.json` (its configuration,
traffic, chips, why and the limits of its checks); its configuration is
`portbench/configs/<config>.json`, its traffic `portbench/traffic/
<traffic>.json`, which names the driver `portbench/drivers/<driver>.py`;
each metric that BENCHMARK.json lists for the cell is read by
`portbench/metrics/<metric>.py`. A driver is a module with

    setup(run) -> state          everything before the window
    window(run, state)           the measured window; fills run.record
    after(run, state)            the program's calls that follow the window
    check(run, state)            the comparisons with the reference
    control(run, state)          the same numbers with the control in the
                                 program's place (portbench/control.py)

and a metric reader a module with `read(run) -> float | None`.

A `--trace 1` run measures two windows of --seconds one after the other:
the first without the profiler, from which the per-layer metrics of the
host's clock and of the program's counters are read, and then the traced
one, from which the metrics of the device trace are read; so the
profiler's own cost never reaches a host-clock reading.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import pathlib
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from portbench.harness import guard, host, tracing

HERE = pathlib.Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent  # the checkout


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    name = "portbench_" + "_".join(path.relative_to(HERE).with_suffix("")
                                   .parts).replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    cell: str
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    memory_peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    record: Dict[str, Any] = dataclasses.field(default_factory=dict)
    checks: List[Check] = dataclasses.field(default_factory=list)
    trace_data: Optional[tracing.Trace] = None
    # the traced window's record and length (--trace 1)
    traced_record: Dict[str, Any] = dataclasses.field(default_factory=dict)
    traced_window_s: Optional[float] = None
    host_noise: Dict[str, float] = dataclasses.field(default_factory=dict)

    def limit(self, name: str) -> float:
        return float(self.workload["limits"][name])

    def add_check(self, name: str, value: float) -> None:
        self.checks.append(Check(name, float(value), self.limit(name)))


def new_run(cell: str, seed: int, seconds: float, trace: bool, device,
            config: Optional[dict] = None) -> Run:
    """A Run of `cell` from its files; `config` replaces the configuration
    file's contents (the CPU tests run the cells at a tiny size)."""
    wl = load_json(HERE / "workloads" / f"{cell}.json")
    cfg = config if config is not None else load_json(
        HERE / "configs" / f"{wl['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    return Run(cell, wl, cfg, traffic, int(seed), float(seconds), bool(trace),
               torch.device(device))


def driver(run: Run):
    return load_module(HERE / "drivers" / f"{run.traffic['driver']}.py")


def cell_metrics(run: Run) -> List[dict]:
    """BENCHMARK.json's metrics that this cell reports in this kind of run:
    the end-to-end ones with --trace 0, the per-layer ones with --trace 1;
    a metric with a "workloads" key only in the cells it lists."""
    bench = load_json(ROOT / "BENCHMARK.json")
    kind = "per_layer" if run.trace else "end_to_end"
    return [m for m in bench[kind]
            if run.cell in m.get("workloads", [run.cell])]


def _sync(run: Run) -> None:
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def _measure(run: Run, drv, state, traced: bool) -> tracing.Window:
    """One window of the driver, traced or not; run.record and
    run.window_s are then that window's."""
    run.record = {}
    win = tracing.Window(traced)
    with win:
        drv.window(run, state)
        _sync(run)
    return win


def execute(run: Run, t_start: float):
    """Set up, measure, follow up and check one run; `t_start` is when the
    process began its set-up (perf_counter). Returns the driver's state
    (the control reads it)."""
    drv = driver(run)
    state = drv.setup(run)
    _sync(run)
    run.setup_s = time.perf_counter() - t_start
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    before = host.snapshot()
    _measure(run, drv, state, traced=False)
    run.host_noise = host.noise(before, host.snapshot())
    read_s = 0.0
    if run.trace:
        untraced = run.record, run.window_s
        win = _measure(run, drv, state, traced=True)
        run.trace_data, read_s = win.trace, win.read_s
        run.traced_record, run.traced_window_s = run.record, run.window_s
        run.record, run.window_s = untraced
    t = time.perf_counter()
    if run.device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(run.device))
    drv.after(run, state)
    t_after = time.perf_counter()
    drv.check(run, state)
    print(f"phases: setup {run.setup_s:.3f} s, window {run.window_s:.3f} s, "
          f"traced window {run.traced_window_s or 0.0:.3f} s, "
          f"trace read {read_s:.3f} s, after {t_after - t:.3f} s, "
          f"check {time.perf_counter() - t_after:.3f} s", file=sys.stderr)
    print("host during the window: " + ", ".join(
        f"{k} {v:.6g}" for k, v in run.host_noise.items()), file=sys.stderr)
    return state


def read_metrics(run: Run) -> Dict[str, dict]:
    """The cell's metrics of this kind of run. A device-trace metric reads
    the traced window, every other metric the untraced one. A kernel's
    metric in a cell whose trace on the card holds none of its launches
    raises work.NoLaunches (an error, never a 0)."""
    out = {}
    traced = dataclasses.replace(run, record=run.traced_record,
                                 window_s=run.traced_window_s)
    for m in cell_metrics(run):
        reader = load_module(HERE / "metrics" / f"{m['name']}.py")
        value = reader.read(traced if m["source"] == "device_trace" else run)
        if value is None:
            print(f"metric {m['name']}: nothing to read in this run",
                  file=sys.stderr)
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(run: Run) -> dict:
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": int(run.workload["chips"]),
           "memory_peak_bytes": run.memory_peak_bytes}
    if run.trace_data is not None:
        dev["busy_s"] = run.trace_data.busy_s
        dev["window_s"] = run.trace_data.window_s
    out = {
        "correct": run.failed == 0 and all(c.ok for c in run.checks),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": read_metrics(run),
        "device": dev,
    }
    if run.trace_data is not None:
        out["breakdown"] = run.trace_data.breakdown()
    out["host"] = run.host_noise
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in run.checks}
    return out


def finish(run: Run) -> int:
    """Print the result line (the checks last on stderr too); 3 and no
    result where a forbidden module was loaded, 4 where a kernel's metric
    found none of its launches."""
    from portbench.harness import work

    try:
        out = result(run)
    except work.NoLaunches as e:
        print(f"error: {e}", file=sys.stderr)
        return 4
    bad = guard.forbidden_modules()
    if bad:
        print("import guard: the run loaded " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for c in run.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
