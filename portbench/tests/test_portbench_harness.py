"""The harness's lookups by name, its two windows in a traced run, the
error of a kernel's metric with no launches, and the host's readings."""

import time

import pytest

from portbench.harness import cell, data, host, tracing, work
from portbench.tests.conftest import tiny_run

SEED = 2 ** 32 + 77


@pytest.mark.parametrize("lookup", ["recipe", "entry"])
def test_unknown_names_are_refused(lookup):
    if lookup == "recipe":
        with pytest.raises(ValueError, match="unknown data recipe"):
            data.make({"kind": "no_such_recipe"}, 1, "cpu")
    else:
        run = tiny_run("c5_fit", SEED)
        run.config = dict(run.config, fit={"entry": "fit_sgpr_host"})
        with pytest.raises(ValueError, match="unknown fit entry"):
            cell.driver(run)._fit_once(run, None, 0)


@pytest.mark.parametrize("name", ["c4_fit", "c4_serve"])
def test_traced_run_reads_host_metrics_from_the_untraced_window(name):
    """A --trace 1 run measures an untraced window, then a traced one of
    the same work; the host-clock and counter metrics read the first."""
    run = tiny_run(name, SEED, trace=True)
    cell.execute(run, time.perf_counter())
    assert run.trace_data is not None
    assert run.window_s > 0 and run.traced_window_s > 0
    assert run.record is not run.traced_record
    key = "fits" if name == "c4_fit" else "points"
    assert run.record[key] > 0 and run.traced_record[key] > 0
    out = cell.result(run)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {
        m["name"] for m in cell.cell_metrics(run)
        if m["source"] != "device_trace"}


class _CardTrace:
    """A trace on the card that holds one kernel of another name."""
    device = [tracing._Ev("some_other_kernel", 0, 10, 1, 1)]

    def launches(self, pattern):
        return 0

    def device_seconds(self, pattern):
        return 0.0

    def device_seconds_under(self, op):
        return 0.0


@pytest.mark.parametrize("metric", ["k1_roofline.fit", "k2_roofline",
                                    "k1_roofline.serve", "trsm_roofline.serve"])
def test_kernel_metric_without_launches_is_an_error(metric):
    run = tiny_run("c5_fit" if metric.endswith(("fit", "k2_roofline"))
                   else "c4_serve", SEED, trace=True)
    run.trace_data = _CardTrace()
    run.record = {"sizes": [4]}
    reader = cell.load_module(cell.HERE / "metrics" / f"{metric}.py")
    with pytest.raises(work.NoLaunches):
        reader.read(run)


def test_host_readings():
    a = host.snapshot()
    sum(i * i for i in range(200000))
    out = host.noise(a, host.snapshot())
    assert out["process_cpu_pct"] > 0
    for key in ("steal_pct", "machine_busy_pct"):
        if key in out:
            assert 0.0 <= out[key] <= 100.0


def test_host_readings_leave_out_a_proc_stat_that_does_not_move():
    a = {"wall": 0.0, "cpu": 0.0, "stat": [0] * 8}
    b = {"wall": 1.0, "cpu": 0.5, "stat": [0] * 8}
    out = host.noise(a, b)
    assert out == {"process_cpu_pct": 50.0}
