"""What the host did while a window ran, read from /proc (Linux): how
much of the machine's CPU time the hypervisor took (steal), how busy the
machine's CPUs were, the run's own CPU time, and the CPUs' clock. None of it is a metric: a host-paced
cell's spread is read against it. Readings that the machine does not give
are left out, and so are the machine's shares where its /proc/stat does
not move (a sandbox may show zeros there)."""

from __future__ import annotations

import time
from typing import Dict


def _stat() -> list:
    with open("/proc/stat") as f:
        return [int(v) for v in f.readline().split()[1:9]]


def _mhz() -> float:
    with open("/proc/cpuinfo") as f:
        v = [float(line.split(":")[1]) for line in f
             if line.startswith("cpu MHz")]
    return sum(v) / len(v)


def snapshot() -> Dict[str, float]:
    out = {"wall": time.perf_counter(), "cpu": time.process_time()}
    for key, fn in (("stat", _stat), ("mhz", _mhz)):
        try:
            out[key] = fn()
        except (OSError, ValueError, IndexError, ZeroDivisionError):
            pass
    return out


def noise(a: dict, b: dict) -> Dict[str, float]:
    """The readings between two snapshots: steal_pct and machine_busy_pct
    of all CPUs' time, process_cpu_pct of the wall time, and cpu_mhz (the
    mean of both ends)."""
    wall = b["wall"] - a["wall"]
    out = {"process_cpu_pct": 100.0 * (b["cpu"] - a["cpu"]) / wall}
    if "stat" in a and "stat" in b:
        d = [y - x for x, y in zip(a["stat"], b["stat"])]
        total = sum(d)
        if total > 0:
            out["steal_pct"] = 100.0 * d[7] / total
            out["machine_busy_pct"] = 100.0 * (total - d[3] - d[4]) / total
    if "mhz" in a and "mhz" in b:
        out["cpu_mhz"] = (a["mhz"] + b["mhz"]) / 2
    return out
