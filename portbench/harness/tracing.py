"""The traced window: torch.profiler over the whole measured window, and
what the per-layer readers take from its trace.

`Window(enabled)` profiles the host's torch operations and the card's
activity (kernels, copies, sets) inside one user span, WINDOW_SPAN, that
covers exactly the measured window. `Trace` holds the events of that span:

- `busy_s`: the union of the device's activity intervals inside the span;
  `window_s`: the span's length. The idle share is 1 - busy_s / window_s.
- `device_seconds(pattern)` / `launches(pattern)`: the device time and the
  count of kernels whose name holds `pattern`;
- `device_seconds_under(op)`: the device time of what host operations
  named `op` launched (linked by the profiler's correlation ids);
- `breakdown()`: the device operations that took the most time, and the
  longest idle gaps with what the host was doing in each.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from typing import List, Optional

import torch

WINDOW_SPAN = "portbench.window"


@dataclasses.dataclass
class _Ev:
    name: str
    start: int  # ns, the profiler's clock
    end: int
    corr: int
    tid: int


class Trace:
    def __init__(self, kineto_events):
        from torch.autograd import DeviceType

        self.device: List[_Ev] = []
        self.host: List[_Ev] = []
        span = None
        for e in kineto_events:
            start = e.start_ns()
            on_device = e.device_type() == DeviceType.CUDA
            if on_device and e.is_user_annotation():
                continue  # a host span's copy on the device's timeline
            # a device event names the host operation that launched it by
            # that operation's correlation id
            corr = e.linked_correlation_id() if on_device else e.correlation_id()
            ev = _Ev(e.name(), start, start + e.duration_ns(), corr,
                     e.start_thread_id())
            if on_device:
                self.device.append(ev)
            elif ev.name == WINDOW_SPAN:
                span = ev
            else:
                self.host.append(ev)
        if span is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
        self.t0, self.t1 = span.start, span.end
        self.device = [e for e in self.device
                       if e.end > self.t0 and e.start < self.t1]
        self.host.sort(key=lambda e: e.start)
        self._starts = [e.start for e in self.host]
        self._busy = self._merge([(max(e.start, self.t0), min(e.end, self.t1))
                                  for e in self.device])

    @staticmethod
    def _merge(intervals):
        out = []
        for s, e in sorted(intervals):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy) * 1e-9

    def kernels(self, pattern: str) -> List[_Ev]:
        return [e for e in self.device if pattern in e.name]

    def launches(self, pattern: str) -> int:
        return len(self.kernels(pattern))

    def device_seconds(self, pattern: str) -> float:
        return sum(e.end - e.start for e in self.kernels(pattern)) * 1e-9

    def device_seconds_under(self, op: str) -> float:
        """Device time of the activity launched inside host operations
        named `op`, or inside operations nested in them on their thread."""
        spans = {}
        for e in self.host:
            if e.name == op:
                spans.setdefault(e.tid, []).append((e.start, e.end))
        corr = set()
        for e in self.host:
            tid_spans = spans.get(e.tid)
            if not tid_spans:
                continue
            i = bisect.bisect_right(tid_spans, (e.start, float("inf"))) - 1
            if i >= 0 and e.end <= tid_spans[i][1]:
                corr.add(e.corr)
        corr.discard(0)
        return sum(e.end - e.start for e in self.device
                   if e.corr in corr) * 1e-9

    def _host_at(self, t: int) -> str:
        """What the host was doing at time t: the innermost torch operation
        running then, and the outermost benchmark span around it."""
        running = [e for e in self.host[:bisect.bisect_right(self._starts, t)]
                   if e.end >= t]
        spans = [e for e in running if e.name.startswith("portbench.")]
        ops = [e for e in running if not e.name.startswith("portbench.")]
        where = f" in {spans[0].name}" if spans else ""
        if not ops:
            return f"host Python, no torch operation{where}"
        return f"{ops[-1].name}{where}"

    def breakdown(self, top: int = 10) -> dict:
        by_name = {}
        for e in self.device:
            by_name[e.name] = by_name.get(e.name, 0) + (e.end - e.start)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        edges = [self.t0] + [x for iv in self._busy for x in iv] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        return {
            "device_ops": [[n[:160], ns * 1e-9] for n, ns in ops],
            "idle_gaps": [[self._host_at(s + g // 2), g * 1e-9]
                          for g, s in gaps],
        }


class Window(contextlib.AbstractContextManager):
    """Profile the block when `enabled`; `trace` is then its Trace."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace: Optional[Trace] = None
        self.read_s = 0.0  # seconds to stop the profiler and read its trace
        self._prof = None
        self._span = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._span = torch.profiler.record_function(WINDOW_SPAN)
            self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            self._span.__exit__(*exc)
            t0 = time.perf_counter()
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.trace = Trace(self._prof.profiler.kineto_results.events())
            self.read_s = time.perf_counter() - t0
        return False
