"""Profiling and timing utilities (port of
madaiemulator_tpu/utils/profiling.py):

  * `trace(logdir)`: a context manager around `torch.profiler` that writes
    a Chrome / TensorBoard trace of the block into `logdir`;
  * `sync(out)`: wait for `out` by fetching one element of its first
    tensor to the host;
  * `timed(fn, *args)`: the best wall-clock time of a few calls, each
    ended by `sync`, after warm-up calls (first-use kernel builds and
    allocator growth excluded).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Optional, Tuple

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (host ops, and the card's kernels when CUDA is
    available) and write its trace file into `logdir` on exit; yields the
    `torch.profiler.profile` object (`key_averages()` and so on)."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def _first_tensor(out: Any) -> Optional[torch.Tensor]:
    """The first tensor leaf of nested tuples, lists and dicts, or None."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        for item in out:
            leaf = _first_tensor(item)
            if leaf is not None:
                return leaf
    return None


def sync(out: Any) -> None:
    """Block until `out` is computed: one element of its first tensor leaf
    is fetched to the host (which waits for the stream that produced it)."""
    leaf = _first_tensor(out)
    if leaf is not None:
        leaf.detach().reshape(-1)[:1].cpu()


def timed(fn: Callable, *args, reps: int = 3,
          warmup: int = 1) -> Tuple[float, Any]:
    """(best wall-clock seconds over `reps` calls, the last output), after
    `warmup` untimed calls."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
        sync(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        sync(out)
        best = min(best, time.perf_counter() - t0)
    return best, out
