"""Streams of random numbers drawn from a run's `--seed`: each use has a
stream of its own, so adding one never shifts another. The seed is any
whole number that fits 64 bits."""

from __future__ import annotations

import numpy as np
import torch

DATA, STARTS, QUERIES, ORDER, SAMPLE = 1, 2, 3, 4, 5


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for the stream (seed, *keys)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *keys])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, *keys: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *keys))


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *keys))
