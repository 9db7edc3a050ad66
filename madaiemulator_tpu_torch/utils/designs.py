"""Design-matrix scaling and Latin-hypercube designs (port of
madaiemulator_tpu/utils/designs.py).

The design is scaled to the unit hypercube before fitting; the scaling
(per-dimension min and range) is part of the snapshot so queries map the
same way at serve time.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class DesignScaling(NamedTuple):
    mins: torch.Tensor  # (d,)
    ranges: torch.Tensor  # (d,) max - min, floored at tiny


def fit_scaling(
    X: torch.Tensor, ranges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
) -> DesignScaling:
    """Scaling from data min/max, or from explicit (mins, maxs) param ranges."""
    if ranges is not None:
        mins, maxs = ranges
        mins = torch.as_tensor(mins, dtype=X.dtype, device=X.device)
        maxs = torch.as_tensor(maxs, dtype=X.dtype, device=X.device)
    else:
        mins = X.amin(dim=0)
        maxs = X.amax(dim=0)
    floor = 1e-300 if X.dtype == torch.float64 else 1e-30
    return DesignScaling(mins=mins, ranges=torch.clamp(maxs - mins, min=floor))


def apply_scaling(X: torch.Tensor, s: DesignScaling) -> torch.Tensor:
    return (X - s.mins[None, :]) / s.ranges[None, :]


def unapply_scaling(Xs: torch.Tensor, s: DesignScaling) -> torch.Tensor:
    return Xs * s.ranges[None, :] + s.mins[None, :]


def latin_hypercube(
    generator: torch.Generator, n: int, d: int, dtype=torch.float64
) -> torch.Tensor:
    """Latin hypercube sample on [0,1]^d, (n, d), on the CPU from
    `generator`: one point per axis stratum, the strata independently
    permuted per dimension (the standard space-filling design for emulator
    training runs)."""
    perms = torch.stack([torch.randperm(n, generator=generator)
                         for _ in range(d)])  # (d, n)
    u = torch.rand((d, n), generator=generator, dtype=dtype)
    return ((perms.to(dtype) + u) / n).T
