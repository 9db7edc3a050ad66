"""Variance-based global sensitivity analysis over the emulator (port of
madaiemulator_tpu/models/sensitivity.py).

Sobol indices and main-effect curves (Oakley & O'Hagan 2004; Saltelli et
al. 2010): Monte Carlo over the emulator, at no simulator cost. The
Saltelli block and the main-effects grid are assembled on the device; the
evaluations run as a host loop over query chunks, each one batched predict
(on the card at float32: one K1 cross covariance a chunk for a dense
emulator).

Estimators (Saltelli et al. 2010):
  first-order  S_i = mean(f_B (f_ABi - f_A)) / V
  total        T_i = mean((f_A - f_ABi)^2) / (2 V)
with A, B two independent uniform designs on [0,1]^d and AB_i = A with
column i taken from B; V = Var over the pooled A/B evaluations.

predict_fn contract: (m, d) -> (m,) scalar means, or (m, t) multivariate
means (indices per observable). Every uniform draw comes from a
`torch.Generator` through one helper per draw site (`_saltelli_uniform`,
`_base_uniform`); the JAX package draws from jax.random, so the two
packages' designs differ by design.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch


class SobolResult(NamedTuple):
    """first[i] / total[i]: Sobol indices with the input-dimension axis
    LEADING, (d,) or (d, t) when predict_fn returns (m, t); mean / variance:
    the output moments the indices are normalized by, () or (t,)."""

    first: torch.Tensor
    total: torch.Tensor
    mean: torch.Tensor
    variance: torch.Tensor


def _uniform(generator: torch.Generator, shape: tuple, dtype,
             device) -> torch.Tensor:
    """U[0, 1) of `shape` drawn on the generator's device, moved to
    `device`."""
    return torch.rand(shape, generator=generator, dtype=dtype,
                      device=generator.device).to(device)


def _saltelli_uniform(generator: torch.Generator, n: int, d: int, dtype,
                      device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sobol's two independent (n, d) uniform designs A and B."""
    return (_uniform(generator, (n, d), dtype, device),
            _uniform(generator, (n, d), dtype, device))


def _base_uniform(generator: torch.Generator, n: int, d: int, dtype,
                  device) -> torch.Tensor:
    """The main effects' (n, d) uniform base design."""
    return _uniform(generator, (n, d), dtype, device)


def _eval_chunked(predict_fn, X: torch.Tensor, chunk: Optional[int]):
    """predict_fn over the rows of X in chunks of at most `chunk` rows, one
    call a chunk (the last may be shorter: no padding, so nothing depends
    on it)."""
    m = X.shape[0]
    if chunk is None or m <= chunk:
        return predict_fn(X)
    return torch.cat([predict_fn(X[i:i + chunk]) for i in range(0, m, chunk)])


def _promoted(f: torch.Tensor) -> torch.Tensor:
    """f in at least float32 (the JAX package's promote_types(f, f32))."""
    return f.to(torch.promote_types(f.dtype, torch.float32))


@torch.no_grad()
def sobol_indices(
    predict_fn: Callable[[torch.Tensor], torch.Tensor],
    d: int,
    generator: torch.Generator,
    n: int = 4096,
    query_chunk: Optional[int] = 4096,
    dtype=torch.float32,
    device="cuda",
) -> SobolResult:
    """Sobol first-order and total indices of predict_fn on [0,1]^d.

    n (d + 2) evaluations, in chunks of query_chunk rows. The raw estimator
    values are returned (noise can leave tiny negatives); where the output
    variance is 0 the indices are 0."""
    A, B = _saltelli_uniform(generator, n, d, dtype, device)
    # one query matrix [A; B; AB_0; ...; AB_{d-1}], (n (d + 2), d)
    AB = A[None].repeat(d, 1, 1)
    idx = torch.arange(d, device=A.device)
    AB[idx, :, idx] = B.mT
    X = torch.cat([A, B, AB.reshape(d * n, d)])
    f = _promoted(_eval_chunked(predict_fn, X, query_chunk))
    fA, fB = f[:n], f[n:2 * n]
    fAB = f[2 * n:].reshape((d, n) + f.shape[1:])
    pooled = torch.cat([fA, fB])
    mean = pooled.mean(0)
    V = pooled.var(0, correction=0)
    pos = V > 0
    Vsafe = torch.where(pos, V, torch.ones_like(V))
    first = (fB[None] * (fAB - fA[None])).mean(1) / Vsafe
    total = ((fA[None] - fAB) ** 2).mean(1) / (2.0 * Vsafe)
    zero = torch.zeros_like(first)
    return SobolResult(first=torch.where(pos, first, zero),
                       total=torch.where(pos, total, zero), mean=mean,
                       variance=V)


@torch.no_grad()
def main_effects(
    predict_fn: Callable[[torch.Tensor], torch.Tensor],
    d: int,
    generator: torch.Generator,
    grid: int = 33,
    n: int = 2048,
    query_chunk: Optional[int] = 4096,
    dtype=torch.float32,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Main-effect curves E[f | x_i = v] on a uniform grid of v in [0,1]:
    (grid values (grid,), effects (d, grid[, t])), each the output averaged
    over an n-point base design with input i pinned to v. d grid n
    evaluations, in chunks of query_chunk rows."""
    base = _base_uniform(generator, n, d, dtype, device)
    gv = torch.linspace(0.0, 1.0, grid, dtype=dtype, device=base.device)
    # (d, grid, n, d): the base with column i pinned to gv[j]
    X = base[None, None].repeat(d, grid, 1, 1)
    idx = torch.arange(d, device=base.device)
    X[idx, :, :, idx] = gv[None, :, None].expand(d, grid, n)
    f = _eval_chunked(predict_fn, X.reshape(d * grid * n, d), query_chunk)
    f = f.reshape((d, grid, n) + f.shape[1:])
    return gv, _promoted(f).mean(2)


def gp_mean_fn(params, data, config, state=None):
    """A trained scalar GP as a (m, d) -> (m,) predict_fn: factors once (or
    reuses a caller's GPPosteriorState), so each evaluation batch is
    serving work only."""
    from madaiemulator_tpu_torch.models.gp import (
        precompute_predictor,
        predict_from_precomputed,
    )

    if state is None:
        state = precompute_predictor(params, data, config)

    def fn(Xs):
        return predict_from_precomputed(state, params, data, Xs, config)[0]

    return fn


def multivariate_mean_fn(emu):
    """A MultivariateEmulator as a (m, d) -> (m, t) predict_fn over the
    SCALED cube: queries map back to the emulator's raw parameter box before
    predicting (Sobol indices are invariant under that per-dimension affine
    map)."""
    from madaiemulator_tpu_torch.models.multivariate import (
        predict_multivariate,
    )
    from madaiemulator_tpu_torch.utils.designs import unapply_scaling

    def fn(Xs):
        return predict_multivariate(emu, unapply_scaling(Xs, emu.scaling))[0]

    return fn
