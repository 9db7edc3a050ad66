"""Ensembles of independent emulators, fitted and served as one batch
(port of madaiemulator_tpu/parallel/ensemble.py; BASELINE config 5).

An MCMC calibration often wants thousands of small emulators, one per
member of an ensemble of data sets. Here they are one batch:

  * `fit_ensemble` fits E scalar GPs at once. Every (member e, restart r)
    pair is one L-BFGS lane, and all E x R lanes step together in one
    lock-step batch (`models.fit.fit_one_start`): each objective evaluation
    is one batched likelihood over the lanes, each lane on its own member's
    design X[e] and targets y[e], so at float32 on the card one K1 launch
    builds all E x R Grams and one K2 launch factors them.
  * `predict_ensemble` serves the E posteriors in one batched call.

Arrays are laid out (ensemble, restart, ...) as in the JAX package. What
the JAX package does across a device mesh (`make_mesh`, a `mesh` argument,
`predict_queries_sharded`) is multi-device and not ported: a `mesh` raises
NotImplementedError. Its TPU crash workaround (`restart_split` defaulting to
2 on TPU backends) is not ported either: `restart_split` defaults to None,
one R-wide batch.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from madaiemulator_tpu_torch.models.fit import (
    FitResult,
    _fit_lanes,
    _flatten_t,
    _new_stats,
    sample_restarts,
)
from madaiemulator_tpu_torch.models.gp import GPData, gp_posterior
from madaiemulator_tpu_torch.ops.kernels import GPParams
from madaiemulator_tpu_torch.utils.config import GPConfig


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh is multi-device and not ported: the port runs an "
            "ensemble on one GPU (pass mesh=None)")


def _fit(u0: torch.Tensor, Xb, yb, config: GPConfig, max_steps: int,
         ensemble_chunk=None, restart_split=None) -> FitResult:
    """The (E, R, P) starts u0 fitted by `models.fit._fit_lanes`, lane
    (e, r) on member e's design and targets, timed into `stats`."""
    t0 = time.perf_counter()
    res = _fit_lanes(u0.to(device=Xb.device, dtype=yb.dtype), Xb, yb,
                     config, max_steps, group_chunk=ensemble_chunk,
                     restart_chunk=restart_split, stats=_new_stats())
    res.stats["fit_wall_s"] = time.perf_counter() - t0
    return res


def fit_ensemble_from_starts(
    u0: GPParams, Xb: torch.Tensor, yb: torch.Tensor, config: GPConfig,
    max_steps: int,
) -> FitResult:
    """Fit E GPs from explicit unconstrained starts u0, leaves (E, R, ...),
    on designs Xb (E, N, d) and targets yb (E, N), on Xb's device. The
    E x R lanes run as one `fit_one_start` batch (K1 is handed the
    (E * R, N, d) scaled designs, one contiguous block per lane); the
    argmax over restarts skips non-finite LMLs. Every FitResult field
    carries the member axis in front: params (E, ...), log_likelihood (E,),
    restart_log_likelihoods (E, R) (-inf where not finite), restart_params
    (E, R, ...); `stats` counts the objective evaluations and the wall
    time."""
    return _fit(_flatten_t(u0), Xb, yb, config, max_steps)


def fit_ensemble(
    generator: torch.Generator,
    Xb: torch.Tensor,  # (E, N, d)
    yb: torch.Tensor,  # (E, N)
    config: GPConfig,
    mesh=None,
    n_restarts: Optional[int] = None,
    max_steps: Optional[int] = None,
    ensemble_chunk: Optional[int] = None,
    restart_split: Optional[int] = None,
) -> FitResult:
    """Fit E independent scalar GPs at once (BASELINE config 5), on Xb's
    device.

    The starts are drawn by `models.fit.sample_restarts(generator, ...)`,
    once per member, in member order, before any chunking or splitting, so
    neither option changes them. All E x R lanes run as one lock-step
    L-BFGS batch. ensemble_chunk runs the members in sequential groups of
    that size (E must be a multiple of it); restart_split runs the restarts
    in sequential parts of at most that many (the JAX package draws each
    part from a fresh key; here the parts split the one draw). Either way
    the result equals one batch's. Like the JAX function, there is no
    dead-start rescue: a lane whose start is not finite keeps LML -inf and
    loses the argmax. `mesh` must be None (a device mesh is not ported).
    """
    _no_mesh(mesh)
    R = config.n_restarts if n_restarts is None else n_restarts
    steps = config.max_opt_steps if max_steps is None else max_steps
    E = Xb.shape[0]
    if ensemble_chunk is not None and E % min(ensemble_chunk, E) != 0:
        raise ValueError(f"ensemble size E={E} not divisible by "
                         f"ensemble_chunk={ensemble_chunk}")
    t0 = time.perf_counter()
    u0 = torch.stack([
        _flatten_t(sample_restarts(generator, config, R, dtype=yb.dtype))
        for _ in range(E)])  # (E, R, P)
    res = _fit(u0, Xb, yb, config, steps, ensemble_chunk, restart_split)
    res.stats["fit_wall_s"] = time.perf_counter() - t0
    return res


def predict_ensemble(
    params: GPParams,  # batched (E, ...)
    Xb: torch.Tensor,  # (E, N, d)
    yb: torch.Tensor,  # (E, N)
    Xsb: torch.Tensor,  # (E, m, d) query points per member
    config: GPConfig,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched posterior (means, variances), (E, m) each: one factorization
    of the E Grams and one batched predict (`models.gp.gp_posterior`; at
    float32 on the card, K1 for the Grams and the cross-covariances, K2 for
    the factors)."""
    _no_mesh(mesh)
    return gp_posterior(params, GPData(X=Xb, y=yb), Xsb, config)
