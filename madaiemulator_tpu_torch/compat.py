"""Array-in / array-out API mirroring the reference's R bindings (port of
madaiemulator_tpu/compat.py; `r/EmuRbind.R`'s callEstimate /
callEmulateAtList contract): numpy arrays and options in, numpy arrays out,
the design scaled to [0,1]^d internally, thetas in the JAX package's order
[amp, nugget, length_scales...]. Both calls run on `device` ("cuda" unless
the caller asks for "cpu"); dtype=None is float64 (what the JAX reference
computes under x64), float32 the caller's choice (on the card: the Hopper
kernels).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from madaiemulator_tpu_torch.models.fit import fit_gp
from madaiemulator_tpu_torch.models.gp import GPData, gp_posterior
from madaiemulator_tpu_torch.ops.kernels import (
    params_to_thetas,
    thetas_to_params,
)
from madaiemulator_tpu_torch.utils.config import COVARIANCE_CLI_NAMES, GPConfig
from madaiemulator_tpu_torch.utils.designs import apply_scaling, fit_scaling


def _config(nparams: int, covariance: str, regression_order: int,
            **kw) -> GPConfig:
    return GPConfig(nparams=nparams,
                    covariance=COVARIANCE_CLI_NAMES[covariance],
                    regression_order=regression_order, **kw)


def _scaled_data(design, y, dtype, device):
    """(scaling, GPData over the scaled design) from raw arrays."""
    X = np.asarray(design, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64).ravel()
    if X.ndim != 2 or X.shape[0] != y.shape[0]:
        raise ValueError(f"design {X.shape} vs y {y.shape}")
    dtype = torch.float64 if dtype is None else dtype
    Xt = torch.tensor(X, dtype=dtype, device=device)
    scaling = fit_scaling(Xt)
    return scaling, GPData(X=apply_scaling(Xt, scaling),
                           y=torch.tensor(y, dtype=dtype, device=device))


def call_estimate(
    design,
    y,
    covariance: str = "power_exponential",
    regression_order: int = 1,
    n_restarts: int = 8,
    max_steps: int = 100,
    seed: int = 0,
    dtype=None,
    device="cuda",
) -> np.ndarray:
    """Estimate the hyperparameters of one scalar output: the natural theta
    vector [amp, nugget, length_scales...] (callEstimate), for the design
    scaled to [0,1]^d. The restarts are drawn from
    `torch.Generator().manual_seed(seed)` (`fit_gp`)."""
    _, data = _scaled_data(design, y, dtype, device)
    cfg = _config(data.X.shape[1], covariance, regression_order,
                  n_restarts=n_restarts, max_opt_steps=max_steps)
    res = fit_gp(torch.Generator().manual_seed(seed), data, cfg)
    return params_to_thetas(res.params).detach().cpu().numpy()


def call_emulate_at_list(
    design,
    y,
    thetas,
    points,
    covariance: str = "power_exponential",
    regression_order: int = 1,
    dtype=None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Posterior (means, variances) at a list of raw points given fitted
    thetas (callEmulateAtList)."""
    scaling, data = _scaled_data(design, y, dtype, device)
    pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
    cfg = _config(data.X.shape[1], covariance, regression_order)
    Ps = apply_scaling(torch.tensor(pts, dtype=data.X.dtype, device=device),
                       scaling)
    params = thetas_to_params(torch.tensor(np.asarray(thetas),
                                           dtype=data.X.dtype, device=device))
    with torch.no_grad():
        mean, var = gp_posterior(params, data, Ps, cfg)
    return mean.cpu().numpy(), var.cpu().numpy()
