"""One small two-level multi-fidelity emulator fitted by the port (float64,
CPU), shared by the port's serving and snapshot tests: noisy data, so that
the fitted nuggets stay well above float64 rounding (native/ serves the
snapshots at 1e-10)."""

import functools

import numpy as np
import torch

from madaiemulator_tpu_torch.models import multifidelity as tmfm
from madaiemulator_tpu_torch.utils import config as tcfg


@functools.cache
def mf_emulator(multivariate: bool):
    """Version 2 (three outputs, PCA at 0.999) when `multivariate`, else
    version 1 on the first output; d = 2 on [1, 3]^2, 20 cheap and 8
    expensive runs, 2 restarts x 10 steps. Fitted once per process: every
    caller reads it and none changes it."""
    rng = np.random.default_rng(8)
    X0 = rng.uniform(1.0, 3.0, size=(20, 2))
    X1 = rng.uniform(1.0, 3.0, size=(8, 2))

    def f(X):
        return np.stack([np.sin(2 * X[:, 0]) + X[:, 1], X[:, 0] * X[:, 1],
                         X[:, 1] ** 2], axis=1) + 0.02 * rng.standard_normal(
                             (X.shape[0], 3))

    Y0, Y1 = f(X0), 1.2 * f(X1) + 0.1 + 0.2 * X1[:, :1]
    cfg = tcfg.GPConfig(nparams=2, regression_order=1, n_restarts=2,
                        max_opt_steps=10)
    Xs = [torch.tensor(X0), torch.tensor(X1)]
    if multivariate:
        return tmfm.fit_multivariate_multifidelity(
            torch.Generator().manual_seed(0), Xs,
            [torch.tensor(Y0), torch.tensor(Y1)], cfg, pca_variance=0.999)
    return tmfm.fit_multifidelity(
        torch.Generator().manual_seed(0), Xs,
        [torch.tensor(Y0[:, 0]), torch.tensor(Y1[:, 0])], cfg)
