"""Multivariate-output emulation via PCA + per-component GPs, serve part
(port of madaiemulator_tpu/models/multivariate.py).

The r component GPs share the scaled design X and run as one batch: their
hyperparameters, serve states and predictions carry a leading (r,) axis
(JAX vmaps over it). Prediction rotates the per-component (mean, variance)
back to the t observables:

    mean_j = ybar_j + s_j * sum_i sqrt(lambda_i) U_ji m_i
    var_j  = s_j^2  * sum_i lambda_i  U_ji^2 v_i
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from madaiemulator_tpu_torch.models.gp import (
    GPData,
    GPPosteriorState,
    precompute_predictor,
    predict_from_precomputed,
)
from madaiemulator_tpu_torch.ops.kernels import GPParams
from madaiemulator_tpu_torch.utils.config import GPConfig
from madaiemulator_tpu_torch.utils.designs import DesignScaling, apply_scaling


class PCAState(NamedTuple):
    ymean: torch.Tensor  # (t,)
    ystd: torch.Tensor  # (t,) ones when standardize=False
    eigenvalues: torch.Tensor  # (r,) retained, descending
    U: torch.Tensor  # (t, r) retained eigenvectors (columns)


class MultivariateEmulator(NamedTuple):
    """A trained multivariate emulator: snapshot payload + serve states.

    `noise` (optional, (N, r)) holds per-point observation-noise variances
    projected to PC-score space, the diagonal each component's Gram was
    built with. (The JAX container's fit log and gradient blocks are not
    yet ported.)
    """

    scaling: DesignScaling
    X: torch.Tensor  # (N, d) scaled design
    Z: torch.Tensor  # (N, r) PC scores (training targets)
    pca: PCAState
    params: GPParams  # batched (r, ...) per-component hyperparameters
    states: GPPosteriorState  # batched (r, ...) serve states
    config: GPConfig
    noise: Optional[torch.Tensor] = None  # (N, r)

    @property
    def n_components(self) -> int:
        return self.Z.shape[1]

    @property
    def n_outputs(self) -> int:
        return self.pca.ymean.shape[0]


def pca_decompose(
    Y, pca_variance: float, standardize: bool = True
) -> Tuple[PCAState, np.ndarray]:
    """Host-side (numpy) PCA of training outputs: (state, Z scores (N, r)),
    both as numpy arrays.

    Deterministic eigenvector sign: the entry of largest magnitude in each
    retained eigenvector is made positive.
    """
    Y = np.asarray(Y)
    n, t = Y.shape
    ymean = Y.mean(axis=0)
    ystd = Y.std(axis=0, ddof=1) if standardize else np.ones(t, Y.dtype)
    ystd = np.maximum(ystd, np.finfo(Y.dtype).tiny)
    Yc = (Y - ymean) / ystd
    cov = (Yc.T @ Yc) / max(n - 1, 1)
    lam, U = np.linalg.eigh(cov)  # ascending
    lam = np.maximum(lam[::-1], 0.0)
    U = U[:, ::-1]
    total = lam.sum()
    if total <= 0:
        r = 1
    else:
        frac = np.cumsum(lam) / total
        r = int(np.searchsorted(frac, pca_variance - 1e-12) + 1)
        r = min(max(r, 1), t)
    lam_r, U_r = lam[:r].copy(), U[:, :r].copy()
    for i in range(r):
        j = np.argmax(np.abs(U_r[:, i]))
        if U_r[j, i] < 0:
            U_r[:, i] = -U_r[:, i]
    denom = np.sqrt(np.maximum(lam_r, np.finfo(Y.dtype).tiny))
    Z = (Yc @ U_r) / denom[None, :]
    return PCAState(ymean=ymean, ystd=ystd, eigenvalues=lam_r, U=U_r), Z


def _vmapped_states(
    params: GPParams, X: torch.Tensor, Z: torch.Tensor, config: GPConfig,
    noise_pc: Optional[torch.Tensor] = None,
) -> GPPosteriorState:
    """Per-component serve states as ONE batched build over (r, N, N): Gram,
    factorization and GLS solves for every component at once, with the
    per-component jitter ladder of `precompute_predictor`."""
    data = GPData(X=X, y=Z.mT, noise=None if noise_pc is None else noise_pc.mT)
    return precompute_predictor(params, data, config)


def _predict_components(
    states: GPPosteriorState, params: GPParams, X: torch.Tensor,
    Z: torch.Tensor, Xs: torch.Tensor, config: GPConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-component posterior at Xs: means, variances, each (r, m)."""
    return predict_from_precomputed(states, params, GPData(X=X, y=Z.mT), Xs,
                                    config)


def reconstruct_observables(
    m_pc: torch.Tensor, v_pc: torch.Tensor, pca: PCAState
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate per-PC (mean, variance), each (r, m), back to observable space
    (m, t)."""
    dt = m_pc.dtype
    lam = pca.eigenvalues.to(dt)
    U = pca.U.to(dt)  # (t, r)
    ymean = pca.ymean.to(dt)
    ystd = pca.ystd.to(dt)
    mean = ymean[None, :] + ((m_pc.mT * torch.sqrt(lam)[None, :]) @ U.mT) * ystd[None, :]
    var = ((v_pc.mT * lam[None, :]) @ (U.mT ** 2)) * (ystd[None, :] ** 2)
    return mean, var


def predict_multivariate(
    emu: MultivariateEmulator, Xs_raw
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and variance in observable space: (m, t), (m, t).
    Xs_raw is (m, d) in natural parameter units (array or tensor)."""
    Xs = apply_scaling(
        torch.as_tensor(Xs_raw, dtype=emu.X.dtype, device=emu.X.device),
        emu.scaling,
    )
    m_pc, v_pc = _predict_components(
        emu.states, emu.params, emu.X, emu.Z, Xs, emu.config
    )
    return reconstruct_observables(m_pc, v_pc, emu.pca)


def emulator_from_numpy(
    arrays: Mapping[str, np.ndarray],
    config: GPConfig,
    device,
    dtype: torch.dtype = torch.float64,
) -> MultivariateEmulator:
    """Build the port's emulator from a trained state held as numpy arrays,
    rebuilding the serve states on `device`.

    Keys (the leaves of a JAX `MultivariateEmulator`): mins, ranges (d,);
    X (N, d) scaled design; Z (N, r); ymean, ystd (t,); eigenvalues (r,);
    U (t, r); log_amp, log_nugget (r,); log_ls (r, k); optional noise (N, r).
    """
    def t(key):  # a copy: the caller's arrays may be read-only views
        return torch.tensor(np.asarray(arrays[key]), dtype=dtype,
                            device=device)

    scaling = DesignScaling(mins=t("mins"), ranges=t("ranges"))
    pca = PCAState(ymean=t("ymean"), ystd=t("ystd"),
                   eigenvalues=t("eigenvalues"), U=t("U"))
    params = GPParams(log_amp=t("log_amp"), log_nugget=t("log_nugget"),
                      log_ls=t("log_ls"))
    X, Z = t("X"), t("Z")
    noise = t("noise") if arrays.get("noise") is not None else None
    states = _vmapped_states(params, X, Z, config, noise_pc=noise)
    return MultivariateEmulator(
        scaling=scaling, X=X, Z=Z, pca=pca, params=params, states=states,
        config=config, noise=noise,
    )
