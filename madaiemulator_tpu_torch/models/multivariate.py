"""Multivariate-output emulation via PCA + per-component GPs (port of
madaiemulator_tpu/models/multivariate.py): `fit_multivariate` trains, the
rest serves.

The r component GPs share the scaled design X and run as one batch: their
hyperparameters, serve states and predictions carry a leading (r,) axis
(JAX vmaps over it). The fit runs every (component x restart) lane in one
lock-step LBFGS batch (`models.fit`). The matrix-free twin,
`IterativeMultivariateEmulator` (`fit_multivariate_iterative`,
`predict_multivariate_iterative`), keeps no dense state and runs each
component through `models.iterative`, one after another. Prediction rotates
the per-component (mean, variance) back to the t observables:

    mean_j = ybar_j + s_j * sum_i sqrt(lambda_i) U_ji m_i
    var_j  = s_j^2  * sum_i lambda_i  U_ji^2 v_i
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from madaiemulator_tpu_torch.models import fit as _fit
from madaiemulator_tpu_torch.models.gp import (
    FastPredictorState,
    GPData,
    GPPosteriorState,
    fast_predictor_from_state,
    precompute_predictor,
    predict_fast,
    predict_from_precomputed,
    predict_gradient,
)
from madaiemulator_tpu_torch.ops.kernels import GPParams
from madaiemulator_tpu_torch.utils.config import CovarianceFamily, GPConfig
from madaiemulator_tpu_torch.utils.designs import (
    DesignScaling,
    apply_scaling,
    fit_scaling,
)

logger = logging.getLogger("madaiemulator_tpu_torch")


class PCAState(NamedTuple):
    ymean: torch.Tensor  # (t,)
    ystd: torch.Tensor  # (t,) ones when standardize=False
    eigenvalues: torch.Tensor  # (r,) retained, descending
    U: torch.Tensor  # (t, r) retained eigenvectors (columns)


class MultivariateEmulator(NamedTuple):
    """A trained multivariate emulator: snapshot payload + serve states.

    `restart_log_likelihoods` (optional, (r, R)) is the fit's per-restart
    best LML of each component and `fit_stats` its objective-evaluation
    counts (`models.fit.FitResult.stats`); both are None for an emulator
    read from a snapshot. `noise` (optional, (N, r)) holds per-point
    observation-noise variances projected to PC-score space, the diagonal
    each component's Gram was built with. `dZ` (optional, (N, d, r)) holds
    gradient observations projected to PC-score space in the scaled design
    coordinates (`project_gradients`): every component is then a joint
    value + gradient GP, and the snapshot is grammar version 3. `dZ_noise`
    carries known gradient-noise variances in the same layout.
    """

    scaling: DesignScaling
    X: torch.Tensor  # (N, d) scaled design
    Z: torch.Tensor  # (N, r) PC scores (training targets)
    pca: PCAState
    params: GPParams  # batched (r, ...) per-component hyperparameters
    states: GPPosteriorState  # batched (r, ...) serve states
    config: GPConfig
    restart_log_likelihoods: Optional[torch.Tensor] = None  # (r, R)
    noise: Optional[torch.Tensor] = None  # (N, r)
    fit_stats: Optional[dict] = None  # the fit's FitResult.stats
    dZ: Optional[torch.Tensor] = None  # (N, d, r) PC-space gradients
    dZ_noise: Optional[torch.Tensor] = None  # (N, d, r) their variances

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


def project_scores(Y, pca: PCAState, dtype=None) -> torch.Tensor:
    """PC scores of new output rows (N, t) under an existing PCA basis:
    z = ((y - ymean) / ystd) @ U / sqrt(lambda), the map pca_decompose bakes
    into its Z. pca's fields may be numpy arrays or tensors; the result is
    a tensor on Y's device (Y a tensor) or the CPU."""
    Y = torch.as_tensor(Y)
    if dtype is not None:
        Y = Y.to(dtype)
    t = np.shape(pca.ymean)[0]
    if Y.ndim != 2 or Y.shape[1] != t:
        raise ValueError(f"outputs must be (N, t={t}); got {tuple(Y.shape)}")

    def f(a):
        return torch.as_tensor(a).to(device=Y.device, dtype=Y.dtype)

    lam = torch.clamp(f(pca.eigenvalues), min=torch.finfo(Y.dtype).tiny)
    Yc = (Y - f(pca.ymean)[None, :]) / f(pca.ystd)[None, :]
    return (Yc @ f(pca.U)) / torch.sqrt(lam)[None, :]


def _pca_tensors(pca: PCAState, like: torch.Tensor) -> PCAState:
    """pca's fields (numpy arrays or tensors) as tensors of like's dtype and
    device."""
    return PCAState(*(torch.as_tensor(a).to(device=like.device,
                                            dtype=like.dtype) for a in pca))


def _as_tensor(a, dtype) -> torch.Tensor:
    a = torch.as_tensor(a)
    return a if dtype is None else a.to(dtype)


def project_noise(noise, pca: PCAState, dtype=None) -> torch.Tensor:
    """Per-PC observation-noise variances (N, r) from per-point output
    noise: (N,), one variance per point in the original y units for every
    output, or (N, t). Var(z_k,i) = sum_t U_tk^2 sigma_ti^2 / ystd_t^2 /
    lambda_k; cross-PC covariances are dropped (exactly zero when the
    z-scored noise is isotropic across outputs), the independent-component
    approximation the PCA emulator makes for its posterior."""
    noise = _as_tensor(noise, dtype)
    t = np.shape(pca.ymean)[0]
    if noise.ndim == 1:
        noise = noise[:, None].expand(noise.shape[0], t)
    if noise.shape[1] != t:
        raise ValueError(
            f"noise must be (N,) or (N, t={t}); got {tuple(noise.shape)}")
    p = _pca_tensors(pca, noise)
    lam = torch.clamp(p.eigenvalues, min=torch.finfo(noise.dtype).tiny)
    return (noise / p.ystd[None, :] ** 2) @ p.U ** 2 / lam[None, :]


def _gradient_weights(pca: PCAState, like: torch.Tensor) -> torch.Tensor:
    """(t, r) weights U / (ystd sqrt(lambda)) of the PC-score map."""
    p = _pca_tensors(pca, like)
    lam = torch.clamp(p.eigenvalues, min=torch.finfo(like.dtype).tiny)
    return p.U / (p.ystd[:, None] * torch.sqrt(lam)[None, :])


def _gradient_block(a, pca: PCAState, what: str, dtype) -> torch.Tensor:
    a = _as_tensor(a, dtype)
    t = np.shape(pca.ymean)[0]
    if a.ndim == 2 and t == 1:
        a = a[:, :, None]
    if a.ndim != 3 or a.shape[2] != t:
        raise ValueError(f"{what} must be (N, d, t={t}); got "
                         f"{tuple(a.shape)}")
    return a


def project_gradients(dY, pca: PCAState, scaling: DesignScaling,
                      dtype=None) -> torch.Tensor:
    """PC-space gradient observations (N, d, r) from raw output gradients
    dY (N, d, t) (or (N, d) when t == 1) w.r.t. the RAW inputs. Both maps
    are linear, so the projection is exact: the scaling X_s = (x - mins) /
    ranges gives d/dX_s,a = ranges_a d/dx_a, and the PC score map gives
    dz_k = sum_u dY_u U_uk / (ystd_u sqrt(lambda_k))."""
    dY = _gradient_block(dY, pca, "gradients", dtype)
    dZ = torch.einsum("nat,tr->nar", dY, _gradient_weights(pca, dY))
    rng = torch.as_tensor(scaling.ranges).to(device=dY.device, dtype=dY.dtype)
    return dZ * rng[None, :, None]


def project_gradient_noise(dY_noise, pca: PCAState, scaling: DesignScaling,
                           dtype=None) -> torch.Tensor:
    """PC-space gradient-noise variances (N, d, r) from raw per-partial
    variances (N, d, t) (or (N, d) when t == 1): through the squared
    weights of `project_gradients`, cross-PC covariances dropped as in
    `project_noise`."""
    v = _gradient_block(dY_noise, pca, "gradient noise", dtype)
    out = torch.einsum("nat,tr->nar", v, _gradient_weights(pca, v) ** 2)
    rng = torch.as_tensor(scaling.ranges).to(device=v.device, dtype=v.dtype)
    return out * (rng ** 2)[None, :, None]


def _component_batch(X: torch.Tensor, Z: torch.Tensor,
                     noise_pc: Optional[torch.Tensor] = None,
                     dZ: Optional[torch.Tensor] = None,
                     dZ_noise: Optional[torch.Tensor] = None,
                     H_pc: Optional[torch.Tensor] = None) -> GPData:
    """The r component GPs as one batched GPData: y (r, N) holds each
    component's scores, noise (r, N) its PC-space noise variances, dY and
    dY_noise (r, N, d) its PC-space gradient blocks. H_pc (N, r), when
    given, is a per-component extra GLS column (the multivariate
    multi-fidelity lower-level mean): component i trains with h_extra =
    H_pc[:, i:i+1]."""
    def comp(a):
        return None if a is None else a.permute(2, 0, 1)

    return GPData(X=X, y=Z.mT, noise=None if noise_pc is None else noise_pc.mT,
                  h_extra=None if H_pc is None else H_pc.mT[:, :, None],
                  dY=comp(dZ), dY_noise=comp(dZ_noise))


def _vmapped_fit(
    generator: torch.Generator, X: torch.Tensor, Z: torch.Tensor,
    config: GPConfig, restart_chunk: Optional[int] = None,
    noise_pc: Optional[torch.Tensor] = None,
    dZ: Optional[torch.Tensor] = None,
    dZ_noise: Optional[torch.Tensor] = None,
    H_pc: Optional[torch.Tensor] = None, **fit_kwargs,
) -> _fit.FitResult:
    """`fit_gp` of every component at once (the JAX package vmaps it over
    the component axis): the (r x R) lanes step in one lock-step LBFGS.
    Each component's restarts come from one `sample_restarts` call, in
    component order. FitResult fields carry the component axis in front."""
    data = _component_batch(X, Z, noise_pc, dZ, dZ_noise, H_pc)
    return _fit._fit_components(generator, X, data.y, config,
                                restart_chunk=restart_chunk,
                                noise=data.noise, dY=data.dY,
                                dY_noise=data.dY_noise,
                                h_extra=data.h_extra, **fit_kwargs)


def _vmapped_states(
    params: GPParams, X: torch.Tensor, Z: torch.Tensor, config: GPConfig,
    noise_pc: Optional[torch.Tensor] = None,
    dZ: Optional[torch.Tensor] = None,
    dZ_noise: Optional[torch.Tensor] = None,
    H_pc: Optional[torch.Tensor] = None,
) -> GPPosteriorState:
    """Per-component serve states as ONE batched build over (r, N, N): Gram,
    factorization and GLS solves for every component at once, with the
    per-component jitter ladder of `precompute_predictor`."""
    return precompute_predictor(
        params, _component_batch(X, Z, noise_pc, dZ, dZ_noise, H_pc), config)


def _predict_components(
    states: GPPosteriorState, params: GPParams, X: torch.Tensor,
    Z: torch.Tensor, Xs: torch.Tensor, config: GPConfig,
    dZ: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-component posterior at Xs: means, variances, each (r, m). Noise
    enters only the stored factorizations; gradient data changes the cross
    covariance's rows, so dZ rides along."""
    return predict_from_precomputed(states, params,
                                    _component_batch(X, Z, dZ=dZ), Xs, config)


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
    m_pc, v_pc = _predict_components(
        emu.states, emu.params, emu.X, emu.Z, _scaled_queries(emu, Xs_raw),
        emu.config, dZ=emu.dZ,
    )
    return reconstruct_observables(m_pc, v_pc, emu.pca)


def _scaled_queries(emu: MultivariateEmulator, Xs_raw) -> torch.Tensor:
    return apply_scaling(
        torch.as_tensor(Xs_raw, dtype=emu.X.dtype, device=emu.X.device),
        emu.scaling,
    )


def predict_multivariate_gradient(
    emu: MultivariateEmulator, Xs_raw
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and marginal variance of the observable gradients
    d f_u / d x_a w.r.t. the RAW inputs: ((m, d, t), (m, d, t)). The
    per-PC gradient posteriors (`gp.predict_gradient`) go back through the
    PCA reconstruction (means by sqrt(lambda) U, variances by lambda U^2,
    the independent-component approximation) and the design scaling
    (divide by ranges, variances by ranges^2). Needs a twice-
    differentiable kernel; values-only and gradient-enhanced emulators
    alike."""
    gm, gv = predict_gradient(
        emu.states, emu.params, _component_batch(emu.X, emu.Z, dZ=emu.dZ),
        _scaled_queries(emu, Xs_raw), emu.config)  # (r, m, d) each
    p = _pca_tensors(emu.pca, gm)
    Wm = p.U * torch.sqrt(p.eigenvalues)[None, :] * p.ystd[:, None]
    Wv = p.U ** 2 * p.eigenvalues[None, :] * (p.ystd ** 2)[:, None]
    inv_rng = 1.0 / emu.scaling.ranges.to(gm.dtype)
    mean = torch.einsum("rma,tr->mat", gm, Wm)
    var = torch.einsum("rma,tr->mat", gv, Wv)
    return (mean * inv_rng[None, :, None],
            var * (inv_rng ** 2)[None, :, None])


def precompute_fast_multivariate(
    emu: MultivariateEmulator,
) -> FastPredictorState:
    """Batched (r, ...) FastPredictorState: explicit per-component
    triangular inverses of the stored factorizations, so serving is
    GEMM-only (`gp.predict_fast`); one-time r N^3/3."""
    if emu.dZ is not None:
        raise ValueError(
            "fast (GEMM-only) serving does not support gradient-enhanced "
            "emulators; use predict_multivariate (the joint cross build "
            "dominates, not the solves)"
        )
    return fast_predictor_from_state(emu.states)


def _predict_components_fast(
    fast_states: FastPredictorState, params: GPParams, X: torch.Tensor,
    Z: torch.Tensor, Xs: torch.Tensor, config: GPConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-component GEMM-only posterior at Xs: (r, m) each."""
    return predict_fast(fast_states, params, GPData(X=X, y=Z.mT), Xs, config)


def predict_multivariate_fast(
    emu: MultivariateEmulator, fast_states: FastPredictorState, Xs_raw
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GEMM-only multivariate serving (see `precompute_fast_multivariate`):
    (m, t), (m, t)."""
    m_pc, v_pc = _predict_components_fast(
        fast_states, emu.params, emu.X, emu.Z, _scaled_queries(emu, Xs_raw),
        emu.config)
    return reconstruct_observables(m_pc, v_pc, emu.pca)


def fit_multivariate(
    generator: torch.Generator,
    X_raw: torch.Tensor,
    Y: torch.Tensor,
    config: GPConfig,
    pca_variance: float = 0.95,
    standardize: bool = True,
    param_ranges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    restart_chunk: Optional[int] = None,
    alpha_grid: Optional[Tuple[float, ...]] = None,
    alpha_refine: int = 0,
    noise=None,
    gradients=None,
    gradient_noise=None,
) -> MultivariateEmulator:
    """Train a multivariate emulator (the `estimate_thetas` dense path).

    X_raw (N, d) is the unscaled design and Y (N, t) the observables, both
    tensors on the device to train on, in the training dtype. The design is
    scaled to the unit box (or by param_ranges), Y is reduced by PCA on the
    host to the r components covering pca_variance, every component's GP
    is fitted in one lock-step batch over (component x restart) lanes
    (`_vmapped_fit`), and the serve states are built for the best thetas.

    alpha_grid (power-exponential only) profiles the kernel exponent: the
    whole fit runs once per grid value, with the same restarts, and the
    emulator with the best total LML (sum over components of the best
    restart) wins; alpha_refine > 0 adds that many golden-section probes
    around the grid winner (`models.fit._golden_refine_alpha`).

    noise: per-point observation-noise variances, (N,) in the original y
    units for every output or (N, t); `project_noise` maps them into each
    component's Gram diagonal. gradients: observed output gradients
    (N, d, t) w.r.t. the RAW inputs ((N, d) when t == 1): every component
    then trains as a joint value + gradient GP (`project_gradients`; needs
    power_exponential alpha=2 or matern52[_ard]); gradient_noise: their
    known variances, same shape.
    """
    if alpha_grid:
        if config.covariance is not CovarianceFamily.POWER_EXPONENTIAL:
            raise ValueError(
                "alpha_grid applies to the power-exponential family only"
            )
        emus: dict = {}

        def eval_alpha(a: float) -> float:
            cfg_a = dataclasses.replace(config, power_exp_alpha=float(a))
            emu_a = fit_multivariate(
                _fit.generator_copy(generator), X_raw, Y, cfg_a,
                pca_variance=pca_variance, standardize=standardize,
                param_ranges=param_ranges, restart_chunk=restart_chunk,
                noise=noise, gradients=gradients,
                gradient_noise=gradient_noise,
            )
            lls = emu_a.restart_log_likelihoods
            best = torch.where(torch.isfinite(lls), lls, -torch.inf)
            total = float(best.amax(dim=1).sum())
            logger.info("alpha_grid: alpha=%g total best logL=%.6g", a, total)
            emus[round(float(a), 6)] = emu_a
            return total

        best_a, _ = _fit._profile_alpha(eval_alpha, alpha_grid, alpha_refine)
        if alpha_refine > 0:
            logger.info("alpha_refine: winner alpha=%g", best_a)
        return emus[best_a]
    scaling = fit_scaling(X_raw, ranges=param_ranges)
    X = apply_scaling(X_raw, scaling)
    pca_np, Z_np = pca_decompose(Y.detach().cpu().numpy(), pca_variance,
                                 standardize=standardize)

    def dev(a):
        return torch.as_tensor(a).to(device=X.device)

    pca = PCAState(*(dev(a) for a in pca_np))
    Z = dev(Z_np).to(X.dtype)

    def on_device(a):
        return torch.as_tensor(a).to(device=X.device, dtype=X.dtype)

    noise_pc = (None if noise is None
                else project_noise(on_device(noise), pca, dtype=X.dtype))
    dZ = (None if gradients is None
          else project_gradients(on_device(gradients), pca, scaling,
                                 dtype=X.dtype))
    dZ_noise = (None if gradient_noise is None
                else project_gradient_noise(on_device(gradient_noise), pca,
                                            scaling, dtype=X.dtype))
    if dZ_noise is not None and dZ is None:
        raise ValueError("gradient_noise given without gradients")
    logger.info(
        "fit_multivariate: N=%d d=%d t=%d -> r=%d components "
        "(pca_variance=%g)", X.shape[0], X.shape[1], Y.shape[1], Z.shape[1],
        pca_variance,
    )
    fit = _vmapped_fit(generator, X, Z, config, restart_chunk=restart_chunk,
                       noise_pc=noise_pc, dZ=dZ, dZ_noise=dZ_noise)
    states = _vmapped_states(fit.params, X, Z, config, noise_pc=noise_pc,
                             dZ=dZ, dZ_noise=dZ_noise)
    lls = fit.restart_log_likelihoods.detach().cpu().numpy()
    for i in range(Z.shape[1]):
        finite = np.isfinite(lls[i])
        if not finite.any():
            logger.warning(
                "fit_multivariate: component %d/%d has NO feasible restart "
                "(every LML = -inf) — its thetas are an unoptimized "
                "fallback and its predictions will be garbage.",
                i, Z.shape[1],
            )
        else:
            logger.info(
                "  component %d: best logL %.6g (%d/%d restarts finite)",
                i, float(lls[i][finite].max()), int(finite.sum()),
                lls.shape[1],
            )
    return MultivariateEmulator(
        scaling=scaling, X=X, Z=Z, pca=pca, params=fit.params, states=states,
        config=config, restart_log_likelihoods=fit.restart_log_likelihoods,
        noise=noise_pc, fit_stats=fit.stats, dZ=dZ, dZ_noise=dZ_noise,
    )


class IterativeMultivariateEmulator(NamedTuple):
    """A trained multivariate emulator with NO dense serving state: both
    fitting and serving run matrix-free (`models.iterative`), so memory is
    O(N (rank + probes)) instead of r N^2. The PCA pipeline, theta layout
    and reconstruction are `MultivariateEmulator`'s; only the per-component
    GP engine differs. It has no gradient fields: the matrix-free engine
    has no joint value + gradient operator."""

    scaling: DesignScaling
    X: torch.Tensor  # (N, d) scaled design
    Z: torch.Tensor  # (N, r) PC scores
    pca: PCAState
    params: GPParams  # batched (r, ...) per-component hyperparameters
    config: GPConfig
    restart_log_likelihoods: Optional[torch.Tensor] = None  # (r, R)
    noise: Optional[torch.Tensor] = None  # (N, r) PC-space noise variances

    @property
    def n_components(self) -> int:
        return self.Z.shape[1]

    @property
    def n_outputs(self) -> int:
        return self.pca.ymean.shape[0]

    def component_data(self, i: int) -> GPData:
        """GPData of component i, with its PC-space noise column."""
        nz = None if self.noise is None else self.noise[:, i]
        return GPData(X=self.X, y=self.Z[:, i], noise=nz)


def fit_multivariate_iterative(
    generator: torch.Generator,
    X_raw: torch.Tensor,
    Y: torch.Tensor,
    config: GPConfig,
    pca_variance: float = 0.95,
    standardize: bool = True,
    param_ranges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    noise=None,
    **iter_kwargs,
) -> IterativeMultivariateEmulator:
    """Matrix-free multivariate training (the `estimate_thetas` path past
    dense memory). The scaling, PCA and noise projection are
    `fit_multivariate`'s; the components are fitted one after another by
    `models.iterative.fit_gp_iterative`, each drawing its restarts from
    `generator` in component order (at the N where this path matters one
    component's solves fill the card). iter_kwargs forward to
    fit_gp_iterative (rank, probes, lanczos_iters, cg_tol, cg_max_iters,
    seed, vg_batch, logdet_method, row_chunk, checkpoint_path: one file per
    component, PATH.c<i>). `noise`: per-point observation-noise variances,
    (N,) or (N, t) (`project_noise`)."""
    from madaiemulator_tpu_torch.models.iterative import fit_gp_iterative

    scaling = fit_scaling(X_raw, ranges=param_ranges)
    X = apply_scaling(X_raw, scaling)
    pca_np, Z_np = pca_decompose(Y.detach().cpu().numpy(), pca_variance,
                                 standardize=standardize)
    pca = PCAState(*(torch.as_tensor(a).to(device=X.device) for a in pca_np))
    Z = torch.as_tensor(Z_np).to(device=X.device, dtype=X.dtype)
    noise_pc = (None if noise is None else project_noise(
        torch.as_tensor(noise).to(device=X.device, dtype=X.dtype), pca,
        dtype=X.dtype))
    r = Z.shape[1]
    logger.info(
        "fit_multivariate_iterative: N=%d d=%d t=%d -> r=%d components",
        X.shape[0], X.shape[1], Y.shape[1], r,
    )
    ckpt = iter_kwargs.pop("checkpoint_path", None)
    fits = []
    for i in range(r):
        # one checkpoint file per component: sequential fits must not
        # resume from each other's optimizer state
        kw = (iter_kwargs if ckpt is None
              else {**iter_kwargs, "checkpoint_path": f"{ckpt}.c{i}"})
        fits.append(fit_gp_iterative(
            generator,
            GPData(X=X, y=Z[:, i],
                   noise=None if noise_pc is None else noise_pc[:, i]),
            config, **kw))
        if not math.isfinite(float(fits[-1].log_likelihood)):
            logger.warning(
                "fit_multivariate_iterative: component %d/%d has NO "
                "feasible restart (best LML = -inf) — its thetas are an "
                "unoptimized fallback and its predictions will be garbage.",
                i, r,
            )
    params = GPParams(*(torch.stack(a) for a in
                        zip(*(f.params for f in fits))))
    return IterativeMultivariateEmulator(
        scaling=scaling, X=X, Z=Z, pca=pca, params=params, config=config,
        restart_log_likelihoods=torch.stack(
            [f.restart_log_likelihoods for f in fits]),
        noise=noise_pc,
    )


def precompute_iterative_multivariate(
    emu: IterativeMultivariateEmulator,
    rank: int = 64,
    cg_tol: float = 1e-6,
    cg_max_iters: int = 256,
    jitter: Optional[float] = None,
    row_chunk: int = 2048,
) -> list:
    """Per-component `IterativePosteriorState` list: the matrix-free
    serving cache (preconditioner + training solves), built once per loaded
    snapshot so that each query batch costs one variance solve (or a
    Woodbury apply) a component."""
    from madaiemulator_tpu_torch.models.iterative import (
        precompute_iterative_predictor,
    )

    return [
        precompute_iterative_predictor(
            GPParams(*(a[i] for a in emu.params)), emu.component_data(i),
            emu.config,
            rank=rank, cg_tol=cg_tol, cg_max_iters=cg_max_iters,
            jitter=jitter, row_chunk=row_chunk,
        )
        for i in range(emu.n_components)
    ]


def predict_multivariate_iterative(
    emu: IterativeMultivariateEmulator,
    Xs_raw,
    states=None,
    **iter_kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matrix-free multivariate serving: (m, t) means and variances, the
    dense path's reconstruction. Pass `states` from
    `precompute_iterative_multivariate` to serve repeated batches without
    re-running the training solves; without it each call precomputes
    (one-shot use). iter_kwargs forward to
    `models.iterative.predict_iterative` (rank, cg_tol, cg_max_iters,
    query_chunk, jitter, variance_method, row_chunk, variance_rhs), or with
    `states` the serving ones to `predict_iterative_from_state`."""
    from madaiemulator_tpu_torch.models.iterative import (
        predict_iterative,
        predict_iterative_from_state,
    )

    Xs = _scaled_queries(emu, Xs_raw)
    ms, vs = [], []
    for i in range(emu.n_components):
        d = emu.component_data(i)
        if states is not None:
            state_kw = {
                k: v for k, v in iter_kwargs.items()
                if k in ("query_chunk", "with_variance", "variance_method",
                         "row_chunk", "variance_rhs")
            }
            m_i, v_i = predict_iterative_from_state(states[i], d, Xs,
                                                    **state_kw)
        else:
            m_i, v_i = predict_iterative(GPParams(*(a[i] for a in emu.params)),
                                         d, Xs, emu.config, **iter_kwargs)
        ms.append(m_i)
        vs.append(v_i)
    return reconstruct_observables(torch.stack(ms), torch.stack(vs), emu.pca)


def emulator_from_numpy(
    arrays: Mapping[str, np.ndarray],
    config: GPConfig,
    device,
    dtype: torch.dtype = torch.float64,
    build_states: bool = True,
):
    """Build the port's emulator from a trained state held as numpy arrays:
    a `MultivariateEmulator` with its serve states rebuilt on `device`, or,
    when build_states is False, an `IterativeMultivariateEmulator` (no
    dense factorization: matrix-free serving, re-encoding, printing). A
    gradient-enhanced state (dZ) has no matrix-free form and raises
    ValueError there.

    Keys (the leaves of a JAX `MultivariateEmulator`): mins, ranges (d,);
    X (N, d) scaled design; Z (N, r); ymean, ystd (t,); eigenvalues (r,);
    U (t, r); log_amp, log_nugget (r,); log_ls (r, k); optional noise
    (N, r), dZ and dZ_noise (N, d, r).
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
    noise, dZ, dZ_noise = (t(k) if arrays.get(k) is not None else None
                           for k in ("noise", "dZ", "dZ_noise"))
    if not build_states:
        if dZ is not None:
            raise ValueError(
                "gradient-enhanced snapshots serve through the dense path "
                "only (build_states=True): the matrix-free engine has no "
                "joint value+gradient operator"
            )
        return IterativeMultivariateEmulator(
            scaling=scaling, X=X, Z=Z, pca=pca, params=params, config=config,
            noise=noise,
        )
    return MultivariateEmulator(
        scaling=scaling, X=X, Z=Z, pca=pca, params=params,
        states=_vmapped_states(params, X, Z, config, noise_pc=noise, dZ=dZ,
                               dZ_noise=dZ_noise),
        config=config, noise=noise, dZ=dZ, dZ_noise=dZ_noise,
    )
