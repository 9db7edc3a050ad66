"""Multi-fidelity emulation: Kennedy-O'Hagan AR(1) co-kriging in its
recursive form (port of madaiemulator_tpu/models/multifidelity.py).

Levels run cheapest first; level k is linked to level k-1 by

    y_k(x) = rho_k * y_{k-1}(x) + delta_k(x),      delta_k ~ GP

(Kennedy & O'Hagan 2000). Le Gratiet's recursive decoupling makes level k
an ordinary GP regression of y_k whose GLS basis gains one extra column,
the lower level's value at the level-k design (observed on nested designs,
or the trained lower levels' recursive mean otherwise): that column's GLS
coefficient is rho_k (`GPData.h_extra`, appended after the polynomial
basis, so rho_k = state.beta[..., -1]).

  - rho_k and the trend are profiled out in closed form inside every
    likelihood evaluation; each level fits with the usual lock-step
    multi-restart L-BFGS (`models.fit.fit_gp`), drawing its restarts from
    the caller's generator in level order;
  - prediction recurses: the mean uses the lower level's mean as the query
    basis column, the variance adds rho_k^2 var_{k-1} to level k's own GP
    variance, whose GLS correction carries the (beta, rho) uncertainty.

Every level fits and serves dense (`models.gp`): at float32 on the card
each level's Gram and cross covariance are K1 launches, and its
factorization is K2 (N <= `pallas_cholesky_max_n`) or the left-looking
factorization with K3 on each diagonal panel above it.

The multivariate twin runs the PCA pipeline across the levels: one PCA
basis fitted on the pooled outputs of every level, each level's outputs
projected to PC scores under it, and the scalar recursion per component.
The component axis is the batch axis of one lock-step fit per level
(`models.multivariate._vmapped_fit` with `H_pc`).
"""

from __future__ import annotations

import logging
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from madaiemulator_tpu_torch.models.fit import FitResult, fit_gp
from madaiemulator_tpu_torch.models.gp import (
    GPData,
    GPPosteriorState,
    precompute_predictor,
    predict_from_precomputed,
)
from madaiemulator_tpu_torch.models.multivariate import (
    PCAState,
    _component_batch,
    _vmapped_fit,
    _vmapped_states,
    pca_decompose,
    project_noise,
    project_scores,
    reconstruct_observables,
)
from madaiemulator_tpu_torch.ops.kernels import GPParams
from madaiemulator_tpu_torch.utils.config import GPConfig
from madaiemulator_tpu_torch.utils.designs import (
    DesignScaling,
    apply_scaling,
    fit_scaling,
)

logger = logging.getLogger("madaiemulator_tpu_torch")


class FidelityLevel(NamedTuple):
    """One trained level: its scaled data, hyperparameters, serve state and,
    for levels >= 1, the fitted AR(1) scale rho (the GLS coefficient of the
    lower-fidelity basis column; 0 at level 0)."""

    data: GPData
    params: GPParams
    state: GPPosteriorState
    rho: torch.Tensor  # ()


class MultiFidelityEmulator(NamedTuple):
    scaling: DesignScaling  # one scaling shared by every level
    levels: Tuple[FidelityLevel, ...]
    config: GPConfig

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def rho(self) -> torch.Tensor:
        """AR(1) scales (n_levels - 1,): rho[k] links level k+1 to k."""
        return torch.stack([lv.rho for lv in self.levels[1:]])


def _check_levels(designs, targets, lower_values, noise) -> tuple:
    L = len(designs)
    if len(targets) != L:
        raise ValueError(
            f"designs/targets length mismatch: {L} vs {len(targets)}")
    if L < 1:
        raise ValueError("need at least one fidelity level")
    lower_values = list(lower_values or [None] * (L - 1))
    if len(lower_values) != L - 1:
        raise ValueError(
            f"lower_values must have {L - 1} entries (levels 1..{L - 1})")
    noise = list(noise or [None] * L)
    if len(noise) != L:
        raise ValueError(f"noise must have {L} entries")
    return L, lower_values, noise


def _on(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a).to(device=like.device, dtype=like.dtype)


def _union_scaling(designs, param_ranges, like) -> DesignScaling:
    """One scaling over the union of the level designs: every level lives
    in the same unit cube."""
    return fit_scaling(torch.cat([_on(X, like) for X in designs]),
                       ranges=param_ranges)


def _predict_level(lv: FidelityLevel, Xs: torch.Tensor, config: GPConfig,
                   lower_mean: Optional[torch.Tensor]):
    hs = None if lower_mean is None else lower_mean[:, None]
    return predict_from_precomputed(lv.state, lv.params, lv.data, Xs, config,
                                    hs_extra=hs)


def fit_multifidelity(
    generator: torch.Generator,
    designs: Sequence[torch.Tensor],
    targets: Sequence[torch.Tensor],
    config: GPConfig,
    lower_values: Optional[Sequence[Optional[torch.Tensor]]] = None,
    noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
    param_ranges=None,
    **fit_kwargs,
) -> MultiFidelityEmulator:
    """Train an AR(1) co-kriging emulator over fidelity levels 0..L-1
    (level 0 the cheapest and largest, level L-1 the target fidelity).

    designs[k] (N_k, d) raw design of level k and targets[k] (N_k,) its
    outputs, tensors on the device to train on, in the training dtype.
    lower_values[k-1] (optional, per level >= 1): the OBSERVED level-(k-1)
    output at designs[k] (exact recursive co-kriging on nested designs);
    without it the trained lower levels' recursive mean at designs[k] is
    used. noise[k]: per-point observation-noise variances of level k.
    fit_kwargs forward to `models.fit.fit_gp` (n_restarts, max_steps,
    restart_chunk); each level draws its restarts from `generator`, in
    level order."""
    L, lower_values, noise = _check_levels(designs, targets, lower_values,
                                           noise)
    like = torch.as_tensor(targets[0])
    scaling = _union_scaling(designs, param_ranges, like)
    levels: List[FidelityLevel] = []
    for k in range(L):
        Xk = apply_scaling(_on(designs[k], like), scaling)
        yk = _on(targets[k], like)
        nz = None if noise[k] is None else _on(noise[k], like)
        h = None
        if k > 0:
            if lower_values[k - 1] is not None:
                h = _on(lower_values[k - 1], like)
            else:
                # the recursive mean of the already-trained levels 0..k-1
                h, _ = _predict_recursive(levels, Xk, config)
            h = h[:, None]  # (N_k, 1): its GLS coefficient is rho_k
        data = GPData(X=Xk, y=yk, noise=nz, h_extra=h)
        fit: FitResult = fit_gp(generator, data, config, **fit_kwargs)
        state = precompute_predictor(fit.params, data, config)
        rho = state.beta[-1] if k > 0 else torch.zeros((), dtype=like.dtype,
                                                        device=like.device)
        levels.append(FidelityLevel(data=data, params=fit.params,
                                    state=state, rho=rho))
    return MultiFidelityEmulator(scaling=scaling, levels=tuple(levels),
                                 config=config)


def _predict_recursive(levels: Sequence[FidelityLevel], Xs: torch.Tensor,
                       config: GPConfig):
    """Recursive mean and variance through trained levels at SCALED queries:
    mean_k = H beta + rho_k mean_{k-1} + k*^T alpha (rho inside the basis),
    var_k = rho_k^2 var_{k-1} + varGP_k."""
    mean, var = _predict_level(levels[0], Xs, config, None)
    for lv in levels[1:]:
        m_k, v_k = _predict_level(lv, Xs, config, mean)
        mean = m_k
        var = lv.rho ** 2 * var + v_k
    return mean, var


def _check_level(level, L: int) -> int:
    level = L - 1 if level is None else level
    if not 0 <= level < L:
        raise ValueError(f"level {level} out of range [0, {L})")
    return level


def predict_multifidelity(
    emu: MultiFidelityEmulator, Xs_raw, level: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and variance of fidelity `level` (default: the
    highest) at raw query points (m, d) -> ((m,), (m,))."""
    level = _check_level(level, emu.n_levels)
    X0 = emu.levels[0].data.X
    Xs = apply_scaling(_on(Xs_raw, X0), emu.scaling)
    return _predict_recursive(emu.levels[:level + 1], Xs, emu.config)


# --- multivariate (t > 1) multi-fidelity ------------------------------------


class MVFidelityLevel(NamedTuple):
    """One trained level of a multivariate multi-fidelity emulator: params
    and states carry the component axis (r, ...) in front; Z, H and noise
    carry it last."""

    X: torch.Tensor  # (N_k, d) scaled design
    Z: torch.Tensor  # (N_k, r) PC-score targets
    H: Optional[torch.Tensor]  # (N_k, r) lower-level columns; None at k=0
    noise: Optional[torch.Tensor]  # (N_k, r) PC-space noise variances
    params: GPParams  # (r, ...)
    states: GPPosteriorState  # (r, ...)
    rho: torch.Tensor  # (r,) AR(1) scales; zeros at level 0


class MultivariateMultiFidelityEmulator(NamedTuple):
    """`restart_log_likelihoods` (one (r, R) tensor a level) and
    `fit_stats` (each level's `FitResult.stats`) are None for an emulator
    read from a snapshot."""

    scaling: DesignScaling  # shared by the levels
    pca: PCAState  # ONE basis shared by every level
    levels: Tuple[MVFidelityLevel, ...]
    config: GPConfig
    restart_log_likelihoods: Optional[Tuple[torch.Tensor, ...]] = None
    fit_stats: Optional[Tuple[dict, ...]] = None

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def n_components(self) -> int:
        return self.levels[0].Z.shape[1]

    @property
    def n_outputs(self) -> int:
        return self.pca.ymean.shape[0]

    @property
    def rho(self) -> torch.Tensor:
        """AR(1) scales (n_levels - 1, r): rho[k, i] links level k+1 to
        level k in component i's score space."""
        return torch.stack([lv.rho for lv in self.levels[1:]])


def _predict_level_components(lv: MVFidelityLevel, Xs: torch.Tensor,
                              config: GPConfig,
                              lower_mean: Optional[torch.Tensor]):
    """(r, m) mean and variance of one level's components, batched over the
    component axis (one cross covariance for every component); lower_mean
    (r, m) is each component's hs_extra query column."""
    data = _component_batch(lv.X, lv.Z, H_pc=lv.H)
    hs = None if lower_mean is None else lower_mean[:, :, None]
    return predict_from_precomputed(lv.states, lv.params, data, Xs, config,
                                    hs_extra=hs)


def _predict_recursive_mv(levels: Sequence[MVFidelityLevel],
                          Xs: torch.Tensor, config: GPConfig):
    """The componentwise recursion: (r, m) score-space mean and variance
    through the level chain (`_predict_recursive`, batched over r)."""
    mean, var = _predict_level_components(levels[0], Xs, config, None)
    for lv in levels[1:]:
        m_k, v_k = _predict_level_components(lv, Xs, config, mean)
        mean = m_k
        var = lv.rho[:, None] ** 2 * var + v_k
    return mean, var


def fit_multivariate_multifidelity(
    generator: torch.Generator,
    designs: Sequence[torch.Tensor],
    targets: Sequence[torch.Tensor],
    config: GPConfig,
    pca_variance: float = 0.95,
    standardize: bool = True,
    lower_values: Optional[Sequence[Optional[torch.Tensor]]] = None,
    noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
    param_ranges=None,
    restart_chunk: Optional[int] = None,
    **fit_kwargs,
) -> MultivariateMultiFidelityEmulator:
    """Train a multivariate AR(1) co-kriging emulator: targets[k] is (N_k,
    t) observables at fidelity k (cheapest first), tensors on the device to
    train on.

    The PCA basis is fitted ONCE on the pooled rows of every level (each
    z-scored with the pooled mean and std): the pooled covariance sees the
    most samples, and a shared basis is what makes the componentwise AR(1)
    recursion well-posed (PC projection is linear, so the link holds per
    component; the affine offset goes to the GLS constant).
    lower_values[k-1] (optional): OBSERVED level-(k-1) outputs (N_k, t) at
    level k's design (nested designs); otherwise the trained lower levels'
    recursive mean is used. noise[k]: per-point observation-noise
    variances, (N_k,) or (N_k, t), projected per component. Each level's
    (r x R) lanes run as one lock-step L-BFGS batch; the levels draw their
    restarts from `generator` in level order, the components of a level in
    component order."""
    L, lower_values, noise = _check_levels(designs, targets, lower_values,
                                           noise)
    like = torch.as_tensor(targets[0])
    t = like.shape[1] if like.ndim == 2 else 1
    for k, Yk in enumerate(targets):
        if Yk.ndim != 2 or Yk.shape[1] != t:
            raise ValueError(
                f"targets[{k}] must be (N_{k}, t={t}); got {tuple(Yk.shape)}")
    scaling = _union_scaling(designs, param_ranges, like)
    dtype, dev = like.dtype, like.device
    # one basis over the pooled outputs (host PCA, as fit_multivariate)
    Y_pool = np.concatenate([torch.as_tensor(Yk).detach().cpu().numpy()
                             for Yk in targets], axis=0)
    pca_np, _ = pca_decompose(Y_pool, pca_variance, standardize=standardize)
    pca = PCAState(*(torch.as_tensor(a).to(device=dev) for a in pca_np))
    r = pca.U.shape[1]
    logger.info(
        "fit_multivariate_multifidelity: L=%d levels, t=%d -> r=%d "
        "components (pca_variance=%g; pooled basis over %d rows)",
        L, t, r, pca_variance, Y_pool.shape[0],
    )
    levels: List[MVFidelityLevel] = []
    lls, stats = [], []
    for k in range(L):
        Xk = apply_scaling(_on(designs[k], like), scaling)
        Zk = project_scores(_on(targets[k], like), pca, dtype=dtype)
        nz = (None if noise[k] is None
              else project_noise(_on(noise[k], like), pca, dtype=dtype))
        H = None
        if k > 0:
            if lower_values[k - 1] is not None:
                H = project_scores(_on(lower_values[k - 1], like), pca,
                                   dtype=dtype)  # (N_k, r)
            else:
                H = _predict_recursive_mv(levels, Xk, config)[0].mT
        fit = _vmapped_fit(generator, Xk, Zk, config,
                           restart_chunk=restart_chunk, noise_pc=nz, H_pc=H,
                           **fit_kwargs)
        states = _vmapped_states(fit.params, Xk, Zk, config, noise_pc=nz,
                                 H_pc=H)
        rho = (states.beta[:, -1] if k > 0
               else torch.zeros((r,), dtype=dtype, device=dev))
        levels.append(MVFidelityLevel(X=Xk, Z=Zk, H=H, noise=nz,
                                      params=fit.params, states=states,
                                      rho=rho))
        lls.append(fit.restart_log_likelihoods)
        stats.append(fit.stats)
        finite = torch.isfinite(fit.restart_log_likelihoods).any(dim=1)
        for i in np.flatnonzero(~finite.cpu().numpy()):
            logger.warning(
                "fit_multivariate_multifidelity: level %d component %d/%d "
                "has NO feasible restart — predictions through this "
                "component will be garbage.", k, i, r)
    return MultivariateMultiFidelityEmulator(
        scaling=scaling, pca=pca, levels=tuple(levels), config=config,
        restart_log_likelihoods=tuple(lls), fit_stats=tuple(stats))


def predict_multivariate_multifidelity(
    emu: MultivariateMultiFidelityEmulator, Xs_raw,
    level: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Observable-space posterior mean and variance of fidelity `level`
    (default: the highest) at raw queries: (m, d) -> ((m, t), (m, t)): the
    componentwise recursion in score space, then the PCA reconstruction
    (`models.multivariate.reconstruct_observables`)."""
    level = _check_level(level, emu.n_levels)
    X0 = emu.levels[0].X
    Xs = apply_scaling(_on(Xs_raw, X0), emu.scaling)
    m_pc, v_pc = _predict_recursive_mv(emu.levels[:level + 1], Xs,
                                       emu.config)
    return reconstruct_observables(m_pc, v_pc, emu.pca)


def is_multifidelity(emu) -> bool:
    return isinstance(emu, (MultiFidelityEmulator,
                            MultivariateMultiFidelityEmulator))
