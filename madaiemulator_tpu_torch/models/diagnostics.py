"""Emulator validation diagnostics and posterior sampling (port of
madaiemulator_tpu/models/diagnostics.py).

  * Closed-form leave-one-out cross-validation for the universal-kriging
    (GLS mean) GP, with no refits: with the projected precision
        P = C^-1 - W A^-1 W^T,   W = C^-1 H,  A = H^T C^-1 H
    the model trained on the other N-1 points (beta re-estimated by GLS on
    them) predicts point i with
        residual_i = (P y)_i / P_ii = alpha_i / P_ii,  variance_i = 1 / P_ii
    (Dubrule 1983; P y = alpha because beta is the GLS maximizer). Cost:
    one factorization and one triangular inversion.
  * Validation summaries (RMSE, standardized-error moments, central-interval
    coverage, log pseudo-likelihood) for LOO, a holdout block, or a sparse
    emulator's training residuals.
  * The full posterior covariance over a query block and exact joint
    posterior draws (eigendecomposition-based, safe for the rank
    deficiency a GP posterior covariance has when m > N), dense and
    matrix-free.
  * Multivariate (PCA) variants, batched over the component axis (the JAX
    package vmaps it), rotated back to observable space.
  * Per-level LOO of a multi-fidelity emulator (scalar and multivariate):
    each level is an ordinary GP whose GLS basis carries the lower level's
    values as one column, so the identity applies level by level with that
    column held fixed.

Random draws (the holdout permutation and the standard normals of the
posterior draws) come from an explicit `torch.Generator`, each through one
private helper (`_permutation`, `_normal_draws`); the JAX package draws from
jax.random, so the draws differ between the packages by design.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from madaiemulator_tpu_torch.models.gp import (
    GPData,
    GPPosteriorState,
    _factor,
    regression_basis,
)
from madaiemulator_tpu_torch.models.iterative import (
    _matvec_for,
    pcg_solve,
    precompute_iterative_predictor,
    predict_iterative_from_state,
)
from madaiemulator_tpu_torch.models.multivariate import (
    _scaled_queries,
    reconstruct_observables,
)
from madaiemulator_tpu_torch.models.sparse import predict_multivariate_sparse
from madaiemulator_tpu_torch.ops import kernels, linalg
from madaiemulator_tpu_torch.ops.kernels import GPParams
from madaiemulator_tpu_torch.utils.config import GPConfig


class LOOResult(NamedTuple):
    """Leave-one-out predictions for each training point, (*B, N) each.

    mean / variance are the LOO predictive distribution of the OBSERVED
    value y_i (they include the nugget: the diagonal of C does), residual
    is y_i - mean_i, standardized is residual_i / sqrt(variance_i): ~N(0, 1)
    when the emulator's error model is calibrated.
    """

    mean: torch.Tensor
    variance: torch.Tensor
    residual: torch.Tensor
    standardized: torch.Tensor
    ok: torch.Tensor  # (*B,) bool: factorization succeeded


def _normal_draws(generator: torch.Generator, shape: tuple, dtype,
                  device) -> torch.Tensor:
    """Standard normals of `shape`, drawn on the CPU from `generator` (a CPU
    generator) in float64 and moved to `device` in `dtype`."""
    z = torch.randn(shape, generator=generator, dtype=torch.float64)
    return z.to(device=device, dtype=dtype)


def _permutation(generator: torch.Generator, n: int) -> np.ndarray:
    """A random permutation of range(n) from `generator`, as numpy ints."""
    return torch.randperm(n, generator=generator).numpy()


def _projected_precision_diag(st: GPPosteriorState) -> torch.Tensor:
    """diag(P), P = C^-1 - W A^-1 W^T, from a factorization state: (*B, N).
    L^-1 by a triangular solve against I at float64, by
    `linalg.tri_inv_block` at "highest" at float32 (the JAX package's
    routes)."""
    L = st.L
    n = L.shape[-1]
    if L.dtype == torch.float64:
        eye = torch.eye(n, dtype=L.dtype, device=L.device)
        Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    else:
        Linv = linalg.tri_inv_block(L, precision="highest")
    cinv_diag = (Linv * Linv).sum(-2)  # diag(L^-T L^-1)
    del Linv
    # W = C^-1 H = L^-T (L^-1 H); diag(W A^-1 W^T) = sum(W * (A^-1 W^T)^T)
    W = linalg.solve_upper_t(L, st.Linv_H)  # (*B, N, p)
    Zp = linalg.cho_solve(st.LA, W.mT)  # (*B, p, N) = A^-1 W^T
    return cinv_diag - (W * Zp.mT).sum(-1)


def _loo_from_state(st: GPPosteriorState, y: torch.Tensor) -> LOOResult:
    """LOO predictions from an existing factorization state (no refactor);
    y (*B, N) the training targets the state was built on."""
    pdiag = _projected_precision_diag(st)
    # SPD C + full-rank H (N > p) guarantee pdiag > 0; the floor only
    # guards the gated-failure branch (ok False) from dividing by ~0
    pdiag = torch.clamp(pdiag, min=torch.finfo(pdiag.dtype).tiny)
    resid = st.alpha / pdiag
    var = 1.0 / pdiag
    ok = st.ok[..., None]
    nan = torch.tensor(float("nan"), dtype=pdiag.dtype, device=pdiag.device)
    return LOOResult(
        mean=torch.where(ok, y - resid, nan),
        variance=torch.where(ok, var, nan),
        residual=torch.where(ok, resid, nan),
        standardized=torch.where(ok, resid / torch.sqrt(var), nan),
        ok=st.ok,
    )


def loo_cv(params: GPParams, data: GPData, config: GPConfig) -> LOOResult:
    """Closed-form leave-one-out cross-validation (module docstring): the
    GLS mean refitted on each size-(N-1) subset predicting the held-out
    point, hyperparameters fixed. Batched like `gp._factor` (params and y
    with a leading (*B,))."""
    if data.dY is not None:
        raise ValueError(
            "loo_cv does not support gradient-enhanced data: leaving out a "
            "value row while keeping its gradient rows is not a "
            "leave-one-POINT-out validation; drop dY (refit values-only) "
            "to cross-validate"
        )
    with torch.no_grad():
        return _loo_from_state(_factor(data, params, config), data.y)


def _norm_ppf(p: float) -> float:
    """Standard-normal quantile (Acklam's rational approximation, |rel
    err| < 1.2e-9)."""
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if not 0.0 < p < 1.0:
        raise ValueError("p must be in (0, 1)")
    if p < plow:
        q = np.sqrt(-2.0 * np.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
                + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > phigh:
        return -_norm_ppf(1.0 - p)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
            + a[5]) * q / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r
                            + b[4]) * r + 1)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a, dtype=np.float64).ravel()


def validation_summary(
    mean, variance, y_true, interval: float = 0.95
) -> Dict[str, float]:
    """Host-side calibration summary of predictive (mean, variance) against
    the truth: rmse / mae, moments of the standardized errors (target 0 /
    1), the fraction of truths inside the central `interval` (target
    `interval`) and the Gaussian log predictive density summed over the
    points (the LOO pseudo-likelihood when fed LOOResult fields)."""
    mean, var, y = _host(mean), _host(variance), _host(y_true)
    err = y - mean
    std = np.sqrt(np.maximum(var, np.finfo(np.float64).tiny))
    zed = err / std
    zcrit = _norm_ppf(0.5 * (1.0 + interval))
    return {
        "n": int(y.size),
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mae": float(np.mean(np.abs(err))),
        "standardized_mean": float(np.mean(zed)),
        "standardized_std": float(np.std(zed)),
        "coverage": float(np.mean(np.abs(zed) <= zcrit)),
        "coverage_target": float(interval),
        # the floored std, so an exact-zero variance cannot emit -inf
        "log_pseudo_likelihood": float(
            np.sum(-0.5 * np.log(2.0 * np.pi) - np.log(std) - 0.5 * zed**2)
        ),
    }


def loo_summary(res: LOOResult, y, **kw) -> Dict[str, float]:
    """validation_summary of a LOOResult against the training vector."""
    return validation_summary(res.mean, res.variance, y, **kw)


# --- full posterior covariance + sampling ----------------------------------


@torch.no_grad()
def posterior_covariance(
    state: GPPosteriorState,
    params: GPParams,
    data: GPData,
    Xs: torch.Tensor,
    config: GPConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean (*B, m) and FULL covariance (*B, m, m) over a query
    block Xs (m, d): `gp._predict_core`'s algebra keeping the cross terms,
        Sigma = K** - V^T V + W^T W,  V = L^-1 K*,  W = LA^-1 G,
    plus the nugget on the diagonal with
    config.predict_variance_includes_nugget. Members whose factorization
    failed (ok False) get NaN. The m x m matrix is materialized: keep query
    blocks to a few thousand points."""
    Ks = kernels.cross_covariance(data.X, Xs, params, config)  # (*B, N, m)
    Hs = regression_basis(Xs, config.regression_order)  # (m, p)
    mean = (Hs @ state.beta[..., None])[..., 0] + (
        Ks.mT @ state.alpha[..., None])[..., 0]
    Kss = kernels.cross_covariance(Xs, Xs, params, config)
    Kss = 0.5 * (Kss + Kss.mT)
    V = linalg.solve_lower(state.L, Ks)  # (*B, N, m)
    cov = Kss - V.mT @ V
    G = Hs.mT - state.Linv_H.mT @ V  # (*B, p, m)
    W = linalg.solve_lower(state.LA, G)
    cov = cov + W.mT @ W
    if config.predict_variance_includes_nugget:
        cov = cov + torch.exp(params.log_nugget)[..., None, None] * torch.eye(
            Xs.shape[-2], dtype=cov.dtype, device=cov.device)
    # a failed state carries placeholder factors: NaN makes its draws
    # visibly invalid, as in loo_cv
    ok = state.ok
    return (torch.where(ok[..., None], mean, torch.nan),
            torch.where(ok[..., None, None], cov, torch.nan))


def _eigh_draws(mean: torch.Tensor, cov: torch.Tensor,
                generator: torch.Generator, num_samples: int) -> torch.Tensor:
    """Exact joint draws from N(mean, cov): (*B, S, m). The symmetric
    eigendecomposition with negative eigenvalues clamped to zero handles a
    GP posterior covariance's exact rank deficiency (m > N) natively,
    where a Cholesky would need a jitter ladder. Shared by the dense and
    matrix-free samplers."""
    lam, U = torch.linalg.eigh(cov)
    scale = torch.sqrt(torch.clamp(lam, min=0.0))
    z = _normal_draws(generator, mean.shape[:-1] + (num_samples,
                                                    mean.shape[-1]),
                      mean.dtype, mean.device)
    return mean[..., None, :] + (z * scale[..., None, :]) @ U.mT


def _rotate_pc_draws(Zs: torch.Tensor, pca) -> torch.Tensor:
    """PC-space joint draws (r, S, m) -> observable space (S, m, t):
    y[s, q, j] = ybar_j + s_j * sum_i sqrt(lam_i) U_ji z_i[s, q]."""
    sqrt_lam = torch.sqrt(pca.eigenvalues.to(Zs.dtype))
    U = pca.U.to(Zs.dtype)
    Y = torch.einsum("rsm,jr->smj", Zs * sqrt_lam[:, None, None], U)
    return (pca.ymean.to(Zs.dtype)[None, None, :]
            + Y * pca.ystd.to(Zs.dtype)[None, None, :])


def sample_posterior(
    state: GPPosteriorState,
    params: GPParams,
    data: GPData,
    Xs: torch.Tensor,
    config: GPConfig,
    generator: torch.Generator,
    num_samples: int,
) -> torch.Tensor:
    """`num_samples` exact joint draws from the GP posterior at Xs:
    (*B, S, m) (`_eigh_draws`)."""
    mean, cov = posterior_covariance(state, params, data, Xs, config)
    return _eigh_draws(mean, cov, generator, num_samples)


# --- multivariate (PCA) variants -------------------------------------------


def loo_cv_multivariate(emu) -> Tuple[LOOResult, torch.Tensor, torch.Tensor]:
    """Per-component LOO, batched over the components, and observable-space
    LOO: (LOOResult with (r, N) fields, loo_mean (N, t), loo_var (N, t)).

    The emulator's own factorization states are reused when it has them
    (they validate exactly the model being served, the jitter rescue
    included, at no extra factorization); a matrix-free emulator carries
    none and refactors densely. Compare against
    `reconstruct_training_outputs` to isolate GP error from PCA truncation
    error, or against the raw Y to include it."""
    if getattr(emu, "dZ", None) is not None:
        raise ValueError(
            "closed-form LOO is not defined for gradient-enhanced "
            "emulators: removing a design point must remove its value AND "
            "gradient rows together, which the per-row Dubrule identity "
            "cannot express. Validate with a holdout refit instead."
        )
    states = getattr(emu, "states", None)
    y = emu.Z.mT  # (r, N)
    if states is not None:
        with torch.no_grad():
            res = _loo_from_state(states, y)
    else:
        noise = getattr(emu, "noise", None)
        res = loo_cv(emu.params, GPData(
            X=emu.X, y=y, noise=None if noise is None else noise.mT),
            emu.config)
    loo_mean, loo_var = reconstruct_observables(res.mean, res.variance,
                                                emu.pca)
    return res, loo_mean, loo_var


def reconstruct_training_outputs(emu) -> torch.Tensor:
    """The training outputs as the retained-r PCA subspace represents them,
    (N, t): ybar + ystd * (Z sqrt(lam)) U^T: the ground truth for
    loo_cv_multivariate when PCA truncation error should be excluded."""
    pca, Z = emu.pca, emu.Z
    sqrt_lam = torch.sqrt(pca.eigenvalues.to(Z.dtype))
    return pca.ymean.to(Z.dtype)[None, :] + (
        (Z * sqrt_lam[None, :]) @ pca.U.to(Z.dtype).mT
    ) * pca.ystd.to(Z.dtype)[None, :]


def loo_summary_multivariate(emu, Y_true=None, **kw) -> Dict[str, float]:
    """Observable-space LOO calibration summary. Y_true defaults to the
    retained-subspace reconstruction of the training outputs (GP error
    only); the raw Y (N, t) includes PCA truncation error, which the error
    bars do not cover."""
    res, loo_mean, loo_var = loo_cv_multivariate(emu)
    ok = res.ok.cpu().numpy()
    if not ok.all():
        bad = np.flatnonzero(~ok).tolist()
        raise ValueError(
            f"LOO unavailable: component(s) {bad} have no valid "
            "factorization (non-SPD even after the jitter rescue) — their "
            "LOO fields are NaN and would silently poison the summary"
        )
    if Y_true is None:
        Y_true = reconstruct_training_outputs(emu)
    return validation_summary(loo_mean, loo_var, Y_true, **kw)


def holdout_cv_multivariate(
    emu,
    generator: torch.Generator,
    n_holdout: int,
    rank: int = 64,
    cg_tol: float = 1e-6,
    cg_max_iters: int = 256,
    jitter: Optional[float] = None,
    query_chunk: int = 128,
    row_chunk: int = 2048,
) -> Tuple[np.ndarray, torch.Tensor, torch.Tensor]:
    """Held-out validation at matrix-free scale: (indices (M,), observable
    mean (M, t), variance (M, t)).

    Exact LOO needs diag(C^-1), a dense-only quantity; past dense memory
    the substitute is a holdout: `n_holdout` training points drawn by
    `_permutation(generator, N)`, the matrix-free serving state rebuilt on
    the other N - M points (training solves only, hyperparameters fixed as
    in LOO), and the held-out block predicted with exact (PCG) variances,
    `query_chunk` queries at a time. Works for the iterative and the dense
    multivariate emulator alike (the same per-component engine)."""
    N = emu.X.shape[0]
    if getattr(emu, "dZ", None) is not None:
        raise ValueError(
            "holdout_cv_multivariate rebuilds a matrix-free serving state, "
            "which has no joint value+gradient operator; refit the held-in "
            "subset with fit_multivariate(gradients=...) instead"
        )
    if not 0 < n_holdout < N:
        raise ValueError(f"n_holdout={n_holdout} must lie in (0, {N})")
    perm = _permutation(generator, N)
    hold, keep = perm[:n_holdout], perm[n_holdout:]
    dev = emu.X.device
    hold_t = torch.tensor(hold, device=dev)
    keep_t = torch.tensor(keep, device=dev)
    Xk, Xh = emu.X[keep_t], emu.X[hold_t]
    ms, vs = [], []
    for i in range(emu.n_components):
        p = GPParams(*(a[i] for a in emu.params))
        d = GPData(X=Xk, y=emu.Z[keep_t, i],
                   noise=None if emu.noise is None else emu.noise[keep_t, i])
        st = precompute_iterative_predictor(
            p, d, emu.config, rank=rank, cg_tol=cg_tol,
            cg_max_iters=cg_max_iters, jitter=jitter, row_chunk=row_chunk)
        m_i, v_i = predict_iterative_from_state(
            st, d, Xh, query_chunk=query_chunk, row_chunk=row_chunk)
        ms.append(m_i)
        vs.append(v_i)
    mean, var = reconstruct_observables(torch.stack(ms), torch.stack(vs),
                                        emu.pca)
    return hold, mean, var


def holdout_summary_multivariate(
    emu,
    generator: torch.Generator,
    n_holdout: int,
    Y_true=None,
    interval: float = 0.95,
    **kw,
) -> Dict[str, float]:
    """Observable-space holdout calibration summary (matrix-free scale);
    Y_true as in `loo_summary_multivariate`. kw forwards to
    holdout_cv_multivariate (rank, cg_tol, cg_max_iters, jitter,
    query_chunk, row_chunk)."""
    hold, mean, var = holdout_cv_multivariate(emu, generator, n_holdout, **kw)
    if Y_true is None:
        Y_true = reconstruct_training_outputs(emu)
    Y_true = torch.as_tensor(Y_true)
    Y_true = Y_true[torch.tensor(hold, device=Y_true.device)]
    return validation_summary(mean, var, Y_true, interval=interval)


@torch.no_grad()
def loo_cv_multifidelity(emu) -> list:
    """Per-level closed-form LOO for a recursive co-kriging emulator: each
    level k is an ordinary GP regression of y_k with the lower level's
    values as one GLS basis column, so leaving out point i of level k
    re-estimates (beta, rho_k) on the remaining points with that column
    held FIXED (conditioned on the lower levels, the usual co-kriging
    convention; the lower levels are validated by their own entries). One
    factorization reuse a level: the states are already built.

    Returns n_levels LOOResult, entry k in level-k target units."""
    return [_loo_from_state(lv.state, lv.data.y) for lv in emu.levels]


def loo_summary_multifidelity(emu, interval: float = 0.95) -> list:
    """`validation_summary` per level (see `loo_cv_multifidelity`)."""
    return [
        validation_summary(r.mean, r.variance, lv.data.y, interval=interval)
        for r, lv in zip(loo_cv_multifidelity(emu), emu.levels)
    ]


@torch.no_grad()
def loo_cv_multifidelity_mv(emu) -> list:
    """Per-level LOO for a MULTIVARIATE multi-fidelity emulator: the
    identity per level and per component (the lower-level columns held
    fixed, as in `loo_cv_multifidelity`), batched over the components, then
    rotated to observable space. Returns n_levels entries (LOOResult with
    (r, N_k) fields, loo_mean (N_k, t), loo_var (N_k, t)); the ground truth
    of level k is `reconstruct_level_targets_mv(emu, k)`."""
    out = []
    for lv in emu.levels:
        res = _loo_from_state(lv.states, lv.Z.mT)  # (r, N_k)
        loo_mean, loo_var = reconstruct_observables(res.mean, res.variance,
                                                    emu.pca)
        out.append((res, loo_mean, loo_var))
    return out


def reconstruct_level_targets_mv(emu, k: int) -> torch.Tensor:
    """Level k's training targets as the retained-r shared PCA subspace
    represents them, (N_k, t): the truncation-free ground truth of
    `loo_cv_multifidelity_mv` (see `reconstruct_training_outputs`)."""
    pca, Z = emu.pca, emu.levels[k].Z
    sqrt_lam = torch.sqrt(pca.eigenvalues.to(Z.dtype))
    return pca.ymean.to(Z.dtype)[None, :] + (
        (Z * sqrt_lam[None, :]) @ pca.U.to(Z.dtype).mT
    ) * pca.ystd.to(Z.dtype)[None, :]


def training_residuals_sparse(
    emu, X_raw, query_chunk: int = 4096
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior (mean, variance), (N, t) each, of a sparse emulator at its
    own training inputs, in chunks of `query_chunk` points so the (m,
    chunk) cross-covariance never scales with N.

    An SGPR posterior has only m << N effective degrees of freedom, so
    training-point residuals measure real out-of-subspace error (a dense GP
    interpolates its data, making them vacuous), and the Titsias variance
    is conservative: coverage should be at or above target. The serve
    state keeps no training arrays, hence the caller supplies X_raw (and
    compares against its own Y)."""
    X_raw = torch.as_tensor(X_raw)
    N = X_raw.shape[0]
    chunk = int(min(query_chunk, N))
    parts = [predict_multivariate_sparse(emu, X_raw[s:s + chunk])
             for s in range(0, N, chunk)]
    return (torch.cat([m for m, _ in parts]),
            torch.cat([v for _, v in parts]))


def training_summary_sparse(
    emu, X_raw, Y, interval: float = 0.95, query_chunk: int = 4096
) -> Dict[str, float]:
    """Calibration summary of a sparse emulator on its training set; Y is
    the raw (N, t) training output block (e.g. from the model file)."""
    mean, var = training_residuals_sparse(emu, X_raw, query_chunk)
    return validation_summary(mean, var, Y, interval=interval)


@torch.no_grad()
def posterior_covariance_iterative(
    state, data: GPData, Xs: torch.Tensor, col_chunk: int = 128,
    row_chunk: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matrix-free posterior mean (m,) and FULL covariance (m, m):
    `posterior_covariance`'s algebra with every N-dimensional solve by the
    cached `IterativePosteriorState`'s PCG (its preconditioner, tolerance
    and budget) instead of a dense factorization:
        Sigma = K** - K*^T C^-1 K* + G^T A^-1 G,  G = Hs^T - CiH^T K*.
    The C^-1 K* solve runs `col_chunk` right-hand sides at a time (each
    column's Krylov solve is independent of the others); `row_chunk` bounds
    the matvec's kernel tiles. Only the m x m result is materialized."""
    params, config = state.params, state.config
    Ks = kernels.cross_covariance(data.X, Xs, params, config)  # (N, m)
    Hs = regression_basis(Xs, config.regression_order)  # (m, p)
    mean = Hs @ state.beta + Ks.mT @ state.alpha
    mv = _matvec_for(params, data, config, None, row_chunk)
    m = Xs.shape[0]
    CiKs = torch.cat([
        pcg_solve(mv, Ks[:, j:j + col_chunk], state.pre, tol=state.cg_tol,
                  max_iters=state.cg_max_iters)[0]
        for j in range(0, m, col_chunk)], dim=1)
    Kss = kernels.cross_covariance(Xs, Xs, params, config)
    cov = Kss - Ks.mT @ CiKs
    G = Hs.mT - state.CiH.mT @ Ks  # (p, m)
    W = torch.linalg.solve_triangular(state.LA, G, upper=False)
    cov = cov + W.mT @ W
    cov = 0.5 * (cov + cov.mT)
    if config.predict_variance_includes_nugget:
        cov = cov + torch.exp(params.log_nugget) * torch.eye(
            m, dtype=cov.dtype, device=cov.device)
    return mean, cov


def sample_multivariate_posterior_iterative(
    emu, states, Xs_raw, generator: torch.Generator, num_samples: int,
    col_chunk: int = 128, row_chunk: int = 2048,
) -> torch.Tensor:
    """Matrix-free joint observable-space posterior draws: (S, m, t). Each
    component's covariance comes from `posterior_covariance_iterative` on
    its cached serving state (`states`, from
    `multivariate.precompute_iterative_multivariate`), then the shared eigh
    draws (one batch over the components) and the PCA rotation. Keep m to a few thousand (the draw is O(m^3)); N is not held
    to dense memory."""
    Xs = _scaled_queries(emu, Xs_raw)
    covs = [posterior_covariance_iterative(
        states[i], emu.component_data(i), Xs, col_chunk=col_chunk,
        row_chunk=row_chunk) for i in range(emu.n_components)]
    mean = torch.stack([c[0] for c in covs])
    cov = torch.stack([c[1] for c in covs])
    return _rotate_pc_draws(_eigh_draws(mean, cov, generator, num_samples),
                            emu.pca)


def sample_multivariate_posterior(
    emu, Xs_raw, generator: torch.Generator, num_samples: int
) -> torch.Tensor:
    """Joint observable-space posterior draws: (S, m, t). Each retained PC
    is sampled from its full GP posterior over the query block (the
    components independent, as the emulator models them; one batch over
    them), then rotated: y[s, q, j] = ybar_j + s_j sum_i sqrt(lam_i) U_ji
    z_i[s, q]. The draws carry the cross-observable correlation of the
    shared PCs and the cross-point correlation of the GP covariance, which
    the marginal predict_multivariate variances cannot express."""
    Xs = _scaled_queries(emu, Xs_raw)
    Zs = sample_posterior(emu.states, emu.params, GPData(X=emu.X, y=emu.Z.mT),
                          Xs, emu.config, generator, num_samples)  # (r, S, m)
    return _rotate_pc_draws(Zs, emu.pca)
