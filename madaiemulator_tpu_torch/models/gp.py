"""Scalar Gaussian-process core, serve part (port of
madaiemulator_tpu/models/gp.py).

Math (GP with a generalized-least-squares polynomial mean):
  C = K(X,X;theta) + nugget*I,  H = poly basis (N,p),  A = H^T C^-1 H
  beta = A^-1 H^T C^-1 y,   r = y - H beta
  mean(x*) = h(x*)^T beta + k*^T C^-1 r
  var(x*)  = k(x*,x*) - k*^T C^-1 k* + g^T A^-1 g,  g = h(x*) - H^T C^-1 k*

Batching: one GP, or a batch of GPs (the PCA components) that share the
design X (N, d): y is then (*B, N) and every GPParams leaf and every
GPPosteriorState field carries the batch shape (*B,) in front. All products
run in full FP32 at float32 (TF32 is off package-wide), the counterpart of
the JAX package's Precision.HIGHEST pins.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple, Optional, Tuple

import torch

from madaiemulator_tpu_torch.ops import kernels, linalg
from madaiemulator_tpu_torch.ops.kernels import GPParams
from madaiemulator_tpu_torch.utils.config import GPConfig

logger = logging.getLogger("madaiemulator_tpu_torch")


class GPData(NamedTuple):
    """Training data: X (N, d) scaled design, y (*B, N) targets, and optional
    per-point observation-noise variances noise (*B, N) added to the Gram
    diagonal. h_extra / dY / dY_noise keep the JAX field layout; they are
    not yet ported and are rejected."""

    X: torch.Tensor
    y: torch.Tensor
    noise: Optional[torch.Tensor] = None
    h_extra: Optional[torch.Tensor] = None
    dY: Optional[torch.Tensor] = None
    dY_noise: Optional[torch.Tensor] = None


class GPPosteriorState(NamedTuple):
    """Everything precomputable once per trained GP for serving."""

    L: torch.Tensor  # (*B, N, N) lower Cholesky of C
    alpha: torch.Tensor  # (*B, N) = C^-1 (y - H beta)
    beta: torch.Tensor  # (*B, p) GLS regression coefficients
    LA: torch.Tensor  # (*B, p, p) lower Cholesky of A = H^T C^-1 H
    Linv_H: torch.Tensor  # (*B, N, p) = L^-1 H
    ok: torch.Tensor  # (*B,) bool; factorization succeeded


def _reject_unported(data: GPData) -> None:
    if data.h_extra is not None:
        raise NotImplementedError("GPData.h_extra is not yet ported")
    if data.dY is not None or data.dY_noise is not None:
        raise NotImplementedError(
            "gradient observations (GPData.dY) are not yet ported"
        )


def regression_basis(X: torch.Tensor, order: int) -> torch.Tensor:
    """Polynomial basis H(X): [1, x_d, x_d^2, ...] per dimension, no cross
    terms; column 0 is the constant, then the d monomials of each power."""
    ones = torch.ones(X.shape[:-1] + (1,), dtype=X.dtype, device=X.device)
    return torch.cat([ones] + [X ** q for q in range(1, order + 1)], dim=-1)


def training_basis(data: GPData, config: GPConfig) -> torch.Tensor:
    _reject_unported(data)
    return regression_basis(data.X, config.regression_order)


def training_targets(data: GPData) -> torch.Tensor:
    _reject_unported(data)
    return data.y


def training_gram(data: GPData, params: GPParams, config: GPConfig) -> torch.Tensor:
    """C(theta) over the training rows; known noise variances land on the
    diagonal."""
    _reject_unported(data)
    C = kernels.gram_matrix(data.X, params, config)
    if data.noise is not None:
        C = C + torch.diag_embed(data.noise.to(C.dtype))
    return C


def query_basis(
    Xs: torch.Tensor, config: GPConfig, hs_extra: Optional[torch.Tensor] = None
) -> torch.Tensor:
    if hs_extra is not None:
        raise NotImplementedError("hs_extra is not yet ported")
    return regression_basis(Xs, config.regression_order)


def _factor(data: GPData, params: GPParams, config: GPConfig) -> GPPosteriorState:
    C = training_gram(data, params, config)
    n = C.shape[-1]
    method = config.cholesky_method
    upd = config.cholesky_update_precision
    if upd == "auto":
        upd = "highest"
    if method == "pallas" and n > config.pallas_cholesky_max_n:
        method = "left"  # as in the JAX package: large N takes the left path
    if method == "pallas" and C.dtype != torch.float64:
        L = linalg.pallas_cholesky(C)
    elif method == "left" and n > config.cholesky_block:
        Cp, n0 = linalg.pad_spd(C, config.cholesky_block)
        L = linalg.left_cholesky(
            Cp, block=config.cholesky_block, update_precision=upd
        )[..., :n0, :n0]
    else:
        L = linalg.xla_cholesky(C)
    ok = linalg.chol_ok(L)
    # a failed factor is replaced by I so the solves stay finite; ok gates
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    Lsafe = torch.where(ok[..., None, None], L, eye)
    H = training_basis(data, config)
    y = training_targets(data)
    H = H.expand(L.shape[:-2] + H.shape[-2:])
    Linv_H = linalg.solve_lower(Lsafe, H)  # (*B, N, p)
    Linv_y = linalg.solve_lower(Lsafe, y)  # (*B, N)
    A = Linv_H.mT @ Linv_H
    LA = linalg.xla_cholesky(A)
    ok = ok & linalg.chol_ok(LA)
    eyep = torch.eye(A.shape[-1], dtype=LA.dtype, device=LA.device)
    LAsafe = torch.where(ok[..., None, None], LA, eyep)
    beta = linalg.cho_solve(LAsafe, (Linv_H.mT @ Linv_y[..., None])[..., 0])
    resid = y - (H @ beta[..., None])[..., 0]
    alpha = linalg.cho_solve(Lsafe, resid)
    return GPPosteriorState(
        L=Lsafe, alpha=alpha, beta=beta, LA=LAsafe, Linv_H=Linv_H, ok=ok
    )


def _select(ok: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per batch member: a where ok, else b."""
    return torch.where(ok.reshape(ok.shape + (1,) * (a.ndim - ok.ndim)), a, b)


def precompute_predictor(
    params: GPParams, data: GPData, config: GPConfig
) -> GPPosteriorState:
    """Factor once for serving, with the jitter rescue ladder.

    Serving a trained snapshot must not fail: at float32, a batch member
    whose factorization is not SPD is refactored with the jitter raised to
    1e-4, then 1e-2, of its amplitude, and merged back per member. Members
    still failing serve the regression mean surface, with a warning. (The
    JAX package runs this ladder twice — in graph and on the host — with
    the same result; the port runs it once, on the host.)
    """
    st = _factor(data, params, config)
    if data.y.dtype == torch.float64 or bool(st.ok.all()):
        return st
    for frac in (1e-4, 1e-2):
        st2 = _factor(data, params, dataclasses.replace(config, jitter=frac))
        st = GPPosteriorState(*(_select(st.ok, a, b) for a, b in zip(st, st2)))
        if bool(st.ok.all()):
            return st
    bad = int((~st.ok).sum())
    logger.warning(
        "serving precompute: %d/%d components remain non-SPD after "
        "jitter rescue; their predictions fall back to the regression "
        "mean surface", bad, st.ok.numel(),
    )
    return st


def _auto_query_chunk(n: int, m: int, chunk):
    """Honor an explicit setting; otherwise chunk whenever the (N, m) solver
    temporaries would exceed ~256 MB f32 (results are identical)."""
    if chunk is not None:
        return chunk
    if n * m > (1 << 26):
        return 1024
    return None


def predict_from_precomputed(
    state: GPPosteriorState,
    params: GPParams,
    data: GPData,
    Xs: torch.Tensor,
    config: GPConfig,
    hs_extra: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and variance at Xs (m, d) -> ((*B, m), (*B, m)),
    in sequential query chunks when `config.predict_query_chunk` (or the
    auto policy) asks for them."""
    if hs_extra is not None:
        raise NotImplementedError("hs_extra is not yet ported")
    m = Xs.shape[-2]
    chunk = _auto_query_chunk(data.X.shape[-2], m, config.predict_query_chunk)
    if chunk is None or m <= chunk:
        return _predict_core(state, params, data, Xs, config)
    parts = [
        _predict_core(state, params, data, Xs[..., i:i + chunk, :], config)
        for i in range(0, m, chunk)
    ]
    return (torch.cat([p[0] for p in parts], dim=-1),
            torch.cat([p[1] for p in parts], dim=-1))


def _predict_core(
    state: GPPosteriorState,
    params: GPParams,
    data: GPData,
    Xs: torch.Tensor,
    config: GPConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    _reject_unported(data)
    Ks = kernels.cross_covariance(data.X, Xs, params, config)  # (*B, N, m)
    Hs = query_basis(Xs, config)  # (m, p)
    mean = (Hs @ state.beta[..., None])[..., 0] + (
        Ks.mT @ state.alpha[..., None]
    )[..., 0]
    V = linalg.solve_lower(state.L, Ks)  # (*B, N, m)
    var = kernels.kdiag(Xs, params, config) - (V * V).sum(-2)
    # GLS correction: g = h(x*) - H^T C^-1 k* = Hs^T - (L^-1 H)^T V
    G = Hs.mT - state.Linv_H.mT @ V  # (*B, p, m)
    W = linalg.solve_lower(state.LA, G)
    var = var + (W * W).sum(-2)
    return mean, torch.clamp(var, min=0.0)
