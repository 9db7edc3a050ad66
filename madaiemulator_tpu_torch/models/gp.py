"""Scalar Gaussian-process core: likelihood, regression mean, posterior
(port of madaiemulator_tpu/models/gp.py).

Math (GP with a generalized-least-squares polynomial mean):
  C = K(X,X;theta) + nugget*I,  H = poly basis (N,p),  A = H^T C^-1 H
  beta = A^-1 H^T C^-1 y,   r = y - H beta
  logL = -1/2 r^T C^-1 r - 1/2 log|C| - N/2 log 2pi   (- 1/2 log|A| if REML)
  mean(x*) = h(x*)^T beta + k*^T C^-1 r
  var(x*)  = k(x*,x*) - k*^T C^-1 k* + g^T A^-1 g,  g = h(x*) - H^T C^-1 k*

Batching: one GP, or a batch of GPs (PCA components, or fit restarts) that
share the design X (N, d), or each on its own design X (*B, N, d) (the
members of an ensemble, `parallel.ensemble`; queries Xs (*B, m, d) then):
every GPParams leaf and every GPPosteriorState field carries the batch
shape (*B,) in front, and y is (*B, N) or one (N,) vector shared by the
batch. All products run in full FP32 at float32 (TF32
is off package-wide), the counterpart of the JAX package's
Precision.HIGHEST pins.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from madaiemulator_tpu_torch.ops import kernels, linalg
from madaiemulator_tpu_torch.ops.kernels import GPParams
from madaiemulator_tpu_torch.utils.config import GPConfig

logger = logging.getLogger("madaiemulator_tpu_torch")


class GPData(NamedTuple):
    """Training data: X (N, d) scaled design (or (*B, N, d), one per batch
    member), y (*B, N) targets, and optional per-point observation-noise
    variances noise (*B, N) added to the Gram diagonal.

    dY (*B, N, d), optional: observed gradients df/dx_a at X in the scaled
    design coordinates; the GP then trains on the joint (value, gradient)
    vector, rows in (point, dim) row-major order after the N values
    (`kernels.gram_joint`), and needs a twice-differentiable kernel
    (power_exponential alpha=2, matern52[_ard]). dY_noise (*B, N, d): known
    gradient-noise variances. h_extra (*B, N, q), optional: extra GLS basis
    columns appended after the polynomial basis (fixed data, not
    theta-dependent, so the closed-form LML backward's GLS envelope stays
    exact); their query-side values go to predict as hs_extra. The
    multi-fidelity levels carry the lower level's values there, so the last
    GLS coefficient is the AR(1) scale rho. h_extra and dY cannot be
    combined."""

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


def regression_basis(X: torch.Tensor, order: int) -> torch.Tensor:
    """Polynomial basis H(X): [1, x_d, x_d^2, ...] per dimension, no cross
    terms; column 0 is the constant, then the d monomials of each power."""
    ones = torch.ones(X.shape[:-1] + (1,), dtype=X.dtype, device=X.device)
    return torch.cat([ones] + [X ** q for q in range(1, order + 1)], dim=-1)


def regression_basis_grad(X: torch.Tensor, order: int) -> torch.Tensor:
    """dH/dx rows for gradient observations: (*B, N*d, p), row i*d + a the
    gradient of every basis column wrt x_a at X[i]. The basis has no cross
    terms, so each power-q block is a diagonal within its d columns:
    d/dx_a (x_b)^q = q x_a^(q-1) [a == b]."""
    n, d = X.shape[-2:]
    G = torch.zeros(X.shape[:-2] + (n, d, 1 + order * d), dtype=X.dtype,
                    device=X.device)
    dims = torch.arange(d, device=X.device)
    for q in range(1, order + 1):
        G[..., dims, 1 + (q - 1) * d + dims] = q * X ** (q - 1)
    return G.reshape(X.shape[:-2] + (n * d, 1 + order * d))


def _with_extra(H: torch.Tensor, extra: Optional[torch.Tensor]) -> torch.Tensor:
    """H with the extra columns appended last, over the batch of both."""
    if extra is None:
        return H
    batch = np.broadcast_shapes(H.shape[:-2], extra.shape[:-2])
    return torch.cat([H.expand(batch + H.shape[-2:]),
                      extra.to(H.dtype).expand(batch + extra.shape[-2:])],
                     dim=-1)


def training_basis(data: GPData, config: GPConfig) -> torch.Tensor:
    """H for training: the polynomial basis, then the h_extra columns; with
    gradient observations the derivative rows dh/dx follow the value rows,
    in the joint layout."""
    H = regression_basis(data.X, config.regression_order)
    if data.h_extra is not None:
        if data.dY is not None:
            raise ValueError(
                "h_extra and dY cannot be combined: the extra regression "
                "columns have no derivative counterpart"
            )
        H = _with_extra(H, data.h_extra)
    if data.dY is not None:
        H = torch.cat(
            [H, regression_basis_grad(data.X, config.regression_order)],
            dim=-2)
    return H


def training_targets(data: GPData) -> torch.Tensor:
    """y, extended by the row-major flattened gradients when dY is given."""
    if data.dY is None:
        return data.y
    dY = data.dY.reshape(data.dY.shape[:-2] + (-1,))
    batch = np.broadcast_shapes(data.y.shape[:-1], dY.shape[:-1])
    return torch.cat([data.y.expand(batch + data.y.shape[-1:]),
                      dY.expand(batch + dY.shape[-1:])], dim=-1)


def training_gram(data: GPData, params: GPParams, config: GPConfig) -> torch.Tensor:
    """C(theta) over the training rows: the Gram, or the joint value +
    gradient Gram when data carries dY; known noise variances land on the
    diagonal. The closed-form LML backward is the VJP of this function."""
    if data.dY is not None:
        return kernels.gram_joint(data.X, params, config, noise=data.noise,
                                  grad_noise=data.dY_noise)
    C = kernels.gram_matrix(data.X, params, config)
    if data.noise is not None:
        C = C + torch.diag_embed(data.noise.to(C.dtype))
    return C


def _train_rows(data: GPData) -> int:
    """Training rows: N, or N(1+d) with gradient observations."""
    n, d = data.X.shape[-2:]
    return n * (1 + d) if data.dY is not None else n


def query_basis(
    Xs: torch.Tensor, config: GPConfig, hs_extra: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """H(x*) for queries: the polynomial basis, then the caller's hs_extra
    columns (*B, m, q) (the training h_extra's width)."""
    return _with_extra(regression_basis(Xs, config.regression_order),
                       hs_extra)


def _cholesky(C: torch.Tensor, config: GPConfig) -> torch.Tensor:
    """Factor the Gram by `config.cholesky_method`, as the JAX package
    routes it (gp.py:195-235), with one deliberate difference: "pallas"
    above `pallas_cholesky_max_n` goes to the left-looking factorization
    with kernel K3 on every diagonal panel (diag="pallas") where the JAX
    package takes diag="xla". Both compute the same factor; the port's
    "pallas" spelling means "the Hopper kernels". "left" keeps the JAX
    route exactly (diag="xla"); float64 always takes the library panels.
    "blocked" above `cholesky_block` is the right-looking
    `linalg.blocked_cholesky_opt` (library math, as in JAX).
    "auto" is resolved from concrete hyperparameters only by
    `precompute_predictor_safe` (`resolve_update_precision`); here, as in
    the JAX package's traced `_factor`, it means "highest"."""
    n = C.shape[-1]
    method = config.cholesky_method
    upd = config.cholesky_update_precision
    if upd == "auto":
        upd = "highest"
    diag = "xla"
    if method == "pallas" and n > config.pallas_cholesky_max_n:
        method, diag = "left", "pallas"
    if method == "pallas" and C.dtype != torch.float64:
        return linalg.pallas_cholesky_diff(C)
    if method == "left" and n > config.cholesky_block:
        Cp, n0 = linalg.pad_spd(C, config.cholesky_block)
        return linalg.left_cholesky(
            Cp, block=config.cholesky_block, update_precision=upd, diag=diag
        )[..., :n0, :n0]
    if method == "blocked" and n > config.cholesky_block:
        Cp, n0 = linalg.pad_spd(C, config.cholesky_block)
        return linalg.blocked_cholesky_opt(
            Cp, block=config.cholesky_block, update_precision=upd
        )[..., :n0, :n0]
    return linalg.xla_cholesky(C)


def _factor(data: GPData, params: GPParams, config: GPConfig) -> GPPosteriorState:
    C = training_gram(data, params, config)
    n = C.shape[-1]
    L = _cholesky(C, config)
    ok = linalg.chol_ok(L)
    # a failed factor is replaced by I so the solves stay finite; ok gates
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    Lsafe = torch.where(ok[..., None, None], L, eye)
    H = training_basis(data, config)
    y = training_targets(data)
    batch = torch.broadcast_shapes(L.shape[:-2], y.shape[:-1])
    Lsafe = Lsafe.expand(batch + (n, n))
    ok = ok.expand(batch)
    H = H.expand(batch + H.shape[-2:])
    y = y.expand(batch + (n,))
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


def _lml_value(
    params: GPParams, data: GPData, config: GPConfig
) -> Tuple[torch.Tensor, GPPosteriorState]:
    """(log-marginal likelihood (*B,), factorization state). -inf where
    C(theta) is not SPD or the value is not finite."""
    st = _factor(data, params, config)
    y = training_targets(data)
    n = y.shape[-1]
    H = training_basis(data, config)
    r = y - (H @ st.beta[..., None])[..., 0]
    quad = (r * st.alpha).sum(-1)  # r^T C^-1 r = r . alpha
    logdet = linalg.logdet_from_chol(st.L)
    ll = -0.5 * quad - 0.5 * logdet - 0.5 * n * math.log(2.0 * math.pi)
    if config.reml:
        ll = ll - 0.5 * linalg.logdet_from_chol(st.LA)
    neg_inf = torch.tensor(-math.inf, dtype=ll.dtype, device=ll.device)
    ll = torch.where(torch.isfinite(ll), ll, neg_inf)
    return torch.where(st.ok, ll, neg_inf), st


def log_marginal_likelihood_ad(
    params: GPParams, data: GPData, config: GPConfig
) -> torch.Tensor:
    """Plain-autodiff LML: gradients flow through the Cholesky / solve
    graph. The reference for gradient tests; `log_marginal_likelihood`
    computes the same value with a closed-form backward."""
    return _lml_value(params, data, config)[0]


class _LML(torch.autograd.Function):
    """The GLS LML with the closed-form backward (JAX `_lml_dense_bwd`)."""

    @staticmethod
    def forward(ctx, log_amp, log_nugget, log_ls, data, config):
        params = GPParams(log_amp, log_nugget, log_ls)
        ll, st = _lml_value(params, data, config)
        ctx.save_for_backward(log_amp, log_nugget, log_ls)
        ctx.st, ctx.data, ctx.config = st, data, config
        return ll

    @staticmethod
    def backward(ctx, g):
        st, data, config = ctx.st, ctx.data, ctx.config
        L = st.L
        # the two O(N^3) terms (Linv, Cinv = Linv^T Linv) follow the
        # factorization's tier as in the JAX package (gp.py:345-356): 3xTF32
        # at "high", full FP32 at every other tier
        tier = ("high" if config.cholesky_update_precision == "high"
                else "highest")
        Linv = _tri_inverse(L, tier)
        Cinv = linalg.matmul_tier(Linv.mT, Linv, tier)
        Mbar = 0.5 * st.alpha[..., :, None] * st.alpha[..., None, :]
        Mbar = Mbar - 0.5 * Cinv
        del Linv, Cinv
        if config.reml:
            # +0.5 W A^-1 W^T,  W = C^-1 H = L^-T (L^-1 H)
            W = linalg.solve_upper_t(L, st.Linv_H)
            Z = linalg.cho_solve(st.LA, W.mT)  # (*B, p, N) = A^-1 W^T
            Mbar = Mbar + 0.5 * linalg.matmul_tier(W, Z, tier)
        Mbar = Mbar * g.to(L.dtype)[..., None, None]
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        # the VJP of the library Gram: K1's own backward is that VJP, so
        # rebuilding C by K1 here would only add a launch and an (N, N)
        lib = dataclasses.replace(config, gram_method="xla")
        with torch.enable_grad():
            p = GPParams(*(t.detach().requires_grad_(nd)
                           for t, nd in zip(saved, needs)))
            C = training_gram(data, p, lib)
            wrt = [t for t in p if t.requires_grad]
            grads = iter(torch.autograd.grad(
                C, wrt, Mbar.sum_to_size(C.shape), allow_unused=True))
        # a failed factorization poisons the gradient, as autodiff through
        # a NaN factor would; a leaf the whole batch shares (params without
        # the batch of y) is poisoned if any member failed
        ok = st.ok if saved[0].shape == st.ok.shape else st.ok.all()
        out = []
        for t, nd in zip(p, needs):
            gr = next(grads) if nd else None
            if nd and gr is None:
                gr = torch.zeros_like(t)
            if gr is not None:
                okb = ok.reshape(ok.shape + (1,) * (gr.ndim - ok.ndim))
                gr = torch.where(okb, gr, torch.nan)
            out.append(gr)
        return (*out, None, None)


def log_marginal_likelihood(
    params: GPParams, data: GPData, config: GPConfig
) -> torch.Tensor:
    """GLS log-marginal likelihood (*B,); -inf where C(theta) is not SPD.

    Differentiable with respect to params through a CLOSED-FORM backward
    (Rasmussen & Williams eq. 5.9 + the GLS envelope), never through the
    Cholesky / solve graph:

        d lml = 0.5 alpha^T dC alpha - 0.5 tr(C^-1 dC)
                [+ 0.5 tr(W A^-1 W^T dC) under REML, W = C^-1 H]

    beta's theta-dependence drops by the envelope theorem. The contraction
    against dC is ONE autograd VJP of the Gram build (`training_gram`)
    with cotangent Mbar = 0.5 alpha alpha^T - 0.5 C^-1 (+ the REML term),
    where C^-1 = Linv^T Linv with Linv from `tri_inv_block` at float32 and
    a triangular solve at float64. Members whose factorization failed get
    NaN gradients. Batched over (*B): restarts or components.
    """
    return _LML.apply(params.log_amp, params.log_nugget, params.log_ls,
                      data, config)


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


def resolve_update_precision(
    params: GPParams, n: int, config: GPConfig
) -> GPConfig:
    """Resolve cholesky_update_precision="auto" from concrete
    hyperparameters (host-level: reads the params). C = amp R +
    (nugget + jitter_frac amp) I has the condition bound
    kappa <= 1 + n amp / nugget_eff, and `linalg.choose_update_precision`
    maps it to a tier. Over a batch (components, restarts) the largest
    bound decides, since one factorization call runs one tier."""
    if config.cholesky_update_precision != "auto":
        return config
    amp = torch.exp(params.log_amp).detach().double().cpu()
    nugget = torch.exp(params.log_nugget).detach().double().cpu()
    jitter_frac = kernels.effective_jitter_frac(n, params.log_amp.dtype,
                                                config)
    kappa = max(linalg.gp_kappa_bound(n, a, g + jitter_frac * a)
                for a, g in zip(amp.reshape(-1).tolist(),
                                nugget.reshape(-1).tolist()))
    return dataclasses.replace(
        config,
        cholesky_update_precision=linalg.choose_update_precision(kappa),
    )


def precompute_predictor_safe(
    params: GPParams, data: GPData, config: GPConfig
) -> GPPosteriorState:
    """Host-level serving precompute with the escalating-jitter retry, the
    large-N serve entry point of the JAX package (gp.py:448-472), which
    resolves cholesky_update_precision="auto" from the concrete
    hyperparameters first (`resolve_update_precision`).

    The port's `precompute_predictor` already runs its ladder on the host,
    once, and merges the rungs per batch member, so the rest is that
    function under the JAX package's name.
    """
    config = resolve_update_precision(params, _train_rows(data), config)
    return precompute_predictor(params, data, config)


class FastPredictorState(NamedTuple):
    """Serve-time state with explicit triangular inverses: every per-query
    solve becomes a GEMM (JAX gp.py:475-491). Batched like the base state:
    Linv (*B, N, N), LAinv (*B, p, p)."""

    base: GPPosteriorState
    Linv: torch.Tensor  # (*B, N, N) lower-triangular L^-1
    LAinv: torch.Tensor  # (*B, p, p) lower-triangular LA^-1


def _tri_inverse(T: torch.Tensor, tier: str = "highest") -> torch.Tensor:
    """Explicit lower-triangular inverse: a triangular solve against the
    identity at float64, `linalg.tri_inv_block` at a tier at float32."""
    if T.dtype == torch.float64:
        eye = torch.eye(T.shape[-1], dtype=T.dtype, device=T.device)
        return torch.linalg.solve_triangular(T, eye.expand_as(T), upper=False)
    return linalg.tri_inv_block(T, precision=tier)


def fast_predictor_from_state(st: GPPosteriorState) -> FastPredictorState:
    """The explicit triangular inverses of an existing factorization (no
    refactorization), over its whole batch."""
    return FastPredictorState(base=st, Linv=_tri_inverse(st.L),
                              LAinv=_tri_inverse(st.LA))


def precompute_fast_predictor(
    params: GPParams, data: GPData, config: GPConfig
) -> FastPredictorState:
    """`precompute_predictor` plus the one-time N^3/3 inversion for
    GEMM-only serving by `predict_fast`."""
    return fast_predictor_from_state(
        precompute_predictor(params, data, config))


def _chunked(core, Xs: torch.Tensor, chunk, dim: int = -1, extra=None):
    """core(Xs) -> (mean, var) over sequential query chunks of Xs (and of
    the rows of `extra`, passed as core's second argument when given), the
    outputs joined on their query axis `dim`. The last chunk is short (the
    JAX package pads it with the first queries and drops their answers:
    the same values)."""
    m = Xs.shape[-2]

    def part(i, j):
        q = Xs[..., i:j, :]
        return core(q) if extra is None else core(q, extra[..., i:j, :])

    if chunk is None or m <= chunk:
        return part(0, m)
    parts = [part(i, i + chunk) for i in range(0, m, chunk)]
    return tuple(torch.cat([p[k] for p in parts], dim=dim) for k in (0, 1))


def predict_fast(
    fp: FastPredictorState,
    params: GPParams,
    data: GPData,
    Xs: torch.Tensor,
    config: GPConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GEMM-only posterior mean and variance (see FastPredictorState), in
    query chunks as `predict_from_precomputed` takes them."""
    if data.h_extra is not None:
        raise ValueError(
            "predict_fast does not support GPData.h_extra; use "
            "predict_from_precomputed(..., hs_extra=...) "
            "(models/multifidelity.py serves through it)"
        )
    if data.dY is not None:
        raise ValueError(
            "predict_fast does not support gradient-enhanced data; use "
            "predict_from_precomputed (the joint cross build is the cost, "
            "not the solves)"
        )
    chunk = _auto_query_chunk(_train_rows(data), Xs.shape[-2],
                              config.predict_query_chunk)
    return _chunked(
        lambda q: _predict_fast_core(fp, params, data, q, config), Xs, chunk)


def _predict_fast_core(
    fp: FastPredictorState,
    params: GPParams,
    data: GPData,
    Xs: torch.Tensor,
    config: GPConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    st = fp.base
    Ks = kernels.cross_covariance(data.X, Xs, params, config)  # (*B, N, m)
    Hs = regression_basis(Xs, config.regression_order)  # (m, p)
    mean = (Hs @ st.beta[..., None])[..., 0] + (
        Ks.mT @ st.alpha[..., None])[..., 0]
    V = fp.Linv @ Ks  # (*B, N, m)
    var = kernels.kdiag(Xs, params, config) - (V * V).sum(-2)
    G = Hs.mT - st.Linv_H.mT @ V  # (*B, p, m)
    W = fp.LAinv @ G
    var = var + (W * W).sum(-2)
    return mean, torch.clamp(var, min=0.0)


def gp_posterior(
    params: GPParams,
    data: GPData,
    Xs: torch.Tensor,
    config: GPConfig,
    hs_extra: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factor + predict in one call, with the single base factorization (no
    jitter ladder): params normally come from a successful fit. Serving a
    snapshot goes through `precompute_predictor_safe`."""
    st = _factor(data, params, config)
    return predict_from_precomputed(st, params, data, Xs, config,
                                    hs_extra=hs_extra)


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
    auto policy) asks for them. hs_extra (*B, m, q): the query-side values
    of the h_extra columns, given exactly when the data carries h_extra."""
    if (data.h_extra is None) != (hs_extra is None):
        raise ValueError(
            "predict: hs_extra must be given exactly when the training "
            "data carried h_extra columns"
        )
    chunk = _auto_query_chunk(_train_rows(data), Xs.shape[-2],
                              config.predict_query_chunk)
    return _chunked(
        lambda q, h=None: _predict_core(state, params, data, q, config,
                                        hs_extra=h),
        Xs, chunk, extra=hs_extra)


def _predict_core(
    state: GPPosteriorState,
    params: GPParams,
    data: GPData,
    Xs: torch.Tensor,
    config: GPConfig,
    hs_extra: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if data.dY is not None:
        # joint rows (values, then gradients) against the query values
        Ks = kernels.joint_cross(data.X, Xs, params, config, grad_rows=True)
    else:
        Ks = kernels.cross_covariance(data.X, Xs, params, config)  # (*B, N, m)
    Hs = query_basis(Xs, config, hs_extra)  # (*B, m, p)
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


def predict_gradient(
    state: GPPosteriorState,
    params: GPParams,
    data: GPData,
    Xs: torch.Tensor,
    config: GPConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and marginal variance of the partial derivatives
    df/dx_b at the queries Xs (m, d): ((*B, m, d), (*B, m, d)), for
    values-only and gradient-enhanced training data alike (JAX
    gp.py:707-755). Needs a twice-differentiable kernel. With
    config.predict_variance_includes_nugget the gradient-units nugget
    (nugget c_g / ell_b^2) is included. Queries run in chunks of the value
    path's size divided by d (each query is d solve columns) unless
    config.predict_query_chunk is set."""
    if data.h_extra is not None:
        raise ValueError(
            "predict_gradient does not support h_extra (the extra "
            "regression columns have no query-side derivative)"
        )
    d = Xs.shape[-1]
    chunk = _auto_query_chunk(_train_rows(data) * d, Xs.shape[-2],
                              config.predict_query_chunk)
    if config.predict_query_chunk is None and chunk is not None:
        chunk = max(1, chunk // d)
    return _chunked(
        lambda q: _predict_gradient_core(state, params, data, q, config),
        Xs, chunk, dim=-2)


def _predict_gradient_core(
    state: GPPosteriorState,
    params: GPParams,
    data: GPData,
    Xs: torch.Tensor,
    config: GPConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    m, d = Xs.shape[-2:]
    # training rows (values [+ gradients]) against query GRADIENT columns
    Ks = kernels.joint_cross(data.X, Xs, params, config,
                             grad_rows=data.dY is not None, grad_cols=True,
                             value_cols=False)  # (*B, rows, m*d)
    Hs = regression_basis_grad(Xs, config.regression_order)  # (m*d, p)
    mean = (Hs @ state.beta[..., None])[..., 0] + (
        Ks.mT @ state.alpha[..., None])[..., 0]
    V = linalg.solve_lower(state.L, Ks)  # (*B, rows, m*d)
    amp = torch.exp(params.log_amp)
    base = amp + (torch.exp(params.log_nugget)
                  if config.predict_variance_includes_nugget else 0.0)
    ell = kernels._ell_vec(params, config, d)  # (*B, d)
    cg = kernels.grad_prior_scale(config)
    kss = base[..., None] * cg / (ell * ell)  # (*B, d)
    kss = kss.repeat((1,) * (kss.ndim - 1) + (m,))  # (*B, m*d) prior vars
    var = kss - (V * V).sum(-2)
    G = Hs.mT - state.Linv_H.mT @ V  # (*B, p, m*d)
    W = linalg.solve_lower(state.LA, G)
    var = torch.clamp(var + (W * W).sum(-2), min=0.0)
    shape = var.shape[:-1] + (m, d)
    return mean.reshape(shape), var.reshape(shape)
