"""Sparse variational GP regression (SGPR; port of
madaiemulator_tpu/models/sparse.py): training past the exact-GP envelope.

SGPR (Titsias 2009, the collapsed variational bound) replaces the (N, N)
Gram with an m-point inducing summary. Every ELBO evaluation is one (m, N)
cross-covariance (kernel K1 at float32) and O(N m^2) triangular-solve and
GEMM work, plus factorizations of m x m and p x p matrices; at N = 1e6 and
m = 512 it trains on one card.

Model: the same universal-kriging GP the dense path serves (polynomial GLS
trend, stationary kernel, nugget + optional per-point noise), approximated
with inducing points Z (m, d):

    ELBO = log N(y | H beta, Q_nn + D) - 1/2 sum_i (k_ii - q_ii) / D_i
    Q_nn = K_nm K_mm^-1 K_mn ,   D = diag(nugget + noise_i)

beta is GLS-profiled under Q_nn + D as the dense path profiles it under
K_nn + D; config.reml adds the same -1/2 log|H^T Sigma^-1 H| term. Every
Sigma^-1 product uses the Woodbury identity through two small Choleskys (Lm
of K_mm, LB of I + A A^T with A = Lm^-1 K_mn D^-1/2): nothing (N, N) is
formed. The m x m and p x p Choleskys are library factorizations
(`linalg.xla_cholesky`, NaN on failure), as in the JAX package; kernels K2
and K3 are not on this path.

Serving keeps no training arrays: `SGPRServeState` is O(m^2 + m p). The
predictive variance carries the dense path's GLS trend-estimation
correction with the model cross-covariance Q_*n in place of K_*n.

Batching: params may carry a leading lane batch (*B,) (restarts of one fit,
or PCA components at serve time); Z is (m, d) or (*B, m, d). The ELBO is
differentiable by plain autograd in (params, Z); with row_chunk the N axis
is streamed in chunks, each under `torch.utils.checkpoint` so that the
backward pass rebuilds one chunk's cross-covariance at a time (live memory
O(m * row_chunk), flat in N).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from madaiemulator_tpu_torch.models import fit as _fit
from madaiemulator_tpu_torch.models.design import _greedy_maximin
from madaiemulator_tpu_torch.models.gp import (
    GPData,
    query_basis,
    regression_basis,
    regression_basis_grad,
)
from madaiemulator_tpu_torch.models.multivariate import (
    PCAState,
    pca_decompose,
    project_gradient_noise,
    project_gradients,
    project_noise,
    reconstruct_observables,
)
from madaiemulator_tpu_torch.ops import kernels, linalg
from madaiemulator_tpu_torch.ops.kernels import GPParams
from madaiemulator_tpu_torch.utils.config import GPConfig
from madaiemulator_tpu_torch.utils.designs import (
    DesignScaling,
    apply_scaling,
    fit_scaling,
)


class SGPRServeState(NamedTuple):
    """Serve-time distillate of an SGPR fit: O(m^2), no N-sized arrays.

    mean(x*) = h(x*) beta + v2^T c,  v1 = Lm^-1 k_m(x*), v2 = LB^-1 v1
    var(x*)  = k** - ||v1||^2 + ||v2||^2 + ||LA^-1 (h - E^T v1)||^2
    """

    Z: torch.Tensor  # (m, d) inducing points, scaled design space
    Lm: torch.Tensor  # (m, m) chol(K_mm + jitter I)
    LB: torch.Tensor  # (m, m) chol(I + A A^T)
    c: torch.Tensor  # (m,)  = LB^-1 A D^-1/2 (y - H beta)
    beta: torch.Tensor  # (p,)  GLS trend coefficients
    LA: torch.Tensor  # (p, p) chol(H^T Sigma^-1 H)
    E: torch.Tensor  # (m, p) = B^-1 G_AH  (GLS variance operator)
    ok: torch.Tensor  # bool: all three factorizations succeeded


class SGPRFitResult(NamedTuple):
    params: GPParams  # best-of-restarts hyperparameters (log space)
    Z: torch.Tensor  # (m, d) inducing points actually used
    elbo: torch.Tensor  # its ELBO value
    restart_elbos: torch.Tensor  # (R,)
    state: SGPRServeState  # ready-to-serve distillate
    # objective evaluations and wall time (models.fit.FitResult.stats)
    stats: Optional[dict] = None


def is_sparse(emu) -> bool:
    """True iff `emu` is a sparse (SGPR) container: the one isinstance
    helper every dispatch site shares."""
    return isinstance(emu, SparseMultivariateEmulator)


def _mm_jitter(dtype) -> float:
    # K_mm has no nugget; a small relative jitter keeps the m x m
    # factorization SPD at working precision (standard SGPR practice)
    return 1e-6 if dtype == torch.float64 else 1e-5


class _SGPRSystem(NamedTuple):
    """N-free distillate of the whole SGPR linear algebra.

    Every quantity the ELBO and the serve state need reduces to
    block-accumulable summaries of the whitened operands
    A = Lm^-1 K_mn D^-1/2, H_w = D^-1/2 H, y_w = D^-1/2 y:

        B    = I + A A^T                 (m, m)
        G_AH = A H_w                     (m, p)
        g_Ay = A y_w                     (m,)
        S_HH = H_w^T H_w,  S_Hy = H_w^T y_w,  S_yy = y_w^T y_w
        tr_AA = ||A||_F^2,  sum_logD,  sum_ampD = sum_i amp / D_i

    from which (Woodbury throughout, LB = chol(B)):
        H^T Sigma^-1 H = S_HH - G_AH^T B^-1 G_AH        -> LA, beta
        quad = r^T Sigma^-1 r  (expanded in beta)
        logdet Sigma = 2 sum log diag LB + sum_logD
        trace corr   = sum_ampD - tr_AA
        c = LB^-1 (g_Ay - G_AH beta),   E = B^-1 G_AH
    """

    Lm: torch.Tensor
    LB: torch.Tensor
    LA: torch.Tensor
    beta: torch.Tensor
    c: torch.Tensor
    E: torch.Tensor
    quad: torch.Tensor
    logdet: torch.Tensor
    trace: torch.Tensor
    ok: torch.Tensor


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _gate(ok: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """L where its batch member succeeded, else the identity (the solves
    stay finite; `ok` gates the results)."""
    return torch.where(ok[..., None, None], L, _eye(L.shape[-1], L))


def _row_summaries(params: GPParams, data: GPData, config: GPConfig,
                   Z: torch.Tensor, Lm: torch.Tensor,
                   row_chunk: Optional[int], amp: torch.Tensor,
                   nugget: torch.Tensor) -> tuple:
    """The nine sums over data's rows that the SGPR system needs: the seven
    block summaries (B - I, G_AH, g_Ay, S_HH, S_Hy, S_yy, tr_AA) and
    sum_i log D_i, sum_i amp / D_i (gradient rows included), streamed in
    row_chunk pieces, each checkpointed under autograd. amp and nugget are
    the caller's exp(log_amp), exp(log_nugget): one node each, so the
    gradient sums in the order it did before the row sums were split
    out."""
    X, y = data.X, data.y
    n, d = X.shape[-2:]
    dtype = y.dtype
    has_grad = data.dY is not None
    D = nugget[..., None] * torch.ones(n, dtype=dtype, device=X.device)
    if data.noise is not None:
        D = D + data.noise.to(dtype)
    rsD = torch.rsqrt(D)  # (*B, n)
    sum_logD = torch.log(D).sum(-1)
    sum_kD = (amp[..., None] / D).sum(-1)
    rsDg = dY = None
    if has_grad:
        # Gradient observations join the likelihood as extra rows whose
        # cross-covariance to the inducing VALUES is the derivative kernel
        # (kernels.joint_cross): the inducing set stays m value points, so
        # the serve state and the snapshot grammar are unchanged. Gradient
        # rows carry the dense joint Gram's relative noise floor, nugget
        # c_g / ell_a^2, plus any known per-partial noise; their prior
        # diagonal amp c_g / ell_a^2 feeds the Titsias trace term.
        grad_unit = kernels.grad_prior_scale(config) / kernels._ell_vec(
            params, config, d) ** 2  # (*B, d)
        Dg = nugget[..., None, None] * grad_unit[..., None, :]
        Dg = Dg.expand(Dg.shape[:-2] + (n, d))
        if data.dY_noise is not None:
            Dg = Dg + data.dY_noise.to(dtype)
        rsDg = torch.rsqrt(Dg)  # (*B, n, d)
        sum_logD = sum_logD + torch.log(Dg).sum((-2, -1))
        sum_kD = sum_kD + ((amp[..., None] * grad_unit)[..., None, :]
                           / Dg).sum((-2, -1))
        dY = data.dY.to(dtype)

    def block_summaries(Xb, yb, rsDb, hb=None, dYb=None, rsDgb=None):
        if dYb is None:
            Kb = kernels.cross_covariance(Z, Xb, params, config)  # (*B, m, cb)
            Hb = query_basis(Xb, config, hb)  # + the h_extra columns
            rsJ, yJ = rsDb, yb
        else:
            cb = Xb.shape[-2]
            # (*B, m, cb (1 + d)): value columns, then gradient columns in
            # the (point, dim) row-major order of dY.reshape(-1)
            Kb = kernels.joint_cross(Z, Xb, params, config, grad_cols=True)
            Hb = torch.cat([
                regression_basis(Xb, config.regression_order),
                regression_basis_grad(Xb, config.regression_order),
            ], dim=-2)
            rsJ = torch.cat([rsDb, rsDgb.reshape(rsDgb.shape[:-2]
                                                 + (cb * d,))], dim=-1)
            dYf = dYb.reshape(dYb.shape[:-2] + (cb * d,))
            batch = np.broadcast_shapes(yb.shape[:-1], dYf.shape[:-1])
            yJ = torch.cat([yb.expand(batch + yb.shape[-1:]),
                            dYf.expand(batch + dYf.shape[-1:])], dim=-1)
        Ab = linalg.solve_lower(Lm, Kb) * rsJ[..., None, :]
        Hw = rsJ[..., :, None] * Hb
        yw = rsJ * yJ
        return (
            Ab @ Ab.mT,  # -> B - I
            Ab @ Hw,  # -> G_AH
            (Ab @ yw[..., None])[..., 0],  # -> g_Ay
            Hw.mT @ Hw,  # -> S_HH
            (Hw.mT @ yw[..., None])[..., 0],  # -> S_Hy
            (yw * yw).sum(-1),  # -> S_yy
            (Ab * Ab).sum((-2, -1)),  # -> tr_AA
        )

    if row_chunk is None or n <= row_chunk:
        sums = block_summaries(X, y, rsD, data.h_extra, dY, rsDg)
    else:
        # pad with rsD = 0 rows: their whitened operands vanish, so every
        # summary is unchanged (the D-scalars above used the real D)
        pad = (-n) % row_chunk

        def padded(t, axis):
            if not pad:
                return t
            shape = list(t.shape)
            shape[axis] = pad
            return torch.cat([t, t.new_zeros(shape)], dim=axis)

        Xp, yp, rp = padded(X, -2), padded(y, -1), padded(rsD, -1)
        hp = None if data.h_extra is None else padded(data.h_extra, -2)
        dYp = None if dY is None else padded(dY, -2)
        rgp = None if rsDg is None else padded(rsDg, -2)
        # each chunk's summaries under torch.utils.checkpoint: the backward
        # pass recomputes the chunk (one more cross-covariance) instead of
        # holding every chunk's (m, row_chunk) intermediates
        remat = torch.is_grad_enabled()
        sums = None
        for s in range(0, n + pad, row_chunk):
            blk = [Xp[..., s:s + row_chunk, :], yp[..., s:s + row_chunk],
                   rp[..., s:s + row_chunk],
                   None if hp is None else hp[..., s:s + row_chunk, :]]
            if dYp is not None:
                blk += [dYp[..., s:s + row_chunk, :],
                        rgp[..., s:s + row_chunk, :]]
            parts = (torch.utils.checkpoint.checkpoint(
                block_summaries, *blk, use_reentrant=False)
                if remat else block_summaries(*blk))
            sums = parts if sums is None else tuple(
                a + b for a, b in zip(sums, parts))
    return sums + (sum_logD, sum_kD)


def _sgpr_system(
    params: GPParams,
    data: GPData,
    config: GPConfig,
    Z: torch.Tensor,
    row_chunk: Optional[int] = None,
    shards=None,
) -> _SGPRSystem:
    """The SGPR linear algebra of (params, data, Z). `shards`, when given,
    is (mesh, [GPData, one a row shard on its device]) from
    `parallel.sparse_sharded.shard_data_rows`: the row sums
    (`_row_summaries`) then run on each shard's device and are summed onto
    Z's device; everything else is O(m^2) and runs there once."""
    dtype = data.y.dtype
    amp = torch.exp(params.log_amp)  # (*B,)
    nugget = torch.exp(params.log_nugget)
    m = Z.shape[-2]
    if data.dY is not None and data.h_extra is not None:
        raise ValueError(
            "h_extra and dY cannot be combined (same rule as the dense "
            "path: the extra regression columns have no derivative rows)"
        )
    Kmm = kernels.cross_covariance(Z, Z, params, config)  # (*B, m, m)
    Kmm = 0.5 * (Kmm + Kmm.mT) + (
        _mm_jitter(dtype) * amp)[..., None, None] * _eye(m, Kmm)
    Lm = linalg.xla_cholesky(Kmm)
    ok = linalg.chol_ok(Lm)
    Lm = _gate(ok, Lm)
    if shards is None:
        sums = _row_summaries(params, data, config, Z, Lm, row_chunk, amp,
                              nugget)
    else:
        from madaiemulator_tpu_torch.parallel.mesh import sum_partials

        mesh, parts = shards

        def one(dev, part):
            return _row_summaries(GPParams(*(t.to(dev) for t in params)),
                                  part, config, Z.to(dev), Lm.to(dev),
                                  row_chunk, amp.to(dev), nugget.to(dev))

        devs = [part.X.device for part in parts]
        sums = sum_partials(mesh.map(devs, one, devs, parts), Z.device)
    AAT, G_AH, g_Ay, S_HH, S_Hy, S_yy, tr_AA, sum_logD, sum_kD = sums

    B = _eye(m, AAT) + 0.5 * (AAT + AAT.mT)
    LB = linalg.xla_cholesky(B)
    ok = ok & linalg.chol_ok(LB)
    LB = _gate(ok, LB)
    # H^T Sigma^-1 H and friends via Woodbury on the summaries
    T_H = linalg.cho_solve(LB, G_AH)  # B^-1 G_AH (m, p), also E
    t_y = linalg.cho_solve(LB, g_Ay)  # B^-1 g_Ay (m,)
    HSH = S_HH - G_AH.mT @ T_H
    HSy = S_Hy - (G_AH.mT @ t_y[..., None])[..., 0]
    ySy = S_yy - (g_Ay * t_y).sum(-1)
    HSH = 0.5 * (HSH + HSH.mT)
    LA = linalg.xla_cholesky(HSH)
    ok = ok & linalg.chol_ok(LA)
    LA = _gate(ok, LA)
    beta = linalg.cho_solve(LA, HSy)
    quad = (ySy - 2.0 * (beta * HSy).sum(-1)
            + (beta * (HSH @ beta[..., None])[..., 0]).sum(-1))
    logdet = 2.0 * torch.log(torch.diagonal(LB, dim1=-2, dim2=-1)).sum(-1) \
        + sum_logD
    trace = sum_kD - tr_AA
    c = linalg.solve_lower(LB, g_Ay - (G_AH @ beta[..., None])[..., 0])
    return _SGPRSystem(Lm=Lm, LB=LB, LA=LA, beta=beta, c=c, E=T_H,
                       quad=quad, logdet=logdet, trace=trace, ok=ok)


def elbo(
    params: GPParams,
    data: GPData,
    config: GPConfig,
    Z: torch.Tensor,
    row_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Collapsed SGPR evidence lower bound with GLS-profiled trend, (*B,).

    -inf where a factorization fails (the fit treats it as the dense path
    treats a non-SPD Gram). Autograd gives exact gradients in (params, Z):
    every Cholesky is m x m or p x p. row_chunk streams the N axis in
    fixed-size chunks (one checkpointed chunk at a time): live memory
    O(m * row_chunk), flat in N, the million-point path.
    """
    return _elbo_of(_sgpr_system(params, data, config, Z,
                                 row_chunk=row_chunk), data, config)


def _elbo_of(sys: _SGPRSystem, data: GPData, config: GPConfig
             ) -> torch.Tensor:
    """The ELBO from the system of (params, data, Z); data gives the row
    count."""
    n, d = data.X.shape[-2:]
    if data.dY is not None:
        n = n * (1 + d)  # joint value + gradient rows
    ll = (-0.5 * sys.quad - 0.5 * sys.logdet
          - 0.5 * n * math.log(2.0 * math.pi) - 0.5 * sys.trace)
    if config.reml:
        ll = ll - 0.5 * linalg.logdet_from_chol(sys.LA)
    neg_inf = torch.tensor(-math.inf, dtype=ll.dtype, device=ll.device)
    ll = torch.where(torch.isfinite(ll), ll, neg_inf)
    return torch.where(sys.ok, ll, neg_inf)


def sgpr_precompute(
    params: GPParams,
    data: GPData,
    config: GPConfig,
    Z: torch.Tensor,
    row_chunk: Optional[int] = None,
) -> SGPRServeState:
    """Build the O(m^2) serve state (training arrays are NOT retained)."""
    with torch.no_grad():
        sys = _sgpr_system(params, data, config, Z, row_chunk=row_chunk)
    return SGPRServeState(Z=Z, Lm=sys.Lm, LB=sys.LB, c=sys.c, beta=sys.beta,
                          LA=sys.LA, E=sys.E, ok=sys.ok)


def predict_sgpr(
    state: SGPRServeState,
    params: GPParams,
    config: GPConfig,
    Xs: torch.Tensor,
    hs_extra: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and variance at SCALED queries Xs (s, d) -> ((*B, s),
    (*B, s)), batched over the state's and params' leading axes. O(s m)
    work per query batch: the training points are folded into the state.
    Variance = the Titsias posterior variance + the GLS trend-estimation
    correction (the dense `predict_from_precomputed`'s structure).
    hs_extra (*B, s, q): the query-side values of the training h_extra
    columns."""
    Hs = query_basis(Xs, config, hs_extra)  # (*B, s, p)
    Ksm = kernels.cross_covariance(state.Z, Xs, params, config)  # (*B, m, s)
    v1 = linalg.solve_lower(state.Lm, Ksm)
    v2 = linalg.solve_lower(state.LB, v1)
    mean = (Hs @ state.beta[..., None])[..., 0] + (
        v2.mT @ state.c[..., None])[..., 0]
    kss = kernels.kdiag(Xs, params, config)
    var = kss - (v1 * v1).sum(-2) + (v2 * v2).sum(-2)
    G = Hs.mT - state.E.mT @ v1  # (*B, p, s)
    W = linalg.solve_lower(state.LA, G)
    var = var + (W * W).sum(-2)
    return mean, torch.clamp(var, min=0.0)


def select_inducing(X: torch.Tensor, m: int) -> torch.Tensor:
    """Greedy-maximin inducing subset of the (scaled) design
    (`models.design._greedy_maximin` with uniform weights): deterministic,
    the same indices as the JAX package's selector."""
    if m >= X.shape[0]:
        return X
    idx, _ = _greedy_maximin(
        X, torch.ones((X.shape[0],), dtype=X.dtype, device=X.device), m)
    return X.index_select(0, idx)


def _inducing_points(X: torch.Tensor, inducing, dtype) -> torch.Tensor:
    if isinstance(inducing, int):
        return select_inducing(X, int(inducing))
    return torch.as_tensor(inducing).to(device=X.device, dtype=dtype)


def _adam_refine(objective, u: torch.Tensor, Z: torch.Tensor, steps: int,
                 lr: float):
    """Joint Adam refinement of (u, Z) on `objective`, with best-so-far
    tracking: optax.adam(lr) written out (b1 0.9, b2 0.999, eps 1e-8
    outside the square root, eps_root 0, bias corrections by the step
    count), in optax's order of operations. Each step evaluates the value
    and gradient at the current iterate, keeps it if it is the best finite
    value so far, then moves. Returns (best u, best Z, best value)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    mu = [torch.zeros_like(u), torch.zeros_like(Z)]
    nu = [torch.zeros_like(u), torch.zeros_like(Z)]
    best_u, best_Z = u, Z
    best_v = torch.tensor(math.inf, dtype=u.dtype, device=u.device)
    for k in range(1, steps + 1):
        leaves = [u.detach().requires_grad_(True),
                  Z.detach().requires_grad_(True)]
        v = objective(*leaves)
        grads = torch.autograd.grad(v, leaves)
        v = v.detach()
        better = torch.isfinite(v) & (v < best_v)
        best_u = torch.where(better, u, best_u)
        best_Z = torch.where(better, Z, best_Z)
        best_v = torch.where(better, v, best_v)
        moved = []
        for i, (p, g) in enumerate(zip((u, Z), grads)):
            mu[i] = (1 - b1) * g + b1 * mu[i]
            nu[i] = (1 - b2) * (g * g) + b2 * nu[i]
            mu_hat = mu[i] / (1 - b1 ** k)
            nu_hat = nu[i] / (1 - b2 ** k)
            moved.append(p + -lr * (mu_hat / (torch.sqrt(nu_hat) + eps)))
        u, Z = (t.detach() for t in moved)
    return best_u, best_Z, best_v


def fit_sgpr(
    generator: torch.Generator,
    data: GPData,
    config: GPConfig,
    inducing=512,
    n_restarts: Optional[int] = None,
    max_steps: Optional[int] = None,
    inducing_opt_steps: int = 0,
    inducing_lr: float = 1e-2,
    restart_chunk: Optional[int] = None,
    row_chunk: Optional[int] = None,
) -> SGPRFitResult:
    """Sparse fit: multi-restart L-BFGS on the ELBO, the restarts as lanes of
    one lock-step `models.fit.fit_one_start` batch (the JAX package vmaps
    them), drawn by `sample_restarts(generator, ...)`.

    inducing: m (the greedy-maximin subset of the design) or an explicit
    (m, d) scaled array. inducing_opt_steps > 0 appends a joint Adam
    refinement of (hyperparameters, Z) on the ELBO (`_adam_refine`).
    restart_chunk runs the restarts in sequential groups of that size (the
    same result, less memory: one restart's live set is dominated by the
    (m, N) whitened cross-covariance). row_chunk streams the N axis inside
    every ELBO evaluation. As in the JAX package there is no dead-start
    rescue (a start at -inf stays dead), and the argmax over restarts
    takes finite ELBOs only.
    """
    R = config.n_restarts if n_restarts is None else n_restarts
    steps = config.max_opt_steps if max_steps is None else max_steps
    dtype, dev = data.y.dtype, data.X.device
    Z = _inducing_points(data.X, inducing, dtype)
    lo, hi = _fit._bounds_arrays(config, dtype, dev)
    u0 = _fit._flatten_t(_fit.sample_restarts(generator, config, R,
                                              dtype=dtype)).to(dev)
    P = u0.shape[-1]
    stats = _fit._new_stats()

    def lml_fn(p, d, c):
        return elbo(p, d, c, Z, row_chunk=row_chunk)

    rc = R if restart_chunk is None or restart_chunk >= R else restart_chunk
    if R % rc:
        raise ValueError(
            f"n_restarts={R} not divisible by restart_chunk={restart_chunk}")
    best_u, best_neg = [], []
    for g in range(0, R, rc):
        bu, bv = _fit.fit_one_start(
            _fit._unflatten(u0[g:g + rc]), data.X, data.y, config, steps,
            noise=data.noise, stats=stats, dY=data.dY,
            dY_noise=data.dY_noise, lml_fn=lml_fn, h_extra=data.h_extra)
        best_u.append(_fit._flatten_t(bu))
        best_neg.append(bv)
    best_u = torch.cat(best_u)
    elbos = -torch.cat(best_neg)
    i = int(torch.argmax(torch.where(torch.isfinite(elbos), elbos,
                                     -torch.inf)))
    u_best = best_u[i]

    if inducing_opt_steps > 0:
        def joint_obj(u, Zc):
            p = _fit._u_to_params(_fit._unflatten(u[None]), lo, hi)
            return -elbo(GPParams(*(a[0] for a in p)), data, config, Zc,
                         row_chunk=row_chunk)

        u_best, Z, neg_best = _adam_refine(joint_obj, u_best, Z,
                                           inducing_opt_steps, inducing_lr)
        best_elbo = -neg_best
    else:
        best_elbo = elbos[i]
    params = GPParams(*(a[0] for a in _fit._u_to_params(
        _fit._unflatten(u_best[None]), lo, hi)))
    state = sgpr_precompute(params, data, config, Z, row_chunk=row_chunk)
    stats["n_steps"] = steps
    return SGPRFitResult(params=params, Z=Z, elbo=best_elbo,
                         restart_elbos=elbos, state=state, stats=stats)


def fit_sgpr_host(
    generator: torch.Generator,
    data: GPData,
    config: GPConfig,
    inducing=512,
    n_restarts: Optional[int] = None,
    max_steps: Optional[int] = None,
    row_chunk: Optional[int] = None,
    **host_kwargs,
) -> SGPRFitResult:
    """Host-loop sparse fit for the million-point scale: the L-BFGS
    recursion, backtracking, dead-start rescue, checkpoint / resume and
    vg_batch memory capping of `models.fit.fit_gp_host`, with the streamed
    ELBO as its objective (host_kwargs forward to it; vg_batch=1 is the
    setting at N ~ 1e6)."""
    Z = _inducing_points(data.X, inducing, data.y.dtype)

    def lml_fn(p, d, c):
        return elbo(p, d, c, Z, row_chunk=row_chunk)

    res = _fit.fit_gp_host(generator, data, config, n_restarts=n_restarts,
                      max_steps=max_steps, lml_fn=lml_fn, **host_kwargs)
    state = sgpr_precompute(res.params, data, config, Z, row_chunk=row_chunk)
    return SGPRFitResult(params=res.params, Z=Z, elbo=res.log_likelihood,
                         restart_elbos=res.restart_log_likelihoods,
                         state=state, stats=res.stats)


# --- multivariate (PCA) sparse emulator -------------------------------------


class SparseMultivariateEmulator(NamedTuple):
    """PCA multivariate emulator with per-component SGPR posteriors: the
    `MultivariateEmulator` container at the million-point scale, keeping NO
    training-set arrays (design, targets and noise are folded into the
    states at fit time). Z, the inducing set, is shared by the components;
    params and states carry the component axis (r, ...) in front."""

    scaling: DesignScaling
    pca: PCAState
    Z: torch.Tensor  # (m, d) shared inducing points
    params: GPParams  # batched over components (r, ...)
    states: SGPRServeState  # batched over components (r, ...)
    config: GPConfig

    @property
    def n_components(self) -> int:
        return self.pca.eigenvalues.shape[0]

    @property
    def n_outputs(self) -> int:
        return self.pca.ymean.shape[0]


def fit_multivariate_sparse(
    generator: torch.Generator,
    X_raw: torch.Tensor,
    Y: torch.Tensor,
    config: GPConfig,
    pca_variance: float = 0.95,
    standardize: bool = True,
    param_ranges=None,
    inducing=512,
    n_restarts: Optional[int] = None,
    max_steps: Optional[int] = None,
    inducing_opt_steps: int = 0,
    inducing_lr: float = 1e-2,
    restart_chunk: Optional[int] = None,
    row_chunk: Optional[int] = None,
    noise=None,
    gradients=None,
    gradient_noise=None,
) -> SparseMultivariateEmulator:
    """Sparse multivariate fit: PCA -> one SGPR per PC (`fit_sgpr`), on a
    shared inducing set. The components run one after another (their live
    set is O(N m) each), every one drawing its restarts from `generator` in
    component order. X_raw (N, d) and Y (N, t) are tensors on the device to
    train on, in the training dtype. noise: (N,) or (N, t) per-point
    observation variances, projected by `multivariate.project_noise`;
    gradients (N, d, t) w.r.t. the RAW inputs ((N, d) when t == 1) train
    every component on the joint (value, gradient) likelihood against the
    m inducing values (`project_gradients`); gradient_noise: their known
    variances, same shape."""
    if Y.ndim == 1:
        Y = Y[:, None]
    dtype, dev = Y.dtype, X_raw.device
    scaling = fit_scaling(X_raw, ranges=param_ranges)
    Xs = apply_scaling(X_raw.to(dtype), scaling)
    pca_np, Z_np = pca_decompose(Y.detach().cpu().numpy(), pca_variance,
                                 standardize=standardize)
    pca = PCAState(*(torch.as_tensor(a).to(device=dev) for a in pca_np))
    Zsc = torch.as_tensor(Z_np).to(device=dev, dtype=dtype)
    r = Zsc.shape[1]

    def on_device(a):
        return torch.as_tensor(a).to(device=dev, dtype=dtype)

    noise_pc = (None if noise is None
                else project_noise(on_device(noise), pca, dtype=dtype))
    dZ = (None if gradients is None
          else project_gradients(on_device(gradients), pca, scaling,
                                 dtype=dtype))  # (N, d, r), scaled coords
    dZ_noise = (None if gradient_noise is None
                else project_gradient_noise(on_device(gradient_noise), pca,
                                            scaling, dtype=dtype))
    if dZ_noise is not None and dZ is None:
        raise ValueError("gradient_noise given without gradients")
    Zi = _inducing_points(Xs, inducing, dtype)
    fits = []
    for c in range(r):
        data_c = GPData(
            X=Xs, y=Zsc[:, c],
            noise=None if noise_pc is None else noise_pc[:, c],
            dY=None if dZ is None else dZ[:, :, c],
            dY_noise=None if dZ_noise is None else dZ_noise[:, :, c])
        fits.append(fit_sgpr(
            generator, data_c, config, inducing=Zi, n_restarts=n_restarts,
            max_steps=max_steps, inducing_opt_steps=inducing_opt_steps,
            inducing_lr=inducing_lr, restart_chunk=restart_chunk,
            row_chunk=row_chunk))
    params = GPParams(*(torch.stack(a) for a in
                        zip(*(f.params for f in fits))))
    states = SGPRServeState(*(torch.stack(a) for a in
                              zip(*(f.state for f in fits))))
    return SparseMultivariateEmulator(scaling=scaling, pca=pca, Z=Zi,
                                      params=params, states=states,
                                      config=config)


def predict_multivariate_sparse(
    emu: SparseMultivariateEmulator, Xs_raw
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Observable-space posterior mean and variance, (s, t) each: one
    `predict_sgpr` batched over the component axis (one K1 call over every
    component at float32) and the shared PCA reconstruction, the output
    contract of `predict_multivariate`."""
    Xs = apply_scaling(torch.as_tensor(Xs_raw, dtype=emu.Z.dtype,
                                       device=emu.Z.device), emu.scaling)
    m_pc, v_pc = predict_sgpr(emu.states, emu.params, emu.config, Xs)
    return reconstruct_observables(m_pc, v_pc, emu.pca)
