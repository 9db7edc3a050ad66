"""Covariance kernels and Gram / cross-matrix builders (port of
madaiemulator_tpu/ops/kernels.py, dense forward part).

Batching: JAX vmaps these functions over PCA components and ensemble
members; here that axis is a leading batch dimension written out. Every
function takes the design X as (N, d) (shared by all components) or
(*B, N, d) (one per member: K1 is then handed one contiguous (B, N, d)
block of scaled points), and GPParams whose leaves carry the same leading
batch shape (*B,) — or none, for one GP. Outputs carry the batch shape in
front.

Routing follows the JAX package: with `gram_method="pallas"` (the port's
default) a float32 operand of an alpha = 2 power-exponential or Matérn
kernel goes through kernel K1 (`ops/hopper/pairwise.py`); float64 and
alpha != 2 take the library math. On the K1 path the forward is the kernel
and the backward is the autograd VJP of the identical library math
(`_K1Cross`, `_K1Gram`; kernels.py:165-239 of the JAX package), so the
likelihood gradient is exact on both paths. When no input needs a gradient
the kernel is called directly, without the autograd.Function (the same
result, less host time per call on the serve path).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from madaiemulator_tpu_torch.ops.hopper import pairwise
from madaiemulator_tpu_torch.utils.config import CovarianceFamily, GPConfig


class GPParams(NamedTuple):
    """Kernel hyperparameters in log space; log_ls is (..., d) for ARD
    families and (..., 1) for isotropic Matérn."""

    log_amp: torch.Tensor  # (*B,)
    log_nugget: torch.Tensor  # (*B,)
    log_ls: torch.Tensor  # (*B, num_length_scales)


def params_to_thetas(params: GPParams) -> torch.Tensor:
    """Natural-space thetas [amp, nugget, ell_1..ell_k] (reference layout)."""
    return torch.cat(
        [
            torch.exp(params.log_amp)[..., None],
            torch.exp(params.log_nugget)[..., None],
            torch.exp(params.log_ls),
        ],
        dim=-1,
    )


def thetas_to_params(thetas: torch.Tensor) -> GPParams:
    log_t = torch.log(thetas)
    return GPParams(
        log_amp=log_t[..., 0], log_nugget=log_t[..., 1], log_ls=log_t[..., 2:]
    )


def _scaled(X: torch.Tensor, params: GPParams, config: GPConfig) -> torch.Tensor:
    """Divide each input dimension by its length scale: (*B, N, d). An
    isotropic length scale (log_ls of width 1, config.num_length_scales
    == 1) broadcasts over every dimension."""
    return X / torch.exp(params.log_ls)[..., None, :]


def _sqdist(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances via one matmul, clipped at 0.

    Both point sets are centred by U's mean so the ||u||^2 terms stay small
    and the uu + vv - 2uv cancellation is mild; the cross term runs in full
    FP32 (TF32 is off package-wide).
    """
    c = U.mean(dim=-2, keepdim=True)
    U = U - c
    V = V - c
    uu = (U * U).sum(-1)
    vv = (V * V).sum(-1)
    uv = U @ V.mT
    return torch.clamp(uu[..., :, None] + vv[..., None, :] - 2.0 * uv, min=0.0)


# Cap on the (*B, chunk, n2, d) difference-tensor footprint of the
# alpha != 2 power distance: 2^25 elements. Above it the rows of U are
# processed in sequential chunks.
_POWER_DIST_MAX_ELEMS = 1 << 25


def _abs_power_dist(U: torch.Tensor, V: torch.Tensor, alpha: float) -> torch.Tensor:
    """sum_d |u_d - v_d|^alpha for alpha != 2 (no matmul form), bounded in
    memory by row chunks of U."""
    n1, d = U.shape[-2:]
    n2 = V.shape[-2]
    batch = max(1, U[..., 0, 0].numel(), V[..., 0, 0].numel())
    chunk = max(1, _POWER_DIST_MAX_ELEMS // (batch * n2 * d))
    parts = [
        (torch.abs(U[..., i:i + chunk, None, :] - V[..., None, :, :]) ** alpha)
        .sum(-1)
        for i in range(0, n1, chunk)
    ]
    return torch.cat(parts, dim=-2)


def _apply_family(
    dist2_or_power: torch.Tensor, amp: torch.Tensor, config: GPConfig
) -> torch.Tensor:
    fam = config.covariance
    a = amp[..., None, None]
    if fam is CovarianceFamily.POWER_EXPONENTIAL:
        # input is sum_d |dx/ell|^alpha (== scaled sqdist when alpha == 2)
        return a * torch.exp(-0.5 * dist2_or_power)
    # Matérn takes the scaled squared distance; the tiny floor keeps sqrt
    # differentiable at 0 and is exact at r = 0 in value
    r = torch.sqrt(dist2_or_power + 1e-36)
    if fam in (CovarianceFamily.MATERN32, CovarianceFamily.MATERN32_ARD):
        s = 3.0 ** 0.5 * r
        return a * (1.0 + s) * torch.exp(-s)
    if fam in (CovarianceFamily.MATERN52, CovarianceFamily.MATERN52_ARD):
        s = 5.0 ** 0.5 * r
        return a * (1.0 + s + s * s / 3.0) * torch.exp(-s)
    raise ValueError(f"unknown covariance family {fam}")


def _cross_xla(
    U: torch.Tensor, V: torch.Tensor, amp: torch.Tensor, config: GPConfig
) -> torch.Tensor:
    """Library-path cross covariance from pre-scaled points (no nugget)."""
    if (
        config.covariance is CovarianceFamily.POWER_EXPONENTIAL
        and config.power_exp_alpha != 2.0
    ):
        d = _abs_power_dist(U, V, config.power_exp_alpha)
    else:
        d = _sqdist(U, V)
    return _apply_family(d, amp, config)


def _pallas_family(config: GPConfig) -> str:
    """K1 epilogue name: ARD Matérn shares the isotropic epilogue (the
    per-dimension scaling happened on the inputs)."""
    return {
        CovarianceFamily.MATERN32_ARD: "matern32",
        CovarianceFamily.MATERN52_ARD: "matern52",
    }.get(config.covariance, config.covariance.value)


def _pallas_eligible(config: GPConfig, dtype: torch.dtype) -> bool:
    """K1 covers float32 alpha = 2 power-exponential and Matérn operands."""
    if config.gram_method != "pallas" or dtype == torch.float64:
        return False
    if (
        config.covariance is CovarianceFamily.POWER_EXPONENTIAL
        and config.power_exp_alpha != 2.0
    ):
        return False
    return True


def _flat(t: torch.Tensor, batch: tuple, tail: tuple) -> torch.Tensor:
    """t broadcast to (*batch, *tail) with one flat contiguous batch axis in
    front; t itself when it already is that."""
    shape = (math.prod(batch), *tail)
    if t.shape == shape and t.is_contiguous():
        return t
    return t.expand((*batch, *tail)).reshape(shape).contiguous()


def _k1(U, V, amp, diag_add, config: GPConfig, add_diag: bool):
    """Run K1 over the batch shape of (U, V, amp): the kernel takes one
    flat batch axis. V None is the Gram k(U, U): the kernel is handed one
    tensor as both operands and computes only its lower triangle. diag_add
    may be None when add_diag is False."""
    batch = tuple(U.shape[:-2])
    if amp.shape != batch or (V is not None and V.shape[:-2] != batch):
        # numpy's rule is torch's; torch.broadcast_shapes imports torch.fx
        # at its first call (about a second)
        batch = np.broadcast_shapes(
            batch, amp.shape, *(() if V is None else (V.shape[:-2],)))
    n1, d = U.shape[-2:]
    Uf = _flat(U, batch, (n1, d))
    Vf = Uf if V is None else _flat(V, batch, (V.shape[-2], d))
    out = pairwise.pairwise_covariance(
        Uf, Vf, _flat(amp, batch, ()),
        None if diag_add is None else _flat(diag_add, batch, ()),
        family=_pallas_family(config),
        add_diag=add_diag,
    )
    return out.reshape(*batch, n1, Vf.shape[1])


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _gram_xla(U, amp, diag_add, config: GPConfig):
    """Library-path Gram from pre-scaled points: symmetrized, plus diag_add
    on the diagonal."""
    K = _cross_xla(U, U, amp, config)
    K = 0.5 * (K + K.mT)  # kill matmul-order asymmetry before Cholesky
    eye = torch.eye(U.shape[-2], dtype=K.dtype, device=K.device)
    return K + diag_add[..., None, None] * eye


def _library_vjp(fn, inputs, needs, cotangent):
    """Gradients of fn(*inputs) against `cotangent` for the inputs flagged
    in `needs`, by autograd through the library math (the backward of both
    K1 Functions)."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(nd) for x, nd in zip(inputs, needs)]
        grads = iter(torch.autograd.grad(
            fn(*xs), [x for x in xs if x.requires_grad], cotangent))
    return tuple(next(grads) if nd else None for nd in needs)


class _K1Cross(torch.autograd.Function):
    """k(U, V) by K1, with the VJP of `_cross_xla` (JAX
    `_pallas_cross_vjp`)."""

    @staticmethod
    def forward(ctx, U, V, amp, config):
        ctx.config = config
        ctx.save_for_backward(U, V, amp)
        return _k1(U, V, amp, None, config, add_diag=False)

    @staticmethod
    def backward(ctx, Kbar):
        U, V, amp = ctx.saved_tensors
        grads = _library_vjp(
            lambda u, v, a: _cross_xla(u, v, a, ctx.config),
            [U, V, amp], ctx.needs_input_grad[:3], Kbar)
        return (*grads, None)


class _K1Gram(torch.autograd.Function):
    """k(U, U) + diag_add I by K1, with the VJP of the library Gram (JAX
    `_pallas_gram_vjp`)."""

    @staticmethod
    def forward(ctx, U, amp, diag_add, config):
        ctx.config = config
        ctx.save_for_backward(U, amp, diag_add)
        return _k1(U, None, amp, diag_add, config, add_diag=True)

    @staticmethod
    def backward(ctx, Kbar):
        U, amp, diag_add = ctx.saved_tensors
        grads = _library_vjp(
            lambda u, a, d: _gram_xla(u, a, d, ctx.config),
            [U, amp, diag_add], ctx.needs_input_grad[:3], Kbar)
        return (*grads, None)


def cross_covariance(
    X1: torch.Tensor, X2: torch.Tensor, params: GPParams, config: GPConfig
) -> torch.Tensor:
    """k(X1, X2): (*B, n1, n2) cross-covariance, NO nugget."""
    U = _scaled(X1, params, config)
    V = _scaled(X2, params, config)
    amp = torch.exp(params.log_amp)
    if _pallas_eligible(config, X1.dtype):
        if _needs_grad(U, V, amp):
            return _K1Cross.apply(U, V, amp, config)
        return _k1(U, V, amp, None, config, add_diag=False)
    return _cross_xla(U, V, amp, config)


def effective_jitter_frac(n: int, dtype: torch.dtype, config: GPConfig) -> float:
    """Stability-floor fraction added to the Gram diagonal (times amp).

    Auto policy (config.jitter is None): none at float64; at float32 the
    floor must beat the Gram build's own rounding noise, whose spectral
    norm grows like sqrt(N) * eps * amp.
    """
    if config.jitter is not None:
        return config.jitter
    if dtype == torch.float64:
        return 0.0
    eps = float(torch.finfo(torch.float32).eps)
    return max(1e-6, 12.0 * (n ** 0.5) * eps)


def gram_matrix(X: torch.Tensor, params: GPParams, config: GPConfig) -> torch.Tensor:
    """C(theta) = k(X, X) + (nugget + jitter) * I: (*B, N, N).

    On the K1 path the nugget lands on the diagonal inside the kernel and
    the Gram is bitwise symmetric by construction, so it is not
    re-symmetrized; the library path keeps its 0.5 * (K + K^T) guard.
    """
    n = X.shape[-2]
    jitter_frac = effective_jitter_frac(n, X.dtype, config)
    amp = torch.exp(params.log_amp)
    diag_add = torch.exp(params.log_nugget) + jitter_frac * amp
    U = _scaled(X, params, config)
    if _pallas_eligible(config, X.dtype):
        if _needs_grad(U, amp, diag_add):
            return _K1Gram.apply(U, amp, diag_add, config)
        return _k1(U, None, amp, diag_add, config, add_diag=True)
    return _gram_xla(U, amp, diag_add, config)


def kdiag(Xs: torch.Tensor, params: GPParams, config: GPConfig) -> torch.Tensor:
    """k(x*, x*) per query point: amplitude (+ nugget if configured),
    shape (*B, m)."""
    val = torch.exp(params.log_amp)
    if config.predict_variance_includes_nugget:
        val = val + torch.exp(params.log_nugget)
    ones = torch.ones(Xs.shape[-2], dtype=Xs.dtype, device=Xs.device)
    return val[..., None] * ones


# --- gradient observations: the joint (value, gradient) covariance ---------
# Library tensor math, as in the JAX package (kernels.py:360-543): one
# scaled squared distance S, the radial profile g and its derivatives
# g'(S), g''(S), and (*B, n1, n2, d[, d]) difference slabs. Autograd
# differentiates it exactly, so the closed-form LML backward (one VJP of
# `gram_joint`) needs nothing more.

_GRAD_OK_FAMILIES = (
    CovarianceFamily.POWER_EXPONENTIAL,
    CovarianceFamily.MATERN52,
    CovarianceFamily.MATERN52_ARD,
)


def _require_grad_family(config: GPConfig) -> None:
    fam = config.covariance
    if fam not in _GRAD_OK_FAMILIES or (
        fam is CovarianceFamily.POWER_EXPONENTIAL
        and config.power_exp_alpha != 2.0
    ):
        raise ValueError(
            "gradient observations need a radial profile twice "
            "differentiable at zero distance: power_exponential with "
            "alpha=2 or matern52/matern52_ard; got "
            f"{fam.value}"
            + (
                f" (alpha={config.power_exp_alpha})"
                if fam is CovarianceFamily.POWER_EXPONENTIAL
                else ""
            )
        )


def _g012(S: torch.Tensor, config: GPConfig):
    """(g, g', g'') of the radial profile at scaled squared distance S
    (amp excluded); only for the gradient-capable families."""
    fam = config.covariance
    if fam not in _GRAD_OK_FAMILIES:
        raise ValueError(
            f"_g012: family {fam.value} has no twice-differentiable radial "
            "profile (caller must run _require_grad_family first)"
        )
    if fam is CovarianceFamily.POWER_EXPONENTIAL:
        g = torch.exp(-0.5 * S)
        return g, -0.5 * g, 0.25 * g
    # Matern-5/2: g(s) = (1 + sqrt5 r + 5 s / 3) e^{-sqrt5 r}, r = sqrt(s);
    # g'(s) = -(5/6)(1 + sqrt5 r) e^{-sqrt5 r}; g''(s) = (25/12) e^{-sqrt5 r}
    r = torch.sqrt(S + 1e-36)
    sq5 = 5.0 ** 0.5
    e = torch.exp(-sq5 * r)
    g = (1.0 + sq5 * r + (5.0 / 3.0) * S) * e
    return g, -(5.0 / 6.0) * (1.0 + sq5 * r) * e, (25.0 / 12.0) * e


def grad_prior_scale(config: GPConfig) -> float:
    """c_g = -2 g'(0): prior Var(df/dx_a) = amp c_g / ell_a^2."""
    _require_grad_family(config)
    if config.covariance is CovarianceFamily.POWER_EXPONENTIAL:
        return 1.0
    return 5.0 / 3.0  # Matern-5/2


def _ell_vec(params: GPParams, config: GPConfig, d: int) -> torch.Tensor:
    """Length scale per input dimension: (*B, d)."""
    ls = torch.exp(params.log_ls)
    if config.num_length_scales == 1:
        return ls[..., :1].expand(ls.shape[:-1] + (d,))
    return ls


def joint_cross(
    X1: torch.Tensor,
    X2: torch.Tensor,
    params: GPParams,
    config: GPConfig,
    *,
    grad_rows: bool = False,
    grad_cols: bool = False,
    value_cols: bool = True,
) -> torch.Tensor:
    """Cross covariance between (value | gradient) observation sets:
    (*B, rows, cols). Rows index X1 (n1 values, then n1*d gradients in
    (point, dim) row-major order when grad_rows); columns index X2 likewise
    (n2 values when value_cols, then n2*d gradients when grad_cols). No
    nugget; `gram_joint` adds the diagonal. A value-only request is
    `cross_covariance` (K1 at float32), correct for every family."""
    if not (grad_rows or grad_cols):
        if not value_cols:
            raise ValueError("joint_cross: nothing requested")
        return cross_covariance(X1, X2, params, config)
    if not (value_cols or grad_cols):
        raise ValueError("joint_cross: no columns requested")
    _require_grad_family(config)
    n1, d = X1.shape[-2:]
    n2 = X2.shape[-2]
    a = torch.exp(params.log_amp)[..., None, None]  # (*B, 1, 1)
    S = _sqdist(_scaled(X1, params, config), _scaled(X2, params, config))
    g, g1, g2 = _g012(S, config)  # (*B, n1, n2)
    inv2 = 1.0 / _ell_vec(params, config, d) ** 2  # (*B, d)
    # Dw[..., i, j, a] = (x1_i - x2_j)_a / ell_a^2
    Dw = (X1[..., :, None, :] - X2[..., None, :, :]) * inv2[..., None, None, :]
    batch = Dw.shape[:-3]
    top = [a * g] if value_cols else []
    if grad_cols:
        # Cov(f(x1_i), df/dx_b(x2_j)) = -2 amp g' Dw
        top.append(((-2.0 * a) * g1)[..., None] * Dw)
        top[-1] = top[-1].reshape(batch + (n1, n2 * d))
    top = torch.cat([t.expand(batch + t.shape[-2:]) for t in top], dim=-1)
    if not grad_rows:
        return top
    bottom = []
    if value_cols:
        # Cov(df/dx_a(x1_i), f(x2_j)) = +2 amp g' Dw
        gv = ((2.0 * a) * g1)[..., None] * Dw  # (*B, n1, n2, d)
        bottom.append(gv.transpose(-1, -2).reshape(batch + (n1 * d, n2)))
    if grad_cols:
        # Cov(df/dx_a(x1_i), df/dx_b(x2_j))
        gg = ((-4.0 * a) * g2)[..., None, None] * (
            Dw[..., :, None] * Dw[..., None, :]
        ) - ((2.0 * a) * g1)[..., None, None] * torch.diag_embed(
            inv2)[..., None, None, :, :]
        bottom.append(gg.transpose(-3, -2).reshape(batch + (n1 * d, n2 * d)))
    return torch.cat([top, torch.cat(bottom, dim=-1)], dim=-2)


def gram_joint(
    X: torch.Tensor,
    params: GPParams,
    config: GPConfig,
    noise: torch.Tensor | None = None,
    grad_noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Joint Gram of (f(X), grad f(X)): (*B, N(1+d), N(1+d)), diagonal
    included. Value rows get nugget + jitter (the `gram_matrix`
    convention), gradient rows the same relative regularization in
    gradient units, (nugget + jitter amp) c_g / ell_a^2; noise (*B, N) and
    grad_noise (*B, N, d) are known variances added to the respective
    diagonals."""
    n, d = X.shape[-2:]
    K = joint_cross(X, X, params, config, grad_rows=True, grad_cols=True)
    K = 0.5 * (K + K.mT)
    amp = torch.exp(params.log_amp)
    jitter_frac = effective_jitter_frac(n * (1 + d), X.dtype, config)
    base = (torch.exp(params.log_nugget) + jitter_frac * amp)[..., None]
    cg = grad_prior_scale(config)
    diag_v = base.expand(base.shape[:-1] + (n,))
    if noise is not None:
        diag_v = diag_v + noise.to(X.dtype)
    diag_g = base * cg / _ell_vec(params, config, d) ** 2  # (*B, d)
    diag_g = diag_g.repeat((1,) * (diag_g.ndim - 1) + (n,))  # (*B, n*d)
    if grad_noise is not None:
        gn = grad_noise.to(X.dtype)
        diag_g = diag_g + gn.reshape(gn.shape[:-2] + (n * d,))
    batch = tuple(np.broadcast_shapes(diag_v.shape[:-1], diag_g.shape[:-1]))
    diag = torch.cat([diag_v.expand(batch + (n,)),
                      diag_g.expand(batch + (n * d,))], dim=-1)
    return K + torch.diag_embed(diag)
