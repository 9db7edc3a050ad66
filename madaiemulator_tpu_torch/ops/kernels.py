"""Covariance kernels and Gram / cross-matrix builders (port of
madaiemulator_tpu/ops/kernels.py, dense forward part).

Batching: JAX vmaps these functions over PCA components; here the component
axis is a leading batch dimension written out. Every function takes the
design X as (N, d) (shared by all components) or (*B, N, d), and GPParams
whose leaves carry the same leading batch shape (*B,) — or none, for one
GP. Outputs carry the batch shape in front.

Routing follows the JAX package: with `gram_method="pallas"` (the port's
default) a float32 operand of an alpha = 2 power-exponential or Matérn
kernel goes through kernel K1 (`ops/hopper/pairwise.py`); float64 and
alpha != 2 take the library math. On the K1 path the forward is the kernel
and the backward is the autograd VJP of the identical library math
(`_K1Cross`, `_K1Gram`; kernels.py:165-239 of the JAX package), so the
likelihood gradient is exact on both paths.
"""

from __future__ import annotations

from typing import NamedTuple

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


def _k1(U, V, amp, diag_add, config: GPConfig, add_diag: bool):
    """Run K1 over the batch shape of (U, V, amp): the kernel takes one
    flat batch axis."""
    batch = torch.broadcast_shapes(U.shape[:-2], V.shape[:-2], amp.shape)
    n1, d = U.shape[-2:]
    n2 = V.shape[-2]
    flat = (-1,)
    out = pairwise.pairwise_covariance(
        U.expand(*batch, n1, d).reshape(flat + (n1, d)).contiguous(),
        V.expand(*batch, n2, d).reshape(flat + (n2, d)).contiguous(),
        amp.expand(batch).reshape(flat).contiguous(),
        diag_add.expand(batch).reshape(flat).contiguous(),
        family=_pallas_family(config),
        add_diag=add_diag,
    )
    return out.reshape(*batch, n1, n2)


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
        return _k1(U, V, amp, torch.zeros_like(amp), config, add_diag=False)

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
        return _k1(U, U, amp, diag_add, config, add_diag=True)

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
        return _K1Cross.apply(U, V, amp, config)
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
        return _K1Gram.apply(U, amp, diag_add, config)
    return _gram_xla(U, amp, diag_add, config)


def kdiag(Xs: torch.Tensor, params: GPParams, config: GPConfig) -> torch.Tensor:
    """k(x*, x*) per query point: amplitude (+ nugget if configured),
    shape (*B, m)."""
    val = torch.exp(params.log_amp)
    if config.predict_variance_includes_nugget:
        val = val + torch.exp(params.log_nugget)
    ones = torch.ones(Xs.shape[-2], dtype=Xs.dtype, device=Xs.device)
    return val[..., None] * ones
