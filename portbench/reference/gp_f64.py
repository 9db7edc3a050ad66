"""The plain reference of both configurations: a Gaussian process with a
power-exponential (alpha = 2) covariance and a generalized-least-squares
polynomial mean, worked out from the inputs alone in float64.

    C = amp exp(-1/2 sum_k (dx_k / ell_k)^2) + (nugget + jitter amp) I
    H = [1, x_1 .. x_d] (regression order 1), A = H^T C^-1 H
    beta = A^-1 H^T C^-1 y, r = y - H beta, alpha = C^-1 r
    lml = -1/2 r^T alpha - 1/2 log|C| - n/2 log(2 pi)
    d lml / d theta = sum_ij Mbar_ij dC_ij / d theta,
        Mbar = 1/2 alpha alpha^T - 1/2 C^-1  (beta drops by the envelope)
    mean(x*) = h(x*)^T beta + k*^T alpha
    var(x*)  = amp + nugget - |L^-1 k*|^2 + |LA^-1 (h(x*) - (L^-1 H)^T L^-1 k*)|^2

`jitter` is the stability floor the configuration states for its float32
data: max(1e-6, 12 sqrt(n) eps_float32) of the amplitude.

`Arith` is the arithmetic of one evaluation: "float64", the reference, or
"tf32", the control: float32 with every product's operands rounded to
TF32's 10 mantissa bits (what the tensor cores take in), which is the step
below the port's full-FP32 products. Factors and solves are blocked so that
every O(n^3) piece of work is such a product; the diagonal blocks are
factored and inverted by the library at the arithmetic's own dtype.

Nothing here imports the program: the benchmark hands both sides the same
inputs, and this file works the Grams, the factors and the serve state out
again.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

F32_EPS = 2.0 ** -23


def jitter_frac(n: int) -> float:
    return max(1e-6, 12.0 * math.sqrt(n) * F32_EPS)


def kappa_bound(n: int, p: "Params") -> torch.Tensor:
    """The bound 1 + n amp / (nugget + jitter amp) on C's condition number
    (K is positive semi-definite with eigenvalues at most n amp)."""
    return 1.0 + n * p.amp / (p.nugget + jitter_frac(n) * p.amp)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class Arith:
    def __init__(self, mode: str = "float64", block: int = 512):
        if mode not in ("float64", "tf32"):
            raise ValueError(f"unknown arithmetic {mode!r}")
        self.mode = mode
        self.dtype = torch.float64 if mode == "float64" else torch.float32
        self.block = block

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.mode == "tf32":
            return _tf32(a) @ _tf32(b)
        return a @ b

    def blk(self, n: int) -> int:
        return max(1, min(self.block, n // 2 if n > 1 else 1))


class Params(NamedTuple):
    """Hyperparameters (*B,) / (*B, d) in the arithmetic's dtype."""
    amp: torch.Tensor
    nugget: torch.Tensor
    ls: torch.Tensor


def params_from_log(log_amp, log_nugget, log_ls, ar: Arith) -> Params:
    return Params(*(torch.exp(torch.as_tensor(t, dtype=torch.float64))
                    .to(ar.dtype) for t in (log_amp, log_nugget, log_ls)))


def _scaled(X, ls):
    return X / ls[..., None, :]


def cross(U: torch.Tensor, V: torch.Tensor, amp, ar: Arith) -> torch.Tensor:
    """amp exp(-1/2 |u - v|^2) of scaled points U (*B, n1, d), V (*B, n2,
    d), distances centred on U's mean."""
    c = U.mean(-2, keepdim=True)
    U, V = U - c, V - c
    d2 = ((U * U).sum(-1)[..., :, None] + (V * V).sum(-1)[..., None, :]
          - 2.0 * ar.mm(U, V.mT)).clamp_min(0.0)
    return amp[..., None, None] * torch.exp(-0.5 * d2)


def gram(X: torch.Tensor, p: Params, ar: Arith) -> torch.Tensor:
    """C (*B, n, n): K symmetrized, the nugget and the jitter on its
    diagonal."""
    U = _scaled(X.to(ar.dtype), p.ls)
    K = cross(U, U, p.amp, ar)
    K = 0.5 * (K + K.mT)
    n = X.shape[-2]
    diag = p.nugget + jitter_frac(n) * p.amp
    return K + diag[..., None, None] * torch.eye(n, dtype=ar.dtype,
                                                 device=K.device)


def _tri_inv(L: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def _chol_block(A: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
    """The library's factor of A (*B, k, k); members where it fails are
    marked in `bad` (in place) and get I, so the others go on."""
    L, info = torch.linalg.cholesky_ex(A)
    bad |= info != 0
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.where(bad[..., None, None], eye, L)


def cholesky(A: torch.Tensor, ar: Arith):
    """Right-looking blocked lower factor of A (*B, n, n), and the mask
    (*B,) of members where a diagonal block was not positive definite."""
    n = A.shape[-1]
    b = ar.blk(n)
    L = A.clone()
    bad = torch.zeros(A.shape[:-2], dtype=torch.bool, device=A.device)
    for j in range(0, n, b):
        e = min(j + b, n)
        Ljj = _chol_block(L[..., j:e, j:e], bad)
        L[..., j:e, j:e] = Ljj
        if e < n:
            L21 = ar.mm(L[..., e:, j:e], _tri_inv(Ljj).mT)
            L[..., e:, j:e] = L21
            L[..., e:, e:] -= ar.mm(L21, L21.mT)
    return torch.tril(L), bad


def solve_lower(L: torch.Tensor, B: torch.Tensor, ar: Arith) -> torch.Tensor:
    """L^-1 B for B (*B, n, m), by blocks of rows."""
    n = L.shape[-1]
    b = ar.blk(n)
    X = B.clone()
    for j in range(0, n, b):
        e = min(j + b, n)
        X[..., j:e, :] = ar.mm(_tri_inv(L[..., j:e, j:e]), X[..., j:e, :])
        if e < n:
            X[..., e:, :] -= ar.mm(L[..., e:, j:e], X[..., j:e, :])
    return X


def basis(X: torch.Tensor) -> torch.Tensor:
    """[1, x_1 .. x_d]: regression order 1."""
    return torch.cat([torch.ones_like(X[..., :1]), X], -1)


class State(NamedTuple):
    bad: torch.Tensor  # (*B,): C or A not positive definite here
    L: torch.Tensor
    LH: torch.Tensor  # L^-1 H
    LA: torch.Tensor  # factor of A = H^T C^-1 H
    beta: torch.Tensor
    Lr: torch.Tensor  # L^-1 r
    logdet: torch.Tensor


def factor(X: torch.Tensor, y: torch.Tensor, p: Params, ar: Arith):
    """The GLS state of C(p) on (X, y); `bad` marks the members where C or
    A is not positive definite in this arithmetic."""
    X = X.to(ar.dtype)
    y = y.to(ar.dtype)
    L, bad = cholesky(gram(X, p, ar), ar)
    H = basis(X).expand(L.shape[:-2] + X.shape[-2:-1] + (X.shape[-1] + 1,))
    y = y.expand(L.shape[:-1])
    sol = solve_lower(L, torch.cat([H, y[..., None]], -1), ar)
    LH, Ly = sol[..., :-1], sol[..., -1]
    LA = _chol_block(LH.mT @ LH, bad)
    beta = torch.cholesky_solve((LH.mT @ Ly[..., None]), LA)[..., 0]
    Lr = Ly - (LH @ beta[..., None])[..., 0]
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return State(bad, L, LH, LA, beta, Lr, logdet)


class Lml(NamedTuple):
    value: torch.Tensor  # (*B,)
    scale: torch.Tensor  # |1/2 quad| + |1/2 logdet| + n/2 log 2 pi
    grad: torch.Tensor = None  # (*B, 2 + d): log amp, log nugget, log ell
    grad_scale: torch.Tensor = None  # |data-fit part| + |trace part|


def lml(X, y, p: Params, ar: Arith, grad: bool = False):
    """The log-likelihood (and its gradient with respect to log amp, log
    nugget and log ell) of each member of the batch; NaN for the members
    where C is not positive definite in this arithmetic."""
    st = factor(X, y, p, ar)
    n = X.shape[-2]
    quad = (st.Lr * st.Lr).sum(-1)
    const = 0.5 * n * math.log(2.0 * math.pi)
    value = -0.5 * quad - 0.5 * st.logdet - const
    scale = 0.5 * quad.abs() + 0.5 * st.logdet.abs() + const
    value = torch.where(st.bad, torch.nan, value)
    if not grad:
        return Lml(value, scale)
    Linv = solve_lower(st.L, torch.eye(n, dtype=ar.dtype, device=X.device)
                       .expand_as(st.L).clone(), ar)
    alpha = (ar.mm(Linv.mT, st.Lr[..., None]))[..., 0]
    Cinv = ar.mm(Linv.mT, Linv)
    del Linv
    U = _scaled(X.to(ar.dtype), p.ls)
    K = cross(U, U, p.amp, ar)
    K = 0.5 * (K + K.mT)
    jit = jitter_frac(n) * p.amp
    parts = []
    for M in (0.5 * alpha[..., :, None] * alpha[..., None, :], -0.5 * Cinv):
        W = M * K
        w = W.sum(-1)
        g_amp = W.sum((-2, -1)) + jit * torch.diagonal(M, dim1=-2,
                                                      dim2=-1).sum(-1)
        g_nug = p.nugget * torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
        # sum_ij W_ij (u_ik - u_jk)^2 = 2 sum_i w_i u_ik^2 - 2 u_k^T W u_k
        g_ls = 2.0 * (w[..., :, None] * U * U).sum(-2) \
            - 2.0 * (U * ar.mm(W, U)).sum(-2)
        parts.append(torch.cat([g_amp[..., None], g_nug[..., None], g_ls],
                               -1))
        del W
    g = torch.where(st.bad[..., None], torch.nan, parts[0] + parts[1])
    return Lml(value, scale, g, parts[0].abs() + parts[1].abs())


def predict(st: State, X, Xs, p: Params, ar: Arith):
    """Posterior mean and variance (*B, m) at Xs (m, d)."""
    X = X.to(ar.dtype)
    Xs = Xs.to(ar.dtype)
    U = _scaled(X, p.ls)
    Us = _scaled(Xs, p.ls)
    Ks = cross(U, Us, p.amp, ar)  # (*B, n, m)
    V = solve_lower(st.L, Ks, ar)
    Hs = basis(Xs)
    mean = (Hs @ st.beta[..., None])[..., 0] + (V.mT @ st.Lr[..., None])[..., 0]
    var = (p.amp + p.nugget)[..., None] - (V * V).sum(-2)
    G = Hs.mT - st.LH.mT @ V
    Wg = torch.linalg.solve_triangular(st.LA, G, upper=False)
    var = var + (Wg * Wg).sum(-2)
    bad = st.bad[..., None]
    return (torch.where(bad, torch.nan, mean),
            torch.where(bad, torch.nan, var.clamp_min(0.0)))
