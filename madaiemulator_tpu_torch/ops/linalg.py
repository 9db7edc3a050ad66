"""Dense SPD linear algebra for the GP core (port of
madaiemulator_tpu/ops/linalg.py).

Every function works on one matrix (n, n) or a batch (*B, n, n).

Failure semantics as in the JAX package: a failed (non-SPD) factorization
leaves NaN in its factor, `chol_ok` reports it, and callers gate the result.
`torch.linalg.cholesky_ex` leaves a partly finite factor when it fails, so
`xla_cholesky` fills the failed batch members with NaN.

Gradients: the kernel factorizations (`pallas_cholesky_diff`, K2) and
`left_cholesky` are `torch.autograd.Function`s whose backward is the Murray
formula (`cholesky_backward`) in library math, as in the JAX package, which
has no backward kernel either; the library factor differentiates natively.
"""

from __future__ import annotations

from typing import Tuple

import torch


def xla_cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky by the library (cuSOLVER / LAPACK); the factor of a
    matrix that is not SPD is all NaN."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], float("nan"), L)


def pallas_cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky by kernel K2 (`ops/hopper/cholesky.py`), float32."""
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2

    n = A.shape[-1]
    L = k2.cholesky(A.reshape(-1, n, n).contiguous())
    return L.reshape(A.shape)


def cholesky_backward(L: torch.Tensor, Lbar: torch.Tensor) -> torch.Tensor:
    """O(n^2)-memory Cholesky backward (Murray 2016): with
    phi(X) = tril(X) with halved diagonal,
        Abar = 0.5 * L^-T (phi(L^T Lbar) + phi(L^T Lbar)^T) L^-1.
    Shared by every factorization that is not differentiated natively."""
    M = L.mT @ Lbar
    phi = torch.tril(M) - 0.5 * torch.diag_embed(
        torch.diagonal(M, dim1=-2, dim2=-1))
    S = 0.5 * (phi + phi.mT)
    X = torch.linalg.solve_triangular(L.mT, S, upper=True)  # L^T X = S
    # Abar L = X
    return torch.linalg.solve_triangular(L, X, upper=False, left=False)


class _MurrayCholesky(torch.autograd.Function):
    """A factorization `fn(A, *args) -> L` with the Murray backward."""

    @staticmethod
    def forward(ctx, A, fn, *args):
        L = fn(A, *args)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        (L,) = ctx.saved_tensors
        return (cholesky_backward(L, Lbar),) + (None,) * (
            len(ctx.needs_input_grad) - 1)


def pallas_cholesky_diff(A: torch.Tensor) -> torch.Tensor:
    """Differentiable K2 Cholesky (Murray backward), float32."""
    return _MurrayCholesky.apply(A, pallas_cholesky)


def _panel_factor(P: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3 (`ops/hopper/panel.py`) over the batch shape of P."""
    from madaiemulator_tpu_torch.ops.hopper import panel as k3

    b = P.shape[-1]
    L, Linv = k3.panel_factor(P.reshape(-1, b, b).contiguous())
    return L.reshape(P.shape), Linv.reshape(P.shape)


def left_cholesky(
    A: torch.Tensor,
    block: int = 1024,
    update_precision: str = "highest",
    diag: str = "xla",
) -> torch.Tensor:
    """Left-looking blocked lower Cholesky: per panel, ONE history GEMM
    folding all earlier panels, then the diagonal block and the rows below.
    n must be a multiple of `block` (pad with `pad_spd`). Differentiable,
    with the Murray backward.

    diag="pallas" (float32): kernel K3 (`ops/hopper/panel.py`) returns the
    diagonal block's factor AND its inverse in one call, and the rows below
    are one GEMM, L21 = P21 invK^T, as in the JAX package. diag="xla", and
    every float64 operand: the library factor of the diagonal block and a
    triangular solve for the rows below.

    Only update_precision="highest" (full FP32) is ported: the TF32 tiers
    need their own H100 accuracy study.
    """
    if diag not in ("xla", "pallas"):
        raise ValueError(f"left_cholesky: unknown diag {diag!r}")
    if update_precision != "highest":
        raise NotImplementedError(
            f"left_cholesky(update_precision={update_precision!r}) is not yet "
            "ported; only 'highest' (full FP32)"
        )
    n = A.shape[-1]
    if n % block:
        raise ValueError(f"left_cholesky: N={n} % {block} != 0 (pad_spd first)")
    return _MurrayCholesky.apply(A, _left_cholesky_impl, block, diag)


def _left_cholesky_impl(A: torch.Tensor, block: int, diag: str) -> torch.Tensor:
    n = A.shape[-1]
    use_k3 = diag == "pallas" and A.dtype == torch.float32
    L = torch.zeros_like(A)
    for cj in range(0, n, block):
        Pa = A[..., cj:, cj:cj + block]  # (*B, n - cj, b)
        if cj:
            Pa = Pa - L[..., cj:, :cj] @ L[..., cj:cj + block, :cj].mT
        if use_k3:
            Lkk, invK = _panel_factor(Pa[..., :block, :])
        else:
            Lkk = xla_cholesky(Pa[..., :block, :])
        L[..., cj:cj + block, cj:cj + block] = Lkk
        if cj + block < n:
            if use_k3:
                L21 = Pa[..., block:, :] @ invK.mT
            else:  # L21 Lkk^T = P21
                L21 = torch.linalg.solve_triangular(
                    Lkk.mT, Pa[..., block:, :], upper=True, left=False
                )
            L[..., cj + block:, cj:cj + block] = L21
    return L


def _tri_inv_lower(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a small lower-triangular block (or batch) by forward
    substitution: row i, X[i] = (e_i - T[i,:] @ X) / T[i,i]."""
    b = T.shape[-1]
    eye = torch.eye(b, dtype=T.dtype, device=T.device)
    X = torch.zeros_like(T)
    for i in range(b):
        ti = T[..., i:i + 1, :]  # (*B, 1, b)
        contrib = (ti @ X)[..., 0, :]
        X[..., i, :] = (eye[i] - contrib) / T[..., i, i:i + 1]
    return X


def tri_inv_block(T: torch.Tensor, base: int = 64) -> torch.Tensor:
    """Lower-triangular inverse with log sequential depth, batched over
    (*B).

    Recursive 2x2 block inversion: inv([[A,0],[B,C]]) =
    [[invA, 0], [-invC B invA, invC]]; the two diagonal halves are
    independent, so each level stacks them into the batch and the only
    sequential loop is ONE base-size substitution over all leaves. The
    products are full FP32 (TF32 is off package-wide).
    """
    b = T.shape[-1]
    if b <= base or b % 2 != 0:
        return _tri_inv_lower(T)
    h = b // 2
    invs = tri_inv_block(torch.stack([T[..., :h, :h], T[..., h:, h:]]), base)
    invA, invC = invs[0], invs[1]
    out = torch.zeros_like(T)
    out[..., :h, :h] = invA
    out[..., h:, h:] = invC
    out[..., h:, :h] = -(invC @ (T[..., h:, :h] @ invA))
    return out


def chol_ok(L: torch.Tensor) -> torch.Tensor:
    """Bool per matrix (*B,): the factor is finite (SPD input)."""
    return torch.isfinite(L).all(dim=-1).all(dim=-1)


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    """log|A| = 2 * sum(log diag L), per matrix."""
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L x = B. B is (*B, n) (a vector per matrix) or (*B, n, m)."""
    vec = B.ndim == L.ndim - 1
    b2 = B[..., None] if vec else B
    x = torch.linalg.solve_triangular(L, b2, upper=False)
    return x[..., 0] if vec else x


def solve_upper_t(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = B with the lower factor L."""
    vec = B.ndim == L.ndim - 1
    b2 = B[..., None] if vec else B
    x = torch.linalg.solve_triangular(L.mT, b2, upper=True)
    return x[..., 0] if vec else x


def cho_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A x = B given A = L L^T."""
    return solve_upper_t(L, solve_lower(L, B))


def pad_spd(A: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    """Pad an SPD matrix (or batch) to a multiple of `multiple` with an
    identity tail: [[A, 0], [0, I]] is SPD, its factor is [[L, 0], [0, I]],
    and solves restricted to the first n rows are unchanged."""
    n = A.shape[-1]
    pad = (-n) % multiple
    if pad == 0:
        return A, n
    Ap = torch.zeros(
        A.shape[:-2] + (n + pad, n + pad), dtype=A.dtype, device=A.device
    )
    Ap[..., :n, :n] = A
    idx = torch.arange(n, n + pad, device=A.device)
    Ap[..., idx, idx] = 1.0
    return Ap, n
