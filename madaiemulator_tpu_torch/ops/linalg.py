"""Dense SPD linear algebra for the GP core (port of
madaiemulator_tpu/ops/linalg.py, serve part).

Every function works on one matrix (n, n) or a batch (*B, n, n).

Failure semantics as in the JAX package: a failed (non-SPD) factorization
leaves NaN in its factor, `chol_ok` reports it, and callers gate the result.
`torch.linalg.cholesky_ex` leaves a partly finite factor when it fails, so
`xla_cholesky` fills the failed batch members with NaN.
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


def left_cholesky(
    A: torch.Tensor,
    block: int = 1024,
    update_precision: str = "highest",
    diag: str = "xla",
) -> torch.Tensor:
    """Left-looking blocked lower Cholesky: per panel, ONE history GEMM
    folding all earlier panels, a library factor of the diagonal block and
    a triangular solve for the rows below. n must be a multiple of `block`
    (pad with `pad_spd`).

    Only diag="xla" and update_precision="highest" (full FP32) are ported:
    diag="pallas" needs the panel-factor kernel K3 and the TF32 tiers need
    their own H100 accuracy study; both come later.
    """
    if diag != "xla":
        raise NotImplementedError(
            f"left_cholesky(diag={diag!r}) is not yet ported: it needs the "
            "panel-factor kernel (K3)"
        )
    if update_precision != "highest":
        raise NotImplementedError(
            f"left_cholesky(update_precision={update_precision!r}) is not yet "
            "ported; only 'highest' (full FP32)"
        )
    n = A.shape[-1]
    if n % block:
        raise ValueError(f"left_cholesky: N={n} % {block} != 0 (pad_spd first)")
    L = torch.zeros_like(A)
    for cj in range(0, n, block):
        Pa = A[..., cj:, cj:cj + block]  # (*B, n - cj, b)
        if cj:
            Pa = Pa - L[..., cj:, :cj] @ L[..., cj:cj + block, :cj].mT
        Lkk = xla_cholesky(Pa[..., :block, :])
        L[..., cj:cj + block, cj:cj + block] = Lkk
        if cj + block < n:
            # L21 Lkk^T = P21
            L[..., cj + block:, cj:cj + block] = torch.linalg.solve_triangular(
                Lkk.mT, Pa[..., block:, :], upper=True, left=False
            )
    return L


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
