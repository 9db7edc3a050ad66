"""Dense SPD linear algebra for the GP core (port of
madaiemulator_tpu/ops/linalg.py).

Every function works on one matrix (n, n) or a batch (*B, n, n).

Failure semantics as in the JAX package: a failed (non-SPD) factorization
leaves NaN in its factor, `chol_ok` reports it, and callers gate the result.
`torch.linalg.cholesky_ex` leaves a partly finite factor when it fails, so
`xla_cholesky` fills the failed batch members with NaN.

Gradients: the kernel factorizations (`pallas_cholesky_diff`, K2),
`left_cholesky` and `blocked_cholesky_opt` are `torch.autograd.Function`s
whose backward is the Murray formula (`cholesky_backward`) in library math,
as in the JAX package, which has no backward kernel either; the library
factor differentiates natively.
"""

from __future__ import annotations

import contextlib
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


# Matmul precision tiers of `left_cholesky`'s updates and of the LML
# backward (the JAX package's `_PRECISIONS`, ops/linalg.py:60-64), as they
# run on an H100 for float32 operands on the card:
#   "highest"  full FP32 (TF32 off, the package-wide setting);
#   "high"     3xTF32: each operand split a = hi + lo, hi = a rounded to
#              the nearest TF32 value (10 mantissa bits), lo = a - hi
#              rounded likewise, and hi.hi + hi.lo + lo.hi as three
#              tensor-core GEMMs, the counterpart of the TPU's bf16x3;
#   "default"  one TF32 GEMM (JAX's DEFAULT on a GPU).
# Float64 operands, and every operand on the CPU, compute in full precision
# whatever the tier, as the JAX package's CPU backend does.
TIERS = ("default", "high", "highest")


@contextlib.contextmanager
def tf32_matmul():
    """TF32 on for float32 matmuls inside the block only; the process flag
    (off since the package import) is restored on exit, exception or not."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """a rounded to the nearest TF32 value (half away from zero): the low
    13 of float32's 23 mantissa bits cleared after adding half of their
    weight. The tensor cores truncate those bits, so an operand already in
    TF32 enters a TF32 GEMM exactly and the split stays unbiased."""
    return ((a.view(torch.int32) + 4096) & -8192).view(torch.float32)


def tf32_split(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a = hi + lo exactly, hi = `tf32_round(a)`, |lo| <= 2^-11 |a|."""
    hi = tf32_round(a)
    return hi, a - hi


def tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """hi.hi + (hi.lo + lo.hi) of the operands' TF32 splits, each remainder
    rounded to TF32 too: three TF32 GEMMs when TF32 is on. The split's own
    error (the dropped lo.lo term, the remainders' rounding) is ~2^-22 of
    the product; what is left on the H100 is the tensor cores' accumulation,
    which leans low as k grows whatever the operands (a k = 4,096 sum of
    squares 2.4e-5 low with one TF32 pass and with three alike, 4e-9 in
    FP32), so "high" sits between one TF32 pass and FP32 (PERF.md)."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    al, bl = tf32_round(al), tf32_round(bl)
    return ah @ bh + (ah @ bl + al @ bh)


def matmul_tier(a: torch.Tensor, b: torch.Tensor, tier: str) -> torch.Tensor:
    """a @ b at a precision tier (see TIERS)."""
    if tier not in TIERS:
        raise ValueError(f"unknown precision tier {tier!r}")
    if tier == "highest" or a.dtype != torch.float32 or not a.is_cuda:
        return a @ b
    with tf32_matmul():
        return a @ b if tier == "default" else tf32x3(a, b)


def left_cholesky(
    A: torch.Tensor,
    block: int = 1024,
    update_precision: str = "highest",
    trsm_precision: str | None = None,
    diag: str = "xla",
) -> torch.Tensor:
    """Left-looking blocked lower Cholesky: per panel, ONE history GEMM
    folding all earlier panels, then the diagonal block and the rows below.
    n must be a multiple of `block` (pad with `pad_spd`). Differentiable,
    with the Murray backward.

    diag="pallas" (float32): kernel K3 (`ops/hopper/panel.py`) returns the
    diagonal block's factor AND its inverse in one call, and the rows below
    are one GEMM, L21 = P21 invK^T, as in the JAX package. diag="xla": the
    library factor of the diagonal block and a triangular solve for the
    rows below (at a float32 trsm tier below "highest", the JAX route: a
    `tri_inv_block` inverse and the GEMM at that tier). Float64 operands
    take the library panels and full-precision GEMMs.

    update_precision is the history GEMM's tier (TIERS); trsm_precision,
    the rows-below GEMM's, defaults to it. At "highest" a float32 history
    product is formed in float64 and rounded once to float32: on the H100
    one float32 GEMM over k up to N leans low as k grows (config 4's LML
    9.9e-5 x |LML| from float64, 7.7e-6 in k-chunks of 2048), and the
    float64 product reaches the CPU's 5.7e-7 at the chunks' cost
    (`tools/f32_factor_error.py`; PERF.md).
    """
    if diag not in ("xla", "pallas"):
        raise ValueError(f"left_cholesky: unknown diag {diag!r}")
    tprec = trsm_precision or update_precision
    for t in (update_precision, tprec):
        if t not in TIERS:
            raise ValueError(f"left_cholesky: unknown precision tier {t!r}")
    n = A.shape[-1]
    if n % block:
        raise ValueError(f"left_cholesky: N={n} % {block} != 0 (pad_spd first)")
    return _MurrayCholesky.apply(A, _left_cholesky_impl, block,
                                 update_precision, tprec, diag)


def _history(A_panel, Lrows, Lpanel, tier: str) -> torch.Tensor:
    """A_panel - Lrows Lpanel^T over a flat batch: (B, m, b)."""
    if tier == "highest" and A_panel.dtype == torch.float32:
        return torch.baddbmm(A_panel.double(), Lrows.double(),
                             Lpanel.double().mT, alpha=-1.0).float()
    return A_panel - matmul_tier(Lrows, Lpanel.mT, tier)


def _left_cholesky_impl(A: torch.Tensor, block: int, upd: str, tprec: str,
                        diag: str) -> torch.Tensor:
    n = A.shape[-1]
    f32 = A.dtype == torch.float32
    use_k3 = diag == "pallas" and f32
    L = torch.zeros(A.shape, dtype=A.dtype, device=A.device)
    L3 = L.view(-1, n, n)
    for cj in range(0, n, block):
        Pa = A[..., cj:, cj:cj + block]  # (*B, n - cj, b)
        if cj:
            Pa = _history(Pa.reshape(-1, n - cj, block), L3[:, cj:, :cj],
                          L3[:, cj:cj + block, :cj], upd).view(Pa.shape)
        invK = None
        if use_k3:
            Lkk, invK = _panel_factor(Pa[..., :block, :])
        else:
            Lkk = xla_cholesky(Pa[..., :block, :])
        L[..., cj:cj + block, cj:cj + block] = Lkk
        if cj + block < n:
            P21 = Pa[..., block:, :]
            if invK is None and f32 and tprec != "highest":
                invK = tri_inv_block(Lkk, precision=tprec)
            if invK is not None:
                L21 = matmul_tier(P21, invK.mT, tprec)
            else:  # L21 Lkk^T = P21
                L21 = torch.linalg.solve_triangular(
                    Lkk.mT, P21, upper=True, left=False)
            L[..., cj + block:, cj:cj + block] = L21
    return L


def left_cholesky_sharded(
    A: torch.Tensor,
    mesh,
    axis: str = "rows",
    block: int = 1024,
    update_precision: str = "highest",
) -> torch.Tensor:
    """`left_cholesky` run row-sharded over the devices along `axis` of a
    `parallel.mesh.Mesh`: each device owns a contiguous row block of A and
    of L (ceil(n / devices) rows). For panel k, the owners of L's panel
    rows send that row block to every device, each device forms the
    history product of its own rows below the panel's top (the history
    GEMM split by output rows; float64 forming at "highest", as
    `_history`), the diagonal block is gathered on the owner of its first
    row, factored there and sent out, and each device forms its own rows
    below it. As in the JAX function (which calls `left_cholesky` with its
    default diag="xla"), the diagonal blocks are library factorizations:
    kernel K3 is not on this path. A single (n, n) matrix, n a multiple
    of `block`; the factor comes back gathered on the mesh's first device,
    differentiable with the Murray backward."""
    from madaiemulator_tpu_torch.parallel.mesh import check_mesh

    check_mesh(mesh, "left_cholesky_sharded")
    if mesh is None:
        raise TypeError("left_cholesky_sharded: a mesh is required")
    if update_precision not in TIERS:
        raise ValueError(f"left_cholesky_sharded: unknown precision tier "
                         f"{update_precision!r}")
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"left_cholesky_sharded: A must be (n, n), got "
                         f"{tuple(A.shape)}")
    if A.shape[0] % block:
        raise ValueError(f"left_cholesky_sharded: N={A.shape[0]} % {block} "
                         "!= 0 (pad_spd first)")
    return _MurrayCholesky.apply(A.to(mesh.first), _left_cholesky_gathered,
                                 mesh, axis, block, update_precision)


def _left_cholesky_gathered(A, mesh, axis, block, upd) -> torch.Tensor:
    owners, Ls = _left_cholesky_shards(A, mesh, axis, block, upd)
    return torch.cat([L.to(A.device) for L in Ls])


def _left_cholesky_shards(A: torch.Tensor, mesh, axis: str, block: int,
                          upd: str):
    """The sharded factor's row blocks: ([(device, first row, end row)],
    [L rows on that device]), one entry a device that owns rows."""
    from madaiemulator_tpu_torch.parallel.mesh import blocks

    n = A.shape[-1]
    devs = mesh.axis_devices(axis)
    owners = [(d, r0, r1) for d, (r0, r1) in zip(devs, blocks(n, len(devs)))
              if r1 > r0]
    As = [A[r0:r1].to(d) for d, r0, r1 in owners]
    Ls = [torch.zeros((r1 - r0, n), dtype=A.dtype, device=d)
          for d, r0, r1 in owners]
    f32 = A.dtype == torch.float32
    idx = list(range(len(owners)))
    for cj in range(0, n, block):
        ce = cj + block
        holders = [k for k in idx if owners[k][1] < ce and owners[k][2] > cj]
        Lp = None
        if cj:
            # the panel's rows of L, from their owners to every device
            Lp = torch.cat([Ls[k][max(cj, owners[k][1]) - owners[k][1]:
                                  min(ce, owners[k][2]) - owners[k][1], :cj]
                            .to(A.device) for k in holders])
            Lp = {d: Lp.to(d) for d in mesh.distinct}

        def history(k):
            d, r0, r1 = owners[k]
            if r1 <= cj:
                return None
            a = max(cj, r0) - r0
            Pa = As[k][a:, cj:ce]
            if cj:
                Pa = _history(Pa[None], Ls[k][a:, :cj][None], Lp[d][None],
                              upd)[0]
            return Pa

        Pas = mesh.map([o[0] for o in owners], history, idx)
        # the diagonal block, gathered on the owner of its first row,
        # factored there and sent out
        d0 = owners[holders[0]][0]
        D = torch.cat([Pas[k][:min(ce, owners[k][2]) - max(cj, owners[k][1])]
                       .to(d0) for k in holders])
        Lkk = xla_cholesky(D)
        invK = (tri_inv_block(Lkk, precision=upd)
                if f32 and upd != "highest" else None)
        Lkk = {d: Lkk.to(d) for d in mesh.distinct}
        invK = None if invK is None else {d: invK.to(d)
                                          for d in mesh.distinct}

        def below(k):
            d, r0, r1 = owners[k]
            if r1 <= cj:
                return None
            a = max(cj, r0)
            top = min(ce, r1)
            if top > a:  # this device's rows of the diagonal block
                Ls[k][a - r0:top - r0, cj:ce] = Lkk[d][a - cj:top - cj]
            if r1 > ce:
                P21 = Pas[k][max(ce, r0) - a:]
                if invK is not None:
                    L21 = matmul_tier(P21, invK[d].mT, upd)
                else:  # L21 Lkk^T = P21
                    L21 = torch.linalg.solve_triangular(
                        Lkk[d].mT, P21, upper=True, left=False)
                Ls[k][max(ce, r0) - r0:, cj:ce] = L21
            return None

        mesh.map([o[0] for o in owners], below, idx)
    return owners, Ls


def choose_update_precision(kappa_bound: float, tol: float = 1e-3) -> str:
    """The update tier from a condition-number bound (JAX
    ops/linalg.py:281-295): "high" (3xTF32 on the H100) up to
    HIGH_TIER_KAPPA_MAX x (tol / 1e-3), else "highest". Never "default"."""
    if kappa_bound <= HIGH_TIER_KAPPA_MAX * (tol / 1e-3):
        return "high"
    return "highest"


# The largest condition-number bound routed to "high". The JAX package's
# 2e4 was measured for the v5e's bf16x3; the H100's 3xTF32 factor is
# 5.6e-4 x max|L| from float64 at cond 2e4 (over the "highest" tier's 5e-4
# gate) and 1.2e-4 at cond 1e3 (N=4,096, `chip_smoke.py`'s tier table;
# PERF.md), so the port routes to "high" only up to 1e4.
HIGH_TIER_KAPPA_MAX = 1e4


def gp_kappa_bound(n: int, amp: float, nugget_eff: float) -> float:
    """Condition bound of C = amp R + nugget_eff I, R a correlation matrix
    (unit diagonal, entries in [-1, 1]): lambda_max <= amp n + g,
    lambda_min >= g."""
    g = max(float(nugget_eff), 1e-300)
    return 1.0 + n * float(amp) / g


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


def tri_inv_block(T: torch.Tensor, base: int = 64,
                  precision: str = "highest") -> torch.Tensor:
    """Lower-triangular inverse with log sequential depth, batched over
    (*B).

    Recursive 2x2 block inversion: inv([[A,0],[B,C]]) =
    [[invA, 0], [-invC B invA, invC]]; the two diagonal halves are
    independent, so each level stacks them into the batch and the only
    sequential loop is ONE base-size substitution over all leaves. The
    merge products run at `precision` (a tier of TIERS; the JAX package's
    argument), the base substitution in full FP32.
    """
    b = T.shape[-1]
    if b <= base or b % 2 != 0:
        return _tri_inv_lower(T)
    h = b // 2
    invs = tri_inv_block(torch.stack([T[..., :h, :h], T[..., h:, h:]]), base,
                         precision)
    invA, invC = invs[0], invs[1]
    out = torch.zeros_like(T)
    out[..., :h, :h] = invA
    out[..., h:, h:] = invC
    out[..., h:, :h] = -matmul_tier(
        invC, matmul_tier(T[..., h:, :h], invA, precision), precision)
    return out


def _unblocked_cholesky(A: torch.Tensor) -> torch.Tensor:
    """Unblocked lower Cholesky of a small (b, b) block (or batch): one
    column at a time, each a rank-1 update of the columns right of it (the
    JAX package's diagonal-block fallback). O(b^3), b steps."""
    b = A.shape[-1]
    idx = torch.arange(b, device=A.device)
    L = A.clone()
    for j in range(b):
        col = L[..., :, j]
        colj = torch.where(idx >= j, col / torch.sqrt(col[..., j:j + 1]),
                           0.0)
        L = L - torch.where(idx[None, :] > j,
                            colj[..., :, None] * colj[..., None, :], 0.0)
        L[..., :, j] = colj
    return torch.tril(L)


def blocked_cholesky_opt(
    A: torch.Tensor,
    block: int = 512,
    update_precision: str = "highest",
    diag: str = "xla",
) -> torch.Tensor:
    """Right-looking blocked lower Cholesky (`cholesky_method="blocked"`),
    differentiable with the Murray backward. n must be a multiple of
    `block` (pad with `pad_spd`).

    Per panel k: the diagonal block's factor (diag="xla": the library
    factor; else `_unblocked_cholesky`), the rows below it (float32:
    `tri_inv_block` and one GEMM at `update_precision`; float64: the library
    trsm), then the trailing update on the block-lower triangle only, one
    GEMM per trailing block column (rows at and below it), at
    `update_precision` (TIERS). All library math, as in the JAX package
    (ops/linalg.py:310-393): no kernel serves this route."""
    if update_precision not in TIERS:
        raise ValueError(
            f"blocked_cholesky_opt: unknown precision tier {update_precision!r}")
    n = A.shape[-1]
    if n % block:
        raise ValueError(f"blocked_cholesky_opt: N={n} % {block} != 0")
    return _MurrayCholesky.apply(A, _blocked_cholesky_impl, block,
                                 update_precision, diag)


def _blocked_cholesky_impl(A: torch.Tensor, block: int, upd: str,
                           diag: str) -> torch.Tensor:
    n = A.shape[-1]
    diag_chol = xla_cholesky if diag == "xla" else _unblocked_cholesky
    M = A.clone()
    L = torch.zeros_like(A)
    for kb in range(0, n, block):
        Lkk = diag_chol(M[..., kb:kb + block, kb:kb + block])
        L[..., kb:kb + block, kb:kb + block] = Lkk
        r0 = kb + block
        if r0 >= n:
            break
        A21 = M[..., r0:, kb:kb + block]
        if A.dtype == torch.float64:  # L21 Lkk^T = A21
            L21 = torch.linalg.solve_triangular(Lkk.mT, A21, upper=True,
                                                left=False)
        else:
            L21 = matmul_tier(A21, tri_inv_block(Lkk, precision=upd).mT, upd)
        L[..., r0:, kb:kb + block] = L21
        for cj in range(r0, n, block):
            lo = cj - r0
            M[..., cj:, cj:cj + block] -= matmul_tier(
                L21[..., lo:, :], L21[..., lo:lo + block, :].mT, upd)
    return L


def blocked_cholesky(A: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Right-looking blocked lower Cholesky, the simple form: per panel the
    unblocked diagonal factor, the library trsm of the rows below, one
    full-precision GEMM over the whole trailing matrix. n must be a multiple
    of `block`. Differentiates natively (through every step)."""
    n = A.shape[-1]
    if n % block:
        raise ValueError(f"blocked_cholesky: N={n} not a multiple of {block}")
    M = A  # the trailing matrix, rows and columns kb: on
    L = torch.zeros_like(A)
    for kb in range(0, n, block):
        Lkk = _unblocked_cholesky(M[..., :block, :block])
        L[..., kb:kb + block, kb:kb + block] = Lkk
        if kb + block < n:
            L21 = torch.linalg.solve_triangular(
                Lkk.mT, M[..., block:, :block], upper=True, left=False)
            L[..., kb + block:, kb:kb + block] = L21
            M = M[..., block:, block:] - L21 @ L21.mT
    return L


def _diag_block_invs(L: torch.Tensor, block: int, tier: str) -> torch.Tensor:
    """The inverses of L's diagonal (block, block) blocks: (*B, nb, b, b)."""
    n = L.shape[-1]
    diags = torch.stack([L[..., i:i + block, i:i + block]
                         for i in range(0, n, block)], dim=-3)
    return tri_inv_block(diags, precision=tier)


def _precise_solve(L, B, block, tier, upper_t: bool) -> torch.Tensor:
    vec = B.ndim == L.ndim - 1
    B2 = B[..., None] if vec else B
    # the identity tail of `pad_spd` (the JAX package's `_pad_tri`): the
    # solves are exact on the original rows
    Lp, n0 = pad_spd(L, block)
    n = Lp.shape[-1]
    if n0 < n:
        B2 = torch.nn.functional.pad(B2, (0, 0, 0, n - n0))
    nb = n // block
    invD = _diag_block_invs(Lp, block, tier)
    xs = [None] * nb
    order = range(nb - 1, -1, -1) if upper_t else range(nb)
    for i in order:
        r0 = i * block
        rhs = B2[..., r0:r0 + block, :]
        if upper_t and i < nb - 1:  # (L^T)[block i, below] = L[below, i]^T
            rhs = rhs - matmul_tier(Lp[..., r0 + block:, r0:r0 + block].mT,
                                    torch.cat(xs[i + 1:], dim=-2), tier)
        elif not upper_t and i > 0:
            rhs = rhs - matmul_tier(Lp[..., r0:r0 + block, :r0],
                                    torch.cat(xs[:i], dim=-2), tier)
        Di = invD[..., i, :, :]
        xs[i] = matmul_tier(Di.mT if upper_t else Di, rhs, tier)
    X = torch.cat(xs, dim=-2)[..., :n0, :]
    return X[..., 0] if vec else X


def solve_lower_precise(L: torch.Tensor, B: torch.Tensor, block: int = 512,
                        precision_name: str = "high") -> torch.Tensor:
    """Solve L x = B by block forward substitution with every product at
    one precision tier (TIERS): `tri_inv_block` inverses of the diagonal
    blocks, then a GEMM per block for the update and the apply (JAX
    ops/linalg.py:502). B is (*B, n) or (*B, n, m)."""
    return _precise_solve(L, B, block, precision_name, upper_t=False)


def solve_upper_t_precise(L: torch.Tensor, B: torch.Tensor, block: int = 512,
                          precision_name: str = "high") -> torch.Tensor:
    """Solve L^T x = B (the lower factor, transposed) by block back
    substitution at one precision tier (JAX ops/linalg.py:537)."""
    return _precise_solve(L, B, block, precision_name, upper_t=True)


def cholesky(A: torch.Tensor, method: str = "xla",
             block: int = 256) -> torch.Tensor:
    """The factorization by name: "xla" (the library), "blocked"
    (`blocked_cholesky`) or "left" (`left_cholesky`)."""
    if method == "xla":
        return xla_cholesky(A)
    if method == "blocked":
        return blocked_cholesky(A, block=block)
    if method == "left":
        return left_cholesky(A, block=block)
    raise ValueError(f"unknown cholesky method {method!r}")


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
