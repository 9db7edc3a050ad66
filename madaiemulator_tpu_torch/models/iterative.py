"""Matrix-free (iterative) GP inference for N past dense device memory (port
of madaiemulator_tpu/models/iterative.py).

The Gram matrix never exists. `gram_matvec` forms C @ V as a loop over row
chunks, each one (row_chunk, N) cross-covariance tile (kernel K1 at float32,
`ops.kernels.cross_covariance`) and one full-FP32 GEMM, so memory is
O(N (d + rank + probes)) plus one tile. On that matvec:

  * `pivoted_cholesky` + `make_preconditioner`: the rank-k Woodbury
    preconditioner P = L_k L_k^T + ridge, built from one K1 column a step;
  * `pcg_solve`: preconditioned CG over a block of right-hand sides. The
    JAX package runs one `lax.while_loop` on the device; here the loop runs
    on the host and reads its stop test back once an iteration;
  * `slq_logdet` / `mbcg_quadrature`: log|C| by stochastic Lanczos
    quadrature, or from the CG coefficients of probe columns riding in the
    solve (mBCG, Gardner et al. 2018);
  * `lml_iterative`: the GLS log-marginal likelihood, differentiable through
    `_LMLIterative`, whose backward is the Hutchinson / adjoint-solve
    estimate of JAX `_lml_iter_bwd`, evaluated one tile at a time
    (`_quad_form_grad`);
  * `precompute_iterative_predictor` / `predict_iterative_from_state`: the
    serving cache and chunked serving.

With a `mesh` (`parallel.iterative_sharded.make_rows_mesh`), every
training matvec of the likelihood, its backward and the serving
precompute runs row-sharded over the mesh's devices
(`parallel/iterative_sharded.py`), the multi-device large-N fit.

Probe vectors are drawn by `_draw_probes` from a `torch.Generator` seeded
from `seed` and the probe stream. The JAX package draws from jax.random, so
stochastic estimates differ between the packages by design; with
probes >= N both switch to exact canonical-basis probes and agree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from madaiemulator_tpu_torch.models.gp import GPData, regression_basis
from madaiemulator_tpu_torch.ops import kernels, linalg
from madaiemulator_tpu_torch.ops.kernels import GPParams
from madaiemulator_tpu_torch.parallel.mesh import check_mesh
from madaiemulator_tpu_torch.utils.config import GPConfig


def _diag_add(n: int, params: GPParams, config: GPConfig,
              dtype: torch.dtype) -> torch.Tensor:
    jf = kernels.effective_jitter_frac(n, dtype, config)
    return torch.exp(params.log_nugget) + jf * torch.exp(params.log_amp)


def _ridge(params: GPParams, data: GPData, config: GPConfig) -> torch.Tensor:
    """The diagonal of C on top of the kernel: nugget + jitter (a scalar),
    plus the per-point noise variances when data carries them ((n,))."""
    da = _diag_add(data.X.shape[0], params, config, data.X.dtype)
    if data.noise is not None:
        da = da + data.noise.to(data.X.dtype)
    return da


@torch.no_grad()
def gram_matvec(
    X: torch.Tensor,
    params: GPParams,
    config: GPConfig,
    V: torch.Tensor,
    row_chunk: int = 2048,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """C(theta) @ V without materializing C. V is (n, m), or (n,).

    Peak extra memory is one (row_chunk, n) kernel tile and the (n, m)
    output. `noise` is an optional (n,) per-point observation-noise
    variance vector (GPData.noise) added to the diagonal term. No autograd
    graph is recorded (it would hold every tile); gradients of quadratic
    forms in C go through `_quad_form_grad`, one tile at a time.
    """
    n = X.shape[0]
    vec = V.ndim == 1
    V2 = V[:, None] if vec else V
    da = _diag_add(n, params, config, X.dtype)
    if noise is not None:
        da = da + noise.to(X.dtype)
    chunk = min(row_chunk, n)
    out = torch.cat([
        kernels.cross_covariance(X[i:i + chunk], X, params, config) @ V2
        for i in range(0, n, chunk)
    ])
    out = out + (da[:, None] if da.ndim else da) * V2
    return out[:, 0] if vec else out


@torch.no_grad()
def pivoted_cholesky(
    X: torch.Tensor,
    params: GPParams,
    config: GPConfig,
    rank: int,
) -> torch.Tensor:
    """Rank-`rank` partial pivoted Cholesky L_k of the NOISELESS kernel
    K(X, X): K ~= L_k L_k^T, pivots chosen greedily by the residual diagonal
    (the first maximum on ties). Returns (n, rank).

    Each step builds one kernel column (an (n, 1) K1 call) and one (n, k)
    GEMV; the pivot stays on the device, so the loop never waits for it.
    """
    n = X.shape[0]
    L = torch.zeros((n, rank), dtype=X.dtype, device=X.device)
    diag = torch.ones(n, dtype=X.dtype, device=X.device) * torch.exp(
        params.log_amp)  # stationary: k(x, x) = amp
    for k in range(rank):
        i = torch.argmax(diag).reshape(1)
        ci = kernels.cross_covariance(X, X.index_select(0, i), params,
                                      config)[:, 0]
        # columns >= k are still zero, so contracting the full (n, rank)
        # buffer against row i applies exactly the first k pivots
        c_res = ci - L @ L.index_select(0, i)[0]
        di = diag.index_select(0, i)[0]
        lk = c_res / torch.sqrt(torch.clamp(di, min=1e-30))
        # numerical guard: the residual column of an exhausted pivot -> 0
        lk = torch.where(di > 0, lk, 0.0)
        L[:, k] = lk
        diag = torch.clamp(diag - lk * lk, min=0.0)
        diag.index_fill_(0, i, 0.0)  # pivot fully consumed, never re-picked
    return L


class Preconditioner(NamedTuple):
    """P = L_k L_k^T + D applied via Woodbury, with D either a scalar
    ridge sigma2 I (homogeneous nugget) or an (n,) diagonal (per-point
    observation noise). Scalar form:
    P^-1 v = (v - L_k M^-1 L_k^T v) / sigma2,  M = sigma2 I_k + L_k^T L_k.
    Vector form (capacitance convention):
    P^-1 v = D^-1 v - D^-1 L_k M^-1 L_k^T D^-1 v,  M = I_k + L_k^T D^-1 L_k."""

    Lk: torch.Tensor  # (n, k)
    sigma2: torch.Tensor  # scalar ridge, or (n,) diagonal ridge
    M_chol: torch.Tensor  # (k, k) lower Cholesky of M

    def _msolve(self, W: torch.Tensor) -> torch.Tensor:
        W = torch.linalg.solve_triangular(self.M_chol, W, upper=False)
        return torch.linalg.solve_triangular(self.M_chol.mT, W, upper=True)

    def solve(self, V: torch.Tensor) -> torch.Tensor:
        if self.sigma2.ndim == 0:
            W = self._msolve(self.Lk.mT @ V)  # (k, m)
            return (V - self.Lk @ W) / self.sigma2
        U = V / self.sigma2[:, None]  # D^-1 v
        W = self._msolve(self.Lk.mT @ U)
        return U - (self.Lk @ W) / self.sigma2[:, None]

    def logdet(self) -> torch.Tensor:
        """log|P| by Sylvester: scalar (n-k) log sigma2 + log|M|; vector
        sum(log d_i) + log|M| (M already capacitance-normalized)."""
        n, k = self.Lk.shape
        mld = 2.0 * torch.log(torch.diagonal(self.M_chol)).sum()
        if self.sigma2.ndim == 0:
            return (n - k) * torch.log(self.sigma2) + mld
        return torch.log(self.sigma2).sum() + mld

    def ridge_sqrt(self) -> torch.Tensor:
        """sqrt of the ridge, shaped to scale (n, m) probe blocks."""
        s = torch.sqrt(self.sigma2)
        return s[:, None] if s.ndim else s


def make_preconditioner(
    Lk: torch.Tensor, sigma2, max_cond: Optional[float] = None
) -> Preconditioner:
    """Build P = L_k L_k^T + sigma_p^2 I with a conditioning-safe ridge.

    sigma_p^2 = max(sigma2, lambda_1(L_k^T L_k) / max_cond), max_cond
    defaulting to 1e-2 / eps(dtype): at smooth-kernel thetas the float32
    Cholesky of the Woodbury capacitance M carries O(eps cond(M)) relative
    error, enough to make the applied P^-1 indefinite and diverge the solve
    it should accelerate. The floor caps cond(M) at max_cond (a factor error
    <= 1%); the state carries the ridge actually applied, so logdet() and
    the probe draws use the same operator. sigma2 is a scalar or an (n,)
    vector (per-point noise), floored elementwise.
    """
    k = Lk.shape[1]
    G = Lk.mT @ Lk
    if max_cond is None:
        max_cond = 1e-2 / torch.finfo(Lk.dtype).eps
    lam1 = G.abs().sum(dim=1).max()  # inf-norm >= lambda_1(G)
    sigma2_p = torch.maximum(
        torch.as_tensor(sigma2, dtype=Lk.dtype, device=Lk.device),
        lam1 / max_cond)
    eye = torch.eye(k, dtype=Lk.dtype, device=Lk.device)
    if sigma2_p.ndim == 0:
        M = sigma2_p * eye + G
    else:
        # capacitance M = I + Lk^T D^-1 Lk; cond(M) <= 1 + lam1(G) / min(D),
        # so the elementwise floor gives the scalar branch's max_cond cap
        M = eye + Lk.mT @ (Lk / sigma2_p[:, None])
    return Preconditioner(Lk=Lk, sigma2=sigma2_p,
                          M_chol=linalg.xla_cholesky(M))


def pcg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    B: torch.Tensor,
    precond: Optional[Preconditioner] = None,
    tol: float = 1e-6,
    max_iters: int = 256,
    track_tridiag: bool = False,
):
    """Batched preconditioned CG: solve A x = b for every column of B.

    Returns (X, rel_residual (m,), iters_used). Converged columns freeze
    (masked updates); the loop ends when every column has converged or
    broken down, or at max_iters. Its stop test is read back to the host
    once an iteration.

    Breakdown hardening: a column whose curvature p^T A p or r^T z is not
    positive, or whose update turns non-finite, is frozen at its last
    finite iterate and keeps its last residual, so callers see rel > tol
    and can gate on it.

    track_tridiag=True also returns (alphas, betas, steps), each
    (max_iters, m) / (m,): the CG coefficients per column, the raw material
    of the mBCG Lanczos tridiagonals:
        T[0,0]   = 1/alpha_0
        T[k,k]   = 1/alpha_k + beta_{k-1}/alpha_{k-1}
        T[k,k+1] = sqrt(beta_k)/alpha_k
    valid for iterations 0..steps_j-1 of column j.
    """
    vec = B.ndim == 1
    B2 = B[:, None] if vec else B
    m = B2.shape[1]
    bnorm = torch.clamp(torch.linalg.vector_norm(B2, dim=0), min=1e-30)

    def psolve(V):
        return precond.solve(V) if precond is not None else V

    X = torch.zeros_like(B2)
    R = B2
    Z = psolve(R)
    P = Z
    rz = (R * Z).sum(0)
    frozen = torch.zeros(m, dtype=torch.bool, device=B2.device)
    At = B2.new_zeros((max_iters, m))  # alphas per iteration
    Bt = B2.new_zeros((max_iters, m))  # betas per iteration
    steps = torch.zeros(m, dtype=torch.int32, device=B2.device)
    i = 0
    while i < max_iters:
        active = (torch.linalg.vector_norm(R, dim=0) / bnorm > tol) & ~frozen
        if not bool(active.any()):
            break
        AP = matvec(P)
        pap = (P * AP).sum(0)
        # pap <= 0 (everything finite) is the common float32 breakdown at
        # the matvec noise floor, rz <= 0 an indefinite applied P^-1: a
        # step would be finite and wrong, so take none and freeze
        curv_ok = pap > 0
        rz_ok = rz > 0
        step_ok = active & curv_ok & rz_ok
        alpha = torch.where(step_ok, rz / torch.where(curv_ok, pap, 1.0), 0.0)
        Xn = X + alpha * P
        Rn = R - alpha * AP
        Zn = psolve(Rn)
        rz_new = (Rn * Zn).sum(0)
        beta = torch.where(step_ok, rz_new / torch.where(rz_ok, rz, 1.0), 0.0)
        Pn = Zn + beta * P
        col_ok = (curv_ok & rz_ok
                  & torch.isfinite(Xn).all(0) & torch.isfinite(Rn).all(0)
                  & torch.isfinite(Pn).all(0) & torch.isfinite(rz_new))
        newly_frozen = active & ~col_ok
        keep = ~newly_frozen
        X = torch.where(keep, Xn, X)
        R = torch.where(keep, Rn, R)
        Z = torch.where(keep, Zn, Z)
        P = torch.where(keep, Pn, P)
        rz = torch.where(newly_frozen, rz, rz_new)
        took = active & col_ok
        At[i] = torch.where(took, alpha, 0.0)
        Bt[i] = torch.where(took, beta, 0.0)
        steps += took.to(torch.int32)
        frozen = frozen | newly_frozen
        i += 1
    rel = torch.linalg.vector_norm(R, dim=0) / bnorm
    if vec:
        X, rel, At, Bt, steps = X[:, 0], rel[0], At[:, 0], Bt[:, 0], steps[0]
    out = (X, rel, i)
    return out + ((At, Bt, steps),) if track_tridiag else out


def _lanczos_tridiag_batched(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    Z: torch.Tensor,
    iters: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lanczos on all probes in lock step: Z is (n, p); returns
    (alphas (iters, p), betas (iters-1, p)) of each probe's tridiagonal,
    with full reorthogonalization against the stored basis. One (n, p)
    matvec per iteration; memory O(n p iters)."""
    n, p = Z.shape
    Q = Z.new_zeros((iters, n, p))
    Q[0] = Z / torch.linalg.vector_norm(Z, dim=0, keepdim=True)
    alphas = Z.new_zeros((iters, p))
    betas = Z.new_zeros((max(iters - 1, 1), p))
    for j in range(iters):
        qj = Q[j]
        W = matvec(qj)  # one call for all probes
        aj = (qj * W).sum(0)
        W = W - aj * qj
        if j > 0:
            W = W - betas[j - 1] * Q[j - 1]
        # full reorthogonalization per probe (rows > j are zero, harmless)
        coeff = torch.einsum("knp,np->kp", Q, W)
        W = W - torch.einsum("knp,kp->np", Q, coeff)
        bj = torch.linalg.vector_norm(W, dim=0)
        alphas[j] = aj
        if j + 1 < iters:
            betas[j] = bj
            Q[j + 1] = torch.where(bj > 1e-12,
                                   W / torch.clamp(bj, min=1e-30), 0.0)
    return alphas, betas[: iters - 1] if iters > 1 else betas[:0]


def _tridiag_quadrature(diag: torch.Tensor, off: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """w_j e1^T log(T_j) e1 for each tridiagonal T_j given as its diagonal
    diag (K, p) and off-diagonal off (K-1, p): (p,)."""
    T = (torch.diag_embed(diag.mT) + torch.diag_embed(off.mT, 1)
         + torch.diag_embed(off.mT, -1))
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.clamp(evals, min=1e-30)
    return (evecs[:, 0, :] ** 2 * torch.log(evals)).sum(-1) * weights


def slq_logdet(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    seed: int,
    probes: int = 16,
    lanczos_iters: int = 32,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> torch.Tensor:
    """Stochastic Lanczos quadrature estimate of log|A| (A SPD via matvec):
    E_z[z^T log(A) z] over Rademacher probes drawn from `seed`, each
    quadratic form from the eigendecomposition of its Lanczos tridiagonal.
    probes >= n is exact: canonical-basis probes and a full Krylov run.
    Biased low for few Lanczos iterations on an ill-conditioned A."""
    m = min(lanczos_iters, n)
    exact = probes >= n
    if exact:
        # canonical-basis probes each give one diagonal entry of log(A);
        # their SUM is the trace
        Z = torch.eye(n, dtype=dtype, device=device)
        m = n
    else:
        (z,) = _draw_probes(seed, "slq", n, probes, 0)
        Z = torch.tensor(z, dtype=dtype, device=device)
    alphas, betas = _lanczos_tridiag_batched(matvec, Z, m)
    ests = _tridiag_quadrature(alphas, betas, (Z * Z).sum(0))
    return ests.sum() if exact else ests.mean()


def mbcg_quadrature(At: torch.Tensor, Bt: torch.Tensor, steps: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Per-probe Gauss quadrature w_j e1^T log(T_j) e1 from CG coefficients
    (mBCG; Gardner et al. 2018). At/Bt are (max_iters, p), steps (p,)
    counts valid iterations; weights (p,) are z^T P^-1 z for probes
    z ~ N(0, P). Iterations beyond steps contribute log(1) = 0 (identity
    padding)."""
    max_iters = At.shape[0]
    it = torch.arange(max_iters, device=At.device)[:, None]
    steps = steps[None, :]
    a_safe = torch.where(At > 0, At, 1.0)
    a_prev = torch.cat([torch.ones_like(At[:1]), At[:-1]])
    b_prev = torch.cat([torch.zeros_like(Bt[:1]), Bt[:-1]])
    diag = 1.0 / a_safe + b_prev / torch.where(a_prev > 0, a_prev, 1.0)
    diag = torch.where(it < steps, diag, 1.0)
    off = torch.sqrt(torch.clamp(Bt, min=0.0)) / a_safe
    off = torch.where(it < steps - 1, off, 0.0)[: max_iters - 1]
    return _tridiag_quadrature(diag, off, weights)


# Probe streams: one torch.Generator seed per (seed, stream), the roles of
# the JAX package's keys (key(seed), fold_in(key, 1), fold_in(key, 2)).
_STREAMS = {"slq": 0, "hutchinson": 1, "mbcg": 2}


def _draw_probes(seed: int, stream: str, n: int, probes: int,
                 rank: int) -> tuple:
    """The random probes of one estimator, as float64 numpy arrays drawn on
    the CPU: "slq" (the SLQ logdet) and "hutchinson" (the trace in the
    backward) give ((n, probes) Rademacher signs,); "mbcg" gives
    (w1 (rank, probes), w2 (n, probes)) standard normals, for probes
    L_k w1 + sqrt(ridge) w2 ~ N(0, P)."""
    g = torch.Generator().manual_seed(len(_STREAMS) * int(seed)
                                      + _STREAMS[stream])
    if stream == "mbcg":
        return (torch.randn((rank, probes), generator=g,
                            dtype=torch.float64).numpy(),
                torch.randn((n, probes), generator=g,
                            dtype=torch.float64).numpy())
    signs = 2 * torch.randint(0, 2, (n, probes), generator=g) - 1
    return (signs.to(torch.float64).numpy(),)


class IterativeInfo(NamedTuple):
    solve_rel_residual: torch.Tensor  # worst relative residual of the solves
    cg_iters: int


def _matvec_for(params, data, config, mesh, row_chunk: int = 2048):
    """The training matvec closure: row-chunked on one device, or
    row-sharded over `mesh` (`parallel.iterative_sharded`; the JAX package
    leaves the sharded matvec at its default row_chunk, the port passes
    it). row_chunk bounds the kernel tile at (row_chunk, n)."""
    if mesh is None:
        return lambda V: gram_matvec(data.X, params, config, V,
                                     row_chunk=row_chunk, noise=data.noise)
    from madaiemulator_tpu_torch.parallel.iterative_sharded import (
        make_sharded_matvec,
    )

    return make_sharded_matvec(data.X, params, config, mesh,
                               row_chunk=row_chunk, noise=data.noise)


def _solve_C(params, data, config, rank, cg, B, mesh=None, row_chunk=2048):
    """PCG solve C^-1 B with a fresh pivoted-Cholesky preconditioner."""
    tol, iters = cg
    Lk = pivoted_cholesky(data.X, params, config, rank)
    pre = make_preconditioner(Lk, _ridge(params, data, config))
    mv = _matvec_for(params, data, config, mesh, row_chunk)
    return pcg_solve(mv, B, pre, tol=tol, max_iters=iters)


def _training_operator(params, data, config, rank, mesh=None, row_chunk=2048):
    """Preconditioner, matvec, regression basis and the [y | H] RHS block:
    the training-solve operator, shared by the LML forward and the serving
    precompute so that the two always solve the same system."""
    Lk = pivoted_cholesky(data.X, params, config, rank)
    pre = make_preconditioner(Lk, _ridge(params, data, config))
    mv = _matvec_for(params, data, config, mesh, row_chunk)
    H = regression_basis(data.X, config.regression_order)
    if data.h_extra is not None:
        # extra GLS columns (the multi-fidelity rho column), training side
        # only: predict_iterative_from_state rejects h_extra data
        H = torch.cat([H, data.h_extra.to(H.dtype)], dim=1)
    B = torch.cat([data.y[:, None], H], dim=1)  # (n, 1 + p)
    return pre, mv, H, B, Lk


def _gls_from_solves(H, Ciy, CiH):
    """GLS algebra from the training solves: A = H^T C^-1 H (Cholesky LA),
    beta = A^-1 H^T C^-1 y, alpha = C^-1 (y - H beta) without a second
    solve."""
    LA = linalg.xla_cholesky(H.mT @ CiH)
    w = torch.linalg.solve_triangular(LA, (H.mT @ Ciy)[:, None], upper=False)
    beta = torch.linalg.solve_triangular(LA.mT, w, upper=True)[:, 0]
    alpha = Ciy - CiH @ beta
    return LA, beta, alpha


class _IterOptions(NamedTuple):
    seed: int
    rank: int
    probes: int
    lanczos_iters: int
    cg_tol: float
    cg_max_iters: int
    logdet_method: str
    row_chunk: int
    mesh: object = None


def _lml_iterative_impl(params: GPParams, data: GPData, config: GPConfig,
                        opts: _IterOptions):
    """The forward: (ll, alpha, CiH, LA, IterativeInfo). ll is -inf unless
    every solve column (y and H; not the mBCG probes) converged below
    max(100 tol, 1e-3) with finite values."""
    n = data.X.shape[0]
    dt, dev = data.X.dtype, data.X.device
    pre, mv, H, B, Lk = _training_operator(params, data, config, opts.rank,
                                           opts.mesh, opts.row_chunk)
    nbase = B.shape[1]
    if opts.logdet_method == "mbcg":
        # probes z ~ N(0, P), drawn with P's ACTUAL ridge (the conditioning
        # floor may raise it above the nugget): the estimator holds for any
        # SPD P as long as probes and quadratures use the same operator
        w1, w2 = (torch.tensor(a, dtype=dt, device=dev) for a in
                  _draw_probes(opts.seed, "mbcg", n, opts.probes, opts.rank))
        U = Lk @ w1 + pre.ridge_sqrt() * w2
        B = torch.cat([B, U], dim=1)
    elif opts.logdet_method != "slq":
        raise ValueError(f"unknown logdet_method {opts.logdet_method!r}")
    S, rel, it, (At, Bt, steps) = pcg_solve(
        mv, B, pre, tol=opts.cg_tol, max_iters=opts.cg_max_iters,
        track_tridiag=True)
    Ciy, CiH = S[:, 0], S[:, 1:nbase]
    LA, beta, alpha = _gls_from_solves(H, Ciy, CiH)
    quad = (data.y - H @ beta) @ alpha
    if opts.logdet_method == "mbcg":
        weights = (U * pre.solve(U)).sum(0)  # z^T P^-1 z per probe
        quads = mbcg_quadrature(At[:, nbase:], Bt[:, nbase:], steps[nbase:],
                                weights)
        logdet = pre.logdet() + quads.mean()
    else:
        logdet = slq_logdet(mv, n, opts.seed, probes=opts.probes,
                            lanczos_iters=opts.lanczos_iters, dtype=dt,
                            device=dev)
    ll = -0.5 * quad - 0.5 * logdet - 0.5 * n * math.log(2.0 * math.pi)
    if config.reml:
        ll = ll - torch.log(torch.diagonal(LA)).sum()
    # Feasibility gate (the dense path's non-SPD -> -inf): unconverged
    # solves make the estimate garbage, so the region is walled off. Only
    # the solve columns count: a probe column that stops early truncates
    # its quadrature, the normal mBCG situation.
    rel_solves = rel[:nbase].max()
    ok = (torch.isfinite(ll) & torch.isfinite(S[:, :nbase]).all()
          & (rel_solves < max(opts.cg_tol * 100.0, 1e-3)))
    ll = torch.where(ok, ll, -math.inf)
    return ll, alpha, CiH, LA, IterativeInfo(rel_solves, it)


def _tile_grads(Xr: torch.Tensor, X: torch.Tensor, p: GPParams,
                config: GPConfig, Wr: torch.Tensor, V: torch.Tensor,
                chunk: int) -> list:
    """sum over the row chunks c of Xr of d/dtheta <W_c V^T, K(X_c, X)>, per
    leaf of p (whose leaves require grad), one (chunk, n) tile at a time:
    the tile is rebuilt under autograd (K1 at float32, whose backward is
    the library-math VJP), back-propagated with cotangent W_c V^T, and
    freed before the next chunk."""
    leaves = list(p)
    total = [torch.zeros_like(t) for t in leaves]
    for i in range(0, Xr.shape[0], chunk):
        Kc = kernels.cross_covariance(Xr[i:i + chunk], X, p, config)
        grads = torch.autograd.grad(Kc, leaves,
                                    grad_outputs=Wr[i:i + chunk] @ V.mT,
                                    allow_unused=True)
        for acc, gr in zip(total, grads):
            if gr is not None:
                acc += gr
        del Kc
    return total


def _quad_form_grad(params: GPParams, data: GPData, config: GPConfig,
                    W: torch.Tensor, V: torch.Tensor,
                    row_chunk: int, mesh=None) -> Tuple[torch.Tensor, ...]:
    """d/dtheta of sum_j w_j^T C(theta) v_j for W, V (n, m), per leaf of
    params. The kernel part one (row_chunk, n) tile at a time
    (`_tile_grads`), so no N x N residual is ever held; with a `mesh`, the
    tile loop split by the sharded matvec's row blocks, each device
    accumulating its partial (`parallel.iterative_sharded`). The diagonal
    term is differentiated on its own."""
    X = data.X
    n = X.shape[0]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in params]
        p = GPParams(*leaves)
        if mesh is None:
            total = _tile_grads(X, X, p, config, W, V, min(row_chunk, n))
        else:
            from madaiemulator_tpu_torch.parallel.iterative_sharded import (
                quad_form_tile_grads,
            )

            total = list(quad_form_tile_grads(params, X, config, W, V, mesh,
                                              row_chunk))
        da = _ridge(p, data, config)
        wv = (W * V).sum(1)
        diag_term = (da * wv).sum() if da.ndim else da * wv.sum()
        for acc, gr in zip(total, torch.autograd.grad(diag_term, leaves,
                                                      allow_unused=True)):
            if gr is not None:
                acc += gr
    return tuple(total)


class _LMLIterative(torch.autograd.Function):
    """The matrix-free LML with the BBMM-style backward (JAX
    `_lml_iter_bwd`), no N x N intermediate:

      d lml = 0.5 alpha^T dC alpha - 0.5 tr(C^-1 dC)
      tr(C^-1 dC) ~= (1/p) sum_i (C^-1 z_i)^T dC z_i   (Hutchinson; exact,
                     as a sum, with canonical-basis probes when probes >= N)

    and under REML +0.5 tr(W A^-1 W^T dC) with W = C^-1 H, from the CiH and
    chol(A) of the forward. The three contractions are u^T dC v forms; they
    are summed into one cotangent per tile and evaluated in one pass over
    the tiles (`_quad_form_grad`), the same arithmetic as three passes.
    """

    @staticmethod
    def forward(ctx, log_amp, log_nugget, log_ls, data, config, opts):
        params = GPParams(log_amp, log_nugget, log_ls)
        ll, alpha, CiH, LA, _ = _lml_iterative_impl(params, data, config,
                                                    opts)
        ctx.save_for_backward(log_amp, log_nugget, log_ls)
        ctx.solves = (alpha, CiH, LA)
        ctx.data, ctx.config, ctx.opts = data, config, opts
        return ll

    @staticmethod
    def backward(ctx, g):
        params = GPParams(*ctx.saved_tensors)
        alpha, CiH, LA = ctx.solves
        data, config, opts = ctx.data, ctx.config, ctx.opts
        n = data.X.shape[0]
        dt, dev = data.X.dtype, data.X.device
        if opts.probes >= n:
            # exact trace: canonical-basis probes, summed
            Zp = torch.eye(n, dtype=dt, device=dev)
            scale = 1.0
        else:
            (z,) = _draw_probes(opts.seed, "hutchinson", n, opts.probes,
                                opts.rank)
            Zp = torch.tensor(z, dtype=dt, device=dev)
            scale = 1.0 / opts.probes  # Hutchinson mean
        CiZ, _, _ = _solve_C(params, data, config, opts.rank,
                             (opts.cg_tol, opts.cg_max_iters), Zp,
                             mesh=opts.mesh, row_chunk=opts.row_chunk)
        Wl = [0.5 * alpha[:, None], (-0.5 * scale) * CiZ]
        Vr = [alpha[:, None], Zp]
        if config.reml:
            w = torch.linalg.solve_triangular(LA, CiH.mT, upper=False)
            Wl.append(0.5 * torch.linalg.solve_triangular(
                LA.mT, w, upper=True).mT)  # 0.5 CiH A^-1
            Vr.append(CiH)
        grads = _quad_form_grad(params, data, config, torch.cat(Wl, dim=1),
                                torch.cat(Vr, dim=1), opts.row_chunk,
                                mesh=opts.mesh)
        return (*(gr * g for gr in grads), None, None, None)


def lml_iterative(
    params: GPParams,
    data: GPData,
    config: GPConfig,
    seed: int = 0,
    rank: int = 64,
    probes: int = 16,
    lanczos_iters: int = 32,
    cg_tol: float = 1e-6,
    cg_max_iters: int = 256,
    mesh=None,
    logdet_method: str = "slq",
    row_chunk: int = 2048,
) -> torch.Tensor:
    """Matrix-free GLS log-marginal likelihood, differentiable with respect
    to params by the Hutchinson / adjoint-solve backward (`_LMLIterative`).
    `seed` fixes the probe vectors: keep it constant across an optimization
    so the objective is a deterministic sample-average approximation.
    probes >= N switches both estimators to exact canonical-basis traces
    (O(N) solves; for validation at small N). logdet_method="mbcg" takes
    the logdet from the same preconditioned-CG pass as the solves (the
    probes ride as extra right-hand sides); "slq" runs a separate Lanczos.

    params holds one GP, or a batch (B,) of them evaluated one after
    another: the result is then (B,). A 1-D `mesh`
    (`parallel.iterative_sharded.make_rows_mesh`) runs every matvec of the
    forward and the backward row-sharded over its devices, the multi-device
    large-N fit objective; the value and gradient are those of the
    single-device layout."""
    if data.dY is not None:
        raise ValueError(
            "the matrix-free path does not support gradient-enhanced data "
            "(dY): the joint value+gradient matvec is not implemented — "
            "use the dense path (models/gp.py), which covers GEK sizes"
        )
    check_mesh(mesh, "lml_iterative")
    kw = dict(seed=seed, rank=rank, probes=probes,
              lanczos_iters=lanczos_iters, cg_tol=cg_tol,
              cg_max_iters=cg_max_iters, logdet_method=logdet_method,
              row_chunk=row_chunk, mesh=mesh)
    if params.log_amp.ndim:
        return torch.stack([
            lml_iterative(GPParams(*(a[b] for a in params)), data, config,
                          **kw)
            for b in range(params.log_amp.shape[0])])
    return _LMLIterative.apply(params.log_amp, params.log_nugget,
                               params.log_ls, data, config,
                               _IterOptions(**kw))


def fit_gp_iterative(
    generator: torch.Generator,
    data: GPData,
    config: GPConfig,
    n_restarts: Optional[int] = None,
    max_steps: Optional[int] = None,
    seed: int = 0,
    rank: int = 64,
    probes: int = 16,
    lanczos_iters: int = 32,
    cg_tol: float = 1e-5,
    cg_max_iters: int = 256,
    vg_batch: Optional[int] = 1,
    mesh=None,
    logdet_method: str = "slq",
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 5,
    value_linesearch: Optional[bool] = None,
    row_chunk: int = 2048,
):
    """Hyperparameter estimation with the matrix-free likelihood: the
    host-loop LBFGS of `models.fit.fit_gp_host` with `lml_iterative` as the
    objective (restarts drawn from `generator`). The probes are fixed by
    `seed`, so the objective is deterministic across LBFGS iterations.
    vg_batch (default 1) is the number of restarts per objective call; the
    restarts of one call are evaluated one after another. `mesh` shards
    every matvec over its devices (see `lml_iterative`)."""
    from madaiemulator_tpu_torch.models.fit import fit_gp_host

    if data.dY is not None:
        raise ValueError(
            "the matrix-free path does not support gradient-enhanced data "
            "(dY); use the dense fit (models/fit.py)")
    check_mesh(mesh, "fit_gp_iterative")

    def lml_fn(params, d, cfg):
        return lml_iterative(
            params, d, cfg, seed=seed, rank=rank, probes=probes,
            lanczos_iters=lanczos_iters, cg_tol=cg_tol,
            cg_max_iters=cg_max_iters, logdet_method=logdet_method,
            row_chunk=row_chunk, mesh=mesh,
        )

    return fit_gp_host(
        generator, data, config, n_restarts=n_restarts, max_steps=max_steps,
        vg_batch=vg_batch, lml_fn=lml_fn,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        value_linesearch=value_linesearch,
    )


class IterativePosteriorState(NamedTuple):
    """Matrix-free serving cache: the pivoted-Cholesky preconditioner and
    the training solves (alpha, beta, CiH, LA) of a trained (params, data)
    pair, built once, so a served query batch costs one variance solve per
    chunk (or a Woodbury apply) and no training-grade solve. `config` is
    the effective config of the precompute (any jitter override included),
    so every later solve sees the identical operator."""

    params: GPParams
    config: GPConfig
    pre: Preconditioner
    alpha: torch.Tensor  # (n,)   C^-1 (y - H beta)
    beta: torch.Tensor  # (p,)    GLS coefficients
    CiH: torch.Tensor  # (n, p)   C^-1 H
    LA: torch.Tensor  # (p, p)    lower Cholesky of H^T C^-1 H
    cg_tol: float
    cg_max_iters: int


@torch.no_grad()
def precompute_iterative_predictor(
    params: GPParams,
    data: GPData,
    config: GPConfig,
    rank: int = 64,
    cg_tol: float = 1e-6,
    cg_max_iters: int = 256,
    jitter: Optional[float] = None,
    row_chunk: int = 2048,
    mesh=None,
) -> IterativePosteriorState:
    """One-time matrix-free training solves for serving (see
    IterativePosteriorState). `jitter` overrides the config's diagonal
    stability floor (raise it by hand if a stiff snapshot's solves stall;
    the CG is breakdown-hardened, so the output stays finite either
    way). `mesh` shards the training matvec over its devices, as in
    `lml_iterative` (the JAX function has no mesh argument)."""
    if data.dY is not None:
        raise ValueError(
            "the matrix-free path does not support gradient-enhanced data "
            "(dY); use precompute_predictor (models/gp.py)"
        )
    if jitter is not None:
        config = dataclasses.replace(config, jitter=jitter)
    check_mesh(mesh, "precompute_iterative_predictor")
    pre, mv, H, B, _ = _training_operator(params, data, config, rank, mesh,
                                          row_chunk)
    S, _, _ = pcg_solve(mv, B, pre, tol=cg_tol, max_iters=cg_max_iters)
    LA, beta, alpha = _gls_from_solves(H, S[:, 0], S[:, 1:])
    return IterativePosteriorState(
        params=params, config=config, pre=pre, alpha=alpha, beta=beta,
        CiH=S[:, 1:], LA=LA, cg_tol=cg_tol, cg_max_iters=cg_max_iters,
    )


def predict_iterative_from_state(
    state: IterativePosteriorState,
    data: GPData,
    Xs: torch.Tensor,
    query_chunk: int = 1024,
    with_variance: bool = True,
    variance_method: str = "exact",
    row_chunk: int = 2048,
    variance_rhs: int = 128,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Serve one query batch from the cached state, query_chunk queries at
    a time: one (n, chunk) cross-covariance (K1) and GEMMs for the mean and,
    with_variance, k*^T C^-1 k* plus the GLS correction. Memory
    O(n (rank + query_chunk)); the answers do not depend on query_chunk or
    variance_rhs.

    variance_method="exact" solves C^-1 k* by PCG in column blocks of at
    most variance_rhs right-hand sides (each column's Krylov solve is
    independent of the others). "precond" replaces the solve with the
    cached preconditioner's Woodbury apply, k*^T P^-1 k*: O(n rank) per
    query. When P's ridge is the plain nugget + jitter diagonal
    (state.pre.sigma2 equal to it, the usual case) P <= C, since the
    pivoted-Cholesky residual is PSD, so the reported variance is a lower
    bound that tightens with the rank (exact at rank = n); if the
    conditioning floor raised the ridge, it is an approximation, not a
    bound. The mean and the GLS correction are exact either way.

    The "precond" route is differentiable in Xs by torch autograd (HMC over
    a matrix-free emulator); "exact" runs without autograd (its PCG loop,
    like the JAX package's while loop, has no reverse pass)."""
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and variance_method == "precond"):
        return _predict_from_state(state, data, Xs, query_chunk,
                                   with_variance, variance_method, row_chunk,
                                   variance_rhs)


def _predict_from_state(state, data, Xs, query_chunk, with_variance,
                        variance_method, row_chunk, variance_rhs):
    params, config = state.params, state.config
    if data.h_extra is not None:
        raise ValueError(
            "predict_iterative_from_state does not support GPData.h_extra "
            "(no query-side hs_extra plumbing)"
        )
    if variance_method not in ("exact", "precond"):
        raise ValueError(f"unknown variance_method {variance_method!r}")
    mv = _matvec_for(params, data, config, None, row_chunk)
    kss = torch.exp(params.log_amp) + (
        torch.exp(params.log_nugget)
        if config.predict_variance_includes_nugget else 0.0)

    def do_chunk(xq):
        Ks = kernels.cross_covariance(data.X, xq, params, config)  # (n, c)
        Hs = regression_basis(xq, config.regression_order)  # (c, p)
        mean = Hs @ state.beta + Ks.mT @ state.alpha
        if not with_variance:
            return mean, None
        if variance_method == "precond":
            CiKs = state.pre.solve(Ks)  # Woodbury apply: O(n rank c)
        else:
            CiKs = torch.cat([
                pcg_solve(mv, Ks[:, j:j + variance_rhs], state.pre,
                          tol=state.cg_tol,
                          max_iters=state.cg_max_iters)[0]
                for j in range(0, Ks.shape[1], variance_rhs)
            ], dim=1)
        var = kss - (Ks * CiKs).sum(0)
        G = Hs.mT - state.CiH.mT @ Ks
        W = torch.linalg.solve_triangular(state.LA, G, upper=False)
        return mean, torch.clamp(var + (W * W).sum(0), min=0.0)

    parts = [do_chunk(Xs[i:i + query_chunk])
             for i in range(0, Xs.shape[0], query_chunk)]
    means = torch.cat([m for m, _ in parts])
    if not with_variance:
        return means, None
    return means, torch.cat([v for _, v in parts])


def predict_iterative_host(
    state: IterativePosteriorState,
    data: GPData,
    Xs: torch.Tensor,
    chunk: int = 64,
    **kwargs,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The JAX package's host-side chunk loop for exact variances over
    large query sets. Every serve of the port already loops over query
    chunks on the host, so this is `predict_iterative_from_state` with
    query_chunk=chunk (unless kwargs set it); kwargs forward to it."""
    kwargs.setdefault("query_chunk", max(1, int(chunk)))
    return predict_iterative_from_state(state, data, Xs, **kwargs)


def predict_iterative(
    params: GPParams,
    data: GPData,
    Xs: torch.Tensor,
    config: GPConfig,
    rank: int = 64,
    cg_tol: float = 1e-6,
    cg_max_iters: int = 256,
    query_chunk: int = 1024,
    with_variance: bool = True,
    jitter: Optional[float] = None,
    state: Optional[IterativePosteriorState] = None,
    variance_method: str = "exact",
    row_chunk: int = 2048,
    variance_rhs: int = 128,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Posterior mean (and optionally variance) with no N x N buffer:
    builds the serving cache (unless `state` is given) and answers one
    batch. Repeated callers build the cache once with
    `precompute_iterative_predictor` and serve through
    `predict_iterative_from_state`."""
    if state is None:
        state = precompute_iterative_predictor(
            params, data, config, rank=rank, cg_tol=cg_tol,
            cg_max_iters=cg_max_iters, jitter=jitter, row_chunk=row_chunk,
        )
    return predict_iterative_from_state(
        state, data, Xs, query_chunk=query_chunk,
        with_variance=with_variance, variance_method=variance_method,
        row_chunk=row_chunk, variance_rhs=variance_rhs,
    )
