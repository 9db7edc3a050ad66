"""Hyperparameter estimation: multi-restart LBFGS over the exact-gradient LML
(port of madaiemulator_tpu/models/fit.py).

Two fit entry points, as in the JAX package:

- `fit_gp` (and `fit_one_start`, `fit_gp_alpha`): optax's L-BFGS with the
  zoom (or backtracking) linesearch, ported as a lock-step batch over every
  lane (`models.lbfgs`). All restarts, and in `fit_multivariate` all
  (component x restart) lanes, step together: each objective evaluation is
  one batched value (and gradient) of the likelihood over the lanes, one
  Gram build by kernel K1 and one factorization by kernel K2 at float32.
- `fit_gp_host`, for large N: the LBFGS two-loop recursion and
  Armijo backtracking on the host in numpy, vectorized over restarts; only
  the batched value and gradient of the likelihood runs in torch.

Restarts are drawn log-uniform inside the configured theta boxes from an
explicit `torch.Generator` and optimized in an unconstrained u-space mapped
into the boxes by a sigmoid. A restart whose covariance goes non-SPD gets
LML = -inf and a NaN gradient there; per-restart best-so-far tracking keeps
its best finite iterate, and the cross-restart argmax ignores bad
trajectories.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from madaiemulator_tpu_torch.models import lbfgs
from madaiemulator_tpu_torch.models.gp import GPData, log_marginal_likelihood
from madaiemulator_tpu_torch.ops.kernels import GPParams
from madaiemulator_tpu_torch.utils.config import GPConfig

logger = logging.getLogger(__name__)


class FitResult(NamedTuple):
    params: GPParams  # best-of-restarts hyperparameters (log space)
    log_likelihood: torch.Tensor  # its LML
    restart_log_likelihoods: torch.Tensor  # (R,) per-restart best LML
    restart_params: GPParams  # (R, ...) per-restart best params
    # objective evaluations and wall time. fit_gp_host: {n_vg_calls,
    # first_vg_wall_s (kernel build + first run), vg_wall_s (the rest),
    # n_v_calls, v_wall_s, n_steps, fit_wall_s}. fit_gp: {n_vg_calls,
    # n_v_calls (batched value+grad and value-only evaluations, each over
    # every lane of one restart group), n_steps, linesearch_evals (and
    # linesearch_evals_by_step), fit_wall_s}
    stats: Optional[dict] = None


def _bounds_arrays(
    config: GPConfig, dtype: torch.dtype, device=None
) -> Tuple[GPParams, GPParams]:
    """(lo, hi) as GPParams of log-bounds."""
    k = config.num_length_scales

    def arr(v, shape=()):
        return torch.full(shape, math.log(v), dtype=dtype, device=device)

    lo = GPParams(
        log_amp=arr(config.amp_bounds[0]),
        log_nugget=arr(config.nugget_bounds[0]),
        log_ls=arr(config.length_scale_bounds[0], (k,)),
    )
    hi = GPParams(
        log_amp=arr(config.amp_bounds[1]),
        log_nugget=arr(config.nugget_bounds[1]),
        log_ls=arr(config.length_scale_bounds[1], (k,)),
    )
    return lo, hi


def _u_to_params(u: GPParams, lo: GPParams, hi: GPParams) -> GPParams:
    """Unconstrained u -> log-theta via sigmoid into the [lo, hi] log-box."""
    return GPParams(*(l + (h - l) * torch.sigmoid(uu)
                      for uu, l, h in zip(u, lo, hi)))


def _params_to_u(p: GPParams, lo: GPParams, hi: GPParams) -> GPParams:
    def inv(pp, l, h):
        s = torch.clamp((pp - l) / (h - l), 1e-6, 1.0 - 1e-6)
        return torch.log(s) - torch.log1p(-s)

    return GPParams(*(inv(pp, l, h) for pp, l, h in zip(p, lo, hi)))


def sample_restarts(
    generator: torch.Generator,
    config: GPConfig,
    n_restarts: int,
    dtype: torch.dtype = torch.float32,
) -> GPParams:
    """Draw restart thetas log-uniform in the boxes (leading axis R), in the
    unconstrained u-space, on the CPU from `generator` (a CPU generator)."""

    def draw(shape):
        s = 0.05 + 0.9 * torch.rand(shape, generator=generator,
                                    dtype=torch.float64)
        return (torch.log(s) - torch.log1p(-s)).to(dtype)

    return GPParams(
        log_amp=draw((n_restarts,)),
        log_nugget=draw((n_restarts,)),
        log_ls=draw((n_restarts, config.num_length_scales)),
    )


def _flatten_t(p: GPParams) -> torch.Tensor:
    """(*B, ...) GPParams -> (*B, P) tensor, columns [log_amp, log_nugget,
    log_ls...] (the JAX ravel_pytree order)."""
    return torch.cat([p.log_amp[..., None], p.log_nugget[..., None],
                      p.log_ls], dim=-1)


def _flatten(p: GPParams) -> np.ndarray:
    """(R, ...) GPParams -> (R, P) float64 host matrix."""
    return _flatten_t(p).detach().cpu().numpy().astype(np.float64)


def _unflatten(u: torch.Tensor) -> GPParams:
    """(R, P) tensor -> GPParams with leading axis R."""
    return GPParams(log_amp=u[:, 0], log_nugget=u[:, 1], log_ls=u[:, 2:])


def _lane_objective(X, y, noise, config: GPConfig, lo, hi, stats: dict,
                    dY=None, dY_noise=None, lml_fn=None, h_extra=None):
    """Batched objective of (B, P) iterates, lane b fitting targets y[b]
    (gradients dY[b], extra GLS columns h_extra[b], if given) on design
    X[b] (X (N, d) and y (N,) may be
    shared by every lane): (value_and_grad, value) closures over -lml_fn
    (default `log_marginal_likelihood`; any (params, data, config) -> (B,)
    log-likelihood differentiable by torch autograd), counting their calls
    in `stats`."""
    data = GPData(X=X, y=y, noise=noise, h_extra=h_extra, dY=dY,
                  dY_noise=dY_noise)
    if lml_fn is None:
        lml_fn = log_marginal_likelihood

    def negll(u):
        return -lml_fn(_u_to_params(_unflatten(u), lo, hi), data, config)

    def value_and_grad(u):
        u = u.detach().requires_grad_(True)
        f = negll(u)
        (g,) = torch.autograd.grad(f.sum(), u)
        stats["n_vg_calls"] += 1
        return f.detach(), g

    def value(u):
        with torch.no_grad():
            f = negll(u)
        stats["n_v_calls"] += 1
        return f

    return value_and_grad, value


def _new_stats() -> dict:
    return {"n_vg_calls": 0, "n_v_calls": 0, "n_steps": 0,
            "linesearch_evals": 0, "fit_wall_s": 0.0}


def fit_one_start(
    u0: GPParams,
    X: torch.Tensor,
    y: torch.Tensor,
    config: GPConfig,
    max_steps: int,
    noise: torch.Tensor | None = None,
    stats: dict | None = None,
    dY: torch.Tensor | None = None,
    dY_noise: torch.Tensor | None = None,
    lml_fn=None,
    h_extra: torch.Tensor | None = None,
) -> Tuple[GPParams, torch.Tensor]:
    """LBFGS trajectories from a batch of unconstrained starts u0 (leading
    lane axis B), all in lock step (`models.lbfgs.run_lbfgs`, optax's
    algorithm with `config.linesearch`). X is (N, d) shared by every lane,
    or (B, N, d), one design per lane (an ensemble); y is (N,) or (B, N);
    noise likewise, the gradient blocks dY, dY_noise (N, d) or
    (B, N, d), and the extra GLS columns h_extra (N, q) or (B, N, q)
    (`GPData.h_extra`). The JAX function runs one start and is vmapped by
    its callers (`in_axes=(0, 0, 0)` for an ensemble); this one takes the
    batch.
    Returns (best_u, best_neg_loglik (B,)) in u0's dtype.
    `stats`, when given, accumulates the objective evaluation counts.
    `lml_fn` overrides the objective as in `fit_gp_host` (the sparse fit
    passes its ELBO); None is `log_marginal_likelihood`.
    """
    dtype = y.dtype
    lo, hi = _bounds_arrays(config, dtype, X.device)
    stats = _new_stats() if stats is None else stats
    vg, v = _lane_objective(X, y, noise, config, lo, hi, stats, dY=dY,
                            dY_noise=dY_noise, lml_fn=lml_fn,
                            h_extra=h_extra)
    res = lbfgs.run_lbfgs(
        _flatten_t(u0).to(device=X.device, dtype=dtype), vg, v, max_steps,
        segments=(1, 1, config.num_length_scales),
        linesearch=config.linesearch,
    )
    stats["n_steps"] += max_steps
    stats["linesearch_evals"] += sum(res.linesearch_evals)
    by_step = stats.setdefault("linesearch_evals_by_step", [0] * max_steps)
    for k, n in enumerate(res.linesearch_evals):
        by_step[k] += n
    return _unflatten(res.best_u), res.best_value.to(dtype)


def fit_gp_host(
    generator: torch.Generator,
    data: GPData,
    config: GPConfig,
    n_restarts: int | None = None,
    max_steps: int | None = None,
    m_history: int = 10,
    gtol: float = 1e-5,
    vg_batch: int | None = None,
    lml_fn=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 5,
    value_linesearch: bool | None = None,
) -> FitResult:
    """Host-loop LBFGS, the BASELINE config-4 (N=16k) fit driver.

    One device computation, the exact value and gradient of the LML over a
    (B, ntheta) restart batch, runs in torch on `data`'s device; the
    two-loop LBFGS recursion and Armijo backtracking run on the host in
    numpy, vectorized over restarts, with converged / dead restarts masked
    out of the update. vg_batch caps how many restarts share one device
    call when R Gram matrices and their backward temporaries would not fit
    device memory.

    lml_fn overrides the objective: any (params, data, config) -> (*B,)
    log-likelihood differentiable by torch autograd.

    checkpoint_path enables checkpoint/resume: every `checkpoint_every`
    LBFGS steps the host optimizer state (iterates, gradients, LBFGS ring
    buffers, best-so-far) is written atomically as .npz; a fresh call with
    the same path resumes from the saved step. The state is keyed to
    (R, P) and to N: a mismatch is rejected, not silently misused.

    value_linesearch runs the backtracking rounds on the value only (no
    gradient), then ONE value+grad at the accepted points. None (default)
    enables it for runs of >= 25 steps, as in the JAX package.
    """
    R = config.n_restarts if n_restarts is None else n_restarts
    steps = config.max_opt_steps if max_steps is None else max_steps
    dtype = data.y.dtype
    device = data.X.device
    lo, hi = _bounds_arrays(config, dtype, device)
    B = R if vg_batch is None else max(1, min(vg_batch, R))
    if lml_fn is None:
        lml_fn = log_marginal_likelihood
    if value_linesearch is None:
        value_linesearch = steps >= 25

    stats = {
        "n_vg_calls": 0, "first_vg_wall_s": 0.0, "vg_wall_s": 0.0,
        "n_v_calls": 0, "v_wall_s": 0.0,
        "n_steps": 0, "fit_wall_s": 0.0,
    }
    t_fit0 = time.perf_counter()

    def objective(u: torch.Tensor) -> torch.Tensor:
        return -lml_fn(_u_to_params(_unflatten(u), lo, hi), data, config)

    def chunks(X_host: np.ndarray):
        """(R, P) -> device chunks of B rows (the last padded by
        repetition) and the count of real rows in each."""
        for i in range(0, R, B):
            chunk = X_host[i:i + B]
            real = chunk.shape[0]
            if real < B:
                chunk = np.concatenate(
                    [chunk, chunk[-1:].repeat(B - real, 0)], 0)
            yield torch.as_tensor(chunk, dtype=dtype, device=device), real

    def host(t: torch.Tensor, real: int) -> np.ndarray:
        return np.asarray(t.detach().cpu(), dtype=np.float64)[:real]

    def vg(X_host: np.ndarray):
        """(R, P) -> (R,), (R, P): batched value+grad, chunked to vg_batch."""
        outs_f, outs_g = [], []
        t0 = time.perf_counter()
        for u, real in chunks(X_host):
            u.requires_grad_(True)
            f = objective(u)
            (g,) = torch.autograd.grad(f.sum(), u)
            outs_f.append(host(f, real))
            outs_g.append(host(g, real))
        dt = time.perf_counter() - t0
        if stats["n_vg_calls"] == 0:
            stats["first_vg_wall_s"] = dt  # kernel build + first run
        else:
            stats["vg_wall_s"] += dt
        stats["n_vg_calls"] += 1
        return np.concatenate(outs_f), np.concatenate(outs_g)

    def v_only(X_host: np.ndarray) -> np.ndarray:
        """(R, P) -> (R,): batched objective values, chunked to vg_batch."""
        t0 = time.perf_counter()
        with torch.no_grad():
            outs = [host(objective(u), real) for u, real in chunks(X_host)]
        stats["v_wall_s"] += time.perf_counter() - t0
        stats["n_v_calls"] += 1
        return np.concatenate(outs)

    u0 = sample_restarts(generator, config, R, dtype=dtype)
    X = _flatten(u0)  # (R, P)
    P = X.shape[1]
    F, G = vg(X)
    # Dead-start rescue: draws whose objective OR gradient is non-finite
    # (unfactorable Grams at long length scales in float32) are remapped to
    # stratified moment-matched fallbacks before LBFGS starts, sweeping
    # windows from short length scales toward long ones with heavier
    # nuggets until the lane revives (JAX fit.py:361-423).
    amp_fb = float(np.clip(np.var(np.asarray(data.y.detach().cpu(),
                                             dtype=np.float64)),
                           config.amp_bounds[0] * 10,
                           config.amp_bounds[1] / 10))
    ls_top = float(config.length_scale_bounds[1])
    rescue_windows = [
        (0.05, 0.5, 1e-4, 1e-1),
        (0.2, min(2.0, ls_top * 0.8), 1e-3, 0.3),
        (0.5, ls_top * 0.9, 1e-2, 1.0),
    ]
    for ls_lo_w, ls_hi_w, nug_lo_w, nug_hi_w in rescue_windows:
        dead = ~(np.isfinite(F) & np.isfinite(G).all(axis=1))
        if not dead.any():
            break
        frac = (np.arange(R) + 0.5) / R
        ls_fb = np.exp(np.log(ls_lo_w)
                       + frac * (np.log(ls_hi_w) - np.log(ls_lo_w)))
        nug_fb = np.exp(np.log(nug_lo_w)
                        + frac * (np.log(nug_hi_w) - np.log(nug_lo_w)))
        fb = GPParams(
            log_amp=torch.full((R,), math.log(amp_fb), dtype=dtype,
                               device=device),
            log_nugget=torch.as_tensor(np.log(nug_fb * amp_fb), dtype=dtype,
                                       device=device),
            log_ls=torch.as_tensor(
                np.tile(np.log(ls_fb)[:, None],
                        (1, config.num_length_scales)),
                dtype=dtype, device=device),
        )
        X = np.where(dead[:, None], _flatten(_params_to_u(fb, lo, hi)), X)
        F, G = vg(X)
    dead = ~(np.isfinite(F) & np.isfinite(G).all(axis=1))
    if dead.all():
        logger.warning(
            "fit_gp_host: ALL %d restarts are infeasible (non-finite "
            "objective or gradient) after %d rescue windows — the optimizer "
            "cannot take a single step and the returned thetas are the last "
            "fallback, NOT a fit.", R, len(rescue_windows),
        )
    best_X = X.copy()
    best_F = np.where(np.isfinite(F), F, np.inf)
    # per-restart LBFGS memory: (m, R, P) ring buffers + validity counts
    S_h = np.zeros((m_history, R, P))
    Y_h = np.zeros((m_history, R, P))
    RHO = np.zeros((m_history, R))
    hlen = np.zeros(R, dtype=int)  # valid history entries per restart
    active = np.isfinite(F) & np.isfinite(G).all(axis=1)
    step0 = 0

    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        ck = np.load(checkpoint_path)
        if ck["X"].shape != (R, P):
            raise ValueError(
                f"checkpoint {checkpoint_path}: saved shape "
                f"{ck['X'].shape} != expected {(R, P)}"
            )
        # theta shapes are N-independent: also key on the data size
        if "n_data" in ck and int(ck["n_data"]) != data.y.shape[-1]:
            raise ValueError(
                f"checkpoint {checkpoint_path}: saved for "
                f"N={int(ck['n_data'])}, current data has "
                f"N={data.y.shape[-1]} — delete it to start fresh"
            )
        X, F, G = ck["X"], ck["F"], ck["G"]
        S_h, Y_h, RHO = ck["S_h"], ck["Y_h"], ck["RHO"]
        hlen = ck["hlen"]
        active = ck["active"]
        best_X, best_F = ck["best_X"], ck["best_F"]
        step0 = int(ck["step"])

    def save_checkpoint(step):
        tmp = checkpoint_path + ".tmp.npz"
        np.savez(
            tmp.removesuffix(".npz"), X=X, F=F, G=G, S_h=S_h, Y_h=Y_h,
            RHO=RHO, hlen=hlen, active=active, best_X=best_X, best_F=best_F,
            step=step, n_data=data.y.shape[-1],
        )
        os.replace(tmp, checkpoint_path)

    step = step0 - 1
    for step in range(step0, steps):
        active &= np.linalg.norm(G, axis=1) >= gtol
        if not active.any():
            break
        # vectorized two-loop recursion (history loop over m <= 10 on host)
        Q = G.copy()
        alphas = np.zeros((m_history, R))
        for k in range(m_history - 1, -1, -1):
            valid = k < hlen  # (R,)
            a = RHO[k] * np.einsum("rp,rp->r", S_h[k], Q)
            a = np.where(valid, a, 0.0)
            alphas[k] = a
            Q -= a[:, None] * Y_h[k]
        has_hist = hlen > 0
        last = np.maximum(hlen - 1, 0)
        s_last = S_h[last, np.arange(R)]
        y_last = Y_h[last, np.arange(R)]
        gamma = np.einsum("rp,rp->r", s_last, y_last) / np.maximum(
            np.einsum("rp,rp->r", y_last, y_last), 1e-300
        )
        Q *= np.where(has_hist, gamma, 1.0)[:, None]
        for k in range(m_history):
            valid = k < hlen
            b = RHO[k] * np.einsum("rp,rp->r", Y_h[k], Q)
            corr = (alphas[k] - np.where(valid, b, 0.0))[:, None] * S_h[k]
            Q += np.where(valid[:, None], corr, 0.0)
        D = -Q
        GTD = np.einsum("rp,rp->r", G, D)
        # non-descent directions: restart that lane's memory, use -G
        bad = GTD >= 0
        if bad.any():
            D[bad] = -G[bad]
            GTD[bad] = -np.einsum("rp,rp->r", G[bad], G[bad])
            hlen[bad] = 0
        # lock-step Armijo backtracking: one batched eval per round; lanes
        # with no LBFGS history take a gradient-normalized first trial
        t = np.where(
            hlen > 0,
            1.0,
            np.minimum(1.0, 1.0 / np.maximum(np.linalg.norm(D, axis=1), 1e-30)),
        )
        accepted = ~active  # inactive lanes are "done" immediately
        F_new, G_new = F.copy(), G.copy()
        X_cand = X.copy()
        for _bt in range(30):
            trial = np.where(accepted[:, None], X_cand, X + t[:, None] * D)
            if value_linesearch:
                f_t, g_t = v_only(trial), None
            else:
                f_t, g_t = vg(trial)
            ok = np.isfinite(f_t) & (f_t <= F + 1e-4 * t * GTD) & ~accepted
            X_cand = np.where(ok[:, None], trial, X_cand)
            F_new = np.where(ok, f_t, F_new)
            if g_t is not None:
                G_new = np.where(ok[:, None], g_t, G_new)
            accepted |= ok
            t = np.where(accepted, t, t * 0.5)
            if accepted.all():
                break
        if value_linesearch and (accepted & active).any():
            # ONE value+grad at the accepted points; lanes that never
            # accepted keep their old state
            f_full, g_full = vg(X_cand)
            took_ls = accepted & active & np.isfinite(f_full)
            F_new = np.where(took_ls, f_full, F_new)
            G_new = np.where(took_ls[:, None], g_full, G_new)
        # lanes whose linesearch never accepted go inactive
        active &= accepted
        stepped = active
        S = X_cand - X
        Yv = G_new - G
        SY = np.einsum("rp,rp->r", S, Yv)
        keep = stepped & (SY > 1e-10)
        for r in np.nonzero(keep)[0]:  # append to the ring buffers
            if hlen[r] == m_history:
                S_h[:-1, r] = S_h[1:, r]
                Y_h[:-1, r] = Y_h[1:, r]
                RHO[:-1, r] = RHO[1:, r]
                hlen[r] -= 1
            S_h[hlen[r], r] = S[r]
            Y_h[hlen[r], r] = Yv[r]
            RHO[hlen[r], r] = 1.0 / SY[r]
            hlen[r] += 1
        X = np.where(stepped[:, None], X_cand, X)
        F = np.where(stepped, F_new, F)
        G = np.where(stepped[:, None], G_new, G)
        better = stepped & np.isfinite(F) & (F < best_F)
        best_X = np.where(better[:, None], X, best_X)
        best_F = np.where(better, F, best_F)
        if checkpoint_path is not None and (step + 1) % checkpoint_every == 0:
            save_checkpoint(step + 1)

    lls = np.where(np.isfinite(best_F), -best_F, -np.inf)
    best_i = int(np.argmax(lls))
    stacked = _u_to_params(
        _unflatten(torch.as_tensor(best_X, dtype=dtype, device=device)),
        lo, hi)
    stats["n_steps"] = step + 1 - step0
    stats["fit_wall_s"] = time.perf_counter() - t_fit0
    return FitResult(
        params=GPParams(*(a[best_i] for a in stacked)),
        log_likelihood=torch.tensor(lls[best_i], dtype=dtype),
        restart_log_likelihoods=torch.as_tensor(lls, dtype=dtype),
        restart_params=stacked,
        stats=stats,
    )


def _repeat_lanes(t, k: int):
    """(G, ...) -> (G * k, ...): each row k times in a row; None stays."""
    if t is None:
        return None
    return t[:, None].expand(t.shape[0], k, *t.shape[1:]).reshape(
        t.shape[0] * k, *t.shape[1:])


def _fit_lanes(
    u0: torch.Tensor,
    X: torch.Tensor,
    Y: torch.Tensor,
    config: GPConfig,
    steps: int,
    noise: torch.Tensor | None = None,
    group_chunk: int | None = None,
    restart_chunk: int | None = None,
    stats: dict | None = None,
    dY: torch.Tensor | None = None,
    dY_noise: torch.Tensor | None = None,
    h_extra: torch.Tensor | None = None,
) -> FitResult:
    """L-BFGS over G x R lanes from unconstrained starts u0 (G, R, P): lane
    (g, r) fits targets Y[g] (noise[g], gradients dY[g] and their variances
    dY_noise[g], extra GLS columns h_extra[g] (N, q), each optional) on
    design X, the (N, d) one shared
    by every lane or X[g] of (G, N, d). The lanes run as one lock-step
    `fit_one_start` batch, or in sequential blocks of group_chunk groups x
    restart_chunk restarts (the same result, less memory). The argmax over
    restarts skips non-finite LMLs. Every FitResult field carries G in
    front: params (G, ...), log_likelihood (G,), restart_log_likelihoods
    (G, R) (-inf where not finite), restart_params (G, R, ...)."""
    G, R, P = u0.shape
    dtype, dev = Y.dtype, X.device
    stats = _new_stats() if stats is None else stats
    gc = G if group_chunk is None else group_chunk
    rc = R if restart_chunk is None else restart_chunk
    best_u = torch.empty_like(u0)
    best_negll = torch.empty((G, R), dtype=dtype, device=dev)
    for g0 in range(0, G, gc):
        g = slice(g0, g0 + gc)
        for r0 in range(0, R, rc):
            r = slice(r0, r0 + rc)
            ub = u0[g, r]
            k = ub.shape[1]
            bu, bv = fit_one_start(
                _unflatten(ub.reshape(-1, P)),
                X if X.dim() == 2 else _repeat_lanes(X[g], k),
                _repeat_lanes(Y[g], k), config, steps,
                noise=None if noise is None else _repeat_lanes(noise[g], k),
                stats=stats,
                dY=None if dY is None else _repeat_lanes(dY[g], k),
                dY_noise=(None if dY_noise is None
                          else _repeat_lanes(dY_noise[g], k)),
                h_extra=(None if h_extra is None
                         else _repeat_lanes(h_extra[g], k)))
            best_u[g, r] = _flatten_t(bu).reshape(ub.shape)
            best_negll[g, r] = bv.reshape(ub.shape[:2])
    lo, hi = _bounds_arrays(config, dtype, dev)
    params_all = GPParams(*(a.reshape((G, R) + a.shape[1:]) for a in
                            _u_to_params(_unflatten(best_u.reshape(-1, P)),
                                         lo, hi)))
    lls = torch.where(torch.isfinite(best_negll), -best_negll, -torch.inf)
    i = torch.argmax(lls, dim=-1)
    rows = torch.arange(G, device=dev)
    return FitResult(
        params=GPParams(*(a[rows, i] for a in params_all)),
        log_likelihood=lls[rows, i],
        restart_log_likelihoods=lls,
        restart_params=params_all,
        stats=stats,
    )


def _fit_components(
    generator: torch.Generator,
    X: torch.Tensor,
    Y: torch.Tensor,
    config: GPConfig,
    n_restarts: int | None = None,
    max_steps: int | None = None,
    restart_chunk: int | None = None,
    noise: torch.Tensor | None = None,
    dY: torch.Tensor | None = None,
    dY_noise: torch.Tensor | None = None,
    h_extra: torch.Tensor | None = None,
) -> FitResult:
    """`fit_gp` for r GPs on one design at once: Y (r, N) holds each
    component's targets (noise, if given, (r, N) its noise variances; dY
    and dY_noise, if given, (r, N, d) its gradient blocks; h_extra, if
    given, (r, N, q) its extra GLS columns). The
    (r x R) lanes run as one lock-step batch, or in groups of restart_chunk
    restarts of every component (`_fit_lanes`)."""
    R = config.n_restarts if n_restarts is None else n_restarts
    steps = config.max_opt_steps if max_steps is None else max_steps
    r = Y.shape[0]
    dtype = Y.dtype
    dev = X.device
    lo, hi = _bounds_arrays(config, dtype, dev)
    t0 = time.perf_counter()
    stats = _new_stats()
    # one draw per component, in component order
    u0 = torch.stack([
        _flatten_t(sample_restarts(generator, config, R, dtype=dtype))
        for _ in range(r)
    ]).to(device=dev, dtype=dtype)  # (r, R, P)
    P = u0.shape[-1]

    # Rescue dead draws (JAX fit.py:637-666): in float32 a smooth-kernel
    # Gram is only factorable in part of theta space, and a start at -inf
    # has a NaN gradient that kills its trajectory. One batched objective
    # value finds dead starts; they are remapped to stratified
    # moment-matched fallbacks (amp = var(y), short length scales, real
    # nuggets) that factor at working precision.
    _, value = _lane_objective(X, _repeat_lanes(Y, R),
                               _repeat_lanes(noise, R), config, lo, hi, stats,
                               dY=_repeat_lanes(dY, R),
                               dY_noise=_repeat_lanes(dY_noise, R),
                               h_extra=_repeat_lanes(h_extra, R))
    v0 = value(u0.reshape(r * R, P)).reshape(r, R)
    amp_fb = torch.clamp(Y.var(dim=-1, unbiased=False),
                         config.amp_bounds[0] * 10, config.amp_bounds[1] / 10)
    frac = (torch.arange(R, dtype=dtype, device=dev) + 0.5) / R
    ls_fb = torch.exp(math.log(0.05)
                      + frac * (math.log(0.5) - math.log(0.05)))
    nug_fb = torch.exp(math.log(1e-4)
                       + frac * (math.log(1e-1) - math.log(1e-4)))
    k = config.num_length_scales
    fb = GPParams(
        log_amp=torch.log(amp_fb)[:, None].expand(r, R),
        log_nugget=torch.log(nug_fb[None, :] * amp_fb[:, None]),
        log_ls=torch.log(ls_fb)[None, :, None].expand(r, R, k),
    )
    u_fb = _flatten_t(_params_to_u(fb, lo, hi))
    u0 = torch.where(torch.isfinite(v0)[..., None], u0, u_fb)

    if restart_chunk is not None and R % min(restart_chunk, R) != 0:
        raise ValueError(
            f"n_restarts={R} not divisible by restart_chunk={restart_chunk}")
    res = _fit_lanes(u0, X, Y, config, steps, noise=noise,
                     restart_chunk=restart_chunk, stats=stats, dY=dY,
                     dY_noise=dY_noise, h_extra=h_extra)
    stats["n_steps"] = steps
    stats["fit_wall_s"] = time.perf_counter() - t0
    return res


def fit_gp(
    generator: torch.Generator,
    data: GPData,
    config: GPConfig,
    n_restarts: int | None = None,
    max_steps: int | None = None,
    restart_chunk: int | None = None,
) -> FitResult:
    """Estimate hyperparameters: the `estimate_thetas` equivalent.

    Draws n_restarts starts with `sample_restarts(generator, ...)`, rescues
    dead ones (non-finite objective) to moment-matched fallbacks with one
    batched objective value, runs every restart's LBFGS in one lock-step
    batch (`fit_one_start`; restart_chunk runs them in sequential groups of
    that size, bounding peak memory at large N) and keeps the best finite
    log-likelihood. `stats` counts the objective evaluations: each one is a
    single batched likelihood over the group's lanes (one K1 Gram build and
    one K2 factorization at float32 on the card)."""
    res = _fit_components(
        generator, data.X, data.y[None], config, n_restarts=n_restarts,
        max_steps=max_steps, restart_chunk=restart_chunk,
        noise=None if data.noise is None else data.noise[None],
        dY=None if data.dY is None else data.dY[None],
        dY_noise=None if data.dY_noise is None else data.dY_noise[None],
        h_extra=None if data.h_extra is None else data.h_extra[None])
    return FitResult(
        params=GPParams(*(a[0] for a in res.params)),
        log_likelihood=res.log_likelihood[0],
        restart_log_likelihoods=res.restart_log_likelihoods[0],
        restart_params=GPParams(*(a[0] for a in res.restart_params)),
        stats=res.stats,
    )


class AlphaFitResult(NamedTuple):
    """Result of the power-exponent profile search (fit_gp_alpha)."""

    result: FitResult  # the winning alpha's full fit
    alpha: float  # the winning exponent
    alphas: Tuple[float, ...]  # every exponent evaluated (grid + refinement)
    alpha_log_likelihoods: Tuple[float, ...]  # best LML per evaluated alpha


# Valid exponent range for the power-exponential kernel: alpha in (0, 2];
# below ~0.1 the Gram is numerically diagonal and the profile flat.
_ALPHA_MIN, _ALPHA_MAX = 0.1, 2.0


def _golden_refine_alpha(eval_fn, evals: dict, best_alpha: float, iters: int):
    """Golden-section search MAXIMIZING eval_fn over the bracket formed by
    the winning grid point's neighbours (the profile LML is locally
    unimodal around a grid winner). Each probe is one full multi-restart
    fit; results land in `evals` (alpha -> best LML). Returns the best
    alpha after refinement."""
    grid = sorted(evals)
    i = grid.index(best_alpha)
    step = grid[1] - grid[0] if len(grid) > 1 else 0.3
    lo = grid[i - 1] if i > 0 else max(_ALPHA_MIN, best_alpha - step)
    step = grid[-1] - grid[-2] if len(grid) > 1 else 0.3
    hi = grid[i + 1] if i + 1 < len(grid) else min(_ALPHA_MAX,
                                                   best_alpha + step)
    if hi - lo < 1e-6:
        return best_alpha
    g = (math.sqrt(5.0) - 1.0) / 2.0

    def probe(a):
        a = round(float(a), 6)
        if a not in evals:
            evals[a] = eval_fn(a)
        return evals[a]

    x1 = hi - g * (hi - lo)
    x2 = lo + g * (hi - lo)
    f1, f2 = probe(x1), probe(x2)
    for _ in range(max(0, iters - 2)):
        if f1 < f2:  # the maximum is in [x1, hi]
            lo, x1, f1 = x1, x2, f2
            x2 = lo + g * (hi - lo)
            f2 = probe(x2)
        else:  # the maximum is in [lo, x2]
            hi, x2, f2 = x2, x1, f1
            x1 = hi - g * (hi - lo)
            f1 = probe(x1)
    finite = {a: v for a, v in evals.items() if math.isfinite(v)}
    return max(finite, key=finite.get) if finite else best_alpha


def _profile_alpha(eval_alpha, alphas, refine_iters: int):
    """The grid over alpha, then golden-section refinement of its winner:
    (best alpha, evals {alpha: best total LML})."""
    evals: dict = {}
    best_alpha, best_ll = None, -math.inf
    for a in alphas:
        a = round(float(a), 6)
        evals[a] = eval_alpha(a)
        if best_alpha is None or (math.isfinite(evals[a])
                                  and evals[a] > best_ll):
            best_alpha, best_ll = a, evals[a]
    if refine_iters > 0 and math.isfinite(best_ll):
        best_alpha = _golden_refine_alpha(eval_alpha, evals, best_alpha,
                                          refine_iters)
    return best_alpha, evals


def generator_copy(generator: torch.Generator) -> torch.Generator:
    """A generator in the same state: each profile point draws the same
    restarts, as the JAX package reuses one PRNG key."""
    g = torch.Generator(device=generator.device)
    g.set_state(generator.get_state())
    return g


def fit_gp_alpha(
    generator: torch.Generator,
    data: GPData,
    config: GPConfig,
    alphas: Tuple[float, ...] = (1.2, 1.5, 1.8, 2.0),
    refine_iters: int = 0,
    **fit_kwargs,
) -> AlphaFitResult:
    """Fit with a trainable power-exponential exponent by profile
    likelihood: one full multi-restart `fit_gp` per grid value (the same
    restarts each time), the best wins; refine_iters > 0 adds that many
    golden-section probes of the continuous profile inside the winner's
    bracket. Power-exponential only. fit_kwargs go to fit_gp."""
    from madaiemulator_tpu_torch.utils.config import CovarianceFamily

    if config.covariance is not CovarianceFamily.POWER_EXPONENTIAL:
        raise ValueError(
            "fit_gp_alpha applies to the power-exponential family only; "
            f"got {config.covariance}"
        )
    results: dict = {}

    def eval_alpha(a: float) -> float:
        cfg_a = dataclasses.replace(config, power_exp_alpha=float(a))
        res = fit_gp(generator_copy(generator), data, cfg_a, **fit_kwargs)
        results[round(float(a), 6)] = res
        return float(res.log_likelihood)

    best_alpha, evals = _profile_alpha(eval_alpha, alphas, refine_iters)
    order = sorted(evals)
    return AlphaFitResult(
        result=results[best_alpha],
        alpha=best_alpha,
        alphas=tuple(order),
        alpha_log_likelihoods=tuple(evals[a] for a in order),
    )
