"""Hyperparameter estimation: multi-restart LBFGS over the exact-gradient LML
(port of madaiemulator_tpu/models/fit.py, host-loop driver).

`fit_gp_host` runs the LBFGS two-loop recursion and the Armijo backtracking
on the host in numpy, vectorized over restarts; only the batched value and
gradient of the likelihood (`models.gp.log_marginal_likelihood`, closed-form
backward) runs in torch, on the device of the data. All restarts step in
lock-step: every device call evaluates the whole restart batch.

Restarts are drawn log-uniform inside the configured theta boxes from an
explicit `torch.Generator` and optimized in an unconstrained u-space mapped
into the boxes by a sigmoid. A restart whose covariance goes non-SPD gets
LML = -inf and a NaN gradient there; per-restart best-so-far tracking keeps
its best finite iterate, and the cross-restart argmax ignores bad
trajectories.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from madaiemulator_tpu_torch.models.gp import GPData, log_marginal_likelihood
from madaiemulator_tpu_torch.ops.kernels import GPParams
from madaiemulator_tpu_torch.utils.config import GPConfig

logger = logging.getLogger(__name__)


class FitResult(NamedTuple):
    params: GPParams  # best-of-restarts hyperparameters (log space)
    log_likelihood: torch.Tensor  # its LML
    restart_log_likelihoods: torch.Tensor  # (R,) per-restart best LML
    restart_params: GPParams  # (R, ...) per-restart best params
    # wall-clock breakdown of the host loop: {n_vg_calls, first_vg_wall_s
    # (kernel build + first run), vg_wall_s (the rest), n_v_calls,
    # v_wall_s, n_steps, fit_wall_s}
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


def _flatten(p: GPParams) -> np.ndarray:
    """(R, ...) GPParams -> (R, P) float64 host matrix, columns
    [log_amp, log_nugget, log_ls...] (the JAX ravel_pytree order)."""
    R = p.log_amp.shape[0]
    return np.concatenate(
        [np.asarray(t.detach().cpu(), dtype=np.float64).reshape(R, -1)
         for t in p], axis=1)


def _unflatten(u: torch.Tensor) -> GPParams:
    """(R, P) tensor -> GPParams with leading axis R."""
    return GPParams(log_amp=u[:, 0], log_nugget=u[:, 1], log_ls=u[:, 2:])


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
