"""In-process model calibration: MCMC over a trained emulator on the device
(port of madaiemulator_tpu/models/calibrate.py).

The likelihood, the proposal mechanics and the emulator's posterior predict
run in one process on one device:

  * each sampler is a host loop over steps (the JAX package's `lax.scan`)
    that reads nothing back inside a step: the chain, the log-posterior and
    the acceptance land in preallocated device tensors, and the only host
    read is the finished chain;
  * walkers are a batch axis: every log-posterior evaluation is one batched
    moments call over the walkers (dense states: one cross covariance over
    every PCA component, K1 at float32 on the card, plus the solves);
  * samplers: the affine-invariant ensemble stretch move (Goodman & Weare
    2010), adaptive random-walk Metropolis, Hamiltonian Monte Carlo with
    gradients by torch autograd through the emulator's predict (K1's cross
    VJP) and a two-phase diagonal mass adaptation, and parallel tempering.

Chains run in the emulator's scaled [0,1]^d coordinates; results come back
in natural parameter space with split-chain R-hat and ESS computed on the
host.

Random draws come from one `torch.Generator` on the chain's device, each
draw site through its own small private helper (`_stretch_uniform`,
`_partner_pick`, `_accept_uniform`, `_rwm_normal`, `_momentum_normal`,
`_step_jitter`, `_pt_jitter_normal`, `_swap_uniform`, `_seed_subset`,
`_seed_pick`, `_seed_normal`, `_extra_normal`). The JAX package draws from
jax.random, so the chains differ between the packages by design; the tests
inject JAX's draws through these helpers.

Every sampler takes a device `mesh` (`parallel.mesh.Mesh`): each step draws
its random numbers for the whole walker batch, as without one, and only
then splits the walkers over the mesh axis (`_shard_walkers`), each shard's
log-posterior evaluated on its device against a replica of the emulator's
serve states made once per distinct device (`make_log_posterior`'s
`on_device`); the values are gathered back on the chain's device, where
the stretch move's partner lookup and the accepts run. So a sharded chain
makes the unsharded chain's draws and moves; it equals that chain as far
as the log-posterior of a shard equals that of the whole batch (to the
rounding of the emulator's solves at another batch width: at float32 one
flipped accept then moves the chain apart).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from madaiemulator_tpu_torch.models.multivariate import (
    _predict_components,
    reconstruct_observables,
)
from madaiemulator_tpu_torch.parallel.mesh import (
    check_mesh,
    gather,
    replicate,
    split,
)
from madaiemulator_tpu_torch.utils.designs import unapply_scaling


def _is_sparse(emu) -> bool:
    from madaiemulator_tpu_torch.models.sparse import is_sparse

    return is_sparse(emu)


def _is_mf(emu) -> bool:
    from madaiemulator_tpu_torch.models.multifidelity import is_multifidelity

    return is_multifidelity(emu)


def _is_mf_mv(emu) -> bool:
    from madaiemulator_tpu_torch.models.multifidelity import (
        MultivariateMultiFidelityEmulator,
    )

    return isinstance(emu, MultivariateMultiFidelityEmulator)


def _design_points(emu) -> torch.Tensor:
    """Scaled in-cube points that locate the emulator: the training design
    (dense, matrix-free), the inducing set (sparse: its serve state keeps
    no training arrays), or the union of the level designs
    (multi-fidelity: the cheap level's coverage is the best seed pool)."""
    if _is_sparse(emu):
        return emu.Z
    if _is_mf_mv(emu):
        return torch.cat([lv.X for lv in emu.levels])
    if _is_mf(emu):
        return torch.cat([lv.data.X for lv in emu.levels])
    return emu.X


def _shard_walkers(log_post, mesh, axis_name=None, axis=0):
    """The walker-batch evaluation of `log_post`: x (..., d) with its
    walker axis at `axis` (0 for (W, d); 1 for parallel tempering's
    (K, W, d)) -> (...). With a mesh, the walkers split into contiguous
    blocks over the devices of its `axis_name` axis (default the first),
    each block evaluated on its device by the log-posterior's replica
    there, the values gathered back on x's device."""
    def flat(lp, x):
        return lp(x) if x.ndim == 2 else lp(
            x.reshape(-1, x.shape[-1])).reshape(x.shape[:-1])

    check_mesh(mesh, "the sampler")
    if mesh is None:
        return lambda x: flat(log_post, x)
    devs = mesh.axis_devices(axis_name or mesh.axis_names[0])
    replicas = {}

    def replica(dev):
        if dev not in replicas:
            on = getattr(log_post, "on_device", None)
            if on is None:
                raise ValueError(
                    "a walker mesh needs a log-posterior from "
                    "make_log_posterior (its serve states are replicated "
                    "on every device of the mesh)")
            replicas[dev] = on(dev)
        return replicas[dev]

    def evaluate(x):
        if all(d == x.device for d in devs):
            lps = [log_post] * len(devs)  # a virtual mesh: no replica
        else:
            lps = [replica(d) for d in devs]
        shards = split(x, len(devs), dim=axis)
        jobs = [(d, lp, xs.to(d)) for d, lp, xs in zip(devs, lps, shards)
                if xs.shape[axis]]
        parts = mesh.map([j[0] for j in jobs],
                         lambda d, lp, xs: flat(lp, xs), *zip(*jobs))
        return gather(parts, x.device, dim=axis)

    return evaluate


class CalibrationResult(NamedTuple):
    """MCMC output in NATURAL parameter space.

    samples: (n_kept, n_walkers, d) post-burn-in, thinned draws
    log_posterior: (n_kept, n_walkers)
    acceptance: the mean acceptance rate over the whole run
    rhat: (d[+1],) split-chain Gelman-Rubin statistic; a sampled
        discrepancy scale's is the last entry
    ess: (d[+1],) effective sample size over all kept draws
    discrepancy: (n_kept, n_walkers) draws of the sampled model-discrepancy
        scale (a fraction of each observable's training std), or None
    """

    samples: np.ndarray
    log_posterior: np.ndarray
    acceptance: float
    rhat: np.ndarray
    ess: np.ndarray
    discrepancy: Optional[np.ndarray] = None

    def summary(self) -> Dict[str, np.ndarray]:
        """Per-coordinate posterior statistics; a sampled discrepancy
        scale's are the LAST entry of every vector (aligned with rhat /
        ess)."""
        flat = self.samples.reshape(-1, self.samples.shape[-1])
        if self.discrepancy is not None:
            flat = np.concatenate(
                [flat, self.discrepancy.reshape(-1, 1)], axis=1)
        return {
            "mean": flat.mean(axis=0),
            "std": flat.std(axis=0),
            "q05": np.quantile(flat, 0.05, axis=0),
            "q50": np.quantile(flat, 0.50, axis=0),
            "q95": np.quantile(flat, 0.95, axis=0),
            "rhat": self.rhat,
            "ess": self.ess,
            "acceptance": np.asarray(self.acceptance),
        }


# ---------------------------------------------------------------------------
# Log-posterior factory
# ---------------------------------------------------------------------------


def _moments_fn(emu, states, variance_method: str, query_chunk: int,
                row_chunk: int):
    """xq (W, d) scaled -> the emulator's observable-space (mean, var),
    (W, t) each, at its highest fidelity."""
    if _is_mf_mv(emu):
        from madaiemulator_tpu_torch.models.multifidelity import (
            _predict_recursive_mv,
        )

        def moments(xq):
            m_pc, v_pc = _predict_recursive_mv(emu.levels, xq, emu.config)
            return reconstruct_observables(m_pc, v_pc, emu.pca)

    elif _is_mf(emu):
        from madaiemulator_tpu_torch.models.multifidelity import (
            _predict_recursive,
        )

        def moments(xq):
            m, v = _predict_recursive(emu.levels, xq, emu.config)
            return m[:, None], v[:, None]

    elif _is_sparse(emu):
        from madaiemulator_tpu_torch.models.sparse import predict_sgpr

        def moments(xq):
            # one predict batched over the components: O(W m) a walker
            m_pc, v_pc = predict_sgpr(emu.states, emu.params, emu.config, xq)
            return reconstruct_observables(m_pc, v_pc, emu.pca)

    elif getattr(emu, "states", None) is not None:

        def moments(xq):
            m_pc, v_pc = _predict_components(
                emu.states, emu.params, emu.X, emu.Z, xq, emu.config,
                dZ=emu.dZ)
            return reconstruct_observables(m_pc, v_pc, emu.pca)

    else:
        if states is None:
            raise ValueError(
                "matrix-free calibration needs the serving cache: pass "
                "states=precompute_iterative_multivariate(emu, ...)")
        from madaiemulator_tpu_torch.models.iterative import (
            predict_iterative_from_state,
        )

        def moments(xq):
            ms, vs = [], []
            for i in range(emu.n_components):
                m_i, v_i = predict_iterative_from_state(
                    states[i], emu.component_data(i), xq,
                    query_chunk=query_chunk, variance_method=variance_method,
                    row_chunk=row_chunk)
                ms.append(m_i)
                vs.append(v_i)
            return reconstruct_observables(torch.stack(ms), torch.stack(vs),
                                           emu.pca)
    return moments


def make_log_posterior(
    emu,
    y_exp,
    exp_cov,
    log_prior: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    discrepancy: bool = False,
    discrepancy_prior: Optional[Callable[[torch.Tensor],
                                         torch.Tensor]] = None,
    states=None,
    variance_method: str = "precond",
    query_chunk: int = 4096,
    row_chunk: int = 2048,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Batched log-posterior over SCALED coordinates: (W, d[+1]) -> (W,).

    The Gaussian measurement model marginalized over the emulator's own
    predictive uncertainty,

        y_exp | theta ~ N( m(theta),  diag(v(theta)) + Sigma_exp [+ D(s)] ),

    (m, v) the emulator's observable-space posterior mean and variance at
    its highest fidelity. `exp_cov` is a (t,) vector of experimental
    variances (the likelihood is then an elementwise reduction) or a full
    (t, t) covariance (a batched t x t Cholesky over the walkers).

    `discrepancy=True` samples a model-discrepancy scale jointly with
    theta: the walker state gains a trailing coordinate s = log(sigma), and
    D(s) = exp(2 s) diag(ystd^2) adds a discrepancy of sigma training
    standard deviations on every observable; `discrepancy_prior` is its
    log-density (default Normal(log 0.05, 1.5)). The box [0,1]^d is
    enforced on theta (-inf outside; the query is clipped so the math
    stays finite and autograd puts no NaN into any in-box walker's
    gradient); `log_prior` adds a log-density on NATURAL theta.

    Matrix-free emulators (IterativeMultivariateEmulator) need `states`
    (precompute_iterative_multivariate): each evaluation is then the cached
    state's GEMMs with the preconditioner's Woodbury variance
    (variance_method="precond", PCG-free, a lower bound when the ridge is
    the plain diagonal) or a PCG solve ("exact"). query_chunk and
    row_chunk bound that path's footprint. Every branch but the
    matrix-free "exact" one is differentiable by torch autograd (HMC).
    """
    pts = _design_points(emu)
    dtype, dev = pts.dtype, pts.device
    y_exp = torch.as_tensor(y_exp).to(device=dev, dtype=dtype)
    exp_cov = torch.as_tensor(exp_cov).to(device=dev, dtype=dtype)
    t = y_exp.shape[0]
    if exp_cov.ndim not in (1, 2):
        raise ValueError("exp_cov must be (t,) variances or (t, t) covariance")
    if exp_cov.shape[0] != t or (exp_cov.ndim == 2 and exp_cov.shape[1] != t):
        raise ValueError(
            f"exp_cov shape {tuple(exp_cov.shape)} mismatches y_exp ({t},)")
    log2pi = float(np.log(2.0 * np.pi))
    d_theta = pts.shape[1]
    if _is_mf_mv(emu):
        if t != emu.n_outputs:
            raise ValueError(
                f"y_exp has {t} observables but this multivariate "
                f"multi-fidelity emulator predicts {emu.n_outputs}")
        ystd2 = emu.pca.ystd.to(dtype) ** 2
    elif _is_mf(emu):
        # a scalar MF emulator stores raw-unit targets: the top level's
        # spread stands in for pca.ystd
        if t != 1:
            raise ValueError(
                f"y_exp has {t} observables but a scalar multi-fidelity "
                "emulator predicts exactly 1 output — broadcasting the same "
                "prediction against every observable would produce a "
                "silently wrong posterior")
        ystd2 = torch.std(emu.levels[-1].data.y, unbiased=False).reshape(1) ** 2
    else:
        ystd2 = emu.pca.ystd.to(dtype) ** 2
    moments = _moments_fn(emu, states, variance_method, query_chunk,
                          row_chunk)
    if discrepancy_prior is None:
        _loc, _scale = float(np.log(0.05)), 1.5

        def discrepancy_prior(s):
            return -0.5 * ((s - _loc) / _scale) ** 2

    tiny = torch.finfo(dtype).tiny

    def log_post(theta_scaled: torch.Tensor) -> torch.Tensor:
        x_full = theta_scaled if theta_scaled.ndim > 1 else theta_scaled[None]
        x = x_full[:, :d_theta]
        inbox = ((x >= 0.0) & (x <= 1.0)).all(dim=-1)  # (W,)
        # the query is clipped into the box (finite math everywhere) and
        # the result gated with -inf below
        xq = torch.clamp(x, 0.0, 1.0)
        mean, var = moments(xq)  # (W, t)
        if discrepancy:
            s = x_full[:, d_theta]
            var = var + torch.exp(2.0 * s)[:, None] * ystd2[None, :]
        resid = mean - y_exp[None, :]
        if exp_cov.ndim == 1:
            tot = torch.clamp(var + exp_cov[None, :], min=tiny)
            ll = -0.5 * (resid * resid / tot + torch.log(tot)
                         + log2pi).sum(-1)
        else:
            # C_w = diag(var_w) + Sigma_exp, a batched Cholesky over walkers
            C = exp_cov[None, :, :] + torch.diag_embed(var)
            L, info = torch.linalg.cholesky_ex(C)
            sol = torch.linalg.solve_triangular(
                L, resid[..., None], upper=False)[..., 0]
            logdet = 2.0 * torch.log(
                torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
            ll = -0.5 * ((sol * sol).sum(-1) + logdet + t * log2pi)
            # a failed factor is NaN, as the JAX package's
            ll = torch.where(info == 0, ll, torch.nan)
        if log_prior is not None:
            ll = ll + log_prior(unapply_scaling(xq, emu.scaling))
        if discrepancy:
            ll = ll + discrepancy_prior(x_full[:, d_theta])
        out = torch.where(inbox, ll, -torch.inf)
        return out if theta_scaled.ndim > 1 else out[0]

    replicas = {}

    def on_device(device):
        """This log-posterior with the emulator's serve states (and
        `states`) copied to `device`, made once a device: what a walker
        mesh evaluates its shards with."""
        device = torch.device(device)
        if device == dev:
            return log_post
        if device not in replicas:
            replicas[device] = make_log_posterior(
                replicate(emu, device), y_exp, exp_cov, log_prior=log_prior,
                discrepancy=discrepancy,
                discrepancy_prior=discrepancy_prior,
                states=replicate(states, device),
                variance_method=variance_method, query_chunk=query_chunk,
                row_chunk=row_chunk)
        return replicas[device]

    log_post.on_device = on_device
    return log_post


# ---------------------------------------------------------------------------
# Draw sites (each a helper of its own: the tests inject JAX's draws here)
# ---------------------------------------------------------------------------


def _rand(generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=like.device)


def _randn(generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def _stretch_uniform(generator, shape, like):
    """U[0, 1) for the stretch factor z of each mover."""
    return _rand(generator, shape, like)


def _partner_pick(generator, high: int, shape, device):
    """Each mover's partner index in the other half, in [0, high)."""
    return torch.randint(0, high, shape, generator=generator, device=device)


def _accept_uniform(generator, shape, like):
    """U[tiny, 1) of a Metropolis accept (its log is finite)."""
    return torch.clamp(_rand(generator, shape, like),
                       min=torch.finfo(like.dtype).tiny)


def _swap_uniform(generator, shape, like):
    """U[tiny, 1) of a replica-exchange accept."""
    return torch.clamp(_rand(generator, shape, like),
                       min=torch.finfo(like.dtype).tiny)


def _rwm_normal(generator, shape, like):
    """The random-walk proposal's standard normals."""
    return _randn(generator, shape, like)


def _momentum_normal(generator, shape, like):
    """HMC's momentum draw (standard normals, scaled by the mass)."""
    return _randn(generator, shape, like)


def _step_jitter(generator, like):
    """HMC's step-size jitter, U[0.8, 1.2), one for the step."""
    return 0.8 + 0.4 * _rand(generator, (), like)


def _pt_jitter_normal(generator, shape, like):
    """The hotter rungs' start offsets."""
    return _randn(generator, shape, like)


def _seed_subset(generator, n: int, k: int, device):
    """k distinct design indices of n (the scored seed pool)."""
    return torch.randperm(n, generator=generator, device=device)[:k]


def _seed_pick(generator, k: int, shape, device):
    """Each walker's seed: a position in the top-k list, with
    replacement."""
    return torch.randint(0, k, shape, generator=generator, device=device)


def _seed_normal(generator, shape, like):
    """The walker starts' jitter."""
    return _randn(generator, shape, like)


def _extra_normal(generator, shape, like):
    """The trailing (discrepancy) coordinates' start jitter."""
    return _randn(generator, shape, like)


# ---------------------------------------------------------------------------
# Samplers (host loops over steps; nothing is read back inside a step)
# ---------------------------------------------------------------------------


def _accept_step(generator, x, lp, x_prop, lp_prop, log_extra=0.0):
    """Metropolis accept: (x', lp', accepted mask)."""
    log_u = torch.log(_accept_uniform(generator, lp.shape, lp))
    ratio = lp_prop - lp + log_extra
    # lp is -inf only before any in-support state is found: a finite
    # proposal against it is an automatic accept
    ratio = torch.where(torch.isneginf(lp) & torch.isfinite(lp_prop),
                        torch.inf, ratio)
    acc = log_u < ratio
    return (torch.where(acc[..., None], x_prop, x),
            torch.where(acc, lp_prop, lp), acc)


def _chain_buffers(n_steps: int, like: torch.Tensor):
    """Preallocated (chain, logp, acceptance) of a run on like's device."""
    w, d = like.shape[-2:]
    kw = dict(dtype=like.dtype, device=like.device)
    return (torch.empty((n_steps, w, d), **kw), torch.empty((n_steps, w), **kw),
            torch.empty((n_steps,), **kw))


def _stretch_half(generator, log_post, movers, movers_lp, others, a: float):
    """Goodman-Weare stretch move of one half against the other."""
    half, d = movers.shape
    u = _stretch_uniform(generator, (half,), movers)
    z = (u * (a - 1.0) + 1.0) ** 2 / a  # g(z) ~ 1/sqrt(z) on [1/a, a]
    pick = _partner_pick(generator, half, (half,), movers.device)
    partners = others[pick]
    prop = partners + z[:, None] * (movers - partners)
    lp_prop = log_post(prop)
    return _accept_step(generator, movers, movers_lp, prop, lp_prop,
                        log_extra=(d - 1) * torch.log(z))


@torch.no_grad()
def run_emcee(
    generator: torch.Generator,
    log_post: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    n_steps: int,
    a: float = 2.0,
    mesh=None,
    axis_name: Optional[str] = None,
):
    """Affine-invariant ensemble sampler: (chain (n_steps, W, d), logp
    (n_steps, W), acceptance ()), in x0's coordinates (scaled space for
    emulator posteriors). W must be even and >= 2 d + 2. Each step is two
    batched log-posterior evaluations, one a half-move. `mesh` splits
    each evaluation's walkers over the devices of its `axis_name` axis
    (`_shard_walkers`), with the unsharded chain's draws (see the module
    docstring)."""
    log_post = _shard_walkers(log_post, mesh, axis_name)
    w, d = x0.shape
    if w % 2 or w < 4:
        raise ValueError(f"n_walkers must be even and >= 4, got {w}")
    if w < 2 * d + 2:
        raise ValueError(f"n_walkers={w} too few for d={d}: need >= "
                         f"{2 * d + 2}")
    half = w // 2
    xs, lps, accs = _chain_buffers(n_steps, x0)
    x, lp = x0, log_post(x0)
    for i in range(n_steps):
        xA, lpA, accA = _stretch_half(generator, log_post, x[:half],
                                      lp[:half], x[half:], a)
        xB, lpB, accB = _stretch_half(generator, log_post, x[half:],
                                      lp[half:], xA, a)
        x = torch.cat([xA, xB])
        lp = torch.cat([lpA, lpB])
        xs[i], lps[i] = x, lp
        accs[i] = torch.cat([accA, accB]).to(x.dtype).mean()
    return xs, lps, accs.mean()


def _robbins_monro(log_s, i: int, n_adapt: int, acc, target: float):
    """The log step size moved toward the target acceptance rate during
    the first n_adapt steps, frozen after (the kept chain stays
    Markovian)."""
    if i >= n_adapt:
        return log_s
    gamma = (i + 1.0) ** -0.6
    return log_s + gamma * (acc.to(log_s.dtype).mean() - target)


@torch.no_grad()
def run_rwm(
    generator: torch.Generator,
    log_post: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    n_steps: int,
    step_size: float = 0.05,
    n_adapt: Optional[int] = None,
    target_acceptance: float = 0.234,
    mesh=None,
    axis_name: Optional[str] = None,
):
    """Adaptive random-walk Metropolis: (chain, logp, acceptance,
    final_step). Walkers are independent chains sharing one proposal
    scale, adapted from their pooled acceptance during the first n_adapt
    steps (default half the run; `calibrate` passes its burn_in). `mesh`
    shards the walkers as in `run_emcee`."""
    log_post = _shard_walkers(log_post, mesh, axis_name)
    if n_adapt is None:
        n_adapt = n_steps // 2
    xs, lps, accs = _chain_buffers(n_steps, x0)
    x, lp = x0, log_post(x0)
    log_s = torch.log(torch.as_tensor(step_size, dtype=x0.dtype,
                                      device=x0.device))
    for i in range(n_steps):
        prop = x + torch.exp(log_s) * _rwm_normal(generator, x.shape, x)
        x, lp, acc = _accept_step(generator, x, lp, prop, log_post(prop))
        log_s = _robbins_monro(log_s, i, n_adapt, acc, target_acceptance)
        xs[i], lps[i] = x, lp
        accs[i] = acc.to(x.dtype).mean()
    return xs, lps, accs.mean(), torch.exp(log_s)


def _lp_and_grad(log_post, x: torch.Tensor):
    """Per-walker log posterior (W,) and its gradient (W, d): one forward
    and one backward of the summed log posterior (walkers are independent,
    so each row gets its own gradient). Non-finite gradient entries (only
    at -inf states) are zeroed: Metropolis rejects those states, and the
    leapfrog must never carry a NaN."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        lp = log_post(xg)
        if not lp.requires_grad:
            raise ValueError(
                "HMC needs a log-posterior differentiable in theta: a "
                "matrix-free emulator's \"exact\" variance (PCG) is not; "
                "use variance_method=\"precond\"")
        (g,) = torch.autograd.grad(lp.sum(), xg)
    return lp.detach(), torch.where(torch.isfinite(g), g, 0.0)


@torch.no_grad()
def run_hmc(
    generator: torch.Generator,
    log_post: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    n_steps: int,
    step_size: float = 0.1,
    n_leapfrog: int = 8,
    n_adapt: Optional[int] = None,
    target_acceptance: float = 0.75,
    mesh=None,
    axis_name: Optional[str] = None,
    adapt_mass: bool = True,
    return_mass: bool = False,
):
    """Hamiltonian Monte Carlo: (chain, logp, acceptance, final_step), plus
    the adapted diagonal inverse mass when return_mass=True.

    Each step costs n_leapfrog batched log-posterior + gradient
    evaluations (torch autograd through the emulator's predict). Mass
    adaptation (adapt_mass=True) is Stan's two-phase warmup: the first
    half of the adaptation window runs identity mass while it accumulates
    the walkers' moments; at its end the diagonal inverse mass freezes to
    the variance estimate (geometric mean 1, floored) and the second half
    re-tunes the step size for it. The step size adapts by Robbins-Monro
    toward target_acceptance during the first n_adapt steps (default half
    the run), jittered +-20% each step. `mesh` shards the walkers as in
    `run_emcee` (the gradients flow back through the shards)."""
    log_post = _shard_walkers(log_post, mesh, axis_name)
    if n_adapt is None:
        n_adapt = n_steps // 2
    if n_leapfrog < 1:
        raise ValueError(f"n_leapfrog must be >= 1, got {n_leapfrog}")
    w, d = x0.shape
    dtype, dev = x0.dtype, x0.device
    n_half = n_adapt // 2 if adapt_mass else n_steps + 1
    xs, lps, accs = _chain_buffers(n_steps, x0)
    x, (lp, g) = x0, _lp_and_grad(log_post, x0)
    log_s = torch.log(torch.as_tensor(step_size, dtype=dtype, device=dev))
    s1 = torch.zeros((d,), dtype=dtype, device=dev)
    s2 = torch.zeros((d,), dtype=dtype, device=dev)
    cnt = 0.0
    inv_mass = torch.ones((d,), dtype=dtype, device=dev)
    for i in range(n_steps):
        # momentum p ~ N(0, M): std 1 / sqrt(inv_mass)
        p = _momentum_normal(generator, x.shape, x) / torch.sqrt(inv_mass)
        eps = torch.exp(log_s) * _step_jitter(generator, x)
        # n_leapfrog velocity-Verlet steps, one lp + grad each
        xn, pn = x, p + 0.5 * eps * g
        for j in range(n_leapfrog):
            xn = xn + eps * inv_mass * pn
            lpn, gn = _lp_and_grad(log_post, xn)
            pn = pn + (0.5 if j == n_leapfrog - 1 else 1.0) * eps * gn
        ke = 0.5 * (p * p * inv_mass).sum(-1)
        ken = 0.5 * (pn * pn * inv_mass).sum(-1)
        x, lp, acc = _accept_step(generator, x, lp, xn, lpn,
                                  log_extra=ke - ken)
        g = torch.where(acc[:, None], gn, g)
        log_s = _robbins_monro(log_s, i, n_adapt, acc, target_acceptance)
        if i < n_half:
            s1 = s1 + x.sum(0)
            s2 = s2 + (x * x).sum(0)
            cnt += w
        if i == n_half - 1:
            mu = s1 / max(cnt, 1.0)
            var = torch.clamp(s2 / max(cnt, 1.0) - mu * mu, min=1e-10)
            inv_mass = var / torch.exp(torch.log(var).mean())
        xs[i], lps[i] = x, lp
        accs[i] = acc.to(dtype).mean()
    out = (xs, lps, accs.mean(), torch.exp(log_s))
    return out + (inv_mass,) if return_mass else out


def _pt_stretch_half(generator, log_post, movers, movers_lp, others, betas,
                     a: float):
    """Tempered stretch move of one half of every rung, one evaluation over
    the rungs: movers / others (K, half, d), movers_lp (K, half); log_post
    is the walker evaluation of `_shard_walkers` ((K, half, d) -> (K,
    half))."""
    k_rungs, half, d = movers.shape
    u = _stretch_uniform(generator, (k_rungs, half), movers)
    z = (u * (a - 1.0) + 1.0) ** 2 / a
    pick = _partner_pick(generator, half, (k_rungs, half), movers.device)
    partners = torch.gather(others, 1, pick[..., None].expand(-1, -1, d))
    prop = partners + z[..., None] * (movers - partners)
    lp_prop = log_post(prop)
    log_u = torch.log(_accept_uniform(generator, (k_rungs, half), lp_prop))
    ratio = (d - 1) * torch.log(z) + betas[:, None] * (lp_prop - movers_lp)
    ratio = torch.where(torch.isneginf(movers_lp) & torch.isfinite(lp_prop),
                        torch.inf, ratio)
    acc = log_u < ratio
    return (torch.where(acc[..., None], prop, movers),
            torch.where(acc, lp_prop, movers_lp), acc)


@torch.no_grad()
def run_parallel_tempering(
    generator: torch.Generator,
    log_post: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    n_steps: int,
    n_rungs: int = 6,
    beta_min: float = 0.05,
    a: float = 2.0,
    init_spread: float = 0.1,
    mesh=None,
    axis_name: Optional[str] = None,
):
    """Replica-exchange ensemble sampler for multimodal posteriors:
    n_rungs tempered copies of the ensemble (beta geometric from 1 to
    beta_min) run the stretch move on beta_k log_post, and adjacent rungs
    exchange walkers Metropolis-style each step, even and odd pairs in
    turn. x0 is the (W, d) cold start; the hotter rungs start at x0 plus
    Gaussian jitter of scale init_spread. Returns (cold chain (n_steps, W,
    d), cold logp, cold in-rung acceptance, swap acceptance); each step
    is two batched evaluations over all K W walkers. `mesh` shards the
    walker axis (axis 1 of the (K, W, d) rungs) as in `run_emcee`."""
    log_post = _shard_walkers(log_post, mesh, axis_name, axis=1)
    w, d = x0.shape
    if w % 2 or w < max(4, 2 * d + 2):
        raise ValueError(
            f"n_walkers={w} must be even and >= {max(4, 2 * d + 2)}")
    if n_rungs < 2:
        raise ValueError("n_rungs must be >= 2 (use run_emcee for 1)")
    dtype, dev = x0.dtype, x0.device
    betas = torch.as_tensor(np.geomspace(1.0, beta_min, n_rungs),
                            dtype=dtype, device=dev)
    jit0 = _pt_jitter_normal(generator, (n_rungs - 1, w, d), x0) * init_spread
    x = torch.cat([x0[None], x0[None] + jit0])  # (K, W, d)
    half = w // 2
    lp = log_post(x)  # (K, W), untempered
    xs, lps, accs = _chain_buffers(n_steps, x0)
    swaps = torch.empty((n_steps,), dtype=dtype, device=dev)
    delta_beta = (betas[:-1] - betas[1:])[:, None]  # (K-1, 1)
    rung = torch.arange(n_rungs - 1, device=dev)
    for i in range(n_steps):
        xA, lpA, accA = _pt_stretch_half(generator, log_post, x[:, :half],
                                         lp[:, :half], x[:, half:], betas, a)
        xB, lpB, accB = _pt_stretch_half(generator, log_post, x[:, half:],
                                         lp[:, half:], xA, betas, a)
        x = torch.cat([xA, xB], dim=1)
        lp = torch.cat([lpA, lpB], dim=1)
        acc0 = torch.cat([accA[0], accB[0]])
        # replica exchange between adjacent rungs, walker by walker
        swap_ratio = delta_beta * (lp[1:] - lp[:-1])  # (K-1, W)
        # -inf - -inf = NaN: never swap two out-of-support walkers
        swap_ratio = torch.where(torch.isnan(swap_ratio), -torch.inf,
                                 swap_ratio)
        log_u = torch.log(_swap_uniform(generator, swap_ratio.shape, lp))
        pair_on = (rung % 2) == (i % 2)  # (K-1,)
        do_swap = (log_u < swap_ratio) & pair_on[:, None]
        # rung k trades with k+1 where do_swap[k]
        no = torch.zeros((1, w), dtype=torch.bool, device=dev)
        up = torch.cat([do_swap, no])[..., None]
        dn = torch.cat([no, do_swap])[..., None]
        x = torch.where(up, torch.roll(x, -1, 0),
                        torch.where(dn, torch.roll(x, 1, 0), x))
        lp = torch.where(up[..., 0], torch.roll(lp, -1, 0),
                         torch.where(dn[..., 0], torch.roll(lp, 1, 0), lp))
        xs[i], lps[i] = x[0], lp[0]
        accs[i] = acc0.to(dtype).mean()
        n_pairs = max(int((np.arange(n_rungs - 1) % 2 == i % 2).sum()) * w,
                      1)
        swaps[i] = do_swap.to(dtype).sum() / n_pairs
    return xs, lps, accs.mean(), swaps.mean()


# ---------------------------------------------------------------------------
# Convergence diagnostics (host, numpy)
# ---------------------------------------------------------------------------


def gelman_rubin(chains: np.ndarray) -> np.ndarray:
    """Split-chain R-hat per dimension. chains: (S, W, d) -> (d,)."""
    c = np.asarray(chains, dtype=np.float64)
    s, w, d = c.shape
    half = s // 2
    if half < 2:
        return np.full(d, np.nan)
    # each walker's chain split in two -> 2W chains of length half
    c = np.concatenate([c[:half], c[half:2 * half]], axis=1)
    n = half
    chain_mean = c.mean(axis=0)
    chain_var = c.var(axis=0, ddof=1)
    W_ = chain_var.mean(axis=0)
    B = n * chain_mean.var(axis=0, ddof=1)
    var_hat = (n - 1) / n * W_ + B / n
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_hat / np.maximum(W_, np.finfo(np.float64).tiny))


def effective_sample_size(chains: np.ndarray) -> np.ndarray:
    """ESS per dimension by Geyer's initial-monotone-sequence estimator on
    the walker-averaged autocorrelation. chains: (S, W, d) -> (d,)."""
    c = np.asarray(chains, dtype=np.float64)
    s, w, d = c.shape
    if s < 4:
        return np.full(d, float(s * w))
    c = c - c.mean(axis=0, keepdims=True)
    # FFT autocovariance per (walker, dim), averaged over walkers
    nfft = 1 << (2 * s - 1).bit_length()
    f = np.fft.rfft(c, n=nfft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=0)[:s].real
    acov /= np.arange(s, 0, -1)[:, None, None]
    rho = acov.mean(axis=1)  # (S, d)
    rho = rho / np.maximum(rho[0], np.finfo(np.float64).tiny)
    ess = np.empty(d)
    for j in range(d):
        # adjacent pairs summed until one goes non-positive (Geyer); if
        # none does, the whole window counts (a slowly mixing chain must
        # not get its tail cut, or ESS is overreported exactly then)
        pair = rho[:(s // 2) * 2, j].reshape(-1, 2).sum(axis=1)
        tau = -1.0 + 2.0 * np.cumsum(np.maximum(pair, 0.0))
        stop = np.argmax(pair <= 0.0) if np.any(pair <= 0.0) else pair.size
        tau_f = max(tau[stop - 1], 1e-12) if stop > 0 else max(tau[0], 1.0)
        ess[j] = s * w / max(tau_f, 1.0)
    return np.minimum(ess, float(s * w))


# ---------------------------------------------------------------------------
# End-to-end driver
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_walkers(
    generator: torch.Generator,
    emu,
    log_post: Callable[[torch.Tensor], torch.Tensor],
    n_walkers: int,
    n_best: int = 8,
    jitter: float = 0.02,
    extra0=None,
) -> torch.Tensor:
    """Walker starts in scaled space, clustered on the design points of
    highest posterior (the only prior knowledge of where the mass lives;
    every start inside the box). At most 2,048 design points are scored
    (a random subset beyond that). extra0 appends unconstrained trailing
    coordinates (the discrepancy log-scale) at the given values plus
    jitter."""
    design = _design_points(emu)
    N, d = design.shape
    score_cap = 2048
    if N > score_cap:
        X_seed = design[_seed_subset(generator, N, score_cap, design.device)]
    else:
        X_seed = design
    X_score = X_seed
    if extra0 is not None:
        extra0 = torch.as_tensor(extra0, dtype=design.dtype,
                                 device=design.device).reshape(-1)  # (e,)
        X_score = torch.cat(
            [X_seed, extra0.expand(X_seed.shape[0], extra0.shape[0])], dim=1)
    lp_design = log_post(X_score)
    k = min(n_best, X_seed.shape[0])
    top = torch.topk(lp_design, k).indices
    pick = top[_seed_pick(generator, k, (n_walkers,), design.device)]
    x0 = X_seed[pick] + jitter * _seed_normal(generator, (n_walkers, d),
                                              design)
    x0 = torch.clamp(x0, 1e-6, 1.0 - 1e-6)
    if extra0 is not None:
        ex = extra0[None, :] + 0.3 * _extra_normal(
            generator, (n_walkers, extra0.shape[0]), design)
        x0 = torch.cat([x0, ex], dim=1)
    return x0


def calibrate(
    generator: torch.Generator,
    emu,
    y_exp,
    exp_cov,
    n_walkers: int = 64,
    n_steps: int = 1000,
    burn_in: Optional[int] = None,
    thin: int = 1,
    sampler: str = "emcee",
    log_prior: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    discrepancy: bool = False,
    discrepancy_prior: Optional[Callable[[torch.Tensor],
                                         torch.Tensor]] = None,
    states=None,
    variance_method: str = "precond",
    precompute_kwargs: Optional[dict] = None,
    query_chunk: int = 4096,
    row_chunk: int = 2048,
    **sampler_kwargs,
) -> CalibrationResult:
    """Calibrate simulator parameters against observations y_exp.

    Builds the marginalized Gaussian log-posterior over the trained
    emulator (`make_log_posterior`), seeds n_walkers at the best design
    points (`init_walkers`), runs the chosen sampler ("emcee", "pt", "rwm"
    or "hmc") and returns natural-space draws after burn_in (default a
    quarter of the run), thinned, with R-hat and ESS. exp_cov: (t,)
    variances or a (t, t) covariance; log_prior: a log-density on natural
    coordinates on top of the box; discrepancy=True samples a
    model-discrepancy scale (its draws in result.discrepancy).
    `generator` (on the emulator's device) gives the walker starts' draws,
    then the sampler's. rwm and hmc adapt during burn-in only.
    `mesh=` in sampler_kwargs shards the walker axis over its devices (every
    sampler takes it), with the unsharded chain's draws.

    A matrix-free emulator builds its serving cache once
    (precompute_iterative_multivariate with precompute_kwargs: rank,
    cg_tol, cg_max_iters, row_chunk), or reuses `states`; each evaluation
    then takes variance_method's variance. sampler_kwargs go to the
    sampler.
    """
    runs = {"emcee": run_emcee, "pt": run_parallel_tempering,
            "rwm": run_rwm, "hmc": run_hmc}
    if sampler not in runs:
        raise ValueError(f"unknown sampler {sampler!r} (emcee|pt|rwm|hmc)")
    if burn_in is None:
        burn_in = n_steps // 4
    if not 0 <= burn_in < n_steps:
        raise ValueError(f"burn_in={burn_in} must lie in [0, n_steps)")
    if sampler in ("rwm", "hmc"):
        # adapt during burn-in only: the kept draws come from a fixed kernel
        sampler_kwargs.setdefault("n_adapt", burn_in)
    if (getattr(emu, "states", None) is None and states is None
            and not _is_mf(emu)):
        from madaiemulator_tpu_torch.models.multivariate import (
            precompute_iterative_multivariate,
        )

        states = precompute_iterative_multivariate(
            emu, **(precompute_kwargs or {}))
    log_post = make_log_posterior(
        emu, y_exp, exp_cov, log_prior=log_prior, discrepancy=discrepancy,
        discrepancy_prior=discrepancy_prior, states=states,
        variance_method=variance_method, query_chunk=query_chunk,
        row_chunk=row_chunk)
    extra0 = [math.log(0.05)] if discrepancy else None
    x0 = init_walkers(generator, emu, log_post, n_walkers, extra0=extra0)
    chain, lps, acc = runs[sampler](generator, log_post, x0, n_steps,
                                    **sampler_kwargs)[:3]
    kept = chain[burn_in::thin].cpu().numpy()  # (S, W, d[+1]) scaled
    kept_lp = lps[burn_in::thin].cpu().numpy()
    d_theta = _design_points(emu).shape[1]
    theta_kept = kept[..., :d_theta]
    scaling = emu.scaling
    natural = (theta_kept * scaling.ranges.cpu().numpy()
               + scaling.mins.cpu().numpy())
    disc = np.exp(kept[..., d_theta]) if discrepancy else None
    diag_chain = (np.concatenate([natural, disc[..., None]], axis=-1)
                  if discrepancy else natural)
    return CalibrationResult(
        samples=natural, log_posterior=kept_lp, acceptance=float(acc),
        rhat=gelman_rubin(diag_chain), ess=effective_sample_size(diag_chain),
        discrepancy=disc)


# ---------------------------------------------------------------------------
# History matching (implausibility)
# ---------------------------------------------------------------------------


def implausibility_from_moments(mean: torch.Tensor, var: torch.Tensor,
                                y_exp: torch.Tensor,
                                s2: torch.Tensor) -> torch.Tensor:
    """I = max_j |mean_j - y_j| / sqrt(var_j + s2_j) from predictive
    moments: mean / var (W, t), y_exp / s2 (t,) -> (W,)."""
    tot = torch.clamp(var + s2[None, :], min=torch.finfo(mean.dtype).tiny)
    return (torch.abs(mean - y_exp[None, :]) / torch.sqrt(tot)).amax(-1)


@torch.no_grad()
def implausibility(emu, y_exp, exp_cov, thetas_scaled: torch.Tensor,
                   states=None, **iter_kwargs) -> torch.Tensor:
    """Max-over-observables implausibility for history matching,

        I(theta) = max_j |m_j(theta) - y_j| / sqrt(v_j(theta) + s_j^2),

    at SCALED thetas (W, d) -> (W,); I > 3 is conventionally ruled out.
    Matrix-free emulators screen with the PCG-free Woodbury variance by
    default (variance_method="precond"; pass "exact" for small-N
    exactness); iter_kwargs (query_chunk, row_chunk, rank, ...) go to
    `predict_multivariate_iterative`, `states` reuses a serving cache. A
    dense emulator takes no iter_kwargs."""
    pts = _design_points(emu)
    dtype, dev = pts.dtype, pts.device
    y_exp = torch.as_tensor(y_exp).to(device=dev, dtype=dtype)
    exp_cov = torch.as_tensor(exp_cov).to(device=dev, dtype=dtype)
    s2 = torch.diagonal(exp_cov) if exp_cov.ndim == 2 else exp_cov
    xq = torch.as_tensor(thetas_scaled).to(device=dev, dtype=dtype)
    xq = xq if xq.ndim > 1 else xq[None]
    if _is_mf_mv(emu) and y_exp.shape[0] != emu.n_outputs:
        raise ValueError(
            f"y_exp has {y_exp.shape[0]} observables but this multivariate "
            f"multi-fidelity emulator predicts {emu.n_outputs}")
    if _is_mf(emu) and not _is_mf_mv(emu) and y_exp.shape[0] != 1:
        raise ValueError(
            f"y_exp has {y_exp.shape[0]} observables but a scalar "
            "multi-fidelity emulator predicts exactly 1 output")
    matrix_free = not _is_mf(emu) and getattr(emu, "states", None) is None
    if not matrix_free:
        if iter_kwargs and not (_is_mf(emu) or _is_sparse(emu)):
            raise TypeError(
                f"iter_kwargs {sorted(iter_kwargs)} apply to matrix-free "
                "emulators only (a dense emulator would silently ignore "
                "them)")
        mean, var = _moments_fn(emu, None, "precond", 4096, 2048)(xq)
    else:
        from madaiemulator_tpu_torch.models.multivariate import (
            predict_multivariate_iterative,
        )

        iter_kwargs.setdefault("variance_method", "precond")
        mean, var = predict_multivariate_iterative(
            emu, unapply_scaling(xq, emu.scaling), states=states,
            **iter_kwargs)
    return implausibility_from_moments(mean, var, y_exp, s2)
