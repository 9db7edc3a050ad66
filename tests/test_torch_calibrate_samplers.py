"""The port's four samplers on the CPU against the JAX package at float64:
emcee, random-walk Metropolis, HMC (with its mass adaptation) and parallel
tempering, each 10 steps from the same walkers with jax.random's draws
injected through the port's per-site draw helpers in JAX's split order
(`split(key, n_steps)`, then each step's own splits): the same chain,
log-posterior and acceptance; HMC's gradient at the box edge; and the
walker starts and the `calibrate` driver end to end under JAX's draws.
The emulator is tests/test_torch_calibrate.py's dense one, read by both
packages from one snapshot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu.models import calibrate as jcal
from madaiemulator_tpu_torch.models import calibrate as tcal
from test_torch_calibrate import D, STEPS, W, _close, _j, _pair_lp, _t
from test_torch_calibrate import build_emulators
import torch_shared  # noqa: F401


@pytest.fixture(scope="module")
def emus(tmp_path_factory):
    return build_emulators(tmp_path_factory.mktemp("cal_samplers"),
                           ("dense",))



class _Draws:
    """Queues of JAX draws, one per port draw helper, consumed in call
    order."""

    def __init__(self):
        self.q = {}

    def push(self, site, value):
        self.q.setdefault(site, []).append(np.asarray(value))

    def install(self, mp):
        for site in self.q:
            it = iter(self.q[site])

            def draw(*a, _it=it, **k):
                return torch.tensor(next(_it))

            mp.setattr(tcal, site, draw)


def _acc_u(k, shape):
    return jax.random.uniform(k, shape, dtype=jnp.float64,
                              minval=jnp.finfo(jnp.float64).tiny)


def _stretch_draws(dr, k, shape, half):
    k_z, k_pick, k_acc = jax.random.split(k, 3)
    dr.push("_stretch_uniform", jax.random.uniform(k_z, shape,
                                                   dtype=jnp.float64))
    dr.push("_partner_pick", jax.random.randint(k_pick, shape, 0, half))
    dr.push("_accept_uniform", _acc_u(k_acc, shape))


def _draws_emcee(key, n_steps):
    dr = _Draws()
    for k in jax.random.split(key, n_steps):
        for kh in jax.random.split(k):
            _stretch_draws(dr, kh, (W // 2,), W // 2)
    return dr


def _draws_rwm(key, n_steps, shape):
    dr = _Draws()
    for k in jax.random.split(key, n_steps):
        k_prop, k_acc = jax.random.split(k)
        dr.push("_rwm_normal", jax.random.normal(k_prop, shape,
                                                 dtype=jnp.float64))
        dr.push("_accept_uniform", _acc_u(k_acc, shape[:1]))
    return dr


def _draws_hmc(key, n_steps, shape):
    dr = _Draws()
    for k in jax.random.split(key, n_steps):
        k_mom, k_jit, k_acc = jax.random.split(k, 3)
        dr.push("_momentum_normal", jax.random.normal(k_mom, shape,
                                                      dtype=jnp.float64))
        dr.push("_step_jitter", jax.random.uniform(
            k_jit, (), dtype=jnp.float64, minval=0.8, maxval=1.2))
        dr.push("_accept_uniform", _acc_u(k_acc, shape[:1]))
    return dr


def _draws_pt(key, n_steps, rungs, d):
    dr = _Draws()
    k0, k1 = jax.random.split(key, 2)
    dr.push("_pt_jitter_normal", jax.random.normal(
        k0, (rungs - 1, W, d), dtype=jnp.float64))
    for k in jax.random.split(k1, n_steps):
        kA, kB, k_su = jax.random.split(k, 3)
        for kh in (kA, kB):
            _stretch_draws(dr, kh, (rungs, W // 2), W // 2)
        dr.push("_swap_uniform", _acc_u(k_su, (rungs - 1, W)))
    return dr


@pytest.fixture(scope="module")
def x0():
    rng = np.random.default_rng(8)
    return np.clip(rng.normal([0.45, 0.55], 0.1, size=(W, D)), 0.02, 0.98)


@pytest.mark.parametrize("sampler", ["emcee", "rwm", "hmc", "pt"])
def test_sampler_matches_jax_under_its_draws(emus, x0, sampler,
                                             monkeypatch):
    """10 steps from the same walkers with JAX's draws injected: the same
    chain, log-posterior and acceptance (and the final step size / swap
    rate)."""
    lj, lt = _pair_lp(emus, "dense")
    key = jax.random.key(3)
    if sampler == "emcee":
        want = jcal.run_emcee(key, lj, _j(x0), STEPS)
        dr = _draws_emcee(key, STEPS)
    elif sampler == "rwm":
        want = jcal.run_rwm(key, lj, _j(x0), STEPS, step_size=0.1, n_adapt=6)
        dr = _draws_rwm(key, STEPS, x0.shape)
    elif sampler == "hmc":
        want = jcal.run_hmc(key, lj, _j(x0), STEPS, step_size=0.05,
                            n_leapfrog=3, n_adapt=8, return_mass=True)
        dr = _draws_hmc(key, STEPS, x0.shape)
    else:
        want = jcal.run_parallel_tempering(key, lj, _j(x0), STEPS, n_rungs=3)
        dr = _draws_pt(key, STEPS, 3, D)
    dr.install(monkeypatch)
    run = {"emcee": tcal.run_emcee, "rwm": tcal.run_rwm,
           "hmc": tcal.run_hmc, "pt": tcal.run_parallel_tempering}[sampler]
    kw = {"rwm": dict(step_size=0.1, n_adapt=6),
          "hmc": dict(step_size=0.05, n_leapfrog=3, n_adapt=8,
                      return_mass=True),
          "pt": dict(n_rungs=3)}.get(sampler, {})
    got = run(torch.Generator(), lt, _t(x0), STEPS, **kw)
    assert len(got) == len(want)
    acc = float(got[2])
    assert 0.0 < acc < 1.0
    for a, b in zip(got, want):
        _close(a, b, atol=1e-11)


def test_hmc_gradient_inside_the_box_ignores_walkers_outside(emus):
    """A walker outside the box (and one at its edge) leaves every in-box
    walker's gradient as it is alone, finite; the outside walker's is
    zeroed."""
    _, lt = _pair_lp(emus, "dense")
    x = torch.tensor([[0.3, 0.6], [1.2, 0.5], [1.0, 0.0], [0.5, -3.0]],
                     dtype=torch.float64)
    lp, g = tcal._lp_and_grad(lt, x)
    assert torch.isneginf(lp[[1, 3]]).all() and torch.isfinite(lp[[0, 2]]).all()
    assert torch.isfinite(g).all() and (g[[1, 3]] == 0).all()
    for i in (0, 2):
        _, gi = tcal._lp_and_grad(lt, x[i:i + 1])
        _close(g[i], gi[0], rtol=1e-13)


def test_init_walkers_and_calibrate_match_jax(emus, monkeypatch):
    """The walker starts (seeded on the best design points; a discrepancy
    coordinate) and the emcee driver end to end with JAX's draws
    injected: the same natural-space samples, log-posterior, acceptance,
    R-hat and ESS."""
    ej, et = emus["dense"]
    y, v = emus["_y_exp"], emus["_exp_var"]
    key = jax.random.key(5)
    want = jcal.calibrate(key, ej, _j(y), _j(v), n_walkers=W,
                          n_steps=STEPS, burn_in=2, discrepancy=True)
    k_init, k_run = jax.random.split(key)
    dr = _draws_emcee(k_run, STEPS)
    k_sub, k = jax.random.split(k_init)
    k_pick, k_jit, k_ex = jax.random.split(k, 3)
    dr.push("_seed_pick", jax.random.randint(k_pick, (W,), 0, 8))
    dr.push("_seed_normal", jax.random.normal(k_jit, (W, D),
                                              dtype=jnp.float64))
    dr.push("_extra_normal", jax.random.normal(k_ex, (W, 1),
                                               dtype=jnp.float64))
    dr.install(monkeypatch)
    got = tcal.calibrate(torch.Generator(), et, y, v, n_walkers=W,
                         n_steps=STEPS, burn_in=2, discrepancy=True)
    for a, b in zip(got, want):
        _close(a, b, atol=1e-11)
    s = got.summary()
    assert s["mean"].shape == (D + 1,) and s["rhat"].shape == (D + 1,)
    with pytest.raises(ValueError, match="unknown sampler"):
        tcal.calibrate(torch.Generator(), et, y, v, n_walkers=W, n_steps=4,
                       sampler="nuts")
    with pytest.raises(TypeError, match="mesh"):
        tcal.run_emcee(torch.Generator(), None, torch.zeros(W, D), 2,
                       mesh=object())
