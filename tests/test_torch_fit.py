"""The port's host-loop fit (madaiemulator_tpu_torch/models/fit.py) against
the JAX package's `fit_gp_host` on the CPU.

JAX PRNG keys and torch generators draw different restarts, so each test
feeds both drivers the same unconstrained starts u0 (numpy, from a seed) by
replacing each module's `sample_restarts`. The host LBFGS arithmetic is the
same numpy in both, so at float64 the trajectories agree to the rounding of
the likelihood gradients (~1e-10 relative).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu.models import fit as jfit
from madaiemulator_tpu.models import gp as jgp
from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu.utils import config as jcfg
from madaiemulator_tpu_torch.models import fit as tfit
from madaiemulator_tpu_torch.models import gp as tgp
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.utils import config as tcfg


def _problem(n=40, d=2, R=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    y = np.sin(3 * X[:, 0]) + 0.5 * X[:, -1] + 0.05 * rng.standard_normal(n)
    u0 = rng.uniform(-2.0, 2.0, size=(R, 2 + d))
    cj = jcfg.GPConfig(nparams=d, n_restarts=R)
    ct = tcfg.GPConfig(nparams=d, n_restarts=R, gram_method="xla",
                       cholesky_method="xla")
    dj = jgp.GPData(X=jnp.asarray(X), y=jnp.asarray(y))
    dt = tgp.GPData(X=torch.tensor(X), y=torch.tensor(y))
    return u0, cj, ct, dj, dt


def _fixed_starts(monkeypatch, u0):
    monkeypatch.setattr(jfit, "sample_restarts", lambda *a, **k: jk.GPParams(
        jnp.asarray(u0[:, 0]), jnp.asarray(u0[:, 1]), jnp.asarray(u0[:, 2:])))
    monkeypatch.setattr(tfit, "sample_restarts", lambda *a, **k: tk.GPParams(
        torch.tensor(u0[:, 0]), torch.tensor(u0[:, 1]),
        torch.tensor(u0[:, 2:])))


@pytest.mark.parametrize("value_linesearch", [False, True])
def test_fit_gp_host_matches_jax_f64(monkeypatch, value_linesearch):
    u0, cj, ct, dj, dt = _problem()
    _fixed_starts(monkeypatch, u0)
    rj = jfit.fit_gp_host(jax.random.key(0), dj, cj, max_steps=3,
                          value_linesearch=value_linesearch)
    rt = tfit.fit_gp_host(torch.Generator().manual_seed(0), dt, ct,
                          max_steps=3, value_linesearch=value_linesearch)
    np.testing.assert_allclose(rt.restart_log_likelihoods.numpy(),
                               np.asarray(rj.restart_log_likelihoods),
                               rtol=1e-7)
    for a, b in zip(rt.params, rj.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-8)
    for a, b in zip(rt.restart_params, rj.restart_params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-8)
    for key in ("n_vg_calls", "n_v_calls", "n_steps"):
        assert rt.stats[key] == rj.stats[key], key
    assert rt.log_likelihood.item() == rt.restart_log_likelihoods.max().item()


def test_fit_gp_host_checkpoint_resume(tmp_path):
    """An interrupted-and-resumed fit reproduces the uninterrupted one; a
    checkpoint of another problem is rejected (tests/test_fit.py:58)."""
    _, _, ct, _, dt = _problem(n=25, d=1)
    ck = str(tmp_path / "fit_ck.npz")

    def run(steps, **kw):
        return tfit.fit_gp_host(torch.Generator().manual_seed(4), dt, ct,
                                max_steps=steps, **kw)

    full = run(4)
    run(2, checkpoint_path=ck, checkpoint_every=1)
    assert os.path.exists(ck)
    resumed = run(4, checkpoint_path=ck, checkpoint_every=1)
    np.testing.assert_allclose(resumed.restart_log_likelihoods.numpy(),
                               full.restart_log_likelihoods.numpy(),
                               rtol=1e-12)
    _, _, ct2, _, dt2 = _problem(n=25, d=2)
    with pytest.raises(ValueError, match="checkpoint"):
        tfit.fit_gp_host(torch.Generator().manual_seed(4), dt2, ct2,
                         max_steps=2, checkpoint_path=ck)
    _, _, _, _, dt3 = _problem(n=30, d=1)
    with pytest.raises(ValueError, match="delete it"):
        tfit.fit_gp_host(torch.Generator().manual_seed(4), dt3, ct,
                         max_steps=2, checkpoint_path=ck)


def test_sample_restarts_in_box_and_seeded():
    cfg = tcfg.GPConfig(nparams=3)
    u = tfit.sample_restarts(torch.Generator().manual_seed(1), cfg, 64,
                             dtype=torch.float64)
    again = tfit.sample_restarts(torch.Generator().manual_seed(1), cfg, 64,
                                 dtype=torch.float64)
    assert all(torch.equal(a, b) for a, b in zip(u, again))
    assert u.log_ls.shape == (64, 3)
    lo, hi = tfit._bounds_arrays(cfg, torch.float64)
    p = tfit._u_to_params(u, lo, hi)
    for leaf, l, h in zip(p, lo, hi):
        frac = (leaf - l) / (h - l)
        assert bool(((frac > 0.05 - 1e-12) & (frac < 0.95 + 1e-12)).all())
    back = tfit._params_to_u(p, lo, hi)
    for a, b in zip(back, u):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9)


def test_rescue_revives_dead_starts_and_all_dead_warns(caplog):
    """The dead-start rescue sweeps to the long-length-scale window when
    only that region is feasible; a fit where nothing is feasible warns
    (tests/test_fit.py:335,369)."""
    import logging

    rng = np.random.default_rng(0)
    data = tgp.GPData(X=torch.tensor(rng.uniform(size=(16, 2))),
                      y=torch.tensor(rng.standard_normal(16)))
    cfg = tcfg.GPConfig(nparams=2, n_restarts=2, max_opt_steps=8)

    def gated_lml(params, data, config):
        ll = -((params.log_ls ** 2).sum(-1) + params.log_amp ** 2
               + (params.log_nugget + 6.9) ** 2)
        ok = params.log_ls.min(-1).values > np.log(0.3)
        return torch.where(ok, ll, -torch.inf)

    res = tfit.fit_gp_host(torch.Generator().manual_seed(123), data, cfg,
                           lml_fn=gated_lml)
    assert np.isfinite(res.log_likelihood.item())
    assert bool((torch.exp(res.params.log_ls) > 0.3).all())
    assert res.log_likelihood.item() > -2.0

    def dead_lml(params, data, config):
        return -torch.inf * params.log_ls.sum(-1) ** 0

    with caplog.at_level(logging.WARNING, logger=tfit.logger.name):
        res = tfit.fit_gp_host(torch.Generator().manual_seed(5), data, cfg,
                               lml_fn=dead_lml)
    assert not np.isfinite(res.log_likelihood.item())
    assert any("infeasible" in r.message for r in caplog.records)
