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
import torch_shared  # noqa: F401


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


# --- the in-graph fit (fit_gp, fit_one_start) against the jitted JAX fit_gp
#
# Each case runs the JAX fit_gp once (one compile) and the port's fit_gp
# unchunked and with restart_chunk=1, all from the same u0 (R=3 restarts,
# 5 LBFGS steps, N=30, d=2). The JAX fit_gp is jitted with the patched
# sample_restarts traced in, so each case has its own config and u0.
# Tolerances (float64): the per-restart best LML to rtol 1e-8 and the best
# params to rtol 1e-6; both packages run optax's algorithm on the same
# iterates, so they agree to the rounding of the likelihood gradients
# (observed ~1e-10 on the LML). The starts are drawn where C(theta) is well
# conditioned (amplitude 0.02-50, nugget >= 1e-5): at a nugget of 1e-8 x
# amp (cond ~1e10) two float64 LAPACK builds already differ by ~5e-9 in
# the objective and its gradient, and the linesearch's long steps amplify
# that (measured: 2.8e-6 on one restart's LML after 5 zoom steps).
# Two cases cover both linesearches, both regression orders and a Matern
# family, with one JAX compile each.
_GP_CASES = {
    "zoom-order0": dict(linesearch="zoom", regression_order=0),
    # restart 1 starts at NaN: a dead start (non-finite objective) that the
    # rescue remaps to the moment-matched fallback
    "backtracking-order1-matern32-dead-start": dict(
        linesearch="backtracking", regression_order=1, covariance="matern32"),
}
DEAD = "backtracking-order1-matern32-dead-start"


@pytest.fixture(scope="module", params=list(_GP_CASES))
def gp_case(request):
    name = request.param
    kw = dict(_GP_CASES[name])
    cov = kw.pop("covariance", "power_exponential")
    n, d, R, steps = 30, 2, 3, 5
    rng = np.random.default_rng(11)
    X = rng.uniform(size=(n, d))
    y = np.sin(3 * X[:, 0]) + 0.5 * X[:, 1] + 0.05 * rng.standard_normal(n)
    cj = jcfg.GPConfig(nparams=d, n_restarts=R, max_opt_steps=steps,
                       covariance=jcfg.COVARIANCE_CLI_NAMES[cov], **kw)
    ct = tcfg.GPConfig(nparams=d, n_restarts=R, max_opt_steps=steps,
                       covariance=tcfg.COVARIANCE_CLI_NAMES[cov], **kw)
    k = ct.num_length_scales
    u0 = np.concatenate([rng.uniform(-1.0, 1.0, (R, 1)),
                         rng.uniform(-0.5, 1.5, (R, 1)),
                         rng.uniform(-1.5, 1.5, (R, k))], axis=1)
    if name == DEAD:
        u0[1] = np.nan
    dj = jgp.GPData(X=jnp.asarray(X), y=jnp.asarray(y))
    dt = tgp.GPData(X=torch.tensor(X), y=torch.tensor(y))
    with pytest.MonkeyPatch.context() as mp:
        _fixed_starts(mp, u0)
        rj = jfit.fit_gp(jax.random.key(0), dj, cj)
        rt = tfit.fit_gp(torch.Generator().manual_seed(0), dt, ct)
        rc = tfit.fit_gp(torch.Generator().manual_seed(0), dt, ct,
                         restart_chunk=1)
    return dict(name=name, u0=u0, X=X, y=y, ct=ct, dt=dt, rj=rj, rt=rt,
                rc=rc, steps=steps)


def test_fit_gp_matches_jax_f64(gp_case):
    rj, rt = gp_case["rj"], gp_case["rt"]
    np.testing.assert_allclose(rt.restart_log_likelihoods.numpy(),
                               np.asarray(rj.restart_log_likelihoods),
                               rtol=1e-8)
    np.testing.assert_allclose(rt.log_likelihood.item(),
                               float(rj.log_likelihood), rtol=1e-8)
    for a, b in zip(rt.params, rj.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for a, b in zip(rt.restart_params, rj.restart_params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    # one rescue value batch, step 0's value+grad, every linesearch
    # evaluation, the final value batch
    st = rt.stats
    assert st["n_v_calls"] == 2
    assert st["n_vg_calls"] >= 1 + st["linesearch_evals"]
    assert st["n_steps"] == gp_case["steps"]


def test_fit_one_start_matches_jax_f64(gp_case):
    """The batched fit_one_start from the same live starts gives what the
    JAX fit_one_start gave under fit_gp's vmap (fit_gp runs a live start
    unchanged; lanes are independent, so the dead start is left out)."""
    u0, ct = gp_case["u0"], gp_case["ct"]
    live = ~np.isnan(u0).any(axis=1)
    start = tk.GPParams(torch.tensor(u0[live, 0]), torch.tensor(u0[live, 1]),
                        torch.tensor(u0[live, 2:]))
    best_u, best_negll = tfit.fit_one_start(
        start, torch.tensor(gp_case["X"]), torch.tensor(gp_case["y"]), ct,
        gp_case["steps"])
    rj = gp_case["rj"]
    np.testing.assert_allclose(-best_negll.numpy(),
                               np.asarray(rj.restart_log_likelihoods)[live],
                               rtol=1e-8)
    lo, hi = tfit._bounds_arrays(ct, torch.float64)
    for a, b in zip(tfit._u_to_params(best_u, lo, hi), rj.restart_params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[live], rtol=1e-6)


@pytest.mark.parametrize("gp_case", [DEAD], indirect=True)
def test_dead_start_rescued_to_jax_fallback(gp_case):
    """Restart 1 starts at NaN; both packages remap it to the same
    moment-matched fallback, and its trajectory from there agrees."""
    assert np.isnan(gp_case["u0"][1]).all()
    lls = gp_case["rt"].restart_log_likelihoods.numpy()
    assert np.isfinite(lls).all()
    np.testing.assert_allclose(
        lls[1], float(gp_case["rj"].restart_log_likelihoods[1]), rtol=1e-8)
    for a, b in zip(gp_case["rt"].restart_params, gp_case["rj"].restart_params):
        np.testing.assert_allclose(a.numpy()[1], np.asarray(b)[1], rtol=1e-6)


def test_restart_chunk_matches_unchunked(gp_case):
    """restart_chunk=1 runs the restarts one at a time (frozen lanes keep
    their state, so the batch does not change a lane's trajectory): the
    same result to rtol 1e-10, with one objective batch per group."""
    rt, rc = gp_case["rt"], gp_case["rc"]
    np.testing.assert_allclose(rc.restart_log_likelihoods.numpy(),
                               rt.restart_log_likelihoods.numpy(), rtol=1e-10)
    for a, b in zip(rc.restart_params, rt.restart_params):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10)
    assert rc.stats["n_v_calls"] == 1 + 3  # rescue + a final value per group
    assert rc.stats["n_vg_calls"] > rt.stats["n_vg_calls"]
