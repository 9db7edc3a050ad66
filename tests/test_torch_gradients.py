"""Observation noise and gradient-enhanced GPs on the port
(madaiemulator_tpu_torch/ops/kernels.py `joint_cross` / `gram_joint`,
models/gp.py gradient rows and `predict_gradient`, models/multivariate.py
`project_*`, the noise / gradient fit and `predict_multivariate_gradient`)
against the JAX package, float64 on the CPU. The same numpy inputs, made
from a seed, go through both packages.

Small sizes: N=16 points in d=3 for the kernels and the LML, a fit of N=10
points in d=2 with t=3 outputs, 2 restarts x 3 L-BFGS steps (backtracking
linesearch: half the JAX compile of the zoom) from the same unconstrained
starts in both packages (each package's `sample_restarts` replaced), one
JAX compile of the fit in a module-scoped fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu.models import fit as jfit
from madaiemulator_tpu.models import gp as jgp
from madaiemulator_tpu.models import multivariate as jmv
from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu.utils import config as jcfg
from madaiemulator_tpu.utils import designs as jdes
from madaiemulator_tpu_torch.models import fit as tfit
from madaiemulator_tpu_torch.models import gp as tgp
from madaiemulator_tpu_torch.models import multivariate as tmv
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.utils import config as tcfg
from madaiemulator_tpu_torch.utils import designs as tdes
import torch_shared  # noqa: F401

N, D, M = 16, 3, 6
FAMILIES = ("POWER_EXPONENTIAL", "MATERN52", "MATERN52_ARD")
# Two float64 builds of the same closed forms (other summation orders).
KERNEL_RTOL = 1e-12
# LML value and gradient, serve means and variances through a cond ~1e4
# joint factorization: float64 rounding amplified by it.
LML_RTOL = 1e-10
GRAD_RTOL = 1e-8
PREDICT_RTOL = 1e-9


def _cfgs(family, order=1):
    return (jcfg.GPConfig(nparams=D, regression_order=order,
                          covariance=getattr(jcfg.CovarianceFamily, family)),
            tcfg.GPConfig(nparams=D, regression_order=order,
                          covariance=getattr(tcfg.CovarianceFamily, family)))


def _params(cfg, rng):
    k = cfg.num_length_scales
    a = (0.2, np.log(1e-3), np.log(rng.uniform(0.3, 0.7, k)))
    return (jk.GPParams(*(jnp.asarray(v) for v in a)),
            tk.GPParams(*(torch.tensor(v, dtype=torch.float64) for v in a)))


def _data(rng, noise=True, grad_noise=True):
    X = rng.uniform(size=(N, D))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 - X[:, 2]
    dY = np.stack([3 * np.cos(3 * X[:, 0]), 2 * X[:, 1], -np.ones(N)], 1)
    f = dict(X=X, y=y, dY=dY,
             noise=rng.uniform(1e-4, 1e-3, N) if noise else None,
             dY_noise=rng.uniform(1e-4, 1e-3, (N, D)) if grad_noise else None)
    return (jgp.GPData(**{k: None if v is None else jnp.asarray(v)
                          for k, v in f.items()}),
            tgp.GPData(**{k: None if v is None else torch.tensor(v)
                          for k, v in f.items()}))


def _close(got, want, rtol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("family", FAMILIES)
def test_joint_cross_and_gram_joint_match_jax(family):
    rng = np.random.default_rng(1)
    cj, ct = _cfgs(family)
    pj, pt = _params(cj, rng)
    dj, dt = _data(rng)
    Xs = rng.uniform(size=(M, D))
    kws = (dict(grad_rows=True), dict(grad_cols=True),
           dict(grad_rows=True, grad_cols=True),
           dict(grad_rows=True, grad_cols=True, value_cols=False), dict())

    @jax.jit
    def ref(x, xs, p, n, g):
        return ([jk.joint_cross(x, xs, p, cj, **kw) for kw in kws],
                jk.gram_joint(x, p, cj, noise=n, grad_noise=g))

    crosses, want = ref(dj.X, jnp.asarray(Xs), pj, dj.noise, dj.dY_noise)
    for kw, w in zip(kws, crosses):
        got = tk.joint_cross(dt.X, torch.tensor(Xs), pt, ct, **kw)
        assert got.shape == w.shape, kw
        _close(got, w, KERNEL_RTOL, str(kw))
    got = tk.gram_joint(dt.X, pt, ct, noise=dt.noise, grad_noise=dt.dY_noise)
    assert got.shape == (N * (1 + D),) * 2
    _close(got, want, KERNEL_RTOL)
    assert torch.equal(got, got.mT)
    assert tk.grad_prior_scale(ct) == jk.grad_prior_scale(cj)


def test_joint_cross_batched_over_components():
    """A batch of parameters (the component / lane axis) gives each
    member's own joint Gram."""
    rng = np.random.default_rng(2)
    _, ct = _cfgs("MATERN52_ARD")
    X = torch.tensor(rng.uniform(size=(N, D)))
    pb = tk.GPParams(torch.tensor([0.1, -0.3]),
                     torch.log(torch.tensor([1e-3, 1e-2])),
                     torch.log(torch.tensor(rng.uniform(0.3, 0.7, (2, D)))))
    gn = torch.tensor(rng.uniform(1e-4, 1e-3, (2, N, D)))
    K = tk.gram_joint(X, pb, ct, grad_noise=gn)
    for i in range(2):
        Ki = tk.gram_joint(X, tk.GPParams(*(a[i] for a in pb)), ct,
                           grad_noise=gn[i])
        _close(K[i], Ki.numpy(), 1e-14)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_regression_basis_grad_matches_jax(order):
    X = np.random.default_rng(3).uniform(size=(N, D))
    want = jgp.regression_basis_grad(jnp.asarray(X), order)
    got = tgp.regression_basis_grad(torch.tensor(X), order)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _lml_both(family, dj, dt, reml=False):
    rng = np.random.default_rng(4)
    cj, ct = _cfgs(family)
    cj = dataclasses.replace(cj, reml=reml)
    ct = dataclasses.replace(ct, reml=reml)
    pj, pt = _params(cj, rng)
    vj, gj = jax.jit(jax.value_and_grad(
        lambda p, d: jgp.log_marginal_likelihood(p, d, cj)))(pj, dj)
    q = tk.GPParams(*(a.clone().requires_grad_() for a in pt))
    vt = tgp.log_marginal_likelihood(q, dt, ct)
    gt = torch.autograd.grad(vt, q)
    qa = tk.GPParams(*(a.clone().requires_grad_() for a in pt))
    ga = torch.autograd.grad(tgp.log_marginal_likelihood_ad(qa, dt, ct), qa)
    return (vt, gt, ga), (vj, gj)


@pytest.mark.parametrize("family,fields", [
    ("POWER_EXPONENTIAL", "noise"), ("POWER_EXPONENTIAL", "dY"),
    ("POWER_EXPONENTIAL", "dY+noise+dY_noise"),
    ("MATERN52", "dY+noise+dY_noise"), ("MATERN52_ARD", "dY+noise+dY_noise"),
])
def test_lml_value_and_grad_match_jax_and_autodiff(family, fields):
    """The closed-form backward (a VJP of `training_gram`) on joint data:
    against jax.grad of the JAX LML and against autodiff through the
    port's own factorization."""
    rng = np.random.default_rng(5)
    dj, dt = _data(rng)
    keep = set(fields.split("+"))
    drop = {k: None for k in ("noise", "dY", "dY_noise") if k not in keep}
    dj, dt = dj._replace(**drop), dt._replace(**drop)
    (vt, gt, ga), (vj, gj) = _lml_both(family, dj, dt,
                                       reml=fields == "noise")
    assert np.isfinite(float(vj))
    np.testing.assert_allclose(vt.item(), float(vj), rtol=LML_RTOL)
    for a, b, c in zip(gt, gj, ga):
        _close(a, b, GRAD_RTOL, "vs JAX")
        _close(a, c.numpy(), GRAD_RTOL, "vs autodiff")


def test_lml_batched_joint_lanes():
    """Lanes with their own gradient targets (the fit's layout): each
    lane's value equals its own unbatched LML."""
    rng = np.random.default_rng(6)
    _, ct = _cfgs("POWER_EXPONENTIAL")
    _, dt = _data(rng)
    dY2 = torch.stack([dt.dY, -dt.dY])
    y2 = torch.stack([dt.y, 2 * dt.y])
    pt = tk.GPParams(torch.tensor([0.1, 0.3]), torch.log(torch.tensor(
        [1e-3, 1e-2])), torch.log(torch.tensor([[0.5] * D, [0.4] * D])))
    v = tgp.log_marginal_likelihood(pt, dt._replace(y=y2, dY=dY2, noise=None,
                                                    dY_noise=None), ct)
    for i in range(2):
        vi = tgp.log_marginal_likelihood(
            tk.GPParams(*(a[i] for a in pt)),
            dt._replace(y=y2[i], dY=dY2[i], noise=None, dY_noise=None), ct)
        np.testing.assert_allclose(v[i].item(), vi.item(), rtol=1e-12)


@pytest.mark.parametrize("with_grads", [False, True],
                         ids=["values_only", "gradient_enhanced"])
def test_predict_gradient_matches_jax(with_grads):
    rng = np.random.default_rng(7)
    cj, ct = _cfgs("MATERN52_ARD")
    cj = dataclasses.replace(cj, predict_variance_includes_nugget=True)
    ct = dataclasses.replace(ct, predict_variance_includes_nugget=True)
    pj, pt = _params(cj, rng)
    dj, dt = _data(rng)
    if not with_grads:
        dj = dj._replace(dY=None, dY_noise=None)
        dt = dt._replace(dY=None, dY_noise=None)
    Xs = rng.uniform(size=(M, D))
    st = tgp.precompute_predictor(pt, dt, ct)

    @jax.jit
    def both(p, d, x):
        s = jgp.precompute_predictor(p, d, cj)
        return (jgp.predict_gradient(s, p, d, x, cj),
                jgp.predict_from_precomputed(s, p, d, x, cj))

    for want, ft in zip(both(pj, dj, jnp.asarray(Xs)),
                        (tgp.predict_gradient, tgp.predict_from_precomputed)):
        got = ft(st, pt, dt, torch.tensor(Xs), ct)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            _close(a, b, PREDICT_RTOL)
    # chunked (2 queries a chunk) equals unchunked
    cc = dataclasses.replace(ct, predict_query_chunk=2)
    for a, b in zip(tgp.predict_gradient(st, pt, dt, torch.tensor(Xs), cc),
                    tgp.predict_gradient(st, pt, dt, torch.tensor(Xs), ct)):
        _close(a, b.numpy(), 1e-14)


def _pca_pair(rng, t=3):
    Y = rng.standard_normal((N, t)) @ rng.standard_normal((t, t))
    pca, _ = tmv.pca_decompose(Y, 0.999)
    sc = tdes.DesignScaling(mins=torch.zeros(D, dtype=torch.float64),
                            ranges=torch.tensor([2.0, 0.5, 3.0],
                                                dtype=torch.float64))
    pj = jmv.PCAState(*(jnp.asarray(a) for a in pca))
    sj = jdes.DesignScaling(jnp.zeros(D), jnp.asarray([2.0, 0.5, 3.0]))
    return pca, sc, pj, sj


def test_projections_match_jax():
    rng = np.random.default_rng(8)
    pca, sc, pj, sj = _pca_pair(rng)
    t = pca.ymean.shape[0]
    for noise in (rng.uniform(1e-4, 1e-3, N), rng.uniform(1e-4, 1e-3, (N, t))):
        _close(tmv.project_noise(noise, pca), jmv.project_noise(noise, pj),
               1e-13)
    dY = rng.standard_normal((N, D, t))
    _close(tmv.project_gradients(dY, pca, sc),
           jmv.project_gradients(dY, pj, sj), 1e-13)
    v = rng.uniform(1e-4, 1e-3, (N, D, t))
    _close(tmv.project_gradient_noise(v, pca, sc),
           jmv.project_gradient_noise(v, pj, sj), 1e-13)
    with pytest.raises(ValueError, match="noise must be"):
        tmv.project_noise(np.ones((N, t + 1)), pca)
    with pytest.raises(ValueError, match="gradients must be"):
        tmv.project_gradients(np.ones((N, D)), pca, sc)


# --- a small gradient-enhanced fit, both packages from the same starts ------

FN, FD, FT, R, STEPS = 10, 2, 3, 2, 3


def _fit_inputs():
    rng = np.random.default_rng(9)
    X = 1.0 + 2.0 * rng.uniform(size=(FN, FD))
    Y = np.stack([np.sin(X[:, 0]) + X[:, 1], X[:, 0] * X[:, 1],
                  np.cos(X[:, 1])], 1)
    G = np.stack([np.stack([np.cos(X[:, 0]), np.ones(FN)], 1),
                  np.stack([X[:, 1], X[:, 0]], 1),
                  np.stack([np.zeros(FN), -np.sin(X[:, 1])], 1)], 2)
    noise = rng.uniform(1e-4, 1e-3, FN)
    u0 = np.concatenate([rng.uniform(-1.0, 1.0, (R, 1)),
                         rng.uniform(-0.5, 1.0, (R, 1)),
                         rng.uniform(-1.0, 1.0, (R, FD))], 1)
    return X, Y, G, noise, u0


@pytest.fixture(scope="module")
def fits():
    X, Y, G, noise, u0 = _fit_inputs()
    kw = dict(nparams=FD, regression_order=1, n_restarts=R,
              max_opt_steps=STEPS, linesearch="backtracking")
    mp = pytest.MonkeyPatch()
    mp.setattr(jfit, "sample_restarts", lambda *a, **k: jk.GPParams(
        jnp.asarray(u0[:, 0]), jnp.asarray(u0[:, 1]), jnp.asarray(u0[:, 2:])))
    mp.setattr(tfit, "sample_restarts", lambda *a, **k: tk.GPParams(
        torch.tensor(u0[:, 0]), torch.tensor(u0[:, 1]),
        torch.tensor(u0[:, 2:])))
    try:
        ej = jmv.fit_multivariate(jax.random.key(0), jnp.asarray(X),
                                  jnp.asarray(Y), jcfg.GPConfig(**kw),
                                  pca_variance=0.999, noise=jnp.asarray(noise),
                                  gradients=jnp.asarray(G))
        et = tmv.fit_multivariate(torch.Generator().manual_seed(0),
                                  torch.tensor(X), torch.tensor(Y),
                                  tcfg.GPConfig(**kw), pca_variance=0.999,
                                  noise=torch.tensor(noise),
                                  gradients=torch.tensor(G))
    finally:
        mp.undo()
    return ej, et, X


def test_fit_multivariate_noise_gradients_matches_jax(fits):
    ej, et, _ = fits
    assert et.dZ.shape == (FN, FD, et.n_components) and et.dZ_noise is None
    _close(et.dZ, ej.dZ, 1e-13, "dZ")
    _close(et.noise, ej.noise, 1e-13, "noise")
    _close(et.restart_log_likelihoods, ej.restart_log_likelihoods, 1e-9)
    for a, b in zip(et.params, ej.params):
        _close(a, b, 1e-7)
    assert bool(et.states.ok.all())


def test_gradient_emulator_serves_like_jax(fits):
    """The JAX-fitted emulator's arrays (dZ included) through the port's
    `emulator_from_numpy`: values and gradients against the JAX
    emulator's."""
    ej, _, X = fits
    keys = dict(mins=ej.scaling.mins, ranges=ej.scaling.ranges, X=ej.X,
                Z=ej.Z, ymean=ej.pca.ymean, ystd=ej.pca.ystd,
                eigenvalues=ej.pca.eigenvalues, U=ej.pca.U,
                log_amp=ej.params.log_amp, log_nugget=ej.params.log_nugget,
                log_ls=ej.params.log_ls, noise=ej.noise, dZ=ej.dZ)
    emu = tmv.emulator_from_numpy({k: np.asarray(v) for k, v in keys.items()},
                                  tcfg.GPConfig(nparams=FD, regression_order=1),
                                  device=torch.device("cpu"))
    q = X[:4] + 0.1
    for ft, fj in ((tmv.predict_multivariate, jmv.predict_multivariate),
                   (tmv.predict_multivariate_gradient,
                    jmv.predict_multivariate_gradient)):
        for a, b in zip(ft(emu, q), fj(ej, jnp.asarray(q))):
            assert a.shape == b.shape
            _close(a, b, PREDICT_RTOL)


def test_gradient_guards_match_jax():
    """A once-differentiable kernel with gradients raises ValueError in
    both packages, as does gradient noise without gradients; values-only
    emulators still serve gradients."""
    X, Y, G, _, _ = _fit_inputs()
    for family in ("MATERN32", "MATERN32_ARD"):
        cj = jcfg.GPConfig(nparams=FD, covariance=getattr(
            jcfg.CovarianceFamily, family), n_restarts=1, max_opt_steps=1)
        ct = tcfg.GPConfig(nparams=FD, covariance=getattr(
            tcfg.CovarianceFamily, family), n_restarts=1, max_opt_steps=1)
        with pytest.raises(ValueError, match="twice") as ej:
            jk.gram_joint(jnp.asarray(X), jk.GPParams(
                jnp.asarray(0.0), jnp.asarray(-3.0), jnp.zeros(
                    cj.num_length_scales)), cj)
        with pytest.raises(ValueError, match="twice") as et:
            tmv.fit_multivariate(torch.Generator(), torch.tensor(X),
                                 torch.tensor(Y), ct,
                                 gradients=torch.tensor(G))
        assert str(et.value) == str(ej.value)
    ct = tcfg.GPConfig(nparams=FD, n_restarts=1, max_opt_steps=1)
    with pytest.raises(ValueError, match="without gradients"):
        tmv.fit_multivariate(torch.Generator(), torch.tensor(X),
                             torch.tensor(Y), ct,
                             gradient_noise=torch.ones(FN, FD, FT))
    cpe = tcfg.GPConfig(nparams=FD, power_exp_alpha=1.5)
    with pytest.raises(ValueError, match="alpha=1.5"):
        tk.grad_prior_scale(cpe)
